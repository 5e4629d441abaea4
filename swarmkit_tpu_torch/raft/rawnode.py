"""Ready/Advance driver around the Raft state machine.

Behavioral reference: vendor/github.com/coreos/etcd/raft/node.go (Ready
struct, node.go:115-168 Node interface) and rawnode.go — collapsed to a
synchronous, explicitly-driven API (no goroutines/channels): the shell calls
tick()/step()/propose(), then drains ready() and acknowledges with advance().

Durability contract preserved from the reference: the caller must persist
Ready.hard_state + Ready.entries (WAL) and Ready.snapshot before sending
Ready.messages, then apply Ready.committed_entries, then call advance().

The port's own copy of the JAX package's raft/rawnode.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from swarmkit_tpu_torch.raft.core import Config, Raft
from swarmkit_tpu_torch.raft.log import RaftLog
from swarmkit_tpu_torch.raft.messages import (
    NONE, ConfChange, ConfChangeType, Entry, EntryType, HardState, LOCAL_MSGS,
    Message, MsgType, Snapshot, SoftState,
)


@dataclass
class Ready:
    soft_state: Optional[SoftState] = None
    hard_state: Optional[HardState] = None
    entries: list = field(default_factory=list)            # to persist
    snapshot: Optional[Snapshot] = None                    # to persist+apply
    committed_entries: list = field(default_factory=list)  # to apply
    messages: list = field(default_factory=list)           # to send

    def contains_updates(self) -> bool:
        return bool(self.soft_state or self.hard_state or self.entries
                    or self.snapshot or self.committed_entries or self.messages)


class RawNode:
    def __init__(self, cfg: Config, log: Optional[RaftLog] = None,
                 hard_state: Optional[HardState] = None,
                 voters: Optional[Sequence[int]] = None):
        self.raft = Raft(cfg, log=log, hard_state=hard_state, voters=voters)
        self._prev_soft = self.raft.soft_state()
        self._prev_hard = self.raft.hard_state()

    # -- inputs ------------------------------------------------------------
    def tick(self) -> None:
        self.raft.tick()

    def campaign(self) -> None:
        self.raft.step(Message(type=MsgType.HUP, frm=self.raft.id))

    def propose(self, data: bytes) -> None:
        self.raft.step(Message(type=MsgType.PROP, frm=self.raft.id,
                               entries=(Entry(data=data),)))

    def propose_conf_change(self, cc: ConfChange) -> None:
        from swarmkit_tpu_torch.raft.wire import encode_conf_change
        self.raft.step(Message(
            type=MsgType.PROP, frm=self.raft.id,
            entries=(Entry(type=EntryType.CONF_CHANGE,
                           data=encode_conf_change(cc)),)))

    def step(self, m: Message) -> None:
        if m.type in LOCAL_MSGS and m.frm != self.raft.id:
            raise ValueError(f"cannot step local message {m.type} from remote")
        if m.frm in self.raft.prs or m.type not in (MsgType.APP_RESP,
                                                    MsgType.HEARTBEAT_RESP,
                                                    MsgType.VOTE_RESP,
                                                    MsgType.PRE_VOTE_RESP):
            self.raft.step(m)

    def apply_conf_change(self, cc: ConfChange) -> tuple:
        if cc.type == ConfChangeType.ADD_NODE:
            self.raft.add_node(cc.node_id)
        elif cc.type == ConfChangeType.REMOVE_NODE:
            self.raft.remove_node(cc.node_id)
        elif cc.type == ConfChangeType.UPDATE_NODE:
            self.raft.pending_conf = False
        return self.raft.voter_ids()

    def report_unreachable(self, pid: int) -> None:
        self.raft.step(Message(type=MsgType.UNREACHABLE, frm=pid,
                               to=self.raft.id))

    def report_snapshot(self, pid: int, ok: bool) -> None:
        self.raft.step(Message(type=MsgType.SNAP_STATUS, frm=pid,
                               to=self.raft.id, reject=not ok))

    def transfer_leadership(self, to: int) -> None:
        self.raft.transfer_leadership(to)

    # -- outputs -----------------------------------------------------------
    def has_ready(self) -> bool:
        r = self.raft
        if r.soft_state() != self._prev_soft:
            return True
        if r.hard_state() != self._prev_hard:
            return True
        if r.log.pending_snapshot is not None:
            return True
        if r.msgs or r.log.unstable_entries() or r.log.unapplied_entries():
            return True
        return False

    def ready(self) -> Ready:
        r = self.raft
        rd = Ready()
        ss = r.soft_state()
        if ss != self._prev_soft:
            rd.soft_state = ss
        hs = r.hard_state()
        if hs != self._prev_hard:
            rd.hard_state = hs
        rd.entries = r.log.unstable_entries()
        rd.committed_entries = r.log.unapplied_entries()
        if r.log.pending_snapshot is not None:
            rd.snapshot = r.log.pending_snapshot
        rd.messages = r.msgs
        r.msgs = []
        return rd

    def advance(self, rd: Ready) -> None:
        r = self.raft
        if rd.soft_state is not None:
            self._prev_soft = rd.soft_state
        if rd.hard_state is not None:
            self._prev_hard = rd.hard_state
        if rd.entries:
            r.log.stabilized(rd.entries[-1].index)
        if rd.snapshot is not None:
            r.log.pending_snapshot = None
        if rd.committed_entries:
            r.log.applied_to(rd.committed_entries[-1].index)

    # -- views -------------------------------------------------------------
    @property
    def id(self) -> int:
        return self.raft.id

    def status(self) -> dict:
        r = self.raft
        return {
            "id": r.id, "term": r.term, "vote": r.vote, "state": r.state,
            "lead": r.lead, "commit": r.log.committed,
            "applied": r.log.applied, "last_index": r.log.last_index(),
            "voters": r.voter_ids(),
        }
