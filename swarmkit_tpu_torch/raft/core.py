"""The raft consensus state machine — host-side golden implementation.

Behavioral reference: vendor/github.com/coreos/etcd/raft/raft.go (Step,
stepLeader/stepCandidate/stepFollower, campaign/poll, maybeCommit quorum rule
at raft.go:478-486, becomeFollower/Candidate/Leader, handleAppendEntries,
checkQuorum lease, PreVote, leader transfer) and progress.go (probe/replicate/
snapshot flow control with inflight windows).

This is a from-scratch re-expression in Python: single-threaded, explicitly
clocked (tick() is a pure event — no goroutines, no timers), message-passing
via an outbox list. In the PyTorch port it is the golden core that
raft/sim/oracle.py drives, the oracle the batched torch tick
(swarmkit_tpu_torch.raft.sim) is differential-tested against; it is the
JAX package's core, copied with its import paths changed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from swarmkit_tpu_torch.raft.log import CompactedError, RaftLog, UnavailableError
from swarmkit_tpu_torch.raft.messages import (
    CAMPAIGN_TRANSFER, NONE, ConfChange, ConfChangeType, Entry, EntryType,
    HardState, Message, MsgType, Snapshot, SnapshotMeta, SoftState,
    vote_resp_type,
)

FOLLOWER = "follower"
CANDIDATE = "candidate"
PRE_CANDIDATE = "pre-candidate"
LEADER = "leader"

# Progress.State (progress.go:12-20)
PROBE = "probe"
REPLICATE = "replicate"
SNAPSHOT = "snapshot"


class Progress:
    """Leader's view of one follower (progress.go)."""

    def __init__(self, next_idx: int, max_inflight: int, match: int = 0):
        self.match = match
        self.next = next_idx
        self.state = PROBE
        self.paused = False
        self.pending_snapshot = 0
        self.recent_active = False
        self.max_inflight = max_inflight
        self.inflights: list[int] = []  # last indexes of inflight appends

    def become_probe(self) -> None:
        if self.state == SNAPSHOT:
            pending = self.pending_snapshot
            self._reset(PROBE)
            self.next = max(self.match + 1, pending + 1)
        else:
            self._reset(PROBE)
            self.next = self.match + 1

    def become_replicate(self) -> None:
        self._reset(REPLICATE)
        self.next = self.match + 1

    def become_snapshot(self, snapshot_index: int) -> None:
        self._reset(SNAPSHOT)
        self.pending_snapshot = snapshot_index

    def _reset(self, state: str) -> None:
        self.paused = False
        self.pending_snapshot = 0
        self.state = state
        self.inflights = []

    def maybe_update(self, n: int) -> bool:
        updated = False
        if self.match < n:
            self.match = n
            updated = True
            self.paused = False
        if self.next < n + 1:
            self.next = n + 1
        return updated

    def optimistic_update(self, n: int) -> None:
        self.next = n + 1

    def maybe_decr_to(self, rejected: int, last: int) -> bool:
        if self.state == REPLICATE:
            if rejected <= self.match:
                return False  # stale rejection
            self.next = self.match + 1
            return True
        if self.next - 1 != rejected:
            return False  # stale
        self.next = max(min(rejected, last + 1), 1)
        self.paused = False
        return True

    def is_paused(self) -> bool:
        if self.state == PROBE:
            return self.paused
        if self.state == REPLICATE:
            return len(self.inflights) >= self.max_inflight
        return True  # SNAPSHOT

    def snapshot_failure(self) -> None:
        self.pending_snapshot = 0

    def need_snapshot_abort(self) -> bool:
        return self.state == SNAPSHOT and self.match >= self.pending_snapshot

    def inflight_add(self, last: int) -> None:
        self.inflights.append(last)

    def inflight_free_to(self, to: int) -> None:
        self.inflights = [i for i in self.inflights if i > to]

    def inflight_free_first(self) -> None:
        if self.inflights:
            self.inflights.pop(0)


@dataclass
class Config:
    id: int = 0
    peers: tuple = ()
    election_tick: int = 10
    heartbeat_tick: int = 1
    max_size_per_msg: int = 64       # entries per append (size proxy)
    max_inflight_msgs: int = 256
    check_quorum: bool = False
    pre_vote: bool = False
    # Deterministic PRNG for randomized election timeouts.
    seed: int = 0


class Raft:
    def __init__(self, cfg: Config, log: Optional[RaftLog] = None,
                 hard_state: Optional[HardState] = None,
                 voters: Optional[Sequence[int]] = None):
        assert cfg.id != NONE
        self.id = cfg.id
        self.cfg = cfg
        self.log = log or RaftLog()
        self.term = 0
        self.vote = NONE
        self.lead = NONE
        self.state = FOLLOWER
        self.prs: dict[int, Progress] = {}
        self.votes: dict[int, bool] = {}
        self.msgs: list[Message] = []
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        # Ticks since last CURRENT-TERM leader contact (append/heartbeat/
        # snapshot) — the CheckQuorum lease measures THIS, not
        # election_elapsed.  etcd-3.1 conflates the two (electionElapsed
        # resets on every campaign attempt, perpetually re-arming the lease
        # after total leader loss and livelocking PreVote elections when
        # randomized timeouts land on election_tick); the raft dissertation
        # (§4.2.3) defines the lease from leader contact.  The reference
        # never enables PreVote so it cannot hit this; we expose PreVote as
        # first-class and fix the lease.
        self.contact_elapsed = 0
        self.randomized_election_timeout = 0
        self.lead_transferee = NONE
        self.pending_conf = False
        # Materialized snapshot (set by the Node shell after each snapshot
        # save) used to catch up followers behind the compaction watermark.
        self.stored_snapshot: Optional[Snapshot] = None
        self._rng = random.Random((cfg.seed << 16) ^ cfg.id)
        self._step_fn: Callable[[Message], None] = self._step_follower

        for pid in (voters if voters is not None else cfg.peers):
            self.prs[pid] = Progress(1, cfg.max_inflight_msgs)
        if hard_state is not None and not hard_state.is_empty():
            self.term = hard_state.term
            self.vote = hard_state.vote
            self.log.commit_to(hard_state.commit)
        self.become_follower(self.term, NONE)

    # -- basic views -------------------------------------------------------
    def quorum(self) -> int:
        return len(self.prs) // 2 + 1

    def hard_state(self) -> HardState:
        return HardState(term=self.term, vote=self.vote, commit=self.log.committed)

    def soft_state(self) -> SoftState:
        return SoftState(lead=self.lead, state=self.state)

    def promotable(self) -> bool:
        return self.id in self.prs

    def voter_ids(self) -> tuple:
        return tuple(sorted(self.prs))

    # -- outbox ------------------------------------------------------------
    def _send(self, m: Message) -> None:
        m.frm = self.id
        if m.type in (MsgType.VOTE, MsgType.VOTE_RESP,
                      MsgType.PRE_VOTE, MsgType.PRE_VOTE_RESP):
            assert m.term != 0, f"{m.type} needs explicit term"
        else:
            assert m.term == 0, f"{m.type} must not set term"
            if m.type != MsgType.PROP:
                m.term = self.term
        self.msgs.append(m)

    # -- ticks -------------------------------------------------------------
    def tick(self) -> None:
        if self.state == LEADER:
            self._tick_heartbeat()
        else:
            self._tick_election()

    def _tick_election(self) -> None:
        self.election_elapsed += 1
        self.contact_elapsed += 1
        if self.promotable() and self.election_elapsed >= self.randomized_election_timeout:
            self.election_elapsed = 0
            self.step(Message(type=MsgType.HUP, frm=self.id))

    def _tick_heartbeat(self) -> None:
        self.heartbeat_elapsed += 1
        self.election_elapsed += 1
        self.contact_elapsed += 1
        if self.election_elapsed >= self.cfg.election_tick:
            self.election_elapsed = 0
            if self.cfg.check_quorum:
                self.step(Message(type=MsgType.CHECK_QUORUM, frm=self.id))
            if self.state == LEADER and self.lead_transferee != NONE:
                self._abort_leader_transfer()
        if self.state != LEADER:
            return
        if self.heartbeat_elapsed >= self.cfg.heartbeat_tick:
            self.heartbeat_elapsed = 0
            self.step(Message(type=MsgType.BEAT, frm=self.id))

    def _reset_randomized_election_timeout(self) -> None:
        self.randomized_election_timeout = (
            self.cfg.election_tick + self._rng.randrange(self.cfg.election_tick))

    # -- role transitions --------------------------------------------------
    def _reset(self, term: int) -> None:
        if self.term != term:
            self.term = term
            self.vote = NONE
        self.lead = NONE
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self._reset_randomized_election_timeout()
        self._abort_leader_transfer()
        self.votes = {}
        for pid in self.prs:
            pr = Progress(self.log.last_index() + 1, self.cfg.max_inflight_msgs)
            if pid == self.id:
                pr.match = self.log.last_index()
            self.prs[pid] = pr
        self.pending_conf = False

    def become_follower(self, term: int, lead: int) -> None:
        self._step_fn = self._step_follower
        self._reset(term)
        self.lead = lead
        self.state = FOLLOWER

    def become_candidate(self) -> None:
        assert self.state != LEADER, "leader -> candidate"
        self._step_fn = self._step_candidate
        self._reset(self.term + 1)
        self.vote = self.id
        self.state = CANDIDATE

    def become_pre_candidate(self) -> None:
        assert self.state != LEADER, "leader -> pre-candidate"
        # Does NOT bump term or change vote.
        self._step_fn = self._step_candidate
        self.votes = {}
        self.state = PRE_CANDIDATE

    def become_leader(self) -> None:
        assert self.state != FOLLOWER, "follower -> leader"
        self._step_fn = self._step_leader
        self._reset(self.term)
        self.lead = self.id
        self.state = LEADER
        self.contact_elapsed = 0
        ents = self.log.entries_from(self.log.committed + 1)
        if sum(1 for e in ents if e.type == EntryType.CONF_CHANGE) == 1:
            self.pending_conf = True
        self._append_entries([Entry(type=EntryType.NORMAL, data=b"")])

    # -- campaign ----------------------------------------------------------
    def _campaign(self, transfer: bool = False, pre: bool = False) -> None:
        if pre:
            self.become_pre_candidate()
            vote_msg = MsgType.PRE_VOTE
            term = self.term + 1
        else:
            self.become_candidate()
            vote_msg = MsgType.VOTE
            term = self.term
        if self._poll(self.id, True) >= self.quorum():
            if pre:
                self._campaign(transfer=transfer)
            else:
                self.become_leader()
            return
        ctx = CAMPAIGN_TRANSFER if transfer else b""
        for pid in self.prs:
            if pid == self.id:
                continue
            self._send(Message(
                type=vote_msg, to=pid, term=term,
                index=self.log.last_index(), log_term=self.log.last_term(),
                context=ctx))

    def _poll(self, pid: int, granted: bool) -> int:
        """Record first response per voter; tally grants over the CURRENT
        configuration (modern etcd counts via the tracker config, so a vote
        from a peer an applied conf change removed is dead weight)."""
        if pid not in self.votes:
            self.votes[pid] = granted
        return sum(1 for p, v in self.votes.items() if v and p in self.prs)

    def _poll_rejections(self) -> int:
        return sum(1 for p, v in self.votes.items()
                   if not v and p in self.prs)

    # -- replication sends -------------------------------------------------
    def _append_entries(self, ents: Sequence[Entry]) -> None:
        li = self.log.last_index()
        stamped = [Entry(index=li + 1 + i, term=self.term, type=e.type,
                         data=e.data) for i, e in enumerate(ents)]
        self.log.append(stamped)
        self.prs[self.id].maybe_update(self.log.last_index())
        self._maybe_commit()

    def _send_append(self, to: int) -> None:
        pr = self.prs[to]
        if pr.is_paused():
            return
        prev = pr.next - 1
        try:
            prev_term = self.log.term(prev)
            ents = self.log.slice(pr.next, self.log.last_index() + 1,
                                  self.cfg.max_size_per_msg)
        except (CompactedError, UnavailableError):
            # Follower is behind the compaction watermark: ship a snapshot.
            if not pr.recent_active:
                return
            # Prefer the materialized snapshot installed by the Node shell
            # (store + membership data at its index); fall back to a bare
            # compaction-point snapshot (etcd MemoryStorage.Snapshot analog).
            snap = self.stored_snapshot
            if snap is None or snap.meta.index < self.log.offset:
                meta = SnapshotMeta(index=self.log.offset,
                                    term=self.log.offset_term,
                                    voters=self.voter_ids())
                snap = Snapshot(meta=meta, data=self._snapshot_data())
            self._send(Message(type=MsgType.SNAP, to=to, snapshot=snap))
            pr.become_snapshot(snap.meta.index)
            return
        m = Message(type=MsgType.APP, to=to, index=prev, log_term=prev_term,
                    entries=tuple(ents), commit=self.log.committed)
        if ents:
            if pr.state == REPLICATE:
                pr.optimistic_update(ents[-1].index)
                pr.inflight_add(ents[-1].index)
            elif pr.state == PROBE:
                pr.paused = True
            else:
                raise AssertionError(f"sending append in state {pr.state}")
        self._send(m)

    def _snapshot_data(self) -> bytes:
        """Hook: Node shell overrides to attach real store snapshot bytes."""
        return b""

    def _bcast_append(self) -> None:
        for pid in self.prs:
            if pid != self.id:
                self._send_append(pid)

    def _bcast_heartbeat(self) -> None:
        for pid in self.prs:
            if pid != self.id:
                commit = min(self.prs[pid].match, self.log.committed)
                self._send(Message(type=MsgType.HEARTBEAT, to=pid, commit=commit))

    def _maybe_commit(self) -> bool:
        matches = sorted((pr.match for pr in self.prs.values()), reverse=True)
        mci = matches[self.quorum() - 1]
        return self.log.maybe_commit(mci, self.term)

    # -- Step --------------------------------------------------------------
    def step(self, m: Message) -> None:
        if m.term == 0:
            pass  # local message
        elif m.term > self.term:
            lead = m.frm
            if m.type in (MsgType.VOTE, MsgType.PRE_VOTE):
                force = m.context == CAMPAIGN_TRANSFER
                in_lease = (self.cfg.check_quorum and self.lead != NONE and
                            self.contact_elapsed < self.cfg.election_tick)
                if not force and in_lease:
                    return  # leader lease not expired; ignore
                lead = NONE
            if m.type == MsgType.PRE_VOTE:
                pass  # never change term for a PreVote request
            elif m.type == MsgType.PRE_VOTE_RESP and not m.reject:
                pass  # term will bump when we win
            else:
                self.become_follower(m.term, lead)
        elif m.term < self.term:
            if self.cfg.check_quorum and m.type in (MsgType.HEARTBEAT, MsgType.APP):
                # Stale leader (or we partitioned and advanced): nudge it.
                self._send(Message(type=MsgType.APP_RESP, to=m.frm))
            return

        if m.type == MsgType.HUP:
            if self.state != LEADER:
                ents = self.log.unapplied_entries()
                if any(e.type == EntryType.CONF_CHANGE for e in ents):
                    return  # pending conf change; cannot campaign
                self._campaign(pre=self.cfg.pre_vote)
            return
        if m.type in (MsgType.VOTE, MsgType.PRE_VOTE):
            can_vote = (self.vote == NONE or m.term > self.term
                        or self.vote == m.frm)
            if can_vote and self.log.is_up_to_date(m.index, m.log_term):
                self._send(Message(type=vote_resp_type(m.type), to=m.frm,
                                   term=m.term))
                if m.type == MsgType.VOTE:
                    self.election_elapsed = 0
                    self.vote = m.frm
            else:
                self._send(Message(type=vote_resp_type(m.type), to=m.frm,
                                   term=self.term, reject=True))
            return
        self._step_fn(m)

    # -- per-role steps ----------------------------------------------------
    def _step_leader(self, m: Message) -> None:
        if m.type == MsgType.BEAT:
            self._bcast_heartbeat()
            return
        if m.type == MsgType.CHECK_QUORUM:
            if not self._check_quorum_active():
                self.become_follower(self.term, NONE)
            else:
                # quorum contact confirmed: the leader's own lease re-arms
                self.contact_elapsed = 0
            return
        if m.type == MsgType.PROP:
            assert m.entries, "empty proposal"
            if self.id not in self.prs:
                raise ProposalDropped("proposer removed from configuration")
            if self.lead_transferee != NONE:
                raise ProposalDropped("leadership transfer in progress")
            ents = list(m.entries)
            for i, e in enumerate(ents):
                if e.type == EntryType.CONF_CHANGE:
                    if self.pending_conf:
                        ents[i] = Entry(type=EntryType.NORMAL, data=b"")
                    else:
                        self.pending_conf = True
            self._append_entries(ents)
            self._bcast_append()
            return

        pr = self.prs.get(m.frm)
        if pr is None:
            return
        if m.type == MsgType.APP_RESP:
            pr.recent_active = True
            if m.reject:
                if pr.maybe_decr_to(m.index, m.reject_hint):
                    if pr.state == REPLICATE:
                        pr.become_probe()
                    self._send_append(m.frm)
            else:
                old_paused = pr.is_paused()
                if pr.maybe_update(m.index):
                    if pr.state == PROBE:
                        pr.become_replicate()
                    elif pr.state == SNAPSHOT and pr.need_snapshot_abort():
                        pr.become_probe()
                    elif pr.state == REPLICATE:
                        pr.inflight_free_to(m.index)
                    if self._maybe_commit():
                        self._bcast_append()
                    elif old_paused:
                        self._send_append(m.frm)
                    if (m.frm == self.lead_transferee
                            and pr.match == self.log.last_index()):
                        self._send(Message(type=MsgType.TIMEOUT_NOW, to=m.frm))
        elif m.type == MsgType.HEARTBEAT_RESP:
            pr.recent_active = True
            pr.paused = False
            if pr.state == REPLICATE and len(pr.inflights) >= pr.max_inflight:
                pr.inflight_free_first()
            if pr.match < self.log.last_index():
                self._send_append(m.frm)
        elif m.type == MsgType.SNAP_STATUS:
            if pr.state != SNAPSHOT:
                return
            if not m.reject:
                pr.become_probe()
            else:
                pr.snapshot_failure()
                pr.become_probe()
            pr.paused = True
        elif m.type == MsgType.UNREACHABLE:
            if pr.state == REPLICATE:
                pr.become_probe()
        elif m.type == MsgType.TRANSFER_LEADER:
            transferee = m.frm
            if self.lead_transferee != NONE:
                if self.lead_transferee == transferee:
                    return
                self._abort_leader_transfer()
            if transferee == self.id:
                return
            self.election_elapsed = 0
            self.lead_transferee = transferee
            if pr.match == self.log.last_index():
                self._send(Message(type=MsgType.TIMEOUT_NOW, to=transferee))
            else:
                self._send_append(transferee)

    def _step_candidate(self, m: Message) -> None:
        my_resp = (MsgType.PRE_VOTE_RESP if self.state == PRE_CANDIDATE
                   else MsgType.VOTE_RESP)
        if m.type == MsgType.PROP:
            raise ProposalDropped(f"no leader at term {self.term}")
        if m.type == MsgType.APP:
            self.become_follower(self.term, m.frm)
            self.contact_elapsed = 0
            self._handle_append(m)
        elif m.type == MsgType.HEARTBEAT:
            self.become_follower(self.term, m.frm)
            self.contact_elapsed = 0
            self._handle_heartbeat(m)
        elif m.type == MsgType.SNAP:
            self.become_follower(m.term, m.frm)
            self.contact_elapsed = 0
            self._handle_snapshot(m)
        elif m.type == my_resp:
            # >= (not etcd's ==): identical decisions in the static-config
            # sequential case (counts rise by 1 per response, checked each
            # time), and well-defined when an applied conf change shrinks
            # the quorum below an already-recorded tally.
            gr = self._poll(m.frm, not m.reject)
            if gr >= self.quorum():
                if self.state == PRE_CANDIDATE:
                    self._campaign()
                else:
                    self.become_leader()
                    self._bcast_append()
            elif self._poll_rejections() >= self.quorum():
                self.become_follower(self.term, NONE)

    def _step_follower(self, m: Message) -> None:
        if m.type == MsgType.PROP:
            if self.lead == NONE:
                raise ProposalDropped(f"no leader at term {self.term}")
            m.to = self.lead
            m.frm = NONE  # will be restamped
            self._send(m)
        elif m.type == MsgType.APP:
            self.election_elapsed = 0
            self.contact_elapsed = 0
            self.lead = m.frm
            self._handle_append(m)
        elif m.type == MsgType.HEARTBEAT:
            self.election_elapsed = 0
            self.contact_elapsed = 0
            self.lead = m.frm
            self._handle_heartbeat(m)
        elif m.type == MsgType.SNAP:
            self.election_elapsed = 0
            self.contact_elapsed = 0
            self.lead = m.frm
            self._handle_snapshot(m)
        elif m.type == MsgType.TRANSFER_LEADER:
            if self.lead == NONE:
                return
            m.to = self.lead
            m.frm = NONE
            self._send(m)
        elif m.type == MsgType.TIMEOUT_NOW:
            if self.promotable():
                # Transfer campaigns skip prevote by design.
                self._campaign(transfer=True)

    # -- message handlers --------------------------------------------------
    def _handle_append(self, m: Message) -> None:
        if m.index < self.log.committed:
            self._send(Message(type=MsgType.APP_RESP, to=m.frm,
                               index=self.log.committed))
            return
        last = self.log.maybe_append(m.index, m.log_term, m.commit, m.entries)
        if last is not None:
            self._send(Message(type=MsgType.APP_RESP, to=m.frm, index=last))
        else:
            self._send(Message(type=MsgType.APP_RESP, to=m.frm, index=m.index,
                               reject=True,
                               reject_hint=self.log.last_index()))

    def _handle_heartbeat(self, m: Message) -> None:
        # Leader sends commit=min(match, committed); clamping to our last
        # index keeps a node that lost state out-of-band (wiped disk) alive —
        # the reference panics here, but the sim prefers graceful re-sync.
        self.log.commit_to(min(m.commit, self.log.last_index()))
        self._send(Message(type=MsgType.HEARTBEAT_RESP, to=m.frm,
                           context=m.context))

    def _handle_snapshot(self, m: Message) -> None:
        meta = m.snapshot.meta
        if self._restore(m.snapshot):
            self._send(Message(type=MsgType.APP_RESP, to=m.frm,
                               index=self.log.last_index()))
        else:
            self._send(Message(type=MsgType.APP_RESP, to=m.frm,
                               index=self.log.committed))

    def _restore(self, snap: Snapshot) -> bool:
        if snap.meta.index <= self.log.committed:
            return False
        if self.log.match_term(snap.meta.index, snap.meta.term):
            # Log already contains the snapshot point: fast-forward commit.
            self.log.commit_to(snap.meta.index)
            return False
        self.log.restore(snap)
        self.prs = {}
        for pid in snap.meta.voters:
            match = self.log.last_index() if pid == self.id else 0
            pr = Progress(self.log.last_index() + 1,
                          self.cfg.max_inflight_msgs, match=match)
            self.prs[pid] = pr
        return True

    # -- checkQuorum -------------------------------------------------------
    def _check_quorum_active(self) -> bool:
        act = 0
        for pid, pr in self.prs.items():
            if pid == self.id:
                act += 1
                continue
            if pr.recent_active:
                act += 1
            pr.recent_active = False
        return act >= self.quorum()

    # -- membership --------------------------------------------------------
    def add_node(self, pid: int) -> None:
        self.pending_conf = False
        if pid in self.prs:
            return
        self.prs[pid] = Progress(self.log.last_index() + 1,
                                 self.cfg.max_inflight_msgs)
        # A new joiner is considered recently active (raft.go addNode).
        self.prs[pid].recent_active = True

    def remove_node(self, pid: int, recheck: bool = True) -> None:
        """`recheck=False` defers the quorum-lowering commit re-check to the
        next commit evaluation (the sim oracle's once-per-tick Phase D —
        same decision one tick later); the Node shell keeps the reference's
        immediate re-check."""
        self.prs.pop(pid, None)
        self.pending_conf = False
        if not self.prs:
            return
        # Removal can lower the quorum size: re-check commit.
        if recheck and self.state == LEADER and self._maybe_commit():
            self._bcast_append()
        if self.state == LEADER and self.lead_transferee == pid:
            self._abort_leader_transfer()

    def _abort_leader_transfer(self) -> None:
        self.lead_transferee = NONE

    def transfer_leadership(self, to: int) -> None:
        self.step(Message(type=MsgType.TRANSFER_LEADER, frm=to, to=self.id))


class ProposalDropped(Exception):
    """Raised when a proposal cannot be accepted right now (no leader, etc.)."""
