"""Raft protocol message and log-entry types.

Behavioral reference: etcd/raft's raftpb package as SwarmKit vendors it
(raft.pb.go message/entry enums) — re-expressed as Python dataclasses. These are
the host-side golden types; the device sim packs the same information into
fixed-width arrays (swarmkit_tpu_torch.raft.sim).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

NONE = 0  # "no node" sentinel (etcd raft.None)


class EntryType(enum.IntEnum):
    NORMAL = 0
    CONF_CHANGE = 1


@dataclass(frozen=True)
class Entry:
    index: int = 0
    term: int = 0
    type: EntryType = EntryType.NORMAL
    data: bytes = b""


class ConfChangeType(enum.IntEnum):
    ADD_NODE = 0
    REMOVE_NODE = 1
    UPDATE_NODE = 2


@dataclass(frozen=True)
class ConfChange:
    id: int = 0
    type: ConfChangeType = ConfChangeType.ADD_NODE
    node_id: int = 0
    context: bytes = b""


class MsgType(enum.IntEnum):
    HUP = 0            # local: start election
    BEAT = 1           # local: leader heartbeat timer fired
    PROP = 2           # propose entries
    APP = 3            # append entries
    APP_RESP = 4
    VOTE = 5
    VOTE_RESP = 6
    SNAP = 7
    HEARTBEAT = 8
    HEARTBEAT_RESP = 9
    UNREACHABLE = 10   # local report: peer unreachable
    SNAP_STATUS = 11   # local report: snapshot send finished/failed
    CHECK_QUORUM = 12  # local: leader lease check
    TRANSFER_LEADER = 13
    TIMEOUT_NOW = 14
    PRE_VOTE = 15
    PRE_VOTE_RESP = 16


LOCAL_MSGS = {MsgType.HUP, MsgType.BEAT, MsgType.UNREACHABLE,
              MsgType.SNAP_STATUS, MsgType.CHECK_QUORUM}

# Context marker for leadership-transfer campaigns (etcd campaignTransfer).
CAMPAIGN_TRANSFER = b"CampaignTransfer"


@dataclass(frozen=True)
class SnapshotMeta:
    index: int = 0
    term: int = 0
    voters: tuple = ()  # member ids in the config at snapshot time


@dataclass(frozen=True)
class Snapshot:
    meta: SnapshotMeta = field(default_factory=SnapshotMeta)
    data: bytes = b""

    @property
    def empty(self) -> bool:
        return self.meta.index == 0


@dataclass
class Message:
    type: MsgType = MsgType.HUP
    to: int = NONE
    frm: int = NONE
    term: int = 0        # 0 => local message
    log_term: int = 0
    index: int = 0
    entries: tuple = ()
    commit: int = 0
    reject: bool = False
    reject_hint: int = 0
    snapshot: Optional[Snapshot] = None
    context: bytes = b""


@dataclass
class HardState:
    """Durable state that must hit the WAL before messages are sent."""

    term: int = 0
    vote: int = NONE
    commit: int = 0

    def is_empty(self) -> bool:
        return self.term == 0 and self.vote == NONE and self.commit == 0


@dataclass
class SoftState:
    lead: int = NONE
    state: str = "follower"  # follower | candidate | pre-candidate | leader


def vote_resp_type(t: MsgType) -> MsgType:
    return MsgType.VOTE_RESP if t == MsgType.VOTE else MsgType.PRE_VOTE_RESP
