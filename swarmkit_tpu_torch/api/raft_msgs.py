"""Raft wire/log types. Reference: api/raft.proto, api/snapshot.proto.

The port's own copy of the JAX package's api/raft_msgs.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.objects import OBJECT_KINDS, kind_of
from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.types import RaftMember


class StoreActionKind(enum.IntEnum):
    UNKNOWN = 0
    CREATE = 1
    UPDATE = 2
    REMOVE = 3


@dataclass
class StoreAction(Message):
    """One object mutation inside a raft log entry
    (api/raft.proto StoreAction :127-139)."""

    action: StoreActionKind = StoreActionKind.UNKNOWN
    kind: str = ""          # object kind name from OBJECT_KINDS
    target: dict = field(default_factory=dict)  # serialized object

    @classmethod
    def make(cls, action: StoreActionKind, obj) -> "StoreAction":
        return cls(action=action, kind=kind_of(obj), target=obj.to_dict())

    def object(self):
        return OBJECT_KINDS[self.kind].from_dict(self.target)


@dataclass
class InternalRaftRequest(Message):
    """The unit proposed to raft (api/raft.proto InternalRaftRequest :116)."""

    id: int = 0
    actions: list[StoreAction] = field(default_factory=list)


@dataclass
class StoreSnapshot(Message):
    """Full dump of every object table (api/snapshot.proto StoreSnapshot)."""

    objects: dict[str, list] = field(default_factory=dict)  # kind -> [obj dicts]


@dataclass
class ClusterMember(Message):
    raft_id: int = 0
    node_id: str = ""
    addr: str = ""


@dataclass
class ClusterSnapshot(Message):
    members: list[ClusterMember] = field(default_factory=list)
    removed: list[int] = field(default_factory=list)


@dataclass
class Snapshot(Message):
    version: int = 0
    membership: ClusterSnapshot = field(default_factory=ClusterSnapshot)
    store: StoreSnapshot = field(default_factory=StoreSnapshot)
