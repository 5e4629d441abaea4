"""Raft cluster membership registry.

Reference: manager/state/raft/membership/cluster.go — active members, the
permanent blacklist of removed ids (never reused), conf-change validation,
and a broadcast queue that fires whenever the peer list changes.

The port's own copy of the JAX package's raft/membership.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from swarmkit_tpu_torch.raft.messages import ConfChange, ConfChangeType
from swarmkit_tpu_torch.watch.queue import Queue


class MembershipError(Exception):
    pass


ERR_ID_EXISTS = "member with this id already exists"
ERR_ID_REMOVED = "member with this id was removed and can never rejoin"
ERR_ID_NOT_FOUND = "member with this id does not exist"
ERR_CONFIG_CHANGE_INVALID = "configuration change is invalid"


@dataclass
class Member:
    raft_id: int = 0
    node_id: str = ""     # swarm node id (cert CN)
    addr: str = ""


class Cluster:
    """reference: membership.Cluster cluster.go:30."""

    def __init__(self) -> None:
        self.members: dict[int, Member] = {}
        self.removed: set[int] = set()
        self.broadcast = Queue()   # PeersBroadcast (cluster.go:38)

    def is_id_removed(self, raft_id: int) -> bool:
        return raft_id in self.removed

    def get_member(self, raft_id: int) -> Optional[Member]:
        return self.members.get(raft_id)

    def add_member(self, m: Member) -> None:
        if m.raft_id in self.removed:
            raise MembershipError(ERR_ID_REMOVED)
        self.members[m.raft_id] = m
        self.broadcast.publish(tuple(self.members))

    def remove_member(self, raft_id: int) -> None:
        """Remove AND blacklist (cluster.go:114)."""
        self.removed.add(raft_id)
        if raft_id in self.members:
            del self.members[raft_id]
        self.broadcast.publish(tuple(self.members))

    def update_member(self, raft_id: int, addr: str) -> None:
        m = self.members.get(raft_id)
        if m is None:
            raise MembershipError(ERR_ID_NOT_FOUND)
        if m.addr != addr:
            m.addr = addr
            self.broadcast.publish(tuple(self.members))

    def clear(self) -> None:
        self.members = {}
        self.removed = set()

    def validate_configuration_change(self, cc: ConfChange) -> None:
        """reference: ValidateConfigurationChange cluster.go:185."""
        if cc.node_id in self.removed:
            raise MembershipError(ERR_ID_REMOVED)
        if cc.type == ConfChangeType.ADD_NODE:
            if cc.node_id in self.members:
                raise MembershipError(ERR_ID_EXISTS)
        elif cc.type in (ConfChangeType.REMOVE_NODE,
                         ConfChangeType.UPDATE_NODE):
            if cc.node_id not in self.members:
                raise MembershipError(ERR_ID_NOT_FOUND)
        else:
            raise MembershipError(ERR_CONFIG_CHANGE_INVALID)
