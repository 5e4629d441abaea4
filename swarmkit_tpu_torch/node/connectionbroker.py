"""Chooses which manager an agent-side RPC talks to.

Reference: connectionbroker/broker.go (123 LoC) — prefer the local manager
when this node runs one (the reference dials the local socket and lets the
generated raft proxies forward to the leader); otherwise pick a remote from
the weighted address book.  In this in-process build the "dial" is a
``dialer(addr) -> Manager`` lookup, and instead of RPC-level proxying we
resolve to the current LEADER's dispatcher directly (the proxy's net
effect).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from swarmkit_tpu_torch.node.remotes import Remotes

log = logging.getLogger("swarmkit_tpu_torch.connectionbroker")


class NoManagerError(Exception):
    pass


class ConnectionBroker:
    def __init__(self, remotes: Remotes,
                 dialer: Callable[[str], Optional[object]],
                 local_manager: Callable[[], Optional[object]] = lambda: None
                 ) -> None:
        self.remotes = remotes
        self.dialer = dialer
        self.local_manager = local_manager

    def _leader_of(self, manager) -> Optional[object]:
        """Resolve a manager to the cluster leader's Manager object."""
        if manager is None:
            return None
        try:
            if manager.is_leader():
                return manager
            leader_addr = manager.leader_addr
        except Exception:
            return None
        if not leader_addr:
            return None
        return self.dialer(leader_addr)

    def select_leader(self):
        """Resolve the cluster leader's Manager, preferring the local
        manager as the route in (reference: broker.Select, local socket
        first).  Raises NoManagerError when unreachable."""
        candidates = []
        local = self.local_manager()
        if local is not None:
            candidates.append(local)
        tried = {id(local)} if local is not None else set()
        for addr in sorted(self.remotes.weights(),
                           key=lambda a: -self.remotes.weights()[a]):
            m = self.dialer(addr)
            if m is not None and id(m) not in tried:
                candidates.append(m)
                tried.add(id(m))
        for m in candidates:
            leader = self._leader_of(m)
            if leader is not None:
                return leader
        raise NoManagerError("cannot locate the cluster leader")

    def select_dispatcher(self):
        d = self.select_leader().dispatcher
        if d is None:
            # a RemoteManager whose channel hasn't connected yet
            raise NoManagerError("leader connection not established yet")
        return d

    def select_logbroker(self):
        lb = getattr(self.select_leader(), "logbroker", None)
        if lb is None:
            raise NoManagerError("leader connection not established yet")
        return lb

    def select_control(self):
        c = self.select_leader().control_api
        if c is None:
            raise NoManagerError("leader connection not established yet")
        return c

    def select_ca(self):
        ca = self.select_leader().ca_server
        if ca is None:
            raise NoManagerError("leader has no CA server")
        return ca
