"""Registered-node store with heartbeat-TTL liveness.

Reference: manager/dispatcher/nodes.go (nodeStore, :44) and
manager/dispatcher/heartbeat/heartbeat.go.  Each registered node carries a
session ID and a heartbeat deadline; missing the deadline fires the expire
callback (which marks the node DOWN in the cluster store).  The per-node
``time.AfterFunc`` timer becomes a per-node asyncio task sleeping on the
injectable Clock, so tests drive expiry deterministically with FakeClock.

Rate limiting of re-registrations mirrors nodes.go:73-90 (RateLimitPeriod
8 s, CheckRateLimit counts rapid re-registrations).

The port's own copy of the JAX package's manager/dispatcher/nodes.py.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from swarmkit_tpu_torch.utils.clock import Clock
from swarmkit_tpu_torch.utils.identity import new_id

# reference: dispatcher.go:31-36
DEFAULT_HEARTBEAT_PERIOD = 5.0
DEFAULT_HEARTBEAT_EPSILON = 0.5
DEFAULT_GRACE_PERIOD_MULTIPLIER = 3
DEFAULT_RATE_LIMIT_PERIOD = 8.0


class ErrNodeNotRegistered(Exception):
    """Reference: dispatcher/errors: node not registered."""


class ErrSessionInvalid(Exception):
    """Session ID does not match the registered session."""


class _Heartbeat:
    """One node's liveness timer (reference: heartbeat/heartbeat.go)."""

    def __init__(self, clock: Clock, timeout: float,
                 timeout_func: Callable[[], None]) -> None:
        self._clock = clock
        self._deadline = clock.now() + timeout
        self._timeout_func = timeout_func
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def update(self, timeout: float) -> None:
        self._deadline = self._clock.now() + timeout

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        try:
            while not self._stopped:
                remaining = self._deadline - self._clock.now()
                if remaining <= 0:
                    self._timeout_func()
                    return
                await self._clock.sleep(remaining)
        except asyncio.CancelledError:
            pass


@dataclass
class RegisteredNode:
    session_id: str
    node_id: str
    description: object = None
    addr: str = ""
    heartbeat: Optional[_Heartbeat] = None
    registrations: list[float] = field(default_factory=list)
    # disconnect notification: closed when the session is superseded/expired
    disconnect: asyncio.Event = field(default_factory=asyncio.Event)

    def check_session(self, session_id: str) -> None:
        if session_id != self.session_id:
            raise ErrSessionInvalid(
                f"session {session_id!r} invalid for node {self.node_id}")


class NodeStore:
    """Reference: manager/dispatcher/nodes.go nodeStore."""

    def __init__(self, clock: Clock,
                 period: float = DEFAULT_HEARTBEAT_PERIOD,
                 epsilon: float = DEFAULT_HEARTBEAT_EPSILON,
                 grace_multiplier: int = DEFAULT_GRACE_PERIOD_MULTIPLIER,
                 rate_limit_period: float = DEFAULT_RATE_LIMIT_PERIOD,
                 rng: Optional[random.Random] = None) -> None:
        self.clock = clock
        self.period = period
        self.epsilon = epsilon
        self.grace_multiplier = grace_multiplier
        self.rate_limit_period = rate_limit_period
        self.nodes: dict[str, RegisteredNode] = {}
        self._rng = rng or random.Random()

    # period ± epsilon (reference: period.go periodChooser)
    def choose_period(self) -> float:
        return self.period + self._rng.uniform(-self.epsilon, self.epsilon)

    def check_rate_limit(self, node_id: str) -> bool:
        """True if the node re-registers too fast (nodes.go:73-90)."""
        rn = self.nodes.get(node_id)
        if rn is None or self.rate_limit_period <= 0:
            return False
        now = self.clock.now()
        rn.registrations = [t for t in rn.registrations
                            if now - t < self.rate_limit_period]
        return len(rn.registrations) >= 3

    def add(self, node_id: str, description, addr: str,
            expire_func: Callable[[str], None]) -> RegisteredNode:
        """Register (or re-register) a node; supersedes any prior session."""
        old = self.nodes.get(node_id)
        history: list[float] = []
        if old is not None:
            history = old.registrations
            if old.heartbeat is not None:
                old.heartbeat.stop()
            old.disconnect.set()
        history.append(self.clock.now())
        rn = RegisteredNode(session_id=new_id(), node_id=node_id,
                            description=description, addr=addr,
                            registrations=history)
        timeout = self.choose_period() * self.grace_multiplier
        rn.heartbeat = _Heartbeat(
            self.clock, timeout,
            lambda nid=node_id: self._expire(nid, expire_func))
        rn.heartbeat.start()
        self.nodes[node_id] = rn
        return rn

    def _expire(self, node_id: str, expire_func: Callable[[str], None]) -> None:
        rn = self.nodes.pop(node_id, None)
        if rn is not None:
            rn.disconnect.set()
            expire_func(node_id)

    def get(self, node_id: str) -> RegisteredNode:
        rn = self.nodes.get(node_id)
        if rn is None:
            raise ErrNodeNotRegistered(node_id)
        return rn

    def get_with_session(self, node_id: str, session_id: str) -> RegisteredNode:
        rn = self.get(node_id)
        rn.check_session(session_id)
        return rn

    def heartbeat(self, node_id: str, session_id: str) -> float:
        """Reset the TTL; returns the next period (dispatcher.go:1177)."""
        rn = self.get_with_session(node_id, session_id)
        period = self.choose_period()
        if rn.heartbeat is not None:
            rn.heartbeat.update(period * self.grace_multiplier)
        return period

    def delete(self, node_id: str) -> None:
        rn = self.nodes.pop(node_id, None)
        if rn is not None:
            if rn.heartbeat is not None:
                rn.heartbeat.stop()
            rn.disconnect.set()

    def delete_all(self) -> None:
        for node_id in list(self.nodes):
            self.delete(node_id)

    def __len__(self) -> int:
        return len(self.nodes)
