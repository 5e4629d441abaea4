"""Shared transport-seam fault surface + declarative fault plans.

The PyTorch port's own copy of the JAX package's raft/faults.py (pure
Python and numpy, no JAX), kept for ``dst.schedule.from_fault_plan``; the
vocabulary and the lowering are the same line for line, so a plan lowers
to the same arrays in both packages.

Every raft wire in this repo (in-process asyncio ``Network``, the real-socket
``GrpcNetwork`` and the device-mesh mailbox ``DeviceMeshNet``) implements the
same injectable fault vocabulary, mirroring what the reference achieves with
real sockets in tests (WrappedListener drops, iptables partitions in BASELINE
configs):

- ``set_down(addr)``        — the node at `addr` is unreachable
- ``set_drop(frm, to, p)``  — probabilistic loss on a directed edge
- ``partition(*groups)``    — only nodes in the same group can talk
- ``set_delay(frm, to, s)`` — added latency on a directed edge
- ``crash_restart(addr)``   — sever wire-level state for a bounced process
                              (cached channels, staged mailbox slots)
- ``heal()``                — clear partitions, drops and delays

``FaultSurface`` holds the mutable fault state and decision helpers; wires
inherit it and consult ``_fault_blocked`` / ``lossy`` / ``delay_for`` on
their delivery paths (the in-process queue drain, the gRPC stub gate, the
device mailbox ``keep`` mask).  ``FaultPlan`` is the declarative form the
fault sweep (tools/fault_sweep.py) replays against each wire: a named list
of inject actions plus the repair actions that undo them.
"""

from __future__ import annotations

import random
from typing import Iterable


class FaultSurface:
    """Mutable fault state shared by every Network implementation."""

    def __init__(self, seed: int = 0) -> None:
        self._down: set[str] = set()
        self._drop: dict[tuple[str, str], float] = {}
        self._partitions: list[set[str]] = []
        self._delay: dict[tuple[str, str], float] = {}
        self._rng = random.Random(seed)
        self.delivered = 0
        self.dropped = 0

    # -- injection ---------------------------------------------------------
    def set_down(self, addr: str, down: bool = True) -> None:
        if down:
            self._down.add(addr)
        else:
            self._down.discard(addr)

    def set_drop(self, frm: str, to: str, p: float) -> None:
        if p <= 0:
            self._drop.pop((frm, to), None)
        else:
            self._drop[(frm, to)] = p

    def partition(self, *groups: Iterable[str]) -> None:
        self._partitions = [set(g) for g in groups]

    def set_delay(self, frm: str, to: str, seconds: float) -> None:
        if seconds <= 0:
            self._delay.pop((frm, to), None)
        else:
            self._delay[(frm, to)] = seconds

    def crash_restart(self, addr: str) -> None:
        """Sever wire-level state for a process bounce at `addr`.

        The base surface holds no per-connection state; wires that cache
        channels (GrpcNetwork) or stage undelivered payloads (DeviceMeshNet)
        override this to drop them, so a restarted process never receives
        traffic addressed to its previous incarnation."""

    def heal(self) -> None:
        self._partitions = []
        self._drop = {}
        self._delay = {}

    # -- decisions (consulted by delivery paths) ---------------------------
    def _fault_blocked(self, frm: str, to: str) -> bool:
        if to in self._down:
            return True
        for group in self._partitions:
            if (frm in group) != (to in group):
                return True
        return False

    def lossy(self, frm: str, to: str) -> bool:
        p = self._drop.get((frm, to), 0.0)
        return p > 0 and self._rng.random() < p

    def delay_for(self, frm: str, to: str) -> float:
        return self._delay.get((frm, to), 0.0)

    def faults_active(self) -> bool:
        return bool(self._down or self._drop or self._partitions
                    or self._delay)


class FaultPlan:
    """A named, replayable fault schedule: inject actions + repair actions.

    Actions are (method-name, args) pairs applied to any FaultSurface, so
    one plan definition runs identically against all three wires.  ``heal``
    runs the plan's repair actions (e.g. un-downing a node) and then the
    surface-wide ``heal()``.
    """

    def __init__(self, name: str, inject=(), repair=()) -> None:
        self.name = name
        self._inject = list(inject)
        self._repair = list(repair)

    def __repr__(self) -> str:
        return f"FaultPlan({self.name!r})"

    def inject(self, net: FaultSurface) -> None:
        for method, args in self._inject:
            getattr(net, method)(*args)

    def heal(self, net: FaultSurface) -> None:
        for method, args in self._repair:
            getattr(net, method)(*args)
        net.heal()

    # -- the five primitives ----------------------------------------------
    @classmethod
    def down(cls, addr: str) -> "FaultPlan":
        return cls(f"down({addr})",
                   inject=[("set_down", (addr, True))],
                   repair=[("set_down", (addr, False))])

    @classmethod
    def drop(cls, frm: str, to: str, p: float = 0.5,
             symmetric: bool = True) -> "FaultPlan":
        inject = [("set_drop", (frm, to, p))]
        if symmetric:
            inject.append(("set_drop", (to, frm, p)))
        return cls(f"drop({frm}<->{to},p={p})", inject=inject)

    @classmethod
    def split(cls, *groups: Iterable[str]) -> "FaultPlan":
        groups = tuple(tuple(g) for g in groups)
        return cls(f"partition({groups})",
                   inject=[("partition", groups)])

    @classmethod
    def delay(cls, frm: str, to: str, seconds: float,
              symmetric: bool = True) -> "FaultPlan":
        inject = [("set_delay", (frm, to, seconds))]
        if symmetric:
            inject.append(("set_delay", (to, frm, seconds)))
        return cls(f"delay({frm}<->{to},{seconds}s)", inject=inject)

    @classmethod
    def crash(cls, addr: str) -> "FaultPlan":
        return cls(f"crash_restart({addr})",
                   inject=[("crash_restart", (addr,))])


def plan_to_schedule(plan: FaultPlan, rows: dict[str, int], n: int,
                     ticks: int, inject_at: int = 0, heal_at=None,
                     seed: int = 0, tick_interval: float = 1.0) -> dict:
    """Lower a declarative FaultPlan into dense per-tick schedule arrays.

    The wire surfaces interpret faults at delivery time against live
    connection state; the DST kernel instead consumes the whole run as
    data — drop [T, N, N] and alive [T, N] — so each primitive lowers to a
    deterministic array pattern over the window [inject_at, heal_at):

    - ``set_down(addr)``      every edge INTO the row is dropped (the
                              surface blocks delivery TO down nodes)
    - ``set_drop(f, t, p)``   seeded Bernoulli per tick on the edge
    - ``partition(groups)``   cross-group edges dropped
    - ``set_delay(f, t, s)``  the synchronous wire retries every tick, so
                              a d-tick delay is the edge gated open only
                              every (d+1)-th tick (d = ceil(s / tick
                              interval)) — traffic lands d ticks late
    - ``crash_restart(addr)`` the row is not alive inside the window

    `rows` maps plan addresses to kernel row indices.  Returns numpy
    arrays (``dst.schedule.from_fault_plan`` wraps them on device).
    """
    import math

    import numpy as np

    heal_at = ticks if heal_at is None else heal_at
    if not 0 <= inject_at <= heal_at <= ticks:
        raise ValueError(f"bad fault window [{inject_at}, {heal_at}) "
                         f"for {ticks} ticks")
    drop = np.zeros((ticks, n, n), bool)
    alive = np.ones((ticks, n), bool)
    rng = np.random.default_rng(seed)
    win = slice(inject_at, heal_at)
    wlen = heal_at - inject_at

    for method, args in plan._inject:
        if method == "set_down":
            addr, down = (args + (True,))[:2]
            if down:
                drop[win, :, rows[addr]] = True
        elif method == "set_drop":
            frm, to, p = args
            drop[win, rows[frm], rows[to]] |= rng.random(wlen) < p
        elif method == "partition":
            groups = [set(rows[a] for a in g) for g in args]
            for i in range(n):
                for j in range(n):
                    if any((i in g) != (j in g) for g in groups):
                        drop[win, i, j] = True
        elif method == "set_delay":
            frm, to, seconds = args
            d = max(1, math.ceil(seconds / tick_interval))
            t = np.arange(inject_at, heal_at)
            drop[win, rows[frm], rows[to]] |= ((t - inject_at) % (d + 1)) != d
        elif method == "crash_restart":
            alive[win, rows[args[0]]] = False
        else:
            raise ValueError(f"cannot lower fault action {method!r}")
    return {"drop": drop, "alive": alive}
