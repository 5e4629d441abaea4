"""Hot-path latency timers + a process-wide metric registry.

Reference: the prometheus timers wrapped around the exact same paths —
propose latency (manager/state/raft/raft.go:69-71,1589), snapshot save
latency (manager/state/raft/storage.go:20-29), and store
read/write/batch-transaction durations (manager/state/store/memory.go:81-110).
Metric names are kept reference-compatible so dashboards translate 1:1.

Timers keep a bounded reservoir of recent observations for percentile
queries (`swarmctl metrics` surfaces p50/p90/p99) plus exact count/sum.

The port's own copy of the JAX package's utils/metrics.py.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

RESERVOIR = 2048

# reference-compatible metric names
RAFT_PROPOSE_LATENCY = "swarm_raft_propose_latency_seconds"
RAFT_SNAPSHOT_LATENCY = "swarm_raft_snapshot_latency_seconds"
STORE_READ_TX_LATENCY = "swarm_store_read_tx_latency_seconds"
STORE_WRITE_TX_LATENCY = "swarm_store_write_tx_latency_seconds"
STORE_BATCH_LATENCY = "swarm_store_batch_latency_seconds"


class Timer:
    __slots__ = ("name", "count", "sum", "_recent", "_i")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._recent: list[float] = []
        self._i = 0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.sum += seconds
        if len(self._recent) < RESERVOIR:
            self._recent.append(seconds)
        else:  # ring overwrite: keeps the newest window, O(1)
            self._recent[self._i] = seconds
            self._i = (self._i + 1) % RESERVOIR
        return None

    def percentile(self, p: float) -> float:
        """p in [0, 100] over the recent reservoir (0.0 when empty)."""
        if not self._recent:
            return 0.0
        s = sorted(self._recent)
        k = min(len(s) - 1, max(0, round(p / 100 * (len(s) - 1))))
        return s[k]

    def summary(self) -> dict:
        return {"count": self.count, "sum": round(self.sum, 6),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class Registry:
    def __init__(self) -> None:
        self._timers: dict[str, Timer] = {}

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            t = self._timers[name] = Timer(name)
        return t

    def snapshot(self) -> dict[str, dict]:
        return {name: t.summary() for name, t in sorted(self._timers.items())}

    def reset(self) -> None:
        self._timers.clear()


REGISTRY = Registry()


def timer(name: str) -> Timer:
    return REGISTRY.timer(name)


class timed:
    """Context manager: time a block into (registry or REGISTRY)[name]."""

    __slots__ = ("_t", "_clock", "_start")

    def __init__(self, name: str,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[Registry] = None) -> None:
        self._t = (registry or REGISTRY).timer(name)
        self._clock = clock or time.perf_counter
        self._start = 0.0

    def __enter__(self) -> "timed":
        self._start = self._clock()
        return self

    def __exit__(self, *exc) -> None:
        self._t.observe(self._clock() - self._start)
