"""Cumulative-to-delta conversion for device-counter publishers.

The kernel keeps *cumulative* counters on device (SimState.stats, the
read tallies, the telemetry histograms).  Registry counters are also
cumulative — so a publisher that calls ``fam.inc(cumulative)`` on every
scrape double-counts the entire history each time.  KernelObs originally
guarded this with per-instance ``_last`` lists, which breaks as soon as
two publisher instances feed the same registry (bench.py builds a fresh
KernelObs per measure() call): each instance re-baselines at zero and
re-adds the other's history.

The fix lives here, once, shared by KernelObs and TelemetryObs: one
:class:`CounterDeltas` table *per registry* (weakly keyed, so throwaway
test registries are collectible), keyed by series identity, converting a
cumulative reading into the increment since the previous scrape of that
registry — regardless of which publisher instance does the scraping.

Reset semantics: a cumulative reading *below* the previous one means a
new run (fresh SimState, counters restart at zero).  We re-baseline and
return the full reading, so the first scrape of a new run is counted
rather than silently dropped.  Within one run device counters are
monotone, so this never misfires mid-run.

Wrapping counters: the kernel's int32 counters wrap mod 2**32 (the summed
commit advance at n=4096 does every few hundred ticks).  A publisher that
passes the state's tick with each reading lets the table tell a wrap from
a new run: a tick past the previous scrape's continues the run, and the
delta is taken mod 2**32; a tick before it starts a new run.  A counter
that wraps more than once between two scrapes, or a new run first scraped
at a tick past the old run's last scrape, is still misread: scrape a run
at least once per wrap, and give a new run its own registry.
"""

from __future__ import annotations

import threading
import weakref

from .registry import MetricsRegistry

U32_MASK = 0xFFFF_FFFF


class CounterDeltas:
    """Per-registry last-seen table for cumulative device counters."""

    def __init__(self) -> None:
        self._last: dict[tuple, tuple[int, int | None]] = {}
        self._lock = threading.Lock()

    def advance(self, key: tuple, cumulative: int,
                tick: int | None = None) -> int:
        """Record `cumulative` for series `key`; return the delta since
        the previous reading (or the full reading after a reset).  With
        `tick` (the run's tick at the reading), an unsigned 32-bit counter
        read at a later tick than the previous reading advanced by the
        difference mod 2**32, and one read at an earlier tick restarted."""
        cumulative = int(cumulative)
        with self._lock:
            prev, prev_tick = self._last.get(key, (0, None))
            self._last[key] = (cumulative, tick)
        if tick is not None and prev_tick is not None:
            if tick > prev_tick:
                return (cumulative - prev) & U32_MASK
            if tick < prev_tick:
                return cumulative
        return cumulative - prev if cumulative >= prev else cumulative


_PER_REGISTRY: "weakref.WeakKeyDictionary[MetricsRegistry, CounterDeltas]" \
    = weakref.WeakKeyDictionary()
_GUARD = threading.Lock()


def deltas_for(registry: MetricsRegistry) -> CounterDeltas:
    """The (single) delta table attached to `registry`."""
    with _GUARD:
        table = _PER_REGISTRY.get(registry)
        if table is None:
            table = _PER_REGISTRY[registry] = CounterDeltas()
        return table
