"""Tick <-> wall-clock correlation for the causal trace export.

The device planes (flight ring, telemetry series) timestamp in ticks —
unitless scan iterations — while host tracer spans carry wall-clock
seconds.  :class:`ClockSync` collects ``(tick, host_ns)`` sync points at
host<->device exchange boundaries (each blocking ``device_get`` of
``state.tick`` is an observation of "the device was at tick T when my
clock read t_ns") and fits a robust line through them, so the export
layer (flightrec/export.py) can place device instants on the same
wall-clock axis as the host spans and draw flow arrows between them.

The fit is Theil–Sen (median of pairwise slopes): a stalled host thread,
an NTP step, or one garbage sample shifts the median far less than a
least-squares fit, and the estimator degrades gracefully — one sync
point anchors an offset with the caller's nominal tick rate, zero sync
points leaves the export on its synthetic tick-as-µs axis.  Residuals
and sample counts publish as ``swarm_trace_clock_*`` metrics so drift
between the two clock domains is visible on the scrape page.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Optional

MAX_SYNC_POINTS = 256


@dataclass(frozen=True)
class ClockFit:
    """host_ns(tick) = intercept_ns + slope_ns_per_tick * tick."""
    slope_ns_per_tick: float
    intercept_ns: float
    n_samples: int
    residual_ns: float      # max |fit - sample| over the sync points
    degenerate: bool        # True when < 2 usable points pinned the slope

    def host_ns_at(self, tick) -> float:
        return self.intercept_ns + self.slope_ns_per_tick * float(tick)

    def to_dict(self) -> dict:
        return {"slope_ns_per_tick": self.slope_ns_per_tick,
                "intercept_ns": self.intercept_ns,
                "n_samples": self.n_samples,
                "residual_ns": self.residual_ns,
                "degenerate": self.degenerate}


class ClockSync:
    """Bounded sync-point collector + robust linear fit.

    ``fallback_tick_us`` is the nominal tick duration used when the
    samples cannot pin a slope themselves (0 or 1 point, or all points
    at one tick).  The default clock is ``time.time_ns()`` — the same
    wall-clock domain as metrics/trace.py spans — so a fit maps ticks
    straight onto the span timeline; pass explicit ``host_ns`` values
    to correlate against a different clock.
    """

    def __init__(self, fallback_tick_us: float = 1.0) -> None:
        if fallback_tick_us <= 0:
            raise ValueError(f"fallback_tick_us must be > 0, "
                             f"got {fallback_tick_us}")
        self.fallback_tick_us = float(fallback_tick_us)
        self.samples: list[tuple[int, int]] = []
        self.discarded = 0   # over-capacity evictions (oldest-first)

    def add(self, tick, host_ns: Optional[int] = None) -> None:
        """Record one sync point.  `tick` may be a device scalar (it is
        read back here — callers already paid the sync that makes the
        observation meaningful).  Non-monotonic and duplicate samples
        are kept: the robust fit, not the collector, decides what an
        outlier is."""
        t = int(tick)
        ns = time.time_ns() if host_ns is None else int(host_ns)
        self.samples.append((t, ns))
        if len(self.samples) > MAX_SYNC_POINTS:
            del self.samples[0]
            self.discarded += 1

    def fit(self) -> Optional[ClockFit]:
        """Theil–Sen fit over the sync points; None when empty."""
        if not self.samples:
            return None
        fallback_slope = self.fallback_tick_us * 1e3  # ns per tick
        pts = sorted(self.samples)
        slopes = [(ns_b - ns_a) / (t_b - t_a)
                  for i, (t_a, ns_a) in enumerate(pts)
                  for (t_b, ns_b) in pts[i + 1:]
                  if t_b != t_a]
        # A wall clock stepped backwards (or a tick observed out of
        # order) yields non-positive pairwise slopes; ticks never run
        # backwards, so those pairs are clock artifacts, not evidence.
        slopes = [s for s in slopes if s > 0]
        degenerate = not slopes
        slope = statistics.median(slopes) if slopes else fallback_slope
        intercept = statistics.median(ns - slope * t for t, ns in pts)
        residual = max(abs(intercept + slope * t - ns) for t, ns in pts)
        return ClockFit(slope_ns_per_tick=float(slope),
                        intercept_ns=float(intercept),
                        n_samples=len(pts), residual_ns=float(residual),
                        degenerate=degenerate)

    def to_dict(self) -> dict:
        d = {"fallback_tick_us": self.fallback_tick_us,
             "discarded": self.discarded,
             "samples": [[t, ns] for t, ns in self.samples]}
        f = self.fit()
        if f is not None:
            d["fit"] = f.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ClockSync":
        cs = cls(fallback_tick_us=d.get("fallback_tick_us", 1.0))
        cs.samples = [(int(t), int(ns)) for t, ns in d.get("samples", ())]
        cs.discarded = int(d.get("discarded", 0))
        return cs

    def publish(self, obs=None) -> None:
        """Fold the collector into the swarm_trace_clock_* metrics."""
        from swarmkit_tpu_torch.metrics import catalog
        from swarmkit_tpu_torch.metrics import registry as obs_registry
        obs = obs or obs_registry.DEFAULT
        catalog.get(obs, "swarm_trace_clock_sync_points_total").inc(
            len(self.samples))
        f = self.fit()
        if f is not None:
            catalog.get(obs, "swarm_trace_clock_tick_us").set(
                f.slope_ns_per_tick / 1e3)
            catalog.get(obs, "swarm_trace_clock_residual_us").set(
                f.residual_ns / 1e3)


def fit_from(obj) -> Optional[ClockFit]:
    """Coerce a ClockSync, ClockFit, or to_dict() payload into a fit.
    None in, None out — callers treat None as "stay on the tick axis"."""
    if obj is None:
        return None
    if isinstance(obj, ClockFit):
        return obj
    if isinstance(obj, ClockSync):
        return obj.fit()
    if isinstance(obj, dict):
        if "samples" in obj:                      # ClockSync.to_dict form
            return ClockSync.from_dict(obj).fit()
        if "slope_ns_per_tick" in obj:            # ClockFit.to_dict form
            return ClockFit(
                slope_ns_per_tick=float(obj["slope_ns_per_tick"]),
                intercept_ns=float(obj["intercept_ns"]),
                n_samples=int(obj.get("n_samples", 0)),
                residual_ns=float(obj.get("residual_ns", 0.0)),
                degenerate=bool(obj.get("degenerate", False)))
    raise TypeError(f"cannot derive a clock fit from {type(obj).__name__}")
