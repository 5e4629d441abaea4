"""FleetSource: grouped state + router -> per-SLO (bad, total) readings
(PyTorch port of the JAX package's slo/source.py).

The seam between the device plane and the burn-rate evaluator: one
``scrape(gstate, router=...)`` call pulls the handful of per-group
aggregates off the device in ONE read, deltas the cumulative ones against
the previous scrape (re-baselining on decrease, the metrics/scrape.py
reset rule), and returns ``{slo_name: [G, 2] (bad, total)}`` arrays in
exactly the shape `SloEngine.observe` consumes.

Each SLO's reading rides a subsystem that may be off; a dark input means
the SLO is simply ABSENT from the scrape (the engine freezes its state)
rather than read-as-zero: a fleet without the storage model should not
accrue a spotless fsync_lag record.

- commit_p99      <- per-group telemetry histograms (collect_telemetry)
- read_block_ratio <- read_srv / read_block fields (read_batch > 0)
- fsync_lag       <- sync_mark durability watermark (storage model on)
- leader_churn    <- group_leaders diff (always available)
- spill_ratio     <- Router per-group flow counters (router passed)
"""

from __future__ import annotations

import numpy as np
import torch

from swarmkit_tpu_torch.multiraft.group import group_leaders
from swarmkit_tpu_torch.raft.sim.kernel import read_many
from swarmkit_tpu_torch.raft.sim.state import SimConfig, SimState
from swarmkit_tpu_torch.telemetry import series as tseries

# Fallback thresholds when the config does not pin its own device-side
# SLO bounds (cfg.slo_p99_commit_ticks / cfg.slo_fsync_lag == 0 = off).
DEFAULT_COMMIT_P99_TICKS = 8
DEFAULT_FSYNC_LAG_TICKS = 16


def _delta(prev: np.ndarray | None, cur: np.ndarray) -> np.ndarray:
    """Cumulative -> per-scrape delta; first scrape is the baseline,
    decreases re-baseline to the full reading (fresh state)."""
    if prev is None:
        return np.zeros_like(cur)
    d = cur - prev
    return np.where(d >= 0, d, cur)


class FleetSource:
    """Stateful per-scrape reading producer for one grouped fleet.

    Thresholds default from the config's own device-side SLO bounds
    (``slo_p99_commit_ticks`` / ``slo_fsync_lag``) when those are set,
    else to the module defaults, so a config that already declares its
    latency objective is graded against the SAME number host-side.
    """

    def __init__(self, cfg: SimConfig,
                 commit_p99_ticks: int | None = None,
                 fsync_lag_ticks: int | None = None) -> None:
        self.cfg = cfg
        self.commit_p99_ticks = (
            commit_p99_ticks if commit_p99_ticks is not None
            else (cfg.slo_p99_commit_ticks or DEFAULT_COMMIT_P99_TICKS))
        self.fsync_lag_ticks = (
            fsync_lag_ticks if fsync_lag_ticks is not None
            else (cfg.slo_fsync_lag or DEFAULT_FSYNC_LAG_TICKS))
        # first histogram bucket whose upper edge exceeds the bound:
        # observations landing there or above are "bad"
        edges = tseries.LATENCY_BUCKET_EDGES
        self._bad_bucket = next(
            (i for i, e in enumerate(edges) if e > self.commit_p99_ticks),
            len(edges) - 1)
        self._prev_hist: np.ndarray | None = None
        self._prev_blocked: np.ndarray | None = None
        self._prev_served: np.ndarray | None = None
        self._prev_leaders: np.ndarray | None = None
        self._prev_routed: np.ndarray | None = None
        self._prev_spilled: np.ndarray | None = None

    @staticmethod
    def _read(gstate: SimState) -> dict:
        """The per-group aggregates a scrape reads, in one device->host
        read: {name: [G, k] int64}."""
        parts = {"leaders": group_leaders(gstate)}
        if gstate.tel_commit_hist is not None:
            parts["hist"] = gstate.tel_commit_hist
        if gstate.read_srv is not None and gstate.read_block is not None:
            parts["served"] = gstate.read_srv.sum(-1, dtype=torch.int32)
            parts["blocked"] = gstate.read_block.sum(-1, dtype=torch.int32)
        if gstate.sync_mark is not None:
            parts["lag"] = (gstate.last - gstate.sync_mark).amax(-1)
        g = int(gstate.tick.shape[0])
        return {name: a.reshape(g, -1) for name, a in
                zip(parts, read_many(list(parts.values())))}

    def scrape(self, gstate: SimState, router=None) -> dict:
        """One scrape: {slo_name: [G, 2] float64 (bad, total)}."""
        host = self._read(gstate)
        out = {}

        if "hist" in host:
            hist = host["hist"].astype(np.float64)
            d = _delta(self._prev_hist, hist)
            self._prev_hist = hist
            out["commit_p99"] = np.stack(
                [d[:, self._bad_bucket:].sum(axis=1), d.sum(axis=1)],
                axis=1)

        if "served" in host:
            served = host["served"][:, 0].astype(np.float64)
            blocked = host["blocked"][:, 0].astype(np.float64)
            bad = _delta(self._prev_blocked, blocked)
            ok = _delta(self._prev_served, served)
            self._prev_blocked, self._prev_served = blocked, served
            out["read_block_ratio"] = np.stack([bad, bad + ok], axis=1)

        if "lag" in host:
            lag = host["lag"][:, 0].astype(np.float64)
            bad = (lag > self.fsync_lag_ticks).astype(np.float64)
            out["fsync_lag"] = np.stack(
                [bad, np.ones_like(bad)], axis=1)

        leaders = host["leaders"][:, 0].astype(np.int32)
        if self._prev_leaders is not None:
            changed = ((leaders >= 0) & (leaders != self._prev_leaders)
                       ).astype(np.float64)
            out["leader_churn"] = np.stack(
                [changed, np.ones_like(changed)], axis=1)
        self._prev_leaders = leaders

        if router is not None:
            routed = np.asarray(router.routed_by_group, np.float64)
            spilled = np.asarray(router.spilled_by_group, np.float64)
            bad = _delta(self._prev_spilled, spilled)
            offered = _delta(self._prev_routed, routed)
            self._prev_routed, self._prev_spilled = routed, spilled
            out["spill_ratio"] = np.stack(
                [bad, np.maximum(offered, bad)], axis=1)

        return out
