"""Hot-group heat: the EWMA load score behind rebalance decisions.

The router-level hot-group detector's scoring core (the JAX package's
multiraft/heat.py, copied): one exponentially-weighted
moving average per group, fused from the two per-group load signals the
serving plane already produces —

- **router spills** (keys deferred past a flush by the group's
  ``max_props`` capacity): the saturation signal.  A spill means offered
  load exceeded what the group could even accept this tick, so spills are
  weighted ``SPILL_WEIGHT`` x heavier than served traffic.
- **commit rate** (entries committed through consensus per scrape): the
  utilization signal.  A group can be hot without spilling yet — a rising
  commit rate is the early warning the spill counter cannot give.

Heat is in "weighted events per scrape" units: raw_g = SPILL_WEIGHT *
spill_delta_g + commit_delta_g, folded as heat_g <- (1 - alpha) * heat_g
+ alpha * raw_g.  Inputs are CUMULATIVE counters (the shape the device
state and the Router both keep); the tracker deltas them internally and
re-baselines on decrease (new run), the same reset rule as
metrics/scrape.py.

``hottest_groups()`` is the designated input for the future rebalance
verb: it returns group indices ranked hottest-first, so "split / move the
top-k" is a one-liner for the layer above.  `MultiRaftObs` publishes the
scores as ``swarm_multiraft_group_heat``.
"""

from __future__ import annotations

import numpy as np

# Spilled keys count this many times a committed entry in the heat score:
# a spill is load the group already could not absorb, a commit is load it
# handled — saturation must outrank throughput when ranking candidates
# for rebalancing.
SPILL_WEIGHT = 4.0


class HeatTracker:
    """Per-group EWMA heat over (spill, commit) cumulative counters."""

    def __init__(self, groups: int, alpha: float = 0.5) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.groups = groups
        self.alpha = alpha
        self.heat = np.zeros((groups,), np.float64)
        self._prev_commit: np.ndarray | None = None
        self._prev_spill: np.ndarray | None = None

    @staticmethod
    def _delta(prev: np.ndarray | None, cur: np.ndarray) -> np.ndarray:
        """Cumulative -> per-scrape delta, re-baselining on decrease
        (fresh state / new run: count the full reading, as scrape.py
        CounterDeltas does)."""
        if prev is None:
            return np.zeros_like(cur)      # first scrape is the baseline
        d = cur - prev
        return np.where(d >= 0, d, cur)

    def update(self, commit_by_group, spill_by_group=None) -> np.ndarray:
        """Fold one scrape's cumulative readings; returns the new heat.

        commit_by_group: [G] cumulative committed entries per group
        (``max(commit, axis=-1)`` of the grouped state).  spill_by_group:
        [G] cumulative spilled keys per group (``Router.spilled_by_group``;
        None when no router fronts the plane — heat is then pure commit
        rate).
        """
        commit = np.asarray(commit_by_group, np.float64)
        if commit.shape != (self.groups,):
            raise ValueError(f"expected [{self.groups}] commit readings, "
                             f"got shape {commit.shape}")
        raw = self._delta(self._prev_commit, commit)
        self._prev_commit = commit
        if spill_by_group is not None:
            spill = np.asarray(spill_by_group, np.float64)
            raw = raw + SPILL_WEIGHT * self._delta(self._prev_spill, spill)
            self._prev_spill = spill
        self.heat = (1.0 - self.alpha) * self.heat + self.alpha * raw
        return self.heat

    def hottest_groups(self, k: int | None = None) -> list[int]:
        """Group indices ranked hottest-first (ties: lower index first —
        deterministic for the rebalance verb).  `k` caps the list."""
        order = np.argsort(-self.heat, kind="stable")
        out = [int(g) for g in order]
        return out if k is None else out[:k]
