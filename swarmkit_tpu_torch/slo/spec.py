"""Declarative SLO catalog for the fleet health plane.

An `SloSpec` names one service-level objective over the serving plane and
the burn-rate alerting policy that guards it.  The semantics follow the
multi-window burn-rate recipe (Google SRE workbook ch. 5): every scrape
contributes a (bad, total) event pair per group; the burn rate over a
window is

    burn = (sum(bad) / sum(total)) / budget

i.e. 1.0 means the group is consuming its error budget exactly at the
allowed rate, ``page_burn`` means it is burning that many times faster.
Alerting requires BOTH a fast window (catches sudden cliffs quickly) and
a slow window (suppresses one-scrape blips) to exceed the threshold — see
slo/engine.py for the ok -> warn -> page state machine and its
hysteresis.

Two reading styles map onto the same (bad, total) shape:

- **ratio SLOs** count real events: read_block_ratio's scrape reading is
  (reads blocked, reads attempted); commit_p99's is (commit observations
  above the latency threshold, commit observations).
- **threshold SLOs** grade the scrape itself: fsync_lag reads (1, 1) when
  the group's durability lag exceeds the bound and (0, 1) otherwise, so
  the budget is the tolerated fraction of bad SCRAPES.  leader_churn
  counts changes against a per-scrape allowance the same way.

Budgets and windows here are tuned for the simulation's scrape cadence
(one scrape per a-few-hundred-ticks chunk), not wall-clock minutes; the
catalog is data, so a deployment with a different cadence builds its own
tuple and hands it to `SloEngine`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SloSpec:
    """One objective + its multi-window burn-rate alerting policy.

    budget: allowed bad/total fraction (the error budget per unit of
    traffic — or per scrape, for threshold-style SLOs).
    fast_window / slow_window: evaluation windows in SCRAPES; both must
    exceed the burn threshold to change state (fast_window <= slow_window).
    warn_burn / page_burn: burn-rate thresholds for the two alert levels.
    clear_scrapes: consecutive calm scrapes (both windows below
    warn_burn) required to step DOWN one level — the hysteresis that
    stops a flapping group from paging repeatedly.
    """

    name: str
    description: str
    budget: float
    fast_window: int = 3
    slow_window: int = 12
    warn_burn: float = 2.0
    page_burn: float = 6.0
    clear_scrapes: int = 3

    def __post_init__(self) -> None:
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"{self.name}: budget must be in (0, 1], "
                             f"got {self.budget}")
        if not 0 < self.fast_window <= self.slow_window:
            raise ValueError(f"{self.name}: need 0 < fast_window <= "
                             f"slow_window, got {self.fast_window} / "
                             f"{self.slow_window}")
        if not 0.0 < self.warn_burn <= self.page_burn:
            raise ValueError(f"{self.name}: need 0 < warn_burn <= "
                             f"page_burn, got {self.warn_burn} / "
                             f"{self.page_burn}")
        if self.clear_scrapes < 1:
            raise ValueError(f"{self.name}: clear_scrapes must be >= 1, "
                             f"got {self.clear_scrapes}")


# The default fleet objectives.  Sources for each reading live in
# slo/source.py (FleetSource); an SLO whose inputs are off (telemetry,
# read path, storage model, router) simply produces no readings and the
# engine leaves it untouched.
SLO_CATALOG = (
    SloSpec(
        "commit_p99",
        "Propose-to-commit latency: the fraction of commit observations "
        "above the p99 latency bound stays within budget.",
        budget=0.05),
    SloSpec(
        "read_block_ratio",
        "Linearizable read availability: reads refused (deposal / lease "
        "expiry) as a fraction of reads attempted stays within budget.",
        budget=0.05),
    # threshold-style budgets must leave page_burn reachable: one
    # (bad, total) pair per scrape caps the burn at 1/budget, so 0.10
    # pages (burn 10 > 6) when most scrapes are bad — 0.25 would cap
    # the burn at 4 and make `page` unreachable
    SloSpec(
        "fsync_lag",
        "Durability lag: scrapes where a group's appended-but-unsynced "
        "window exceeds the configured bound stay within budget.",
        budget=0.10),
    SloSpec(
        "leader_churn",
        "Leadership stability: leader changes per scrape stay within "
        "the churn allowance.",
        budget=0.10),
    SloSpec(
        "spill_ratio",
        "Router capacity: keys spilled past a flush as a fraction of "
        "keys offered stays within budget.",
        budget=0.10),
)
