"""Multi-window burn-rate evaluator: readings -> alert state + metrics.

`SloEngine` is the host-side state machine of the fleet health plane.
Each scrape, the caller hands it per-SLO ``[G, 2]`` (bad, total) reading
arrays (slo/source.py produces them from a grouped state + router); the
engine folds them into per-(SLO, group) ring buffers, computes fast- and
slow-window burn rates, and walks the alert state machine:

    ok --(both windows >= warn_burn)--> warn
    ok/warn --(both windows >= page_burn)--> page
    any --(clear_scrapes consecutive calm scrapes)--> one level down

Escalation is immediate (a cliff can jump ok -> page in one scrape once
both windows agree); de-escalation is deliberately slow and one level at
a time — the hysteresis that keeps a flapping group from re-paging on
every oscillation.  Windows may be PARTIALLY filled: a brand-new fleet
can page on its very first scrapes if the readings are bad enough, which
is the behavior you want for a group born into an outage.

``METRIC_NAMES`` is the scrape-side schema, the catalog's swarm_slo_*
families (metrics/catalog.py).  Every transition also appends a
flightrec-style host alert record to ``self.alerts`` (bounded deque) so
DST artifacts and an alerts panel can show WHAT fired and WHEN without
scraping the registry.  The JAX package's engine, copied with its import
paths changed.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from swarmkit_tpu_torch.slo.spec import SLO_CATALOG, SloSpec

METRIC_STATE = "swarm_slo_state"
METRIC_BURN = "swarm_slo_burn_rate"
METRIC_TRANSITIONS = "swarm_slo_transitions_total"

# name -> required label names, exactly as the catalog must declare them
METRIC_NAMES = {
    METRIC_STATE: ("slo", "group"),
    METRIC_BURN: ("slo", "group", "window"),      # fast | slow
    METRIC_TRANSITIONS: ("slo", "group", "state"),  # state ENTERED
}

# one valid value per label, for the lint's publishability probe
SAMPLE_LABELS = {
    "slo": "commit_p99",
    "group": "0",
    "window": "fast",
    "state": "page",
}

STATE_NAMES = ("ok", "warn", "page")
OK, WARN, PAGE = 0, 1, 2

# Per-group SLO families label by (slo, group[, window]); with the full
# default catalog the burn family holds len(catalog) * G * 2 label sets
# against the registry's MAX_LABEL_SETS cap, so per-group metric
# publishing is gated on G.  Evaluation and alert records never gate.
GROUP_LABEL_CAP = 16


class _SloState:
    """Ring of (bad, total) readings + alert state for one SLO."""

    def __init__(self, spec: SloSpec, groups: int) -> None:
        self.spec = spec
        self.ring = np.zeros((groups, spec.slow_window, 2), np.float64)
        self.filled = 0                    # scrapes folded, saturating
        self.pos = 0
        self.state = np.zeros((groups,), np.int64)
        self.calm = np.zeros((groups,), np.int64)

    def burn(self, window: int) -> np.ndarray:
        """[G] burn rate over the last `window` folded scrapes."""
        take = min(self.filled, window)
        if take == 0:
            return np.zeros((self.ring.shape[0],), np.float64)
        idx = [(self.pos - 1 - i) % self.spec.slow_window
               for i in range(take)]
        win = self.ring[:, idx, :]
        bad, total = win[:, :, 0].sum(axis=1), win[:, :, 1].sum(axis=1)
        frac = np.divide(bad, total, out=np.zeros_like(bad),
                         where=total > 0)
        return frac / self.spec.budget

    def push(self, readings: np.ndarray) -> None:
        self.ring[:, self.pos, :] = readings
        self.pos = (self.pos + 1) % self.spec.slow_window
        self.filled = min(self.filled + 1, self.spec.slow_window)


class SloEngine:
    """Evaluates an SLO catalog over per-scrape (bad, total) readings.

    >>> eng = SloEngine(registry=reg)
    >>> fired = eng.observe({"leader_churn": readings})   # [G, 2] array
    >>> eng.active()       # [{"slo": ..., "group": 3, "state": "page"}]

    `observe` returns the alert records newly fired by this scrape (state
    transitions only — a group that stays paged returns nothing new).
    Per-SLO group counts are sized from the first reading for that SLO;
    a reshaped fleet resets that SLO's windows and state.
    """

    def __init__(self, catalog=SLO_CATALOG, registry=None,
                 max_alerts: int = 256) -> None:
        from swarmkit_tpu_torch.metrics import catalog as obs_catalog
        from swarmkit_tpu_torch.metrics import registry as obs_registry

        self.catalog = {spec.name: spec for spec in catalog}
        self.obs = registry or obs_registry.DEFAULT
        self._m = {name: obs_catalog.get(self.obs, name)
                   for name in METRIC_NAMES}
        self._slos: dict[str, _SloState] = {}
        self.alerts: deque = deque(maxlen=max_alerts)
        self.scrapes = 0

    def _slo(self, name: str, groups: int) -> _SloState:
        st = self._slos.get(name)
        if st is None or st.ring.shape[0] != groups:
            st = _SloState(self.catalog[name], groups)
            self._slos[name] = st
        return st

    def observe(self, readings: dict) -> list:
        """Fold one scrape of {slo_name: [G, 2] (bad, total)} readings.

        Unknown SLO names raise (a typo'd source would otherwise silently
        never alert); catalog SLOs absent from `readings` keep their
        state frozen.  Returns the alert records fired by this scrape.
        """
        self.scrapes += 1
        fired = []
        for name, arr in readings.items():
            spec = self.catalog.get(name)
            if spec is None:
                raise KeyError(f"reading for unknown SLO {name!r}; "
                               f"catalog has {sorted(self.catalog)}")
            arr = np.asarray(arr, np.float64)
            if arr.ndim != 2 or arr.shape[1] != 2:
                raise ValueError(f"{name}: readings must be [G, 2] "
                                 f"(bad, total), got shape {arr.shape}")
            st = self._slo(name, arr.shape[0])
            st.push(arr)
            fast = st.burn(spec.fast_window)
            slow = st.burn(spec.slow_window)
            fired.extend(self._advance(st, fast, slow))
            self._publish(st, fast, slow)
        return fired

    def _advance(self, st: _SloState, fast, slow) -> list:
        spec, fired = st.spec, []
        for g in range(st.state.shape[0]):
            cur = int(st.state[g])
            if fast[g] >= spec.page_burn and slow[g] >= spec.page_burn:
                new, st.calm[g] = PAGE, 0
            elif fast[g] >= spec.warn_burn and slow[g] >= spec.warn_burn:
                new, st.calm[g] = max(cur, WARN), 0
            elif fast[g] < spec.warn_burn and slow[g] < spec.warn_burn:
                st.calm[g] += 1
                new = cur
                if cur > OK and st.calm[g] >= spec.clear_scrapes:
                    new, st.calm[g] = cur - 1, 0
            else:                      # windows disagree: hold, not calm
                new, st.calm[g] = cur, 0
            if new != cur:
                st.state[g] = new
                rec = {"scrape": self.scrapes, "slo": spec.name,
                       "group": g, "from": STATE_NAMES[cur],
                       "to": STATE_NAMES[new],
                       "fast_burn": round(float(fast[g]), 3),
                       "slow_burn": round(float(slow[g]), 3)}
                self.alerts.append(rec)
                fired.append(rec)
        return fired

    def _publish(self, st: _SloState, fast, slow) -> None:
        groups = st.state.shape[0]
        if groups > GROUP_LABEL_CAP:
            return
        name = st.spec.name
        for g in range(groups):
            gl = str(g)
            self._m[METRIC_STATE].labels(slo=name, group=gl).set(
                int(st.state[g]))
            burn = self._m[METRIC_BURN]
            burn.labels(slo=name, group=gl, window="fast").set(
                round(float(fast[g]), 6))
            burn.labels(slo=name, group=gl, window="slow").set(
                round(float(slow[g]), 6))
        # transitions publish from the alert records of this scrape
        for rec in list(self.alerts):
            if rec["scrape"] == self.scrapes and rec["slo"] == name:
                self._m[METRIC_TRANSITIONS].labels(
                    slo=name, group=str(rec["group"]),
                    state=rec["to"]).inc()

    def state_of(self, slo: str, group: int) -> str:
        """Current alert state name for one (SLO, group)."""
        st = self._slos.get(slo)
        if st is None:
            return STATE_NAMES[OK]
        return STATE_NAMES[int(st.state[group])]

    def active(self) -> list:
        """Every (SLO, group) currently above ok, pages first."""
        out = []
        for name, st in sorted(self._slos.items()):
            for g in np.nonzero(st.state > OK)[0]:
                out.append({"slo": name, "group": int(g),
                            "state": STATE_NAMES[int(st.state[g])]})
        out.sort(key=lambda r: (r["state"] != "page", r["slo"],
                                r["group"]))
        return out
