"""swarm_multiraft_* metric names + the serving-plane publisher (PyTorch
port of the JAX package's multiraft/obs.py).

``METRIC_NAMES`` is the scrape-side schema for the multi-raft serving
plane: every name has a catalog spec (metrics/catalog.py) with exactly
these labels.

`MultiRaftObs` mirrors `KernelObs` (raft/sim/run.py) for the group axis:
pull the tiny aggregate quantities off the device in one read per
publish, fold the cumulative ones through the shared per-registry delta
seam (metrics/scrape.py) so repeated publishes of the same state add
nothing, and gauge the point-in-time ones.

The fleet-health families are per group: commit-latency p50/p99 read off
each group's on-device telemetry histogram, a per-group leader-changes
counter (the churn-rate input for the SLO engine), and the
``swarm_multiraft_group_heat`` EWMA score fused from router spills and
commit rate (multiraft/heat.py).  Per-group label sets are bounded: the
registry caps a family at MAX_LABEL_SETS children, so fleets beyond
``GROUP_LABEL_CAP`` groups publish heat for the top ``HEAT_TOP_K``
hottest groups only and skip the other per-group families; the
aggregates always publish, whatever G is.
"""

from __future__ import annotations

import numpy as np

from swarmkit_tpu_torch.multiraft.group import (
    aggregate_reads_served, group_leaders, groups_of,
)
from swarmkit_tpu_torch.multiraft.heat import HeatTracker
from swarmkit_tpu_torch.raft.sim.kernel import read_many
from swarmkit_tpu_torch.raft.sim.state import SimState

METRIC_GROUPS = "swarm_multiraft_groups"
METRIC_GROUPS_WITH_LEADER = "swarm_multiraft_groups_with_leader"
METRIC_ROUTER_KEYS = "swarm_multiraft_router_keys_total"
METRIC_LEADER_CHANGES = "swarm_multiraft_leader_changes_total"
METRIC_COMMITTED = "swarm_multiraft_committed_entries_total"
METRIC_READS = "swarm_multiraft_reads_served_total"
METRIC_GROUP_COMMIT_LATENCY = "swarm_multiraft_group_commit_latency_ticks"
METRIC_GROUP_LEADER_CHANGES = "swarm_multiraft_group_leader_changes_total"
METRIC_GROUP_HEAT = "swarm_multiraft_group_heat"

# Per-group families label by group index; a registry family holds at
# most MAX_LABEL_SETS children, so per-group publishing is gated on G.
GROUP_LABEL_CAP = 64
HEAT_TOP_K = 8

# name -> required label names, exactly as the catalog declares them
METRIC_NAMES = {
    METRIC_GROUPS: (),
    METRIC_GROUPS_WITH_LEADER: (),
    METRIC_ROUTER_KEYS: ("outcome",),      # routed | spilled
    METRIC_LEADER_CHANGES: (),
    METRIC_COMMITTED: (),
    METRIC_READS: (),
    METRIC_GROUP_COMMIT_LATENCY: ("group", "quantile"),   # p50 | p99
    METRIC_GROUP_LEADER_CHANGES: ("group",),
    METRIC_GROUP_HEAT: ("group",),
}

# one valid value per label, for a publishability probe
SAMPLE_LABELS = {
    "outcome": "routed",
    "group": "0",
    "quantile": "p99",
}


class MultiRaftObs:
    """Host-side observability for a [G, N, ...] grouped state.

    ``publish(gstate)`` folds the aggregate serving quantities into the
    swarm_multiraft_* families and returns them as a dict.  Per-group
    leader changes are detected host-side by diffing each group's leader
    row against the previous publish: a group whose CURRENT leader is a
    different concrete row than last time counts one change (the first
    publish only establishes the baseline; a group that merely lost its
    leader counts when the replacement appears).  Router outcomes are
    pushed by the Router through ``router_keys``.

    Pass the fronting ``Router`` to ``publish(gstate, router=r)`` and the
    heat score fuses its per-group spill counters; without one, heat is
    pure per-group commit rate.  ``hottest_groups()`` exposes the
    resulting ranking, the designated input for a rebalance verb.
    """

    def __init__(self, registry=None, heat_alpha: float = 0.5) -> None:
        from swarmkit_tpu_torch.metrics import catalog as obs_catalog
        from swarmkit_tpu_torch.metrics import registry as obs_registry
        from swarmkit_tpu_torch.metrics import scrape as obs_scrape

        self.obs = registry or obs_registry.DEFAULT
        self._m = {name: obs_catalog.get(self.obs, name)
                   for name in METRIC_NAMES}
        self._deltas = obs_scrape.deltas_for(self.obs)
        self._last_leaders: np.ndarray | None = None
        self._heat_alpha = heat_alpha
        self.heat: HeatTracker | None = None    # sized at first publish

    def router_keys(self, outcome: str, n: int = 1) -> None:
        self._m[METRIC_ROUTER_KEYS].labels(outcome=outcome).inc(n)

    def hottest_groups(self, k: int | None = None) -> list[int]:
        """Hottest-first group ranking (empty before the first publish)."""
        return [] if self.heat is None else self.heat.hottest_groups(k)

    def _publish_group_latency(self, hist: np.ndarray, g: int) -> None:
        from swarmkit_tpu_torch.telemetry.obs import percentile_edge

        fam = self._m[METRIC_GROUP_COMMIT_LATENCY]
        for gi in range(g):
            counts = hist[gi]
            for q in (50, 99):
                edge = percentile_edge(counts, q)
                if edge is not None:
                    fam.labels(group=str(gi), quantile=f"p{q}").set(edge)

    def publish(self, gstate: SimState, router=None) -> dict:
        g = groups_of(gstate)
        per_group_ok = g <= GROUP_LABEL_CAP
        want_hist = per_group_ok and gstate.tel_commit_hist is not None
        # one device->host read: leaders, per-group commit, reads served
        # and (when published) the commit-latency histograms
        parts = [group_leaders(gstate), gstate.commit.amax(-1)]
        if gstate.read_srv is not None:
            parts.append(aggregate_reads_served(gstate))
        if want_hist:
            parts.append(gstate.tel_commit_hist)
        host = read_many(parts)
        leaders = host[0].astype(np.int32)
        commit_by_group = host[1].astype(np.int32)

        with_leader = int((leaders >= 0).sum())
        self._m[METRIC_GROUPS].set(g)
        self._m[METRIC_GROUPS_WITH_LEADER].set(with_leader)

        changes = 0
        if self._last_leaders is not None:
            changed = (leaders >= 0) & (leaders != self._last_leaders)
            changes = int(changed.sum())
            if changes:
                self._m[METRIC_LEADER_CHANGES].inc(changes)
            if per_group_ok:
                fam = self._m[METRIC_GROUP_LEADER_CHANGES]
                for gi in np.nonzero(changed)[0]:
                    fam.labels(group=str(int(gi))).inc()
        self._last_leaders = leaders

        out = {"groups": g, "groups_with_leader": with_leader,
               "leader_changes": changes}
        committed = int(commit_by_group.sum())
        d = self._deltas.advance((METRIC_COMMITTED,), committed)
        if d:
            self._m[METRIC_COMMITTED].inc(d)
        out["committed_entries"] = committed
        if gstate.read_srv is not None:
            reads = int(host[2])
            d = self._deltas.advance((METRIC_READS,), reads)
            if d:
                self._m[METRIC_READS].inc(d)
            out["reads_served"] = reads

        # per-group commit latency off the grouped telemetry histograms
        if want_hist:
            self._publish_group_latency(host[-1].reshape(g, -1), g)

        # hot-group heat: EWMA over router spills + per-group commit rate
        if self.heat is None or self.heat.groups != g:
            self.heat = HeatTracker(g, alpha=self._heat_alpha)
        spills = None if router is None else router.spilled_by_group
        heat = self.heat.update(commit_by_group, spills)
        fam = self._m[METRIC_GROUP_HEAT]
        hot = self.heat.hottest_groups(HEAT_TOP_K)
        for gi in (range(g) if per_group_ok else hot):
            fam.labels(group=str(int(gi))).set(float(heat[int(gi)]))
        out["hottest_groups"] = hot
        return out
