"""swarm_mc_* metric names — the device vocabulary's scrape-side schema
(the JAX package's mc/metrics.py).

metrics/catalog.py declares each of these with exactly these labels, and
every swarm_mc_* spec there has a constant here (tests hold the two
together, as the JAX package's metrics lint does).
"""

METRIC_BRANCHES = "swarm_mc_branches_total"
METRIC_STATES = "swarm_mc_states_total"
METRIC_VIOLATIONS = "swarm_mc_violations_total"
METRIC_BRANCH_RATE = "swarm_mc_branches_per_second"
METRIC_FRONTIER_PEAK = "swarm_mc_frontier_peak_states"
METRIC_TRUNCATIONS = "swarm_mc_truncations_total"

# name -> required label names, exactly as the catalog must declare them
METRIC_NAMES = {
    METRIC_BRANCHES: ("result",),          # clean | violation
    METRIC_STATES: ("kind",),              # unique | duplicate
    METRIC_VIOLATIONS: ("invariant",),     # dst BIT_NAMES values
    METRIC_BRANCH_RATE: ("scope",),
    METRIC_FRONTIER_PEAK: ("scope",),
    METRIC_TRUNCATIONS: ("scope",),
}

# one valid value per label, for the lint's publishability probe
SAMPLE_LABELS = {
    "result": "clean",
    "kind": "unique",
    "invariant": "election_safety",
    "scope": "n3h8",
}
