"""Fleet health plane (PyTorch port): declarative SLOs + multi-window
burn-rate alerting.

The host-side alerting layer over the multi-raft serving plane:
slo/spec.py declares WHAT is promised (the `SLO_CATALOG` of five
objectives: commit latency, read availability, durability lag, leader
stability, router capacity), slo/source.py reads the per-group evidence
off a grouped state + router each scrape (one device read), and
slo/engine.py grades it with fast/slow burn-rate windows and an ok ->
warn -> page state machine with hysteresis, publishing ``swarm_slo_*`` and
appending host alert records.
"""

from swarmkit_tpu_torch.slo.engine import (
    METRIC_NAMES, SAMPLE_LABELS, STATE_NAMES, SloEngine,
)
from swarmkit_tpu_torch.slo.source import FleetSource
from swarmkit_tpu_torch.slo.spec import SLO_CATALOG, SloSpec

__all__ = [
    "METRIC_NAMES", "SAMPLE_LABELS", "SLO_CATALOG", "STATE_NAMES",
    "FleetSource", "SloEngine", "SloSpec",
]
