"""On-device telemetry plane (PyTorch port): tick-resolution latency
histograms and a strided time-series ring, aggregated where the data lives.

Device side (series.py): the bucket ladder, the series enum and the fold
and ring ops the kernel's end-of-tick telemetry block uses when
``SimConfig.collect_telemetry`` is on.  Host side (obs.py): the
TelemetryObs publisher, the ring decoder and the JSON summary.
"""

from .obs import (TelemetryObs, decode_series, percentile_edge,
                  summarize_groups, summarize_state)
from .series import (GAUGE_ROWS, LATENCY_BUCKET_EDGES, NUM_BUCKETS,
                     NUM_SERIES, PROP_RING, SERIES_COMMIT_RATE,
                     SERIES_LEADER_CHANGES, SERIES_LOG_OCCUPANCY,
                     SERIES_NAMES, SERIES_READS_BLOCKED, bucket_of,
                     hist_fold, percentile_edge_device, ring_write)

__all__ = [
    "TelemetryObs", "decode_series", "percentile_edge", "summarize_groups",
    "summarize_state",
    "GAUGE_ROWS", "LATENCY_BUCKET_EDGES", "NUM_BUCKETS", "NUM_SERIES",
    "PROP_RING", "SERIES_COMMIT_RATE", "SERIES_LEADER_CHANGES",
    "SERIES_LOG_OCCUPANCY", "SERIES_NAMES", "SERIES_READS_BLOCKED",
    "bucket_of", "hist_fold", "percentile_edge_device", "ring_write",
]
