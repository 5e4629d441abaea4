"""Metrics registry, catalog, tracing and Prometheus exposition (the port's
copies of the JAX package's dependency-free modules).

    from swarmkit_tpu_torch import metrics as obs

    reg = obs.MetricsRegistry()              # or obs.default_registry()
    c = obs.catalog_get(reg, "swarm_kernel_commit_advance_total")
    c.inc()
    text = reg.render()                      # Prometheus text format

Publishers take an optional registry and tracer and fall back to the
process-global defaults.
"""

from .catalog import CATALOG, MetricSpec
from .catalog import get as catalog_get
from .exposition import render_all, snapshot_all
from .registry import (DEFAULT_BUCKETS, MAX_LABEL_SETS, Counter, Gauge,
                       Histogram, LabelCardinalityError, MetricError,
                       MetricsRegistry, default_registry)
from .trace import (Span, Tracer, current_span, current_span_id,
                    default_tracer, iter_ancestry, span_trace_tag)

__all__ = [
    "CATALOG", "MetricSpec", "catalog_get",
    "render_all", "snapshot_all",
    "DEFAULT_BUCKETS", "MAX_LABEL_SETS",
    "Counter", "Gauge", "Histogram",
    "LabelCardinalityError", "MetricError", "MetricsRegistry",
    "default_registry",
    "Span", "Tracer", "current_span", "current_span_id", "default_tracer",
    "iter_ancestry", "span_trace_tag",
]
