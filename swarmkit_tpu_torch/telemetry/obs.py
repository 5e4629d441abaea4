"""Host-side telemetry scrape: device counters -> registry + JSON.

Mirrors KernelObs (raft/sim/run.py) for the telemetry plane: read the
tiny aggregate tensors back from the device (``.cpu().numpy()``), publish
them into catalog-declared families, and hand back a JSON-able summary
for bench lines and DST artifacts.  Histogram publishing goes through the shared per-registry
delta seam (metrics/scrape.py), so repeated scrapes of the same state —
or scrapes from several publisher instances into one registry — add each
device observation exactly once.
"""

from __future__ import annotations

import numpy as np
import torch

from swarmkit_tpu_torch.metrics import catalog, scrape
from swarmkit_tpu_torch.metrics.registry import (MetricsRegistry,
                                                 default_registry)

from . import series as tseries


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

# registry family name -> SimState field carrying its device counters
_HIST_FIELDS = {
    "swarm_telemetry_commit_latency_ticks": "tel_commit_hist",
    "swarm_telemetry_election_ticks": "tel_elect_hist",
    "swarm_telemetry_read_latency_ticks": "tel_read_hist",
}
_SERIES_GAUGE = "swarm_telemetry_series_value"


def percentile_edge(counts, q: int):
    """Host-side bucket-edge percentile over a [NUM_BUCKETS] count list.

    Returns the upper edge (ticks) of the bucket containing the q-th
    percentile observation, None when the histogram is empty.  Overflow
    clamps to the largest finite edge (JSON has no Inf); report the
    overflow count separately when it matters.
    """
    counts = [int(c) for c in counts]
    total = sum(counts)
    if total == 0:
        return None
    k = max(1, -(-q * total // 100))        # ceil(q% of total)
    running = 0
    for i, c in enumerate(counts):
        running += c
        if running >= k:
            edges = tseries.LATENCY_BUCKET_EDGES
            return edges[min(i, len(edges) - 1)]
    return tseries.LATENCY_BUCKET_EDGES[-1]


def decode_series(state, cfg) -> dict:
    """Unroll the strided ring into {series_name: [(tick, value), ...]}.

    The ring holds one column per stride bucket; the bucket a column
    currently belongs to is recovered from the final tick: the newest
    bucket is b_now = (tick-1) // stride, and column s holds the most
    recent bucket congruent to s mod window.  Columns from before tick 0
    (first window lap still filling) are skipped.
    """
    ring = _host(state.tel_series)
    stride, window = cfg.telemetry_stride, cfg.telemetry_window
    now = int(state.tick) - 1                 # last tick the kernel ran
    if now < 0:
        return {name: [] for name in tseries.SERIES_NAMES.values()}
    b_now = now // stride
    points = []                               # (tick, column)
    for s in range(window):
        b = b_now - ((b_now - s) % window)
        if b >= 0:
            points.append((b * stride, s))
    points.sort()
    return {name: [(t, int(ring[idx, s])) for t, s in points]
            for idx, name in tseries.SERIES_NAMES.items()}


def summarize_state(state, cfg) -> dict:
    """JSON-able snapshot of the telemetry plane in `state`."""
    if getattr(state, "tel_commit_hist", None) is None:
        return {"enabled": False}
    out = {"enabled": True,
           "buckets": list(tseries.LATENCY_BUCKET_EDGES)}
    for short, field in (("commit", "tel_commit_hist"),
                         ("election", "tel_elect_hist"),
                         ("read", "tel_read_hist")):
        counts = [int(c) for c in _host(getattr(state, field))]
        out[short] = {
            "counts": counts,
            "total": sum(counts),
            "overflow": counts[-1],
            "p50": percentile_edge(counts, 50),
            "p99": percentile_edge(counts, 99),
        }
    ser = decode_series(state, cfg)
    out["series_last"] = {name: (pts[-1][1] if pts else None)
                          for name, pts in ser.items()}
    return out


# the fields summarize_state reads
_SUMMARY_FIELDS = ("tick", "tel_commit_hist", "tel_elect_hist",
                   "tel_read_hist", "tel_series")


def summarize_groups(gstate, cfg) -> list:
    """Per-group ``summarize_state`` over a [G, N, ...] grouped state.

    One device->host read of the fields the summary uses, then host-side
    slicing: group g's summary is exactly what a solo run of that group
    would report (the grouped tick folds each group on its own).  Returns
    ``[{"enabled": False}] * G`` when telemetry is off.
    """
    from types import SimpleNamespace

    from swarmkit_tpu_torch.raft.sim.kernel import read_many

    groups = int(gstate.tick.shape[0])
    if getattr(gstate, "tel_commit_hist", None) is None:
        return [{"enabled": False} for _ in range(groups)]
    host = dict(zip(_SUMMARY_FIELDS, read_many(
        [getattr(gstate, f) for f in _SUMMARY_FIELDS])))
    return [summarize_state(
        SimpleNamespace(**{f: a[g] for f, a in host.items()}), cfg)
        for g in range(groups)]


class TelemetryObs:
    """Publishes a telemetry-enabled SimState into a metrics registry."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.obs = registry or default_registry()
        self._deltas = scrape.deltas_for(self.obs)

    def publish(self, state, cfg) -> dict:
        """Scrape `state` into the registry; returns summarize_state()."""
        summary = summarize_state(state, cfg)
        if not summary["enabled"]:
            return summary
        for name, field in _HIST_FIELDS.items():
            fam = catalog.get(self.obs, name)
            counts = [int(c) for c in _host(getattr(state, field))]
            for i, c in enumerate(counts):
                d = self._deltas.advance((name, i), c)
                if d:
                    fam.observe_bucket(i, d)
        fam = catalog.get(self.obs, _SERIES_GAUGE)
        for sname, last in summary["series_last"].items():
            if last is not None:
                fam.labels(series=sname).set(last)
        return summary
