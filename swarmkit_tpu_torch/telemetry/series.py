"""Device-side telemetry vocabulary and tensor ops (PyTorch port).

The single owner of the on-device telemetry plane's layout in the port:
the fixed latency-bucket ladder, the row indices of ``SimState.tel_series``
and the fold/ring ops the kernel's end-of-tick telemetry block calls.  The
names, values and semantics are the JAX package's telemetry/series.py, and
the metrics catalog (metrics/catalog.py ``swarm_telemetry_*``) mirrors the
ladder and the series names.

Everything is tick-unit int32 math that wraps as the JAX package's does,
so the histograms and the series ring equal JAX's bit for bit.  No op here
reads a device value back: ring columns are device scalars, written with
``index_copy_``, and the histogram fold is a ``scatter_add``.  The ring
writes are IN PLACE, like the kernel's log rings: a call consumes the
tensor it is given.
"""

from __future__ import annotations

import torch

I32 = torch.int32

# Fixed histogram bucket UPPER edges, in ticks: a latency of t lands in the
# first bucket with t <= edge; the extra last counter is overflow (> 256).
LATENCY_BUCKET_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
NUM_BUCKETS = len(LATENCY_BUCKET_EDGES) + 1          # + overflow

# Row indices of SimState.tel_series [NUM_SERIES, telemetry_window].
SERIES_COMMIT_RATE = 0      # committed entries per stride bucket (sum)
SERIES_LEADER_CHANGES = 1   # election wins per stride bucket (sum)
SERIES_LOG_OCCUPANCY = 2    # sum over rows of last - snap_idx (gauge)
SERIES_READS_BLOCKED = 3    # read ops refused per stride bucket (sum)
NUM_SERIES = 4

# Scrape-side names, index -> name.
SERIES_NAMES = {
    SERIES_COMMIT_RATE: "commit_rate",
    SERIES_LEADER_CHANGES: "leader_changes",
    SERIES_LOG_OCCUPANCY: "log_occupancy",
    SERIES_READS_BLOCKED: "reads_blocked",
}

# Gauge-mode rows OVERWRITE within a stride bucket (last tick wins);
# counter-mode rows accumulate ticks into the bucket.
GAUGE_ROWS = (SERIES_LOG_OCCUPANCY,)

# Default propose-batch ring depth of SimState.tel_prop_* [N, PROP_RING]:
# slot t % PROP_RING holds the (first idx, count, tick) of the batch a
# leader appended at tick t; batches uncommitted after PROP_RING ticks age
# out of measurement.
PROP_RING = 512

# The ladder is 2**k, which bucket_edges() builds on the device without a
# host->device copy (a copy from pageable memory waits for the stream).
assert LATENCY_BUCKET_EDGES == tuple(1 << k for k in range(9))


def bucket_edges(device) -> torch.Tensor:
    """LATENCY_BUCKET_EDGES as an int32 tensor on `device`."""
    return 1 << torch.arange(len(LATENCY_BUCKET_EDGES), dtype=I32,
                             device=device)


def col_set(ring: torch.Tensor, col: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """ring[:, col] = vals [N], in place, for a device scalar `col`."""
    return ring.index_copy_(1, col.reshape(1).to(torch.int64),
                            vals.reshape(-1, 1).to(ring.dtype))


def bucket_of(lat: torch.Tensor, edges=None) -> torch.Tensor:
    """Bucket index (0..NUM_BUCKETS-1, int32) of tick latency `lat`: the
    number of edges strictly below it."""
    if edges is None:
        edges = bucket_edges(lat.device)
    return torch.bucketize(lat.to(I32), edges, out_int32=True)


def hist_fold(hist: torch.Tensor, mask: torch.Tensor, lat: torch.Tensor,
              weight=None, edges=None) -> torch.Tensor:
    """Fold masked latencies into a [NUM_BUCKETS] int32 counter vector; each
    masked element adds `weight` samples (1 when None).  Masked-out
    elements add 0 to their bucket, whatever garbage latency they hold.

    An integer scatter_add of each element into its bucket, per leading
    row (an [R, NUM_BUCKETS] partial, so a row's elements are all that
    meet on one counter), then a sum over rows: int32 sums wrap the same
    in any order, so the bits equal the JAX package's exceed-count
    differencing."""
    w = mask.to(I32) if weight is None \
        else torch.where(mask, weight.to(I32), 0)
    b = bucket_of(lat, edges)
    rows = b.shape[0] if b.dim() > 1 else 1
    part = torch.zeros((rows, NUM_BUCKETS), dtype=I32, device=hist.device)
    part.scatter_add_(1, b.reshape(rows, -1).to(torch.int64),
                      w.reshape(rows, -1))
    return hist + part.sum(0, dtype=I32)


def ring_write(series: torch.Tensor, stride: int, now: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Write this tick's [NUM_SERIES] sample into the strided ring, in place.

    Column of tick t is (t // stride) % window; the first tick of a stride
    bucket resets the column, later ticks accumulate (counter rows) or
    overwrite (gauge rows)."""
    col = torch.remainder(torch.div(now, stride, rounding_mode="floor"),
                          series.shape[-1]).to(torch.int64).reshape(1)
    fresh = torch.remainder(now, stride) == 0
    base = torch.where(fresh, 0, series.index_select(1, col)[:, 0])
    rows = torch.arange(NUM_SERIES, device=series.device)
    gauge = torch.zeros_like(rows, dtype=torch.bool)
    for r in GAUGE_ROWS:
        gauge = gauge | (rows == r)
    vals = vals.to(I32)
    return col_set(series, col, torch.where(gauge, vals, base + vals))


def percentile_edge_device(hist: torch.Tensor, q: int) -> torch.Tensor:
    """Upper edge (ticks, int32 0-d tensor) of the q-th percentile bucket, on
    the device.  q is an integer percent.  The overflow bucket reads as
    int32 max; an empty histogram reads as the first edge (callers gate on
    sum(hist) > 0)."""
    total = hist.sum(dtype=I32)
    k = torch.clamp(torch.div(q * total + 99, 100, rounding_mode="floor"),
                    min=1)
    b = (hist.cumsum(0, dtype=I32) >= k).to(I32).argmax()
    edges = torch.cat([bucket_edges(hist.device),
                       torch.full((1,), 2 ** 31 - 1, dtype=I32,
                                  device=hist.device)])
    return edges[b]
