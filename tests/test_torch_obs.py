"""The device observability planes on the port against the JAX package.

The flight recorder, telemetry and trace tags run in the port's tick and
in JAX's, in lockstep on the CPU from one seeded numpy schedule (the
lockstep of tests/test_torch_wire.py), with host trace tags on `propose`,
`submit_reads` and the fused propose's `step(prop_tag=)`.  Every SimState
field (the event ring, its cursor and fault-edge registers, every tel_*
buffer, the read tag) must be equal after every call and tick: all of it
is integer, so the tolerance is exact.  Two configurations bound the JAX
compiles: (a) the sync wire, tiled, banded peer counts and the [8, N]
progress slab, with a storm (both progress branches) and fused proposes;
(b) the mailbox wire with PreVote, dynamic membership, reads and gated
storage, and a variant with a 64-deep propose-batch ring and stride 2.

Also: run_ticks without a drop matrix, the device percentile against
JAX's, and the ring append's wrap and dropped count (sequential and the
kernel's one-scatter form against JAX's ring_append).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.flightrec import codes as jcodes
from swarmkit_tpu.flightrec import decoder as jdecoder
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu.telemetry import series as jseries
from swarmkit_tpu_torch.flightrec import codes as tcodes
from swarmkit_tpu_torch.flightrec import decoder as tdecoder
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.telemetry import series as tseries

from tests.test_torch_step import CPU, assert_same
from tests.test_torch_wire import lockstep, one_torch_thread  # noqa: F401

PLANES = dict(record_events=True, collect_telemetry=True, trace_tags=True)
# (a): the sync wire at n=16, tiled log, two peer bands of 8, the [8, N]
# progress slab, fused proposes
SYNC_TILED = dict(n=16, log_len=1024, window=64, apply_batch=64,
                  max_props=64, keep=32, election_tick=14, seed=3,
                  log_chunk=128, peer_chunk=8, active_rows=8,
                  static_members=True, collect_stats=True, event_ring=128,
                  **PLANES)
# (b): the mailbox wire with PreVote, dynamic membership, reads and the
# gated storage model
MAILBOX_ALL = dict(n=16, log_len=1024, window=64, apply_batch=64,
                   max_props=64, keep=32, election_tick=14, seed=5,
                   latency=2, latency_jitter=1, inflight=2, pre_vote=True,
                   log_chunk=128, peer_chunk=8, active_rows=8, read_batch=4,
                   fsync_lag_ticks=2, ack_gating=True, event_ring=16,
                   **PLANES)


def _tag(t: int) -> int:
    """A tag per tick, as span_trace_tag gives (positive int32); every
    fifth tick untagged."""
    return 0x100 + 7 * t if t % 5 else None


def _events(ts):
    return tdecoder.decode_state(ts)[0]


def test_sync_tiled_banded_slab_storm():
    """(a): drops, crashes (FAULT_EDGE down/up), transfers, fused tagged
    proposes and a storm that overflows the slab: both progress branches,
    banded and one-pass counts, banded and full-pass ring writes."""
    r = lockstep(SYNC_TILED, 110, 42, drop_rate=0.05, crash_prob=0.2,
                 transfer_every=37, storm=(45, 70), fused=True, tag_fn=_tag)
    c = r["counts"]
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    names = {e.name for e in _events(r["ts"])}
    assert {"FAULT_EDGE", "TERM_BUMP", "ELECTION_WON", "COMMIT_ADVANCE",
            "FALLBACK_TICK"} <= names, names
    tagged = [e for e in _events(r["ts"]) if e.tag]
    assert tagged and all(e.name == "COMMIT_ADVANCE" for e in tagged)
    assert int(r["ts"].tel_commit_hist.sum()) > 0


@pytest.mark.parametrize("tel", [{}, dict(telemetry_prop_ring=64,
                                          telemetry_stride=2,
                                          telemetry_window=8)],
                         ids=["default-ring", "ring64-stride2"])
def test_mailbox_prevote_members_reads_storage(tel):
    """(b): host proposes and reads with tags, conf changes, stalled disks
    and flagged snapshot images (RECOVER_REJECT_SNAP), crashes and drops,
    a storm; every plane field equal after every call."""
    flags = {t: {"fsync_stall": [3, 4]} for t in range(40, 46)}
    flags.update({t: {"snap_bad": [9]} for t in range(60, 70)})
    reads = {t: (3, None if t % 2 else [0, 1, 2]) for t in range(20, 110, 9)}
    r = lockstep(dict(MAILBOX_ALL, **tel), 110, 7, drop_rate=0.05,
                 crash_prob=0.1, conf_every=30, storm=(80, 95),
                 reads_at=reads, flags_at=flags, tag_fn=_tag)
    assert r["max_commit"] > 0
    names = {e.name for e in _events(r["ts"])}
    assert {"COMMIT_ADVANCE", "FSYNC_ADVANCE", "READ_SERVED"} <= names, names
    assert int(r["ts"].tel_read_hist.sum()) > 0


def test_run_ticks_without_a_drop_matrix():
    """run_ticks with no drop rate hands step no drop matrix: the drop
    degree is zero, as JAX's zero matrix gives, and the whole state equals
    JAX's scan after an election and proposing ticks with a leader
    crash."""
    kw = dict(SYNC_TILED, trace_tags=False)
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    js, _ = jrun.run_ticks(jstate.init_state(jcfg), jcfg, 60,
                           prop_count=16, crash_every=25, down_for=4)
    ts, _ = trun.run_ticks(tstate.init_state(tcfg, device=CPU), tcfg, 60,
                           prop_count=16, crash_every=25, down_for=4,
                           device=CPU)
    assert_same("run_ticks", js, ts)
    assert not bool(ts.ev_drop.any())
    assert any(e.name == "FAULT_EDGE" for e in _events(ts))


def test_percentile_edge_device_matches_jax():
    """Seeded histograms, an empty one and one all in overflow: the same
    edge for every q."""
    rng = np.random.default_rng(11)
    hists = [rng.integers(0, 50, jseries.NUM_BUCKETS) for _ in range(6)]
    hists += [np.zeros(jseries.NUM_BUCKETS, np.int64),
              np.eye(jseries.NUM_BUCKETS, dtype=np.int64)[-1] * 9,
              np.eye(jseries.NUM_BUCKETS, dtype=np.int64)[0]]
    for h in hists:
        h = h.astype(np.int32)
        for q in (1, 50, 90, 99, 100):
            want = int(jseries.percentile_edge_device(jnp.asarray(h), q))
            got = tseries.percentile_edge_device(torch.from_numpy(h), q)
            assert got.dtype == torch.int32 and int(got) == want, (h, q)


def test_hist_fold_and_ring_write_match_jax():
    """The scatter-add fold equals JAX's exceed-count differencing
    (masked-out garbage latencies, weights, negative latencies), and the
    strided ring write equals JAX's on counter and gauge rows."""
    rng = np.random.default_rng(12)
    hist = rng.integers(0, 9, jseries.NUM_BUCKETS).astype(np.int32)
    lat = rng.integers(-5, 600, (16, 64)).astype(np.int32)
    mask = rng.random((16, 64)) < 0.4
    w = rng.integers(0, 70, (16, 64)).astype(np.int32)
    for weight in (None, w):
        want = jseries.hist_fold(jnp.asarray(hist), jnp.asarray(mask),
                                 jnp.asarray(lat), None if weight is None
                                 else jnp.asarray(weight))
        got = tseries.hist_fold(torch.from_numpy(hist),
                                torch.from_numpy(mask), torch.from_numpy(lat),
                                None if weight is None
                                else torch.from_numpy(weight))
        assert np.array_equal(got.numpy(), np.asarray(want))
    series = rng.integers(0, 99, (4, 8)).astype(np.int32)
    vals = rng.integers(0, 99, 4).astype(np.int32)
    for now in (0, 3, 8, 13):
        want = jseries.ring_write(jnp.asarray(series), 4,
                                  jnp.asarray(now, jnp.int32),
                                  jnp.asarray(vals))
        got = tseries.ring_write(torch.from_numpy(series.copy()), 4,
                                 torch.tensor(now, dtype=torch.int32),
                                 torch.from_numpy(vals))
        assert np.array_equal(got.numpy(), np.asarray(want)), now


@pytest.mark.parametrize("width", [4, 5])
def test_ring_append_wraps_and_counts_drops(width):
    """30 ticks of random appends into an 8-slot ring (rows wrap, some
    append more than 8 events in one tick): the port's sequential
    ring_append equals JAX's, the kernel's one-scatter form equals the
    sequential one, and the decoders agree on events and dropped counts."""
    rng = np.random.default_rng(width)
    n, cap = 6, 8
    jbuf = jnp.zeros((n, cap, width), jnp.int32)
    jpos = jnp.zeros((n,), jnp.int32)
    tbuf = torch.zeros((n, cap, width), dtype=torch.int32)
    tpos = torch.zeros((n,), dtype=torch.int32)
    mbuf, mpos = tbuf.clone(), tpos.clone()
    for tick in range(30):
        k = 12 if tick % 7 == 3 else 3
        batch = []
        for j in range(k):
            mask = rng.random(n) < 0.8
            a0 = rng.integers(-9, 99, n).astype(np.int32)
            a1 = rng.integers(0, 99, n).astype(np.int32)
            tag = rng.integers(1, 99, n).astype(np.int32)
            code = int(rng.integers(1, 21))
            jbuf, jpos = jcodes.ring_append(
                jbuf, jpos, jnp.asarray(mask), jnp.asarray(tick, jnp.int32),
                code, jnp.asarray(a0), jnp.asarray(a1), tag=jnp.asarray(tag))
            tt = torch.tensor(tick, dtype=torch.int32)
            tbuf, tpos = tcodes.ring_append(
                tbuf, tpos, torch.from_numpy(mask), tt, code,
                torch.from_numpy(a0), torch.from_numpy(a1),
                tag=torch.from_numpy(tag))
            batch.append((code, (torch.from_numpy(mask), torch.from_numpy(a0),
                                 torch.from_numpy(a1),
                                 torch.from_numpy(tag))))
        mbuf, mpos = tcodes.ring_append_many(
            mbuf, mpos, torch.tensor(tick, dtype=torch.int32),
            [e for _, e in batch],
            torch.tensor([c for c, _ in batch], dtype=torch.int32))
        assert np.array_equal(tbuf.numpy(), np.asarray(jbuf)), tick
        assert np.array_equal(tpos.numpy(), np.asarray(jpos)), tick
        assert torch.equal(mbuf, tbuf) and torch.equal(mpos, tpos), tick
    jev, jdrop = jdecoder.decode_rings(jbuf, jpos)
    tev, tdrop = tdecoder.decode_rings(tbuf, tpos)
    assert [e.to_dict() for e in tev] == [e.to_dict() for e in jev]
    assert np.array_equal(tdrop, np.asarray(jdrop)) and tdrop.sum() > 0
