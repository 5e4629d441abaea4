"""The batched tick's levers and planes where the clusters of one batch
disagree: each cluster against jax.vmap(step), on every field and tick.

The port decides the tiled ring write and the progress slab once for the
batch (the union of the clusters' bands; the slab only if every cluster
fits), where JAX's vmap selects per cluster.  These tests put clusters
that would choose differently into the same tick:

- a cluster whose band fits beside one whose band does not, and two
  clusters whose bands each fit but whose union does not (the ring write
  takes the full pass; no cluster records FALLBACK_TICK), with the
  per-cluster FALLBACK_TICK rows of `ev_buf` held to JAX's;
- a cluster whose active rows fit the slab beside one in an election
  storm, on the sync wire and on the mailbox wire;
- batched `propose`, `propose_dense` and `submit_reads` with one shared
  trace tag and with a tag per cluster.

Faults and counts are made from a seed with numpy and handed to both
packages; the tolerance is exact equality (all raft state is integer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.flightrec import codes as fc
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import assert_same, jax_numpy

CPU = "cpu"
DST5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10)
TILED = dict(DST5, log_len=1024, window=64, apply_batch=64, max_props=64,
             keep=32, log_chunk=128, record_events=True)
SLAB = dict(DST5, n=16, active_rows=8)


def _vstep_impl(st, alive, drop, prop, cfg):
    def one(s, a, d, c):
        return jkernel.step(s, cfg, alive=a, drop=d, prop_count=c,
                            payload_fn=jrun._payload_at)
    return jax.vmap(one)(st, alive, drop, prop)


# jax.vmap(step) with a per-cluster proposal count, and without the fused
# propose (whose batch stamp would take the column a host propose stamped
# at the same tick)
_vstep = jax.jit(_vstep_impl, static_argnames=("cfg",))
_vstep_bare = jax.jit(
    lambda st, alive, drop, cfg: jax.vmap(
        lambda s, a, d: jkernel.step(s, cfg, alive=a, drop=d))(
            st, alive, drop), static_argnames=("cfg",))


def _stacked(jcfg, batch: int):
    j0 = jstate.init_state(jcfg)
    jb = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), j0)
    return jb, tstate.state_from_numpy(jax_numpy(jb), device=CPU)


def _both(jb, tb, jcfg, tcfg, alive, drop, prop):
    if prop is None:
        return (_vstep_bare(jb, jnp.asarray(alive), jnp.asarray(drop),
                            cfg=jcfg),
                tkernel.step(tb, tcfg, alive=torch.from_numpy(alive),
                             drop=torch.from_numpy(drop), device=CPU))
    jb = _vstep(jb, jnp.asarray(alive), jnp.asarray(drop),
                jnp.asarray(prop), cfg=jcfg)
    tb = tkernel.step(tb, tcfg, alive=torch.from_numpy(alive),
                      drop=torch.from_numpy(drop),
                      prop_count=torch.from_numpy(prop),
                      payload_fn=trun._payload_at, device=CPU)
    return jb, tb


def _fallback_ticks(ev_buf: torch.Tensor) -> list:
    """Per cluster, the ticks of the FALLBACK_TICK events in row 0's ring."""
    rows = ev_buf[:, 0].numpy()                      # [B, cap, W]
    return [sorted(set(r[r[:, 1] == fc.FALLBACK_TICK, 0].tolist()))
            for r in rows]


def test_tiled_union_band_and_per_cluster_fallback_events(monkeypatch):
    """Two clusters of the tiled log: cluster 0 proposes 1 entry a tick,
    cluster 1 proposes 40, so their logs drift apart until the union of
    their bands no longer fits and the ring write takes the full pass,
    while each cluster's own band still fits (no FALLBACK_TICK); cluster
    1's leader is then crashed, so its election ticks (full pass, its own
    FALLBACK_TICK) land beside cluster 0's fitting band."""
    jcfg, tcfg = jstate.SimConfig(**TILED), tstate.SimConfig(**TILED)
    n, L = jcfg.n, jcfg.log_len
    widths = []
    copy = tkernel.cuda_ops.append_band_copy

    def recording(log_term, log_data, off, src_t, src_d, write):
        widths.append(write.shape[1])
        copy(log_term, log_data, off, src_t, src_d, write)

    monkeypatch.setattr(tkernel.cuda_ops, "append_band_copy", recording)
    jb, tb = _stacked(jcfg, 2)
    prop = np.array([1, 40], np.int32)
    none_drop = np.zeros((2, n, n), bool)
    full_pass = []
    for t in range(75):
        alive = np.ones((2, n), bool)
        if t == 40:
            down = tb.role[1].numpy() == tstate.LEADER
        if 40 <= t < 60:
            alive[1] = ~down
        widths.clear()
        jb, tb = _both(jb, tb, jcfg, tcfg, alive, none_drop, prop)
        assert_same(f"tick {t}", jb, tb)
        if L in widths:
            full_pass.append(t)
    fb = _fallback_ticks(tb.ev_buf)
    # the union's full pass ran on ticks where no cluster's band overflowed
    union_only = [t for t in full_pass if t not in fb[0] + fb[1]]
    assert union_only, (full_pass, fb)
    # and cluster 1 fell back on ticks where cluster 0's own band fitted
    assert set(fb[1]) - set(fb[0]), fb
    assert int(tb.last[1].amax()) - int(tb.last[0].amax()) \
        > 2 * tcfg.band_chunks * tcfg.log_chunk


def test_tiled_propose_dense_per_cluster_counts():
    """propose_dense on a batched tiled state with [B] counts whose bands
    fit alone and overflow together (the union's full pass), then ticks:
    each cluster equal to JAX's vmap of propose_dense and step."""
    jcfg, tcfg = jstate.SimConfig(**TILED), tstate.SimConfig(**TILED)
    n = jcfg.n
    jb, tb = _stacked(jcfg, 3)
    ones, none = np.ones((3, n), bool), np.zeros((3, n, n), bool)
    for t in range(40):
        prop = np.array([0, 1, 60], np.int32) if t >= 20 else \
            np.zeros((3,), np.int32)
        jb, tb = _both(jb, tb, jcfg, tcfg, ones, none, prop)
    assert int(tb.last[2].amax()) - int(tb.last[0].amax()) \
        > tcfg.band_chunks * tcfg.log_chunk
    jdense = jax.jit(jax.vmap(
        lambda s, c: jkernel.propose_dense(s, jcfg, jrun._payload_at, c)))
    for counts in ([5, 0, 64], [0, 7, 0]):
        counts = np.array(counts, np.int32)
        jb = jdense(jb, jnp.asarray(counts))
        tb = tkernel.propose_dense(tb, tcfg, trun._payload_at,
                                   torch.from_numpy(counts), device=CPU)
        assert_same(f"propose_dense {counts.tolist()}", jb, tb)
        for t in range(3):
            jb, tb = _both(jb, tb, jcfg, tcfg, ones, none, None)
            assert_same(f"after {counts.tolist()}, tick {t}", jb, tb)


def _slab_run(kw: dict, ticks: int, storm_drop: float, seed: int):
    """B=2 on the slab against jax.vmap, cluster 1 cut off completely for
    ticks 12-31 (every row campaigns: an election storm that overflows the
    slab) and under `storm_drop` random drops after; and cluster 0 alone
    (B=1) beside it.  Returns the ticks on which the batch took the dense
    fallback while cluster 0 alone took the slab, and the batch's slab
    tick count."""
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    n = jcfg.n
    jb, tb = _stacked(jcfg, 2)
    alone = tstate.broadcast_state(tstate.init_state(tcfg, device=CPU), 1)
    rng = np.random.default_rng(seed)
    prop = np.array([2, 2], np.int32)
    split, slab = [], 0
    for t in range(ticks):
        drop = np.zeros((2, n, n), bool)
        drop[1] = (rng.random((n, n)) < storm_drop) | (12 <= t < 32)
        alive = np.ones((2, n), bool)
        tkernel.reset_counts()
        jb, tb = _both(jb, tb, jcfg, tcfg, alive, drop, prop)
        batch_fell = tkernel.COUNTS["dense_fallback_ticks"] == 1
        slab += tkernel.COUNTS["slab_ticks"]
        tkernel.reset_counts()
        alone = tkernel.step(alone, tcfg, alive=torch.from_numpy(alive[:1]),
                             drop=torch.from_numpy(drop[:1]), prop_count=2,
                             payload_fn=trun._payload_at, device=CPU)
        if batch_fell and tkernel.COUNTS["slab_ticks"] == 1:
            split.append(t)
        assert_same(f"tick {t}", jb, tb)
    for k, w in tstate.state_to_numpy(alone).items():
        assert np.array_equal(tstate.state_to_numpy(tb)[k][:1], w), k
    return split, slab


def test_slab_fit_and_overflow_in_one_batch():
    """Sync wire: cluster 1's election storm overflows the [8, 16] slab
    while cluster 0's active rows fit; the batch takes the dense rows for
    both on those ticks and the slab on the others, each cluster equal to
    JAX's (active_ttl included) and cluster 0 equal to itself alone."""
    split, slab = _slab_run(SLAB, 60, 0.2, 3)
    assert split and slab > 0, (split, slab)


def test_mailbox_wire_on_the_slab():
    """The mailbox wire's per-edge slots gathered into the slab and merged
    back, per cluster: latency 2, jitter 1, inflight 4."""
    kw = dict(SLAB, latency=2, latency_jitter=1, inflight=4,
              election_tick=14)
    split, slab = _slab_run(kw, 60, 0.2, 4)
    assert slab > 0 and split, (split, slab)


TAGS = dict(DST5, read_batch=2, record_events=True, collect_telemetry=True,
            trace_tags=True)


def test_batched_host_apis_take_shared_and_per_cluster_tags():
    """propose, propose_dense and submit_reads on a batched state, with
    one tag for every cluster and with a [B] tag, equal JAX's vmap of each
    (tag broadcast, or mapped); the tags reach the commit and serve events
    of the ticks that follow."""
    jcfg, tcfg = jstate.SimConfig(**TAGS), tstate.SimConfig(**TAGS)
    n, b = jcfg.n, 3
    jb, tb = _stacked(jcfg, b)
    ones, none = np.ones((b, n), bool), np.zeros((b, n, n), bool)
    zero = np.zeros((b,), np.int32)
    for _ in range(30):
        jb, tb = _both(jb, tb, jcfg, tcfg, ones, none, zero)
    assert bool(trun.has_leader(tb).all())
    rng = np.random.default_rng(8)
    payloads = rng.integers(0, 2 ** 31, (b, jcfg.max_props)).astype(np.uint32)
    counts = np.array([3, 0, 5], np.int32)
    per = np.array([11, 12, 13], np.int32)

    jprop = jax.jit(jax.vmap(
        lambda s, p, c, g: jkernel.propose(s, jcfg, p, c, tag=g)))
    jdense = jax.jit(jax.vmap(
        lambda s, c, g: jkernel.propose_dense(s, jcfg, jrun._payload_at, c,
                                              tag=g)))
    jreads = jax.jit(jax.vmap(
        lambda s, c, g: jrun.submit_reads(s, jcfg, c, tag=g)))
    calls = [
        ("propose shared", lambda s: jprop(s, jnp.asarray(payloads),
                                           jnp.asarray(counts),
                                           jnp.full((b,), 7, jnp.int32)),
         lambda s: tkernel.propose(s, tcfg, payloads, counts, tag=7,
                                   device=CPU)),
        ("propose_dense per cluster",
         lambda s: jdense(s, jnp.asarray(counts), jnp.asarray(per)),
         lambda s: tkernel.propose_dense(s, tcfg, trun._payload_at,
                                         torch.from_numpy(counts),
                                         tag=torch.from_numpy(per),
                                         device=CPU)),
        ("submit_reads per cluster",
         lambda s: jreads(s, jnp.asarray(counts), jnp.asarray(per + 10)),
         lambda s: trun.submit_reads(s, tcfg, counts, tag=per + 10,
                                     device=CPU)),
    ]
    for name, jcall, tcall in calls:
        jb, tb = jcall(jb), tcall(tb)
        assert_same(name, jb, tb)
        for t in range(6):
            jb, tb = _both(jb, tb, jcfg, tcfg, ones, none, None)
            assert_same(f"after {name}, tick {t}", jb, tb)
    # a shared tag on submit_reads too, then the events carry both kinds
    jb = jreads(jb, jnp.asarray(counts), jnp.full((b,), 4, jnp.int32))
    tb = trun.submit_reads(tb, tcfg, counts, tag=4, device=CPU)
    for t in range(4):
        jb, tb = _both(jb, tb, jcfg, tcfg, ones, none, None)
    assert_same("shared read tag", jb, tb)
    tags = set(tb.ev_buf[..., 4].reshape(-1).tolist())
    assert {7, 11, 13, 21, 23, 4}.issubset(tags), tags
