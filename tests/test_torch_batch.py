"""The port's batch-native tick against jax.vmap(step): all-field bit
identity on a leading [B] axis of clusters.

numpy makes each tick's per-cluster `alive` [B, N] and `drop` [B, N, N]
from a seed (every cluster its own drop rate and crash rate) and hands
them to both packages: JAX runs jax.vmap of its step over the stacked
state, the port runs its step once on the batched state.  Every field of
every cluster is compared after every tick; all raft state is integer, so
the tolerance is exact equality.  Also: B=1 equals the unbatched tick, and
the levers and planes the batched tick does not run raise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import assert_same, jax_numpy

CPU = "cpu"
B = 4
DST5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10)
# (i) the sync wire, dynamic members, reads and the fused propose; (ii)
# PreVote with the vote guard, cooldown 15, fsync every 2 ticks with ack
# gating, and telemetry; (iii) the mailbox wire: latency 2, jitter 1,
# inflight 4
CONFIGS = {
    "sync_dynamic_reads": dict(DST5, read_batch=2),
    "prevote_guard_storage_telemetry": dict(
        DST5, pre_vote=True, vote_guard=True, transfer_cooldown_ticks=15,
        fsync_lag_ticks=2, ack_gating=True, collect_telemetry=True,
        slo_p99_commit_ticks=16),
    "mailbox_lat2_jitter1_inflight4": dict(
        DST5, latency=2, latency_jitter=1, inflight=4, election_tick=14),
}
DROP_RATE = np.array([0.0, 0.1, 0.3, 0.05])[:, None, None]
DOWN_RATE = np.array([0.0, 0.05, 0.1, 0.2])[:, None]


def _faults(rng, n: int):
    drop = rng.random((B, n, n)) < DROP_RATE
    alive = rng.random((B, n)) >= DOWN_RATE
    return alive, drop


def _jstep_impl(st, alive, drop, cfg, prop):
    def one(s, a, d):
        return jkernel.step(s, cfg, alive=a, drop=d,
                            prop_count=jnp.asarray(prop, jnp.int32),
                            payload_fn=jrun._payload_at)
    return jax.vmap(one)(st, alive, drop)


# jax.vmap(step) with the fused propose, compiled once per config for the
# whole file
_vstep = jax.jit(_jstep_impl, static_argnames=("cfg", "prop"))


def _clear(batch: int, n: int):
    return (jnp.ones((batch, n), bool), jnp.zeros((batch, n, n), bool))


def _stacked(jcfg, batch: int):
    """The JAX init state stacked `batch` times, and its port copy."""
    j0 = jstate.init_state(jcfg)
    jb = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), j0)
    return jb, tstate.state_from_numpy(jax_numpy(jb), device=CPU)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_step_equals_jax_vmap(name):
    kw = CONFIGS[name]
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jb, tb = _stacked(jcfg, B)
    prop = 2
    rng = np.random.default_rng(11)
    tkernel.reset_counts()
    for t in range(72):
        alive, drop = _faults(rng, jcfg.n)
        jb = _vstep(jb, jnp.asarray(alive), jnp.asarray(drop), cfg=jcfg,
                    prop=prop)
        tb = tkernel.step(tb, tcfg, alive=torch.from_numpy(alive),
                          drop=torch.from_numpy(drop), prop_count=prop,
                          payload_fn=trun._payload_at, device=CPU)
        assert_same(f"{name} tick {t}", jb, tb)
    # the batched tick reads nothing back
    assert tkernel.COUNTS["host_syncs"] == 0
    # every cluster elected and committed, each at its own pace
    commit = tb.commit.amax(1)
    assert bool((commit > 0).all()) and len(set(commit.tolist())) > 1


def test_batch_of_one_equals_the_unbatched_step():
    """B=1 runs the batched program; it gives the unbatched tick's bits on
    the widest configuration (mailbox, PreVote, reads, gated storage,
    telemetry, cooldown)."""
    kw = dict(CONFIGS["mailbox_lat2_jitter1_inflight4"], pre_vote=True,
              read_batch=2, fsync_lag_ticks=2, ack_gating=True,
              collect_telemetry=True, transfer_cooldown_ticks=15,
              collect_stats=True)
    cfg = tstate.SimConfig(**kw)
    one = tstate.init_state(cfg, device=CPU)
    batch = tstate.broadcast_state(one, 1)
    assert tstate.batch_size(batch) == 1 and tstate.batch_size(one) is None
    rng = np.random.default_rng(5)
    for t in range(60):
        drop = rng.random((cfg.n, cfg.n)) < 0.1
        alive = rng.random(cfg.n) >= 0.05
        one = tkernel.step(one, cfg, alive=torch.from_numpy(alive),
                           drop=torch.from_numpy(drop), prop_count=2,
                           payload_fn=trun._payload_at, device=CPU)
        batch = tkernel.step(batch, cfg,
                             alive=torch.from_numpy(alive[None]),
                             drop=torch.from_numpy(drop[None]),
                             prop_count=2, payload_fn=trun._payload_at,
                             device=CPU)
        want = tstate.state_to_numpy(one)
        got = tstate.state_to_numpy(batch)
        assert sorted(want) == sorted(got)
        for k, w in want.items():
            assert np.array_equal(got[k][0], w), f"tick {t}: {k}"
    assert int(one.commit.max()) > 0


def test_batched_propose_dense_takes_per_cluster_counts():
    """propose_dense on a batched state with a [B] device count equals JAX's
    vmap of it (the dst append_flood verb's call)."""
    kw = CONFIGS["prevote_guard_storage_telemetry"]
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jb, tb = _stacked(jcfg, B)
    for _ in range(25):
        jb = _vstep(jb, *_clear(B, jcfg.n), cfg=jcfg, prop=2)
        tb = tkernel.step(tb, tcfg, prop_count=2,
                          payload_fn=trun._payload_at, device=CPU)
    counts = np.array([0, 8, 3, 8], np.int32)

    def jprop(st, cnt):
        return jkernel.propose_dense(st, jcfg, jrun._payload_at, cnt)

    jb = jax.jit(jax.vmap(jprop))(jb, jnp.asarray(counts))
    tb = tkernel.propose_dense(tb, tcfg, trun._payload_at,
                               torch.from_numpy(counts), device=CPU)
    assert_same("propose_dense", jb, tb)
    assert int(tb.last.max()) > int(tb.commit.max())


def test_broadcast_state_copies_every_field():
    """The tick writes rings in place, so no two clusters share storage."""
    cfg = tstate.SimConfig(**DST5)
    one = tstate.init_state(cfg, device=CPU)
    batch = tstate.broadcast_state(one, 3)
    for f in tstate.FIELD_NAMES:
        t = getattr(batch, f)
        if t is not None:
            assert t.shape == (3,) + getattr(one, f).shape, f
    batch.log_term[1, 2, 3] = 7
    assert int(batch.log_term[0, 2, 3]) == 0 and int(one.log_term[2, 3]) == 0
    with pytest.raises(ValueError, match="one cluster"):
        tstate.broadcast_state(batch, 2)


def test_batched_run_schedule_and_reductions_are_per_cluster():
    """run_schedule takes [B, T, ...] schedules and gives [B, T, 3] trace
    rows equal to each cluster run alone; leader_mask, has_leader and
    committed_entries reduce inside each cluster."""
    cfg = tstate.SimConfig(**CONFIGS["sync_dynamic_reads"])
    rng = np.random.default_rng(2)
    ticks = 40
    drop = rng.random((B, ticks, cfg.n, cfg.n)) < DROP_RATE[:, None]
    alive = rng.random((B, ticks, cfg.n)) >= DOWN_RATE[:, None]
    batch = tstate.broadcast_state(tstate.init_state(cfg, device=CPU), B)
    batch, trace = trun.run_schedule(batch, cfg, torch.from_numpy(drop),
                                     torch.from_numpy(alive), prop_count=2,
                                     device=CPU)
    assert trace.shape == (B, ticks, 3)
    for b in range(B):
        one, tr1 = trun.run_schedule(
            tstate.init_state(cfg, device=CPU), cfg,
            torch.from_numpy(drop[b]), torch.from_numpy(alive[b]),
            prop_count=2, device=CPU)
        assert torch.equal(trace[b], tr1)
        assert torch.equal(trun.leader_mask(batch)[b], trun.leader_mask(one))
        assert bool(trun.has_leader(batch)[b]) == bool(trun.has_leader(one))
        assert int(trun.committed_entries(batch)[b]) \
            == int(trun.committed_entries(one))


REFUSED = {
    "tiled log": dict(DST5, log_len=1024, window=64, apply_batch=64,
                      max_props=64, keep=32, log_chunk=128),
    "banded peers": dict(DST5, n=16, peer_chunk=8, active_rows=0),
    "progress slab": dict(DST5, n=16, active_rows=8),
    "flight recorder": dict(DST5, record_events=True),
    "trace tags": dict(DST5, record_events=True, collect_telemetry=True,
                       trace_tags=True),
}


@pytest.mark.parametrize("lever", sorted(REFUSED))
def test_batched_step_refuses_what_it_does_not_run(lever):
    """A lever or plane the batched tick does not run raises a ValueError
    that names its ROADMAP item; it never runs something else."""
    cfg = tstate.SimConfig(**REFUSED[lever])
    batch = tstate.broadcast_state(tstate.init_state(cfg, device=CPU), 2)
    with pytest.raises(ValueError, match="ROADMAP"):
        tkernel.step(batch, cfg, device=CPU)
    with pytest.raises(ValueError, match="ROADMAP"):
        tkernel.propose_dense(batch, cfg, trun._payload_at, 1, device=CPU)


@pytest.mark.parametrize("api", ["propose", "propose_conf",
                                 "transfer_leadership", "submit_reads"])
def test_host_apis_take_one_cluster(api):
    """propose_conf and transfer_leadership take one cluster's state and
    refuse a batched one; propose and submit_reads are batch-native, each
    cluster equal to its own unbatched call."""
    cfg = tstate.SimConfig(**dict(DST5, read_batch=2))
    one = tstate.init_state(cfg, device=CPU)
    one, _ = trun.run_until_leader(one, cfg, 100, device=CPU)
    batch = tstate.broadcast_state(one, 2)
    calls = {
        "propose_conf": lambda: tkernel.propose_conf(batch, cfg, 1, True,
                                                     device=CPU),
        "transfer_leadership": lambda: tkernel.transfer_leadership(
            batch, cfg, 0, 1),
    }
    if api in calls:
        with pytest.raises(ValueError, match="one cluster"):
            calls[api]()
        return
    payloads = np.array([[1, 2, 0, 0, 0, 0, 0, 0], [7, 8, 9, 0, 0, 0, 0, 0]])
    counts = [2, 3]
    if api == "propose":
        got = tkernel.propose(batch, cfg, payloads, counts, device=CPU)
    else:
        got = trun.submit_reads(batch, cfg, counts, device=CPU)
    g = tstate.state_to_numpy(got)
    for b in range(2):
        single = tstate.state_from_numpy(tstate.state_to_numpy(one),
                                         device=CPU)
        if api == "propose":
            want = tkernel.propose(single, cfg, payloads[b], counts[b],
                                   device=CPU)
        else:
            want = trun.submit_reads(single, cfg, counts[b], device=CPU)
        for k, w in tstate.state_to_numpy(want).items():
            assert np.array_equal(g[k][b], w), (api, b, k)
    if api == "propose":
        assert g["last"].max(1).tolist() == [
            int(one.last.amax()) + c for c in counts]


def test_batched_telemetry_folds_stay_in_their_cluster():
    """The histogram fold, the series ring and the percentile read of a
    batched plane equal each cluster's own unbatched ones."""
    from swarmkit_tpu_torch.telemetry import series as ts

    rng = np.random.default_rng(9)
    hist = torch.from_numpy(rng.integers(0, 5, (3, ts.NUM_BUCKETS))
                            .astype(np.int32))
    mask = torch.from_numpy(rng.random((3, 5, 7)) < 0.5)
    lat = torch.from_numpy(rng.integers(0, 300, (3, 5, 7)).astype(np.int32))
    w = torch.from_numpy(rng.integers(1, 4, (3, 5, 7)).astype(np.int32))
    got = ts.hist_fold(hist.clone(), mask, lat, weight=w)
    edge = ts.percentile_edge_device(got, 99)
    series = torch.from_numpy(rng.integers(0, 9, (3, ts.NUM_SERIES, 8))
                              .astype(np.int32))
    now = torch.tensor([3, 8, 17], dtype=torch.int32)
    vals = torch.from_numpy(rng.integers(0, 9, (3, ts.NUM_SERIES))
                            .astype(np.int32))
    ring = ts.ring_write(series.clone(), 4, now, vals)
    for b in range(3):
        one = ts.hist_fold(hist[b].clone(), mask[b], lat[b], weight=w[b])
        assert torch.equal(got[b], one)
        assert int(edge[b]) == int(ts.percentile_edge_device(one, 99))
        assert torch.equal(ring[b], ts.ring_write(series[b].clone(), 4,
                                                  now[b], vals[b]))


def test_batched_payloads_follow_each_clusters_tick():
    """The fused propose's payloads use each cluster's own tick: clusters
    whose ticks differ get different payload bits (JAX's vmap semantics)."""
    kw = CONFIGS["sync_dynamic_reads"]
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jb, tb = _stacked(jcfg, B)
    ticks = np.array([0, 5, 9, 0], np.int32)
    jb = dataclasses.replace(jb, tick=jnp.asarray(ticks))
    tb = dataclasses.replace(tb, tick=torch.from_numpy(ticks))
    for t in range(30):
        jb = _vstep(jb, *_clear(B, jcfg.n), cfg=jcfg, prop=2)
        tb = tkernel.step(tb, tcfg, prop_count=2,
                          payload_fn=trun._payload_at, device=CPU)
        assert_same(f"tick {t}", jb, tb)
    assert not torch.equal(tb.apply_chk[0], tb.apply_chk[1])
    assert torch.equal(tb.apply_chk[0], tb.apply_chk[3])
