"""Banded peer counts and role-sparse progress: the port against the JAX package.

Both levers are lowerings, not semantics, and the JAX package pins each
bit-identical to its dense form (TestTiledPeer, TestSparseProgress in
tests/test_raft_sim.py).  Here the port's lowering runs the same schedule
as the JAX package's same lowering, from the same config, and every
SimState field, active_ttl included, must be equal on every tick (exact:
all raft state is integer).  The port's branch counters show which
progress rows each tick ran on.
"""

from __future__ import annotations

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

from tests.test_torch_step import (
    CPU, _jstep_fused, _tstep_fused, assert_same, configs, t_bool,
)

FAULTS = dict(n=16, log_len=1024, window=64, apply_batch=64, max_props=64,
              keep=32, election_tick=14, seed=3, static_members=True)
STORM = dict(n=16, log_len=256, window=32, apply_batch=64, max_props=16,
             keep=8, election_tick=10, seed=5, static_members=True)


def _leaders(st) -> np.ndarray:
    return np.flatnonzero(np.asarray(st.role) == jstate.LEADER)


@pytest.mark.parametrize("levers", [
    dict(peer_chunk=8, active_rows=0),
    dict(peer_chunk=0, active_rows=8),
    dict(peer_chunk=8, active_rows=8, log_chunk=128),
], ids=["banded-peer", "sparse-progress", "both-tiled-log"])
def test_faulted_schedule_bit_identical(levers):
    """The static-sync schedule of TestTiledPeer/TestSparseProgress: 300
    ticks of crashes, 5% drops, leader transfers every 37 ticks and bursty
    fused proposals, n=16 (two peer bands of 8, a slab of 8 rows)."""
    jcfg, tcfg = configs(**{**FAULTS, **levers})
    assert tcfg.peer_tiled == (levers["peer_chunk"] > 0)
    assert tcfg.active_rows_on == (levers["active_rows"] > 0)
    rng = np.random.default_rng(42)
    js = jstate.init_state(jcfg)
    ts = tstate.init_state(tcfg, device=CPU)
    tkernel.reset_counts()
    for t in range(300):
        alive = rng.random(16) > 0.08
        drop = rng.random((16, 16)) < 0.05
        cnt = int(rng.integers(0, 49))
        if t % 37 == 36 and len(_leaders(js)):
            lid, tgt = int(_leaders(js)[0]), int(rng.integers(16))
            js = jkernel.transfer_leadership(js, jcfg, lid, tgt)
            ts = tkernel.transfer_leadership(ts, tcfg, lid, tgt)
        js = _jstep_fused(js, jcfg, jnp.asarray(alive), jnp.asarray(drop),
                          jnp.asarray(cnt, jnp.int32))
        ts = _tstep_fused(ts, tcfg, alive, drop, cnt)
        assert_same(f"{levers} tick {t}", js, ts)
    assert int(np.asarray(js.commit).max()) > 100
    if tcfg.active_rows_on:
        c = tkernel.COUNTS
        assert c["slab_ticks"] + c["dense_fallback_ticks"] == 300
        assert c["slab_ticks"] > 0, c


@pytest.mark.parametrize("extra", [
    dict(),
    dict(log_len=1024, window=64, max_props=64, keep=32, log_chunk=128,
         peer_chunk=8),
], ids=["untiled", "tiled-banded"])
def test_election_storm_takes_both_branches(extra):
    """test_forced_fallback_election_storm's schedule with active_rows=8:
    elect, drop every non-self edge for 60 ticks so every row campaigns
    (more active rows than the slab holds: the dense fallback), heal,
    re-elect, settle.  Both branches must run, every tick must equal the
    JAX package's, and the host read-backs must be one per slab tick and
    (tiled) two per fallback tick, whose speculative slab pass is redone."""
    jcfg, tcfg = configs(**{**STORM, **extra}, active_rows=8)
    js = jstate.init_state(jcfg)
    ts = tstate.init_state(tcfg, device=CPU)
    no_drop = np.zeros((16, 16), bool)
    storm = ~np.eye(16, dtype=bool)
    alive = np.ones(16, bool)
    tkernel.reset_counts()
    ticks = 0

    def tick(tag, drop):
        nonlocal js, ts, ticks
        js = _jstep_fused(js, jcfg, jnp.asarray(alive), jnp.asarray(drop),
                          jnp.asarray(4, jnp.int32))
        ts = _tstep_fused(ts, tcfg, alive, drop, 4)
        ticks += 1
        assert_same(tag, js, ts)

    for t in range(120):
        tick(f"elect {t}", no_drop)
        if len(_leaders(js)):
            break
    assert len(_leaders(js)) == 1
    peak = 0
    for t in range(60):
        tick(f"storm {t}", storm)
        peak = max(peak, int((np.asarray(js.role) != jstate.FOLLOWER).sum()))
    assert peak > tcfg.active_rows
    for t in range(150):
        tick(f"heal {t}", no_drop)
        if len(_leaders(js)):
            break
    assert len(_leaders(js)) == 1
    for t in range(20):
        tick(f"steady {t}", no_drop)
    c = tkernel.COUNTS
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    assert c["slab_ticks"] + c["dense_fallback_ticks"] == ticks
    per_fallback = 2 if tcfg.tiled else 1
    assert c["host_syncs"] == c["slab_ticks"] \
        + per_fallback * c["dense_fallback_ticks"], c


def test_run_schedule_matches_jax():
    """run_schedule over a [T, N, N] drop / [T, N] liveness schedule with a
    storm window (both levers, tiled log, fused proposals): the same trace
    rows and final state as the JAX package's run_schedule."""
    jcfg, tcfg = configs(**{**FAULTS, "log_chunk": 128}, peer_chunk=8,
                         active_rows=8)
    T = 140
    rng = np.random.default_rng(7)
    drop = rng.random((T, 16, 16)) < 0.03
    drop[50:80] |= ~np.eye(16, dtype=bool)          # storm: all rows hot
    alive = rng.random((T, 16)) > 0.03
    js, jtrace = jrun.run_schedule(jstate.init_state(jcfg), jcfg,
                                   jnp.asarray(drop), jnp.asarray(alive),
                                   prop_count=32)
    tkernel.reset_counts()
    ts, ttrace = trun.run_schedule(tstate.init_state(tcfg, device=CPU), tcfg,
                                   t_bool(drop), t_bool(alive), prop_count=32,
                                   device=CPU)
    np.testing.assert_array_equal(ttrace.numpy(), np.asarray(jtrace))
    assert_same("after run_schedule", js, ts)
    c = tkernel.COUNTS
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    assert int(np.asarray(jtrace)[:, 1].max()) > 100


def test_run_schedule_without_proposals_and_empty():
    """run_schedule with prop_count=0 steps without the fused propose (the
    JAX package's), and a zero-tick schedule returns the state and an
    empty [0, 3] trace."""
    jcfg, tcfg = configs(**STORM, active_rows=8)
    T = 40
    drop = np.zeros((T, 16, 16), bool)
    alive = np.ones((T, 16), bool)
    js, jtrace = jrun.run_schedule(jstate.init_state(jcfg), jcfg,
                                   jnp.asarray(drop), jnp.asarray(alive))
    ts, ttrace = trun.run_schedule(tstate.init_state(tcfg, device=CPU), tcfg,
                                   t_bool(drop), t_bool(alive), device=CPU)
    np.testing.assert_array_equal(ttrace.numpy(), np.asarray(jtrace))
    assert_same("no proposals", js, ts)
    ts2, empty = trun.run_schedule(ts, tcfg, t_bool(drop[:0]),
                                   t_bool(alive[:0]), device=CPU)
    assert ts2 is ts and tuple(empty.shape) == (0, 3)


def test_pcount_banded_equals_one_pass():
    """_pcount's band-by-band sum equals the one-pass count (integer sums
    commute), for a predicate straddling the band boundaries."""
    cfg = tstate.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                           max_props=64, keep=32, peer_chunk=8)
    g = torch.Generator().manual_seed(3)
    m = torch.randint(0, 50, (32, 32), generator=g, dtype=torch.int32)
    mid = torch.randint(0, 50, (32,), generator=g, dtype=torch.int32)

    def band(j0, w):
        return m[:, j0:j0 + w] >= mid[:, None]

    one = tkernel._pcount(cfg, band, banded=False)
    assert torch.equal(tkernel._pcount(cfg, band, banded=True), one)
    assert torch.equal(one, (m >= mid[:, None]).sum(1, dtype=torch.int32))
