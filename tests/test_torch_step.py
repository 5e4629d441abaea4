"""The PyTorch port's tick against the JAX kernel: all-field bit identity.

Both packages start from the same config and state and run the same
seeded fault schedule (numpy makes every input and hands it to both).  All
raft state is integer, so the tolerance is exact equality on every field,
every tick.  The JAX side runs its default jnp path (the Pallas band copy
is pinned value-identical to it by tests/test_pallas_ops.py).
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

CPU = "cpu"


def jax_numpy(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(jstate.SimState)
            if getattr(st, f.name) is not None}


def assert_same(tag, jst, tst):
    want, got = jax_numpy(jst), tstate.state_to_numpy(tst)
    assert sorted(want) == sorted(got), f"{tag}: field sets differ"
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, f"{tag}: {name} dtype {g.dtype} != {w.dtype}"
        if not np.array_equal(g, w):
            bad = np.argwhere(g != w)[:5].tolist()
            raise AssertionError(f"{tag}: field {name} diverged at {bad}")


def configs(**kw):
    return jstate.SimConfig(**kw), tstate.SimConfig(**kw)


def t_bool(a):
    return torch.from_numpy(np.asarray(a, dtype=bool))


_jstep_fused = jax.jit(
    lambda st, cfg, alive, drop, cnt: jkernel.step(
        st, cfg, alive=alive, drop=drop, prop_count=cnt,
        payload_fn=jrun._payload_at),
    static_argnames=("cfg",))
_jstep = jax.jit(jkernel.step, static_argnames=("cfg",))
_jpropose = jax.jit(
    lambda st, cfg, cnt: jkernel.propose_dense(st, cfg, jrun._payload_at,
                                               cnt),
    static_argnames=("cfg",))


def _tstep_fused(st, cfg, alive, drop, cnt):
    return tkernel.step(st, cfg, alive=t_bool(alive), drop=t_bool(drop),
                        prop_count=cnt, payload_fn=trun._payload_at,
                        device=CPU)


class TestStepIdentity:
    @pytest.mark.parametrize("log_chunk", [128, 0])
    def test_bit_identity_under_faults(self, log_chunk):
        """The static-sync schedule of TestTiledLog: 300 ticks of crashes,
        drops, leader transfers and bursty fused proposals."""
        jcfg, tcfg = configs(n=7, log_len=1024, window=64, apply_batch=64,
                             max_props=64, keep=32, election_tick=14,
                             seed=3, static_members=True,
                             log_chunk=log_chunk)
        rng = np.random.default_rng(42)
        js = jstate.init_state(jcfg)
        ts = tstate.init_state(tcfg, device=CPU)
        for t in range(300):
            alive = rng.random(7) > 0.08
            drop = rng.random((7, 7)) < 0.05
            cnt = int(rng.integers(0, 49))
            if t % 37 == 36:
                leaders = np.flatnonzero(np.asarray(js.role) == jstate.LEADER)
                if len(leaders):
                    lid, tgt = int(leaders[0]), int(rng.integers(7))
                    js = jkernel.transfer_leadership(js, jcfg, lid, tgt)
                    ts = tkernel.transfer_leadership(ts, tcfg, lid, tgt)
                    assert_same(f"transfer t={t}", js, ts)
            js = _jstep_fused(js, jcfg, jnp.asarray(alive), jnp.asarray(drop),
                              jnp.asarray(cnt, jnp.int32))
            ts = _tstep_fused(ts, tcfg, alive, drop, cnt)
            assert_same(f"log_chunk={log_chunk} tick {t}", js, ts)
        assert int(np.asarray(js.commit).max()) > 100

    def test_forced_fallback_win_and_restore_identical(self, monkeypatch):
        """TestTiledLog's forced-fallback schedule (static members): the
        election win, a crash long enough for compaction to overtake the
        victim (its revival is a snapshot restore), then a re-election —
        so the tiled tick takes both ring-write branches, each compared."""
        jcfg, tcfg = configs(n=3, log_len=1024, window=64, apply_batch=64,
                             max_props=32, keep=32, election_tick=10, seed=5,
                             static_members=True, log_chunk=128)
        branches = {"banded": 0, "full": 0}

        def counted(fn, key):
            def wrapper(*a):
                branches[key] += 1
                return fn(*a)
            return wrapper

        # in a tiled tick these two index maps are built only by the banded
        # and the full-pass ring write respectively
        monkeypatch.setattr(tkernel, "_idx_at_band",
                            counted(tkernel._idx_at_band, "banded"))
        monkeypatch.setattr(tkernel, "_idx_at_slots",
                            counted(tkernel._idx_at_slots, "full"))
        js = jstate.init_state(jcfg)
        ts = tstate.init_state(tcfg, device=CPU)
        no_drop = np.zeros((3, 3), bool)
        all_up = np.ones(3, bool)

        def tick(alive, tag):
            nonlocal js, ts
            js = _jstep_fused(js, jcfg, jnp.asarray(alive),
                              jnp.asarray(no_drop), jnp.asarray(32, jnp.int32))
            ts = _tstep_fused(ts, tcfg, alive, no_drop, 32)
            assert_same(tag, js, ts)

        def leaders():
            return np.flatnonzero(np.asarray(js.role) == jstate.LEADER)

        for t in range(40):
            tick(all_up, f"warmup {t}")
            if len(leaders()) and t > 5:
                break
        lid = int(leaders()[0])
        victim = (lid + 1) % 3
        down = all_up.copy()
        down[victim] = False
        for t in range(45):
            tick(down, f"down {t}")
        assert int(np.asarray(js.snap_idx).max()) \
            > int(np.asarray(js.last)[victim])
        snap_before = int(np.asarray(js.snap_idx)[victim])
        for t in range(30):
            tick(all_up, f"restore {t}")
        assert int(np.asarray(js.snap_idx)[victim]) > snap_before
        lead_down = all_up.copy()
        lead_down[lid] = False
        for t in range(30):
            tick(lead_down, f"re-elect {t}")
        assert len(leaders())
        assert branches["banded"] > 0 and branches["full"] > 0, branches

    def test_propose_dense_then_step_matches_jax(self):
        """The separate propose_dense + step path (the fused propose's
        ground truth) against the JAX package's, banded and untiled."""
        for log_chunk in (128, 0):
            jcfg, tcfg = configs(n=5, log_len=1024, window=64,
                                 apply_batch=64, max_props=64, keep=32,
                                 election_tick=10, seed=1,
                                 static_members=True, log_chunk=log_chunk)
            js = jstate.init_state(jcfg)
            ts = tstate.init_state(tcfg, device=CPU)
            for t in range(60):
                js = _jpropose(js, jcfg, jnp.asarray(40, jnp.int32))
                ts = tkernel.propose_dense(ts, tcfg, trun._payload_at, 40,
                                           device=CPU)
                assert_same(f"propose t={t}", js, ts)
                js = _jstep(js, jcfg)
                ts = tkernel.step(ts, tcfg, device=CPU)
                assert_same(f"step t={t}", js, ts)
            assert int(np.asarray(js.commit).max()) > 40


class TestRunLoops:
    def test_run_until_leader_and_run_ticks_trace(self):
        """run_until_leader takes the same tick count, and run_ticks under
        crashes and 5% drops gives the same trace rows and final state, at
        n=64."""
        jcfg, tcfg = configs(n=64, log_len=1024, window=64, apply_batch=64,
                             max_props=64, keep=32, election_tick=10,
                             seed=7, static_members=True, collect_stats=True,
                             log_chunk=128, peer_chunk=0, active_rows=0)
        js, jt = jrun.run_until_leader(jstate.init_state(jcfg), jcfg,
                                       max_ticks=200)
        ts, tt = trun.run_until_leader(tstate.init_state(tcfg, device=CPU),
                                       tcfg, max_ticks=200, device=CPU)
        assert int(jt) == tt > 0
        assert_same("elected", js, ts)
        kw = dict(prop_count=32, drop_rate=0.05, crash_every=50, down_for=8)
        js, jtrace = jrun.run_ticks(js, jcfg, 200, **kw)
        ts, ttrace = trun.run_ticks(ts, tcfg, 200, device=CPU, **kw)
        np.testing.assert_array_equal(ttrace.numpy(), np.asarray(jtrace))
        assert_same("after run_ticks", js, ts)
        assert int(trun.committed_entries(ts)) > 1000
        applied, chk = trun.quorum_applied_checksum(ts)
        seen = {}
        for a, c in zip(applied.tolist(), chk.tolist()):
            assert seen.setdefault(a, c) == c
