"""The port's DST sweep (swarmkit_tpu_torch/dst/) against the JAX package's.

The same inputs go through both packages and must give the same bits:
numpy-built states through the invariant checkers, one mid-run batched
state and seeded masks through effective_faults and the nine verbs, and
JAX's own make_batch schedules (carried across with
FaultSchedule.from_numpy) through explore (viol, first_tick, bits_by_tick
and every final field).  All values are integers or bools, so every
comparison is exact.  The port's generator draws its own stream (JAX's
laws, not its draws): it is checked for determinism per (seed, index),
stability across widths, and JAX's leaves, shapes and dtypes.  The repro
pipeline's parity is tests/test_torch_dst_repro.py; the storage sweep's is
tests/test_torch_dst_storage.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.dst.explore import apply_mutation
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.tools import dst_sweep

from tests.test_torch_step import jax_numpy

CPU = "cpu"
DST5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10, seed=0)
SWEEP = dict(DST5, read_batch=2)        # tools/dst_sweep.py's _cfg
# the EXTRA_PROFILES sweep: storage on (fsync every 4 ticks, gated), the
# read path, telemetry and the SLO bounds, so every verb and checker runs
EXTRA = dict(SWEEP, fsync_lag_ticks=4, ack_gating=True,
             collect_telemetry=True, slo_p99_commit_ticks=32,
             slo_leader_changes=6, slo_log_occupancy=40, slo_fsync_lag=40,
             prop_inflight_cap=24, transfer_cooldown_ticks=15)
S, T = 16, 60


def configs(kw):
    return jstate.SimConfig(**kw), tstate.SimConfig(**kw)


def assert_fields(tag, jst, tst):
    want, got = jax_numpy(jst), tstate.state_to_numpy(tst)
    assert sorted(want) == sorted(got), f"{tag}: field sets differ"
    for name, w in want.items():
        if not np.array_equal(got[name], w):
            bad = np.argwhere(got[name] != w)[:5].tolist()
            raise AssertionError(f"{tag}: field {name} diverged at {bad}")


@functools.lru_cache(maxsize=None)
def jax_batch(kw_items, profiles, seed=0):
    jcfg = jstate.SimConfig(**dict(kw_items))
    return jdst.make_batch(jcfg, ticks=T, schedules=S, seed=seed,
                           profiles=profiles)


@functools.lru_cache(maxsize=None)
def both_explore(kw_items, profiles, mutation):
    """JAX's explore and the port's on JAX's schedules."""
    jcfg, tcfg = configs(dict(kw_items))
    jb, names = jax_batch(kw_items, profiles)
    jres = jdst.explore(jstate.init_state(jcfg), jcfg, jb, profiles=names,
                        mutation=mutation)
    tb = tdst.FaultSchedule.from_numpy(jb, device=CPU)
    tres = tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, tb,
                        profiles=names, mutation=mutation, device=CPU)
    return jres, tres, jb, tb, names


# ---------------------------------------------------------------------------
# invariant checkers on hand-built states


def _arr(base, **updates):
    """dataclasses.replace with each update applied via .at[idx].set."""
    fields = {}
    for name, pairs in updates.items():
        a = getattr(base, name)
        for idx, val in pairs:
            a = a.at[idx].set(val)
        fields[name] = a
    return dataclasses.replace(base, **fields)


def _hand_built():
    """tests/test_dst.py's hand-built states (each trips its own bit, or
    none), plus states for the read, SLO and storage bits."""
    jcfg = jstate.SimConfig(**EXTRA)
    st = jstate.init_state(jcfg)
    hist = jnp.zeros((tstate.NUM_BUCKETS,), jnp.int32)
    return jcfg, [
        st,
        _arr(st, role=[(0, 2), (1, 2)], term=[(0, 5), (1, 5)]),
        _arr(st, role=[(0, 2), (1, 2)], term=[(0, 5), (1, 4)]),
        _arr(st, last=[(0, 1), (1, 1)], log_term=[((0, 0), 1), ((1, 0), 1)],
             log_data=[((0, 0), 10), ((1, 0), 11)]),
        _arr(st, last=[(0, 1), (1, 1)], log_term=[((0, 0), 1), ((1, 0), 2)],
             log_data=[((0, 0), 10), ((1, 0), 11)]),
        _arr(st, role=[(0, 2)], term=[(0, 5)], last=[(1, 3)],
             commit=[(1, 3)],
             log_term=[((1, 0), 1), ((1, 1), 1), ((1, 2), 1)]),
        _arr(st, role=[(0, 2)], term=[(0, 3), (1, 5)], last=[(1, 3)],
             commit=[(1, 3)],
             log_term=[((1, 0), 1), ((1, 1), 1), ((1, 2), 1)]),
        _arr(st, last=[(0, 2), (1, 2)], commit=[(0, 2), (1, 2)],
             applied=[(0, 2), (1, 2)], apply_chk=[(0, 7), (1, 9)]),
        _arr(st, read_srv_idx=[(2, 3)], read_srv_goal=[(2, 4)]),
        dataclasses.replace(st, tel_commit_hist=hist.at[8].set(3)),
        dataclasses.replace(st, tel_elect_hist=hist.at[0].set(7)),
        _arr(st, last=[(3, 45)]),
        _arr(st, ack_frontier=[(1, 3)], last=[(0, 2)]),
        _arr(st, last=[(4, 41)], commit=[(4, 41)]),
    ]


def test_invariant_bits_equal_jax_on_hand_built_states():
    jcfg, states = _hand_built()
    tcfg = tstate.SimConfig(**EXTRA)
    want = [int(jdst.check_state(s, jcfg)) for s in states]
    assert set(want) >= {0, jdst.ELECTION_SAFETY, jdst.LOG_MATCHING,
                         jdst.LEADER_COMPLETENESS, jdst.CHECKSUM_AGREEMENT,
                         jdst.LINEARIZABLE_READ, jdst.SLO_COMMIT_P99,
                         jdst.SLO_LEADER_CHURN, jdst.DURABILITY}
    ported = [tstate.state_from_numpy(jax_numpy(s), device=CPU)
              for s in states]
    got = [int(tdst.check_state(s, tcfg)) for s in ported]
    assert got == want
    # the same states as one batch: each cluster its own bits
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states)
    batch = tstate.state_from_numpy(jax_numpy(stacked), device=CPU)
    assert tdst.check_state(batch, tcfg).tolist() == want


def test_transition_bits_equal_jax():
    jcfg = jstate.SimConfig(**EXTRA)
    st = jstate.init_state(jcfg)
    prev = _arr(st, commit=[(0, 3)], last=[(0, 3)], dur_commit=[(1, 2)])
    cases = [(st, st, None),
             (prev, _arr(st, commit=[(0, 2)], last=[(0, 3)]), None),
             (prev, _arr(st, commit=[(0, 2)], last=[(0, 3)]),
              np.array([True, False, False, False, False])),
             (st, _arr(st, applied=[(0, 1)]), None),
             (prev, _arr(prev, dur_commit=[(1, 1)]), None)]
    for a, b, rec in cases:
        want = int(jdst.check_transition(
            a, b, None if rec is None else jnp.asarray(rec)))
        got = int(tdst.check_transition(
            tstate.state_from_numpy(jax_numpy(a), device=CPU),
            tstate.state_from_numpy(jax_numpy(b), device=CPU),
            None if rec is None else torch.from_numpy(rec)))
        assert got == want
    assert tdst.bits_to_names(tdst.ELECTION_SAFETY | tdst.DURABILITY) \
        == ["election_safety", "durability"]


# ---------------------------------------------------------------------------
# effective_faults and the nine verbs


VERBS = ("effective_faults", "apply_term_inflation", "apply_rejoin_campaign",
         "apply_vote_equivocation", "apply_transfer_abuse",
         "apply_append_flood", "apply_disk_stall", "apply_snap_corrupt",
         "apply_lost_tail", "apply_torn_write")


@functools.lru_cache(maxsize=None)
def _mid_run():
    """A mid-run batched state of the EXTRA sweep: the port's explore on
    its own schedules, carried to JAX (the verbs' input, the same on both
    sides)."""
    tcfg = tstate.SimConfig(**EXTRA)
    sched, names = tdst.make_batch(tcfg, ticks=T, schedules=S, seed=2,
                                   profiles=tdst.EXTRA_PROFILES, device=CPU)
    res = tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, sched,
                       profiles=names, device=CPU)
    d = tstate.state_to_numpy(res.final_state)
    jst = jstate.SimState(**{f.name: None if d.get(f.name) is None
                             else jnp.asarray(d[f.name])
                             for f in dataclasses.fields(jstate.SimState)})
    return jst, res.final_state


@pytest.mark.parametrize("verb", VERBS)
def test_verb_equals_jax(verb):
    jcfg, tcfg = configs(EXTRA)
    jst, _ = _mid_run()
    rng = np.random.default_rng(VERBS.index(verb))
    n = jcfg.n
    gate = rng.random((S, n)) < 0.5
    alive = rng.random((S, n)) < 0.8
    flood = rng.random(S) < 0.5

    def fresh():
        return tstate.state_from_numpy(jax_numpy(jst), device=CPU)

    t = torch.from_numpy
    if verb == "effective_faults":
        drop = rng.random((S, n, n)) < 0.2
        args = (drop, alive, flood, rng.random(S) < 0.5)
        want = jax.vmap(jdst.schedule.effective_faults)(
            jst.role, *map(jnp.asarray, args))
        got = tdst.schedule.effective_faults(fresh().role, *map(t, args))
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
        one = tdst.schedule.effective_faults(fresh().role[0],
                                    *(torch.as_tensor(a[0]) for a in args))
        for w, g in zip(want, one):
            assert np.array_equal(np.asarray(w)[0], g.numpy())
        return
    jverb, tverb = getattr(jdst, verb), getattr(tdst, verb)
    mask = flood if verb == "apply_append_flood" else gate
    if verb in ("apply_transfer_abuse", "apply_append_flood"):
        want = jax.vmap(lambda s, m, a: jverb(s, jcfg, m, a))(
            jst, jnp.asarray(mask), jnp.asarray(alive))
        got = tverb(fresh(), tcfg, t(mask), t(alive))
        one = tverb(tstate.state_from_numpy(
            {k: v[0] for k, v in jax_numpy(jst).items()}, device=CPU),
            tcfg, torch.as_tensor(mask[0]), t(alive[0]))
    else:
        want = jax.vmap(jverb)(jst, jnp.asarray(mask), jnp.asarray(alive))
        got = tverb(fresh(), t(mask), t(alive))
        one = tverb(tstate.state_from_numpy(
            {k: v[0] for k, v in jax_numpy(jst).items()}, device=CPU),
            torch.as_tensor(mask[0]), t(alive[0]))
    assert_fields(verb, want, got)
    want0 = jax.tree_util.tree_map(lambda a: a[0], want)
    assert_fields(f"{verb} unbatched", want0, one)


# ---------------------------------------------------------------------------
# explore on JAX's schedules


@pytest.mark.parametrize("mutation,profiles,kw", [
    (None, "PROFILES", SWEEP),
    ("commit_no_quorum", "PROFILES", SWEEP),
    ("stale_lease_read", "EXTRA_PROFILES", SWEEP),
], ids=["stock", "commit_no_quorum", "stale_lease_read"])
def test_explore_equals_jax(mutation, profiles, kw):
    jres, tres, *_ = both_explore(tuple(kw.items()),
                                  getattr(jdst, profiles), mutation)
    assert np.array_equal(tres.viol, jres.viol)
    assert tres.viol.dtype == np.uint32
    assert np.array_equal(tres.first_tick, jres.first_tick)
    assert np.array_equal(tres.bits_by_tick, jres.bits_by_tick)
    assert_fields("final", jres.final_state, tres.final_state)
    if mutation is None:
        assert tres.violating.size == 0
    else:
        assert tres.violating.size > 0


# ---------------------------------------------------------------------------
# the port's generator: JAX's laws, its own stream


@functools.lru_cache(maxsize=None)
def _jax_schedule(profile):
    return jdst.make_schedule(jstate.SimConfig(**DST5), ticks=40,
                              profile=profile, seed=5, index=3)


@pytest.mark.parametrize("profile", jdst.PROFILES + jdst.EXTRA_PROFILES)
def test_generator_has_jax_leaves_and_is_deterministic(profile):
    tcfg = tstate.SimConfig(**DST5)
    want = _jax_schedule(profile)
    a = tdst.make_schedule(tcfg, ticks=40, profile=profile, seed=5, index=3,
                           device=CPU)
    b = tdst.make_schedule(tcfg, ticks=40, profile=profile, seed=5, index=3,
                           device=CPU)
    jleaves = {f.name: np.asarray(getattr(want, f.name))
               for f in dataclasses.fields(want)
               if getattr(want, f.name) is not None}
    assert sorted(a.leaves()) == sorted(jleaves)
    for k, v in a.to_numpy().items():
        assert v.shape == jleaves[k].shape and v.dtype == jleaves[k].dtype
        assert np.array_equal(v, b.to_numpy()[k])
    others = [tdst.make_schedule(tcfg, ticks=40, profile=profile, seed=s,
                                 index=i, device=CPU).to_numpy()
              for s, i in ((6, 3), (5, 4))]
    for o in others:
        assert any(not np.array_equal(v, o[k])
                   for k, v in a.to_numpy().items()), profile


def test_make_batch_is_stable_across_widths_and_promotes_leaves():
    tcfg = tstate.SimConfig(**DST5)
    profiles = ("random_drop", "append_flood", "lost_tail")
    wide, wide_names = tdst.make_batch(tcfg, ticks=16, schedules=9, seed=9,
                                       profiles=profiles, device=CPU)
    narrow, narrow_names = tdst.make_batch(tcfg, ticks=16, schedules=4,
                                           seed=9, profiles=profiles,
                                           device=CPU)
    assert wide_names[:4] == narrow_names
    for s in range(4):
        w, nn = wide.slice(s).to_numpy(), narrow.slice(s).to_numpy()
        for k in nn:
            assert np.array_equal(w[k], nn[k]), (s, k)
    # absent leaves are promoted to all-False gates of JAX's shapes
    assert wide.append_flood.shape == (9, 16)
    assert wide.lost_tail.shape == (9, 16, 5)
    assert not wide.append_flood[0].any() and not wide.lost_tail[1].any()
    one = tdst.make_schedule(tcfg, ticks=16, profile="append_flood", seed=9,
                             index=1, device=CPU).to_numpy()
    for k, v in one.items():
        assert np.array_equal(wide.slice(1).to_numpy()[k], v)
    with pytest.raises(KeyError):
        tdst.make_schedule(tcfg, ticks=8, profile="nope", seed=0, device=CPU)


# ---------------------------------------------------------------------------
# the CLI, and no silent CPU


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tstate.SimConfig(**SWEEP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdst.make_batch(tcfg, ticks=4, schedules=2, seed=0)
    sched, _ = tdst.make_batch(tcfg, ticks=4, schedules=2, seed=0,
                               device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, sched)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst_sweep.main(["--schedules", "2", "--ticks", "4"])
    with pytest.raises(KeyError):
        apply_mutation(tstate.init_state(tcfg, device=CPU), tcfg, "x")
    tkernel.reset_counts()
    res = tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, sched,
                       device=CPU)
    assert tkernel.COUNTS["host_syncs"] == 0
    assert res.bits_by_tick.shape == (4, 2)
