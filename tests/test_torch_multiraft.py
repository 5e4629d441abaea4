"""The port's multi-raft serving plane (swarmkit_tpu_torch/multiraft/)
against the JAX package's: the grouped tick, the router, the observability
and the DST drive.

The same inputs go through both packages and must give the same bits on
every SimState field (all raft state is integer: exact equality):
`run_group_ticks`, `Router.flush` (per-group payloads, spills, reads),
the batched host `propose` / `submit_reads` against `jax.vmap`, and
`run_groups_under_schedule` on the sync and mailbox wires.  Also: G=1 is
the single-group program (its non-view aten ops are `step`'s, op for op),
the stagger and broadcast of `init_groups`, the router's key hash across
processes, grouped telemetry off and on, `MultiRaftObs`, and `KernelObs` /
`sync_point` on a grouped state.  Group placement over a mesh (a fleet
sharded over several devices) is tests/test_torch_parallel.py's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from swarmkit_tpu import multiraft as jmr
from swarmkit_tpu.dst.schedule import FaultSchedule as JFaultSchedule
from swarmkit_tpu.metrics.registry import MetricsRegistry as JRegistry
from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu.telemetry import obs as jtobs
from swarmkit_tpu_torch import multiraft as tmr
from swarmkit_tpu_torch.dst.schedule import FaultSchedule
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.telemetry import obs as ttobs

from tests.test_torch_step import assert_same, jax_numpy

CPU = "cpu"
KW = dict(n=5, log_len=96, window=16, apply_batch=16, max_props=8, keep=8,
          seed=7, election_tick=10, collect_stats=True, read_batch=4,
          read_leases=True)
MAILBOX = dict(KW, latency=1, latency_jitter=1, inflight=2)
TEL = dict(KW, collect_telemetry=True, telemetry_prop_ring=64)


def cfgs(kw):
    return jstate.SimConfig(**kw), tstate.SimConfig(**kw)


def to_port(jst):
    return tstate.state_from_numpy(jax_numpy(jst), device=CPU)


def clone(tst):
    """The port's tick writes its rings in place: a state used twice is
    copied first (JAX's states are values)."""
    return tstate.state_from_numpy(tstate.state_to_numpy(tst), device=CPU)


@functools.lru_cache(maxsize=None)
def _jax_elected4():
    jcfg = jstate.SimConfig(**KW)
    js, _ = jmr.run_group_ticks(jmr.init_groups(jcfg, 4), jcfg, 60,
                                prop_count=1)
    return js


@pytest.fixture
def elected4():
    """G=4 fleet with every group led: JAX's and the port's (which must
    be equal), the port's a fresh copy per test."""
    js = _jax_elected4()
    tcfg = tstate.SimConfig(**KW)
    ts, trace = tmr.run_group_ticks(tmr.init_groups(tcfg, 4, device=CPU),
                                    tcfg, 60, prop_count=1, device=CPU)
    assert_same("elected4", js, ts)
    assert int(tmr.groups_with_leader(ts)) == 4
    return js, ts


# ---------------------------------------------------------------------------
# G=1: the single-group program


class _Ops(TorchDispatchMode):
    """The aten ops dispatched, by name, views apart (they launch
    nothing)."""

    def __init__(self):
        super().__init__()
        self.ops, self.views = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        (self.views if func.is_view else self.ops).append(str(func))
        return func(*args, **(kwargs or {}))


def test_g1_is_the_single_group_program():
    """Over 120 ticks with the fused propose, reads and stats, the
    squeezed G=1 run equals run_ticks on every field (and JAX's grouped
    run); a G=1 step_groups dispatches exactly `step`'s non-view ops, op
    for op, and only views besides."""
    jcfg, tcfg = cfgs(KW)
    single, _ = trun.run_ticks(tstate.init_state(tcfg, device=CPU), tcfg,
                               120, prop_count=2, device=CPU)
    grouped, trace = tmr.run_group_ticks(
        tmr.init_groups(tcfg, 1, device=CPU), tcfg, 120, prop_count=2,
        device=CPU)
    want, got = tstate.state_to_numpy(single), tstate.state_to_numpy(
        tmr.slice_group(grouped, 0))
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    jg, jtrace = jmr.run_group_ticks(jmr.init_groups(jcfg, 1), jcfg, 120,
                                     prop_count=2)
    assert_same("G=1 grouped", jg, grouped)
    assert np.array_equal(trace.numpy(), np.asarray(jtrace))
    assert trace.dtype == torch.int32 and int(trace[-1, 0]) == 1
    assert int(tmr.aggregate_committed(grouped)) > 0
    assert int(tmr.aggregate_reads_served(grouped)) > 0

    a, b = _Ops(), _Ops()
    one = clone(single)
    with a:
        tkernel.step(one, tcfg, prop_count=2, payload_fn=trun._payload_at,
                     device=CPU)
    g1 = tstate.broadcast_state(clone(single), 1)
    with b:
        tmr.step_groups(g1, tcfg, prop_count=2, payload_fn=trun._payload_at,
                        device=CPU)
    assert a.ops == b.ops and len(a.ops) > 1000
    assert len(b.views) > len(a.views)


# ---------------------------------------------------------------------------
# init_groups


def test_init_groups_stagger_and_broadcast():
    jcfg, tcfg = cfgs(KW)
    for groups, stagger in ((8, True), (3, False), (1, True)):
        want = jmr.init_groups(jcfg, groups, stagger=stagger)
        got = tmr.init_groups(tcfg, groups, stagger=stagger, device=CPU)
        assert_same(f"G={groups} stagger={stagger}", want, got)
    g = tmr.init_groups(tcfg, 8, device=CPU)
    one = tstate.state_to_numpy(tstate.init_state(tcfg, device=CPU))
    g0 = tstate.state_to_numpy(tmr.slice_group(g, 0))
    assert all(np.array_equal(g0[k], v) for k, v in one.items())
    tmo = g.timeout.numpy()
    assert len({tuple(r) for r in tmo}) > 1
    assert (tmo >= tcfg.election_tick).all()
    assert (tmo < 2 * tcfg.election_tick).all()
    flat = tmr.init_groups(tcfg, 3, stagger=False, device=CPU).timeout
    assert bool((flat == flat[0]).all())


# ---------------------------------------------------------------------------
# router


def test_router_hash_is_stable_across_processes_and_equals_jax():
    keys = ["user/1", "user/2", b"\x00\xffraw", 1234567, -5]
    here = [tmr.group_of_key(k, 64, seed=3) for k in keys]
    assert here == [jmr.group_of_key(k, 64, seed=3) for k in keys]
    code = ("from swarmkit_tpu_torch.multiraft import group_of_key;"
            "ks=['user/1','user/2',b'\\x00\\xffraw',1234567,-5];"
            "print([group_of_key(k,64,seed=3) for k in ks])")
    env = dict(os.environ, PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert eval(out.stdout.strip()) == here
    groups = {tmr.group_of_key(f"k{i}", 16) for i in range(200)}
    assert len(groups) == 16
    moved = sum(tmr.group_of_key(f"k{i}", 16)
                != tmr.group_of_key(f"k{i}", 16, seed=9) for i in range(200))
    assert moved > 100


def test_router_flush_equals_jax(elected4):
    """Per-group payloads past max_props (spills over 12 flushes) and
    reads: every field equal to JAX's Router after every flush, then the
    drained fleet commits them all."""
    js, ts = elected4
    jcfg, tcfg = cfgs(KW)
    base = int(tmr.aggregate_committed(ts))
    reads0 = int(tmr.aggregate_reads_served(ts))
    jr, tr = jmr.Router(jcfg, 4, seed=1), tmr.Router(tcfg, 4, seed=1,
                                                     device=CPU)
    offered = 10 * tcfg.max_props
    for i in range(offered):
        assert tr.offer(f"key/{i}", payload=i + 1) \
            == jr.offer(f"key/{i}", payload=i + 1)
    tr.offer_read("hot/key", count=6)
    jr.offer_read("hot/key", count=6)
    assert tr.pending() == jr.pending() == (offered, 6)
    for f in range(12):
        js, ts = jr.flush(js), tr.flush(ts)
        assert_same(f"flush {f}", js, ts)
        assert tr.pending() == jr.pending()
    assert tr.pending() == (0, 0) and tr.spilled == jr.spilled > 0
    assert tr.routed == offered + 6
    assert np.array_equal(tr.spilled_by_group, jr.spilled_by_group)
    ts, _ = tmr.run_group_ticks(ts, tcfg, 60, prop_count=1, device=CPU)
    assert int(tmr.aggregate_committed(ts)) >= base + offered
    assert int(tmr.aggregate_reads_served(ts)) > reads0


def test_batched_propose_and_submit_reads_equal_jax_vmap(elected4):
    """The host APIs on a [G] state: per-group payload rows and counts
    (0 to max_props) equal jax.vmap(propose); per-group read counts equal
    jax.vmap(submit_reads); then a tick on top."""
    js, ts = elected4
    jcfg, tcfg = cfgs(TEL)
    # carry the elected fleet into the telemetry config, so the batch
    # stamps are per cluster too
    jt = jstate.init_state(jcfg)
    extra = {f.name: jnp.broadcast_to(getattr(jt, f.name),
                                      (4,) + getattr(jt, f.name).shape)
             for f in dataclasses.fields(jt)
             if f.name.startswith("tel_")
             and getattr(jt, f.name) is not None}
    js = dataclasses.replace(js, **extra)
    ts = to_port(js)
    rng = np.random.default_rng(3)
    vprop = jax.jit(jax.vmap(lambda s, p, c: jkernel.propose(s, jcfg, p, c)))
    vreads = jax.jit(jax.vmap(lambda s, c: jrun.submit_reads(s, jcfg, c)))
    for r in range(3):
        pl = rng.integers(0, 2 ** 32, (4, tcfg.max_props), dtype=np.uint64) \
            .astype(np.uint32)
        cnt = rng.integers(0, tcfg.max_props + 1, 4).astype(np.int32)
        js = vprop(js, jnp.asarray(pl), jnp.asarray(cnt))
        ts = tkernel.propose(ts, tcfg, pl, cnt, device=CPU)
        assert_same(f"propose {r}", js, ts)
        rc = rng.integers(1, 9, 4).astype(np.int32)
        js = vreads(js, jnp.asarray(rc))
        ts = trun.submit_reads(ts, tcfg, torch.from_numpy(rc), device=CPU)
        assert_same(f"submit_reads {r}", js, ts)
        js = jmr.step_groups(js, jcfg)
        ts = tmr.step_groups(ts, tcfg, device=CPU)
        assert_same(f"tick {r}", js, ts)


def test_per_group_fused_counts_equal_jax(elected4):
    """step_groups with a [G] prop_count: each group its own fused count,
    as JAX's vmap over the counts."""
    js, ts = elected4
    jcfg, tcfg = cfgs(KW)
    pc = np.array([0, 3, 8, 1], np.int32)
    for t in range(6):
        js = jmr.step_groups(js, jcfg, prop_count=jnp.asarray(pc),
                             payload_fn=jrun._payload_at)
        ts = tmr.step_groups(ts, tcfg, prop_count=pc,
                             payload_fn=trun._payload_at, device=CPU)
        assert_same(f"tick {t}", js, ts)
        pc = np.roll(pc, 1)
    # G=1 with a [1] device count runs the single-group tick on a 0-d
    # device count: the int count's result
    one = tmr.slice_group(ts, 2)
    a = tmr.step_groups(tstate.broadcast_state(one, 1), tcfg,
                        prop_count=torch.tensor([5], dtype=torch.int32),
                        payload_fn=trun._payload_at, device=CPU)
    b = tmr.step_groups(tstate.broadcast_state(one, 1), tcfg, prop_count=5,
                        payload_fn=trun._payload_at, device=CPU)
    want, got = tstate.state_to_numpy(b), tstate.state_to_numpy(a)
    assert all(np.array_equal(got[k], v) for k, v in want.items())
    assert int(a.last.amax()) > int(one.last.amax())


# ---------------------------------------------------------------------------
# group isolation under the DST adversary, against JAX


def _fault_free(groups, ticks, n):
    return dict(drop=np.zeros((groups, ticks, n, n), bool),
                alive=np.ones((groups, ticks, n), bool),
                target_leader=np.zeros((groups, ticks), bool),
                crash_campaign=np.zeros((groups, ticks), bool))


def _isolation_schedule(groups, ticks, n, victim):
    """Crash rows, isolate leaders, and drop edges, in `victim` only."""
    s = _fault_free(groups, ticks, n)
    s["alive"][victim, 50:120, 0] = False
    s["target_leader"][victim, 150:200] = True
    s["drop"][victim, 220:260, 1, 2] = True
    s["drop"][victim, 220:260, 2, 1] = True
    s["crash_campaign"][victim, 260:280] = True
    return s


@pytest.mark.parametrize("wire", ["sync", "mailbox"])
def test_group_isolation_equals_jax(wire):
    jcfg, tcfg = cfgs(KW if wire == "sync" else MAILBOX)
    groups, ticks, victim = 4, 300, 1
    g0 = tmr.init_groups(tcfg, groups, device=CPU)
    jg0 = jmr.init_groups(jcfg, groups)
    runs = {}
    for name, arrs in (("quiet", _fault_free(groups, ticks, tcfg.n)),
                       ("faulty", _isolation_schedule(groups, ticks, tcfg.n,
                                                      victim))):
        jsched = JFaultSchedule(**{k: jnp.asarray(v)
                                   for k, v in arrs.items()})
        jfin, jviol, jfirst = jmr.run_groups_under_schedule(
            jg0, jcfg, jsched, prop_count=2)
        tkernel.reset_counts()
        fin, viol, first = tmr.run_groups_under_schedule(
            clone(g0), tcfg, FaultSchedule.from_numpy(arrs, device=CPU),
            prop_count=2, device=CPU)
        assert tkernel.COUNTS["host_syncs"] == 0
        assert_same(name, jfin, fin)
        assert np.array_equal(viol.numpy().view(np.uint32),
                              np.asarray(jviol))
        assert np.array_equal(first.numpy(), np.asarray(jfirst))
        assert not int((viol != 0).sum())
        runs[name] = tstate.state_to_numpy(fin)
    for g in range(groups):
        same = all(np.array_equal(runs["quiet"][k][g], runs["faulty"][k][g])
                   for k in runs["quiet"])
        assert same == (g != victim), g
    assert runs["faulty"]["commit"].max() > 0


# ---------------------------------------------------------------------------
# grouped telemetry


def test_grouped_telemetry_equals_jax_and_observes_only():
    """Telemetry on adds the tel_* fields and changes nothing else; the
    grouped run equals JAX's on every field, and summarize_groups equals
    JAX's per group."""
    jcfg, tcfg = cfgs(TEL)
    bare = tstate.SimConfig(**KW)
    base, _ = tmr.run_group_ticks(tmr.init_groups(bare, 3, device=CPU),
                                  bare, 120, prop_count=2, device=CPU)
    instr, _ = tmr.run_group_ticks(tmr.init_groups(tcfg, 3, device=CPU),
                                   tcfg, 120, prop_count=2, device=CPU)
    a, b = tstate.state_to_numpy(base), tstate.state_to_numpy(instr)
    extra = set(b) - set(a)
    assert extra and all(k.startswith("tel_") for k in extra)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert b["tel_commit_hist"].sum() > 0
    jg, _ = jmr.run_group_ticks(jmr.init_groups(jcfg, 3), jcfg, 120,
                                prop_count=2)
    assert_same("telemetry on", jg, instr)
    assert ttobs.summarize_groups(instr, tcfg) \
        == jtobs.summarize_groups(jg, jcfg)
    assert ttobs.summarize_groups(base, bare) == [{"enabled": False}] * 3


def test_grouped_telemetry_per_group_equals_single_group():
    """Without stagger every group runs the single-group program: each
    group's state (histograms included) equals run_ticks', and G=1 with
    telemetry on equals it too."""
    tcfg = tstate.SimConfig(**TEL)
    single, _ = trun.run_ticks(tstate.init_state(tcfg, device=CPU), tcfg,
                               100, prop_count=2, device=CPU)
    want = tstate.state_to_numpy(single)
    assert want["tel_commit_hist"].sum() > 0
    for groups in (3, 1):
        grouped, _ = tmr.run_group_ticks(
            tmr.init_groups(tcfg, groups, stagger=False, device=CPU), tcfg,
            100, prop_count=2, device=CPU)
        got = tstate.state_to_numpy(grouped)
        for g in range(groups):
            for k, v in want.items():
                assert np.array_equal(got[k][g], v), (groups, g, k)


# ---------------------------------------------------------------------------
# observability


def test_multiraft_obs_equals_jax_and_counts_leader_changes(elected4):
    js, ts = elected4
    jreg, treg = JRegistry(), MetricsRegistry()
    jobs, tobs = jmr.MultiRaftObs(registry=jreg), \
        tmr.MultiRaftObs(registry=treg)
    out = tobs.publish(ts)
    assert out == jobs.publish(js)
    assert out["groups"] == 4 and out["groups_with_leader"] == 4
    assert out["leader_changes"] == 0 and out["committed_entries"] > 0
    name = "swarm_multiraft_committed_entries_total"
    committed = treg.counter(name, "x").snapshot()
    assert committed == out["committed_entries"]
    again = tobs.publish(ts)                    # same state: adds nothing
    assert again["leader_changes"] == 0
    assert treg.counter(name, "x").snapshot() == committed
    moved = np.asarray(tobs._last_leaders).copy()
    moved[2] = (moved[2] + 1) % KW["n"]
    tobs._last_leaders = moved
    assert tobs.publish(ts)["leader_changes"] == 1
    assert treg.counter("swarm_multiraft_leader_changes_total",
                        "x").snapshot() == 1.0
    r = tmr.Router(tstate.SimConfig(**KW), 8, obs=tobs, device=CPU)
    for i in range(20):
        r.offer(i, payload=i)
    fam = treg.counter("swarm_multiraft_router_keys_total", "x",
                       labels=("outcome",))
    assert fam.labels(outcome="routed").value == 20.0


def test_multiraft_obs_per_group_latency_and_heat_equal_jax():
    """With telemetry on, the per-group p50/p99 gauges and the heat
    ranking publish the JAX package's values."""
    jcfg, tcfg = cfgs(TEL)
    js, _ = jmr.run_group_ticks(jmr.init_groups(jcfg, 3), jcfg, 120,
                                prop_count=2)
    ts = to_port(js)
    jreg, treg = JRegistry(), MetricsRegistry()
    jobs, tobs = jmr.MultiRaftObs(registry=jreg), \
        tmr.MultiRaftObs(registry=treg)
    jr, tr = jmr.Router(jcfg, 3), tmr.Router(tcfg, 3, device=CPU)
    for i in range(40):
        jr.offer(f"k{i}", i)
        tr.offer(f"k{i}", i)
    assert tobs.publish(ts, router=tr) == jobs.publish(js, router=jr)
    js, ts = jr.flush(js), tr.flush(ts)
    assert tobs.publish(ts, router=tr) == jobs.publish(js, router=jr)
    for fam in ("swarm_multiraft_group_commit_latency_ticks",
                "swarm_multiraft_group_heat"):
        assert treg.snapshot()[fam] == jreg.snapshot()[fam]
        assert treg.snapshot()[fam]
    assert tobs.hottest_groups() == jobs.hottest_groups()


def test_kernel_obs_and_sync_point_on_grouped_state(elected4):
    """KernelObs.publish sums a [G, 4] stats table into one fleet-wide
    delta, as JAX's does; sync_point reads the [G] tick vector."""
    js, ts = elected4
    treg = MetricsRegistry()
    out = trun.KernelObs(obs=treg).publish(ts)
    assert out == jrun.KernelObs(obs=JRegistry()).publish(js)
    per_group = ts.stats.numpy()
    assert per_group.shape == (4, 4)
    assert out["commit_advance"] == int(per_group[:, 2].sum())
    assert out["elections_won"] == int(per_group[:, 1].sum()) >= 4

    class Clock:
        def add(self, tick):
            self.saw = tick
    c = Clock()
    assert trun.sync_point(c, ts) == 60 and c.saw == 60
