"""The port's fleet health plane against the JAX package's: the heat
tracker, the SLO specs and burn-rate engine (host modules, copied), the
FleetSource readings off a grouped state, and the end-to-end alert demo.

The host modules take the same synthetic readings in both packages and
must give the same heat, states, alert records and scrape pages.
FleetSource reads a port fleet carried from JAX's (every field equal) and
must give JAX's readings.  The end-to-end demo degrades one group of a
port fleet under the DST adversary and checks JAX's acceptance bar, then
holds its alert trail equal to the JAX package's run of the same demo.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarmkit_tpu import multiraft as jmr
from swarmkit_tpu import slo as jslo
from swarmkit_tpu.dst.schedule import FaultSchedule as JFaultSchedule
from swarmkit_tpu.metrics.registry import MetricsRegistry as JRegistry
from swarmkit_tpu.multiraft import heat as jheat
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import multiraft as tmr
from swarmkit_tpu_torch import slo as tslo
from swarmkit_tpu_torch.dst.schedule import FaultSchedule
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.multiraft import heat as theat
from swarmkit_tpu_torch.multiraft.heat import SPILL_WEIGHT, HeatTracker
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.slo import SLO_CATALOG, FleetSource, SloEngine, SloSpec
from swarmkit_tpu_torch.slo.engine import GROUP_LABEL_CAP

from tests.test_torch_step import assert_same, jax_numpy

CPU = "cpu"


# ---------------------------------------------------------------------------
# HeatTracker


def _heat_run(mod, groups, alpha, steps):
    h = mod.HeatTracker(groups, alpha=alpha)
    out = [h.update(*[np.array(a) for a in s]).tolist() for s in steps]
    return out, h.hottest_groups(), h.hottest_groups(2)


@pytest.mark.parametrize("groups,alpha,steps", [
    (3, 0.5, [([100, 200, 300],)]),
    (2, 0.5, [([0, 0],), ([10, 40],), ([20, 40],)]),
    (2, 1.0, [([0, 0], [0, 0]), ([8, 2], [0, 2])]),
    (1, 1.0, [([100],), ([3],)]),
    (4, 1.0, [([0, 0, 0, 0],), ([5, 9, 5, 1],)]),
], ids=["baseline", "ewma", "spills", "rebaseline", "ties"])
def test_heat_equals_jax(groups, alpha, steps):
    got = _heat_run(theat, groups, alpha, steps)
    assert got == _heat_run(jheat, groups, alpha, steps)
    heats = got[0]
    if len(steps) == 1:
        assert heats[0] == [0.0] * groups        # first scrape: baseline
    if groups == 2 and alpha == 0.5:
        assert heats[1:] == [[5.0, 20.0], [7.5, 10.0]]
    if groups == 2 and alpha == 1.0:
        assert heats[1][1] == 2 + SPILL_WEIGHT * 2 > heats[1][0]
    if groups == 1:
        assert heats[1] == [3.0]
    if groups == 4:
        assert got[1:] == ([1, 0, 2, 3], [1, 0])


def test_heat_validation():
    with pytest.raises(ValueError):
        HeatTracker(2, alpha=0.0)
    with pytest.raises(ValueError):
        HeatTracker(2).update(np.zeros(3))


# ---------------------------------------------------------------------------
# SloSpec / catalog


def test_slo_spec_validation_and_catalog():
    for kw in (dict(budget=0.0),
               dict(budget=0.1, fast_window=5, slow_window=3),
               dict(budget=0.1, warn_burn=4.0, page_burn=2.0),
               dict(budget=0.1, clear_scrapes=0)):
        with pytest.raises(ValueError):
            SloSpec("x", "d", **kw)
    assert [dataclasses.astuple(s) for s in SLO_CATALOG] \
        == [dataclasses.astuple(s) for s in jslo.SLO_CATALOG]
    for spec in SLO_CATALOG:        # every page is reachable
        assert 1.0 / spec.budget > spec.page_burn, spec.name


# ---------------------------------------------------------------------------
# SloEngine on synthetic readings, in both packages


def _spec(mod, **kw):
    kw.setdefault("budget", 0.1)
    kw.setdefault("fast_window", 2)
    kw.setdefault("slow_window", 4)
    kw.setdefault("warn_burn", 2.0)
    kw.setdefault("page_burn", 6.0)
    kw.setdefault("clear_scrapes", 2)
    return mod.SloSpec("t", "test objective", **kw)


def _r(bad, total=1.0):
    return np.array([[bad, total]], np.float64)


def _drive(mod, reg_cls, spec_kw, seq, extra=()):
    """Feed `seq` ({slo: reading} per scrape) to a fresh engine; returns
    (fired per scrape, states per scrape, alert records, active, page)."""
    reg = reg_cls(strict=True)
    specs = (_spec(mod, **spec_kw),) + tuple(
        dataclasses.replace(_spec(mod, **spec_kw), name=n) for n in extra)
    eng = mod.SloEngine(catalog=specs, registry=reg)
    fired, states = [], []
    for obs in seq:
        fired.append([(f["slo"], f["group"], f["from"], f["to"])
                      for f in eng.observe(obs)])
        states.append(eng.state_of("t", 0))
    return fired, states, list(eng.alerts), eng.active(), reg.snapshot()


SCENARIOS = {
    # one catastrophic scrape warns but the slow window holds the page
    "page_requires_both_windows": (
        dict(fast_window=1, slow_window=4),
        [{"t": _r(0.0)}] * 3 + [{"t": _r(1.0)}], "warn"),
    # a fleet born into an outage pages on its first scrape
    "partial_window_pages_early": ({}, [{"t": _r(1.0)}] * 2, "page"),
    "warn_between_thresholds": ({}, [{"t": _r(0.3)}] * 4, "warn"),
    # de-escalation steps down one level at a time
    "hysteresis": ({}, [{"t": _r(1.0)}] * 4 + [{"t": _r(0.0)}] * 8, "ok"),
    # an oscillating group never gets clear_scrapes calm scrapes in a row
    "flapping": (dict(fast_window=1, slow_window=2, clear_scrapes=3),
                 [{"t": _r(1.0)}] * 3
                 + [{"t": _r(0.0)}, {"t": _r(0.0)}, {"t": _r(1.0)}] * 4,
                 "page"),
    "transitions": ({}, [{"t": _r(1.0)}] * 2 + [{"t": _r(0.0)}] * 8,
                    "ok"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenarios_equal_jax(name):
    spec_kw, seq, final = SCENARIOS[name]
    got = _drive(tslo, MetricsRegistry, spec_kw, seq)
    assert got == _drive(jslo, JRegistry, spec_kw, seq)
    fired, states, alerts, _, snap = got
    assert states[-1] == final
    if name == "page_requires_both_windows":
        assert [f[3] for f in fired[-1]] == ["warn"]
    if name == "partial_window_pages_early":
        assert fired == [[("t", 0, "ok", "page")], []]
    if name == "hysteresis":
        assert "warn" in states[4:]            # never page -> ok directly
    if name == "transitions":
        assert [(r["from"], r["to"]) for r in alerts] == \
            [("ok", "page"), ("page", "warn"), ("warn", "ok")]
        trans = snap["swarm_slo_transitions_total"]
        assert trans["slo=t,group=0,state=page"] == 1
        assert trans["slo=t,group=0,state=ok"] == 1


def test_engine_active_ranks_pages_first():
    seq = [{"t": _r(0.3), "u": _r(1.0)}] * 2
    got = _drive(tslo, MetricsRegistry, {}, seq, extra=("u",))
    assert got == _drive(jslo, JRegistry, {}, seq, extra=("u",))
    assert [(a["slo"], a["state"]) for a in got[3]] == \
        [("u", "page"), ("t", "warn")]


def test_engine_rejects_unknown_slo_and_bad_shape():
    eng = SloEngine(catalog=(_spec(tslo),),
                    registry=MetricsRegistry(strict=True))
    with pytest.raises(KeyError):
        eng.observe({"bogus": _r(0.0)})
    with pytest.raises(ValueError):
        eng.observe({"t": np.zeros((2, 3))})


def test_engine_per_group_metrics_gate_on_cardinality():
    big = np.tile([[1.0, 1.0]], (GROUP_LABEL_CAP + 1, 1))
    reg = MetricsRegistry(strict=True)
    eng = SloEngine(catalog=(_spec(tslo),), registry=reg)
    for _ in range(2):
        eng.observe({"t": big})
    assert eng.state_of("t", GROUP_LABEL_CAP) == "page"
    assert reg.snapshot()["swarm_slo_state"] == {}


# ---------------------------------------------------------------------------
# FleetSource readings off a grouped state, against JAX's


KW = dict(n=5, log_len=96, window=16, apply_batch=16, max_props=8, keep=8,
          seed=7, election_tick=10, collect_stats=True, read_batch=4,
          read_leases=True, collect_telemetry=True, telemetry_prop_ring=64)


def cfgs(kw):
    return jstate.SimConfig(**kw), tstate.SimConfig(**kw)


def to_port(jst):
    return tstate.state_from_numpy(jax_numpy(jst), device=CPU)


def _same_readings(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("subsystems", ["telemetry_reads_storage", "dark"])
def test_fleet_source_readings_equal_jax(subsystems):
    """Two scrapes of a G=2 fleet (carried from JAX's run, every field
    equal) give JAX's readings; dark subsystems are absent, not zero; a
    router's spills feed spill_ratio."""
    kw = dict(KW, fsync_lag_ticks=3) if subsystems != "dark" else dict(
        KW, collect_telemetry=False, telemetry_prop_ring=0, read_batch=0,
        read_leases=False)
    jcfg, tcfg = cfgs(kw)
    js, _ = jmr.run_group_ticks(jmr.init_groups(jcfg, 2), jcfg, 40,
                                prop_count=2)
    ts, _ = tmr.run_group_ticks(tmr.init_groups(tcfg, 2, device=CPU), tcfg,
                                40, prop_count=2, device=CPU)
    assert_same("40 ticks", js, ts)
    jsrc, tsrc = jslo.FleetSource(jcfg), FleetSource(tcfg)
    jr, tr = jmr.Router(jcfg, 2), tmr.Router(tcfg, 2, device=CPU)
    first = tsrc.scrape(ts, router=tr)
    _same_readings(first, jsrc.scrape(js, router=jr))
    for i in range(64):                          # 4x the flush capacity
        jr.offer(f"k{i}", i)
        tr.offer(f"k{i}", i)
    js, ts = jr.flush(js), tr.flush(ts)
    assert_same("flush", js, ts)
    second = tsrc.scrape(ts, router=tr)
    _same_readings(second, jsrc.scrape(js, router=jr))
    if subsystems == "dark":
        assert sorted(second) == ["leader_churn", "spill_ratio"]
    else:
        assert sorted(first) == ["commit_p99", "fsync_lag",
                                 "read_block_ratio", "spill_ratio"]
        assert sorted(second) == ["commit_p99", "fsync_lag", "leader_churn",
                                  "read_block_ratio", "spill_ratio"]
        assert second["commit_p99"][:, 1].sum() > 0
    for arr in second.values():
        assert arr.shape == (2, 2) and (arr[:, 0] <= arr[:, 1]).all()
    assert second["spill_ratio"][:, 0].sum() > 0
    assert second["leader_churn"][:, 0].sum() == 0


# ---------------------------------------------------------------------------
# end to end: one degraded group pages, ranks hottest, and stays isolated


def _flood_churn_schedule(groups, ticks, n, victim):
    """Degrade ONLY `victim`: a standing append flood (the heat signal)
    plus a leader partition window late in every 25-tick chunk (the churn
    signal)."""
    s = dict(drop=np.zeros((groups, ticks, n, n), bool),
             alive=np.ones((groups, ticks, n), bool),
             target_leader=np.zeros((groups, ticks), bool),
             crash_campaign=np.zeros((groups, ticks), bool),
             append_flood=np.zeros((groups, ticks), bool))
    s["append_flood"][victim, 10:] = True
    for start in range(0, ticks, 25):
        s["target_leader"][victim, start + 8:start + 21] = True
    return s


def _chunk(arrs, t0, t1):
    return {k: v[:, t0:t1] for k, v in arrs.items()}


@functools.lru_cache(maxsize=None)
def _jax_demo(groups, victim, chunk, chunks):
    """The JAX package's run of the demo: its alert trail and heat."""
    jcfg = jstate.SimConfig(**KW)
    g, _ = jmr.run_group_ticks(jmr.init_groups(jcfg, groups), jcfg, 60)
    sched = _flood_churn_schedule(groups, chunk * chunks, jcfg.n, victim)
    reg = JRegistry(strict=True)
    obs, src = jmr.MultiRaftObs(registry=reg), jslo.FleetSource(jcfg)
    eng = jslo.SloEngine(registry=reg)
    obs.publish(g)
    eng.observe(src.scrape(g))
    for c in range(chunks):
        sl = JFaultSchedule(**{k: jnp.asarray(v) for k, v in
                               _chunk(sched, c * chunk,
                                      (c + 1) * chunk).items()})
        g, _, _ = jmr.run_groups_under_schedule(g, jcfg, sl, prop_count=2)
        obs.publish(g)
        eng.observe(src.scrape(g))
    return list(eng.alerts), obs.hottest_groups(), \
        reg.snapshot()["swarm_multiraft_group_heat"]


def test_one_degraded_group_pages_and_ranks_hottest():
    groups, victim, chunk, chunks = 4, 2, 25, 10
    tcfg = tstate.SimConfig(**KW)
    g0, _ = tmr.run_group_ticks(tmr.init_groups(tcfg, groups, device=CPU),
                                tcfg, 60, device=CPU)
    faulty_s = _flood_churn_schedule(groups, chunk * chunks, tcfg.n, victim)
    quiet_s = dict(faulty_s, target_leader=np.zeros_like(
        faulty_s["target_leader"]), append_flood=np.zeros_like(
        faulty_s["append_flood"]))
    reg = MetricsRegistry(strict=True)
    obs, src, eng = tmr.MultiRaftObs(registry=reg), FleetSource(tcfg), \
        SloEngine(registry=reg)
    obs.publish(g0)
    eng.observe(src.scrape(g0))                  # scrape 1: baselines
    faulty = g0
    quiet = tstate.state_from_numpy(tstate.state_to_numpy(g0), device=CPU)
    paged_at = None
    for c in range(chunks):
        for name, arrs in (("faulty", faulty_s), ("quiet", quiet_s)):
            sl = FaultSchedule.from_numpy(
                _chunk(arrs, c * chunk, (c + 1) * chunk), device=CPU)
            st = faulty if name == "faulty" else quiet
            st, viol, _ = tmr.run_groups_under_schedule(
                st, tcfg, sl, prop_count=2, device=CPU)
            assert not int((viol != 0).sum())
            if name == "faulty":
                faulty = st
            else:
                quiet = st
        obs.publish(faulty)
        eng.observe(src.scrape(faulty))
        if paged_at is None and any(
                a["group"] == victim and a["state"] == "page"
                for a in eng.active()):
            paged_at = c + 2                     # + the baseline scrape
    assert paged_at is not None and paged_at <= 8, list(eng.alerts)
    assert eng.state_of("leader_churn", victim) == "page"
    for a in eng.active():
        assert a["group"] == victim, f"bystander alerted: {a}"
    assert obs.hottest_groups()[0] == victim
    heat_rows = reg.snapshot()["swarm_multiraft_group_heat"]
    assert heat_rows[f"group={victim}"] == max(heat_rows.values())
    q, f = tstate.state_to_numpy(quiet), tstate.state_to_numpy(faulty)
    for g in range(groups):
        if g != victim:
            assert all(np.array_equal(q[k][g], f[k][g]) for k in q), g
    churn = [r for r in eng.alerts if r["slo"] == "leader_churn"
             and r["group"] == victim and r["to"] == "page"]
    assert churn and churn[0]["fast_burn"] >= 6.0
    # the JAX package's run of the same demo: the same trail and heat
    jalerts, jhot, jheat_rows = _jax_demo(groups, victim, chunk, chunks)
    assert list(eng.alerts) == jalerts
    assert obs.hottest_groups() == jhot and heat_rows == jheat_rows
