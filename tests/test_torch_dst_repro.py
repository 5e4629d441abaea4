"""The port's DST repro pipeline against the JAX package's: shrink (the
shrunk arrays and `evals`, from speculative batches that start where
their candidates leave the accepted schedule), capture_flight (the
decoded event window and telemetry), artifacts loaded and replayed across
both packages, and from_fault_plan.  All compared values are integers or
bools: exact equality.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.metrics import catalog as jcatalog
from swarmkit_tpu.metrics.registry import MetricsRegistry as JRegistry
from swarmkit_tpu.raft import faults as jfaults
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.metrics import catalog as tcatalog
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.raft import faults as tfaults

from tests.test_torch_dst import CPU, DST5, SWEEP, both_explore, configs


@pytest.mark.parametrize("mutation,profiles", [
    ("commit_no_quorum", "PROFILES"),
    ("stale_lease_read", "EXTRA_PROFILES"),
])
def test_shrink_equals_jax_with_speculative_batches(mutation, profiles):
    jcfg, tcfg = configs(SWEEP)
    jres, tres, jb, tb, _ = both_explore(tuple(SWEEP.items()),
                                         getattr(jdst, profiles), mutation)
    s = int(jres.violating[0])
    viol = int(jres.viol[s])
    jreg, treg = JRegistry(), MetricsRegistry()
    jsmall, jevals = jdst.shrink(jcfg, jb.slice(s), viol, 2, mutation,
                                 obs=jreg)
    info = {}
    tsmall, tevals = tdst.shrink(tcfg, tb.slice(s), viol, 2, mutation,
                                 obs=treg, device=CPU, info=info)
    assert tevals == jevals
    # every evaluated candidate was replayed or failed on the shared prefix,
    # and the batches skipped the ticks their candidates share with it
    assert info["replayed"] + info["settled"] >= tevals
    assert info["batches"] < tevals
    assert info["ticks"] < info["batches"] * tb.ticks
    for k, v in tsmall.to_numpy().items():
        assert np.array_equal(np.asarray(getattr(jsmall, k)), v), k
    fam = "swarm_dst_shrink_rounds_total"
    assert tcatalog.get(treg, fam).snapshot() \
        == jcatalog.get(jreg, fam).snapshot()
    want = jdst.replay(jcfg, jsmall, 2, mutation)
    assert tdst.replay(tcfg, tsmall, 2, mutation, device=CPU) == want


def test_artifacts_cross_load_both_ways(tmp_path):
    jcfg, tcfg = configs(SWEEP)
    jres, tres, jb, tb, names = both_explore(
        tuple(SWEEP.items()), jdst.PROFILES, "commit_no_quorum")
    s = int(jres.violating[0])
    viol, first = int(jres.viol[s]), int(jres.first_tick[s])
    kw = dict(seed=0, profile=names[s], index=s, prop_count=2,
              mutation="commit_no_quorum", viol=viol, first_tick=first)
    jart = jdst.to_artifact(jcfg, jb.slice(s), **kw)
    tart = tdst.to_artifact(tcfg, tb.slice(s), **kw)
    assert json.loads(json.dumps(tart)) == json.loads(json.dumps(jart))
    # the port's artifact, with its flight window, replays in JAX
    flight = tdst.capture_flight(tcfg, tb.slice(s), 2, "commit_no_quorum",
                                 first_tick=first, device=CPU)
    assert flight["first_tick"] == first
    path = str(tmp_path / "port.json")
    tdst.save_artifact(path, tdst.to_artifact(tcfg, tb.slice(s), **kw,
                                              flight=flight))
    verdict = jdst.replay_artifact(jdst.load_artifact(path),
                                   with_trace=False)
    assert verdict["matches_recorded"], verdict
    # JAX's artifact, with its flight window, replays in the port
    jflight = jdst.capture_flight(jcfg, jb.slice(s), 2, "commit_no_quorum",
                                  first_tick=first)
    assert flight["violation_bits"] == jflight["violation_bits"]
    assert flight["window"] == jflight["window"]
    assert flight["telemetry"] == jflight["telemetry"]
    jpath = str(tmp_path / "jax.json")
    jdst.save_artifact(jpath, jdst.to_artifact(jcfg, jb.slice(s), **kw,
                                               flight=jflight))
    verdict = tdst.replay_artifact(jpath, device=CPU)
    assert verdict["matches_recorded"], verdict
    assert verdict["violations"] == jdst.bits_to_names(viol)
    # the oracle trace of the artifact, and of the schedule, equal JAX's
    jverdict = jdst.replay_artifact(jpath)
    assert verdict["oracle"] == jverdict["oracle"]
    assert verdict["oracle"]["diverged_at"] >= 0
    assert tdst.replay_artifact(jpath, with_trace=True,
                                device=CPU)["oracle"] == jverdict["oracle"]
    assert tdst.oracle_trace(tcfg, tb.slice(s), device=CPU) \
        == jdst.oracle_trace(jcfg, jb.slice(s))


ROWS3 = {"a": 0, "b": 1, "c": 2}


@pytest.mark.parametrize("plan", [
    jfaults.FaultPlan.down("b"),
    jfaults.FaultPlan.split(("a", "b"), ("c",)),
    jfaults.FaultPlan.delay("a", "b", 3.0, symmetric=False),
    jfaults.FaultPlan.drop("a", "c", p=0.5),
    jfaults.FaultPlan.crash("c"),
], ids=lambda p: p.name)
def test_from_fault_plan_equals_jax(plan):
    kw = dict(DST5, n=3)
    jcfg, tcfg = configs(kw)
    tplan = tfaults.FaultPlan(plan.name, plan._inject, plan._repair)
    want = jdst.from_fault_plan(jcfg, plan, ROWS3, ticks=12, inject_at=2,
                                heal_at=9, seed=4)
    got = tdst.from_fault_plan(tcfg, tplan, ROWS3, ticks=12, inject_at=2,
                               heal_at=9, seed=4, device=CPU)
    assert sorted(got.leaves()) == ["alive", "crash_campaign", "drop",
                                    "target_leader"]
    for k, v in got.to_numpy().items():
        assert np.array_equal(np.asarray(getattr(want, k)), v), k


def test_postmortem_equals_jax_captures():
    """postmortem re-runs the violating schedules alone with the recorder
    on, each stopped after its first violating tick: the decoded windows
    and verdicts equal the JAX package's captures of the same schedules."""
    jcfg, tcfg = configs(SWEEP)
    jres, tres, jb, tb, _ = both_explore(tuple(SWEEP.items()),
                                         jdst.PROFILES, "commit_no_quorum")
    caps = tdst.postmortem(tres, tcfg, tb, 2, "commit_no_quorum", limit=2,
                           device=CPU)
    assert sorted(caps) == [int(s) for s in tres.violating[:2]]
    for s, cap in caps.items():
        want = jdst.capture_flight(jcfg, jb.slice(s), 2, "commit_no_quorum",
                                   first_tick=int(jres.first_tick[s]))
        assert cap["first_tick"] == int(tres.first_tick[s])
        for k in ("violation_bits", "first_tick", "window", "dropped",
                  "telemetry"):
            assert cap[k] == want[k], k

