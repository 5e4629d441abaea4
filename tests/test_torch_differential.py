"""The port's differential gate (raft/sim/differential.py) and its fresh-seed
sweep (tools/differential_sweep.py) against the JAX package's, on the CPU.

The port's `run_differential` draws its schedule from the same numpy
stream as the JAX harness (tests/test_raft_sim_differential.py), so one
seed is one schedule in both packages: each schedule knob runs through
both, and each side holds its tick to its golden core on every field of
every tick.  The results are integers, so they must be equal.  The sweep
tool's loop, failure line, zero-commit rerun and exit code are checked on
the port alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from swarmkit_tpu.raft.sim import SimConfig as JConfig
from swarmkit_tpu_torch.raft.sim import differential, oracle
from swarmkit_tpu_torch.raft.sim.state import SimConfig as TConfig
from swarmkit_tpu_torch.tools import differential_sweep as ds

from tests.test_raft_sim_differential import CFG5, CFG7
from tests.test_raft_sim_differential import run_differential as jax_run
from tests.test_torch_wire import one_torch_thread  # noqa: F401 (fixture)

CPU = "cpu"
MB5 = dataclasses.asdict(ds.MB5)


def _port(jcfg: JConfig) -> TConfig:
    return TConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("cfg,kw", [
    (CFG5, dict(n_ticks=90, seed=101, drop_rate=0.1, crash_prob=0.05)),
    (CFG5, dict(n_ticks=120, seed=400, drop_rate=0.05,
                partition_at=(30, 70, 2))),
    (CFG5, dict(n_ticks=120, seed=300, crash_leader_every=30,
                prop_prob=0.7)),
    (CFG5, dict(n_ticks=130, seed=901, drop_rate=0.1, transfer_every=25,
                prop_prob=0.6)),
    (CFG7, dict(n_ticks=140, seed=1031, drop_rate=0.1, crash_prob=0.05,
                conf_every=20, min_members=3)),
    (CFG5, dict(n_ticks=160, seed=1150, drop_rate=0.05,
                remove_leader_every=45, prop_prob=0.6, min_members=3)),
    (CFG5, dict(n_ticks=160, seed=1110, drop_rate=0.05, conf_every=15,
                voters=range(3), prop_prob=0.7, min_members=3)),
    (JConfig(**MB5), dict(n_ticks=160, seed=5, drop_rate=0.08,
                          crash_prob=0.04, transfer_every=35)),
], ids=["drop-crash", "partition-heal", "crash-leader", "transfer",
        "conf-churn", "remove-leader", "voters-bootstrap", "mailbox"])
def test_run_differential_equals_jax(cfg, kw):
    info = {}
    got = differential.run_differential(_port(cfg), device=CPU, info=info,
                                        **kw)
    assert got == jax_run(cfg, **kw)
    assert got["max_commit"] > 0
    # one view a tick plus the initial one; the wire ticks read nothing
    assert info["ticks"] == kw["n_ticks"]
    assert info["reads"] == kw["n_ticks"] + 1
    assert info["step_syncs"] == 0


def test_kernel_view_reads_once_in_jax_dtypes():
    cfg = _port(CFG5)
    st = differential.init_state(cfg, device=CPU)
    view = differential.kernel_view(st)
    assert tuple(view) == differential.VIEW_FIELDS
    assert view["member"].dtype == bool and view["member"].shape == (5, 5)
    assert view["apply_chk"].dtype == np.uint32
    assert view["term"].dtype == np.int32


def test_perturbed_oracle_is_caught_with_the_tick_and_field(monkeypatch):
    """A golden core that disagrees at one tick fails the run there, with
    JAX's message: seed, tick, field, both sides' values, terms, roles."""
    real = oracle.OracleCluster.view
    calls = {"n": 0}

    def view(self):
        v = real(self)
        if calls["n"] == 7:
            v = dataclasses.replace(v, commit=v.commit + 1)
        calls["n"] += 1
        return v

    monkeypatch.setattr(oracle.OracleCluster, "view", view)
    with pytest.raises(AssertionError) as err:
        differential.run_differential(_port(CFG5), 20, seed=101,
                                      drop_rate=0.1, device=CPU)
    msg = str(err.value)
    assert msg.startswith("seed=101 tick=7 field=commit\n")
    for part in ("  kernel: ", "  oracle: ", "  terms k/o: ",
                 "  roles k/o: "):
        assert part in msg


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        differential.run_differential(_port(CFG5), 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.run_family("sync5-faults", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.main(["--minutes", "0.01", "--seed-base", "0"])


def test_families_are_the_jax_tools():
    from tools import differential_sweep as jds

    assert [name for name, *_ in ds.FAMILIES] == \
        [name for name, *_ in jds.FAMILIES]
    for (_, tcfg, tkw), (_, jcfg, jkw) in zip(ds.FAMILIES, jds.FAMILIES):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tkw == jkw


def test_main_runs_and_reports(capsys):
    assert ds.main(["--minutes", "0.02", "--seed-base", "0",
                    "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "DONE: " in out and " fresh-seed schedules, 0 failures" in out
    assert "per family: {'sync5-faults': 1" in out


def test_a_failing_family_prints_its_repro_and_fails(monkeypatch, capsys):
    def diverge(cfg, n_ticks, seed, **kw):
        time.sleep(0.05)   # past the deadline: one schedule runs
        raise AssertionError(f"seed={seed} tick=3 field=term")

    monkeypatch.setattr(ds, "run_differential", diverge)
    assert ds.main(["--minutes", "0.0001", "--seed-base", "12",
                    "--device", CPU]) == 1
    captured = capsys.readouterr()
    assert ("FAILURE family=sync5-faults seed=12 (repro: run_differential("
            "cfg, seed=12, **{'n_ticks': 200, 'drop_rate': 0.1, "
            "'crash_prob': 0.06})") in captured.out
    assert "AssertionError: seed=12 tick=3 field=term" in captured.err
    assert "DONE: 0 fresh-seed schedules, 1 failures" in captured.out


@pytest.mark.parametrize("commits", [[0, 5], [0, 0]],
                         ids=["commits-later", "stalled"])
def test_zero_commits_rerun_the_schedule_at_three_times(monkeypatch,
                                                        commits):
    calls = []

    def fake(cfg, n_ticks, seed, device=None, info=None, **kw):
        calls.append((cfg, n_ticks, seed, kw))
        return {"max_commit": commits[len(calls) - 1], "max_term": 2}

    monkeypatch.setattr(ds, "run_differential", fake)
    out = ds.run_family("mb5-prevote-faults", 2009343, device=CPU)
    assert [c[1] for c in calls] == [220, 660]
    assert calls[0][0] is calls[1][0] is ds.MB5
    assert calls[0][2] == calls[1][2] == 2009343
    assert calls[0][3] == calls[1][3] == dict(drop_rate=0.08,
                                              crash_prob=0.04)
    assert out["reran"] and out["n_ticks"] == 660
    assert out["ok"] == (commits[1] > 0)
    if not out["ok"]:
        assert "'n_ticks': 660" in out["repro"]


@pytest.mark.parametrize("name", [
    pytest.param(name, marks=pytest.mark.slow) if cfg.n >= 64 else name
    for name, cfg, _ in ds.FAMILIES])
def test_family_at_seed_zero(name):
    """Each family's seed-0 schedule through the sweep's own loop body on
    the port (the n=64/128 families under slow), with JAX's result."""
    from tools import differential_sweep as jds

    got = ds.run_family(name, 0, device=CPU)
    assert got["ok"], got
    jcfg, jkw = {n: (c, k) for n, c, k in jds.FAMILIES}[name]
    jkw = dict(jkw, n_ticks=got["n_ticks"])
    want = jax_run(jcfg, seed=0, **jkw)
    assert {k: got[k] for k in want} == want
