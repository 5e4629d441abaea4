"""The device half of the port's fault_sweep (tools/fault_sweep.py) against
the JAX package's tools/fault_sweep.py, on the CPU.

The scenario tables are JAX's; the lowering precheck gives JAX's rows (the
fault plans lower to the same schedules, and the DST tick gives the same
bits); the attack and storage pipelines pass on the port, and each trip
artifact they write replays exactly in the JAX package.  The port draws
its attack schedules from its own streams (JAX's laws, not its draws), so
the explore masks are held to JAX's on schedules JAX drew.  The host-wire
sweep's rows are held to JAX's in tests/test_torch_fault_sweep_host.py;
here its flags give skip rows in the device runs.
The full four-attack and four-storage runs and all five plans in both
lowerings are `slow`, as in tests/test_fault_sweep.py.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.tools import fault_sweep as fs
from tools import fault_sweep as jfs

from tests.test_torch_wire import one_torch_thread  # noqa: F401 (fixture)

CPU = "cpu"


def _device(rows):
    return [r for r in rows if r["wire"] == "device"]


def test_tables_are_the_jax_tools():
    for name in ("WIRES", "PLANS", "DEFAULT_SEEDS", "ATTACK_SCENARIOS",
                 "ATTACK_WIRE_SKIP", "STORAGE_SCENARIOS",
                 "STORAGE_WIRE_SKIP"):
        assert getattr(fs, name) == getattr(jfs, name), name


@functools.lru_cache(maxsize=None)
def _jax_precheck(plans, peer_chunk, active_rows):
    return jfs.run_device_precheck(plans, peer_chunk=peer_chunk,
                                   active_rows=active_rows, verbose=False)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("wire", "plan", "seed", "ok", "notes", "error"):
            assert g[k] == w[k], (k, g, w)


def test_precheck_rows_equal_jax():
    plans = ("down", "partition")
    stats = {}
    got = fs.run_device_precheck(plans, verbose=False, device=CPU,
                                 stats=stats)
    _same_rows(got, _jax_precheck(plans, 8, None))
    assert all(r["ok"] and r["notes"].endswith("lowering=banded "
                                               "== dense-peer") for r in got)
    # the stats sink holds each row's banded explore result
    assert sorted(stats) == sorted((p, s) for p in plans
                                   for s in fs.DEFAULT_SEEDS)
    for r in got:
        res = stats[(r["plan"], r["seed"])]
        assert r["notes"].startswith(f"viol=0x{int(res.viol[0]):x} ")
        assert res.bits_by_tick.shape == (60, 1)


@pytest.mark.slow
@pytest.mark.parametrize("peer_chunk,active_rows", [(8, None), (8, 8)],
                         ids=["banded", "sparse"])
def test_precheck_all_plans_both_lowerings_equal_jax(peer_chunk,
                                                     active_rows):
    got = fs.run_device_precheck(peer_chunk=peer_chunk,
                                 active_rows=active_rows, verbose=False,
                                 device=CPU)
    _same_rows(got, _jax_precheck(fs.PLANS, peer_chunk, active_rows))
    assert all(r["ok"] for r in got)


def _replays_in_jax(stats: dict) -> None:
    """Each trip artifact the port wrote replays exactly in the JAX
    package (bits and first tick)."""
    for name, st in stats.items():
        if "artifact" in st:
            verdict = jdst.replay_artifact(st["artifact"], with_trace=False)
            assert verdict["matches_recorded"], name


def test_vote_equivocation_pipeline(tmp_path):
    stats = {}
    rows = fs.run_attack_sweep(["vote_equivocation"], schedules=4,
                               out_dir=str(tmp_path), verbose=False,
                               device=CPU, stats=stats)
    dev = _device(rows)
    assert len(dev) == 1 and dev[0]["ok"], dev
    assert dev[0]["notes"].startswith("caught ")
    assert "oracle lockstep" in dev[0]["notes"]
    skips = [r for r in rows if r.get("skipped")]
    assert [r["wire"] for r in skips] == list(fs.WIRES)
    assert all(r["notes"] == f"SKIP: {fs.ATTACK_WIRE_SKIP}" for r in skips)
    st = stats["vote_equivocation"]
    assert st["diverged_at"] == -1
    assert st["faults_after"] < st["faults_before"]
    assert dev[0]["notes"].startswith(
        f"caught {st['caught']}/4 (election_safety), shrunk "
        f"{st['faults_before']}->{st['faults_after']} fault-events in "
        f"{st['shrink_evals']} replays")
    _replays_in_jax(stats)


def test_lost_tail_and_torn_write_pipelines(tmp_path):
    stats = {}
    rows = fs.run_storage_sweep(["lost_tail", "torn_write"], schedules=4,
                                out_dir=str(tmp_path), verbose=False,
                                device=CPU, stats=stats)
    dev = _device(rows)
    assert [r["plan"] for r in dev] == ["lost_tail", "torn_write"]
    assert all(r["ok"] for r in dev), dev
    assert "(violation-bounded)" in dev[0]["notes"]
    assert dev[1]["notes"].startswith("contained: 0/4 violations")
    assert stats["torn_write"]["recovery_events"] > 0
    assert stats["lost_tail"]["diverged_at"] == -1
    assert len([r for r in rows if r.get("skipped")]) == 2 * len(fs.WIRES)
    _replays_in_jax(stats)


def test_explore_masks_on_jax_drawn_attack_schedules():
    """JAX's own vote_equivocation schedules through the port's explore:
    the defense-off and defense-on masks are JAX's."""
    sc = fs.ATTACK_SCENARIOS["vote_equivocation"]
    base = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8,
                keep=4, election_tick=10, seed=7)
    jbatch, names = jdst.make_batch(
        jstate.SimConfig(**base, **sc["off"]), ticks=sc["ticks"],
        schedules=4, seed=7, profiles=("vote_equivocation",))
    tbatch = tdst.FaultSchedule.from_numpy(jbatch, device=CPU)
    for side in ("off", "on"):
        kw = dict(base, **sc[side])
        jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
        want = jdst.explore(jstate.init_state(jcfg), jcfg, jbatch,
                            profiles=names, prop_count=sc["prop_count"])
        got = tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg,
                           tbatch, profiles=names,
                           prop_count=sc["prop_count"], device=CPU)
        assert np.array_equal(got.viol, want.viol), side
        assert np.array_equal(got.first_tick, want.first_tick), side
        assert np.array_equal(got.bits_by_tick, want.bits_by_tick), side
        assert (got.violating.size > 0) == (side == "off")


@pytest.mark.slow
def test_attack_sweep_all_scenarios(tmp_path):
    stats = {}
    rows = fs.run_attack_sweep(out_dir=str(tmp_path), verbose=False,
                               device=CPU, stats=stats)
    dev = _device(rows)
    assert len(dev) == len(fs.ATTACK_SCENARIOS)
    assert len([r for r in rows if r.get("skipped")]) == \
        len(fs.ATTACK_SCENARIOS) * len(fs.WIRES)
    assert not [r for r in dev if not r["ok"]], dev
    _replays_in_jax(stats)


@pytest.mark.slow
def test_storage_sweep_all_scenarios(tmp_path):
    stats = {}
    rows = fs.run_storage_sweep(out_dir=str(tmp_path), verbose=False,
                                device=CPU, stats=stats)
    dev = _device(rows)
    assert len(dev) == len(fs.STORAGE_SCENARIOS)
    assert not [r for r in dev if not r["ok"]], dev
    _replays_in_jax(stats)


def test_cli_host_wires_and_unknown_names(capsys):
    """With no device flag the tool runs the host-wire sweep (here one
    inproc row), and every unknown name is refused."""
    assert fs.main(["--wires", "inproc", "--plans", "down",
                    "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "ok   inproc   down" in out and "1/1 scenarios passed" in out
    for argv, what in ((["--attacks", "nope"], "unknown attack 'nope'"),
                       (["--storage", "nope"],
                        "unknown storage fault 'nope'"),
                       (["--wires", "smoke", "--attacks", "all"],
                        "unknown wire 'smoke'"),
                       (["--wires", "smoke"], "unknown wire 'smoke'"),
                       (["--plans", "nope"], "unknown plan 'nope'")):
        with pytest.raises(SystemExit):
            fs.main(argv + ["--device", CPU])
        assert what in capsys.readouterr().err


def test_cli_precheck_on_the_cpu(capsys):
    """--peer-chunk runs the precheck, then the host-wire scenarios."""
    assert fs.main(["--peer-chunk", "8", "--plans", "drop",
                    "--wires", "inproc", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "ok   device(pc=8) drop" in out
    assert out.index("device(pc=8) drop") < out.index("ok   inproc   drop")
    assert "2/2 scenarios passed" in out


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: fs.run_device_precheck(("down",), verbose=False),
                 lambda: fs.run_attack_sweep(["append_flood"],
                                             verbose=False),
                 lambda: fs.run_storage_sweep(["torn_write"], verbose=False),
                 lambda: fs.main(["--peer-chunk", "8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_host_skip_rows_follow_the_wires(tmp_path):
    """The --wires list picks the skip rows (none when only the device
    half is asked for)."""
    rows = fs.run_storage_sweep(["torn_write"], schedules=2, wires=(),
                                out_dir=str(tmp_path), verbose=False,
                                device=CPU)
    assert [r["wire"] for r in rows] == ["device"]
