"""The host half of the port's fault_sweep (swarmkit_tpu_torch/tools/
fault_sweep.py) against the JAX package's tools/fault_sweep.py, on the CPU.

Both tools drive the same robustness schedule on a 3-node cluster of each
package's raft Node.  With a FakeClock and a seeded Network, the inproc
rows are JAX's word for word (leader moved X -> Y, removed member Z,
campaigns a -> b).  The devmesh rows are too: the port's DeviceMeshNet
draws its keep masks as JAX's does, so the same seed gives the same
elections.  The grpc rows run on real sockets and the system clock; they
must all pass, and their notes name the ports they bound.
"""

from __future__ import annotations

import functools

import pytest
import torch

from swarmkit_tpu.flightrec import record as jrecord
from swarmkit_tpu_torch.tools import fault_sweep as fs
from tools import fault_sweep as jfs

from tests.torch_port_copies import free_port

CPU = "cpu"
KEYS = ("wire", "plan", "seed", "ok", "notes")


@functools.lru_cache(maxsize=None)
def _jax_rows(wire: str, plans: tuple) -> tuple:
    return tuple(jfs.run_sweep(wires=(wire,), plans=plans, verbose=False))


def _same_rows(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in KEYS} == {k: w[k] for k in KEYS}, (g, w)
        assert "error" not in g


def test_inproc_rows_equal_jax():
    got = fs.run_sweep(wires=("inproc",), verbose=False, device=CPU)
    _same_rows(got, _jax_rows("inproc", fs.PLANS))
    assert [r["plan"] for r in got] == list(fs.PLANS)
    assert all(r["ok"] and "leader moved" in r["notes"]
               and "removed member" in r["notes"] for r in got)
    part = next(r for r in got if r["plan"] == "partition")
    assert "campaigns 0 -> " in part["notes"]


def test_devmesh_rows_on_the_cpu_equal_jax():
    """All five devmesh rows pass with the exchange on the CPU; drop (the
    keep-mask draws) and partition (a campaign) equal JAX's notes."""
    stats = {}
    got = fs.run_sweep(wires=("devmesh",), verbose=False, device=CPU,
                       stats=stats)
    assert [r["plan"] for r in got] == list(fs.PLANS)
    assert all(r["ok"] for r in got), got
    # every row exchanged through the device mailbox
    assert sorted(stats) == sorted(("devmesh", p, fs.DEFAULT_SEEDS[0])
                                   for p in fs.PLANS)
    assert all(s["messages"] >= s["flushes"] > 0 for s in stats.values())
    plans = ("drop", "partition")
    _same_rows([r for r in got if r["plan"] in plans],
               _jax_rows("devmesh", plans))


def test_grpc_rows_all_pass(monkeypatch):
    monkeypatch.setattr(fs, "_free_port", free_port)
    got = fs.run_sweep(wires=("grpc",), verbose=False, device=CPU)
    assert [r["plan"] for r in got] == list(fs.PLANS)
    assert all(r["ok"] for r in got), got
    part = next(r for r in got if r["plan"] == "partition")
    assert "campaigns 0 -> " in part["notes"]
    assert "probe flips 0 -> " in part["notes"]


def test_failed_scenario_dumps_a_record_jax_loads(monkeypatch, tmp_path,
                                                  capsys):
    """One settle step a wait: the cluster never converges, the row fails
    with JAX's error, and its flight record loads in the JAX package's
    load_record with the row's provenance."""
    monkeypatch.setattr(fs._Cluster, "MAX_STEPS", 1)
    monkeypatch.setattr(jfs._Cluster, "MAX_STEPS", 1)
    rows = fs.run_sweep(wires=("inproc",), plans=("down",), device=CPU,
                        flight_dir=str(tmp_path))
    (r,) = rows
    (want,) = jfs.run_sweep(wires=("inproc",), plans=("down",),
                            verbose=False)
    assert r["ok"] is False is want["ok"]
    assert r["error"] == want["error"] == (
        "TimeoutError: [inproc] timed out waiting for cluster convergence")
    assert r["notes"] == want["notes"]
    assert r["flight"] == str(tmp_path / "fault_inproc_down_2009343.json")
    assert "FAIL inproc   down       seed=2009343" in capsys.readouterr().out
    rec = jrecord.load_record(r["flight"])
    assert rec.trigger == "scenario_failure"
    assert rec.meta == {k: r.get(k) for k in
                        ("wire", "plan", "seed", "error", "notes")}
    assert rec.events == [] and rec.n == 0


def test_cli_runs_the_inproc_wire(capsys):
    assert fs.main(["--wires", "inproc", "--device", CPU]) == 0
    out = capsys.readouterr().out
    for plan in fs.PLANS:
        assert f"ok   inproc   {plan}" in out
    assert "5/5 scenarios passed" in out


def test_devmesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: fs.run_sweep(wires=("devmesh",), verbose=False),
                 lambda: fs.main(["--wires", "devmesh"]),
                 lambda: fs.main(["--wires", "inproc"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
