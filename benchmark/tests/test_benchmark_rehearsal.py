"""The CPU rehearsal: each cell's flow and the reference end to end at
n = 64 on the plain kernels, then the control and the faults that a raft
cell can have, each of which must read not correct.  No number of these
runs is a device number, and none is written as a metric."""

import types

import pytest
import torch

from conftest import rehearse

CELLS = ("n32768-append", "n4096-append", "n4096-failover", "n4096-reads")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert all(v == 0 for v, _ in res["checks"].values())
    win = res["window"]
    assert win["ticks"] > 0 and win["committed"] > 0
    if cell == "n4096-failover":
        assert win["failovers"] and res["failed"] > 0
    else:
        assert res["failed"] == 0
    if cell == "n4096-reads":
        assert win["reads"] > 0 and "reads_short" in res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell):
    res = rehearse(cell, seconds=0.5, control=True)
    assert not res["correct"]
    assert res["checks"]["minority"][0] > 0


def _broken(fault):
    """raft.sim with its run_ticks broken underneath."""
    from swarmkit_tpu_torch.raft import sim

    def run_ticks(st, cfg, n, prop_count=0, **kw):
        if fault == "unchanged":
            row = sim.run.__dict__["_trace_row"](st)
            return st, torch.stack([row] * n)
        return sim.run_ticks(st, cfg, n, prop_count=prop_count // 2, **kw)

    return types.SimpleNamespace(**{
        **{k: getattr(sim, k) for k in sim.__all__}, "run_ticks": run_ticks})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_reads_not_correct(cell, fault):
    res = rehearse(cell, seconds=0.5, run=_broken(fault))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_entry_reads_not_correct(cell, monkeypatch):
    """A payload altered where the fused propose produces it."""
    from swarmkit_tpu_torch.raft.sim import run

    real = run._payload_at

    def altered(tick, k):
        return real(tick, k) + (k == 7).to(torch.int32)

    monkeypatch.setattr(run, "_payload_at", altered)
    res = rehearse(cell, seconds=0.5)
    assert not res["correct"]
    assert res["checks"]["apply_chk_rows"][0] > 0


def test_refuses_without_a_card(capsys, monkeypatch):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "n4096-append", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
