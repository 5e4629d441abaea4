"""A cell, a traffic mix and a per-layer metric added as new files (and
new BENCHMARK.json entries) are picked up with no edit to any file that
was there: a mix that cuts the load, one that splits the state by rows
over two devices, and one that drops messages, each driven through the
one generator and judged by the reference from its file alone."""

import dataclasses
import hashlib
import json
import shutil
import time
import types

import torch

from conftest import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    from benchmark import cells

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    (tmp_path / "benchmark" / "traffic" / "half-load.json").write_text(
        json.dumps({"proposals_per_tick": 1024, "chunk_ticks": 16}))
    (tmp_path / "benchmark" / "metrics" / "window_ticks.py").write_text(
        "def read(ctx):\n    return ctx['window']['ticks'] or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "n4096-half", "config": "raft-n4096",
        "traffic": "half-load", "chips": 1, "why": "half the load"})
    bench["per_layer"].append({
        "name": "window_ticks", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "drivers: the window",
        "moves": "entries_per_s", "workloads": ["n4096-half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("n4096-half", root=tmp_path)
    assert cell.traffic["proposals_per_tick"] == 1024
    assert cell.config["sim"]["n"] == 4096
    names = [m["name"] for m in cell.per_layer]
    assert "window_ticks" in names and "device_idle_pct" in names
    assert "read_phase_ms" not in names
    read = cells.metric_reader("window_ticks", root=tmp_path)
    assert read({"window": {"ticks": 96}}) == 96
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert not changed
    assert set(after) - set(before) == {
        p.relative_to(tmp_path) for p in (
            tmp_path / "benchmark" / "traffic" / "half-load.json",
            tmp_path / "benchmark" / "metrics" / "window_ticks.py")}
    # the existing cells are found as before
    assert cells.load_cell("n4096-reads", root=tmp_path).traffic["sim"] \
        == {"read_batch": 49}


def _copy_with_cell(tmp_path, cell: str, mix: str, params: dict):
    """The checkout copied to tmp_path, with the mix `mix` and the cell
    `cell` on raft-n4096 added as a new file and a new entry."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    (tmp_path / "benchmark" / "traffic" / f"{mix}.json").write_text(
        json.dumps(params))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "raft-n4096",
                               "traffic": mix, "chips": 1, "why": mix})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {p for p in before if before[p] != after.get(p)} == set()
    return tmp_path


def _spy():
    """raft.sim with run_ticks recording each call's state placement and
    keyword arguments."""
    from swarmkit_tpu_torch import parallel
    from swarmkit_tpu_torch.raft import sim

    calls = []

    def run_ticks(st, cfg, n, **kw):
        calls.append((parallel.row_sharded(st),
                      {k: v for k, v in kw.items() if k != "device"}))
        return sim.run_ticks(st, cfg, n, **kw)

    mod = types.SimpleNamespace(**{
        **{k: getattr(sim, k) for k in sim.__all__}, "run_ticks": run_ticks})
    return mod, calls


def _rehearse(root, name: str, n: int = 64, **kw):
    from benchmark import cells, run

    cell = cells.load_cell(name, root=root)
    cell = dataclasses.replace(cell, config={
        **cell.config, "sim": {**cell.config["sim"], "n": n}})
    return run.run_cell(cell, 2**31 + 4099, 0.5, False, torch.device("cpu"),
                        time.perf_counter(), **kw)


def test_a_row_sharded_mix_needs_only_a_file(tmp_path):
    root = _copy_with_cell(tmp_path, "n4096-rows2", "append-rows2", {
        "proposals_per_tick": 2048, "chunk_ticks": 8, "warm_ticks": 8,
        "row_shards": 2})
    spy, calls = _spy()
    res = _rehearse(root, "n4096-rows2", run=spy)
    assert calls and all(sharded for sharded, _ in calls)
    assert res["correct"], res["checks"]
    assert res["window"]["committed"] > 0


def test_a_drop_mix_needs_only_a_file(tmp_path):
    """The drop rate reaches every run_ticks call and the judge takes its
    parameters from the mix's file."""
    root = _copy_with_cell(tmp_path, "n4096-drop5", "append-drop5", {
        "proposals_per_tick": 2048, "chunk_ticks": 8, "warm_ticks": 8,
        "run_ticks": {"drop_rate": 0.05},
        "judge": {"one_round_elections": False}})
    spy, calls = _spy()
    res = _rehearse(root, "n4096-drop5", run=spy)
    assert calls and all(kw.get("drop_rate") == 0.05 for _, kw in calls)
    assert "term_rounds" not in res["checks"]
    assert "term_order" in res["checks"]
