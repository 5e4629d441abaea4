"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every part of every cell found by name."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for group, keys in ENTRY_KEYS.items():
        assert 1 <= len(bench[group])
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                              "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e


def test_names_and_units(bench):
    for group in ENTRY_KEYS:
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    for word in bench["command"]:
        assert _line(word)


def test_metrics_and_cells_agree(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for m in bench["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_part_found_by_name(bench):
    from benchmark import cells, drive

    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        cfg = drive.sim_config(cell, 2**31 + 5)
        assert cfg.n == cell.config["sim"]["n"]
        assert cell.traffic["proposals_per_tick"] > 0
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(ROOT / "benchmark")
        data = json.loads(path.read_text())
        assert data["source"] and data["guarantees"]
        assert data["reduced"] == c["reduced"]
        assert all(k in data for k in c["reduced"])
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")
