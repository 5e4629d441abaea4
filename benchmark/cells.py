"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names each cell (a workload) with
its configuration and traffic mix, and each metric with the cells that
report it.  Every part lives in a file of its own under this folder:

- a configuration: ``configs/<config>.json`` (the `SimConfig` fields under
  ``"sim"``, the source, the guarantees, ``reduced`` and ``assumed``);
- a traffic mix: ``traffic/<traffic>.json``, parameters that the one
  generator in ``drive.py`` reads;
- a per-layer metric: ``metrics/<name>.py``, a reader with a
  ``read(ctx)`` function (``trace.py`` says what ``ctx`` holds).

So a later cell, mix or metric is new files plus new entries in
`BENCHMARK.json`, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    end_to_end: tuple      # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    """A metric without a `workloads` key is reported by every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration and
    traffic files read from root/benchmark/.  Raises KeyError for a name
    the file does not list."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = root / configs[w["config"]]["file"]
    return Cell(
        name=name, chips=int(w["chips"]), config=load_json(cfg_file),
        traffic=load_json(root / "benchmark" / "traffic"
                          / f"{w['traffic']}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reports(m, name)))


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` function of root/benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
