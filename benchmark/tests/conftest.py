"""Shared helpers of the benchmark's tests: the checkout's root on the
path, and a cell cut to a size the CPU runs in seconds."""

import dataclasses
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, n: int = 64):
    """The cell `name` of BENCHMARK.json at n rows: the CPU rehearsal's
    size (every other field as the cell runs it)."""
    from benchmark import cells

    cell = cells.load_cell(name)
    return dataclasses.replace(cell, config={
        **cell.config, "sim": {**cell.config["sim"], "n": n}})


def rehearse(name: str, seed: int = 2**31 + 77, seconds: float = 1.0,
             n: int = 64, device: str = "cpu", **kw) -> dict:
    """One run of the cell's flow and the reference on `device` at n rows
    (run.run_cell: no metric is written)."""
    import torch

    from benchmark import run

    return run.run_cell(small_cell(name, n), seed, seconds,
                        kw.pop("trace", False), torch.device(device),
                        time.perf_counter(), **kw)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
