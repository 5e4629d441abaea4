"""The PyTorch port's boundary: no JAX, no JAX package, no silent CPU."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from swarmkit_tpu_torch.raft.sim import kernel, run, state

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "swarmkit_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    """A fresh interpreter with `jax` and the JAX package blocked imports
    every module of the port and chip_smoke."""
    mods = _port_modules() + ["chip_smoke"]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['swarmkit_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_port_source_names_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + [ROOT / "chip_smoke.py"]
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for f in files:
        text = f.read_text()
        assert "swarmkit_tpu." not in text, f
        assert not jax_import.search(text), f


def test_entry_points_raise_without_a_card(monkeypatch):
    """Called without device=, the entry points need CUDA and raise when
    there is none — they never drop to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = state.SimConfig(n=5, log_len=1024, window=64, apply_batch=64,
                          max_props=64, keep=32, static_members=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.init_state(cfg)
    st = state.init_state(cfg, device="cpu")
    for call in (lambda: kernel.step(st, cfg),
                 lambda: run.run_ticks(st, cfg, 1),
                 lambda: run.run_until_leader(st, cfg, 1),
                 lambda: state.state_from_numpy(state.state_to_numpy(st))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("lever,kw", [
    ("dynamic membership", dict(static_members=False)),
    ("mailbox wire", dict(latency=1, election_tick=14)),
    ("PreVote", dict(pre_vote=True)),
    ("banded peer", dict(n=16, peer_chunk=8)),
    ("role-sparse", dict(n=32, active_rows=8)),
    ("read path", dict(read_batch=2)),
    ("flight recorder", dict(record_events=True)),
    ("telemetry", dict(collect_telemetry=True)),
    ("storage model", dict(fsync_lag_ticks=1)),
    ("vote guard", dict(vote_guard=True)),
    ("transfer cooldown", dict(transfer_cooldown_ticks=4)),
])
def test_unported_levers_raise(lever, kw):
    base = dict(n=5, log_len=1024, window=64, apply_batch=64, max_props=64,
                keep=32, static_members=True, active_rows=0)
    cfg = state.SimConfig(**{**base, **kw})
    st = state.init_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=lever):
        kernel.step(st, cfg, device="cpu")
