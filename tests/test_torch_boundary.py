"""The PyTorch port's boundary: no JAX, no JAX package, no silent CPU."""

from __future__ import annotations

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from swarmkit_tpu_torch.agent.tpu import TpuExecutor
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
    assert {"swarmkit_tpu_torch.raft.read.lease",
            "swarmkit_tpu_torch.raft.read.serve"} <= set(mods)
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
                 lambda: state.state_from_numpy(state.state_to_numpy(st)),
                 lambda: TpuExecutor(hostname="w1")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert TpuExecutor(device="cpu").device.type == "cpu"


BASE5 = dict(n=5, log_len=1024, window=64, apply_batch=64, max_props=64,
             keep=32, static_members=True, active_rows=0)


@pytest.mark.parametrize("lever,kw", [
    ("flight recorder", dict(record_events=True)),
    ("telemetry", dict(collect_telemetry=True)),
    ("trace tags", dict(record_events=True, collect_telemetry=True,
                        trace_tags=True)),
])
def test_unported_levers_raise(lever, kw):
    cfg = state.SimConfig(**{**BASE5, **kw})
    st = state.init_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=lever):
        kernel.step(st, cfg, device="cpu")


@pytest.mark.parametrize("lever,kw", [
    ("read path", dict(read_batch=2)),
    ("read path", dict(read_batch=2, latency=2, election_tick=14)),
    ("storage model", dict(fsync_lag_ticks=1, pre_vote=True)),
    ("transfer cooldown", dict(transfer_cooldown_ticks=4,
                               static_members=False)),
    ("storage model", dict(fsync_lag_ticks=1)),
    ("vote guard", dict(vote_guard=True)),
    ("transfer cooldown", dict(transfer_cooldown_ticks=4)),
])
def test_ported_levers_step_like_jax(lever, kw):
    """The levers the earlier slices left raising now run: one step from
    the initial state equals the JAX package's on every field."""
    from swarmkit_tpu.raft.sim import kernel as jkernel
    from swarmkit_tpu.raft.sim import state as jstate

    from tests.test_torch_step import assert_same

    cfg_kw = {**BASE5, **kw}
    jcfg, tcfg = jstate.SimConfig(**cfg_kw), state.SimConfig(**cfg_kw)
    js = jkernel.step(jstate.init_state(jcfg), jcfg)
    ts = kernel.step(state.init_state(tcfg, device="cpu"), tcfg,
                     device="cpu")
    assert_same(lever, js, ts)


def test_unported_lever_raises_with_both_ported_levers_on():
    """Banded peers, role-sparse progress, the mailbox wire, PreVote and
    dynamic membership are ported; a lever still unported raises by name
    with all of them on, and without it the tick runs."""
    cfg = state.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                          max_props=64, keep=32, peer_chunk=8,
                          active_rows=8, latency=2, latency_jitter=1,
                          inflight=4, pre_vote=True, election_tick=14,
                          record_events=True)
    assert cfg.peer_tiled and cfg.active_rows_on and cfg.mailboxes
    assert not cfg.static_members
    st = state.init_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="flight recorder"):
        kernel.step(st, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="flight recorder"):
        kernel.propose_conf(st, cfg, 1, True, device="cpu")
    cfg = dataclasses.replace(cfg, record_events=False)
    st = kernel.step(state.init_state(cfg, device="cpu"), cfg, device="cpu")
    assert int(st.tick) == 1


def test_propose_conf_refuses_a_static_config():
    """As in the JAX package, a conf change on a static_members config is
    an error, not a silently dropped entry."""
    cfg = state.SimConfig(n=5, log_len=1024, window=64, apply_batch=64,
                          max_props=64, keep=32, static_members=True)
    st = state.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="static_members"):
        kernel.propose_conf(st, cfg, 1, True, device="cpu")
