"""The PyTorch port's boundary: no JAX, no JAX package, no silent CPU."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from swarmkit_tpu_torch.agent.tpu import TpuExecutor
from swarmkit_tpu_torch.raft.sim import kernel, run, state
from swarmkit_tpu_torch.transport import DeviceMeshNet

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
            "swarmkit_tpu_torch.raft.read.serve",
            "swarmkit_tpu_torch.flightrec.codes",
            "swarmkit_tpu_torch.flightrec.record",
            "swarmkit_tpu_torch.flightrec.export",
            "swarmkit_tpu_torch.telemetry.series",
            "swarmkit_tpu_torch.telemetry.obs",
            "swarmkit_tpu_torch.metrics.catalog",
            "swarmkit_tpu_torch.metrics.trace",
            "swarmkit_tpu_torch.raft.faults",
            "swarmkit_tpu_torch.raft.sim.batch",
            "swarmkit_tpu_torch.dst",
            "swarmkit_tpu_torch.dst.schedule",
            "swarmkit_tpu_torch.dst.invariants",
            "swarmkit_tpu_torch.dst.explore",
            "swarmkit_tpu_torch.dst.repro",
            "swarmkit_tpu_torch.tools.dst_sweep",
            "swarmkit_tpu_torch.manager.constraint",
            "swarmkit_tpu_torch.manager.scheduler.kernel",
            "swarmkit_tpu_torch.manager.scheduler.scheduler",
            "swarmkit_tpu_torch.tools.multiraft_sweep",
            "swarmkit_tpu_torch.tools.swarm_top",
            "swarmkit_tpu_torch.tools.sched_world",
            "swarmkit_tpu_torch.transport",
            "swarmkit_tpu_torch.transport.device_mesh",
            "swarmkit_tpu_torch.raft.wire",
            "swarmkit_tpu_torch.raft.transport",
            "swarmkit_tpu_torch.agent.dependency",
            "swarmkit_tpu_torch.agent.logs",
            "swarmkit_tpu_torch.template",
            "swarmkit_tpu_torch.watch.queue",
            "swarmkit_tpu_torch.utils.identity",
            "swarmkit_tpu_torch.utils.metrics",
            "swarmkit_tpu_torch.api.raft_msgs",
            "swarmkit_tpu_torch.api.dispatcher_msgs",
            "swarmkit_tpu_torch.store",
            "swarmkit_tpu_torch.store.memory",
            "swarmkit_tpu_torch.manager.allocator",
            "swarmkit_tpu_torch.manager.controlapi",
            "swarmkit_tpu_torch.manager.drivers",
            "swarmkit_tpu_torch.manager.orchestrator.replicated",
            "swarmkit_tpu_torch.manager.dispatcher.dispatcher",
            "swarmkit_tpu_torch.agent.agent",
            "swarmkit_tpu_torch.agent.worker",
            "swarmkit_tpu_torch.agent.testutils",
            "swarmkit_tpu_torch.tools.control_plane",
            "swarmkit_tpu_torch.raft.wait",
            "swarmkit_tpu_torch.raft.membership",
            "swarmkit_tpu_torch.raft.rawnode",
            "swarmkit_tpu_torch.raft.storage",
            "swarmkit_tpu_torch.raft.node",
            "swarmkit_tpu_torch.native",
            "swarmkit_tpu_torch.encryption",
            "swarmkit_tpu_torch.encryption.encryption",
            "swarmkit_tpu_torch.store.pipeline",
            "swarmkit_tpu_torch.manager.health",
            "swarmkit_tpu_torch.manager.keymanager",
            "swarmkit_tpu_torch.manager.role_manager",
            "swarmkit_tpu_torch.manager.metrics",
            "swarmkit_tpu_torch.manager.watchapi",
            "swarmkit_tpu_torch.manager.resourceapi",
            "swarmkit_tpu_torch.manager.logbroker",
            "swarmkit_tpu_torch.manager.orchestrator.global_",
            "swarmkit_tpu_torch.manager.orchestrator.constraintenforcer",
            "swarmkit_tpu_torch.manager.orchestrator.taskreaper",
            "swarmkit_tpu_torch.manager.manager",
            "swarmkit_tpu_torch.cmd",
            "swarmkit_tpu_torch.cmd.swarm_bench"} <= set(mods)
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
        + sorted(PORT.rglob("*.cpp")) + [ROOT / "chip_smoke.py"]
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    for f in files:
        text = f.read_text()
        assert "swarmkit_tpu." not in text, f
        assert not jax_import.search(text), f


def test_wal_codec_source_is_the_ports_own():
    """The native WAL codec builds from the port's own copy of
    wal_codec.cpp, a regular file inside the port, into the checkout's
    build tree: no path into the JAX package."""
    from swarmkit_tpu_torch import native

    src = pathlib.Path(native.SRC)
    assert src == PORT / "native" / "wal_codec.cpp"
    assert src.is_file() and not src.is_symlink()
    assert src.resolve().is_relative_to(PORT.resolve())
    assert pathlib.Path(native.BUILD_DIR) == ROOT / "build" / "native"
    assert "swarmkit_tpu/" not in src.read_text()


def test_port_imports_no_module_named_by_its_caller():
    """Every dynamic import in the port and chip_smoke names one of the
    port's modules as a literal: no package root comes from a caller."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    call = re.compile(r"\b(import_module|__import__)\s*\(")
    literal = re.compile(r"\(\s*\"swarmkit_tpu_torch(\.\w+)*\"\s*\)")
    seen = 0
    for f in files:
        text = f.read_text()
        for m in call.finditer(text):
            seen += 1
            assert literal.match(text, m.end() - 1), \
                f"{f}: {text[m.start():m.start() + 80]!r}"
    assert seen > 0      # chip_smoke's lookups of the port's modules


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
                 lambda: TpuExecutor(hostname="w1"),
                 lambda: DeviceMeshNet(rows=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert TpuExecutor(device="cpu").device.type == "cpu"


BASE5 = dict(n=5, log_len=1024, window=64, apply_batch=64, max_props=64,
             keep=32, static_members=True, active_rows=0)


@pytest.mark.parametrize("lever,kw", [
    ("read path", dict(read_batch=2)),
    ("read path", dict(read_batch=2, latency=2, election_tick=14)),
    ("storage model", dict(fsync_lag_ticks=1, pre_vote=True)),
    ("transfer cooldown", dict(transfer_cooldown_ticks=4,
                               static_members=False)),
    ("storage model", dict(fsync_lag_ticks=1)),
    ("vote guard", dict(vote_guard=True)),
    ("transfer cooldown", dict(transfer_cooldown_ticks=4)),
    ("flight recorder", dict(record_events=True)),
    ("telemetry", dict(collect_telemetry=True)),
    ("trace tags", dict(record_events=True, collect_telemetry=True,
                        trace_tags=True, read_batch=2)),
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


def test_recorder_steps_like_jax_with_both_levers_on():
    """Banded peers, role-sparse progress, the mailbox wire, PreVote and
    dynamic membership with the flight recorder on: a conf proposal and
    ticks through the election equal the JAX package's on every field
    (the event ring included)."""
    import jax

    from swarmkit_tpu.raft.sim import kernel as jkernel
    from swarmkit_tpu.raft.sim import state as jstate

    from tests.test_torch_step import assert_same

    kw = dict(n=32, log_len=1024, window=64, apply_batch=64, max_props=64,
              keep=32, peer_chunk=8, active_rows=8, latency=2,
              latency_jitter=1, inflight=4, pre_vote=True, election_tick=14,
              record_events=True)
    jcfg, tcfg = jstate.SimConfig(**kw), state.SimConfig(**kw)
    assert tcfg.peer_tiled and tcfg.active_rows_on and tcfg.mailboxes
    assert not tcfg.static_members
    js, ts = jstate.init_state(jcfg), state.init_state(tcfg, device="cpu")
    js = jkernel.propose_conf(js, jcfg, 1, True)
    ts = kernel.propose_conf(ts, tcfg, 1, True, device="cpu")
    assert_same("propose_conf", js, ts)
    step = jax.jit(jkernel.step, static_argnames=("cfg",))
    for t in range(36):
        js = step(js, jcfg)
        ts = kernel.step(ts, tcfg, device="cpu")
        assert_same(f"tick {t}", js, ts)
    assert int(ts.ev_pos.sum()) > 0


def test_propose_conf_refuses_a_static_config():
    """As in the JAX package, a conf change on a static_members config is
    an error, not a silently dropped entry."""
    cfg = state.SimConfig(n=5, log_len=1024, window=64, apply_batch=64,
                          max_props=64, keep=32, static_members=True)
    st = state.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="static_members"):
        kernel.propose_conf(st, cfg, 1, True, device="cpu")
