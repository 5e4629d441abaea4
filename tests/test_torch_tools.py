"""The port's multi-raft tools (swarm_top, multiraft_sweep) against the
JAX package's (tools/swarm_top.py, tools/multiraft_sweep.py).

TestSwarmTop is tests/test_causal_trace.py's TestSwarmTop against the
port's module.  The frames and the demo's deterministic metric values
must equal the JAX tool's exactly; the sweep's JSON lines must carry the
same keys.  All runs here are on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from swarmkit_tpu_torch.tools import multiraft_sweep
from swarmkit_tpu_torch.tools import swarm_top as ttop

ROOT = Path(__file__).resolve().parent.parent


def _load_jax_tool(name: str):
    """tools/<name>.py, the JAX package's tool, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtop = _load_jax_tool("swarm_top")


def _fake_snapshot(commits=100.0, leader=1.0):
    return {"metrics": {"swarm_raft_is_leader": leader,
                        "swarm_kernel_commit_advance_total": commits,
                        "swarm_flightrec_captures_total":
                            {"trigger=manual": 2.0}},
            "timers": {}, "objects": {"nodes": 3}, "spans": [],
            "recent_events": [{"describe": "flightrec[manual] 1 span"}]}


class TestSwarmTop:
    def test_render_frame_shows_series_and_rates(self):
        state = ttop.TopState()
        state.observe({"m1": _fake_snapshot(100.0)}, now=0.0)
        state.observe({"m1": _fake_snapshot(250.0)}, now=10.0)
        frame = ttop.render_frame({"m1": _fake_snapshot(250.0)}, state)
        assert "m1" in frame and "[LEADER]" in frame
        assert "swarm_kernel_commit_advance_total" in frame
        assert "15.0/s" in frame           # (250-100)/10
        assert "trigger=manual" in frame   # labeled child flattened
        assert "flightrec[manual]" in frame

    def test_render_frame_shows_fleet_health_panels(self):
        snap = _fake_snapshot()
        snap["hottest"] = [2, 0, 1]
        snap["slo_active"] = [{"slo": "leader_churn", "group": 2,
                               "state": "page"}]
        snap["alerts"] = [{"scrape": 4, "slo": "leader_churn", "group": 2,
                           "from": "ok", "to": "page",
                           "fast_burn": 10.0, "slow_burn": 7.5}]
        frame = ttop.render_frame({"fleet": snap}, ttop.TopState())
        assert "hottest groups: g2 g0 g1" in frame
        assert "SLO ALERTS (1 active):" in frame
        assert "!! PAGE  leader_churn group=2" in frame
        assert "ok->page" in frame and "burn fast 10.0x" in frame

    def test_render_frame_all_ok_banner(self):
        snap = _fake_snapshot()
        snap["slo_active"] = []            # present-but-empty: fleet is ok
        frame = ttop.render_frame({"fleet": snap}, ttop.TopState())
        assert "SLO ALERTS: none — all objectives ok" in frame
        assert "hottest groups" not in frame

    def test_counter_reset_drops_sample(self):
        state = ttop.TopState()
        state.observe({"m1": _fake_snapshot(100.0)}, now=0.0)
        state.observe({"m1": _fake_snapshot(10.0)}, now=1.0)  # restart
        # negative delta is not a rate: no sample recorded
        assert not state.rates["m1"].get(
            "swarm_kernel_commit_advance_total")

    def test_sparkline_scales_to_max(self):
        assert ttop.sparkline([]) == ""
        line = ttop.sparkline([0, 1, 2, 4])
        assert len(line) == 4 and line[0] == "▁" and line[-1] == "█"

    def test_once_from_snapshot_file(self, tmp_path, capsys):
        p = tmp_path / "snap.json"
        p.write_text(json.dumps({"mgr-a": _fake_snapshot(),
                                 "mgr-b": _fake_snapshot(leader=0.0)}))
        assert ttop.main(["--from", str(p), "--once"]) == 0
        out = capsys.readouterr().out
        assert "2 manager(s)" in out and "mgr-a" in out and "mgr-b" in out

    def test_unreadable_file_degrades_not_crashes(self, tmp_path, capsys):
        p = tmp_path / "broken.json"
        p.write_text("{nope")
        assert ttop.main(["--from", str(p), "--once"]) == 0
        assert "unreadable" in capsys.readouterr().out


def _snapshots():
    a = _fake_snapshot(100.0)
    b = _fake_snapshot(250.0, leader=0.0)
    b["metrics"]["swarm_kernel_tick_seconds"] = {
        "call=step": {"count": 3, "sum": 0.25}}
    b["metrics"]["swarm_slo_state"] = {"slo=spill_ratio,group=1": 2.0}
    b["metrics"]["swarm_store_objects"] = 12.5
    b["hottest"] = [1, 3]
    b["slo_active"] = [{"slo": "spill_ratio", "group": 1, "state": "warn"},
                       {"slo": "commit_p99", "group": 0, "state": "page"}]
    b["alerts"] = [{"scrape": s, "slo": "spill_ratio", "group": 1,
                    "from": "ok", "to": "warn", "fast_burn": 3.0 + s,
                    "slow_burn": 1.5} for s in range(5)]
    b["objects"] = {"nodes": 3, "tasks": 9, "services": 2, "networks": 1,
                    "secrets": 4}
    b["recent_events"] = [{"name": f"ev{i}"} for i in range(5)]
    c = _fake_snapshot()
    c["slo_active"] = []
    return [{"m1": a}, {"m1": a, "m2": b}, {"m1": b, "m2": a, "fleet": c}]


@pytest.mark.parametrize("width", [100, 40])
def test_render_frame_text_equals_jax(monkeypatch, width):
    """The same snapshots through the same polls: the port's frames are
    the JAX tool's, character for character."""
    monkeypatch.setattr(time, "strftime", lambda fmt: "12:34:56")
    states = (jtop.TopState(), ttop.TopState())
    patterns = tuple(jtop.DEFAULT_FILTER) + ("timers",)
    assert ttop.DEFAULT_FILTER == jtop.DEFAULT_FILTER
    for k, snaps in enumerate(_snapshots()):
        for st in states:
            st.observe(snaps, now=float(k))
        frames = [mod.render_frame(snaps, st, patterns, width=width)
                  for mod, st in zip((jtop, ttop), states)]
        assert frames[0] == frames[1]
    assert states[0].rates == states[1].rates


def test_source_demo_matches_jax():
    """The port's demo (on the CPU) at the JAX tool's demo size: after
    each of three polls every published metric value, the objects, the
    hottest groups, the active SLOs and the alerts equal the JAX demo's
    (the demo's registries hold no timings)."""
    poll_j, poll_t = jtop.source_demo(), ttop.source_demo(device="cpu")
    for k in range(3):
        snap_j, snap_t = poll_j(), poll_t()
        assert sorted(snap_j) == sorted(snap_t) == ["sim-fleet",
                                                    "sim-quorum"]
        for mgr in snap_j:
            assert snap_t[mgr] == snap_j[mgr], (k, mgr)
    fleet = snap_t["sim-fleet"]
    assert fleet["hottest"] and fleet["slo_active"]
    assert snap_t["sim-quorum"]["metrics"][
        "swarm_kernel_commit_advance_total"] > 0


def test_source_demo_needs_a_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttop.source_demo()


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_multiraft_sweep_json_keys_equal_jax(capsys):
    """--groups 2,4 --entries 2000 --no-single --json: the port's lines
    carry the JAX tool's keys, and the deterministic counts agree."""
    args = ["--groups", "2,4", "--entries", "2000", "--no-single", "--json"]
    assert multiraft_sweep.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    port = _json_lines(out)
    assert "| groups | agg entries/s" in out
    assert out.rstrip().splitlines()[-1].startswith("| 4 x n=3 |")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "multiraft_sweep.py"), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    jax = _json_lines(res.stdout)
    assert [sorted(p) for p in port] == [sorted(j) for j in jax]
    assert len(port) == 2
    for p, j in zip(port, jax):
        for k in ("groups", "n", "committed", "reads", "groups_with_leader",
                  "elect_ticks"):
            assert p[k] == j[k], k
