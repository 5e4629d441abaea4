"""The port's soak_controlplane (churn soak and gRPC load harness) and its
TestCluster, on the CPU.

The churn soak runs every cycle kind on both wires; the load harness at
200 agents meets tests/test_load_harness.py's checks with the scheduler's
plain loop, returns the JAX tool's result keys and publishes the JAX
tool's three swarm_bench_* gauges in the leader's registry.  The
package's TestCluster keeps tests/integration_harness.py's methods.
"""

from __future__ import annotations

import asyncio
import inspect
import pathlib
import re

import pytest

from swarmkit_tpu_torch.metrics import catalog
from swarmkit_tpu_torch.tools import integration_harness
from swarmkit_tpu_torch.tools import soak_controlplane as sc

from tests import integration_harness as jharness

JAX_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "soak_controlplane.py"


def _jax_result_keys() -> set:
    """The keys of the JAX tool's load() result dict."""
    text = JAX_TOOL.read_text()
    body = text[text.index("        result = {"):]
    body = body[:body.index("\n        }\n")]
    return set(re.findall(r'"(\w+)":', body))


@pytest.mark.parametrize("transport", ["inproc", "device"])
def test_soak_runs_every_cycle_kind(transport, capsys):
    stats = {}
    assert asyncio.run(sc.soak(0.15, transport, device="cpu",
                               stats=stats)) == 0
    assert set(stats["cycles"]) == set(sc.CYCLE_KINDS)
    assert all(n >= 1 for n in stats["cycles"].values()), stats
    assert 4 <= stats["max_tasks"] < 80
    cycles = sum(stats["cycles"].values())
    assert f"SOAK OK: {cycles} cycles on {transport} transport" in \
        capsys.readouterr().out


def test_load_harness_on_the_cpu(monkeypatch):
    """tests/test_load_harness.py's checks at 200 agents for 0.2 minutes,
    the scheduler kernel's plain loop counting kernel groups; the result
    has the JAX tool's keys; the leader's registry holds the three
    gauges under config grpc-200."""
    from swarmkit_tpu_torch.manager import manager as mgr_mod

    made = []

    class Recorded(mgr_mod.Manager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mgr_mod, "Manager", Recorded)
    r = asyncio.run(sc.load(minutes=0.2, agents=200, active=32,
                            heartbeat=5.0, report_every=1e9,
                            sustain_floor=0.98, device="cpu"))
    assert set(r) == _jax_result_keys(), set(r) ^ _jax_result_keys()
    assert "error" not in r
    assert r["agents_sustained"] >= int(0.98 * 200)
    assert r["assignments"] > 0 and r["status_writes"] > 0
    assert r["kernel_groups"] > 0
    assert r["entries_per_proposal"] > 1.0
    assert r["rtt_p99_ms"] < 5_000.0
    assert (r["agents"], r["active"], r["replicas"]) == (200, 32, 64)
    assert len(made) == 3 and all(m.device.type == "cpu" for m in made)
    gauges = {}
    for m in made:
        for name in ("swarm_bench_assignments_per_second",
                     "swarm_bench_agents_sustained",
                     "swarm_bench_heartbeat_rtt_p99_seconds"):
            fam = m.obs.get(name)
            if fam is not None:
                gauges[name] = fam.labels(config="grpc-200").value
    assert gauges == {
        "swarm_bench_assignments_per_second": r["assignments_per_s"],
        "swarm_bench_agents_sustained": r["agents_sustained"],
        "swarm_bench_heartbeat_rtt_p99_seconds":
            pytest.approx(r["rtt_p99_ms"] / 1e3, abs=1e-5)}
    assert all(n in catalog.CATALOG for n in gauges)


def test_cli_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.main(["--minutes", "0.01"])


def _public(cls) -> dict:
    return {n: inspect.signature(f) for n, f in vars(cls).items()
            if not n.startswith("_") and callable(f)}


def test_test_cluster_matches_the_test_harness():
    """The package's TestCluster has the test harness's public methods
    with the same signatures; its constructor adds only `device`."""
    got, want = integration_harness.TestCluster, jharness.TestCluster
    assert _public(got).keys() == _public(want).keys()
    for name, sig in _public(want).items():
        assert str(_public(got)[name]) == str(sig), name
    init = inspect.signature(got.__init__).parameters
    assert list(init) == list(inspect.signature(
        want.__init__).parameters) + ["device"]
    assert init["device"].default is None
