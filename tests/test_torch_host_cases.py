"""The JAX package's host test files, every case run on the port.

These fourteen files drive no JAX: the API objects, the control API, the
dispatcher, the orchestrators, service logs, the task state machine, watch
queues, tracing, watch and resourceapi over gRPC, the fault surface, the
gRPC wire's health probes, the golden raft core, the metrics registry and
a Manager's scrape page.  Each case is loaded through
tests/torch_port_copies.py, so it meets the JAX test's own checks on the
port; its id names the JAX file and the case, and its own skip stays.
"""

from __future__ import annotations

import pytest

from tests.torch_port_copies import on_cpu, params, port_copy, run_case

FILES = (
    "test_api", "test_controlapi", "test_dispatcher", "test_orchestrator",
    "test_service_logs", "test_task_fsm", "test_watch", "test_trace",
    "test_watch_resource_grpc", "test_faults", "test_transport_health",
    "test_raft_core", "test_metrics_registry", "test_metrics_integration",
)


@pytest.mark.parametrize(
    "mod,case", [p for f in FILES for p in params(port_copy(f))])
def test_jax_case_on_port(mod, case, monkeypatch, request):
    on_cpu(monkeypatch)
    run_case(mod, case, request)
