"""The port's node lifecycle (node/: Node, Remotes, ConnectionBroker, the
debug surface) against the JAX package's.

tests/test_integration.py's cases run on the port through the port's copy
of tests/integration_harness.py (tests/torch_port_copies.py): cluster
and service creation, replication and a leader restart, promotion and
demotion, a forced new cluster, a worker restart, the CA join by token,
a manager joined with the manager token, the device wire.  Then one
script runs through both packages' harnesses (in-process Network, the
manager's scheduler on the CPU): a manager and two agents, a service of 4
replicas, a second manager, a scale-down to 2, the service removed; the
store after each step, its random ids replaced by names, equals the JAX
package's.  Last, the port's debug surface answers what the JAX
package's does, plus the kernel launches of its process.
"""

from __future__ import annotations

import asyncio
import importlib
import json

import pytest

from tests.torch_port_copies import cases, on_cpu, port_copy

JAX_CASES = port_copy("test_integration")


@pytest.mark.parametrize("case", cases(JAX_CASES))
def test_jax_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(JAX_CASES, case)()


def _view(lead, loose: bool = False) -> dict:
    """The leader's store with service ids replaced by the service's
    name and task ids dropped: each service's slots, and its tasks' nodes
    and states.  Which slot lands on which node follows the order of the
    tasks' random ids, and varies from run to run in either package; so
    do the slots a scale-down keeps, which `loose` leaves out with the
    tasks' nodes."""
    names = {s.id: s.spec.annotations.name for s in lead.store.find("service")}
    nodes = sorted((n.id, int(n.role), int(n.spec.desired_role),
                    int(n.status.state), int(n.spec.availability))
                   for n in lead.store.find("node"))
    services = sorted((s.spec.annotations.name, s.spec.replicated.replicas)
                      for s in lead.store.find("service"))
    tasks = lead.store.find("task")
    slots = sorted((names.get(t.service_id, "?"), t.slot) for t in tasks)
    if loose:
        slots = sorted(name for name, _ in slots)
    placed = sorted((names.get(t.service_id, "?"),
                     "" if loose else t.node_id, int(t.desired_state),
                     int(t.status.state)) for t in tasks)
    return dict(nodes=nodes, services=services, slots=slots, tasks=placed)


async def _script(harness) -> list:
    c = harness.TestCluster()
    views = []
    try:
        await c.add_manager()
        await c.add_agent()
        await c.add_agent()
        await c.poll_cluster_ready(managers=1, workers=2)
        views.append(("ready", _view(c.leader())))
        svc = await c.create_service(replicas=4)
        await c.poll(lambda: len(c.running_tasks(svc.id)) == 4, "4 running")
        views.append(("created", _view(c.leader())))
        await c.add_manager()
        await c.poll_cluster_ready(managers=2, workers=2)
        views.append(("second manager", _view(c.leader())))
        lead = await c.wait_leader()
        cur = lead.control_api.get_service(svc.id)
        spec = cur.spec.copy()
        spec.replicated.replicas = 2
        await lead.control_api.update_service(
            svc.id, spec, version=cur.meta.version.index)

        def scaled():
            return len(c.running_tasks(svc.id)) == 2 \
                and len(c.leader().store.find("task")) == 2
        await c.poll(scaled, "scaled to 2")
        views.append(("scaled", _view(c.leader(), loose=True)))
        await c.leader().control_api.remove_service(svc.id)
        await c.poll(lambda: not c.leader().store.find("task"),
                     "the tasks removed")
        views.append(("removed", _view(c.leader())))
    finally:
        await c.stop_all()
    return views


def test_node_script_stores_equal_jax(monkeypatch):
    on_cpu(monkeypatch)
    from tests import integration_harness as jh

    jax = asyncio.run(_script(jh))
    port = asyncio.run(_script(port_copy("integration_harness")))
    assert [s for s, _ in port] == [s for s, _ in jax]
    for (step, want), (_, got) in zip(jax, port):
        assert got == want, step


async def _debug_session(root: str, tmp) -> dict:
    swarmd = importlib.import_module(f"{root}.cmd.swarmd")
    sock = str(tmp / f"{root}-dbg.sock")
    args = swarmd.build_parser().parse_args([
        "--state-dir", str(tmp / root), "--listen-control-api",
        str(tmp / f"{root}.sock"), "--node-id", "m1", "--manager",
        "--election-tick", "4", "--backend", "inproc", "--executor", "test",
        "--listen-debug", sock])
    node = await swarmd.run(args)
    node.config.tick_interval = 0.05
    out = {}
    try:
        for _ in range(400):
            if node.is_leader():
                break
            await asyncio.sleep(0.05)

        async def get(path):
            r, w = await asyncio.open_unix_connection(sock)
            w.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
            await w.drain()
            raw = await r.read()
            w.close()
            head, _, body = raw.partition(b"\r\n\r\n")
            return head.split(b" ")[1].decode(), json.loads(body)
        for path in ("/debug/vars", "/debug/store", "/debug/queues",
                     "/debug/nope", "/debug/kernels"):
            status, body = await get(path)
            if path == "/debug/vars":
                body = {k: body[k] for k in ("node_id", "is_manager",
                                             "is_leader")}
            elif path == "/debug/store":
                body = {k: body[k] for k in ("wedged", "write_lock_held",
                                             "in_flight_proposals")}
            elif path == "/debug/queues":
                body = sorted(body)
            out[path] = (status, body)
    finally:
        await node._debug_server.stop()
        await node._ctl_server.stop()
        await node.stop()
    return out


def test_debug_surface_like_jax(monkeypatch, tmp_path):
    on_cpu(monkeypatch)
    jax = asyncio.run(_debug_session("swarmkit_tpu", tmp_path))
    port = asyncio.run(_debug_session("swarmkit_tpu_torch", tmp_path))
    from swarmkit_tpu_torch.parallel import cuda_ops

    # the port serves one path more: this process's kernel launches
    assert jax["/debug/kernels"][0] == "404"
    assert port["/debug/kernels"] == (
        "200", {"launches": dict(cuda_ops.LAUNCHES), "device": None})
    assert port["/debug/nope"][1]["paths"] == \
        jax["/debug/nope"][1]["paths"] + ["/debug/kernels"]
    for path in ("/debug/vars", "/debug/store", "/debug/queues"):
        assert port[path] == jax[path], path
