"""Mutual TLS on the port's wire against the JAX package's.

tests/test_tls.py's cases run on the port (tests/torch_port_copies.py):
raft peers over TLS sockets, a wrong-CA join and a worker certificate on
the raft service refused, the bootstrap fetch pinned by the token digest,
swarmd's join by token, the advertise address, a root-CA rotation end to
end, autolock and its key's rotation, the WAL encrypted at rest, a
foreign cluster's certificate refused, service logs over mTLS.  Then the
packages meet: a port worker joins a JAX manager by token over mutual TLS
(and a JAX worker a port manager), is issued its certificate, registers
and runs a task; its identity has the subject and role the JAX worker's
would.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import tempfile

import pytest

from tests.conftest import requires_cryptography
from tests.torch_port_copies import cases, free_port, on_cpu, port_copy

pytestmark = requires_cryptography

JAX_CASES = port_copy("test_tls")


@pytest.mark.parametrize("case", cases(JAX_CASES))
def test_jax_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(JAX_CASES, case)()


async def _until(pred, what: str, timeout: float = 20.0):
    for _ in range(int(timeout / 0.05)):
        val = pred()
        if val:
            return val
        await asyncio.sleep(0.05)
    raise AssertionError(f"timeout waiting for {what}")


async def _join_across(manager_root: str, worker_root: str) -> dict:
    md = importlib.import_module(f"{manager_root}.cmd.swarmd")
    wd = importlib.import_module(f"{worker_root}.cmd.swarmd")
    wapi = importlib.import_module(f"{manager_root}.api")
    tmp = tempfile.TemporaryDirectory(prefix="tls-mixed-")
    common = ["--election-tick", "4", "--executor", "test"]
    m1 = w1 = None
    try:
        m1 = await md.run(md.build_parser().parse_args([
            "--state-dir", os.path.join(tmp.name, "m1"),
            "--listen-control-api", os.path.join(tmp.name, "m1.sock"),
            "--listen-remote-api", f"127.0.0.1:{free_port()}",
            "--node-id", "m1", "--manager", *common]))
        await _until(lambda: m1.is_leader()
                     and m1.manager.store.find("cluster"), "a leader")
        cluster = m1.manager.store.find("cluster")[0]
        w1 = await wd.run(wd.build_parser().parse_args([
            "--state-dir", os.path.join(tmp.name, "w1"),
            "--listen-control-api", os.path.join(tmp.name, "w1.sock"),
            "--listen-remote-api", f"127.0.0.1:{free_port()}",
            "--node-id", "w1", "--join-addr", m1.addr,
            "--join-token", cluster.root_ca.join_token_worker, *common]))
        await _until(lambda: (n := m1.manager.store.get("node", "w1"))
                     is not None and n.status.state == wapi.NodeState.READY,
                     "the worker READY over its mTLS session")
        svc = await m1.manager.control_api.create_service(wapi.ServiceSpec(
            annotations=wapi.Annotations(name="web"),
            task=wapi.TaskSpec(container=wapi.ContainerSpec(image="img")),
            replicated=wapi.ReplicatedService(replicas=2)))
        by = importlib.import_module(f"{manager_root}.store.by")

        def running():
            ts = m1.manager.store.find("task", by.ByService(svc.id))
            return sorted((t.node_id, int(t.status.state)) for t in ts
                          if t.status.state == wapi.TaskState.RUNNING)
        placed = await _until(lambda: len(running()) == 2 and running(),
                              "two tasks RUNNING")
        sec = w1.security
        return dict(role=sec.role_ou, node=sec.node_id,
                    org=sec.org == m1.security.org,
                    root=sec.root_ca.cert_pem == cluster.root_ca.ca_cert,
                    placed=placed)
    finally:
        for n in (w1, m1):
            if n is not None:
                try:
                    await n._ctl_server.stop()
                    await n.stop()
                except Exception:
                    pass
        tmp.cleanup()


@pytest.mark.parametrize("manager,worker", [
    ("swarmkit_tpu", "swarmkit_tpu_torch"),
    ("swarmkit_tpu_torch", "swarmkit_tpu")])
def test_worker_joins_across_packages_over_mtls(manager, worker,
                                                monkeypatch):
    on_cpu(monkeypatch)
    want = asyncio.run(_join_across("swarmkit_tpu", "swarmkit_tpu"))
    got = asyncio.run(_join_across(manager, worker))
    assert got == want
    assert got["role"] == "swarm-worker" and got["org"] and got["root"]


def test_listener_fetcher_hands_a_configuration_only_on_change():
    """The port's TLS listener hands grpcio a certificate configuration
    only when the node's identity changed, and None ("no change") on every
    other handshake (the JAX package's builds one on every handshake)."""
    import grpc

    from swarmkit_tpu_torch.ca import (
        MANAGER_ROLE_OU, RootCA, SecurityConfig, tlsutil,
    )

    root = RootCA.create()
    first = root.issue_node_certificate("n1", MANAGER_ROLE_OU, "org")
    sec = SecurityConfig(RootCA(root.cert_pem, root.key_pem), "n1",
                         MANAGER_ROLE_OU, "org", first.cert_pem,
                         first.key_pem)
    initial, fetch = tlsutil._cert_config_fetcher(sec)
    assert isinstance(initial, grpc.ServerCertificateConfiguration)
    assert [fetch() for _ in range(3)] == [None] * 3
    renewed = root.issue_node_certificate("n1", MANAGER_ROLE_OU, "org")
    sec.update_cert(renewed.cert_pem, renewed.key_pem)
    assert isinstance(fetch(), grpc.ServerCertificateConfiguration)
    assert fetch() is None
    sec.root_ca = RootCA(root.cert_pem + RootCA.create().cert_pem)
    assert isinstance(fetch(), grpc.ServerCertificateConfiguration)
    assert fetch() is None
