"""The port's cluster RPCs (rpc.py) against the JAX package's, on real
gRPC sockets, each package's client against the other's server.

The health and metrics services: a status, a crashing backend read as
NOT_SERVING, a scrape, an unreachable endpoint.  The cluster services of
a TLS manager started by swarmd (in this process): a certificate-less
joiner pinned by the join token's digest reads the manager's Info and is
issued a worker and a manager certificate over the TLS join port; with
those identities over mutual TLS, the control API refuses the worker and
answers the manager exactly as the manager's own control API does, and a
dispatcher session opens with the node's id.  Each answer is equal for
the four pairings of client and server package.  The wire payloads the
clients and servers pack are byte-identical between the packages.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import tempfile

import grpc
import pytest

from swarmkit_tpu import rpc as jrpc
from swarmkit_tpu_torch import rpc as trpc
from tests.conftest import requires_cryptography
from tests.torch_port_copies import free_port, on_cpu

ROOTS = {"jax": "swarmkit_tpu", "port": "swarmkit_tpu_torch"}
PAIRS = [(s, c) for s in ROOTS for c in ROOTS]


def _pkg(name: str):
    root = ROOTS[name]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")
    return m


@pytest.mark.parametrize("server,client", PAIRS)
def test_health_and_metrics_services(server, client):
    srv, cli = _pkg(server)("rpc"), _pkg(client)("rpc")

    def check(service):
        if service == "boom":
            raise RuntimeError("backend down")
        return {"": 1, "swarmkit.Raft": 1}.get(service, 3)

    async def go():
        port = free_port()
        s = grpc.aio.server()
        for h in srv.health_handlers(check) + srv.metrics_handlers(
                lambda: "swarm_up 1\n"):
            s.add_generic_rpc_handlers((h,))
        s.add_insecure_port(f"127.0.0.1:{port}")
        await s.start()
        ch = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        try:
            got = [await cli.check_health(ch, svc)
                   for svc in ("", "swarmkit.Raft", "other", "boom")]
            text = await cli.scrape_metrics(ch)
        finally:
            await ch.close()
            await s.stop(None)
        dead = grpc.aio.insecure_channel(f"127.0.0.1:{free_port()}")
        try:
            with pytest.raises(cli.RpcError):
                await cli.check_health(dead, timeout=0.5)
        finally:
            await dead.close()
        return got, text
    assert asyncio.run(go()) == ([1, 1, 3, 2], "swarm_up 1\n")


async def _manager(server: str, tmp: str):
    swarmd = _pkg(server)("cmd.swarmd")
    argv = ["--state-dir", os.path.join(tmp, "m1"),
            "--listen-control-api", os.path.join(tmp, "m1.sock"),
            "--listen-remote-api", f"127.0.0.1:{free_port()}",
            "--node-id", "m1", "--manager", "--election-tick", "4",
            "--executor", "test"]
    node = await swarmd.run(swarmd.build_parser().parse_args(argv))
    for _ in range(400):
        if node.is_leader() and node.manager.store.find("cluster"):
            break
        await asyncio.sleep(0.05)
    assert node.is_leader()
    return node


async def _client_session(server: str, client: str) -> dict:
    m = _pkg(client)
    crpc, cca = m("rpc"), m("ca")
    out = {}
    with tempfile.TemporaryDirectory(prefix="rpc-") as tmp:
        node = await _manager(server, tmp)
        try:
            cl = node.manager.store.find("cluster")[0]
            digest = cl.root_ca.ca_cert_hash
            joiner = crpc.RemoteManager(node.addr, expected_ca_digest=digest)
            try:
                await joiner.refresh()
                out["info"] = (joiner.is_leader(), joiner.leader_addr ==
                               node.addr, joiner._has_manager)
                ids = {}
                for role, token in (("worker", cl.root_ca.join_token_worker),
                                    ("manager",
                                     cl.root_ca.join_token_manager)):
                    csr, key = cca.create_csr(f"n-{role}")
                    nid, issued = await joiner.ca_server \
                        .issue_node_certificate(csr, token,
                                                requested_node_id=f"n-{role}")
                    ids[role] = (nid, issued.cert_pem, key)
                    out[f"issued_{role}"] = (
                        nid, cca.parse_identity(issued.cert_pem)[1:])
                root_pem = joiner.ca_server.get_root_ca_certificate()
                with pytest.raises(crpc.RpcError) as bad:
                    csr, _ = cca.create_csr("n-bad")
                    await joiner.ca_server.issue_node_certificate(
                        csr, "SWMTKN-1-" + digest + "-" + "0" * 32)
                out["bad_token"] = str(bad.value).split(":")[0]
            finally:
                await joiner.close()
            for role, (nid, cert, key) in ids.items():
                role_ou, org = cca.parse_identity(cert)[1:]
                sec = cca.SecurityConfig(cca.RootCA(root_pem), nid, role_ou,
                                         org, cert, key)
                rm = crpc.RemoteManager(node.addr, security_ref=lambda s=sec: s)
                try:
                    await rm.refresh()
                    try:
                        got = await rm.control_call("cluster.inspect", {})
                        out[f"control_{role}"] = got["spec"] == \
                            cl.to_dict()["spec"] and got["id"] == cl.id
                    except Exception as e:
                        out[f"control_{role}"] = (type(e).__name__,
                                                  str(e).split(":")[0])
                    if role == "worker":
                        first = await rm.dispatcher.session(nid).__anext__()
                        out["session"] = (first.node.id == nid,
                                          bool(first.session_id))
                finally:
                    await rm.close()
        finally:
            await node._ctl_server.stop()
            await node.stop()
    return out


@requires_cryptography
@pytest.mark.parametrize("server,client", PAIRS)
def test_cluster_services_across_packages(server, client, monkeypatch):
    on_cpu(monkeypatch)
    got = asyncio.run(_client_session(server, client))
    assert got == {
        "info": (True, True, True),
        "issued_worker": ("n-worker", ("swarm-worker", got["issued_worker"]
                                       [1][1])),
        "issued_manager": ("n-manager", ("swarm-manager",
                                         got["issued_manager"][1][1])),
        "bad_token": "INVALID_ARGUMENT",
        "control_worker": ("RpcError", "PERMISSION_DENIED"),
        "control_manager": True,
        "session": (True, True),
    }


def _payloads(rpc, pkg, packb) -> list:
    api = pkg("api")
    lb = pkg("manager.logbroker")
    msg = lb.LogMessage(
        context=lb.LogContext(service_id="s", node_id="n", task_id="t"),
        timestamp=1234.5, stream=lb.LogStream(1), data=b"result: -1.5")
    sub = lb.SubscriptionMessage(
        id="sub1", selector=lb.LogSelector(service_ids=["s"]), close=False,
        options={"follow": True, "tail": 10})
    return [
        rpc.pack_session_request("n1", api.NodeDescription(hostname="h"),
                                 "sess", "10.0.0.1:1"),
        packb(rpc._pack_logmsg(msg)),
        packb(rpc._pack_submsg(sub)),
    ]


def test_wire_payloads_are_byte_identical():
    import msgpack

    j = _payloads(jrpc, _pkg("jax"), msgpack.packb)
    t = _payloads(trpc, _pkg("port"), trpc.packb)
    assert t == j
    # and each side decodes the other's log and subscription messages
    assert trpc._unpack_logmsg(trpc.unpackb(j[1])).timestamp == 1234.5
    assert trpc._unpack_submsg(trpc.unpackb(j[2])).options == \
        {"follow": True, "tail": 10}
