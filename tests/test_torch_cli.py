"""The port's daemons and CLIs (cmd/swarmd, swarmctl, ctl, rafttool,
external_ca_example) against the JAX package's, on the CPU
(``--device cpu``).

tests/test_cli.py's and tests/test_drivers_and_external.py's cases run on
the port (tests/torch_port_copies.py).  Then the packages meet:

- one swarmctl session through each package's swarmd (in this process,
  the in-process wire): every command's exit code and output, its random
  ids replaced by names, equal;
- rafttool's dump of a manager's WAL: the port's tool reads a JAX
  manager's WAL as the JAX tool reads it, and a TLS swarmd's WAL (kept
  under the raft DEK of the node's key file), which the JAX tool cannot
  read;
- each package's external-CA example server signs for the other's
  client;
- the port's control socket carries an answer over asyncio's 64 KiB line
  limit (a 100-replica task-ls), which the JAX package's client refuses;
- swarmd without ``--device`` needs a card for a manager, and says so.
"""

from __future__ import annotations

import asyncio
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import pytest

from tests.conftest import requires_cryptography
from tests.torch_port_copies import cases, free_port, on_cpu, port_copy

ROOTS = {"jax": "swarmkit_tpu", "port": "swarmkit_tpu_torch"}
CLI_CASES = port_copy("test_cli")
DRIVER_CASES = port_copy("test_drivers_and_external")


@pytest.mark.parametrize("case", cases(CLI_CASES))
def test_jax_cli_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(CLI_CASES, case)()


@pytest.mark.parametrize("case", cases(DRIVER_CASES))
def test_jax_driver_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(DRIVER_CASES, case)()


def _m(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


async def _daemon(root: str, tmp: str, *extra: str):
    swarmd = _m(root, "cmd.swarmd")
    sock = os.path.join(tmp, f"{root}.sock")
    args = swarmd.build_parser().parse_args([
        "--state-dir", os.path.join(tmp, root), "--listen-control-api",
        sock, "--node-id", "m1", "--manager", "--election-tick", "4",
        "--backend", "inproc", "--executor", "test", *extra])
    node = await swarmd.run(args)
    node.config.tick_interval = 0.05
    for _ in range(400):
        if node.is_leader() and node.manager.store.find("cluster"):
            break
        await asyncio.sleep(0.05)
    assert node.is_leader()
    return node, sock


async def _stop(node) -> None:
    await node._ctl_server.stop()
    await node.stop()


SESSION = [
    ("cluster-inspect",),
    ("node-ls",),
    ("service-create", "--name", "web", "--image", "nginx", "--replicas",
     "3", "--label", "tier=frontend", "--env", "A=1"),
    ("service-ls",),
    ("service-inspect", "web"),
    ("service-scale", "web", "1"),
    ("secret-create", "db-pass", "--data", "hunter2"),
    ("secret-ls",),
    ("network-create", "--name", "overlay1"),
    ("network-ls",),
    ("node-update", "m1", "--label-add", "zone=a"),
    ("service-inspect", "nope"),
    ("service-rm", "web"),
    ("service-ls",),
]
_STAMPS = re.compile(r'"(created_at|updated_at|timestamp|index)": [0-9.e+-]+')


async def _session(root: str) -> list:
    ctl = _m(root, "cmd.swarmctl")
    out = []
    with tempfile.TemporaryDirectory(prefix="cli-") as tmp:
        node, sock = await _daemon(root, tmp)
        ids: dict = {}
        try:
            for argv in SESSION:
                buf = io.StringIO()
                rc = await ctl.run(ctl.build_parser().parse_args(
                    ["--socket", sock, *argv]), out=buf)
                text = buf.getvalue()
                for o in node.manager.store.find("service") \
                        + node.manager.store.find("secret") \
                        + node.manager.store.find("network") \
                        + node.manager.store.find("cluster"):
                    ids.setdefault(o.id, f"<{o.spec.annotations.name}>")
                for oid, name in ids.items():
                    text = text.replace(oid, name)
                out.append((argv[0], rc, _STAMPS.sub(r'"\1": 0', text)))
                await asyncio.sleep(0.2)
        finally:
            await _stop(node)
    return out


def _normalize(session: list) -> list:
    """Drop what either package draws at random: the root CA, its
    digest, the join tokens, the network keys."""
    out = []
    for cmd, rc, text in session:
        if cmd == "cluster-inspect" and rc == 0:
            d = json.loads(text)
            d["root_ca"] = None
            d["network_bootstrap_keys"] = len(d["network_bootstrap_keys"])
            text = json.dumps(d, sort_keys=True)
        out.append((cmd, rc, text))
    return out


def test_swarmctl_session_like_jax(monkeypatch):
    on_cpu(monkeypatch)
    jax = _normalize(asyncio.run(_session(ROOTS["jax"])))
    port = _normalize(asyncio.run(_session(ROOTS["port"])))
    assert [c for c, *_ in port] == [c for c, *_ in jax]
    for want, got in zip(jax, port):
        assert got == want, want[0]


async def _manager_wal(root: str, state: str) -> None:
    mgr = _m(root, "manager.manager")
    net = _m(root, "raft.transport").Network(seed=2)
    api = _m(root, "api")
    kw = {"device": "cpu"} if root == ROOTS["port"] else {}
    m = mgr.Manager(node_id="m1", addr="m1:4242", network=net,
                    state_dir=state, tick_interval=0.05, election_tick=4,
                    **kw)
    await m.start()
    for _ in range(200):
        if m.is_leader() and m.store.find("cluster"):
            break
        await asyncio.sleep(0.05)
    await m.control_api.create_service(api.ServiceSpec(
        annotations=api.Annotations(name="web"),
        task=api.TaskSpec(container=api.ContainerSpec(image="nginx")),
        replicated=api.ReplicatedService(replicas=1)))
    await asyncio.sleep(0.3)
    await m.stop()


def _dump(root: str, state: str, *extra: str) -> tuple:
    r = subprocess.run([sys.executable, "-m", f"{root}.cmd.rafttool",
                        "--state-dir", state, *extra, "dump-wal"],
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout, r.stderr.strip().splitlines()[-1:]


def test_rafttool_reads_the_jax_wal_as_jax_does(tmp_path):
    state = str(tmp_path / "m1")
    asyncio.run(_manager_wal(ROOTS["jax"], state))
    want = _dump(ROOTS["jax"], state)
    got = _dump(ROOTS["port"], state)
    assert want[0] == 0 and "web" in want[1]
    assert got == want


@requires_cryptography
def test_rafttool_reads_a_tls_daemons_wal(monkeypatch, tmp_path):
    """A manager with a TLS identity keeps its WAL under the raft DEK of
    its key file: the port's rafttool decrypts it with that DEK; the JAX
    package's reads no entry of it."""
    on_cpu(monkeypatch)

    async def go():
        swarmd = _m(ROOTS["port"], "cmd.swarmd")
        args = swarmd.build_parser().parse_args([
            "--state-dir", str(tmp_path / "m1"), "--listen-control-api",
            str(tmp_path / "m1.sock"), "--listen-remote-api",
            f"127.0.0.1:{free_port()}", "--node-id", "m1", "--manager",
            "--election-tick", "4", "--executor", "test"])
        node = await swarmd.run(args)
        try:
            for _ in range(400):
                if node.is_leader() and node.manager.store.find("cluster"):
                    break
                await asyncio.sleep(0.05)
            assert node.security is not None
            api = _m(ROOTS["port"], "api")
            await node.manager.control_api.create_service(api.ServiceSpec(
                annotations=api.Annotations(name="sealed"),
                task=api.TaskSpec(container=api.ContainerSpec(image="img")),
                replicated=api.ReplicatedService(replicas=0)))
            await asyncio.sleep(0.3)
        finally:
            await _stop(node)
    asyncio.run(go())
    state = str(tmp_path / "m1")
    rc, out, err = _dump(ROOTS["port"], state)
    assert rc == 0 and "sealed" in out, err
    assert _dump(ROOTS["jax"], state)[0] != 0


@requires_cryptography
@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_external_ca_example_signs_for_the_other_package(server, client):
    example = _m(ROOTS[server], "cmd.external_ca_example")
    sca, cca = _m(ROOTS[server], "ca"), _m(ROOTS[client], "ca")
    ext = _m(ROOTS[client], "ca.external")
    spec = _m(ROOTS[client], "api.specs").ExternalCA
    signing = sca.RootCA.create()
    httpd, port = example.serve(signing)
    try:
        public = cca.RootCA(signing.cert_pem)
        client_ = ext.ExternalCAClient([spec(url=f"http://127.0.0.1:{port}")],
                                       public)
        csr, _ = cca.create_csr()
        issued = asyncio.run(client_.sign(csr, "node-x", cca.WORKER_ROLE_OU,
                                          "org-1"))
        public.validate_cert_chain(issued.cert_pem)
        assert cca.parse_identity(issued.cert_pem) == \
            sca.parse_identity(issued.cert_pem) == \
            ("node-x", cca.WORKER_ROLE_OU, "org-1")
    finally:
        httpd.shutdown()


def test_control_socket_carries_long_answers(monkeypatch, tmp_path):
    on_cpu(monkeypatch)

    async def go():
        node, sock = await _daemon(ROOTS["port"], str(tmp_path))
        try:
            api = _m(ROOTS["port"], "api")
            svc = await node.manager.control_api.create_service(
                api.ServiceSpec(
                    annotations=api.Annotations(name="big"),
                    task=api.TaskSpec(container=api.ContainerSpec(
                        image="img")),
                    replicated=api.ReplicatedService(replicas=100)))
            for _ in range(400):
                if len(node.manager.store.find("task")) == 100:
                    break
                await asyncio.sleep(0.05)
            results = {}
            for root in ROOTS.values():
                client = _m(root, "cmd.ctl").ControlSocketClient(sock)
                try:
                    tasks = await client.call("task.ls",
                                              service_ids=[svc.id])
                    results[root] = (len(tasks),
                                     len(json.dumps(tasks)) > 65536)
                except ValueError as e:
                    results[root] = str(e)
                finally:
                    await client.close()
            return results
        finally:
            await _stop(node)
    got = asyncio.run(go())
    assert got[ROOTS["port"]] == (100, True)
    assert "limit" in got[ROOTS["jax"]]


def test_swarmd_manager_needs_a_card_without_device(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(_daemon(ROOTS["port"], str(tmp_path)))

    async def on_the_cpu():
        node, _ = await _daemon(ROOTS["port"], str(tmp_path / "cpu"),
                                "--device", "cpu")
        try:
            return node.manager.device.type
        finally:
            await _stop(node)
    os.makedirs(tmp_path / "cpu")
    assert asyncio.run(on_the_cpu()) == "cpu"
