"""The port's certificate authority (ca/) against the JAX package's.

tests/test_ca.py's cases run on the port (tests/torch_port_copies.py).
Then the two packages meet: a certificate or a CSR of either package's
RootCA verifies and signs under the other's, with the same subject and
role; join tokens generated by one parse, pin and refuse alike in the
other; a KeyReadWriter's files, locked by a KEK or not, headers and raft
DEKs included, read back in the other package; a CAServer of each package
takes the same token joins and renewals to the same answers.  Last, the
no-`cryptography` branch in a subprocess that blocks the package: both
packages bootstrap a cluster without a root CA and their key files
cross-read on the hashlib-backed Fernet.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import pathlib
import subprocess
import sys

import pytest

from swarmkit_tpu import ca as jca
from swarmkit_tpu_torch import ca as tca
from tests.conftest import requires_cryptography
from tests.torch_port_copies import cases, on_cpu, port_copy

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_CASES = port_copy("test_ca")
PACKAGES = {"jax": jca, "port": tca}


@pytest.mark.parametrize("case", cases(JAX_CASES))
def test_jax_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(JAX_CASES, case)()


def _subject(pkg, cert_pem: bytes) -> tuple:
    return pkg.parse_identity(cert_pem)


@requires_cryptography
@pytest.mark.parametrize("signer,verifier", [("jax", "port"),
                                             ("port", "jax")])
def test_certificates_cross_verify(signer, verifier):
    s, v = PACKAGES[signer], PACKAGES[verifier]
    root = s.RootCA.create()
    issued = root.issue_node_certificate("node1", s.WORKER_ROLE_OU, "org1")
    other = v.RootCA(root.cert_pem, root.key_pem)
    assert other.digest() == root.digest()
    other.validate_cert_chain(issued.cert_pem)
    assert _subject(v, issued.cert_pem) == _subject(s, issued.cert_pem) \
        == ("node1", v.WORKER_ROLE_OU, "org1")
    # a CSR of the verifier's package signed by the signer's root, and
    # one of the signer's signed by the verifier's copy of that root
    csr, _ = v.create_csr("node9")
    cert = root.issue_node_certificate("node9", s.MANAGER_ROLE_OU, "orgX",
                                       csr_pem=csr).cert_pem
    other.validate_cert_chain(cert)
    csr2, _ = s.create_csr("node10")
    cert2 = other.issue_node_certificate("node10", v.MANAGER_ROLE_OU,
                                         "orgX", csr_pem=csr2).cert_pem
    root.validate_cert_chain(cert2)
    assert _subject(s, cert2) == _subject(v, cert2) \
        == ("node10", s.MANAGER_ROLE_OU, "orgX")
    # a certificate of another root is refused by both copies of this one
    foreign = v.RootCA.create().issue_node_certificate(
        "evil", v.WORKER_ROLE_OU, "org1")
    for pkg, ca in ((s, root), (v, other)):
        with pytest.raises(pkg.CertificateError):
            ca.validate_cert_chain(foreign.cert_pem)


@requires_cryptography
@pytest.mark.parametrize("maker,reader", [("jax", "port"), ("port", "jax")])
def test_tokens_parse_both_ways(maker, reader):
    m, r = PACKAGES[maker], PACKAGES[reader]
    root = m.RootCA.create()
    for secret in (None, "0123456789abcdef0123456789abcdef"):
        token = m.generate_join_token(root, secret)
        a, b = m.parse_join_token(token), r.parse_join_token(token)
        assert (a.version, a.ca_digest, a.secret) \
            == (b.version, b.ca_digest, b.secret)
        assert b.ca_digest == r.RootCA(root.cert_pem).digest()
    cfg_m = importlib.import_module(f"{m.__name__}.config")
    cfg_r = importlib.import_module(f"{r.__name__}.config")
    token = m.generate_join_token(root)
    assert cfg_r.verify_root_digest(root.cert_pem, token)
    assert cfg_r.pinned_cert(root.cert_pem, token) \
        == cfg_m.pinned_cert(root.cert_pem, token)
    assert not cfg_r.verify_root_digest(m.RootCA.create().cert_pem, token)
    for bad in ("", "SWMTKN-2-abc-def", "SWMTKN-1-zz", token + "-x"):
        errs = []
        for p in (m, r):
            try:
                p.parse_join_token(bad)
                errs.append(None)
            except p.InvalidJoinToken as e:
                errs.append(str(e))
        assert errs[0] == errs[1], bad


@pytest.mark.parametrize("kek", [None, b"SWMKEY-1-kek"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_keyreadwriter_files_cross_read(writer, reader, kek, tmp_path):
    w, r = PACKAGES[writer], PACKAGES[reader]
    kw = w.KeyReadWriter(str(tmp_path), kek=kek)
    kw.write(b"CERT-PEM", b"KEY-PEM")
    kw.write_root_ca(b"ROOT-PEM")
    kw.set_raft_deks(b"d" * 32, [b"o" * 32])
    kw.set_headers({**kw.get_headers(), "extra": b"\x00\x01"})
    kr = r.KeyReadWriter(str(tmp_path), kek=kek)
    assert kr.read() == kw.read() == (b"CERT-PEM", b"KEY-PEM")
    assert kr.read_root_ca() == b"ROOT-PEM"
    deks = kw.get_raft_deks()
    assert kr.get_raft_deks() == deks == (b"d" * 32, [b"o" * 32])
    assert kr.get_headers() == kw.get_headers()
    assert kr.is_encrypted() == kw.is_encrypted() == (kek is not None)
    if kek is not None:
        # the wrong KEK fails alike in both
        for p in (w, r):
            with pytest.raises(Exception):
                p.KeyReadWriter(str(tmp_path), kek=b"wrong").read()
    # the reader re-locks under a new KEK; the writer's package opens it
    kr.set_kek(b"SWMKEY-1-other")
    again = w.KeyReadWriter(str(tmp_path), kek=b"SWMKEY-1-other")
    assert again.read() == (b"CERT-PEM", b"KEY-PEM")
    assert again.get_raft_deks() == deks


def _ca_script(pkg_name: str) -> list:
    """CAServer token joins and a renewal on a FakeClock: each step's
    answer, without what either package draws at random."""
    def m(name):
        return importlib.import_module(f"{pkg_name}.{name}")
    ca, api = m("ca"), m("api")
    store_mod, clock_mod = m("store.memory"), m("utils.clock")
    out = []

    async def go():
        clock = clock_mod.FakeClock()
        store = store_mod.MemoryStore(clock=clock.now)
        root = ca.RootCA.create()
        wtok = ca.generate_join_token(root, "1" * 32)
        mtok = ca.generate_join_token(root, "2" * 32)
        cluster = api.Cluster(id="org1", spec=api.ClusterSpec(
            annotations=api.Annotations(name="default")))
        cluster.root_ca.join_token_worker = wtok
        cluster.root_ca.join_token_manager = mtok
        await store.update(lambda tx: tx.create(cluster))
        server = ca.CAServer(store, root, org="org1", clock=clock)
        await server.start()
        try:
            ids, keys, certs = {}, {}, {}
            for name, tok in (("w", wtok), ("m", mtok), ("bad", "SWMTKN-1-"
                              + root.digest() + "-" + "0" * 32)):
                csr, keys[name] = ca.create_csr(name)
                try:
                    nid, issued = await server.issue_node_certificate(
                        csr, tok, addr=f"{name}:1", requested_node_id=name)
                except Exception as e:
                    out.append((name, type(e).__name__))
                    continue
                ids[name], certs[name] = nid, issued.cert_pem
                out.append((name, ca.parse_identity(issued.cert_pem)[1:],
                            nid == name))
            for _ in range(5):
                await asyncio.sleep(0)
            nodes = sorted((n.id, int(n.role), int(n.spec.desired_role),
                            int(n.certificate.status_state), n.certificate.cn)
                           for n in store.find("node"))
            out.append(("nodes", nodes))
            csr = ca.create_csr_from_key(keys["w"], ids["w"])
            renewed = await server.renew_node_certificate(
                ids["w"], certs["w"], csr)
            out.append(("renewed", ca.parse_identity(renewed.cert_pem)))
        finally:
            await server.stop()
    asyncio.run(go())
    return out


@requires_cryptography
def test_ca_server_answers_like_jax():
    assert _ca_script("swarmkit_tpu_torch") == _ca_script("swarmkit_tpu")


_NO_CRYPTOGRAPHY = r"""
import asyncio, json, sys, tempfile
sys.modules["cryptography"] = None
from swarmkit_tpu.ca import certificates as jc, keyreadwriter as jk
from swarmkit_tpu_torch.ca import certificates as tc, keyreadwriter as tk
from swarmkit_tpu.manager.manager import Manager as JM
from swarmkit_tpu.raft.transport import Network as JN
from swarmkit_tpu_torch.manager.manager import Manager as TM
from swarmkit_tpu_torch.raft.transport import Network as TN
assert not jc.HAVE_CRYPTOGRAPHY and not tc.HAVE_CRYPTOGRAPHY
out = {}
for a, b, name in ((jk, tk, "jax->port"), (tk, jk, "port->jax")):
    d = tempfile.mkdtemp()
    w = a.KeyReadWriter(d, kek=b"k")
    w.write(b"C", b"K")
    w.set_raft_deks(b"d" * 32, [])
    r = b.KeyReadWriter(d, kek=b"k")
    out[name] = [r.read() == (b"C", b"K"), r.get_raft_deks()[0] == b"d" * 32,
                 r.is_encrypted()]

async def seed(M, N, **kw):
    m = M(node_id="m1", addr="m1:1", network=N(seed=1),
          state_dir=tempfile.mkdtemp(), tick_interval=0.02,
          election_tick=3, **kw)
    await m.start()
    for _ in range(500):
        if m.is_leader() and m.store.find("cluster"):
            break
        await asyncio.sleep(0.02)
    cl = m.store.find("cluster")[0]
    view = [cl.id, bool(cl.root_ca.ca_cert), cl.root_ca.join_token_worker,
            m.ca_server is None]
    await m.stop()
    return view

out["jax"] = asyncio.run(seed(JM, JN))
out["port"] = asyncio.run(seed(TM, TN, device="cpu"))
print(json.dumps(out))
"""


def test_no_cryptography_branch_in_a_subprocess():
    res = subprocess.run([sys.executable, "-c", _NO_CRYPTOGRAPHY], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["jax->port"] == out["port->jax"] == [True, True, True]
    assert out["port"] == out["jax"] == ["cluster-default", False, "", True]
