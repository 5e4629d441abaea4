"""CA server: join-token-gated certificate issuance + pending-cert
reconciliation.

Reference: ca/server.go (917 LoC) — IssueNodeCertificate (:236): a valid
join token admits a new node (role = which token matched), creating its
node record with the CSR PENDING; the signing loop (Run :422 +
reconciler) signs PENDING certificates; renewals derive the role from
Node.spec.desired_role so promotion/demotion flows through certificate
renewal.  NodeCertificateStatus (:180) lets joiners poll for their signed
certificate.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import MembershipState, NodeRole, NodeSpec, Annotations
from swarmkit_tpu_torch.api.objects import (
    Node as ApiNode, NodeStatus, RootRotation,
)
from swarmkit_tpu_torch.api.types import Certificate, IssuanceState
from swarmkit_tpu_torch.ca.certificates import (
    MANAGER_ROLE_OU, WORKER_ROLE_OU, CertificateError, IssuedCertificate,
    RootCA, is_issued_by, parse_identity,
)
from swarmkit_tpu_torch.ca.config import InvalidJoinToken, parse_join_token
from swarmkit_tpu_torch.store.memory import Event, MemoryStore, match
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock
from swarmkit_tpu_torch.utils.identity import new_id

log = logging.getLogger("swarmkit_tpu_torch.ca.server")

_ROLE_OU = {NodeRole.MANAGER: MANAGER_ROLE_OU, NodeRole.WORKER: WORKER_ROLE_OU}


class CAServer:
    def __init__(self, store: MemoryStore, root_ca: RootCA, org: str,
                 clock: Optional[Clock] = None) -> None:
        # signing goes through _sign(): local root key when present, else
        # the cluster's configured external CFSSL CAs (ca/external.go)
        self.store = store
        self.root_ca = root_ca
        self.org = org
        self.clock = clock or SystemClock()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._rot_cache: Optional[RootCA] = None

    # ------------------------------------------------------------------
    # Root rotation (reference: ca/server.go rotation handling +
    # ca/reconciler.go rootRotationReconciler + integration
    # TestSuccessfulRootRotation).  Protocol: the NEW root's certificate
    # is cross-signed by the OLD root, issuance switches to the new key
    # with the cross-signed cert appended (old-trusting verifiers still
    # chain), the trust bundle carries old+new, nodes with old-root certs
    # are marked ROTATE so their renewers re-issue, and once every node
    # certificate chains to the new root the cluster flips to it and
    # regenerates join tokens.
    def _rotation(self) -> Optional[RootRotation]:
        cl = self._cluster()
        rot = cl.root_ca.root_rotation if cl is not None else None
        return rot or None

    def _rotation_root(self) -> Optional[RootCA]:
        rot = self._rotation()
        if not rot:
            self._rot_cache = None
            return None
        if self._rot_cache is None \
                or self._rot_cache.cert_pem != rot.ca_cert:
            self._rot_cache = RootCA(rot.ca_cert, rot.ca_key)
        return self._rot_cache

    async def start_root_rotation(self, new_cert_pem: bytes = b"",
                                  new_key_pem: bytes = b"") -> None:
        """Begin rotating the cluster root CA to ``new_cert``/``new_key``
        (generated when omitted)."""
        if not self.root_ca.can_sign:
            raise CertificateError(
                "root rotation requires the local signing key "
                "(external-CA rotation is driven by re-configuring the "
                "external CA set)")
        if self._rotation() is not None:
            raise CertificateError(
                "a root rotation is already in progress — wait for it to "
                "finalize (re-rotating would orphan certificates already "
                "issued under the incoming root)")
        if new_cert_pem:
            new_root = RootCA(new_cert_pem, new_key_pem or None)
            if not new_root.can_sign:
                raise CertificateError("new root needs a signing key")
        else:
            new_root = RootCA.create()
        cross = self.root_ca.cross_sign_ca_certificate(new_root.cert_pem)

        def txn(tx):
            cl = tx.find("cluster")[0]
            cl = cl.copy()
            cl.root_ca.root_rotation = RootRotation(
                ca_cert=new_root.cert_pem,
                ca_key=new_root.key_pem or b"",
                cross_signed_ca_cert=cross)
            tx.update(cl)
            # every node holding an old-root cert renews (ROTATE wakes the
            # node-side TLSRenewer through its session node-watch); nodes
            # with NO recorded cert (the bootstrap manager self-issued its
            # identity before any CA server existed) are marked too — their
            # renewal both rotates the identity and records it
            for n in tx.find("node"):
                if not n.certificate.certificate or not is_issued_by(
                        n.certificate.certificate, new_root.cert_pem):
                    n = n.copy()
                    n.certificate.status_state = int(IssuanceState.ROTATE)
                    tx.update(n)
        await self.store.update(txn)
        await self._maybe_finalize_rotation()

    async def _maybe_finalize_rotation(self) -> None:
        rot = self._rotation()
        if not rot:
            return
        new_cert = rot.ca_cert
        nodes = self.store.find("node")
        # cheap flag scan first: signature checks (ECDSA verify per node)
        # run only once the marked set has drained, keeping convergence
        # O(N) instead of O(N^2) verifies across the rotation
        if any(n.certificate.status_state == int(IssuanceState.ROTATE)
               for n in nodes):
            return  # a marked node has not renewed yet
        for n in nodes:
            if n.certificate.certificate \
                    and not is_issued_by(n.certificate.certificate,
                                         new_cert):
                return  # still converging
        from swarmkit_tpu_torch.ca.config import generate_join_token

        new_root = RootCA(rot.ca_cert, rot.ca_key)

        def txn(tx):
            cl = tx.find("cluster")[0]
            cl = cl.copy()
            cl.root_ca.ca_cert = new_root.cert_pem
            cl.root_ca.ca_key = new_root.key_pem or b""
            cl.root_ca.ca_cert_hash = new_root.digest()
            cl.root_ca.join_token_worker = generate_join_token(new_root)
            cl.root_ca.join_token_manager = generate_join_token(new_root)
            cl.root_ca.root_rotation = None
            tx.update(cl)
        await self.store.update(txn)
        self.root_ca = new_root
        self._rot_cache = None
        log.info("root CA rotation complete; join tokens regenerated")

    # ------------------------------------------------------------------
    def _cluster(self):
        clusters = self.store.find("cluster")
        return clusters[0] if clusters else None

    def _role_for_token(self, token: str) -> NodeRole:
        """Which join token matched decides the role
        (reference: server.go checkNodeCertificate / token switch).
        Comparisons are constant-time: join tokens are bearer secrets."""
        import hmac

        parsed = parse_join_token(token)
        if not hmac.compare_digest(parsed.ca_digest, self.root_ca.digest()):
            raise InvalidJoinToken("join token CA digest mismatch")
        cluster = self._cluster()
        if cluster is None:
            raise InvalidJoinToken("no cluster object")
        if hmac.compare_digest(token,
                               cluster.root_ca.join_token_manager or ""):
            return NodeRole.MANAGER
        if hmac.compare_digest(token,
                               cluster.root_ca.join_token_worker or ""):
            return NodeRole.WORKER
        raise InvalidJoinToken("join token not recognized")

    # ------------------------------------------------------------------
    def _external_client(self):
        from swarmkit_tpu_torch.ca.external import ExternalCAClient

        cluster = self._cluster()
        cas = (cluster.spec.ca_config.external_cas
               if cluster is not None and cluster.spec.ca_config else [])
        client = ExternalCAClient(cas, self.root_ca)
        return client if client.configured else None

    async def _sign(self, node_id: str, role_ou: str, csr_pem: bytes
                    ) -> IssuedCertificate:
        """Local root key when available, else the cluster's external CA
        (reference: server.go signNodeCert -> ca/external.go)."""
        rot_root = self._rotation_root()
        if rot_root is not None and rot_root.can_sign:
            issued = rot_root.issue_node_certificate(
                node_id, role_ou, self.org, csr_pem=csr_pem,
                expiry=self._cert_expiry())
            # append the cross-signed new-root cert: verifiers that still
            # trust only the OLD root chain through it
            cross = self._rotation().cross_signed_ca_cert
            return IssuedCertificate(
                cert_pem=issued.cert_pem + cross, key_pem=issued.key_pem,
                root_bundle=self.get_root_ca_certificate())
        if self.root_ca.can_sign:
            issued = self.root_ca.issue_node_certificate(
                node_id, role_ou, self.org, csr_pem=csr_pem,
                expiry=self._cert_expiry())
            return IssuedCertificate(
                cert_pem=issued.cert_pem, key_pem=issued.key_pem,
                root_bundle=self.get_root_ca_certificate())
        ext = self._external_client()
        if ext is None:
            raise CertificateError(
                "root CA has no signing key and no external CA is "
                "configured")
        return await ext.sign(csr_pem, node_id, role_ou, self.org)

    async def issue_node_certificate(self, csr_pem: bytes, token: str,
                                     addr: str = "",
                                     requested_node_id: str = ""
                                     ) -> tuple[str, IssuedCertificate]:
        """Admit a new node via join token (reference: server.go:236).
        ``requested_node_id`` is honored only when vacant (test harnesses
        want stable names; the reference always assigns a fresh id)."""
        role = self._role_for_token(token)
        node_id = new_id()
        if requested_node_id \
                and self.store.get("node", requested_node_id) is None:
            node_id = requested_node_id
        issued = await self._sign(node_id, _ROLE_OU[role], csr_pem)
        node = ApiNode(
            id=node_id,
            spec=NodeSpec(annotations=Annotations(name=node_id),
                          desired_role=role,
                          membership=MembershipState.ACCEPTED),
            role=role,
            certificate=Certificate(
                role=role, csr=csr_pem,
                status_state=int(IssuanceState.ISSUED),
                certificate=issued.cert_pem, cn=node_id),
            status=NodeStatus(addr=addr))
        await self.store.update(lambda tx: tx.create(node))
        return node_id, issued

    async def renew_node_certificate(self, node_id: str,
                                     old_cert_pem: bytes,
                                     csr_pem: bytes) -> IssuedCertificate:
        """Renewal: identity proven by the old cert AND a CSR signed with
        the certificate's own key (possession proof — the reference proves
        possession via the mutual-TLS channel); role comes from
        Node.spec.desired_role (reference: issueRenewCertificate)."""
        from cryptography import x509 as _x509
        from cryptography.hazmat.primitives import serialization as _ser

        cn, _, org = parse_identity(old_cert_pem)
        try:
            old_cert = self.root_ca.validate_cert_chain(old_cert_pem)
        except CertificateError:
            rot_root = self._rotation_root()
            if rot_root is None:
                raise
            # mid-rotation: the presenting cert may already chain to the
            # new root
            old_cert = rot_root.validate_cert_chain(old_cert_pem)
        if cn != node_id or org != self.org:
            raise CertificateError("certificate identity mismatch")
        csr = _x509.load_pem_x509_csr(csr_pem)
        if not csr.is_signature_valid:
            raise CertificateError("renewal CSR signature invalid")
        pub = lambda k: k.public_bytes(
            _ser.Encoding.PEM, _ser.PublicFormat.SubjectPublicKeyInfo)
        if pub(csr.public_key()) != pub(old_cert.public_key()):
            raise CertificateError(
                "renewal CSR key does not match the certificate key")
        node = self.store.get("node", node_id)
        if node is None:
            raise CertificateError(f"node {node_id} not registered")
        role = NodeRole(node.spec.desired_role)
        issued = await self._sign(node_id, _ROLE_OU[role], csr_pem)

        def txn(tx):
            cur = tx.get("node", node_id)
            if cur is None:
                return
            cur = cur.copy()
            cur.role = role
            cur.certificate = Certificate(
                role=role, status_state=int(IssuanceState.ISSUED),
                certificate=issued.cert_pem, cn=node_id)
            tx.update(cur)
        await self.store.update(txn)
        return issued

    def node_certificate_status(self, node_id: str
                                ) -> tuple[IssuanceState, bytes]:
        """reference: NodeCertificateStatus server.go:180."""
        node = self.store.get("node", node_id)
        if node is None:
            raise CertificateError(f"node {node_id} not found")
        return (IssuanceState(node.certificate.status_state),
                node.certificate.certificate)

    def get_root_ca_certificate(self) -> bytes:
        """The trust bundle to distribute: the current root, plus the
        incoming root while a rotation is converging (reference:
        GetRootCACertificate ca.proto)."""
        rot = self._rotation()
        if rot:
            return self.root_ca.cert_pem + rot.ca_cert
        return self.root_ca.cert_pem

    def _cert_expiry(self) -> float:
        cluster = self._cluster()
        if cluster is not None:
            return cluster.spec.ca_config.node_cert_expiry
        from swarmkit_tpu_torch.ca.certificates import DEFAULT_NODE_CERT_EXPIRATION

        return DEFAULT_NODE_CERT_EXPIRATION

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Pending-cert reconciliation loop (reference: Run server.go:422
        + ca/reconciler.go)."""
        self._watcher = self.store.watch(match(kind="node"))
        await self._sign_pending()
        # a leader failover mid-rotation must not wedge it: the last
        # renewal may have landed just before the old leader died
        await self._maybe_finalize_rotation()
        self._running = True
        self._task = asyncio.get_running_loop().create_task(
            self._run(self._watcher))

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        if getattr(self, "_watcher", None) is not None:
            self._watcher.close()
            self._watcher = None

    async def _run(self, watcher) -> None:
        try:
            async for ev in watcher:
                if not self._running:
                    return
                if isinstance(ev, Event) and ev.action != "remove" \
                        and ev.object.certificate.status_state \
                        == IssuanceState.PENDING:
                    await self._sign_pending()
                if isinstance(ev, Event) \
                        and (ev.action == "remove"
                             or ev.object.certificate.status_state
                             == IssuanceState.ISSUED):
                    # a renewal — or the REMOVAL of the last old-root
                    # node — may be what the rotation was waiting on
                    await self._maybe_finalize_rotation()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("CA server loop crashed")

    async def _sign_pending(self) -> None:
        pending = [n for n in self.store.find("node")
                   if n.certificate.status_state == IssuanceState.PENDING
                   and n.certificate.csr]
        for n in pending:
            try:
                issued = await self._sign(
                    n.id, _ROLE_OU[NodeRole(n.spec.desired_role)],
                    n.certificate.csr)
            except Exception as e:
                log.warning("cannot sign CSR for %s: %s", n.id, e)
                continue

            role = NodeRole(n.spec.desired_role)

            def txn(tx, nid=n.id, cert=issued.cert_pem, role=role):
                cur = tx.get("node", nid)
                if cur is None:
                    return
                cur = cur.copy()
                cur.role = role
                cur.certificate.certificate = cert
                cur.certificate.status_state = int(IssuanceState.ISSUED)
                cur.certificate.role = role
                cur.certificate.cn = nid
                tx.update(cur)
            await self.store.update(txn)
