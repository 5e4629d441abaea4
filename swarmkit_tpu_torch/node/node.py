"""Node lifecycle: one process-level member running an agent and, when its
role demands, a manager — with automatic promotion/demotion.

Reference: node/node.go (1352 LoC) — New (:194), Start (:251), run (:272):
load identity, start the agent (runAgent :559), supervise the manager
(superviseManager :1080: waitRole("manager") → runManager), tear the
manager down on demotion.  The reference learns its role from certificate
renewals; here the role arrives on the dispatcher session's node object
(the CA layer adds the certificate path on top of this seam).

The port's own copy of the JAX package's node/node.py.  It differs in two
places: ``NodeConfig.device`` names where a manager of this node runs its
scheduler's placement kernel (the card unless ``"cpu"``), and the Manager
is imported when the node first runs one, so a worker's process never
imports torch (seconds of every daemon's start on the card's host).
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional

from swarmkit_tpu_torch.agent import Agent, AgentConfig
from swarmkit_tpu_torch.agent.exec import Executor
from swarmkit_tpu_torch.api import NodeRole, Peer
from swarmkit_tpu_torch.ca import (
    MANAGER_ROLE_OU, KeyReadWriter, RootCA, SecurityConfig, TLSRenewer,
    create_csr, parse_identity,
)
from swarmkit_tpu_torch.node.connectionbroker import ConnectionBroker
from swarmkit_tpu_torch.node.remotes import Remotes
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock
from swarmkit_tpu_torch.utils.identity import new_id

if TYPE_CHECKING:
    from swarmkit_tpu_torch.manager.manager import Manager

log = logging.getLogger("swarmkit_tpu_torch.node")


class _RenewClient:
    """Renews via the cluster CA and persists the result
    (reference: agent-side CA client in ca/renewer.go)."""

    def __init__(self, node: "Node") -> None:
        self.node = node

    async def renew_node_certificate(self, node_id: str, cert_pem: bytes):
        from swarmkit_tpu_torch.ca import create_csr_from_key

        ca = self.node._ca_client()
        if ca is None:
            raise RuntimeError("no CA reachable for renewal")
        csr = create_csr_from_key(self.node.security.key_pem, node_id)
        issued = await ca.renew_node_certificate(node_id, cert_pem, csr)
        if self.node.keyrw is not None:
            self.node.keyrw.write(issued.cert_pem,
                                  self.node.security.key_pem)
        if issued.root_bundle:
            # a root rotation is distributing new trust: persist it and
            # refresh the in-memory trust store (old+new during the
            # transition, new-only once the rotation finalizes)
            from swarmkit_tpu_torch.ca import RootCA

            if self.node.keyrw is not None:
                self.node.keyrw.write_root_ca(issued.root_bundle)
            self.node.security.root_ca = RootCA(issued.root_bundle)
        return issued


@dataclass
class NodeConfig:
    """reference: node.Config node/node.go:194."""

    node_id: str
    state_dir: str
    executor: Executor
    network: object                      # raft transport Network
    dialer: Callable[[str], Optional[Manager]]   # addr -> Manager lookup
    listen_addr: str = ""
    # address peers should DIAL (reference swarmd --advertise-remote-api):
    # differs from listen_addr when binding a wildcard/NAT-internal address
    advertise_addr: str = ""
    join_addr: str = ""
    join_token: str = ""
    is_manager: bool = False             # initial role
    force_new_cluster: bool = False
    unlock_key: Optional[bytes] = None   # autolock KEK for the node key
    tick_interval: float = 1.0
    election_tick: int = 10
    heartbeat_tick: int = 1
    clock: Optional[Clock] = None
    seed: int = 0
    # raft Transport selection (raft/node.py NodeOpts.transport_factory):
    # None = in-process Transport; DeviceMeshTransport (with a
    # DeviceMeshNet network) runs the manager quorum over the device
    # mailbox wire
    transport_factory: object = None
    # where the manager's scheduler kernel (sched_place) runs: None = the
    # CUDA card, "cpu" = its plain version (tests)
    device: object = None


class Node:
    def __init__(self, config: NodeConfig) -> None:
        self.config = config
        self.clock = config.clock or SystemClock()
        self.node_id = config.node_id
        # self.addr is what this node ADVERTISES (raft member context, CSR,
        # manager address book); the listener binds listen_addr separately
        self.addr = (config.advertise_addr or config.listen_addr
                     or f"{config.node_id}:4242")
        self.manager: Optional[Manager] = None
        self.security: Optional[SecurityConfig] = None
        self.keyrw: Optional[KeyReadWriter] = None
        self.remotes = Remotes()
        if config.join_addr:
            self.remotes.observe(Peer(addr=config.join_addr))
        self.broker = ConnectionBroker(
            self.remotes, config.dialer, lambda: self._running_manager())
        self.agent: Optional[Agent] = None
        self._renewer: Optional[TLSRenewer] = None
        self._desired_manager = config.is_manager
        self._role_evt = asyncio.Event()
        self._supervisor: Optional[asyncio.Task] = None
        self._running = False

    # ------------------------------------------------------------------
    def _running_manager(self) -> Optional[Manager]:
        m = self.manager
        return m if m is not None and m._running else None

    def is_manager(self) -> bool:
        return self._running_manager() is not None

    def is_leader(self) -> bool:
        m = self._running_manager()
        return m is not None and m.is_leader()

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _ca_client(self):
        """The leader's CA server, resolved like any agent-side RPC."""
        from swarmkit_tpu_torch.node.connectionbroker import NoManagerError

        try:
            return self.broker.select_ca()
        except NoManagerError:
            return None

    @staticmethod
    def _cert_has_tls_san(cert_pem: bytes) -> bool:
        from cryptography import x509

        from swarmkit_tpu_torch.ca.certificates import (
            TLS_SERVER_NAME, cert_from_pem,
        )

        try:
            san = cert_from_pem(cert_pem).extensions.get_extension_for_class(
                x509.SubjectAlternativeName)
        except x509.ExtensionNotFound:
            return False
        return TLS_SERVER_NAME in san.value.get_values_for_type(x509.DNSName)

    async def _load_security_config(self) -> None:
        """Obtain (or restore) this node's TLS identity
        (reference: loadSecurityConfig node/node.go:305 — may block on the
        CA join; sets node id + role from the certificate)."""
        state_dir = self.config.state_dir
        if state_dir == ":memory:":
            import tempfile

            self._cert_tmp = tempfile.TemporaryDirectory(
                prefix=f"swarmkit-certs-{self.node_id}-")
            cert_dir = self._cert_tmp.name
        else:
            cert_dir = os.path.join(state_dir, "certificates")
        self.keyrw = KeyReadWriter(cert_dir, kek=self.config.unlock_key)

        cert, key = self.keyrw.read()
        root_pem = self.keyrw.read_root_ca()
        if cert and key and root_pem:
            node_id, role_ou, org = parse_identity(cert)
            self.node_id = node_id
            self.security = SecurityConfig(RootCA(root_pem), node_id,
                                           role_ou, org, cert, key)
            self._desired_manager = role_ou == MANAGER_ROLE_OU
            # Migration: certificates issued before TLS SANs existed fail
            # gRPC hostname checks when used as SERVER certs. They still
            # work as CLIENT certs (no hostname check), so the renewal RPC
            # goes through — force it immediately (start() wires the
            # renewer after this returns).
            self._needs_cert_refresh = not self._cert_has_tls_san(cert)
            if self._needs_cert_refresh:
                log.warning(
                    "node %s: stored certificate lacks the TLS SAN; "
                    "forcing renewal so peers can dial this node",
                    self.node_id)
            return

        if self.config.join_token and self.config.join_addr:
            # remote CA join (reference: RequestAndSaveNewCertificates)
            csr_pem, key_pem = create_csr()
            ca = None
            for _ in range(200):
                ca = self._ca_client()
                if ca is not None:
                    break
                await self.clock.sleep(0.05)
            if ca is None:
                raise RuntimeError("cannot reach a CA to join the cluster")
            node_id, issued = await ca.issue_node_certificate(
                csr_pem, self.config.join_token, addr=self.addr,
                requested_node_id=self.node_id)
            root_pem = ca.get_root_ca_certificate()
            # Join-token pin: the fetched bundle MUST contain a cert whose
            # digest matches the SWMTKN pin, and ONLY that cert becomes
            # trust from this unauthenticated fetch (a MITM could append a
            # rogue root to the bundle otherwise).  The full rotation
            # bundle, if any, is installed below from the issuance
            # response, which rode a channel verified against the pin.
            from swarmkit_tpu_torch.ca.config import pinned_cert

            pin = pinned_cert(root_pem, self.config.join_token)
            if pin is None:
                raise RuntimeError(
                    "root CA digest from the remote CA does not match the "
                    "join token pin — refusing to join")
            root_pem = issued.root_bundle or pin
            self.keyrw.write_root_ca(root_pem)
            self.keyrw.write(issued.cert_pem, key_pem)
            self.node_id = node_id
            _, role_ou, org = parse_identity(issued.cert_pem)
            self.security = SecurityConfig(RootCA(root_pem), node_id,
                                           role_ou, org, issued.cert_pem,
                                           key_pem)
            self._desired_manager = role_ou == MANAGER_ROLE_OU
            return

        if self.config.is_manager and self.config.join_addr:
            # a manager joining an existing cluster without a token gets no
            # identity here (legacy/test path) — minting an unrelated root
            # CA would break the org == cluster-id invariant
            log.warning("manager %s joining without a join token; running "
                        "without a certificate identity", self.node_id)
            return

        if self.config.is_manager:
            # bootstrap: self-signed root CA; the manager seeds the cluster
            # from it and the org becomes the cluster id (reference:
            # node.go bootstrap path in loadSecurityConfig)
            from swarmkit_tpu_torch.ca.certificates import HAVE_CRYPTOGRAPHY
            if not HAVE_CRYPTOGRAPHY:
                log.warning("manager %s: cryptography unavailable; running "
                            "without a certificate identity", self.node_id)
                return
            root = RootCA.create()
            org = "cluster-" + new_id()
            issued = root.issue_node_certificate(
                self.node_id, MANAGER_ROLE_OU, org)
            self.keyrw.write_root_ca(root.cert_pem)
            self.keyrw.write(issued.cert_pem, issued.key_pem)
            self.security = SecurityConfig(
                root, self.node_id, MANAGER_ROLE_OU, org,
                issued.cert_pem, issued.key_pem)
        # else: no token, not a manager — legacy identityless worker; the
        # harness (or operator) must have pre-created the node record

    async def start(self) -> None:
        """reference: node.Start node/node.go:251 → run :272."""
        self._running = True
        await self._load_security_config()
        # the restored certificate's role wins over the configured one
        # (reference: role is derived from the cert, node.go:305)
        if self._desired_manager:
            await self._start_manager()
        if self.security is not None:
            self._renewer = TLSRenewer(self.security,
                                       _RenewClient(self),
                                       clock=self.clock)
            self._renewer.start()
            if getattr(self, "_needs_cert_refresh", False):
                self._renewer.renew_soon()
        self.agent = Agent(AgentConfig(
            node_id=self.node_id,
            executor=self.config.executor,
            connect=self.broker.select_dispatcher,
            connect_logs=self.broker.select_logbroker,
            addr=self.addr,
            db_path=os.path.join(self.config.state_dir, "tasks.db")
            if self.config.state_dir != ":memory:" else ":memory:",
            clock=self.clock,
            on_node_change=self._on_node_change,
            on_managers_change=self._on_managers_change))
        await self.agent.start()
        self._supervisor = asyncio.get_running_loop().create_task(
            self._supervise_manager())

    async def stop(self) -> None:
        self._running = False
        self._cancel_role_watches()
        # embedder-attached background tasks (e.g. swarmd's autolock
        # bootstrap) die with the node instead of outliving it
        for t in getattr(self, "_aux_tasks", ()):
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        if getattr(self, "_renewer", None) is not None:
            await self._renewer.stop()
            self._renewer = None
        if self._supervisor is not None:
            self._supervisor.cancel()
            try:
                await self._supervisor
            except (asyncio.CancelledError, Exception):
                pass
            self._supervisor = None
        if self.agent is not None:
            await self.agent.stop()
            self.agent = None
        if self.manager is not None:
            await self.manager.stop()
            self.manager = None
        # close any gRPC RemoteManager clients the dialer created
        for rm in getattr(self, "_remote_managers", {}).values():
            try:
                await rm.close()
            except Exception:
                pass
        self._remote_managers = {}

    # ------------------------------------------------------------------
    def _on_node_change(self, node) -> None:
        """Role flips observed via the session stream
        (reference: the cert-renewal waitRole seam node/node.go:933; the
        renewal forcing mirrors renewer.go SetExpectedRole)."""
        self._set_desired_role(manager=node.role == NodeRole.MANAGER)
        # a ROTATE-marked certificate means the cluster root is rotating:
        # renew NOW so the rotation can converge (reference:
        # rootRotationReconciler marking + renewer pickup)
        from swarmkit_tpu_torch.api.types import IssuanceState

        if self._renewer is not None and node.certificate is not None \
                and node.certificate.status_state \
                == int(IssuanceState.ROTATE):
            self._renewer.renew_soon()

    def _on_managers_change(self, managers) -> None:
        for wp in managers:
            self.remotes.observe(wp.peer)

    async def _supervise_manager(self) -> None:
        """reference: superviseManager node/node.go:1080."""
        try:
            while self._running:
                await self._role_evt.wait()
                self._role_evt.clear()
                if self._desired_manager and self.manager is None:
                    log.info("node %s promoted; starting manager",
                             self.node_id)
                    try:
                        await self._start_manager(join=True)
                    except Exception:
                        log.exception("manager start failed; will retry")
                        if self.manager is not None:
                            try:
                                await self.manager.stop()
                            except Exception:
                                pass
                            self.manager = None
                        self._role_evt.set()
                        await self.clock.sleep(1.0)
                elif not self._desired_manager and self.manager is not None:
                    log.info("node %s demoted; stopping manager",
                             self.node_id)
                    self._cancel_role_watches()
                    m, self.manager = self.manager, None
                    await m.stop()
        except asyncio.CancelledError:
            pass

    async def _start_manager(self, join: bool = False) -> None:
        join_addr = self.config.join_addr
        if join:
            # join via the current leader if we know one
            join_addr = self._leader_addr() or join_addr
        state_dir = self.config.state_dir
        if state_dir == ":memory:":
            # raft storage is always file-backed; give ephemeral nodes a
            # throwaway dir instead of a literal ":memory:" path in cwd
            import tempfile

            self._ephemeral_dir = tempfile.TemporaryDirectory(
                prefix=f"swarmkit-{self.node_id}-")
            state_dir = self._ephemeral_dir.name
        # raft storage appends its own "raft" subdir (raft/storage.py)
        encrypter, decrypter = self._raft_dek_crypters()
        from swarmkit_tpu_torch.manager.manager import Manager

        self.manager = Manager(
            node_id=self.node_id, addr=self.addr,
            network=self.config.network, state_dir=state_dir,
            clock=self.clock, join_addr=join_addr,
            force_new_cluster=self.config.force_new_cluster,
            tick_interval=self.config.tick_interval,
            election_tick=self.config.election_tick,
            heartbeat_tick=self.config.heartbeat_tick,
            seed=self.config.seed, security=self.security,
            encrypter=encrypter, decrypter=decrypter,
            transport_factory=self.config.transport_factory,
            device=self.config.device)
        await self.manager.start()
        # Demotion safety net: the dispatcher session is the primary
        # role-change channel, but during a demotion the session churns
        # with leadership at the exact moment the role flips, and by then
        # this node's raft member is already removed — so its local store
        # never sees the flip either. Member removal itself is therefore
        # the authoritative demotion signal (reference: superviseManager
        # treats ErrMemberRemoved as demotion, node/node.go:1080).
        self._removal_watch = asyncio.get_running_loop().create_task(
            self._watch_member_removal(self.manager))
        self._autolock_watch = asyncio.get_running_loop().create_task(
            self._watch_autolock(self.manager))

    async def _watch_autolock(self, manager) -> None:
        """Apply the cluster's manager autolock KEK to this node's key
        store as it changes in the replicated state (reference:
        manager.go handleKEKChange / keyreadwriter RotateKEK).  With
        autolock on, a restarted manager cannot load its TLS key without
        --unlock-key."""
        from swarmkit_tpu_torch.store.memory import match
        from swarmkit_tpu_torch.watch.queue import watch_with_sweep

        def current_kek():
            clusters = manager.store.find("cluster")
            if not clusters:
                return None
            return next((k.key for k in clusters[0].unlock_keys
                         if k.subsystem == "manager"), None)

        try:
            watcher = manager.store.watch(match(kind="cluster"))
            async for _ev in watch_with_sweep(watcher, self.clock, 2.0):
                if manager is not self.manager or not manager._running:
                    return
                kek = current_kek()
                if self.keyrw is not None and self.security is not None \
                        and self.keyrw.set_kek(kek):
                    log.info("node %s: manager autolock %s", self.node_id,
                             "engaged" if kek else "released")
                    self._rotate_raft_dek()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("autolock watch crashed")

    def _raft_dek_crypters(self):
        """The raft WAL/snapshot data-encryption key, minted on first
        manager start and persisted in the KEK-protected key-store headers
        (reference: manager/deks.go — the DEK rides the TLS key headers so
        autolock covers it).  Returns (encrypter, decrypter); plaintext
        only for keyrw-less harness nodes."""
        from swarmkit_tpu_torch.encryption.encryption import (
            MultiDecrypter, SecretboxCrypter,
        )

        if self.keyrw is None or self.security is None:
            return None, None
        dek, history = self.keyrw.get_raft_deks()
        if dek is None:
            dek = os.urandom(32)
            self.keyrw.set_raft_deks(dek, history)
        crypter = SecretboxCrypter(dek)
        history = [h for h in history if h != dek]
        if history:
            return crypter, MultiDecrypter(
                crypter, *(SecretboxCrypter(h) for h in history))
        return crypter, crypter

    def _rotate_raft_dek(self) -> None:
        """KEK change => DEK rotation (reference: deks.go NeedsRotation —
        a key that protected the old DEK may be known to holders of the
        old KEK)."""
        from swarmkit_tpu_torch.encryption.encryption import SecretboxCrypter

        if self.keyrw is None or self.manager is None:
            return
        old, history = self.keyrw.get_raft_deks()
        if old is None:
            return
        new = os.urandom(32)
        # History is NEVER auto-drained: a same-index snapshot can keep a
        # live WAL segment with old-generation records, so dropping a
        # generation on "snapshot success" risks an unbootable state dir.
        # Generations are 32 bytes per KEK rotation — keeping them all is
        # the safe trade (the snapshot below still re-encrypts history so
        # old keys stop MATTERING; they just remain available).
        self.keyrw.set_raft_deks(new, history + [old])
        self.manager.raft.storage.rotate_encryption_key(
            SecretboxCrypter(new), SecretboxCrypter(new))
        try:
            # re-encrypt the log under the new key ASAP (reference:
            # deks.go triggers a snapshot to complete rotation)
            self.manager.raft.snapshot_now()
        except Exception:
            log.exception("post-rotation snapshot failed; the old DEK "
                          "generation still decrypts existing segments")
        log.info("node %s: raft DEK rotated with the KEK", self.node_id)

    async def _watch_member_removal(self, manager) -> None:
        try:
            while manager is self.manager and manager._running:
                if manager.raft.removed:
                    log.info("node %s: raft member removed; demoting",
                             self.node_id)
                    self._note_demoted()
                    return
                await self.clock.sleep(0.5)
        except asyncio.CancelledError:
            raise

    def _note_demoted(self) -> None:
        self._set_desired_role(manager=False)

    def _set_desired_role(self, manager: bool) -> None:
        """One place for the role-flip invariant (both the session path
        and the member-removal path): update the desired role, force
        certificate renewal when the cert's role no longer matches, and
        wake the supervisor."""
        if manager == self._desired_manager:
            return
        self._desired_manager = manager
        if not manager and self.keyrw is not None:
            # a worker runs no autolock watch and must never be locked
            # out of its own key: release the manager KEK at-rest
            # encryption on EVERY demotion path (reference: keyreadwriter
            # RotateKEK(nil) on demotion)
            try:
                self.keyrw.set_kek(None)
            except Exception:
                log.exception("cannot release the autolock KEK on demotion")
        if self.security is not None and self._renewer is not None:
            have_mgr_cert = self.security.role_ou == MANAGER_ROLE_OU
            if manager != have_mgr_cert:
                self._renewer.renew_soon()
        self._role_evt.set()

    def _cancel_role_watches(self) -> None:
        for attr in ("_removal_watch", "_autolock_watch"):
            t = getattr(self, attr, None)
            if t is not None:
                t.cancel()
                setattr(self, attr, None)

    def _leader_addr(self) -> str:
        for addr in self.remotes.weights():
            m = self.config.dialer(addr)
            if m is not None:
                try:
                    if m.is_leader():
                        return m.addr
                    if m.leader_addr:
                        return m.leader_addr
                except Exception:
                    continue
        return ""
