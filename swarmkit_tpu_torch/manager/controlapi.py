"""Control API: validated CRUD over every cluster object.

Reference: manager/controlapi/ — server.go (Server :18), service.go (932 LoC
of CreateService/UpdateService validation), node.go (update/remove incl.
role-change safety), cluster.go (UpdateCluster + join-token rotation),
network.go, secret.go, config.go.  gRPC status codes become exception
types; the store is written through ``store.update`` so every mutation
rides raft when a proposer is attached.

The reference wraps this server in generated raft proxies
(RaftProxyControlServer) so followers forward to the leader; here the
manager exposes the same behavior via a ``leader_conn`` seam on the Manager
(leader proxying lives there, not in this class).
"""

from __future__ import annotations

import re
from typing import Optional

from swarmkit_tpu_torch.api import (
    Annotations, Cluster, Config, Extension, Mode, Network, Node,
    NodeAvailability, NodeRole, NodeState, Resource, Secret, Service, Task,
    TaskState,
)
from swarmkit_tpu_torch.store import by as by_mod
from swarmkit_tpu_torch.store.errors import ErrNameConflict, ErrSequenceConflict
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.identity import new_id

# reference: secret.go MaxSecretSize 500KB
MAX_SECRET_SIZE = 500 * 1024
MAX_CONFIG_SIZE = 500 * 1024

_NAME_RE = re.compile(r"^[a-zA-Z0-9]([a-zA-Z0-9\-_.]*[a-zA-Z0-9])?$")


class ControlError(Exception):
    code = "unknown"


class InvalidArgument(ControlError):
    code = "invalid_argument"


class NotFound(ControlError):
    code = "not_found"


class AlreadyExists(ControlError):
    code = "already_exists"


class FailedPrecondition(ControlError):
    code = "failed_precondition"


class PermissionDenied(ControlError):
    code = "permission_denied"


def validate_annotations(annotations: Optional[Annotations]) -> None:
    """reference: controlapi/common.go validateAnnotations."""
    if annotations is None or not annotations.name:
        raise InvalidArgument("meta: name must be provided")
    if not _NAME_RE.match(annotations.name):
        raise InvalidArgument(
            f"name must conform to {_NAME_RE.pattern}: {annotations.name!r}")


def _validate_task_spec(task_spec) -> None:
    """reference: controlapi/service.go validateTask."""
    if task_spec.container is None:
        raise InvalidArgument("spec: container spec must be provided")
    if not task_spec.container.image:
        raise InvalidArgument("spec: image reference must be provided")
    if task_spec.restart is not None and task_spec.restart.delay < 0:
        raise InvalidArgument("spec: restart delay must be non-negative")
    if task_spec.placement is not None and task_spec.placement.constraints:
        from swarmkit_tpu_torch.manager import constraint as constraint_mod
        try:
            constraint_mod.parse(task_spec.placement.constraints)
        except constraint_mod.InvalidConstraint as e:
            raise InvalidArgument(f"spec: invalid constraint: {e}")
    # resource quantities must be non-negative: a negative reservation
    # would inflate scheduler availability accounting instead of
    # constraining it (reference validateResources)
    res = task_spec.resources
    for group in ((res.reservations, res.limits) if res is not None
                  else ()):
        if group is None:
            continue
        if group.nano_cpus < 0 or group.memory_bytes < 0 \
                or any(v < 0 for v in group.generic.values()):
            raise InvalidArgument(
                "spec: resource quantities must be non-negative")
    # reference service.go validateMounts: every mount needs a target,
    # bind mounts need a source, and targets must not collide
    targets = set()
    for m in task_spec.container.mounts:
        if m.type not in ("bind", "volume", "tmpfs", "npipe"):
            raise InvalidArgument(f"spec: invalid mount type {m.type!r}")
        if not m.target:
            raise InvalidArgument("spec: mount target must be provided")
        if m.target in targets:
            raise InvalidArgument(
                f"spec: duplicate mount target {m.target!r}")
        targets.add(m.target)
        if m.type == "bind" and not m.source:
            raise InvalidArgument("spec: bind mount requires a source")
        if m.type == "tmpfs" and m.source:
            raise InvalidArgument("spec: tmpfs mount cannot have a source")


def _validate_endpoint_spec(ep_spec) -> None:
    """reference: service.go validateEndpointSpec — no duplicate
    (protocol, published_port) within one spec."""
    if ep_spec is None:
        return
    seen = set()
    for p in ep_spec.ports:
        if not (0 <= p.target_port <= 65535) \
                or not (0 <= p.published_port <= 65535):
            raise InvalidArgument("endpoint: port out of range")
        if p.published_port:
            key = (p.protocol, p.published_port)
            if key in seen:
                raise InvalidArgument(
                    f"endpoint: duplicate published port "
                    f"{p.protocol}/{p.published_port}")
            seen.add(key)


def _validate_update_config(update) -> None:
    if update is None:
        return
    if not (0.0 <= update.max_failure_ratio <= 1.0):
        raise InvalidArgument(
            "update: max_failure_ratio must be within [0, 1]")
    if update.delay < 0 or update.monitor < 0:
        raise InvalidArgument("update: delays must be non-negative")


def _validate_service_spec(spec) -> None:
    validate_annotations(spec.annotations)
    _validate_task_spec(spec.task)
    _validate_endpoint_spec(spec.endpoint)
    _validate_update_config(spec.update)
    _validate_update_config(spec.rollback)
    if spec.mode == Mode.REPLICATED:
        if spec.replicated is None or spec.replicated.replicas < 0:
            raise InvalidArgument("spec: replicas must be non-negative")
    elif spec.mode == Mode.GLOBAL:
        if spec.global_ is None:
            raise InvalidArgument("spec: global mode config missing")
    else:
        raise InvalidArgument("spec: unrecognized service mode")


def _mint_manager_kek():
    """A fresh manager autolock key record (reference: generateUnlockKey)."""
    import secrets as _secrets

    from swarmkit_tpu_torch.api.objects import EncryptionKey
    return EncryptionKey(
        subsystem="manager",
        key=("SWMKEY-1-" + _secrets.token_hex(32)).encode())


class ControlApi:
    def __init__(self, store: MemoryStore, raft=None,
                 on_remove_node=None, metrics=None,
                 metrics_registry=None) -> None:
        self.store = store
        self.raft = raft   # for memberlist in node listings / demote checks
        # hook the manager uses to deregister raft members on node removal
        self.on_remove_node = on_remove_node
        self.metrics = metrics  # gauge collector for cluster.metrics
        self.metrics_registry = metrics_registry  # per-node latency timers

    # -- helpers ---------------------------------------------------------
    def _get(self, kind: str, obj_id: str):
        obj = self.store.get(kind, obj_id)
        if obj is None:
            raise NotFound(f"{kind} {obj_id} not found")
        return obj

    def _check_version(self, current, requested_version) -> None:
        if requested_version is not None \
                and current.meta.version.index != requested_version:
            raise FailedPrecondition(
                f"update out of sequence: stored version "
                f"{current.meta.version.index} != {requested_version}")

    @staticmethod
    def _check_secret_config_refs(tx, spec) -> None:
        """reference: service.go checkSecretExistence/checkConfigExistence —
        runs INSIDE the write transaction so a concurrent remove_secret
        cannot slip between the check and the commit."""
        c = spec.task.container
        if c is None:
            return
        missing = [r.secret_id for r in c.secrets
                   if tx.get("secret", r.secret_id) is None]
        missing += [r.config_id for r in c.configs
                    if tx.get("config", r.config_id) is None]
        if missing:
            raise InvalidArgument(
                "spec: unknown secret/config references: "
                + ", ".join(missing))

    # -- service ---------------------------------------------------------
    async def create_service(self, spec) -> Service:
        """reference: CreateService service.go."""
        _validate_service_spec(spec)
        service = Service(id=new_id(), spec=spec.copy())

        def txn(tx):
            self._check_secret_config_refs(tx, spec)
            tx.create(service)
        try:
            await self.store.update(txn)
        except ErrNameConflict:
            raise AlreadyExists(
                f"service name {spec.annotations.name!r} is in use")
        return service

    async def update_service(self, service_id: str, spec,
                             version: Optional[int] = None) -> Service:
        """reference: UpdateService service.go — mode is immutable; the
        prior spec is kept for rollback."""
        _validate_service_spec(spec)

        def txn(tx):
            self._check_secret_config_refs(tx, spec)
            svc = tx.get("service", service_id)
            if svc is None:
                raise NotFound(f"service {service_id} not found")
            self._check_version(svc, version)
            if svc.spec.mode != spec.mode:
                raise InvalidArgument("service mode cannot be changed")
            if svc.spec.annotations.name != spec.annotations.name:
                raise InvalidArgument("renaming services is not supported")
            svc = svc.copy()
            svc.previous_spec = svc.spec
            svc.spec = spec.copy()
            svc.update_status = None
            tx.update(svc)
            return svc
        try:
            return await self.store.update(txn)
        except ErrSequenceConflict:
            raise FailedPrecondition("update out of sequence")

    async def rollback_service(self, service_id: str,
                               version: Optional[int] = None) -> Service:
        """Manual rollback (reference: UpdateServiceRequest.Rollback,
        service.go — restore previous_spec; the update supervisor sees
        ROLLBACK_STARTED and re-runs reconciliation under the rollback
        config, updater.go:587)."""
        from swarmkit_tpu_torch.api.objects import UpdateStatus

        def txn(tx):
            svc = tx.get("service", service_id)
            if svc is None:
                raise NotFound(f"service {service_id} not found")
            self._check_version(svc, version)
            if svc.previous_spec is None:
                raise FailedPrecondition(
                    "service has no previous spec to roll back to")
            svc = svc.copy()
            svc.spec = svc.previous_spec
            svc.previous_spec = None
            svc.update_status = UpdateStatus(
                state="rollback_started",
                message="manually requested rollback")
            tx.update(svc)
            return svc
        try:
            return await self.store.update(txn)
        except ErrSequenceConflict:
            raise FailedPrecondition("rollback out of sequence")

    async def remove_service(self, service_id: str) -> None:
        def txn(tx):
            if tx.get("service", service_id) is None:
                raise NotFound(f"service {service_id} not found")
            tx.delete("service", service_id)
        await self.store.update(txn)

    def get_service(self, service_id: str) -> Service:
        return self._get("service", service_id)

    def list_services(self, names=None, name_prefixes=None, id_prefixes=None,
                      labels=None) -> list[Service]:
        return self._list("service", names, name_prefixes, id_prefixes,
                          labels)

    # -- task ------------------------------------------------------------
    def get_task(self, task_id: str) -> Task:
        return self._get("task", task_id)

    async def remove_task(self, task_id: str) -> None:
        def txn(tx):
            if tx.get("task", task_id) is None:
                raise NotFound(f"task {task_id} not found")
            tx.delete("task", task_id)
        await self.store.update(txn)

    def list_tasks(self, service_ids=None, node_ids=None,
                   desired_states=None, names=None, id_prefixes=None,
                   labels=None) -> list[Task]:
        tasks = self.store.find("task")
        if service_ids:
            tasks = [t for t in tasks if t.service_id in service_ids]
        if node_ids:
            tasks = [t for t in tasks if t.node_id in node_ids]
        if desired_states:
            tasks = [t for t in tasks if t.desired_state in desired_states]
        if id_prefixes:
            tasks = [t for t in tasks
                     if any(t.id.startswith(p) for p in id_prefixes)]
        if names:
            tasks = [t for t in tasks
                     if t.service_annotations.name in names
                     or t.annotations.name in names]
        if labels:
            tasks = [t for t in tasks
                     if all(t.annotations.labels.get(k) == v if v
                            else k in t.annotations.labels
                            for k, v in labels.items())]
        return tasks

    # -- node ------------------------------------------------------------
    def get_node(self, node_id: str) -> Node:
        return self._get("node", node_id)

    def list_nodes(self, roles=None, memberships=None, names=None,
                   id_prefixes=None, labels=None) -> list[Node]:
        nodes = self._list("node", names, None, id_prefixes, labels)
        if roles:
            nodes = [n for n in nodes if n.role in roles]
        if memberships:
            nodes = [n for n in nodes if n.spec.membership in memberships]
        return nodes

    async def update_node(self, node_id: str, spec,
                          version: Optional[int] = None) -> Node:
        """reference: UpdateNode node.go — demotion safety lives with the
        role manager; here we gate demoting the last manager."""
        def txn(tx):
            node = tx.get("node", node_id)
            if node is None:
                raise NotFound(f"node {node_id} not found")
            self._check_version(node, version)
            if spec.desired_role == NodeRole.WORKER:
                # inside the transaction so two concurrent demotions of the
                # last two managers cannot both pass (reference: node.go
                # performs this check within store.Update)
                self._check_can_demote(tx, node_id)
            node = node.copy()
            node.spec = spec.copy()
            tx.update(node)
            return node
        try:
            return await self.store.update(txn)
        except ErrSequenceConflict:
            raise FailedPrecondition("update out of sequence")

    @staticmethod
    def _check_can_demote(tx, node_id: str) -> None:
        target = tx.get("node", node_id)
        if target is None or target.role != NodeRole.MANAGER:
            return
        others = [n for n in tx.find("node")
                  if n.id != node_id and n.role == NodeRole.MANAGER
                  and n.spec.desired_role == NodeRole.MANAGER]
        if not others:
            raise FailedPrecondition(
                "attempting to demote the last manager of the swarm")

    async def remove_node(self, node_id: str, force: bool = False) -> None:
        """reference: RemoveNode node.go — only down workers (or with
        force) can be removed; managers must be demoted first."""
        def txn(tx):
            node = tx.get("node", node_id)
            if node is None:
                raise NotFound(f"node {node_id} not found")
            if node.role == NodeRole.MANAGER:
                raise FailedPrecondition(
                    "node is a cluster manager and is a member of the raft "
                    "cluster; it must be demoted before removal")
            if not force and node.status.state == NodeState.READY:
                raise FailedPrecondition(
                    "node is not down and can't be removed; use force")
            tx.delete("node", node_id)
        await self.store.update(txn)
        if self.on_remove_node is not None:
            await self.on_remove_node(node_id)

    # -- network ---------------------------------------------------------
    async def create_network(self, spec) -> Network:
        validate_annotations(spec.annotations)
        net = Network(id=new_id(), spec=spec.copy())
        try:
            await self.store.update(lambda tx: tx.create(net))
        except ErrNameConflict:
            raise AlreadyExists(
                f"network name {spec.annotations.name!r} is in use")
        return net

    def get_network(self, network_id: str) -> Network:
        return self._get("network", network_id)

    def list_networks(self, names=None, name_prefixes=None, id_prefixes=None,
                      labels=None) -> list[Network]:
        return self._list("network", names, name_prefixes, id_prefixes,
                          labels)

    async def remove_network(self, network_id: str) -> None:
        """reference: RemoveNetwork network.go — refuse while in use."""
        def txn(tx):
            net = tx.get("network", network_id)
            if net is None:
                raise NotFound(f"network {network_id} not found")
            for svc in tx.find("service"):
                nets = list(svc.spec.networks) + list(svc.spec.task.networks)
                if network_id in nets:
                    raise FailedPrecondition(
                        f"network {network_id} is in use by service "
                        f"{svc.id}")
            for t in tx.find("task"):
                if any(a.network_id == network_id for a in t.networks):
                    raise FailedPrecondition(
                        f"network {network_id} is in use by task {t.id}")
            tx.delete("network", network_id)
        await self.store.update(txn)

    # -- cluster ---------------------------------------------------------
    @staticmethod
    def _redact_cluster(cl: Cluster) -> Cluster:
        """Strip private material before returning cluster objects
        (reference: controlapi/cluster.go redactClusters — CA keys and
        unlock keys never leave the manager)."""
        cl = cl.copy()
        cl.root_ca.ca_key = b""
        if cl.root_ca.root_rotation is not None:
            cl.root_ca.root_rotation.ca_key = b""
        cl.unlock_keys = []
        return cl

    async def rotate_root_ca(self) -> dict:
        """Begin a root-CA rotation on the leader (reference: controlapi
        UpdateCluster with a new root + ca/server.go rotation path; the
        integration bar is TestSuccessfulRootRotation)."""
        ca = getattr(self, "ca_server", None)
        if ca is None:
            raise FailedPrecondition("no CA server on this manager (not "
                                     "the leader, or external-CA-only)")
        await ca.start_root_rotation()
        cl = self.get_cluster()
        rot = cl.root_ca.root_rotation
        new_cert = rot.ca_cert if rot else cl.root_ca.ca_cert
        from swarmkit_tpu_torch.ca import RootCA
        return {"rotation_active": rot is not None,
                "new_ca_digest": RootCA(new_cert).digest()}

    async def rotate_unlock_key(self) -> dict:
        """Mint a fresh manager autolock key (reference: swarmctl/swarm
        unlock-key --rotate); manager nodes re-encrypt their keys via the
        autolock watch."""
        minted = _mint_manager_kek()

        def txn(tx):
            clusters = tx.find("cluster")
            if not clusters:
                raise NotFound("cluster object not created yet")
            cl = clusters[0].copy()
            if not cl.spec.encryption_config.auto_lock_managers:
                raise FailedPrecondition(
                    "autolock is not enabled on this cluster")
            cl.unlock_keys = [k for k in cl.unlock_keys
                              if k.subsystem != "manager"] + [minted]
            tx.update(cl)
        await self.store.update(txn)
        # return the key THIS call minted — a re-read could race a
        # concurrent autolock-off or second rotation
        return {"unlock_key": minted.key.decode(), "autolock": True}

    def get_unlock_key(self) -> dict:
        """The manager autolock key (reference: GetUnlockKey ca/server.go —
        deliberately excluded from redacted cluster objects; this is the
        one endpoint that returns it)."""
        clusters = self.store.find("cluster")
        if not clusters:
            raise NotFound("cluster object not created yet")
        cl = clusters[0]
        key = next((k.key for k in cl.unlock_keys
                    if k.subsystem == "manager"), b"")
        return {"unlock_key": key.decode() if key else "",
                "autolock": bool(
                    cl.spec.encryption_config.auto_lock_managers)}

    def get_cluster(self, cluster_id: str = "") -> Cluster:
        if cluster_id:
            return self._redact_cluster(self._get("cluster", cluster_id))
        clusters = self.store.find("cluster")
        if not clusters:
            raise NotFound("cluster not found")
        return self._redact_cluster(clusters[0])

    def list_clusters(self, **kw) -> list[Cluster]:
        return [self._redact_cluster(c)
                for c in self.store.find("cluster")]

    async def update_cluster(self, cluster_id: str, spec,
                             version: Optional[int] = None,
                             rotate_worker_token: bool = False,
                             rotate_manager_token: bool = False) -> Cluster:
        """reference: UpdateCluster cluster.go — spec update + join-token
        rotation flags."""
        validate_annotations(spec.annotations)

        def txn(tx):
            cl = tx.get("cluster", cluster_id)
            if cl is None:
                raise NotFound(f"cluster {cluster_id} not found")
            self._check_version(cl, version)
            cl = cl.copy()
            cl.spec = spec.copy()
            if (rotate_worker_token or rotate_manager_token) \
                    and not cl.root_ca.ca_cert:
                # a token without the CA digest could never be accepted by
                # the CA server — refuse loudly instead of minting it
                raise FailedPrecondition(
                    "cluster has no root CA; cannot rotate join tokens")
            if rotate_worker_token:
                cl.root_ca.join_token_worker = generate_join_token(
                    ca_cert=cl.root_ca.ca_cert)
            if rotate_manager_token:
                cl.root_ca.join_token_manager = generate_join_token(
                    ca_cert=cl.root_ca.ca_cert)
            # Manager autolock (reference: cluster.go UpdateCluster unlock
            # key management + keyreadwriter RotateKEK): toggling it on
            # mints the manager KEK; off clears it.  Every manager node
            # applies the replicated key to its KeyReadWriter (node.py
            # autolock watch).
            want_lock = bool(spec.encryption_config.auto_lock_managers)
            have = [k for k in cl.unlock_keys if k.subsystem == "manager"]
            if want_lock and not have:
                cl.unlock_keys = list(cl.unlock_keys) + [_mint_manager_kek()]
            elif not want_lock and have:
                cl.unlock_keys = [k for k in cl.unlock_keys
                                  if k.subsystem != "manager"]
            tx.update(cl)
            return cl
        try:
            return await self.store.update(txn)
        except ErrSequenceConflict:
            raise FailedPrecondition("update out of sequence")

    # -- secret / config -------------------------------------------------
    async def create_secret(self, spec) -> Secret:
        validate_annotations(spec.annotations)
        if len(spec.data) > MAX_SECRET_SIZE:
            raise InvalidArgument(
                f"secret data must be less than {MAX_SECRET_SIZE} bytes")
        if not spec.data:
            raise InvalidArgument("secret data must be provided")
        secret = Secret(id=new_id(), spec=spec.copy())
        try:
            await self.store.update(lambda tx: tx.create(secret))
        except ErrNameConflict:
            raise AlreadyExists(
                f"secret name {spec.annotations.name!r} is in use")
        return secret

    def get_secret(self, secret_id: str) -> Secret:
        """Returns the secret WITHOUT data (reference: GetSecret redacts)."""
        s = self._get("secret", secret_id).copy()
        s.spec.data = b""
        return s

    def list_secrets(self, names=None, name_prefixes=None, id_prefixes=None,
                     labels=None) -> list[Secret]:
        out = []
        for s in self._list("secret", names, name_prefixes, id_prefixes,
                            labels):
            s = s.copy()
            s.spec.data = b""  # never return secret payloads in lists
            out.append(s)
        return out

    async def update_secret(self, secret_id: str, spec,
                            version: Optional[int] = None) -> Secret:
        """reference: UpdateSecret secret.go — only labels may change."""
        def txn(tx):
            s = tx.get("secret", secret_id)
            if s is None:
                raise NotFound(f"secret {secret_id} not found")
            self._check_version(s, version)
            if spec.data and spec.data != s.spec.data:
                raise InvalidArgument(
                    "only updates to Labels are allowed")
            if spec.annotations.name != s.spec.annotations.name:
                raise InvalidArgument("renaming secrets is not supported")
            s = s.copy()
            s.spec.annotations.labels = dict(spec.annotations.labels)
            tx.update(s)
            return s
        return await self.store.update(txn)

    async def remove_secret(self, secret_id: str) -> None:
        """Refuse to remove a secret in use (reference: RemoveSecret)."""
        def txn(tx):
            if tx.get("secret", secret_id) is None:
                raise NotFound(f"secret {secret_id} not found")
            users = tx.find("service")
            names = [s.spec.annotations.name for s in users
                     if s.spec.task.container is not None
                     and any(r.secret_id == secret_id
                             for r in s.spec.task.container.secrets)]
            if names:
                raise FailedPrecondition(
                    f"secret is in use by services: {', '.join(names)}")
            tx.delete("secret", secret_id)
        await self.store.update(txn)

    async def create_config(self, spec) -> Config:
        validate_annotations(spec.annotations)
        if len(spec.data) > MAX_CONFIG_SIZE:
            raise InvalidArgument(
                f"config data must be less than {MAX_CONFIG_SIZE} bytes")
        if not spec.data:
            raise InvalidArgument("config data must be provided")
        config = Config(id=new_id(), spec=spec.copy())
        try:
            await self.store.update(lambda tx: tx.create(config))
        except ErrNameConflict:
            raise AlreadyExists(
                f"config name {spec.annotations.name!r} is in use")
        return config

    def get_config(self, config_id: str) -> Config:
        return self._get("config", config_id)

    def list_configs(self, names=None, name_prefixes=None, id_prefixes=None,
                     labels=None) -> list[Config]:
        return self._list("config", names, name_prefixes, id_prefixes,
                          labels)

    async def update_config(self, config_id: str, spec,
                            version: Optional[int] = None) -> Config:
        def txn(tx):
            c = tx.get("config", config_id)
            if c is None:
                raise NotFound(f"config {config_id} not found")
            self._check_version(c, version)
            if spec.data and spec.data != c.spec.data:
                raise InvalidArgument("only updates to Labels are allowed")
            if spec.annotations.name != c.spec.annotations.name:
                raise InvalidArgument("renaming configs is not supported")
            c = c.copy()
            c.spec.annotations.labels = dict(spec.annotations.labels)
            tx.update(c)
            return c
        return await self.store.update(txn)

    async def remove_config(self, config_id: str) -> None:
        def txn(tx):
            if tx.get("config", config_id) is None:
                raise NotFound(f"config {config_id} not found")
            users = tx.find("service")
            names = [s.spec.annotations.name for s in users
                     if s.spec.task.container is not None
                     and any(r.config_id == config_id
                             for r in s.spec.task.container.configs)]
            if names:
                raise FailedPrecondition(
                    f"config is in use by services: {', '.join(names)}")
            tx.delete("config", config_id)
        await self.store.update(txn)

    # -- extension / resource -------------------------------------------
    async def create_extension(self, annotations: Annotations,
                               description: str = "") -> Extension:
        validate_annotations(annotations)
        ext = Extension(id=new_id(), annotations=annotations.copy(),
                        description=description)
        try:
            await self.store.update(lambda tx: tx.create(ext))
        except ErrNameConflict:
            raise AlreadyExists(
                f"extension name {annotations.name!r} is in use")
        return ext

    async def remove_extension(self, extension_id: str) -> None:
        def txn(tx):
            ext = tx.get("extension", extension_id)
            if ext is None:
                raise NotFound(f"extension {extension_id} not found")
            for r in tx.find("resource"):
                if r.kind == ext.annotations.name:
                    raise FailedPrecondition(
                        f"extension {extension_id} is in use")
            tx.delete("extension", extension_id)
        await self.store.update(txn)

    async def create_resource(self, annotations: Annotations, kind: str,
                              payload: bytes = b"") -> Resource:
        validate_annotations(annotations)
        exts = [e for e in self.store.find("extension")
                if e.annotations.name == kind]
        if not exts:
            raise InvalidArgument(f"unrecognized resource kind {kind!r}")
        res = Resource(id=new_id(), annotations=annotations.copy(),
                       kind=kind, payload=payload)
        try:
            await self.store.update(lambda tx: tx.create(res))
        except ErrNameConflict:
            raise AlreadyExists(
                f"resource name {annotations.name!r} is in use")
        return res

    async def remove_resource(self, resource_id: str) -> None:
        def txn(tx):
            if tx.get("resource", resource_id) is None:
                raise NotFound(f"resource {resource_id} not found")
            tx.delete("resource", resource_id)
        await self.store.update(txn)

    # -- shared listing --------------------------------------------------
    def _list(self, kind: str, names, name_prefixes, id_prefixes, labels
              ) -> list:
        objs = self.store.find(kind)
        if names:
            objs = [o for o in objs if o.annotations.name in names]
        if name_prefixes:
            objs = [o for o in objs
                    if any(o.annotations.name.startswith(p)
                           for p in name_prefixes)]
        if id_prefixes:
            objs = [o for o in objs
                    if any(o.id.startswith(p) for p in id_prefixes)]
        if labels:
            def has_labels(o):
                have = o.annotations.labels
                return all(have.get(k) == v if v else k in have
                           for k, v in labels.items())
            objs = [o for o in objs if has_labels(o)]
        return objs


def generate_join_token(secret: Optional[str] = None,
                        ca_cert: bytes = b"") -> str:
    """``SWMTKN-1-<ca digest>-<secret>`` (reference: ca/config.go
    GenerateJoinToken).  A CA certificate is required — a digest-less
    token would be unjoinable."""
    if not ca_cert:
        raise ValueError("cannot generate a join token without a root CA")
    from swarmkit_tpu_torch.ca import RootCA
    from swarmkit_tpu_torch.ca import generate_join_token as ca_generate

    return ca_generate(RootCA(ca_cert), secret)
