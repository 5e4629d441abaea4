"""Manager: builds the raft node + every API service, and flips the
leader-only control loops on leadership changes.

Reference: manager/manager.go — New (:199) wires raft, store and services;
Run (:427) registers them (:526-548) and starts raft; leadership events
(handleLeadershipEvents :846) drive becomeLeader (:906: orchestrators,
scheduler, allocator, task reaper, constraint enforcer, key manager, role
manager, dispatcher; plus seeding the default cluster + own node objects
:931-983) and becomeFollower (:1088).  The dirty-state check mirrors
manager/dirty.go IsStateDirty.

The port's own copy of the JAX package's manager/manager.py.  It differs
in one place: the scheduler places with its kernel (``sched_place``) by
default, on the card unless ``device="cpu"``, as the port's ``Scheduler``
does; ``sched_use_kernel=False`` asks for the host Pipeline, the JAX
package's default.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.api import (
    Annotations, Cluster, ClusterSpec, MembershipState, Node as ApiNode,
    NodeRole, NodeSpec, Peer, WeightedPeer,
)
from swarmkit_tpu_torch.api.objects import NodeStatus
from swarmkit_tpu_torch.ca import CAServer, RootCA, generate_join_token as ca_token
from swarmkit_tpu_torch.manager.allocator import Allocator
from swarmkit_tpu_torch.manager.controlapi import ControlApi
from swarmkit_tpu_torch.manager.dispatcher import Dispatcher
from swarmkit_tpu_torch.manager.health import HealthServer, HealthStatus
from swarmkit_tpu_torch.manager.keymanager import KeyManager
from swarmkit_tpu_torch.manager.logbroker import LogBroker
from swarmkit_tpu_torch.manager.metrics import Collector
from swarmkit_tpu_torch.manager.orchestrator.constraintenforcer import (
    ConstraintEnforcer,
)
from swarmkit_tpu_torch.manager.orchestrator.global_ import GlobalOrchestrator
from swarmkit_tpu_torch.manager.orchestrator.replicated import (
    ReplicatedOrchestrator,
)
from swarmkit_tpu_torch.manager.orchestrator.taskreaper import TaskReaper
from swarmkit_tpu_torch.manager.resourceapi import ResourceApi
from swarmkit_tpu_torch.manager.role_manager import RoleManager
from swarmkit_tpu_torch.manager.scheduler import Scheduler
from swarmkit_tpu_torch.manager.watchapi import WatchServer
from swarmkit_tpu_torch.raft.node import LeadershipState, Node as RaftNode, NodeOpts
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock
from swarmkit_tpu_torch.watch.queue import watch_with_sweep

log = logging.getLogger("swarmkit_tpu_torch.manager")

DEFAULT_CLUSTER_NAME = "default"   # reference: store.DefaultClusterName


class Manager:
    def __init__(self, node_id: str, addr: str, network, state_dir: str,
                 clock: Optional[Clock] = None, join_addr: str = "",
                 force_new_cluster: bool = False,
                 tick_interval: float = 1.0,
                 election_tick: int = 10, heartbeat_tick: int = 1,
                 seed: int = 0, security=None,
                 encrypter=None, decrypter=None,
                 transport_factory=None, obs=None,
                 sched_use_kernel: bool = True,
                 sched_commit_debounce: Optional[float] = None,
                 device=None) -> None:
        self.node_id = node_id
        self.addr = addr
        self.clock = clock or SystemClock()
        # node-provided TLS identity; its root CA seeds the cluster's CA on
        # bootstrap (reference: manager.go uses SecurityConfig's RootCA)
        self.security = security
        self.ca_server: Optional[CAServer] = None
        from swarmkit_tpu_torch.utils.metrics import Registry
        self.metrics_registry = Registry()
        # typed observability registry: per-manager by default so multi-
        # manager test clusters don't mix counters (pass obs= to share one)
        from swarmkit_tpu_torch.metrics import registry as obs_registry
        self.obs = obs or obs_registry.MetricsRegistry()
        self.raft = RaftNode(NodeOpts(
            metrics_registry=self.metrics_registry,
            obs_registry=self.obs,
            node_id=node_id, addr=addr, network=network,
            state_dir=state_dir, clock=self.clock, join_addr=join_addr,
            force_new_cluster=force_new_cluster,
            tick_interval=tick_interval, election_tick=election_tick,
            heartbeat_tick=heartbeat_tick, seed=seed,
            encrypter=encrypter, decrypter=decrypter,
            transport_factory=transport_factory))
        self.store: MemoryStore = self.raft.store
        # the scheduler's group-placement kernel on `device`; the batched
        # proposal pipeline is switched on with store.set_coalescing()
        self._sched_use_kernel = sched_use_kernel
        # resolved here, so a manager without a card fails at construction
        # rather than at its first placement as leader
        self.device = resolve_device(device) if sched_use_kernel else device
        self._sched_commit_debounce = sched_commit_debounce

        # always-on services (reference: manager.go:526-548)
        self.metrics = Collector(self.store)
        self.control_api = ControlApi(self.store, raft=self.raft,
                                      on_remove_node=self._on_remove_node,
                                      metrics=self.metrics,
                                      metrics_registry=self.metrics_registry)
        from swarmkit_tpu_torch.manager.drivers import DriverProvider
        self.drivers = DriverProvider()
        self.dispatcher = Dispatcher(
            self.store, managers_fn=self._weighted_peers, clock=self.clock,
            peers_queue=self.raft.cluster.broadcast, drivers=self.drivers,
            obs=self.obs)
        self.logbroker = LogBroker(self.store)
        self.watch_server = WatchServer(self.store, proposer=self.raft)
        self.health = HealthServer()
        self.resource_api = ResourceApi(self.store, clock=self.clock)

        # leader-only control loops, built on becomeLeader
        self._leader_components: list = []
        self.role_manager: Optional[RoleManager] = None
        self._leadership_task: Optional[asyncio.Task] = None
        self._members_task: Optional[asyncio.Task] = None
        self._running = False
        self._is_leader = False

    # ------------------------------------------------------------------
    def _weighted_peers(self) -> list[WeightedPeer]:
        return [WeightedPeer(peer=Peer(node_id=m.node_id, addr=m.addr))
                for m in self.raft.cluster.members.values()]

    async def _on_remove_node(self, node_id: str) -> None:
        member = next((m for m in self.raft.cluster.members.values()
                       if m.node_id == node_id), None)
        if member is not None:
            await self.raft.remove_member(member.raft_id)

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    @property
    def leader_addr(self) -> str:
        return self.raft.leader_addr()

    # ------------------------------------------------------------------
    # observability: the /metrics-equivalent scrape surface.  One page
    # merges the typed registry (raft/transport/scheduler/dispatcher/store
    # families), the legacy latency timers, and the store-object gauges
    # (reference: manager.go registers the prometheus handler next to the
    # health service).
    def metrics_text(self) -> str:
        from swarmkit_tpu_torch.metrics import exposition, trace as obs_trace
        return exposition.render_all(
            registry=self.obs,
            legacy_registry=self.metrics_registry,
            collector_gauges=self.metrics.snapshot(),
            tracer=obs_trace.DEFAULT)

    def metrics_snapshot(self) -> dict:
        from swarmkit_tpu_torch.metrics import exposition, trace as obs_trace
        return exposition.snapshot_all(
            registry=self.obs,
            legacy_registry=self.metrics_registry,
            collector_gauges=self.metrics.snapshot(),
            tracer=obs_trace.DEFAULT)

    def is_state_dirty(self) -> bool:
        """reference: manager/dirty.go IsStateDirty — any object beyond the
        cluster + own node means this store has real state."""
        count = sum(len(self.store.find(k))
                    for k in ("service", "task", "network", "secret",
                              "config", "resource", "extension"))
        nodes = self.store.find("node")
        extra_nodes = [n for n in nodes if n.id != self.node_id]
        return count > 0 or len(extra_nodes) > 0

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """reference: manager.Run manager.go:427."""
        self._running = True
        self.raft.pre_join_hook = self._create_joiner_node_record
        # promote our HealthServer onto the wire BEFORE the raft listener
        # starts, so peer probes read real per-service statuses
        # (reference: health service registration manager.go:526-548)
        network = self.raft.opts.network
        if hasattr(network, "set_health"):
            network.set_health(self.addr, lambda: self.health)
        # the metrics scrape service rides the same listener, registered
        # before raft starts for the same reason as health above
        if hasattr(network, "add_service"):
            from swarmkit_tpu_torch.rpc import metrics_handlers
            network.add_service(self.addr, metrics_handlers(self.metrics_text))
        leadership = self.raft.leadership.watch()
        await self.raft.start()
        await self.metrics.start()
        self.health.set_serving_status("Raft", HealthStatus.SERVING)
        self.health.set_serving_status("ControlAPI", HealthStatus.SERVING)
        self.health.set_serving_status("Watch", HealthStatus.SERVING)
        self.health.set_serving_status("ResourceAllocator",
                                       HealthStatus.SERVING)
        self._leadership_task = asyncio.get_running_loop().create_task(
            self._handle_leadership_events(leadership))
        # we may already be the leader (single-node bootstrap elects fast)
        if self.raft.is_leader() and not self._is_leader:
            await self._become_leader()

    async def stop(self) -> None:
        self._running = False
        self.health.shutdown()
        if self._leadership_task is not None:
            self._leadership_task.cancel()
            try:
                await self._leadership_task
            except (asyncio.CancelledError, Exception):
                pass
            self._leadership_task = None
        await self._become_follower()
        await self.store.stop_coalescing()
        await self.metrics.stop()
        await self.raft.stop()

    async def _handle_leadership_events(self, watcher) -> None:
        """reference: handleLeadershipEvents manager.go:846."""
        try:
            async for ev in watcher:
                if not self._running:
                    return
                if not isinstance(ev, LeadershipState):
                    continue
                # one failed flip (e.g. leadership lost mid-seed, raising
                # ErrLostLeadership from a proposal) must not kill the
                # handler — roll back and keep listening
                try:
                    if ev.is_leader and not self._is_leader:
                        await self._become_leader()
                    elif not ev.is_leader and self._is_leader:
                        await self._become_follower()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception("leadership flip failed; demoting")
                    try:
                        await self._become_follower()
                    except Exception:
                        log.exception("follower rollback failed")
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("leadership handler crashed")

    # ------------------------------------------------------------------
    async def _become_leader(self) -> None:
        """reference: becomeLeader manager.go:906."""
        log.info("manager %s became leader", self.node_id)
        self._is_leader = True
        self.metrics.set_leader(True)
        await self._seed_defaults()

        # the CA signing service, loaded from the replicated cluster object
        # (reference: ca.Server started in becomeLeader manager.go:906)
        cluster = self.store.find("cluster")[0]
        if cluster.root_ca.ca_cert and cluster.root_ca.ca_key:
            self.ca_server = CAServer(
                self.store,
                RootCA(cluster.root_ca.ca_cert, cluster.root_ca.ca_key),
                org=cluster.id, clock=self.clock)
        self.control_api.ca_server = self.ca_server

        sched_kw = {}
        if self._sched_commit_debounce is not None:
            sched_kw["commit_debounce"] = self._sched_commit_debounce
        sched = Scheduler(self.store, clock=self.clock, obs=self.obs,
                          use_kernel=self._sched_use_kernel,
                          device=self.device, **sched_kw)
        replicated = ReplicatedOrchestrator(self.store, clock=self.clock)
        global_ = GlobalOrchestrator(self.store, clock=self.clock)
        reaper = TaskReaper(self.store, clock=self.clock)
        enforcer = ConstraintEnforcer(self.store, clock=self.clock)
        allocator = Allocator(self.store, clock=self.clock)
        keymanager = KeyManager(self.store, clock=self.clock)
        # reconciliation retries scale with the raft tick so fast-tick test
        # clusters retry fast too (production: 1 s ticks → 16 s interval)
        self.role_manager = RoleManager(
            self.store, self.raft, clock=self.clock,
            reconcile_interval=16.0 * self.raft.opts.tick_interval)

        # allocator first so tasks reach PENDING before scheduling
        # (reference ordering in becomeLeader)
        self._leader_components = [allocator, sched, replicated, global_,
                                   reaper, enforcer, keymanager,
                                   self.role_manager]
        if self.ca_server is not None:
            self._leader_components.append(self.ca_server)
        for c in self._leader_components:
            await c.start()
        await self.dispatcher.start(mark_unknown=True)
        # node records for raft members: the reference's CA server creates
        # these when issuing certs to joiners (ca/server.go
        # IssueNodeCertificate); until a node-side CA join flow runs, the
        # leader reconciles them from the member list.  Watch BEFORE the
        # initial reconcile so a join during the first write isn't lost.
        members_watcher = self.raft.cluster.broadcast.watch()
        await self._ensure_member_node_records()
        self._members_task = asyncio.get_running_loop().create_task(
            self._watch_members(members_watcher))

    @staticmethod
    def _manager_node_record(node_id: str) -> ApiNode:
        """The node record the leader materializes for a raft member —
        single source for both the pre-join hook and the sweep."""
        return ApiNode(
            id=node_id,
            spec=NodeSpec(
                annotations=Annotations(name=node_id),
                desired_role=NodeRole.MANAGER,
                membership=MembershipState.ACCEPTED),
            role=NodeRole.MANAGER,
            status=NodeStatus())

    async def _create_joiner_node_record(self, node_id: str,
                                         addr: str) -> None:
        """pre_join_hook: commit the joiner's node record before its member
        can exist, so the role manager never sees a record-less member to
        reap (reference ordering: ca/server.go IssueNodeCertificate runs
        before the manager joins raft)."""
        if self.role_manager is not None \
                and node_id in self.role_manager.pending_removal:
            return  # a record the role manager is deleting must stay gone

        def txn(tx):
            if tx.get("node", node_id) is None:
                tx.create(self._manager_node_record(node_id))
        await self.store.update(txn)

    async def _ensure_member_node_records(self) -> None:
        members = list(self.raft.cluster.members.values())
        # records the role manager is deleting must stay deleted — the
        # sweep otherwise resurrects them faster than the member removal
        # converges
        being_removed = (set(self.role_manager.pending_removal)
                         if self.role_manager is not None else set())

        def txn(tx):
            for m in members:
                if not m.node_id or m.node_id in being_removed \
                        or tx.get("node", m.node_id) is not None:
                    continue
                tx.create(self._manager_node_record(m.node_id))
        await self.store.update(txn)

    async def _watch_members(self, watcher) -> None:
        # Event-driven with a periodic sweep: a membership event arriving
        # during a transient leadership blip must not end reconciliation
        # forever (the blip window is exactly when joins churn), and a
        # failed ensure (proposal timeout on a flip) retries. The txn is
        # create-only, so sweeps are free once records exist.
        try:
            async for _ev in watch_with_sweep(watcher, self.clock, 2.0):
                if not self._running:
                    return
                if self._is_leader:
                    try:
                        await self._ensure_member_node_records()
                    except Exception as e:
                        log.debug("member-record reconcile failed; "
                                  "retrying: %s", e)
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("member watch crashed")

    async def _become_follower(self) -> None:
        """reference: becomeFollower manager.go:1088."""
        if self._is_leader:
            log.info("manager %s lost leadership", self.node_id)
        self._is_leader = False
        self.metrics.set_leader(False)
        if self._members_task is not None:
            self._members_task.cancel()
            try:
                await self._members_task
            except (asyncio.CancelledError, Exception):
                pass
            self._members_task = None
        if self.dispatcher._running:
            await self.dispatcher.stop()
        for c in reversed(self._leader_components):
            try:
                await c.stop()
            except Exception:
                log.exception("stopping leader component %r failed", c)
        self._leader_components = []
        self.role_manager = None
        self.ca_server = None
        self.control_api.ca_server = None

    def _bootstrap_root_ca(self) -> Optional[RootCA]:
        if self.security is not None and self.security.root_ca.can_sign:
            return self.security.root_ca
        from swarmkit_tpu_torch.ca.certificates import HAVE_CRYPTOGRAPHY
        if not HAVE_CRYPTOGRAPHY:
            # No x509 stack in this environment: seed the cluster object
            # without CA material (join tokens / TLS identities disabled).
            log.warning("cryptography unavailable; bootstrapping cluster "
                        "without a root CA")
            return None
        return RootCA.create()

    async def _seed_defaults(self) -> None:
        """Seed the default cluster object and our own node record
        (reference: becomeLeader manager.go:931-983)."""
        seed_cluster = not self.store.find("cluster")
        root_ca = self._bootstrap_root_ca() if seed_cluster else None

        # bootstrap cluster id = the certificate org (reference:
        # manager.go uses securityConfig's Organization as the cluster id)
        cluster_id = (self.security.org if self.security is not None
                      else "cluster-" + DEFAULT_CLUSTER_NAME)

        def txn(tx):
            clusters = tx.find("cluster")
            if not clusters and seed_cluster:
                cluster = Cluster(
                    id=cluster_id,
                    spec=ClusterSpec(
                        annotations=Annotations(name=DEFAULT_CLUSTER_NAME)))
                if root_ca is not None:
                    cluster.root_ca.ca_cert = root_ca.cert_pem
                    cluster.root_ca.ca_key = root_ca.key_pem or b""
                    cluster.root_ca.ca_cert_hash = root_ca.digest()
                    cluster.root_ca.join_token_worker = ca_token(root_ca)
                    cluster.root_ca.join_token_manager = ca_token(root_ca)
                tx.create(cluster)
            if tx.get("node", self.node_id) is None:
                tx.create(ApiNode(
                    id=self.node_id,
                    spec=NodeSpec(
                        annotations=Annotations(name=self.node_id),
                        desired_role=NodeRole.MANAGER,
                        membership=MembershipState.ACCEPTED),
                    role=NodeRole.MANAGER,
                    status=NodeStatus()))
        await self.store.update(txn)
