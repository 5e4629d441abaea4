"""In-process cluster harness: the port's TestCluster.

Reference: integration/cluster.go (testCluster :28 — AddManager, AddAgent,
RemoveNode, SetNodeRole, Leader, CreateService …) and integration/node.go
(testNode with Pause for restart-preserving-state tests).  Full
``swarmkit_tpu_torch.node.Node`` objects (manager+agent in one "process")
share an in-process raft Network and a dialer directory; workloads run on
TestExecutor fakes; everything runs on the real event loop with a fast
raft tick.

The tools' own copy of the JAX package's test harness, with the same
methods and signatures, plus ``device``: where every manager of the
cluster runs its scheduler kernel (``sched_place``; None = the CUDA card,
"cpu" = its plain version).  The churn soak
(tools/soak_controlplane.py) drives it.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
from typing import Optional

from swarmkit_tpu_torch.agent.testutils import TestExecutor
from swarmkit_tpu_torch.api import (
    Annotations, ContainerSpec, MembershipState, NodeRole, NodeSpec,
    ReplicatedService, ServiceSpec, TaskSpec, TaskState,
)
from swarmkit_tpu_torch.api.objects import Node as ApiNode, NodeStatus
from swarmkit_tpu_torch.manager.manager import Manager
from swarmkit_tpu_torch.node import Node, NodeConfig
from swarmkit_tpu_torch.raft.transport import Network

TICK = 0.05


class TestCluster:
    """reference: testCluster integration/cluster.go:28."""

    __test__ = False

    def __init__(self, seed: int = 3, network=None,
                 transport_factory=None, device=None) -> None:
        self.network = network if network is not None else Network(seed=seed)
        self.transport_factory = transport_factory
        self.device = device
        self.tmp = tempfile.TemporaryDirectory(prefix="swarmkit-int-")
        self.nodes: dict[str, Node] = {}
        self.executors: dict[str, TestExecutor] = {}
        self._n = 0
        self.seed = seed

    # ------------------------------------------------------------------
    def _dialer(self, addr: str) -> Optional[Manager]:
        for node in self.nodes.values():
            m = node._running_manager()
            if m is not None and m.addr == addr:
                return m
        return None

    def leader(self) -> Optional[Manager]:
        for node in self.nodes.values():
            m = node._running_manager()
            if m is not None and m.is_leader() and m._is_leader:
                return m
        return None

    async def wait_leader(self, timeout: float = 20.0) -> Manager:
        return await self.poll(self.leader, "leader elected", timeout)

    async def poll(self, fn, what: str, timeout: float = 20.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            val = fn()
            if val:
                return val
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(f"timeout waiting for {what}")
            await asyncio.sleep(0.02)

    # ------------------------------------------------------------------
    def _config(self, node_id: str, is_manager: bool, join_addr: str,
                force_new_cluster: bool = False,
                executor=None) -> NodeConfig:
        self._n += 1
        ex = executor or TestExecutor(hostname=node_id)
        self.executors[node_id] = ex
        return NodeConfig(
            node_id=node_id,
            state_dir=os.path.join(self.tmp.name, node_id),
            executor=ex,
            network=self.network,
            dialer=self._dialer,
            listen_addr=f"{node_id}:4242",
            join_addr=join_addr,
            is_manager=is_manager,
            force_new_cluster=force_new_cluster,
            tick_interval=TICK,
            election_tick=4,
            heartbeat_tick=1,
            seed=self.seed + self._n,
            transport_factory=self.transport_factory,
            device=self.device)

    async def add_manager(self, node_id: str = "", executor=None) -> Node:
        """reference: AddManager cluster.go."""
        node_id = node_id or f"manager-{self._n + 1}"
        lead = self.leader()
        join = lead.addr if lead is not None else ""
        node = Node(self._config(node_id, is_manager=True, join_addr=join,
                                 executor=executor))
        self.nodes[node_id] = node
        await node.start()
        await self.wait_leader()
        # wait for the manager-role node record to exist — callers that
        # immediately demote another manager must see the true manager
        # count, or controlapi's last-manager safeguard misfires
        await self.poll(
            lambda: (l := self.leader()) is not None
            and (rec := l.store.get("node", node_id)) is not None
            and rec.role == NodeRole.MANAGER or None,
            f"{node_id} manager record", timeout=20)
        return node

    async def add_agent(self, node_id: str = "", executor=None) -> Node:
        """reference: AddAgent cluster.go — the CA join creates the node
        record; until the CA layer lands the harness seeds it."""
        node_id = node_id or f"agent-{self._n + 1}"
        lead = await self.wait_leader()
        await lead.store.update(lambda tx: tx.create(ApiNode(
            id=node_id,
            spec=NodeSpec(annotations=Annotations(name=node_id),
                          membership=MembershipState.ACCEPTED),
            status=NodeStatus())))
        node = Node(self._config(node_id, is_manager=False,
                                 join_addr=lead.addr, executor=executor))
        self.nodes[node_id] = node
        await node.start()
        return node

    async def remove_node(self, node_id: str, force: bool = False) -> None:
        node = self.nodes.pop(node_id)
        await node.stop()
        self.network.unregister(node.addr)
        lead = self.leader()
        if lead is not None:
            try:
                await lead.control_api.remove_node(node_id, force=force)
            except Exception:
                pass

    async def set_node_role(self, node_id: str, role: NodeRole) -> None:
        """reference: SetNodeRole cluster.go — via control api.  Retries
        out-of-sequence failures like any real control client: concurrent
        status writes bump the node version between read and update."""
        deadline = asyncio.get_running_loop().time() + 20
        while True:
            lead = await self.wait_leader()
            cur = lead.control_api.get_node(node_id)
            spec = cur.spec.copy()
            spec.desired_role = role
            try:
                await lead.control_api.update_node(
                    node_id, spec, version=cur.meta.version.index)
                return
            except Exception:
                if asyncio.get_running_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.02)

    async def stop_node(self, node_id: str) -> Node:
        """Stop without removing state (reference: testNode.Pause)."""
        node = self.nodes[node_id]
        await node.stop()
        self.network.unregister(node.addr)
        return node

    async def restart_node(self, node_id: str,
                           force_new_cluster: bool = False) -> Node:
        old = self.nodes[node_id]
        cfg = old.config
        cfg.force_new_cluster = force_new_cluster
        cfg.join_addr = ""
        node = Node(cfg)
        self.nodes[node_id] = node
        await node.start()
        return node

    async def stop_all(self) -> None:
        for node in list(self.nodes.values()):
            try:
                await node.stop()
            except Exception:
                pass
        close = getattr(self.network, "close", None)
        if close is not None:   # DeviceMeshNet owns a pump task
            close()

    # ------------------------------------------------------------------
    async def create_service(self, name: str = "web", replicas: int = 2,
                             image: str = "img"):
        lead = await self.wait_leader()
        return await lead.control_api.create_service(ServiceSpec(
            annotations=Annotations(name=name),
            task=TaskSpec(container=ContainerSpec(image=image)),
            replicated=ReplicatedService(replicas=replicas)))

    def running_tasks(self, service_id: str) -> list:
        lead = self.leader()
        if lead is None:
            return []
        from swarmkit_tpu_torch.store.by import ByService

        return [t for t in lead.store.find("task", ByService(service_id))
                if t.status.state == TaskState.RUNNING
                and t.desired_state <= TaskState.RUNNING]

    async def poll_cluster_ready(self, managers: int, workers: int,
                                 timeout: float = 30.0) -> None:
        """reference: pollClusterReady integration_test.go:71."""
        def ready():
            lead = self.leader()
            if lead is None:
                return False
            nodes = lead.store.find("node")
            from swarmkit_tpu_torch.api import NodeState

            ready_nodes = [n for n in nodes
                           if n.status.state == NodeState.READY]
            mgrs = [n for n in ready_nodes if n.role == NodeRole.MANAGER]
            wrks = [n for n in ready_nodes if n.role == NodeRole.WORKER]
            return len(mgrs) == managers and len(wrks) == workers
        await self.poll(ready, f"{managers} managers + {workers} workers "
                        "ready", timeout)
