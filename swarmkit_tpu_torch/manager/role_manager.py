"""Leader loop reconciling Node.spec.desired_role with the observed role and
the raft membership.

Reference: manager/role_manager.go — roleManager (:26): promotions flip
Node.role immediately; demotions first remove the node from the raft member
list (with a CanRemoveMember quorum safeguard, and a leadership transfer if
the leader demotes itself), then flip the role on a later pass; deleted
nodes' raft members are removed too.  Failed reconciliations retry every
reconciliation interval (16 s).

The port's own copy of the JAX package's manager/role_manager.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import NodeRole
from swarmkit_tpu_torch.store.memory import Event, MemoryStore, match
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock
from swarmkit_tpu_torch.watch.queue import watch_with_sweep

log = logging.getLogger("swarmkit_tpu_torch.rolemanager")

RECONCILIATION_INTERVAL = 16.0   # reference: role_manager.go roleReconcileInterval


class RoleManager:
    def __init__(self, store: MemoryStore, raft, clock: Optional[Clock] = None,
                 reconcile_interval: float = RECONCILIATION_INTERVAL) -> None:
        self.store = store
        self.raft = raft
        self.clock = clock or SystemClock()
        self.reconcile_interval = reconcile_interval
        self.pending: dict[str, object] = {}
        self.pending_removal: set[str] = set()
        # node_id -> first time its member was seen without a node record
        self._orphan_since: dict[str, float] = {}
        self._task: Optional[asyncio.Task] = None
        self._running = False

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="node"))
        # initial pass: reconcile every node, and remove raft members whose
        # node object no longer exists (role_manager.go Run)
        node_ids = set()
        for node in self.store.find("node"):
            node_ids.add(node.id)
            if node.spec.desired_role != node.role:
                self.pending[node.id] = node
        for member in list(self.raft.cluster.members.values()):
            if member.node_id and member.node_id not in node_ids:
                self.pending_removal.add(member.node_id)
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run(watcher))

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self, watcher) -> None:
        try:
            await self._reconcile_all()
            async for ev in watch_with_sweep(watcher, self.clock,
                                             self.reconcile_interval):
                if not self._running:
                    return
                if isinstance(ev, Event):
                    if ev.action == "remove":
                        # explicit record deletion: no join-in-progress
                        # grace — the member goes as soon as quorum
                        # rules allow
                        self.pending_removal.add(ev.object.id)
                        self._orphan_since[ev.object.id] = float("-inf")
                    elif ev.object.spec.desired_role != ev.object.role:
                        self.pending[ev.object.id] = ev.object
                await self._reconcile_all()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("role manager crashed")

    async def _reconcile_all(self) -> None:
        # Leader-only, re-checked on EVERY pass: after this manager hands
        # leadership away (self-demotion transfer), a stale pass here must
        # not keep injecting TRANSFER_LEADER requests — followers forward
        # those to the new leader, deposing it and bouncing leadership in a
        # loop that can starve the demotion from ever committing.
        if not self._is_leader():
            return
        for node_id in list(self.pending):
            node = self.store.get("node", node_id)
            if node is None:
                self.pending.pop(node_id, None)
                continue
            try:
                await self._reconcile_role(node)
            except Exception as e:
                # one node's failed reconciliation (proposal timeout on a
                # leadership flip, version conflict) must not kill the loop
                log.info("reconcile of %s failed; retrying later: %s",
                         node_id, e)
            if not self._is_leader():
                return
        for node_id in list(self.pending_removal):
            member = self._member_by_node_id(node_id)
            if member is None:
                self.pending_removal.discard(node_id)
                self._orphan_since.pop(node_id, None)
                continue
            # A member without a node record is only an orphan once the
            # record has been missing for a full reconcile interval: in
            # certless clusters the leader CREATES member records AFTER the
            # raft join, so a role manager freshly started by a leadership
            # flip would otherwise kill a member that is mid-join (the
            # reference never hits this because CA issuance creates the
            # record before the manager ever joins raft).
            if self.store.get("node", node_id) is not None:
                self.pending_removal.discard(node_id)
                self._orphan_since.pop(node_id, None)
                continue
            first = self._orphan_since.setdefault(node_id, self.clock.now())
            if self.clock.now() - first < self.reconcile_interval:
                continue
            try:
                await self._remove_member(member)
            except Exception as e:
                log.info("member removal of %s failed; retrying later: %s",
                         node_id, e)
            if not self._is_leader():
                return

    def _is_leader(self) -> bool:
        return self.raft.is_leader()

    def _member_by_node_id(self, node_id: str):
        for m in self.raft.cluster.members.values():
            if m.node_id == node_id:
                return m
        return None

    async def _remove_member(self, member) -> None:
        """reference: removeMember role_manager.go:200 — quorum safeguard +
        self-demotion leadership transfer."""
        if not self.raft.can_remove_member(member.raft_id):
            log.debug("removing %s would break quorum; retrying later",
                      member.node_id)
            return
        if member.raft_id == self.raft.raft_id:
            if not self._is_leader():
                return  # stale pass after the transfer already happened
            log.info("demoted; transferring leadership")
            try:
                await self.raft.transfer_leadership()
                return
            except Exception as e:
                log.info("failed to transfer leadership: %s", e)
        try:
            await self.raft.remove_member(member.raft_id)
        except Exception as e:
            log.debug("cannot remove member %s yet: %s", member.node_id, e)

    async def _reconcile_role(self, node) -> None:
        """reference: reconcileRole role_manager.go:231."""
        if node.spec.desired_role == node.role:
            self.pending.pop(node.id, None)
            return
        if node.spec.desired_role == NodeRole.MANAGER \
                and node.role == NodeRole.WORKER:
            await self._set_role(node, NodeRole.MANAGER)
            self.pending.pop(node.id, None)
        elif node.spec.desired_role == NodeRole.WORKER \
                and node.role == NodeRole.MANAGER:
            member = self._member_by_node_id(node.id)
            if member is not None:
                # remove from raft first; flip the role on a later pass
                await self._remove_member(member)
                return
            await self._set_role(node, NodeRole.WORKER)
            self.pending.pop(node.id, None)

    async def _set_role(self, node, role: NodeRole) -> None:
        def txn(tx):
            cur = tx.get("node", node.id)
            if cur is None or cur.spec.desired_role != node.spec.desired_role \
                    or cur.role != node.role:
                return
            cur = cur.copy()
            cur.role = role
            tx.update(cur)
        await self.store.update(txn)
