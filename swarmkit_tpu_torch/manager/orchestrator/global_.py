"""Global-service orchestrator: one task per eligible node.

Reference: manager/orchestrator/global/global.go — reconcileServices (:253)
creates a task on every READY, non-drained node matching the service's
constraints and shuts down tasks on nodes that stopped qualifying; node
add/remove events trigger reconciliation of every global service.

The port's own copy of the JAX package's manager/orchestrator/global_.py,
with one change: a service's task creates and shutdowns, and a removed
service's deletes, go through the store's ``Batch``, one change a
callback, as upstream SwarmKit writes them (global/global.go,
store.Batch).  At ``MAX_CHANGES_PER_TRANSACTION`` changes or fewer the
batch is one transaction with the same events as one ``store.update``;
above it a single ``update`` raises ``ErrTxTooLarge`` and the service
never gets its tasks (201 eligible nodes are enough).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import Mode, NodeAvailability, NodeState, TaskState
from swarmkit_tpu_torch.manager import constraint as constraint_mod
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.manager.orchestrator.restart import RestartSupervisor
from swarmkit_tpu_torch.manager.orchestrator.taskinit import check_tasks
from swarmkit_tpu_torch.manager.orchestrator.update import UpdateSupervisor
from swarmkit_tpu_torch.store.by import ByService
from swarmkit_tpu_torch.store.memory import Event, EventCommit, MemoryStore, match, match_commit
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.global")


def _node_eligible(service, node) -> bool:
    if node.status.state != NodeState.READY:
        return False
    if node.spec.availability in (NodeAvailability.DRAIN,):
        return False
    p = service.spec.task.placement
    if p is not None and p.constraints:
        try:
            cons = constraint_mod.parse(p.constraints)
        except constraint_mod.InvalidConstraint:
            return False
        if not constraint_mod.node_matches(cons, node):
            return False
    return True


class GlobalOrchestrator:
    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None,
                 restart: Optional[RestartSupervisor] = None,
                 updater: Optional[UpdateSupervisor] = None) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self.restart = restart or RestartSupervisor(store, clock=self.clock)
        self.updater = updater or UpdateSupervisor(store, self.restart,
                                                   clock=self.clock)
        self._dirty: set[str] = set()
        self._deleted: dict[str, object] = {}
        self._restart_queue: list = []
        self._nodes_changed = False
        self._task: Optional[asyncio.Task] = None
        self._running = False

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="service"), match(kind="task"),
                                   match(kind="node"), match_commit)
        for s in self.store.find("service"):
            if s.spec.mode == Mode.GLOBAL:
                self._dirty.add(s.id)
        # fix stale tasks from before this orchestrator existed
        # (reference: taskinit.CheckTasks via global.go Run)
        await check_tasks(self.store, self.restart, Mode.GLOBAL)
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
        await self.updater.stop()
        await self.restart.stop()

    async def _run(self, watcher) -> None:
        try:
            if self._dirty:
                await self.tick()
            while self._running:
                ev = await watcher.get()
                self._handle(ev)
                if isinstance(ev, EventCommit) and (
                        self._dirty or self._deleted or self._restart_queue):
                    await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("global orchestrator crashed")

    def _handle(self, ev) -> None:
        if not isinstance(ev, Event):
            return
        if ev.kind == "service":
            if ev.object.spec.mode != Mode.GLOBAL:
                return
            if ev.action == "remove":
                self._deleted[ev.object.id] = ev.object
            else:
                self._dirty.add(ev.object.id)
        elif ev.kind == "node":
            # any node change can affect every global service
            for s in self.store.find("service"):
                if s.spec.mode == Mode.GLOBAL:
                    self._dirty.add(s.id)
        elif ev.kind == "task":
            t = ev.object
            if not t.service_id:
                return
            if ev.action == "remove":
                self._dirty.add(t.service_id)
            elif ev.action == "update" and common.in_terminal_state(t) \
                    and t.desired_state <= TaskState.RUNNING:
                self._restart_queue.append(t)

    async def tick(self) -> None:
        deleted, self._deleted = self._deleted, {}
        for service in deleted.values():
            def delete(tx, t):
                if tx.get("task", t.id) is not None:
                    tx.delete("task", t.id)
            await self._batched(
                [lambda tx, t=t: delete(tx, t) for t in
                 self.store.find("task", ByService(service.id))])
            self.restart.clear_service_history(service.id)

        restarts, self._restart_queue = self._restart_queue, []
        for task in restarts:
            service = self.store.get("service", task.service_id)
            if service is None or service.spec.mode != Mode.GLOBAL:
                continue
            cluster = self._cluster()
            await self.store.update(
                lambda tx, s=service, t=task:
                self.restart.restart(tx, cluster, s, t))

        dirty, self._dirty = self._dirty, set()
        for sid in dirty:
            service = self.store.get("service", sid)
            if service is not None and service.spec.mode == Mode.GLOBAL:
                await self._reconcile(service)

    async def _batched(self, writes: list) -> None:
        """Run every write callback, in order, through one store batch
        (reference: store.Batch, split at MAX_CHANGES_PER_TRANSACTION)."""
        if not writes:
            return
        batch = self.store.batch()
        for write in writes:
            await batch.update(write)
        await batch.commit()

    def _cluster(self):
        clusters = self.store.find("cluster")
        return clusters[0] if clusters else None

    async def _reconcile(self, service) -> None:
        """reference: reconcileServices global.go:253."""
        nodes = self.store.find("node")
        eligible = {n.id for n in nodes if _node_eligible(service, n)}
        tasks = self.store.find("task", ByService(service.id))
        by_node: dict[str, list] = {}
        for t in tasks:
            if common.runnable(t):
                by_node.setdefault(t.node_id, []).append(t)

        cluster = self._cluster()
        to_create = [nid for nid in eligible if nid not in by_node]
        to_shutdown = [t for nid, ts in by_node.items()
                       if nid not in eligible for t in ts]

        def create(tx, nid):
            tx.create(common.new_task(cluster, service, slot=0, node_id=nid))

        def shutdown(tx, t):
            cur = tx.get("task", t.id)
            if cur is not None and cur.desired_state <= TaskState.RUNNING:
                cur.desired_state = int(TaskState.SHUTDOWN)
                tx.update(cur)
        await self._batched(
            [lambda tx, nid=nid: create(tx, nid) for nid in to_create]
            + [lambda tx, t=t: shutdown(tx, t) for t in to_shutdown])

        # spec changes roll out via the update supervisor, one "slot" per
        # node (reference: global.go reconcileServices → g.updater.Update)
        node_slots = [ts for nid, ts in by_node.items() if nid in eligible]
        if any(common.is_task_dirty(service, t)
               for ts in node_slots for t in ts):
            self.updater.update(cluster, service, node_slots)
