"""Replicated-service orchestrator.

Reference: manager/orchestrator/replicated/ — watches service/task/node
events, reconciles on commit (replicated.go:47-93): scale up by creating
tasks in free slots, scale down by removing the least-valuable slots
(services.go), restart failed tasks via the restart supervisor (tasks.go),
and hand dirty (spec-changed) slots to the update supervisor.

The port's own copy of the JAX package's manager/orchestrator/replicated.py,
with one change: a service's task creates, a scale-down's removals and a
removed service's deletes go through the store's ``Batch``, one change a
callback, as upstream SwarmKit writes them (replicated/services.go,
store.Batch).  At ``MAX_CHANGES_PER_TRANSACTION`` changes or fewer the
batch is one transaction with the same events as one ``store.update``;
above it a single ``update`` would raise ``ErrTxTooLarge`` and the
service would never get its tasks.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import Mode, TaskState
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.manager.orchestrator.restart import RestartSupervisor
from swarmkit_tpu_torch.manager.orchestrator.taskinit import check_tasks
from swarmkit_tpu_torch.manager.orchestrator.update import UpdateSupervisor
from swarmkit_tpu_torch.store.by import ByNode, ByService
from swarmkit_tpu_torch.store.memory import Event, EventCommit, MemoryStore, match, match_commit
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.replicated")


class ReplicatedOrchestrator:
    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None,
                 restart: Optional[RestartSupervisor] = None,
                 updater: Optional[UpdateSupervisor] = None) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self.restart = restart or RestartSupervisor(store, clock=self.clock)
        self.updater = updater or UpdateSupervisor(store, self.restart,
                                                   clock=self.clock)
        self._dirty_services: set[str] = set()
        self._deleted_services: dict[str, object] = {}
        self._restart_queue: list[tuple] = []
        self._task: Optional[asyncio.Task] = None
        self._running = False

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="service"), match(kind="task"),
                                   match(kind="node"), match_commit)
        # initial reconciliation of everything (reference: init via taskinit)
        for s in self.store.find("service"):
            if s.spec.mode == Mode.REPLICATED:
                self._dirty_services.add(s.id)
        # fix stale tasks from before this orchestrator existed: re-arm
        # parked restart delays, restart tasks that died unwatched
        # (reference: taskinit.CheckTasks via replicated.go Run)
        await check_tasks(self.store, self.restart, Mode.REPLICATED)
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

    # ------------------------------------------------------------------
    async def _run(self, watcher) -> None:
        try:
            if self._dirty_services:
                await self.tick()
            while self._running:
                ev = await watcher.get()
                self._handle(ev)
                if isinstance(ev, EventCommit) and (
                        self._dirty_services or self._restart_queue
                        or self._deleted_services):
                    await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("replicated orchestrator crashed")

    def _handle(self, ev) -> None:
        if not isinstance(ev, Event):
            return
        if ev.kind == "service":
            s = ev.object
            if s.spec.mode != Mode.REPLICATED:
                return
            if ev.action == "remove":
                self._deleted_services[s.id] = s
            else:
                self._dirty_services.add(s.id)
        elif ev.kind == "task":
            t = ev.object
            if not t.service_id:
                return
            if ev.action == "remove":
                self._dirty_services.add(t.service_id)
                return
            # a task reaching a terminal state — or sitting on a node
            # that can no longer host it — may need a restart
            # (reference: handleTaskChange tasks.go:118-146)
            if ev.action == "update" and t.desired_state <= TaskState.RUNNING \
                    and (common.in_terminal_state(t)
                         or (t.node_id and common.invalid_node(
                             self.store.get("node", t.node_id)))):
                self._restart_queue.append(t)
        elif ev.kind == "node":
            # a node going down/drained (or deleted) restarts its tasks
            # elsewhere (reference: handleNodeChange + restartTasksByNodeID
            # tasks.go:85-115; InvalidNode task.go:141)
            n = ev.object
            if ev.action == "remove" or common.invalid_node(n):
                self._queue_node_restarts(n.id)

    def _queue_node_restarts(self, node_id: str) -> None:
        """reference: restartTasksByNodeID tasks.go:85 — every runnable
        replicated task on the node goes through the restart supervisor,
        which shuts it down AND creates its replacement in one txn."""
        for t in self.store.find("task", ByNode(node_id)):
            if t.desired_state <= TaskState.RUNNING and t.service_id:
                self._restart_queue.append(t)

    # ------------------------------------------------------------------
    async def tick(self) -> None:
        deleted, self._deleted_services = self._deleted_services, {}
        for service in deleted.values():
            await self._delete_service_tasks(service)

        restarts, self._restart_queue = self._restart_queue, []
        for task in restarts:
            await self._restart_task(task)

        dirty, self._dirty_services = self._dirty_services, set()
        for sid in dirty:
            service = self.store.get("service", sid)
            if service is not None and service.spec.mode == Mode.REPLICATED:
                await self._reconcile(service)

    async def _delete_service_tasks(self, service) -> None:
        """reference: replicated.go deleteServiceTasks."""
        tasks = self.store.find("task", ByService(service.id))

        def txn(tx, t):
            if tx.get("task", t.id) is not None:
                tx.delete("task", t.id)
        await self._batched(txn, tasks)
        # forget restart strike counts (reference ClearServiceHistory)
        self.restart.clear_service_history(service.id)

    async def _restart_task(self, task) -> None:
        service = self.store.get("service", task.service_id)
        if service is None or service.spec.mode != Mode.REPLICATED:
            return
        cluster = self._cluster()
        await self.store.update(
            lambda tx: self.restart.restart(tx, cluster, service, task))

    def _cluster(self):
        clusters = self.store.find("cluster")
        return clusters[0] if clusters else None

    async def _batched(self, cb, items: list) -> None:
        """Write ``cb(tx, item)`` for every item through one store batch
        (reference: store.Batch, split at MAX_CHANGES_PER_TRANSACTION)."""
        if not items:
            return
        batch = self.store.batch()
        for item in items:
            await batch.update(lambda tx, item=item: cb(tx, item))
        await batch.commit()

    async def _reconcile(self, service) -> None:
        """reference: services.go reconcile."""
        tasks = self.store.find("task", ByService(service.id))
        # group live tasks by slot
        slots: dict[int, list] = {}
        for t in tasks:
            if common.runnable(t):
                slots.setdefault(t.slot, []).append(t)
        want = service.spec.replica_count()
        have = len(slots)

        if have < want:
            cluster = self._cluster()
            used = set(slots)
            free = [i for i in range(1, want + len(used) + 1)
                    if i not in used]
            new_tasks = []
            for i in range(want - have):
                new_tasks.append(common.new_task(cluster, service,
                                                 slot=free[i]))

            await self._batched(lambda tx, t: tx.create(t), new_tasks)
        elif have > want:
            # remove surplus slots, preferring those not yet running
            # (reference: services.go scale-down preferences)
            def sort_key(item):
                slot_num, slot_tasks = item
                running = any(t.status.state == TaskState.RUNNING
                              for t in slot_tasks)
                return (running, slot_num)
            surplus = sorted(slots.items(), key=sort_key)[:have - want]

            def txn(tx, t):
                cur = tx.get("task", t.id)
                if cur is not None:
                    cur.desired_state = int(TaskState.REMOVE)
                    tx.update(cur)
            await self._batched(txn, [t for _, slot_tasks in surplus
                                      for t in slot_tasks])

        # dirty slots go to the rolling updater
        live_slots = [s for s in slots.values() if s]
        if any(common.is_task_dirty(service, t)
               for s in live_slots for t in s):
            self.updater.update(self._cluster(), service, live_slots)
