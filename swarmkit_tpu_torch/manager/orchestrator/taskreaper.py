"""Task reaper: garbage-collects dead and REMOVE-desired tasks.

Reference: manager/orchestrator/taskreaper/task_reaper.go — keeps at most
TaskHistoryRetentionLimit dead tasks per slot (tick :234), deletes tasks with
desired_state REMOVE once they reach a terminal state OR while still
unassigned (task_reaper.go:109-111,181: state < ASSIGNED never reaches an
agent, so nothing will ever shut it down — the design/tla/Tasks.tla reaper
exceptions <<new, null>> / <<pending, null>>), and cleans up tasks orphaned
for too long.

The port's own copy of the JAX package's
manager/orchestrator/taskreaper.py, with one change: a global service's
history (a slot keyed by node) is read from the node's tasks, where the
JAX package copies every task of the service once a dirty node.  The
tasks and their order are the same; a global service over 1,000 nodes
no longer costs a million task copies a tick.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import TaskState
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.store.by import ByNode, BySlot
from swarmkit_tpu_torch.store.memory import Event, EventCommit, MemoryStore, match, match_commit
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.taskreaper")

DEFAULT_RETENTION = 5  # reference: defaults.Service TaskHistoryRetentionLimit


def _removable(t) -> bool:
    """Reapable outright: desired REMOVE and either already dead or never
    assigned (reference task_reaper.go:181: state < ASSIGNED or
    >= COMPLETE), or a SERVICELESS orphaned task (network-attachment
    tasks have no service to reconcile them; task_reaper.go:174-175)."""
    if t.status.state >= TaskState.ORPHANED and not t.service_id:
        return True
    return t.desired_state == TaskState.REMOVE \
        and (t.status.state < TaskState.ASSIGNED
             or common.in_terminal_state(t))


class TaskReaper:
    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None
                 ) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self._dirty_slots: set[tuple] = set()
        self._cleanup: set[str] = set()
        self._task: Optional[asyncio.Task] = None
        self._running = False

    def _retention(self) -> int:
        clusters = self.store.find("cluster")
        if clusters:
            orch = clusters[0].spec.orchestration
            if orch is not None:
                # the configured value verbatim: 0 keeps NO history and
                # negative disables cleanup (reference reads the cluster
                # field directly; the dataclass default supplies 5)
                return orch.task_history_retention_limit
        return DEFAULT_RETENTION

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="task"), match_commit)
        # startup scan (reference: taskReaper.Run initial pass)
        for t in self.store.find("task"):
            if _removable(t):
                self._cleanup.add(t.id)
            elif common.in_terminal_state(t) \
                    or t.desired_state > TaskState.RUNNING:
                self._dirty_slots.add(common.slot_tuple(t))
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
            if self._cleanup or self._dirty_slots:
                await self.tick()
            while self._running:
                ev = await watcher.get()
                if isinstance(ev, Event):
                    t = ev.object
                    if ev.action == "remove":
                        continue
                    if ev.action == "create" and t.service_id:
                        # a new task in a slot is when its history can
                        # exceed retention (reference EventCreateTask
                        # dirtying, task_reaper.go:166)
                        self._dirty_slots.add(common.slot_tuple(t))
                    if _removable(t):
                        self._cleanup.add(t.id)
                    elif common.in_terminal_state(t) \
                            or t.desired_state > TaskState.RUNNING:
                        self._dirty_slots.add(common.slot_tuple(t))
                elif isinstance(ev, EventCommit) \
                        and (self._cleanup or self._dirty_slots):
                    await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("task reaper crashed")

    async def tick(self) -> None:
        """reference: tick task_reaper.go:234."""
        cleanup, self._cleanup = self._cleanup, set()
        dirty, self._dirty_slots = self._dirty_slots, set()
        retention = self._retention()

        to_delete = set(cleanup)
        for slot in dirty:
            kind, service_id, key = slot
            service = self.store.get("service", service_id)
            if service is None:
                continue   # orchestrator deletes the tasks wholesale
            hist = retention
            rp = service.spec.task.restart
            if rp is not None and rp.max_attempts > 0:
                # keep one more than max_attempts so restart history can
                # be reconstructed after a leader change — this OVERRIDES
                # the cluster retention limit (task_reaper.go:295)
                hist = rp.max_attempts + 1
            if hist < 0:
                # negative retention = never clean history
                # (task_reaper.go:298)
                continue
            if kind == "slot":
                tasks = self.store.find("task", BySlot(service_id, key))
            else:
                # a global service's "slot" is its node: read that node's
                # tasks (the same tasks, in the same id order, as the
                # service's filtered by node, without copying every task
                # of the service once a node)
                tasks = [t for t in self.store.find("task", ByNode(key))
                         if t.service_id == service_id and not t.slot]
            # cleanable history: reached a terminal state (and already
            # processed by the restart path: desired > RUNNING), or will
            # NEVER run — desired terminal while still unassigned, so no
            # agent will ever move it (taskInTerminalState ||
            # taskWillNeverRun, task_reaper.go:344-347)
            dead = sorted(
                (t for t in tasks
                 if (common.in_terminal_state(t)
                     and t.desired_state > TaskState.RUNNING)
                 or (t.status.state < TaskState.ASSIGNED
                     and t.desired_state > TaskState.RUNNING)),
                key=lambda t: t.status.timestamp)
            excess = len(dead) - hist
            for t in dead[:max(0, excess)]:
                to_delete.add(t.id)

        if not to_delete:
            return

        batch = self.store.batch()
        for tid in to_delete:
            def txn(tx, tid=tid):
                if tx.get("task", tid) is not None:
                    tx.delete("task", tid)
            await batch.update(txn)
        await batch.commit()
