"""Worker: applies assignment sets to the local runtime.

Reference: agent/worker.go — ``Assign`` (full set, :131) / ``Update``
(incremental, :165) reconcile task managers against the assigned set
(reconcileTaskState :190), persist accepted tasks + statuses to the local DB
(agent/storage.go) so a restarted worker resumes them, and maintain the
secret/config dependency stores.  A Reporter is notified of every status
change; on (re)connection the worker re-reports everything it knows
(reportAll semantics via ``set_reporter``).

The port's own copy of the JAX package's agent/worker.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from swarmkit_tpu_torch.agent.dependency import Dependencies
from swarmkit_tpu_torch.agent.exec import Executor
from swarmkit_tpu_torch.agent.storage import TaskDB
from swarmkit_tpu_torch.agent.task import TaskManager
from swarmkit_tpu_torch.api import TaskState, TaskStatus
from swarmkit_tpu_torch.api.dispatcher_msgs import (
    AssignmentAction, AssignmentsMessage, AssignmentsType,
)
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.agent.worker")


class Worker:
    def __init__(self, executor: Executor, db: Optional[TaskDB] = None,
                 clock: Optional[Clock] = None) -> None:
        self.executor = executor
        # controllers resolve task secrets/configs through this (the
        # reference wires a DependencyManager into the executor the same
        # way; template/getter.go wraps it per task)
        executor.dependencies = self.dependencies = Dependencies()
        self.db = db or TaskDB()
        self.clock = clock or SystemClock()
        self.node = None   # latest node object from the session stream
        self.task_managers: dict[str, TaskManager] = {}
        # freshest status per task, for re-reporting on reconnection
        self.statuses: dict[str, TaskStatus] = {}
        self._reporter: Optional[Callable[[str, TaskStatus], None]] = None

    # ------------------------------------------------------------------
    def set_node(self, node) -> None:
        """Latest node object (template-expansion context), persisted so a
        restart can restore templated tasks before the session opens."""
        self.node = node
        try:
            self.db.put_node(node)
        except Exception:
            pass

    async def init(self) -> None:
        """Resume tasks recorded in the local DB (reference: worker.Init —
        restores accepted tasks after an agent restart)."""
        if self.node is None:
            self.node = self.db.get_node()
        for task, status, assigned in list(self.db.walk()):
            if not assigned:
                self.db.delete_task(task.id)
                continue
            if status is not None:
                task.status = status
            await self._start_manager(task)

    async def close(self) -> None:
        for tm in list(self.task_managers.values()):
            await tm.close()
        self.task_managers = {}

    def set_reporter(self, reporter: Optional[Callable[[str, TaskStatus], None]]
                     ) -> None:
        """Attach the status sink and replay everything known
        (reference: worker.Listen → reportAll)."""
        self._reporter = reporter
        if reporter is not None:
            for tid, status in self.statuses.items():
                reporter(tid, status)

    # ------------------------------------------------------------------
    async def assign(self, message: AssignmentsMessage) -> None:
        """Apply a message from the dispatcher: COMPLETE replaces the whole
        set, INCREMENTAL applies the diff (worker.go Assign/Update)."""
        if message.type == AssignmentsType.COMPLETE:
            await self._assign_complete(message)
        else:
            await self._assign_incremental(message)

    async def _assign_complete(self, message: AssignmentsMessage) -> None:
        assigned_tasks = {}
        secrets, configs = [], []
        for ch in message.changes:
            a = ch.assignment
            if a.task is not None:
                assigned_tasks[a.task.id] = a.task
            elif a.secret is not None:
                secrets.append(a.secret)
            elif a.config is not None:
                configs.append(a.config)
        self.dependencies.secrets.reset()
        self.dependencies.secrets.add(*secrets)
        self.dependencies.configs.reset()
        self.dependencies.configs.add(*configs)
        # anything we run that is no longer assigned gets released
        for tid in list(self.task_managers):
            if tid not in assigned_tasks:
                await self._remove_task(tid)
        for task in assigned_tasks.values():
            await self._update_task(task)

    async def _assign_incremental(self, message: AssignmentsMessage) -> None:
        for ch in message.changes:
            a = ch.assignment
            if a.task is not None:
                if ch.action == AssignmentAction.REMOVE:
                    await self._remove_task(a.task.id)
                else:
                    await self._update_task(a.task)
            elif a.secret is not None:
                if ch.action == AssignmentAction.REMOVE:
                    self.dependencies.secrets.remove([a.secret.id])
                else:
                    self.dependencies.secrets.add(a.secret)
            elif a.config is not None:
                if ch.action == AssignmentAction.REMOVE:
                    self.dependencies.configs.remove([a.config.id])
                else:
                    self.dependencies.configs.add(a.config)

    # ------------------------------------------------------------------
    async def _update_task(self, task) -> None:
        tm = self.task_managers.get(task.id)
        if tm is not None:
            self.db.put_task(task)
            await tm.update(task)
            return
        # the dispatcher's copy of status may lag ours (we are the source
        # of truth once the task runs here) — reference: reconcileTaskState
        known = self.db.get_task_status(task.id)
        if known is not None and known.state > task.status.state:
            task = task.copy()
            task.status = known
        await self._start_manager(task)

    async def _start_manager(self, task) -> None:
        self.db.put_task(task)
        self.db.set_task_assignment(task.id, True)
        if task.status.state >= TaskState.COMPLETE:
            self.statuses[task.id] = task.status
            return  # nothing to drive
        # expand {{.Service.Name}}-style templates against this node
        # (reference: dockerapi controller runs ExpandContainerSpec)
        try:
            from swarmkit_tpu_torch.template import expand_container_spec

            expanded = expand_container_spec(task, self.node)
        except Exception as e:
            status = task.status.copy()
            status.state = TaskState.REJECTED
            status.err = f"template expansion failed: {e}"
            status.timestamp = self.clock.now()
            await self._report(task.id, status)
            return
        try:
            controller = await self.executor.controller(expanded)
        except Exception as e:
            status = task.status.copy()
            status.state = TaskState.REJECTED
            status.err = str(e)
            status.timestamp = self.clock.now()
            await self._report(task.id, status)
            return
        tm = TaskManager(task, controller, self._report, self.clock)
        self.task_managers[task.id] = tm
        tm.start()

    async def _remove_task(self, task_id: str) -> None:
        tm = self.task_managers.pop(task_id, None)
        if tm is not None:
            # drive the workload down before dropping it (worker.go releases
            # via taskManager close + controller remove)
            try:
                await tm.controller.shutdown()
                await tm.controller.remove()
            except Exception:
                pass
            await tm.close()
        self.statuses.pop(task_id, None)
        self.db.delete_task(task_id)

    async def _report(self, task_id: str, status: TaskStatus) -> None:
        self.statuses[task_id] = status
        try:
            self.db.put_task_status(task_id, status)
        except Exception:
            pass
        if self._reporter is not None:
            self._reporter(task_id, status)
        await asyncio.sleep(0)
