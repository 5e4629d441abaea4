"""Constraint enforcer: evicts tasks from nodes that stop satisfying their
placement constraints or resource reservations.

Reference: manager/orchestrator/constraintenforcer/constraint_enforcer.go —
watches node updates, rejectNoncompliantTasks (:65) shuts down running tasks
whose constraints no longer match the changed node.

The port's own copy of the JAX package's
manager/orchestrator/constraintenforcer.py, with one change: a node's
evictions go through the store's ``Batch``, one task a callback (one
transaction with the same events at ``MAX_CHANGES_PER_TRANSACTION``
changes or fewer; a single ``update`` refuses more, and a node can hold
more than 200 tasks).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import NodeAvailability, TaskState
from swarmkit_tpu_torch.manager import constraint as constraint_mod
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.store.by import ByNode
from swarmkit_tpu_torch.store.memory import Event, MemoryStore, match
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.constraintenforcer")


class ConstraintEnforcer:
    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None
                 ) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self._task: Optional[asyncio.Task] = None
        self._running = False

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="node", action="update"))
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
            while self._running:
                ev = await watcher.get()
                if isinstance(ev, Event):
                    await self.reject_noncompliant(ev.object)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("constraint enforcer crashed")

    async def reject_noncompliant(self, node) -> None:
        """reference: rejectNoncompliantTasks constraint_enforcer.go:65."""
        # Drain is the ORCHESTRATOR's job (its restart supervisor shuts
        # down AND replaces each task atomically); pause means leave the
        # tasks alone.  The enforcer only polices ACTIVE nodes
        # (reference: constraint_enforcer.go:66-72).
        if node.spec.availability != NodeAvailability.ACTIVE:
            return
        tasks = self.store.find("task", ByNode(node.id))
        to_shutdown = []
        # remaining capacity for the resource-fit pass (the reference
        # recomputes available resources and evicts tasks whose
        # reservations no longer fit a shrunk node)
        cpus = mem = 0
        generic: dict[str, int] = {}
        if node.description is not None \
                and node.description.resources is not None:
            cpus = node.description.resources.nano_cpus
            mem = node.description.resources.memory_bytes
            generic = dict(node.description.resources.generic)
        for t in sorted(tasks, key=lambda t: t.id):
            if t.desired_state > TaskState.RUNNING \
                    or common.in_terminal_state(t):
                continue
            p = t.spec.placement
            if p is not None and p.constraints:
                try:
                    cons = constraint_mod.parse(p.constraints)
                except constraint_mod.InvalidConstraint:
                    continue
                if not constraint_mod.node_matches(cons, node):
                    to_shutdown.append(t)
                    continue
            res = t.spec.resources
            reserved = res.reservations if res is not None else None
            if reserved is not None:
                over_generic = any(generic.get(k, 0) < v
                                   for k, v in reserved.generic.items())
                if reserved.nano_cpus > cpus or reserved.memory_bytes > mem \
                        or over_generic:
                    to_shutdown.append(t)
                    continue
                cpus -= reserved.nano_cpus
                mem -= reserved.memory_bytes
                for k, v in reserved.generic.items():
                    generic[k] = generic.get(k, 0) - v
        if not to_shutdown:
            return

        def txn(tx, t):
            cur = tx.get("task", t.id)
            if cur is not None and cur.desired_state <= TaskState.RUNNING:
                cur.desired_state = int(TaskState.SHUTDOWN)
                cur.status.message = \
                    "node no longer satisfies task constraints"
                tx.update(cur)
        batch = self.store.batch()
        for t in to_shutdown:
            await batch.update(lambda tx, t=t: txn(tx, t))
        await batch.commit()
