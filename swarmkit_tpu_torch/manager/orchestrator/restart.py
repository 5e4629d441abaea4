"""Restart supervisor: applies restart policies when tasks fail.

Reference: manager/orchestrator/restart/restart.go — Restart (:103) shuts
down the failed task and, when shouldRestart (:195) allows (condition,
max-attempts within window), creates a replacement in the same slot with
desired_state READY, then DelayStart (:395) flips it to RUNNING after the
policy delay.  Restart history is tracked per slot (restartedInstances
ring) and RESETS when the task spec changes (:223 specVersion check), so a
slot that exhausted max_attempts under a broken spec restarts again after
a service update.  Before promoting, DelayStart also waits for the old
task to actually stop (or its node to go down / disappear, or a 1-minute
timeout) so a slot never runs two tasks concurrently; the restart delay is
skipped for tasks leaving a drained node (:156).

The port's own copy of the JAX package's manager/orchestrator/restart.py.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api import RestartCondition, TaskState
from swarmkit_tpu_torch.api.types import NodeAvailability, NodeState
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.restart")

# reference defaultOldTaskTimeout (restart.go:20): the longest the
# replacement waits for the old task to stop before starting anyway
OLD_TASK_TIMEOUT = 60.0


@dataclass
class _Instance:
    timestamp: float


@dataclass
class _History:
    """Per-slot restart record (reference restartedInstanceInfo)."""
    spec_key: int
    total: int = 0
    instances: deque = field(default_factory=lambda: deque(maxlen=256))


def _spec_key(task) -> int:
    """Stable fingerprint of the spec a task runs; plays the role of the
    reference's Task.SpecVersion (restart history resets across updates)."""
    return task.spec.fingerprint()


class RestartSupervisor:
    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None
                 ) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self.old_task_timeout = OLD_TASK_TIMEOUT
        # slot tuple -> _History (restart.go historyByService)
        self._history: dict[tuple, _History] = {}
        self._delays: dict[str, asyncio.Task] = {}  # new task id -> timer

    async def stop(self) -> None:
        for t in self._delays.values():
            t.cancel()
        for t in list(self._delays.values()):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._delays = {}

    # ------------------------------------------------------------------
    def should_restart(self, task, service) -> bool:
        """reference: shouldRestart restart.go:195."""
        cond = common.restart_condition(task)
        if cond == RestartCondition.NONE:
            return False
        if cond == RestartCondition.ON_FAILURE \
                and task.status.state == TaskState.COMPLETE:
            return False
        policy = common.restart_policy(task)
        if policy.max_attempts == 0:
            return True
        h = self._history.get(common.slot_tuple(task))
        if h is None or h.spec_key != _spec_key(task):
            # no history under THIS spec: a service update wipes the
            # slot's strike count (restart.go:223)
            return True
        if policy.window <= 0:
            return h.total < policy.max_attempts
        now = self.clock.now()
        recent = sum(1 for inst in h.instances
                     if now - inst.timestamp <= policy.window)
        return recent < policy.max_attempts

    def restart(self, tx, cluster, service, task) -> None:
        """Shut down `task`; maybe create its replacement.  Runs inside a
        store transaction (synchronous — only the delayed-start timer is
        async; reference: Restart restart.go:103)."""
        t = tx.get("task", task.id)
        if t is None:
            return
        if t.desired_state > TaskState.RUNNING:
            return  # already being shut down
        t.desired_state = int(TaskState.SHUTDOWN)
        tx.update(t)

        if not self.should_restart(task, service):
            return

        policy = common.restart_policy(task)
        new = common.new_task(cluster, service, slot=task.slot,
                              node_id="" if task.slot else task.node_id)
        # replacement waits in READY until the restart delay elapses
        new.desired_state = int(TaskState.READY)
        tx.create(new)

        slot = common.slot_tuple(task)
        # record the strike under the REPLACEMENT's spec key: new_task
        # builds from the service's current spec, which may differ from the
        # failed task's.  Keying by the old spec would let the next failure
        # (of the replacement) read the history as stale and wipe the
        # slot's strike count, so max_attempts would never trip across a
        # service update (reference keys by the restarted task's
        # SpecVersion, restart.go:223).
        key = _spec_key(new)
        h = self._history.get(slot)
        if h is None or h.spec_key != key:
            h = self._history[slot] = _History(spec_key=key)
        h.total += 1
        h.instances.append(_Instance(timestamp=self.clock.now()))

        node = tx.get("node", task.node_id) if task.node_id else None
        # restart delay is not applied to drained nodes (restart.go:156):
        # evacuation replacements start immediately
        drained = (node is not None and node.spec is not None
                   and node.spec.availability == NodeAvailability.DRAIN)
        delay = 0.0 if drained else policy.delay
        # wait for the old task to stop before starting the replacement,
        # unless it is already dead or its node is down (restart.go:169)
        node_down = (node is not None and node.status is not None
                     and node.status.state == NodeState.DOWN)
        wait_stop = not (node_down or task.status.state > TaskState.RUNNING)
        self.delay_start(new.id, delay,
                         old_task=task if wait_stop else None)

    # ------------------------------------------------------------------
    def delay_start(self, task_id: str, delay: float,
                    old_task=None, old_tasks=None) -> None:
        """reference: DelayStart restart.go:395 — sleep the restart delay,
        then (when old task(s) are given) hold the replacement in READY
        until EVERY one of them stops running, its node goes down or
        disappears, or `old_task_timeout` elapses, so the slot never runs
        two tasks."""
        if task_id in self._delays:
            return
        olds = list(old_tasks or ([] if old_task is None else [old_task]))

        async def _timer():
            try:
                if delay > 0:
                    await self.clock.sleep(delay)
                if olds:
                    # ONE deadline across all old tasks: N stuck nodes must
                    # not compound the bound to N x old_task_timeout
                    deadline = self.clock.now() + self.old_task_timeout
                    for old in olds:
                        await self._wait_old_task_stopped(old, deadline)
                await self.store.update(lambda tx: self._promote(tx, task_id))
            except asyncio.CancelledError:
                pass
            except Exception:
                log.exception("delayed start of %s failed", task_id)
            finally:
                self._delays.pop(task_id, None)

        self._delays[task_id] = asyncio.get_running_loop().create_task(_timer())

    def _old_task_gone(self, old_task) -> bool:
        t = self.store.get("task", old_task.id)
        if t is None or t.status.state > TaskState.RUNNING:
            return True
        if old_task.node_id:
            n = self.store.get("node", old_task.node_id)
            if n is None or (n.status is not None
                             and n.status.state == NodeState.DOWN):
                return True
        return False

    async def _wait_old_task_stopped(self, old_task,
                                     deadline: Optional[float] = None
                                     ) -> None:
        """Event-driven wait (reference DelayStart's watch on the old
        task/node, restart.go:420): wake on updates to the old task or its
        node rather than polling, bounded by `deadline` (default: one
        old_task_timeout from now)."""
        def relevant(ev):
            from swarmkit_tpu_torch.store.memory import Event

            if not isinstance(ev, Event):
                return False
            return ((ev.kind == "task" and ev.object.id == old_task.id)
                    or (old_task.node_id and ev.kind == "node"
                        and ev.object.id == old_task.node_id))

        watcher = self.store.watch(relevant)
        try:
            # subscribe-then-check: an event between the check and the
            # subscription cannot be missed this way
            if self._old_task_gone(old_task):
                return
            if deadline is None:
                deadline = self.clock.now() + self.old_task_timeout
            timeout = asyncio.ensure_future(
                self.clock.sleep(max(0.0, deadline - self.clock.now())))
            try:
                while not self._old_task_gone(old_task):
                    ev = asyncio.ensure_future(watcher.get())
                    done, _ = await asyncio.wait(
                        {ev, timeout}, return_when=asyncio.FIRST_COMPLETED)
                    if ev not in done:
                        ev.cancel()
                    elif ev.exception() is not None:
                        # watcher torn down under us (WatcherClosed on
                        # store shutdown): no further events can arrive,
                        # so treat it as terminal and start the
                        # replacement instead of re-arming a get() that
                        # fails instantly until the deadline
                        return
                    if timeout in done:
                        return   # waited long enough; start anyway
            finally:
                timeout.cancel()
        finally:
            watcher.close()

    @staticmethod
    def _promote(tx, task_id: str) -> None:
        """reference: StartNow restart.go:487 — any task still desired
        below RUNNING is started; already-started or re-purposed tasks
        are left alone."""
        t = tx.get("task", task_id)
        if t is None or t.desired_state >= TaskState.RUNNING:
            return
        t.desired_state = int(TaskState.RUNNING)
        tx.update(t)

    def cancel_delay(self, task_id: str) -> None:
        timer = self._delays.pop(task_id, None)
        if timer is not None:
            timer.cancel()

    def clear_service_history(self, service_id: str) -> None:
        """reference: ClearServiceHistory restart.go:525 — forget strike
        counts when a service is removed."""
        for slot in [s for s in self._history if s[1] == service_id]:
            del self._history[slot]

    def pending_delays(self) -> int:
        return len(self._delays)
