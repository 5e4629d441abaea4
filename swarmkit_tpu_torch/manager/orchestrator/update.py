"""Rolling-update supervisor.

Reference: manager/orchestrator/update/updater.go — one Updater per service
update (Supervisor.Update :50 dedups by service id), with parallelism, delay,
order (stop-first/start-first), monitor window, max_failure_ratio and
failure_action pause/continue/rollback (rollbackUpdate :587).  Progress and
outcome land in service.update_status.

The port's own copy of the JAX package's manager/orchestrator/update.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import (
    TaskState, UpdateConfig, UpdateFailureAction, UpdateOrder,
)
from swarmkit_tpu_torch.api.objects import UpdateStatus
from swarmkit_tpu_torch.manager.orchestrator import common
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.update")

# update_status.state values (reference: api UpdateStatus_UpdateState)
UPDATING = "updating"
PAUSED = "paused"
COMPLETED = "completed"
ROLLBACK_STARTED = "rollback_started"
ROLLBACK_PAUSED = "rollback_paused"
ROLLBACK_COMPLETED = "rollback_completed"


class UpdateSupervisor:
    """reference: update.Supervisor updater.go:27."""

    def __init__(self, store: MemoryStore, restart, clock: Optional[Clock] = None
                 ) -> None:
        self.store = store
        self.restart = restart
        self.clock = clock or SystemClock()
        self._updates: dict[str, asyncio.Task] = {}
        self._update_specs: dict[str, object] = {}

    def update(self, cluster, service, slots: list[list]) -> None:
        """Start the updater for a service; a second call with an UNCHANGED
        spec while one is running is a no-op — only a newer spec replaces the
        in-flight updater (reference: Supervisor.Update :50)."""
        # A paused update stays paused until the OPERATOR acts: a new
        # service-update resets update_status (controlapi), which is the
        # only resume path (reference: Updater.Run updater.go:130).
        if service.update_status is not None \
                and service.update_status.state in (PAUSED, ROLLBACK_PAUSED):
            return
        digest = service.spec.to_dict()
        old = self._updates.get(service.id)
        if old is not None and not old.done():
            if self._update_specs.get(service.id) == digest:
                return
            old.cancel()
        dirty = [s for s in slots if any(common.is_task_dirty(service, t)
                                         for t in s)]
        if not dirty:
            return
        self._update_specs[service.id] = digest
        # a spec restored by _rollback arrives flagged ROLLBACK_STARTED: run
        # the pass under the rollback config (reference: updater.go:125)
        rollback = (service.update_status is not None
                    and service.update_status.state == ROLLBACK_STARTED)
        self._updates[service.id] = asyncio.get_running_loop().create_task(
            self._run(cluster, service, slots, rollback=rollback))

    async def stop(self) -> None:
        for t in self._updates.values():
            t.cancel()
        for t in list(self._updates.values()):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._updates = {}

    # ------------------------------------------------------------------
    async def _run(self, cluster, service, slots: list[list],
                   rollback: bool = False) -> None:
        try:
            await self._run_update(cluster, service, slots, rollback=rollback)
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("update of service %s crashed", service.id)
        finally:
            # Only clear our own registration: a cancelled updater must not
            # pop the successor that replaced it (Supervisor.Update :50
            # replaces the map entry before the old goroutine winds down).
            if self._updates.get(service.id) is asyncio.current_task():
                self._updates.pop(service.id, None)
                self._update_specs.pop(service.id, None)

    def _config(self, service, rollback: bool) -> UpdateConfig:
        cfg = service.spec.rollback if rollback else service.spec.update
        return cfg if cfg is not None else UpdateConfig()

    async def _run_update(self, cluster, service, slots: list[list],
                          rollback: bool) -> None:
        cfg = self._config(service, rollback)
        parallelism = cfg.parallelism or len(slots) or 1
        dirty = [s for s in slots
                 if any(common.is_task_dirty(service, t) for t in s)]
        await self._set_status(
            service.id, ROLLBACK_STARTED if rollback else UPDATING,
            "update in progress")

        failures = 0
        total = len(dirty) or 1
        for i in range(0, len(dirty), parallelism):
            batch = dirty[i:i + parallelism]
            results = await asyncio.gather(
                *(self._update_slot(cluster, service, slot, cfg)
                  for slot in batch))
            failures += sum(1 for ok in results if not ok)
            if failures and failures / total > cfg.max_failure_ratio:
                action = cfg.failure_action
                if action == UpdateFailureAction.PAUSE:
                    await self._set_status(
                        service.id, ROLLBACK_PAUSED if rollback else PAUSED,
                        f"update paused after {failures} failures")
                    return
                if action == UpdateFailureAction.ROLLBACK and not rollback:
                    await self._rollback(cluster, service)
                    return
                # CONTINUE: fall through
            if cfg.delay > 0 and i + parallelism < len(dirty):
                await self.clock.sleep(cfg.delay)

        await self._set_status(
            service.id, ROLLBACK_COMPLETED if rollback else COMPLETED,
            "update completed")

    async def _update_slot(self, cluster, service, slot: list,
                           cfg: UpdateConfig) -> bool:
        """Replace one slot's task; True on success
        (reference: updateTask updater.go:411)."""
        # A half-updated slot may already hold a task matching the new
        # spec (an earlier updater died between create and cleanup):
        # finish the slot by removing the others instead of churning the
        # healthy new task (reference worker/useExistingTask
        # updater.go:313-485).
        clean = [t for t in slot if not common.is_task_dirty(service, t)]
        existing = next(
            (t for t in clean if t.desired_state == TaskState.RUNNING),
            None) or next(
            (t for t in clean if t.desired_state < TaskState.RUNNING), None)
        if existing is not None:
            draining: list = []
            reused = False

            def finish(tx):
                nonlocal reused
                draining.clear()
                # the slot snapshot is stale by the time this batch runs:
                # re-validate the candidate INSIDE the transaction — a
                # clean task that died meanwhile must not absorb the slot
                cur_ex = tx.get("task", existing.id)
                if cur_ex is None \
                        or cur_ex.desired_state > TaskState.RUNNING \
                        or common.in_terminal_state(cur_ex):
                    return
                reused = True
                for old in slot:
                    if old.id == existing.id:
                        continue
                    cur = tx.get("task", old.id)
                    if cur is not None \
                            and cur.desired_state <= TaskState.RUNNING:
                        cur.desired_state = int(TaskState.SHUTDOWN)
                        tx.update(cur)
                        if cur.status.state <= TaskState.RUNNING:
                            draining.append(cur)
            await self.store.update(finish)
            if reused:
                if existing.desired_state >= TaskState.RUNNING:
                    return True
                # parked below RUNNING: start it once ALL old tasks drain
                self.restart.delay_start(existing.id, 0.0,
                                         old_tasks=draining)
                return await self._wait_running(existing.id, cfg.monitor)
            # candidate died under us: fall through and create a fresh task

        slot_num = slot[0].slot if slot else 0
        node_id = slot[0].node_id if slot and not slot_num else ""
        new = common.new_task(cluster, service, slot=slot_num,
                              node_id=node_id)

        if cfg.order == UpdateOrder.START_FIRST:
            new.desired_state = int(TaskState.RUNNING)

            def txn(tx):
                tx.create(new)
            await self.store.update(txn)
            started = await self._wait_running(new.id, cfg.monitor)
            if not started:
                # keep the healthy old task: start-first exists precisely so
                # a failed replacement never takes the slot down
                return False

            def stop_old(tx):
                for old in slot:
                    cur = tx.get("task", old.id)
                    if cur is not None \
                            and cur.desired_state <= TaskState.RUNNING:
                        cur.desired_state = int(TaskState.SHUTDOWN)
                        tx.update(cur)
            await self.store.update(stop_old)
            return True
        else:  # STOP_FIRST
            new.desired_state = int(TaskState.READY)

            def txn(tx):
                for old in slot:
                    cur = tx.get("task", old.id)
                    if cur is not None \
                            and cur.desired_state <= TaskState.RUNNING:
                        cur.desired_state = int(TaskState.SHUTDOWN)
                        tx.update(cur)
                tx.create(new)
            await self.store.update(txn)
            await self._wait_shutdown(slot, cfg.monitor)

            def promote(tx):
                cur = tx.get("task", new.id)
                if cur is not None and cur.desired_state == TaskState.READY:
                    cur.desired_state = int(TaskState.RUNNING)
                    tx.update(cur)
            await self.store.update(promote)
            return await self._wait_running(new.id, cfg.monitor)

    async def _wait_running(self, task_id: str, monitor: float) -> bool:
        """Watch the task reach RUNNING (or fail) within the monitor window."""
        deadline = self.clock.now() + (monitor or 5.0)
        while self.clock.now() < deadline:
            t = self.store.get("task", task_id)
            if t is None:
                return False
            if t.status.state == TaskState.RUNNING:
                return True
            if common.in_terminal_state(t):
                return False
            await self.clock.sleep(0.05)
        # window elapsed without failure => treat as success if still moving
        t = self.store.get("task", task_id)
        return t is not None and not common.in_terminal_state(t)

    async def _wait_shutdown(self, slot: list, monitor: float) -> None:
        deadline = self.clock.now() + (monitor or 5.0)
        while self.clock.now() < deadline:
            tasks = [self.store.get("task", t.id) for t in slot]
            if all(t is None or common.in_terminal_state(t) for t in tasks):
                return
            await self.clock.sleep(0.05)

    async def _rollback(self, cluster, service) -> None:
        """reference: rollbackUpdate updater.go:587 — flip the spec back to
        previous_spec and let reconciliation re-run."""
        def txn(tx):
            s = tx.get("service", service.id)
            if s is None or s.previous_spec is None:
                return
            s.spec = s.previous_spec
            s.previous_spec = None
            s.update_status = UpdateStatus(
                state=ROLLBACK_STARTED, started_at=self.clock.now(),
                message="rolling back after update failure")
            tx.update(s)
        await self.store.update(txn)

    async def _set_status(self, service_id: str, state: str, message: str
                          ) -> None:
        def txn(tx):
            s = tx.get("service", service_id)
            if s is None:
                return
            if s.update_status is None:
                s.update_status = UpdateStatus(started_at=self.clock.now())
            s.update_status.state = state
            s.update_status.message = message
            if state in (COMPLETED, ROLLBACK_COMPLETED):
                s.update_status.completed_at = self.clock.now()
            tx.update(s)
        try:
            await self.store.update(txn)
        except Exception:
            log.exception("could not update service %s status", service_id)
