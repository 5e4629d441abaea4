"""Per-task driver: one asyncio task advancing one Controller through the
FSM with ordered status reporting.

Reference: agent/task.go taskManager (:16, run :77) — a goroutine per task
calling exec.Do in a loop, absorbing task updates (desired-state flips) via
``update``, and pushing every observed status to the reporter.

The port's own copy of the JAX package's agent/task.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from swarmkit_tpu_torch.agent.exec import Controller, do_task_state
from swarmkit_tpu_torch.api import TaskState
from swarmkit_tpu_torch.utils.clock import Clock

log = logging.getLogger("swarmkit_tpu_torch.agent.task")


class TaskManager:
    def __init__(self, task, controller: Controller,
                 report: Callable[[str, object], Awaitable[None]],
                 clock: Clock) -> None:
        self.task = task.copy()
        self.controller = controller
        self.report = report
        self.clock = clock
        self._update_evt = asyncio.Event()
        self._runner: Optional[asyncio.Task] = None
        self._closed = False

    def start(self) -> None:
        self._runner = asyncio.get_running_loop().create_task(self._run())

    async def update(self, task) -> None:
        """Absorb a task update (reference: taskManager.Update task.go:38)."""
        self.task = task.copy()
        try:
            await self.controller.update(task)
        except Exception:
            pass
        self._update_evt.set()

    async def close(self) -> None:
        """Stop driving; does NOT shut the workload down (the worker decides
        whether that's wanted via desired_state)."""
        self._closed = True
        self._update_evt.set()
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except (asyncio.CancelledError, Exception):
                pass
            self._runner = None
        try:
            await self.controller.close()
        except Exception:
            pass

    @property
    def done(self) -> bool:
        return self.task.status.state >= TaskState.COMPLETE

    async def _run(self) -> None:
        try:
            while not self._closed:
                # race the FSM step against task updates so a desired-state
                # flip interrupts a blocked Wait (reference: task.go cancels
                # the in-flight Do when an update arrives)
                step = asyncio.ensure_future(do_task_state(
                    self.task, self.controller, self.clock.now()))
                upd = asyncio.ensure_future(self._update_evt.wait())
                try:
                    done, _ = await asyncio.wait(
                        {step, upd}, return_when=asyncio.FIRST_COMPLETED)
                except asyncio.CancelledError:
                    # close() cancelled the runner mid-wait: reap the
                    # in-flight FSM step too or it leaks (a blocked
                    # controller.wait() outlives the loop otherwise) —
                    # and AWAIT it so its unwind finishes before close()
                    # proceeds to controller.close()
                    step.cancel()
                    upd.cancel()
                    try:
                        await step
                    except (asyncio.CancelledError, Exception):
                        pass
                    raise
                if step in done:
                    upd.cancel()
                    status = step.result()
                    if status is None:
                        # terminal: park until an update changes the picture
                        await self._update_evt.wait()
                        self._update_evt.clear()
                        continue
                    self.task.status = status
                    await self.report(self.task.id, status)
                else:
                    step.cancel()
                    try:
                        await step
                    except (asyncio.CancelledError, Exception):
                        pass
                    self._update_evt.clear()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("task %s manager crashed", self.task.id)
