"""Status-report queue: dedup + retry of task status updates to the manager.

Reference: agent/reporter.go — statusReporter keeps the freshest status per
task id and a single goroutine drains the map via UpdateTaskStatus, putting
statuses back on failure so they retry on the next wakeup.

The port's own copy of the JAX package's agent/reporter.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from swarmkit_tpu_torch.api import TaskStatus
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.agent.reporter")


class StatusReporter:
    def __init__(self,
                 send: Callable[[list[tuple[str, TaskStatus]]], Awaitable[None]],
                 retry_delay: float = 0.1,
                 clock: Optional[Clock] = None) -> None:
        self._send = send
        self._retry_delay = retry_delay
        self._clock = clock or SystemClock()
        self._statuses: dict[str, TaskStatus] = {}
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    def update_status(self, task_id: str, status: TaskStatus) -> None:
        """Keep only the freshest status per task (reporter.go dedup)."""
        old = self._statuses.get(task_id)
        if old is not None and old.state > status.state:
            return
        self._statuses[task_id] = status
        self._wake.set()

    async def _run(self) -> None:
        try:
            while not self._closed:
                await self._wake.wait()
                self._wake.clear()
                while self._statuses and not self._closed:
                    batch, self._statuses = self._statuses, {}
                    try:
                        await self._send(list(batch.items()))
                    except Exception as e:
                        log.debug("status report failed, will retry: %s", e)
                        # put back anything not overwritten meanwhile
                        for tid, st in batch.items():
                            cur = self._statuses.get(tid)
                            if cur is None or cur.state < st.state:
                                self._statuses[tid] = st
                        await self._clock.sleep(self._retry_delay)
        except asyncio.CancelledError:
            pass
