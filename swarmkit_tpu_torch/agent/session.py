"""One dispatcher session: registration stream, heartbeats, assignments,
status updates.

Reference: agent/session.go — ``session`` (:31) opens the Session stream
(start :120), then runs heartbeat (:176), watch/assignments (:282) and
status-update (:393) machinery against one manager connection; any error
closes the whole session and the agent rebuilds it with backoff.

The port's own copy of the JAX package's agent/session.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import TaskStatus
from swarmkit_tpu_torch.utils.clock import Clock

log = logging.getLogger("swarmkit_tpu_torch.agent.session")


class SessionError(Exception):
    pass


class Session:
    def __init__(self, client, node_id: str, description, addr: str,
                 clock: Clock) -> None:
        self.client = client          # Dispatcher-shaped (local or remote)
        self.node_id = node_id
        self.description = description
        self.addr = addr
        self.clock = clock
        self.session_id: str = ""
        self.session_msgs: asyncio.Queue = asyncio.Queue()
        self.assignments: asyncio.Queue = asyncio.Queue()
        self.errs: asyncio.Queue = asyncio.Queue()
        self._tasks: list[asyncio.Task] = []
        self._closed = False

    async def start(self) -> None:
        """Open the Session stream and wait for the first message (which
        carries the session id), then start heartbeat + assignments."""
        self._stream = self.client.session(
            self.node_id, self.description, addr=self.addr)
        first = await self._stream.__anext__()
        self.session_id = first.session_id
        await self.session_msgs.put(first)
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._consume_session()),
            loop.create_task(self._heartbeat()),
            loop.create_task(self._consume_assignments()),
        ]

    async def close(self) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []

    def _fail(self, err: Exception) -> None:
        if not self._closed:
            self.errs.put_nowait(err)

    # ------------------------------------------------------------------
    async def _consume_session(self) -> None:
        try:
            async for msg in self._stream:
                await self.session_msgs.put(msg)
            self._fail(SessionError("session stream closed"))
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self._fail(e)

    async def _heartbeat(self) -> None:
        period = 1.0
        try:
            while not self._closed:
                await self.clock.sleep(period)
                resp = await self.client.heartbeat(self.node_id,
                                                   self.session_id)
                period = resp.period
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self._fail(e)

    async def _consume_assignments(self) -> None:
        try:
            async for msg in self.client.assignments(self.node_id,
                                                     self.session_id):
                await self.assignments.put(msg)
            self._fail(SessionError("assignments stream closed"))
        except asyncio.CancelledError:
            pass
        except Exception as e:
            self._fail(e)

    # ------------------------------------------------------------------
    async def send_task_statuses(self, updates: list[tuple[str, TaskStatus]]
                                 ) -> None:
        await self.client.update_task_status(self.node_id, self.session_id,
                                             updates)
