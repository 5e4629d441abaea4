"""The agent event loop: owns one dispatcher session at a time, feeds the
worker, reports statuses, rebuilds the session with backoff on failure.

Reference: agent/agent.go — ``run`` (:179) is the select loop over session
messages / assignment sets / errors; handleSessionMessage (:393) absorbs
node updates, manager lists and bootstrap keys; session rebuild backoff at
agent.go:338-341 (max 8 s).

The port's own copy of the JAX package's agent/agent.py.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from swarmkit_tpu_torch.agent.exec import Executor
from swarmkit_tpu_torch.agent.reporter import StatusReporter
from swarmkit_tpu_torch.agent.session import Session
from swarmkit_tpu_torch.agent.storage import TaskDB
from swarmkit_tpu_torch.agent.worker import Worker
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.agent")

MAX_SESSION_BACKOFF = 8.0   # reference: agent.go:338-341


@dataclass
class AgentConfig:
    node_id: str
    executor: Executor
    # the connection-broker seam: returns a Dispatcher-shaped client
    # (reference: agent/config.go ConnBroker)
    connect: Callable[[], object] = None
    # LogBroker-shaped client factory (listen_subscriptions/publish_logs);
    # None disables the agent-side log pipeline (reference:
    # agent/session.go:249 logSubscriptions over the same connection)
    connect_logs: Callable[[], object] = None
    addr: str = ""
    db_path: str = ":memory:"
    clock: Optional[Clock] = None
    # notification hooks (reference: Agent node/manager update channels)
    on_node_change: Optional[Callable[[object], None]] = None
    on_managers_change: Optional[Callable[[list], None]] = None


class Agent:
    def __init__(self, config: AgentConfig) -> None:
        self.config = config
        self.clock = config.clock or SystemClock()
        self.worker = Worker(config.executor, TaskDB(config.db_path),
                             clock=self.clock)
        self.reporter: Optional[StatusReporter] = None
        self.session: Optional[Session] = None
        self.managers: list = []
        self._runner: Optional[asyncio.Task] = None
        self._running = False
        self._established = False
        self._ready = asyncio.Event()
        self._rng = random.Random()

    # ------------------------------------------------------------------
    async def start(self) -> None:
        await self.worker.init()
        self._running = True
        self._runner = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._running = False
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except (asyncio.CancelledError, Exception):
                pass
            self._runner = None
        await self._teardown_session()
        await self.worker.close()

    async def ready(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._ready.wait(), timeout)

    # ------------------------------------------------------------------
    async def _run(self) -> None:
        backoff = 0.0
        while self._running:
            self._established = False
            try:
                await self._run_session()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.info("agent %s: session failed: %s",
                         self.config.node_id, e)
            finally:
                await self._teardown_session()
            if not self._running:
                return
            self._ready.clear()
            if self._established:
                # a session that registered successfully resets the backoff
                # (reference: agent.go — registered resets the timer)
                backoff = 0.0
            if backoff:
                await self.clock.sleep(backoff * self._rng.uniform(0.5, 1.0))
            backoff = min(MAX_SESSION_BACKOFF, (backoff * 2) or 0.05)

    async def _run_session(self) -> None:
        description = await self.config.executor.describe()
        client = self.config.connect()
        session = Session(client, self.config.node_id, description,
                          self.config.addr, self.clock)
        await session.start()
        self.session = session

        reporter = StatusReporter(session.send_task_statuses,
                                  clock=self.clock)
        reporter.start()
        self.reporter = reporter
        self.worker.set_reporter(reporter.update_status)
        self._established = True
        self._ready.set()

        # agent side of `service logs`: subscription intake + publishers,
        # tied to the session lifetime (reference: session.go:249-273)
        self.log_loop = None
        log_buffer = getattr(self.config.executor, "logs", None)
        if self.config.connect_logs is not None and log_buffer is not None:
            from swarmkit_tpu_torch.agent.logs import LogSubscriptionLoop

            try:
                self.log_loop = LogSubscriptionLoop(
                    self.config.connect_logs(), self.worker, log_buffer,
                    self.config.node_id)
                self.log_loop.start()
            except Exception:
                log.exception("log subscription loop failed to start")

        # absorb the registration message (node object = template context)
        # BEFORE any assignment can race it
        if not session.session_msgs.empty():
            await self._handle_session_message(
                session.session_msgs.get_nowait())

        smsg = asyncio.ensure_future(session.session_msgs.get())
        amsg = asyncio.ensure_future(session.assignments.get())
        emsg = asyncio.ensure_future(session.errs.get())
        try:
            while self._running:
                done, _ = await asyncio.wait(
                    {smsg, amsg, emsg}, return_when=asyncio.FIRST_COMPLETED)
                if emsg in done:
                    raise emsg.result()
                if smsg in done:
                    await self._handle_session_message(smsg.result())
                    smsg = asyncio.ensure_future(session.session_msgs.get())
                if amsg in done:
                    await self.worker.assign(amsg.result())
                    amsg = asyncio.ensure_future(session.assignments.get())
        finally:
            for f in (smsg, amsg, emsg):
                f.cancel()

    async def _handle_session_message(self, msg) -> None:
        """reference: handleSessionMessage agent.go:393."""
        if msg.node is not None:
            self.worker.set_node(msg.node)   # template-expansion context
            try:
                await self.config.executor.configure(msg.node)
            except Exception:
                log.exception("executor.configure failed")
            if self.config.on_node_change is not None:
                self.config.on_node_change(msg.node)
        if msg.managers != self.managers:
            self.managers = list(msg.managers)
            if self.config.on_managers_change is not None:
                self.config.on_managers_change(self.managers)
        if msg.network_bootstrap_keys:
            try:
                await self.config.executor.set_network_bootstrap_keys(
                    msg.network_bootstrap_keys)
            except Exception:
                log.exception("setting network bootstrap keys failed")

    async def _teardown_session(self) -> None:
        if getattr(self, "log_loop", None) is not None:
            await self.log_loop.stop()
            self.log_loop = None
        self.worker.set_reporter(None)
        if self.reporter is not None:
            await self.reporter.close()
            self.reporter = None
        if self.session is not None:
            await self.session.close()
            self.session = None
