"""Fake runtime for tests and the in-process integration harness.

Reference: agent/testutils/fakes.go — TestExecutor (:24) instantly "runs"
tasks; its controllers succeed at every step and block in Wait until shut
down, so orchestration logic can be exercised with no real containers.

The port's own copy of the JAX package's agent/testutils.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from swarmkit_tpu_torch.agent.exec import Controller, Executor, TaskError
from swarmkit_tpu_torch.api.types import NodeDescription, NodeResources, Platform


class TestController(Controller):
    def __init__(self, task, executor: "TestExecutor") -> None:
        self.task = task
        self.executor = executor
        self.exit_evt = asyncio.Event()
        self.fail_msg: Optional[str] = None

    def write_log(self, line: str) -> None:
        """Test hook: emit a task output line into the executor's buffer."""
        import time

        from swarmkit_tpu_torch.manager.logbroker import LogStream

        self.executor.logs.publish(
            self.task.id, LogStream.STDOUT, line.encode(),
            service_id=self.task.service_id, node_id=self.task.node_id,
            timestamp=time.time())

    async def prepare(self) -> None:
        if self.executor.fail_prepare:
            raise TaskError("prepare failed (test)")
        # resolve referenced secrets/configs through the per-task templated
        # view (template/getter.go) so tests can assert expanded payloads
        deps = getattr(self.executor, "dependencies", None)
        self.resolved_secrets: dict[str, bytes] = {}
        self.resolved_configs: dict[str, bytes] = {}
        if deps is not None and self.task.spec.container is not None:
            view = deps.templated(self.task,
                                  (self.executor.configured_nodes or
                                   [None])[-1])
            for ref in self.task.spec.container.secrets:
                item = view.secrets.get(ref.secret_id)
                if item is not None:
                    self.resolved_secrets[ref.secret_name] = item.spec.data
            for ref in self.task.spec.container.configs:
                item = view.configs.get(ref.config_id)
                if item is not None:
                    self.resolved_configs[ref.config_name] = item.spec.data

    async def start(self) -> None:
        if self.executor.fail_start:
            raise TaskError("start failed (test)")
        self.write_log("started")

    async def wait(self) -> None:
        await self.exit_evt.wait()
        if self.fail_msg:
            raise TaskError(self.fail_msg)

    async def shutdown(self) -> None:
        self.exit_evt.set()

    async def terminate(self) -> None:
        self.exit_evt.set()

    # test hooks ---------------------------------------------------------
    def exit(self, fail: Optional[str] = None) -> None:
        """Make the fake workload exit (cleanly or with an error)."""
        self.fail_msg = fail
        self.exit_evt.set()


class TestExecutor(Executor):
    __test__ = False  # not a pytest class despite the name

    def __init__(self, hostname: str = "testhost",
                 cpus: int = 4_000_000_000, memory: int = 8 << 30) -> None:
        self.hostname = hostname
        self.cpus = cpus
        self.memory = memory
        from swarmkit_tpu_torch.agent.logs import TaskLogBuffer

        self.controllers: dict[str, TestController] = {}
        self.logs = TaskLogBuffer()
        self.fail_prepare = False
        self.fail_start = False
        self.configured_nodes: list = []
        self.bootstrap_keys: list = []

    async def describe(self) -> NodeDescription:
        return NodeDescription(
            hostname=self.hostname,
            platform=Platform(architecture="x86_64", os="linux"),
            resources=NodeResources(nano_cpus=self.cpus,
                                    memory_bytes=self.memory))

    async def configure(self, node) -> None:
        self.configured_nodes.append(node)

    async def controller(self, task) -> Controller:
        c = TestController(task, self)
        self.controllers[task.id] = c
        return c

    async def set_network_bootstrap_keys(self, keys) -> None:
        self.bootstrap_keys = list(keys)
