"""The pluggable runtime seam: Executor / Controller interfaces and the
task-state advancer (the port's own copy of the JAX package's
agent/exec.py, unchanged in behaviour).

Reference: agent/exec/executor.go:9-23 (Executor: Describe/Configure/
Controller/SetNetworkBootstrapKeys) and agent/exec/controller.go:17-46
(Controller FSM: Update/Prepare/Start/Wait/Shutdown/Terminate/Remove/Close)
plus the ``Do`` state-advancer in controller.go — one observable transition
per call so every step is reported to the dispatcher in order.
"""

from __future__ import annotations

from typing import Optional

from swarmkit_tpu_torch.api.types import (
    NodeDescription, TaskState, TaskStatus,
)


class TaskError(Exception):
    """Controller operation failed.  The terminal state is chosen by
    WHERE the failure occurred, not by the exception type (reference
    fatal() switch controller.go:210-221): before STARTING the task is
    REJECTED, from STARTING on it is FAILED."""


class TaskRejected(TaskError):
    """Semantic marker: the node cannot run this task at all.  Raised
    from update()/prepare() it lands as REJECTED via the same
    where-it-failed rule above (an escape from start()/wait() would be
    FAILED like any other error there)."""


class Controller:
    """Drives one task through its lifecycle (agent/exec/controller.go:17)."""

    async def update(self, task) -> None:
        """Absorb a changed task spec (most runtimes reject real changes)."""

    async def prepare(self) -> None:
        """Allocate runtime resources (pull image, create container…)."""

    async def start(self) -> None:
        """Start the workload."""

    async def wait(self) -> None:
        """Block until the workload exits; raise TaskError on failure."""

    async def shutdown(self) -> None:
        """Gracefully stop."""

    async def terminate(self) -> None:
        """Forcefully stop."""

    async def remove(self) -> None:
        """Remove all resources."""

    async def close(self) -> None:
        """Release the controller itself."""


class Executor:
    """Factory + node description provider (agent/exec/executor.go:9)."""

    async def describe(self) -> NodeDescription:
        raise NotImplementedError

    async def configure(self, node) -> None:
        """Absorb node object changes (labels, certificates...)."""

    async def controller(self, task) -> Controller:
        raise NotImplementedError

    async def set_network_bootstrap_keys(self, keys) -> None:
        pass


def _status(task, state: TaskState, message: str, now: float,
            err: Optional[Exception] = None) -> TaskStatus:
    st = task.status.copy()
    st.state = state
    st.message = message
    st.timestamp = now
    if err is not None:
        st.err = str(err)
    return st


async def do_task_state(task, controller: Controller, now: float
                        ) -> Optional[TaskStatus]:
    """Advance the task one observable state (reference: exec.Do
    controller.go).  Returns the new status, or None when terminal.

    The switch mirrors the reference exactly: ASSIGNED→ACCEPTED→PREPARING→
    (Prepare)→READY→STARTING→(Start)→RUNNING→(Wait)→COMPLETE/FAILED, with
    desired_state >= SHUTDOWN short-circuiting to Shutdown at any point.
    """
    state = task.status.state
    if state >= TaskState.COMPLETE:
        return None  # terminal; nothing to do

    if task.desired_state in (TaskState.SHUTDOWN, TaskState.REMOVE):
        try:
            await controller.shutdown()
        except Exception:
            pass
        return _status(task, TaskState.SHUTDOWN, "shutdown", now)

    try:
        if state <= TaskState.ASSIGNED:
            return _status(task, TaskState.ACCEPTED, "accepted", now)
        if state == TaskState.ACCEPTED:
            return _status(task, TaskState.PREPARING, "preparing", now)
        if state == TaskState.PREPARING:
            await controller.prepare()
            return _status(task, TaskState.READY, "prepared", now)
        if state == TaskState.READY:
            # park here while desired_state <= READY: stop-first rolling
            # updates create replacements at desired READY and only promote
            # them to RUNNING once the old task is down (reference: exec.Do
            # gates on desired state; update.py:166-184 relies on it)
            if task.desired_state <= TaskState.READY:
                return None
            return _status(task, TaskState.STARTING, "starting", now)
        if state == TaskState.STARTING:
            await controller.start()
            return _status(task, TaskState.RUNNING, "started", now)
        if state == TaskState.RUNNING:
            await controller.wait()
            return _status(task, TaskState.COMPLETE, "finished", now)
    except Exception as e:
        # The reference's fatal() switch (controller.go:210-221) picks the
        # terminal state by WHERE the failure was encountered: before
        # STARTING the node never ran the workload, so the task is
        # REJECTED; from STARTING on it FAILED.  (Tasks.tla's agent table
        # encodes the same shape: rejected from assigned..starting, failed
        # from running.)
        if state < TaskState.STARTING:
            return _status(task, TaskState.REJECTED, "rejected", now, e)
        return _status(task, TaskState.FAILED, "failed", now, e)
    return None
