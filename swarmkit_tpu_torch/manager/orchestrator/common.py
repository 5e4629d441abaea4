"""Shared orchestrator task helpers.

Reference: manager/orchestrator/task.go (NewTask, IsTaskDirty,
RestartCondition) and slot.go.

The port's own copy of the JAX package's manager/orchestrator/common.py.
"""

from __future__ import annotations

from typing import Optional

from swarmkit_tpu_torch.api import (
    Annotations, RestartCondition, RestartPolicy, Task, TaskState, TaskStatus,
)
from swarmkit_tpu_torch.utils.identity import new_id


def new_task(cluster, service, slot: int = 0, node_id: str = "") -> Task:
    """reference: orchestrator/task.go NewTask."""
    log_driver = service.spec.task.log_driver
    if log_driver is None and cluster is not None:
        # cluster-wide default (reference: newTask task.go reads
        # cluster.Spec.TaskDefaults.LogDriver)
        log_driver = cluster.spec.task_defaults.log_driver
    t = Task(
        id=new_id(),
        service_id=service.id,
        slot=slot,
        node_id=node_id,
        spec=service.spec.task.copy(),
        service_annotations=service.spec.annotations.copy(),
        status=TaskStatus(state=TaskState.NEW, message="created"),
        desired_state=int(TaskState.RUNNING),
        log_driver=log_driver,
    )
    t.annotations = Annotations(name=f"{service.spec.annotations.name}.{slot or node_id}.{t.id}")
    if service.spec.endpoint is not None:
        from swarmkit_tpu_torch.api.types import Endpoint
        t.endpoint = Endpoint(spec=service.spec.endpoint.copy())
    return t


def is_task_dirty(service, task) -> bool:
    """Spec divergence check (reference: task.go IsTaskDirty)."""
    return task.spec.to_dict() != service.spec.task.to_dict() \
        or (task.endpoint is not None and service.spec.endpoint is not None
            and task.endpoint.spec is not None
            and task.endpoint.spec.to_dict()
            != service.spec.endpoint.to_dict())


def restart_condition(task) -> RestartCondition:
    """reference: task.go RestartCondition (default ANY)."""
    if task.spec.restart is None:
        return RestartCondition.ANY
    return task.spec.restart.condition


def restart_policy(task) -> RestartPolicy:
    return task.spec.restart if task.spec.restart is not None \
        else RestartPolicy()


def slot_tuple(task) -> tuple:
    """Identity of the slot a task occupies (reference: slot.go)."""
    if task.service_id and task.slot:
        return ("slot", task.service_id, task.slot)
    return ("node", task.service_id, task.node_id)


def is_replicated(service) -> bool:
    from swarmkit_tpu_torch.api import Mode
    return service.spec.mode == Mode.REPLICATED


def is_global(service) -> bool:
    from swarmkit_tpu_torch.api import Mode
    return service.spec.mode == Mode.GLOBAL


def in_terminal_state(task) -> bool:
    from swarmkit_tpu_torch.api.types import TERMINAL_STATES
    return task.status.state in TERMINAL_STATES


def runnable(task) -> bool:
    """Task still wants to run (desired <= RUNNING and not failed out)."""
    return task.desired_state <= TaskState.RUNNING \
        and not in_terminal_state(task)


def invalid_node(node) -> bool:
    """Node cannot host running tasks: gone, down, or drained
    (reference: orchestrator.InvalidNode task.go:141-145)."""
    from swarmkit_tpu_torch.api.types import NodeAvailability, NodeState
    return (node is None
            or node.status.state == NodeState.DOWN
            or node.spec.availability == NodeAvailability.DRAIN)
