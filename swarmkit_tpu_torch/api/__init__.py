"""The API objects the port's task executor uses."""

from swarmkit_tpu_torch.api.objects import Task
from swarmkit_tpu_torch.api.specs import (
    ConfigReference, ContainerSpec, SecretReference, TaskSpec,
)
from swarmkit_tpu_torch.api.types import (
    TERMINAL_STATES, Annotations, EngineDescription, NodeDescription,
    NodeResources, Platform, TaskState, TaskStatus,
)

__all__ = [
    "Task", "ConfigReference", "ContainerSpec", "SecretReference",
    "TaskSpec", "TERMINAL_STATES", "Annotations", "EngineDescription",
    "NodeDescription", "NodeResources", "Platform", "TaskState",
    "TaskStatus",
]
