"""The API objects the port's task executor and scheduler use."""

from swarmkit_tpu_torch.api.objects import Node, NodeStatus, Task
from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.specs import (
    ConfigReference, ContainerSpec, NodeSpec, Placement, ResourceRequirements,
    Resources, SecretReference, TaskSpec,
)
from swarmkit_tpu_torch.api.types import (
    TERMINAL_STATES, Annotations, Driver, Endpoint, EngineDescription,
    NetworkAttachment, NodeAvailability, NodeDescription, NodeResources,
    NodeRole, NodeState, Platform, PortConfig, TaskState, TaskStatus,
)

__all__ = [
    "Node", "NodeStatus", "Task", "Message", "ConfigReference",
    "ContainerSpec", "NodeSpec", "Placement", "ResourceRequirements",
    "Resources", "SecretReference", "TaskSpec", "TERMINAL_STATES",
    "Annotations", "Driver", "Endpoint", "EngineDescription",
    "NetworkAttachment", "NodeAvailability", "NodeDescription",
    "NodeResources", "NodeRole", "NodeState", "Platform", "PortConfig",
    "TaskState", "TaskStatus",
]
