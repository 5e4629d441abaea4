"""The API objects the port's task executor and scheduler use."""

from swarmkit_tpu_torch.api.objects import (
    Config, Node, NodeStatus, Secret, Task,
)
from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.specs import (
    ConfigReference, ConfigSpec, ContainerSpec, NodeSpec, Placement,
    ResourceRequirements, Resources, SecretReference, SecretSpec, TaskSpec,
)
from swarmkit_tpu_torch.api.types import (
    TERMINAL_STATES, Annotations, Driver, Endpoint, EngineDescription,
    NetworkAttachment, NodeAvailability, NodeDescription, NodeResources,
    NodeRole, NodeState, Platform, PortConfig, TaskState, TaskStatus,
)

__all__ = [
    "Config", "Node", "NodeStatus", "Secret", "Task", "Message",
    "ConfigReference", "ConfigSpec", "ContainerSpec", "SecretSpec", "NodeSpec", "Placement", "ResourceRequirements",
    "Resources", "SecretReference", "TaskSpec", "TERMINAL_STATES",
    "Annotations", "Driver", "Endpoint", "EngineDescription",
    "NetworkAttachment", "NodeAvailability", "NodeDescription",
    "NodeResources", "NodeRole", "NodeState", "Platform", "PortConfig",
    "TaskState", "TaskStatus",
]
