"""The Node and Task objects (the port's own copy of the JAX package's
api/objects.py Node, NodeStatus, Task, Secret and Config, without the
store's meta and the fields neither the executor nor the scheduler reads)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.specs import (
    ConfigSpec, NodeSpec, SecretSpec, TaskSpec,
)
from swarmkit_tpu_torch.api.types import (
    Annotations, Driver, Endpoint, NetworkAttachment, NodeDescription,
    NodeRole, NodeState, TaskStatus,
)


@dataclass
class NodeStatus(Message):
    state: NodeState = NodeState.UNKNOWN
    message: str = ""
    addr: str = ""


@dataclass
class Node(Message):
    id: str = ""
    spec: NodeSpec = field(default_factory=NodeSpec)
    description: Optional[NodeDescription] = None
    status: NodeStatus = field(default_factory=NodeStatus)
    role: NodeRole = NodeRole.WORKER  # observed role (cert-derived)

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Task(Message):
    id: str = ""
    annotations: Annotations = field(default_factory=Annotations)
    spec: TaskSpec = field(default_factory=TaskSpec)
    service_id: str = ""
    slot: int = 0
    node_id: str = ""
    status: TaskStatus = field(default_factory=TaskStatus)
    desired_state: int = 0  # TaskState value
    networks: list[NetworkAttachment] = field(default_factory=list)
    endpoint: Optional[Endpoint] = None
    log_driver: Optional[Driver] = None
    service_annotations: Annotations = field(default_factory=Annotations)
    # specific named-resource ids claimed by the scheduler for this task
    assigned_generic: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class Secret(Message):
    id: str = ""
    spec: SecretSpec = field(default_factory=SecretSpec)
    internal: bool = False

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Config(Message):
    id: str = ""
    spec: ConfigSpec = field(default_factory=ConfigSpec)

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations
