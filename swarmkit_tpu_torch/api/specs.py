"""The spec fields the executor and the scheduler read (the port's own
copy of the JAX package's api/specs.py NodeSpec, Resources,
ResourceRequirements, Placement, ContainerSpec, SecretReference,
ConfigReference, TaskSpec, SecretSpec and ConfigSpec; fields neither the
executor nor the scheduler reads are left out)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.types import (
    Annotations, Driver, NodeAvailability, NodeRole,
)


@dataclass
class NodeSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    desired_role: NodeRole = NodeRole.WORKER
    membership: int = 1  # MembershipState.ACCEPTED
    availability: NodeAvailability = NodeAvailability.ACTIVE


@dataclass
class Resources(Message):
    nano_cpus: int = 0
    memory_bytes: int = 0
    generic: dict[str, int] = field(default_factory=dict)


@dataclass
class ResourceRequirements(Message):
    limits: Optional[Resources] = None
    reservations: Optional[Resources] = None


@dataclass
class Placement(Message):
    constraints: list[str] = field(default_factory=list)
    preferences: list[str] = field(default_factory=list)  # "spread=node.labels.X"
    max_replicas: int = 0  # max replicas per node; 0 = unlimited
    platforms: list[str] = field(default_factory=list)  # "os/arch"


@dataclass
class SecretReference(Message):
    secret_id: str = ""
    secret_name: str = ""
    target_name: str = ""


@dataclass
class ConfigReference(Message):
    config_id: str = ""
    config_name: str = ""
    target_name: str = ""


@dataclass
class ContainerSpec(Message):
    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    secrets: list[SecretReference] = field(default_factory=list)
    configs: list[ConfigReference] = field(default_factory=list)


@dataclass
class TaskSpec(Message):
    container: Optional[ContainerSpec] = None
    resources: Optional[ResourceRequirements] = None
    placement: Optional[Placement] = None
    networks: list[str] = field(default_factory=list)  # network ids
    log_driver: Optional[Driver] = None


@dataclass
class SecretSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    driver: Optional[Driver] = None
    # when set (driver name "golang"), the payload is template-expanded
    # per task when served to a workload (template.expand_secret_spec)
    templating: Optional[Driver] = None


@dataclass
class ConfigSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    templating: Optional[Driver] = None
