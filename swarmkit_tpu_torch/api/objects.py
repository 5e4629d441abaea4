"""Cluster state objects. Reference: api/objects.proto.

Every object: ``id`` + ``meta`` (version = raft index of last write) + a
user-intent ``spec`` + runtime state.  ``OBJECT_KINDS`` is the registry the
store's tables are generated from (replacing the reference's storeobject
protobuf plugin, protobuf/plugin/storeobject/).

The port's own copy of the JAX package's api/objects.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.specs import (
    ClusterSpec, ConfigSpec, NetworkSpec, NodeSpec, SecretSpec, ServiceSpec,
    TaskSpec,
)
from swarmkit_tpu_torch.api.types import (
    Annotations, Certificate, Endpoint, Meta, NetworkAttachment,
    NodeDescription, NodeRole, NodeState, TaskStatus, Driver, IPAMOptions,
)


@dataclass
class NodeStatus(Message):
    state: NodeState = NodeState.UNKNOWN
    message: str = ""
    addr: str = ""


@dataclass
class Node(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    description: Optional[NodeDescription] = None
    status: NodeStatus = field(default_factory=NodeStatus)
    manager_status: Optional[dict] = None  # {raft_id, addr, leader, reachability}
    attachment: Optional[NetworkAttachment] = None
    certificate: Certificate = field(default_factory=Certificate)
    role: NodeRole = NodeRole.WORKER  # observed role (cert-derived)

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class UpdateStatus(Message):
    state: str = ""  # updating|paused|completed|rollback_started|rollback_paused|rollback_completed
    started_at: float = 0.0
    completed_at: float = 0.0
    message: str = ""


@dataclass
class Service(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    previous_spec: Optional[ServiceSpec] = None
    endpoint: Optional[Endpoint] = None
    update_status: Optional[UpdateStatus] = None
    pending_delete: bool = False

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Task(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
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
    # (reference: Task.AssignedGenericResources, api/genericresource)
    assigned_generic: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class Network(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: NetworkSpec = field(default_factory=NetworkSpec)
    driver_state: Optional[Driver] = None
    ipam: Optional[IPAMOptions] = None

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class RootRotation(Message):
    """In-flight root-CA rotation (reference: api/ca.proto RootRotation):
    the new root + its cert cross-signed by the old root."""
    ca_cert: bytes = b""
    ca_key: bytes = b""
    cross_signed_ca_cert: bytes = b""


@dataclass
class RootCA(Message):
    ca_key: bytes = b""
    ca_cert: bytes = b""
    ca_cert_hash: str = ""
    join_token_worker: str = ""
    join_token_manager: str = ""
    root_rotation: Optional[RootRotation] = None


@dataclass
class EncryptionKey(Message):
    subsystem: str = ""
    algorithm: int = 0
    key: bytes = b""
    lamport_time: int = 0


@dataclass
class Cluster(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: ClusterSpec = field(default_factory=ClusterSpec)
    root_ca: RootCA = field(default_factory=RootCA)
    network_bootstrap_keys: list[EncryptionKey] = field(default_factory=list)
    encryption_key_lamport_clock: int = 0
    unlock_keys: list[EncryptionKey] = field(default_factory=list)
    fips: bool = False

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Secret(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: SecretSpec = field(default_factory=SecretSpec)
    internal: bool = False

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Config(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    spec: ConfigSpec = field(default_factory=ConfigSpec)

    @property
    def annotations(self) -> Annotations:
        return self.spec.annotations


@dataclass
class Resource(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    annotations: Annotations = field(default_factory=Annotations)
    kind: str = ""
    payload: bytes = b""


@dataclass
class Extension(Message):
    id: str = ""
    meta: Meta = field(default_factory=Meta)
    annotations: Annotations = field(default_factory=Annotations)
    description: str = ""


# Registry: kind name -> class (drives store table creation and StoreAction
# routing; replaces generated StoreObject plumbing).
OBJECT_KINDS: dict[str, type] = {
    "node": Node,
    "service": Service,
    "task": Task,
    "network": Network,
    "cluster": Cluster,
    "secret": Secret,
    "config": Config,
    "resource": Resource,
    "extension": Extension,
}

_CLASS_TO_KIND = {v: k for k, v in OBJECT_KINDS.items()}


def kind_of(obj) -> str:
    return _CLASS_TO_KIND[type(obj)]
