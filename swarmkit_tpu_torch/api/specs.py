"""User-intent specs. Reference: api/specs.proto.

The port's own copy of the JAX package's api/specs.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.types import (
    Annotations, Driver, EndpointSpecRef, IPAMOptions, NodeAvailability,
    NodeRole, PortConfig,
)


class Mode(enum.IntEnum):
    REPLICATED = 0
    GLOBAL = 1


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


class RestartCondition(enum.IntEnum):
    NONE = 0
    ON_FAILURE = 1
    ANY = 2


@dataclass
class RestartPolicy(Message):
    condition: RestartCondition = RestartCondition.ANY
    delay: float = 5.0
    max_attempts: int = 0  # 0 = unlimited
    window: float = 0.0    # seconds; 0 = unbounded attempt window


@dataclass
class Placement(Message):
    constraints: list[str] = field(default_factory=list)
    preferences: list[str] = field(default_factory=list)  # "spread=node.labels.X"
    max_replicas: int = 0  # max replicas per node; 0 = unlimited
    platforms: list[str] = field(default_factory=list)  # "os/arch"


@dataclass
class Mount(Message):
    """Filesystem mount carried on the container spec (reference:
    api/types.proto Mount — bind/volume/tmpfs/npipe). The TPU executor has
    no container filesystem, so mounts ride the data model for executor
    implementations that do (and for API parity); source/target are
    template-expanded per task like the reference's expandMounts."""
    type: str = "bind"            # bind | volume | tmpfs | npipe
    source: str = ""
    target: str = ""
    read_only: bool = False
    volume_labels: dict[str, str] = field(default_factory=dict)


@dataclass
class ContainerSpec(Message):
    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    dir: str = ""
    user: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    secrets: list["SecretReference"] = field(default_factory=list)
    configs: list["ConfigReference"] = field(default_factory=list)
    hostname: str = ""
    stop_grace_period: float = 10.0
    pull_options: dict[str, str] = field(default_factory=dict)
    hosts: list[str] = field(default_factory=list)
    healthcheck: Optional[dict] = None
    mounts: list[Mount] = field(default_factory=list)


@dataclass
class SecretReference(Message):
    secret_id: str = ""
    secret_name: str = ""
    target_name: str = ""
    mode: int = 0o444
    uid: str = "0"
    gid: str = "0"


@dataclass
class ConfigReference(Message):
    config_id: str = ""
    config_name: str = ""
    target_name: str = ""
    mode: int = 0o444
    uid: str = "0"
    gid: str = "0"


@dataclass
class TaskSpec(Message):
    # runtime oneof — exactly one of container/attachment set.
    container: Optional[ContainerSpec] = None
    attachment: Optional[dict] = None  # network-attachment tasks
    resources: Optional[ResourceRequirements] = None
    restart: Optional[RestartPolicy] = None
    placement: Optional[Placement] = None
    networks: list[str] = field(default_factory=list)  # network ids
    log_driver: Optional[Driver] = None
    force_update: int = 0


class UpdateFailureAction(enum.IntEnum):
    PAUSE = 0
    CONTINUE = 1
    ROLLBACK = 2


class UpdateOrder(enum.IntEnum):
    STOP_FIRST = 0
    START_FIRST = 1


@dataclass
class UpdateConfig(Message):
    parallelism: int = 0  # 0 = all at once
    delay: float = 0.0
    failure_action: UpdateFailureAction = UpdateFailureAction.PAUSE
    monitor: float = 5.0
    max_failure_ratio: float = 0.0
    order: UpdateOrder = UpdateOrder.STOP_FIRST


@dataclass
class ReplicatedService(Message):
    replicas: int = 1


@dataclass
class GlobalService(Message):
    pass


@dataclass
class ServiceSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    task: TaskSpec = field(default_factory=TaskSpec)
    mode: Mode = Mode.REPLICATED
    replicated: Optional[ReplicatedService] = None
    global_: Optional[GlobalService] = None
    update: Optional[UpdateConfig] = None
    rollback: Optional[UpdateConfig] = None
    networks: list[str] = field(default_factory=list)
    endpoint: Optional[EndpointSpecRef] = None

    def replica_count(self) -> int:
        if self.mode == Mode.GLOBAL:
            return 0
        return self.replicated.replicas if self.replicated else 1


EndpointSpec = EndpointSpecRef


@dataclass
class NetworkSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    driver_config: Optional[Driver] = None
    ipv6_enabled: bool = False
    internal: bool = False
    ipam: Optional[IPAMOptions] = None
    attachable: bool = False
    ingress: bool = False


@dataclass
class SecretSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    driver: Optional[Driver] = None
    # reference api/specs.proto SecretSpec.Templating: when set (driver
    # name "golang"), the payload is template-expanded PER TASK when
    # served to a workload (template/expand.go:132 ExpandSecretSpec)
    templating: Optional[Driver] = None


@dataclass
class ConfigSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    templating: Optional[Driver] = None


# ---- cluster-level config (api/specs.proto ClusterSpec) -------------------

@dataclass
class RaftConfig(Message):
    snapshot_interval: int = 10000       # entries between snapshots (raft.go:499)
    keep_old_snapshots: int = 0
    log_entries_for_slow_followers: int = 500
    heartbeat_tick: int = 1
    election_tick: int = 10


@dataclass
class ExternalCA(Message):
    protocol: str = "cfssl"
    url: str = ""
    options: dict[str, str] = field(default_factory=dict)
    ca_cert: bytes = b""


@dataclass
class CAConfig(Message):
    node_cert_expiry: float = 90 * 24 * 3600.0
    external_cas: list[ExternalCA] = field(default_factory=list)
    signing_ca_cert: bytes = b""
    signing_ca_key: bytes = b""
    force_rotate: int = 0


@dataclass
class DispatcherConfig(Message):
    heartbeat_period: float = 5.0  # dispatcher.go:31


@dataclass
class TaskDefaults(Message):
    log_driver: Optional[Driver] = None


@dataclass
class EncryptionConfig(Message):
    auto_lock_managers: bool = False


@dataclass
class OrchestrationConfig(Message):
    task_history_retention_limit: int = 5


@dataclass
class ClusterSpec(Message):
    annotations: Annotations = field(default_factory=Annotations)
    acceptance_policy: dict = field(default_factory=dict)
    orchestration: OrchestrationConfig = field(default_factory=OrchestrationConfig)
    raft: RaftConfig = field(default_factory=RaftConfig)
    dispatcher: DispatcherConfig = field(default_factory=DispatcherConfig)
    ca_config: CAConfig = field(default_factory=CAConfig)
    task_defaults: TaskDefaults = field(default_factory=TaskDefaults)
    encryption_config: EncryptionConfig = field(default_factory=EncryptionConfig)
