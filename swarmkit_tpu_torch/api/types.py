"""Core enums and shared message types.

Reference: api/types.proto (TaskState at :~500 — lamport-ordered enum with
gaps of 64 so states can be inserted), api/objects.proto Meta/Version.

The port's own copy of the JAX package's api/types.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.api.serde import Message


class TaskState(enum.IntEnum):
    """Observed/desired task states; ordering is meaningful (monotonic FSM).

    Values keep the reference's gaps of 64 (api/types.proto TaskState).
    """

    NEW = 0
    PENDING = 64
    ASSIGNED = 128
    ACCEPTED = 192
    PREPARING = 256
    READY = 320
    STARTING = 384
    RUNNING = 448
    COMPLETE = 512
    SHUTDOWN = 576
    FAILED = 640
    REJECTED = 704
    REMOVE = 768
    ORPHANED = 832


# States at or beyond which a task no longer consumes resources.
TERMINAL_STATES = (TaskState.COMPLETE, TaskState.SHUTDOWN, TaskState.FAILED,
                   TaskState.REJECTED, TaskState.REMOVE, TaskState.ORPHANED)


class NodeRole(enum.IntEnum):
    WORKER = 0
    MANAGER = 1


class NodeState(enum.IntEnum):
    UNKNOWN = 0
    DOWN = 1
    READY = 2
    DISCONNECTED = 3


class NodeAvailability(enum.IntEnum):
    ACTIVE = 0
    PAUSE = 1
    DRAIN = 2


class MembershipState(enum.IntEnum):
    PENDING = 0
    ACCEPTED = 1


@dataclass
class Version(Message):
    """Raft index of the last modification; optimistic-concurrency token
    (reference: api/objects.proto Meta.version)."""

    index: int = 0


@dataclass
class Meta(Message):
    version: Version = field(default_factory=Version)
    created_at: float = 0.0
    updated_at: float = 0.0


@dataclass
class Annotations(Message):
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)


@dataclass
class TaskStatus(Message):
    timestamp: float = 0.0
    state: TaskState = TaskState.NEW
    message: str = ""
    err: str = ""
    container_exit_code: Optional[int] = None


@dataclass
class Peer(Message):
    node_id: str = ""
    addr: str = ""


@dataclass
class WeightedPeer(Message):
    peer: Peer = field(default_factory=Peer)
    weight: int = 1


@dataclass
class RaftMemberStatus(Message):
    leader: bool = False
    reachability: int = 0  # 0 unknown, 1 unreachable, 2 reachable
    message: str = ""


@dataclass
class RaftMember(Message):
    raft_id: int = 0
    node_id: str = ""
    addr: str = ""
    status: RaftMemberStatus = field(default_factory=RaftMemberStatus)


@dataclass
class Platform(Message):
    architecture: str = ""
    os: str = ""


@dataclass
class EngineDescription(Message):
    engine_version: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    plugins: list[str] = field(default_factory=list)


@dataclass
class NodeDescription(Message):
    hostname: str = ""
    platform: Platform = field(default_factory=Platform)
    resources: Optional["NodeResources"] = None
    engine: EngineDescription = field(default_factory=EngineDescription)
    tls_info: Optional["NodeTLSInfo"] = None
    fips: bool = False


@dataclass
class NodeResources(Message):
    nano_cpus: int = 0
    memory_bytes: int = 0
    generic: dict[str, int] = field(default_factory=dict)
    # Named generic resources (reference: api/genericresource
    # NamedGenericResource): a SET of claimable string ids per kind (e.g.
    # tpu-chip -> ["0","1",...]); discrete `generic` counts and named sets
    # may coexist under different kinds
    generic_named: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class NodeTLSInfo(Message):
    trust_root: bytes = b""
    cert_issuer_subject: bytes = b""
    cert_issuer_public_key: bytes = b""


@dataclass
class Certificate(Message):
    role: NodeRole = NodeRole.WORKER
    csr: bytes = b""
    status_state: int = 0  # IssuanceState: 0 unknown,1 renew,2 pending,3 issued,4 failed,5 rotate
    certificate: bytes = b""
    cn: str = ""


class IssuanceState(enum.IntEnum):
    UNKNOWN = 0
    RENEW = 1
    PENDING = 2
    ISSUED = 3
    FAILED = 4
    ROTATE = 5


@dataclass
class Endpoint(Message):
    spec: Optional["EndpointSpecRef"] = None
    ports: list["PortConfig"] = field(default_factory=list)
    virtual_ips: list["EndpointVIP"] = field(default_factory=list)


@dataclass
class EndpointVIP(Message):
    network_id: str = ""
    addr: str = ""


@dataclass
class PortConfig(Message):
    name: str = ""
    protocol: str = "tcp"
    target_port: int = 0
    published_port: int = 0
    publish_mode: str = "ingress"  # ingress | host


@dataclass
class EndpointSpecRef(Message):
    mode: str = "vip"
    ports: list[PortConfig] = field(default_factory=list)


@dataclass
class NetworkAttachment(Message):
    network_id: str = ""
    addresses: list[str] = field(default_factory=list)
    aliases: list[str] = field(default_factory=list)
    # resolved network driver name (reference: NetworkAttachment.Network
    # .DriverState carried into the task so the scheduler's PluginFilter
    # needs no store lookup); "" = default driver
    driver: str = ""


@dataclass
class IPAMConfig(Message):
    family: str = "ipv4"
    subnet: str = ""
    ip_range: str = ""
    gateway: str = ""
    reserved: dict[str, str] = field(default_factory=dict)


@dataclass
class IPAMOptions(Message):
    driver: str = "default"
    configs: list[IPAMConfig] = field(default_factory=list)


@dataclass
class Driver(Message):
    name: str = ""
    options: dict[str, str] = field(default_factory=dict)
