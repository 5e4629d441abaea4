"""Task and node states, and the descriptions the executor and the
scheduler read.

The port's own copy of the parts of the JAX package's api/types.py that
the task executor and the scheduler touch, as ``Message`` dataclasses
with the same names, fields and values, so the JAX package's objects also
work where these are expected (duck typing).
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
class Platform(Message):
    architecture: str = ""
    os: str = ""


@dataclass
class EngineDescription(Message):
    engine_version: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    plugins: list[str] = field(default_factory=list)


@dataclass
class NodeResources(Message):
    nano_cpus: int = 0
    memory_bytes: int = 0
    generic: dict[str, int] = field(default_factory=dict)
    # a SET of claimable string ids per kind (e.g. gpu-chip -> ["0"])
    generic_named: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class NodeDescription(Message):
    hostname: str = ""
    platform: Platform = field(default_factory=Platform)
    resources: Optional[NodeResources] = None
    engine: EngineDescription = field(default_factory=EngineDescription)


@dataclass
class PortConfig(Message):
    name: str = ""
    protocol: str = "tcp"
    target_port: int = 0
    published_port: int = 0
    publish_mode: str = "ingress"  # ingress | host


@dataclass
class Endpoint(Message):
    ports: list[PortConfig] = field(default_factory=list)


@dataclass
class NetworkAttachment(Message):
    network_id: str = ""
    addresses: list[str] = field(default_factory=list)
    aliases: list[str] = field(default_factory=list)
    # resolved network driver name, carried into the task so the
    # scheduler's PluginFilter needs no lookup; "" = default driver
    driver: str = ""


@dataclass
class Driver(Message):
    name: str = ""
    options: dict[str, str] = field(default_factory=dict)
