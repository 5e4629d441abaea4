"""Task states and the node description the executor advertises.

The port's own copy of the parts of the JAX package's api/types.py that
the task executor touches, as plain dataclasses with the same names,
fields and values, so the JAX package's objects also work where these are
expected (duck typing).
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass, field
from typing import Optional


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


@dataclass
class Annotations:
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)


@dataclass
class TaskStatus:
    timestamp: float = 0.0
    state: TaskState = TaskState.NEW
    message: str = ""
    err: str = ""
    container_exit_code: Optional[int] = None

    def copy(self) -> "TaskStatus":
        """An independent copy."""
        return copy.deepcopy(self)


@dataclass
class Platform:
    architecture: str = ""
    os: str = ""


@dataclass
class EngineDescription:
    engine_version: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    plugins: list[str] = field(default_factory=list)


@dataclass
class NodeResources:
    nano_cpus: int = 0
    memory_bytes: int = 0
    generic: dict[str, int] = field(default_factory=dict)
    # a SET of claimable string ids per kind (e.g. gpu-chip -> ["0"])
    generic_named: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class NodeDescription:
    hostname: str = ""
    platform: Platform = field(default_factory=Platform)
    resources: Optional[NodeResources] = None
    engine: EngineDescription = field(default_factory=EngineDescription)
