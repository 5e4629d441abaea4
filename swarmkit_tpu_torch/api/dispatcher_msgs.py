"""Dispatcher wire messages. Reference: api/dispatcher.proto.

The reference defines the Dispatcher gRPC service (Session, Heartbeat,
UpdateTaskStatus, Tasks, Assignments) plus its message types.  Here they are
plain dataclasses flowing over in-process async streams; the gRPC bridge
(transport impl #2) serializes them when crossing hosts.

The port's own copy of the JAX package's api/dispatcher_msgs.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from swarmkit_tpu_torch.api.objects import Config, EncryptionKey, Node, Secret, Task
from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.types import TaskStatus, WeightedPeer


@dataclass
class SessionMessage(Message):
    """Reference: api/dispatcher.proto SessionMessage."""

    session_id: str = ""
    node: Optional[Node] = None
    managers: list[WeightedPeer] = field(default_factory=list)
    network_bootstrap_keys: list[EncryptionKey] = field(default_factory=list)
    root_ca: bytes = b""


@dataclass
class HeartbeatResponse(Message):
    period: float = 0.0  # seconds until next expected heartbeat


class AssignmentsType(enum.IntEnum):
    """Reference: api/dispatcher.proto AssignmentsMessage.Type."""

    COMPLETE = 0
    INCREMENTAL = 1


class AssignmentAction(enum.IntEnum):
    """Reference: api/dispatcher.proto AssignmentChange.AssignmentAction."""

    UPDATE = 0
    REMOVE = 1


@dataclass
class Assignment(Message):
    """One of task / secret / config (reference: Assignment oneof)."""

    task: Optional[Task] = None
    secret: Optional[Secret] = None
    config: Optional[Config] = None

    @property
    def item(self) -> Any:
        return self.task if self.task is not None else (
            self.secret if self.secret is not None else self.config)


@dataclass
class AssignmentChange(Message):
    assignment: Assignment = field(default_factory=Assignment)
    action: AssignmentAction = AssignmentAction.UPDATE


@dataclass
class AssignmentsMessage(Message):
    type: AssignmentsType = AssignmentsType.COMPLETE
    applies_to: str = ""
    results_in: str = ""
    changes: list[AssignmentChange] = field(default_factory=list)


@dataclass
class UpdateTaskStatusRequest(Message):
    """Reference: api/dispatcher.proto UpdateTaskStatusRequest."""

    session_id: str = ""
    updates: list[tuple[str, TaskStatus]] = field(default_factory=list)
