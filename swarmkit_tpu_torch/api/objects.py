"""The Task object (the port's own copy of the JAX package's
api/objects.py Task, without the store's meta and network fields)."""

from __future__ import annotations

from dataclasses import dataclass, field

from swarmkit_tpu_torch.api.specs import TaskSpec
from swarmkit_tpu_torch.api.types import Annotations, TaskStatus


@dataclass
class Task:
    id: str = ""
    annotations: Annotations = field(default_factory=Annotations)
    spec: TaskSpec = field(default_factory=TaskSpec)
    service_id: str = ""
    slot: int = 0
    node_id: str = ""
    status: TaskStatus = field(default_factory=TaskStatus)
    desired_state: int = 0  # TaskState value
    service_annotations: Annotations = field(default_factory=Annotations)
    # specific named-resource ids claimed by the scheduler for this task
    assigned_generic: dict[str, list[str]] = field(default_factory=dict)
