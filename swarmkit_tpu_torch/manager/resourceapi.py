"""Agent-facing network-attachment task API.

Reference: manager/resourceapi/allocator.go (:124) — AttachNetwork creates
an attachment task bound to a node+network (used by the engine for
`docker run --network <swarm net>`), DetachNetwork removes it.

The port's own copy of the JAX package's manager/resourceapi.py.
"""

from __future__ import annotations

from swarmkit_tpu_torch.api import Task, TaskState, TaskStatus
from swarmkit_tpu_torch.api.specs import TaskSpec
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.identity import new_id


class ResourceError(Exception):
    pass


class ResourceApi:
    def __init__(self, store: MemoryStore, clock=None) -> None:
        self.store = store
        self.clock = clock

    async def attach_network(self, node_id: str, network_id: str,
                             container_id: str = "") -> str:
        task = Task(
            id=new_id(), node_id=node_id,
            spec=TaskSpec(networks=[network_id]),
            status=TaskStatus(state=TaskState.NEW,
                              message="network attachment requested"),
            desired_state=int(TaskState.RUNNING))
        task.annotations.labels["attachment-container"] = container_id

        def txn(tx):
            # existence checks inside the txn so a concurrent
            # remove_network/remove_node cannot slip between check+commit
            if tx.get("network", network_id) is None:
                raise ResourceError(f"network {network_id} not found")
            if tx.get("node", node_id) is None:
                raise ResourceError(f"node {node_id} not found")
            tx.create(task)
        await self.store.update(txn)
        return task.id

    async def detach_network(self, attachment_id: str) -> None:
        def txn(tx):
            t = tx.get("task", attachment_id)
            if t is None:
                raise ResourceError(f"attachment {attachment_id} not found")
            tx.delete("task", attachment_id)
        await self.store.update(txn)
