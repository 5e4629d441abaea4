"""Agent-side task log capture (the port's own copy of the JAX package's
agent/logs.py TaskLogBuffer).

The executor writes its tasks' stdout/stderr-equivalent lines into an
in-memory ring per task; `tail` reads them back.  The live fan-out
(`watch`) and the subscription publishers that ship lines to `service
logs` need the watch queue and the subscription pipeline, which are not
ported yet: this buffer has no `watch`.
"""

from __future__ import annotations

from collections import deque

from swarmkit_tpu_torch.manager.logbroker import (
    LogContext, LogMessage, LogStream,
)


class TaskLogBuffer:
    """Per-task ring of LogMessage, bounded per task."""

    def __init__(self, maxlen: int = 1000) -> None:
        self.maxlen = maxlen
        self._rings: dict[str, deque] = {}
        self._seq = 0                # monotonic ring position, all tasks

    def publish(self, task_id: str, stream: LogStream, data: bytes,
                service_id: str = "", node_id: str = "",
                timestamp: float = 0.0) -> None:
        self._seq += 1
        msg = LogMessage(
            context=LogContext(service_id=service_id, node_id=node_id,
                               task_id=task_id),
            timestamp=timestamp, stream=stream, data=data, seq=self._seq)
        self._rings.setdefault(task_id, deque(maxlen=self.maxlen)).append(msg)

    def tail(self, task_id: str, n: int = -1) -> list[LogMessage]:
        ring = self._rings.get(task_id)
        if not ring:
            return []
        msgs = list(ring)
        return msgs if n < 0 else msgs[len(msgs) - min(n, len(msgs)):]

    def drop(self, task_id: str) -> None:
        self._rings.pop(task_id, None)
