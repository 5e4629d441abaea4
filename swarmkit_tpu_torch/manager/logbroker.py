"""Log message types of `service logs` (the port's own copy of the JAX
package's manager/logbroker.py LogStream, LogContext and LogMessage; the
broker itself is not ported)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class LogStream(enum.IntEnum):
    UNKNOWN = 0
    STDOUT = 1
    STDERR = 2


@dataclass
class LogContext:
    service_id: str = ""
    node_id: str = ""
    task_id: str = ""


@dataclass
class LogMessage:
    context: LogContext = field(default_factory=LogContext)
    timestamp: float = 0.0
    stream: LogStream = LogStream.STDOUT
    data: bytes = b""
    # producer-local monotonic position (TaskLogBuffer ring sequence)
    seq: int = 0
