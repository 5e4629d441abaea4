"""gRPC-health-protocol-shaped service registry.

Reference: manager/health/health.go (:21) — per-service SERVING /
NOT_SERVING statuses, checked by joiners before trusting a manager
(raft.go:1422 vote-health gating uses this).

The port's own copy of the JAX package's manager/health.py.
"""

from __future__ import annotations

import enum


class HealthStatus(enum.IntEnum):
    UNKNOWN = 0
    SERVING = 1
    NOT_SERVING = 2


class HealthServer:
    def __init__(self) -> None:
        self._statuses: dict[str, HealthStatus] = {}

    def set_serving_status(self, service: str, status: HealthStatus) -> None:
        self._statuses[service] = status

    def check(self, service: str = "") -> HealthStatus:
        return self._statuses.get(service, HealthStatus.UNKNOWN)

    def shutdown(self) -> None:
        for k in self._statuses:
            self._statuses[k] = HealthStatus.NOT_SERVING
