"""Scheduler's in-memory view of one node.

Reference: manager/scheduler/nodeinfo.go — NodeInfo wraps the store Node with
its task set, per-service active counts, and remaining resources, maintained
incrementally as tasks come and go.

The port's own copy of the JAX package's module of the same name, line
for line.
"""

from __future__ import annotations

from typing import Optional

from swarmkit_tpu_torch.api import TaskState


# reference nodeinfo.go: monitorFailures = 5*time.Minute, maxFailures = 5
FAILURE_WINDOW = 300.0
FAILURE_LIMIT = 5


def task_reserved(task) -> tuple[int, int, dict]:
    res = task.spec.resources
    if res is None or res.reservations is None:
        return 0, 0, {}
    r = res.reservations
    return r.nano_cpus, r.memory_bytes, dict(r.generic)


class NodeInfo:
    def __init__(self, node, tasks: Optional[dict] = None) -> None:
        self.node = node
        self.tasks: dict[str, object] = {}
        # ACTIVE (non-terminal desired) tasks per service
        self.active_tasks_per_service: dict[str, int] = {}
        self.available_cpus = 0
        self.available_memory = 0
        self.available_generic: dict[str, int] = {}
        # named string-set resources: kind -> ids still free on this node
        # (reference: api/genericresource string sets + nodeinfo claims)
        self.available_named: dict[str, set[str]] = {}
        self._advertised_named: dict[str, frozenset] = {}
        desc = node.description
        if desc is not None and desc.resources is not None:
            self.available_cpus = desc.resources.nano_cpus
            self.available_memory = desc.resources.memory_bytes
            self.available_generic = dict(desc.resources.generic)
            self.available_named = {
                k: set(v)
                for k, v in desc.resources.generic_named.items()}
            # releases are clamped to what the node CURRENTLY advertises —
            # a re-register that drops dead chips must not let a finishing
            # task resurrect them
            self._advertised_named = {
                k: frozenset(v)
                for k, v in desc.resources.generic_named.items()}
        # (service id, spec fingerprint) -> timestamps of recent task
        # failures on this node.  Keying by spec too means a service
        # update escapes the taint (reference versionedService,
        # nodeinfo.go:153) — failures of the broken old spec must not
        # penalize the fixed new one.
        self.recent_failures: dict[tuple, list[float]] = {}
        for t in (tasks or {}).values():
            self.add_task(t)

    @property
    def id(self) -> str:
        return self.node.id

    def counts_toward_load(self, task) -> bool:
        return task.desired_state <= TaskState.RUNNING \
            and task.status.state <= TaskState.RUNNING

    def add_task(self, task) -> bool:
        """reference: nodeinfo.go addTask."""
        if task.id in self.tasks:
            return False
        self.tasks[task.id] = task
        if self.counts_toward_load(task):
            cpus, mem, gen = task_reserved(task)
            self.available_cpus -= cpus
            self.available_memory -= mem
            for k, v in gen.items():
                # named kinds deduct their claimed ids below; a task with a
                # named-kind reservation but no recorded claim (scheduled
                # before the kind became named) falls back to the discrete
                # counter so the pool is not overcommitted
                if k in self.available_named and task.assigned_generic.get(k):
                    continue
                self.available_generic[k] = self.available_generic.get(k, 0) - v
            for k, ids in task.assigned_generic.items():
                self.available_named.setdefault(k, set()).difference_update(
                    ids)
            if task.service_id:
                self.active_tasks_per_service[task.service_id] = \
                    self.active_tasks_per_service.get(task.service_id, 0) + 1
        return True

    def remove_task(self, task) -> bool:
        old = self.tasks.pop(task.id, None)
        if old is None:
            return False
        if self.counts_toward_load(old):
            cpus, mem, gen = task_reserved(old)
            self.available_cpus += cpus
            self.available_memory += mem
            for k, v in gen.items():
                if k in self.available_named and old.assigned_generic.get(k):
                    continue
                self.available_generic[k] = self.available_generic.get(k, 0) + v
            for k, ids in old.assigned_generic.items():
                allowed = self._advertised_named.get(k, frozenset())
                self.available_named.setdefault(k, set()).update(
                    set(ids) & allowed)
            if old.service_id:
                n = self.active_tasks_per_service.get(old.service_id, 1) - 1
                if n <= 0:
                    self.active_tasks_per_service.pop(old.service_id, None)
                else:
                    self.active_tasks_per_service[old.service_id] = n
        return True

    def claim_named(self, requirements: dict) -> dict[str, list[str]]:
        """Pick the specific named ids satisfying a reservation on this
        node (reference: genericresource.Claim). Deterministic: sorted ids,
        lowest first. Caller records them on the task so add_task deducts
        exactly these."""
        claimed: dict[str, list[str]] = {}
        for k, v in requirements.items():
            pool = self.available_named.get(k)
            if pool is None:
                continue  # discrete kind
            ids = sorted(pool)[:v]
            if len(ids) < v:
                return {}
            claimed[k] = ids
        return claimed

    def active_task_count(self) -> int:
        return sum(1 for t in self.tasks.values()
                   if self.counts_toward_load(t))

    def count_for_service(self, service_id: str) -> int:
        return self.active_tasks_per_service.get(service_id, 0)

    @staticmethod
    def failure_key(task) -> tuple:
        """reference versionedService: service id + spec fingerprint.
        Fingerprinting serializes the spec — compute once per failure /
        per scheduling group, never inside a comparator."""
        return (task.service_id, task.spec.fingerprint())

    def record_failure(self, task, now: float,
                       window: float = FAILURE_WINDOW) -> None:
        """reference: nodeinfo.go taskFailed — failures keyed by the
        versioned service (service id + spec).  Also sweeps keys whose
        newest failure left the window (superseded spec revisions would
        otherwise accumulate forever — the old key is never queried
        again once a service is updated; reference lastCleanup sweep,
        nodeinfo.go:181)."""
        dead = [k for k, ts in self.recent_failures.items()
                if not ts or now - ts[-1] >= window]
        for k in dead:
            del self.recent_failures[k]
        self.recent_failures.setdefault(self.failure_key(task),
                                        []).append(now)

    def taint(self, key: tuple, now: float, window: float = FAILURE_WINDOW,
              limit: int = FAILURE_LIMIT) -> bool:
        """True when this node has failed tasks of THIS service spec
        (key = failure_key(task), precomputed by the caller) too often
        lately (reference: countRecentFailures + backoff)."""
        hist = [t for t in self.recent_failures.get(key, ())
                if now - t < window]
        if hist:
            self.recent_failures[key] = hist
        else:
            self.recent_failures.pop(key, None)
        return len(hist) >= limit
