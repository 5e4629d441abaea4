"""The scheduler's group placement.

Reference: manager/scheduler/scheduler.go — groups unassigned tasks by
common spec key (commonSpecKey, :376), runs the filter pipeline once per
group, and picks least-loaded nodes with spread preferences
(scheduleTaskGroup :533).

The port's own copy of the group path of the JAX package's
manager/scheduler/scheduler.py: ``node_set``, ``pipeline``,
``_common_spec_key``, ``_schedule_group`` and ``_schedule_group_kernel``,
plus ``schedule`` (a tick's grouping and placement without the store).
The store watch, ``tick``, ``_apply``, ``_process_preassigned`` and
``_explain_unplaced`` read and write a ``MemoryStore``; the store is a
host-only layer that the port does not carry, so they are not here.
Callers fill ``node_set`` with ``NodeInfo`` mirrors and apply the
returned decisions themselves.  Unlike the JAX package, the port places
groups with its kernel by default (``use_kernel=True``, on the card
unless ``device="cpu"``); ``use_kernel=False`` asks for the host path.
"""

from __future__ import annotations

from typing import Optional

from swarmkit_tpu_torch.manager.scheduler import kernel as sched_kernel
from swarmkit_tpu_torch.manager.scheduler.filters import Pipeline
from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo, task_reserved
from swarmkit_tpu_torch.manager.scheduler.nodeset import NodeSet
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock


class Scheduler:
    def __init__(self, clock: Optional[Clock] = None,
                 obs: Optional[obs_registry.MetricsRegistry] = None,
                 use_kernel: bool = True, device=None) -> None:
        self.clock = clock or SystemClock()
        self.obs = obs or obs_registry.DEFAULT
        # the group-placement kernel (kernel.py) on `device`: the card
        # unless the caller asks for the CPU, and the default here where
        # the JAX package defaults to the host path.  use_kernel=False
        # asks for the host Pipeline below, which stays the oracle and
        # the fallback for the groups encode_group does not cover
        self.use_kernel = use_kernel
        self.device = device
        self._m_kernel_groups = obs_catalog.get(
            self.obs, "swarm_sched_kernel_groups_total")
        self._m_kernel_tasks = obs_catalog.get(
            self.obs, "swarm_sched_kernel_tasks_total")
        self._m_kernel_seconds = obs_catalog.get(
            self.obs, "swarm_sched_kernel_seconds")
        self._m_latency = obs_catalog.get(
            self.obs, "swarm_scheduler_latency_seconds")
        self._m_decisions = obs_catalog.get(
            self.obs, "swarm_scheduler_decisions_total")
        obs_catalog.get(self.obs, "swarm_scheduler_pending_tasks") \
            .set_function(lambda: float(len(self.unassigned)))
        self.node_set = NodeSet()
        # tasks the last schedule() call left unplaced
        self.unassigned: dict[str, object] = {}
        self.pipeline = Pipeline()

    @staticmethod
    def _common_spec_key(task) -> tuple:
        """Group tasks that can share one scheduling decision pipeline run
        (reference: commonSpecKey scheduler.go:376)."""
        return (task.service_id,
                task.spec.encode() if hasattr(task.spec, "encode")
                else repr(task.spec))

    def schedule(self, tasks: list) -> list[tuple[object, str, object]]:
        """Place `tasks` as one scheduler tick does: group them by common
        spec key, in arrival order, and place each group.  Returns the
        (task, node_id, mirrored-assigned-copy) triples; the tasks no node
        took stay in `unassigned`."""
        with self._m_latency.time():
            groups: dict[tuple, list] = {}
            for t in tasks:
                groups.setdefault(self._common_spec_key(t), []).append(t)
            decisions = []
            for group in groups.values():
                decisions.extend(self._schedule_group(group))
            placed = {t.id for t, _, _ in decisions}
            self.unassigned = {t.id: t for t in tasks if t.id not in placed}
            self._m_decisions.labels(result="assigned").inc(len(decisions))
            if self.unassigned:
                self._m_decisions.labels(result="unassigned") \
                    .inc(len(self.unassigned))
        return decisions

    def _schedule_group(self, tasks: list
                        ) -> list[tuple[object, str, object]]:
        """Returns (task, node_id, mirrored-assigned-copy) triples
        (reference: scheduleTaskGroup :533)."""
        sample = tasks[0]
        self.pipeline.set_task(sample)
        prefs = []
        if sample.spec.placement is not None:
            prefs = list(sample.spec.placement.preferences)
        service_id = sample.service_id

        def better(a: NodeInfo, b: NodeInfo) -> bool:
            ca, cb = a.count_for_service(service_id), b.count_for_service(service_id)
            if ca != cb:
                return ca < cb
            return a.active_task_count() < b.active_task_count()

        now = self.clock.now()
        fkey = NodeInfo.failure_key(sample)   # once per group, not per cmp

        def best(a: NodeInfo, b: NodeInfo) -> bool:
            # nodes that keep failing this service's tasks lose ties
            # (reference: nodeLess + countRecentFailures backoff)
            ta = a.taint(fkey, now)
            tb = b.taint(fkey, now)
            if ta != tb:
                return tb
            return better(a, b)

        if self.use_kernel:
            out = self._schedule_group_kernel(tasks, sample, prefs, fkey, now)
            if out is not None:
                return out
            self._m_kernel_groups.labels(path="host").inc()

        out = []
        for task in tasks:
            candidates = self.node_set.find_best_nodes(
                1, self.pipeline.process, prefs, best,
                load=lambda i: i.count_for_service(service_id))
            if not candidates:
                continue
            info = candidates[0]
            # mirror the assignment so the next pick sees updated load
            assigned = task.copy()
            assigned.node_id = info.id
            # claim concrete named-resource ids now so parallel decisions
            # in this pass cannot hand the same id to two tasks
            _, _, gen = task_reserved(task)
            if gen:
                assigned.assigned_generic = info.claim_named(gen)
            info.add_task(assigned)
            out.append((task, info.id, assigned))
        return out

    def _schedule_group_kernel(self, tasks, sample, prefs, fkey, now
                               ) -> Optional[list]:
        """The group fan-out on the device (kernel.py); None → host
        fallback for the cases the encoding does not cover."""
        node_list = list(self.node_set.nodes.values())
        if not node_list:
            return []
        with self._m_kernel_seconds.time():
            enc = sched_kernel.encode_group(sample, prefs, node_list,
                                            fkey, now)
            if enc is None:
                return None
            choices = sched_kernel.place_group(enc, len(tasks),
                                               device=self.device)
        self._m_kernel_groups.labels(path="kernel").inc()
        out = []
        for task, c in zip(tasks, choices):
            if c < 0:
                continue
            info = node_list[c]
            assigned = task.copy()
            assigned.node_id = info.id
            if enc.gen:
                assigned.assigned_generic = info.claim_named(enc.gen)
            info.add_task(assigned)
            out.append((task, info.id, assigned))
            self._m_kernel_tasks.inc()
        return out
