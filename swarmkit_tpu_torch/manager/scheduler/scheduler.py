"""Event-driven task scheduler.

Reference: manager/scheduler/scheduler.go — watches the store, keeps an
in-memory mirror of nodes + tasks, debounces commits (50 ms, max latency 1 s,
scheduler.go:123-128), groups unassigned tasks by common spec key
(commonSpecKey, :376), runs the filter pipeline once per group, and picks
least-loaded nodes with spread preferences (scheduleTaskGroup :533).
Decisions are applied in a store batch with retry when the task changed
underneath (applySchedulingDecisions :432).

The port's own copy of the JAX package's manager/scheduler/scheduler.py,
plus ``schedule`` (one tick's grouping and placement without the store,
for callers that fill ``node_set`` with ``NodeInfo`` mirrors and apply
the decisions themselves).  The store is optional: ``start``, ``tick``
and the rest of the store loop need one.  Where it differs:

- the port places groups with its kernel by default (``use_kernel=True``,
  on the card unless ``device="cpu"``); ``use_kernel=False`` asks for
  the host Pipeline, as the JAX package's default does.  A kernel launch
  that fails raises: the loop never falls back to the host to hide it.
  The host path stays for what the encoding does not cover (named
  generic resources, more than one spread level), counted under
  ``path="host"``;
- ``_explain_unplaced`` writes its messages through the store's
  ``Batch`` (the JAX package writes them in one transaction, which
  refuses more than ``MAX_CHANGES_PER_TRANSACTION`` changes and so
  stops the loop once that many tasks stay unplaced), and computes the
  explanation once per group of tasks the placement treats alike.  At
  200 messages or fewer the batch is that one transaction.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import TaskState
from swarmkit_tpu_torch.manager.scheduler import kernel as sched_kernel
from swarmkit_tpu_torch.manager.scheduler.filters import Pipeline
from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo, task_reserved
from swarmkit_tpu_torch.manager.scheduler.nodeset import NodeSet
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.store.errors import ErrSequenceConflict
from swarmkit_tpu_torch.store.memory import (
    Event, EventCommit, MemoryStore, match, match_commit,
)
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.scheduler")

COMMIT_DEBOUNCE = 0.050   # reference: scheduler.go:126
MAX_LATENCY = 1.0         # reference: scheduler.go:124


class Scheduler:
    def __init__(self, store: Optional[MemoryStore] = None,
                 clock: Optional[Clock] = None,
                 obs: Optional[obs_registry.MetricsRegistry] = None,
                 commit_debounce: float = COMMIT_DEBOUNCE,
                 max_latency: float = MAX_LATENCY,
                 use_kernel: bool = True, device=None) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self.obs = obs or obs_registry.DEFAULT
        # debounce knobs ride the injected Clock, so tests and the load
        # harness can run debounce-accurate without wall-clock sleeps
        self.commit_debounce = commit_debounce
        self.max_latency = max_latency
        # the group-placement kernel (kernel.py) on `device`: the card
        # unless the caller asks for the CPU.  use_kernel=False asks for
        # the host Pipeline below, which stays the oracle and the path
        # for the groups encode_group does not cover
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
            .set_function(lambda: float(len(self.unassigned)
                                        + len(self.preassigned)))
        self.node_set = NodeSet()
        self.unassigned: dict[str, object] = {}  # taskid -> task
        # PENDING tasks that arrived with a node already chosen (global
        # services pin one task per node): the scheduler still validates
        # the fit and flips them to ASSIGNED (reference:
        # pendingPreassignedTasks + processPreassignedTasks scheduler.go)
        self.preassigned: dict[str, object] = {}
        self.all_tasks: dict[str, object] = {}
        self.pipeline = Pipeline()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._changed_since_tick = True

    # ------------------------------------------------------------------
    async def start(self) -> None:
        # initial state (reference: Run :105 buildNodeSet under view)
        watcher = self.store.watch(match(kind="task"), match(kind="node"),
                                   match_commit)
        for t in self.store.find("task"):
            if t.status.state == TaskState.PENDING:
                if t.node_id:
                    self.preassigned[t.id] = t
                else:
                    self.unassigned[t.id] = t
            self.all_tasks[t.id] = t
        for n in self.store.find("node"):
            self.node_set.add_or_update(self._node_info(n))
        self._running = True
        self._task = asyncio.get_running_loop().create_task(
            self._run(watcher))

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    def _node_info(self, node) -> NodeInfo:
        tasks = {t.id: t for t in self.all_tasks.values()
                 if t.node_id == node.id}
        return NodeInfo(node, tasks)

    # ------------------------------------------------------------------
    async def _run(self, watcher) -> None:
        try:
            while self._running:
                ev = await watcher.get()
                dirty = self._handle(ev)
                # debounce: wait for a quiet 50 ms window (or 1 s max)
                start = self.clock.now()
                while self._running:
                    nxt = watcher.try_get()
                    if nxt is None:
                        await self.clock.sleep(self.commit_debounce)
                        nxt = watcher.try_get()
                        if nxt is None:
                            break
                    dirty = self._handle(nxt) or dirty
                    if self.clock.now() - start > self.max_latency:
                        break
                if dirty and self._running:
                    await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception:
            # the task keeps the error (a CUDA failure of the kernel path)
            # for whoever waits on the loop; stop() drops it
            log.exception("scheduler loop crashed")
            raise

    def _handle(self, ev) -> bool:
        """Update mirrors; return True when a tick might make progress."""
        if isinstance(ev, EventCommit):
            # only retry unassigned work when something actually changed
            # since the last tick — a commit alone can't make progress
            fire = self._changed_since_tick \
                and bool(self.unassigned or self.preassigned)
            return fire
        if not isinstance(ev, Event):
            return False
        if ev.kind == "node":
            self._changed_since_tick = True
            if ev.action == "remove":
                self.node_set.remove(ev.object.id)
            else:
                # rebuild NodeInfo so available_* reflect a changed
                # description (resources can grow/shrink on re-register) —
                # but carry the failure history forward: node status churn
                # (READY/DOWN flaps) must not reset the taint backoff
                old = self.node_set.get(ev.object.id)
                info = self._node_info(ev.object)
                if old is not None:
                    info.recent_failures = old.recent_failures
                self.node_set.add_or_update(info)
            return True
        if ev.kind == "task":
            self._changed_since_tick = True
            t = ev.object
            if ev.action == "remove":
                self.all_tasks.pop(t.id, None)
                self.unassigned.pop(t.id, None)
                self.preassigned.pop(t.id, None)
                if t.node_id:
                    info = self.node_set.get(t.node_id)
                    if info is not None:
                        info.remove_task(t)
                return False
            prev = self.all_tasks.get(t.id)
            self.all_tasks[t.id] = t
            if prev is not None and prev.node_id:
                info = self.node_set.get(prev.node_id)
                if info is not None:
                    info.remove_task(prev)
            if t.node_id:
                info = self.node_set.get(t.node_id)
                if info is not None:
                    info.add_task(t)
            # remember nodes that keep failing tasks so placement backs off
            # (reference: scheduler.go recording task failures per node)
            if ev.action == "update" and t.node_id \
                    and t.status.state in (TaskState.FAILED,
                                           TaskState.REJECTED) \
                    and (prev is None
                         or prev.status.state != t.status.state):
                info = self.node_set.get(t.node_id)
                if info is not None:
                    info.record_failure(t, self.clock.now())
            if t.status.state == TaskState.PENDING \
                    and t.desired_state <= TaskState.RUNNING:
                if t.node_id:
                    self.preassigned[t.id] = t
                    self.unassigned.pop(t.id, None)
                else:
                    self.unassigned[t.id] = t
                    self.preassigned.pop(t.id, None)
                return True
            self.unassigned.pop(t.id, None)
            self.preassigned.pop(t.id, None)
            return False
        return False

    # ------------------------------------------------------------------
    @staticmethod
    def _common_spec_key(task) -> tuple:
        """Group tasks that can share one scheduling decision pipeline run
        (reference: commonSpecKey scheduler.go:376)."""
        return (task.service_id,
                task.spec.encode() if hasattr(task.spec, "encode")
                else repr(task.spec))

    def _place(self, tasks: list) -> list[tuple[object, str, object]]:
        """Group `tasks` by common spec key, in arrival order, and place
        each group: the (task, node_id, mirrored-assigned-copy) triples."""
        groups: dict[tuple, list] = {}
        for t in tasks:
            groups.setdefault(self._common_spec_key(t), []).append(t)
        decisions = []
        for group in groups.values():
            decisions.extend(self._schedule_group(group))
        return decisions

    def schedule(self, tasks: list) -> list[tuple[object, str, object]]:
        """Place `tasks` as one scheduler tick does, without the store:
        returns the (task, node_id, mirrored-assigned-copy) triples; the
        tasks no node took stay in `unassigned`."""
        with self._m_latency.time():
            decisions = self._place(tasks)
            placed = {t.id for t, _, _ in decisions}
            self.unassigned = {t.id: t for t in tasks if t.id not in placed}
            self._m_decisions.labels(result="assigned").inc(len(decisions))
            if self.unassigned:
                self._m_decisions.labels(result="unassigned") \
                    .inc(len(self.unassigned))
        return decisions

    async def tick(self) -> None:
        """Schedule everything currently unassigned."""
        with self._m_latency.time():
            self._changed_since_tick = False
            if self.preassigned:
                await self._process_preassigned()
            decisions = self._place(list(self.unassigned.values()))
            placed = {t.id for t, _, _ in decisions}
            if decisions:
                await self._apply(decisions)
            # annotate tasks no filter would place so operators can see why
            # (reference: noSuitableNode scheduler.go — sets task status
            # message; taskFitNode does the same for preassigned misfits)
            unplaced = [t for t in self.unassigned.values()
                        if t.id not in placed] \
                + list(self.preassigned.values())
            if unplaced:
                self._m_decisions.labels(result="unassigned") \
                    .inc(len(unplaced))
            await self._explain_unplaced(unplaced)

    async def _process_preassigned(self) -> None:
        """Validate PENDING tasks whose node is already chosen and flip
        them to ASSIGNED (reference: processPreassignedTasks + taskFitNode
        scheduler.go:34-38).  A task whose pinned node fails the pipeline
        stays pending and is retried when the node changes."""
        fits = []
        for t in list(self.preassigned.values()):
            info = self.node_set.get(t.node_id)
            if info is None:
                continue
            # the event mirror already booked this task's reservation on
            # its pinned node — take it out so the task does not compete
            # with ITSELF (reference: processPreassignedTasks removes the
            # task from nodeInfo before taskFitNode)
            had = info.remove_task(t)
            self.pipeline.set_task(t)
            if self.pipeline.process(info):
                fits.append((t, info))
            elif had:
                info.add_task(t)
        if not fits:
            return
        batch = self.store.batch()
        applied: dict[str, bool] = {}
        for t, info in fits:
            def txn(tx, t=t):
                current = tx.get("task", t.id)
                if current is None \
                        or current.status.state != TaskState.PENDING \
                        or current.node_id != t.node_id \
                        or current.desired_state > TaskState.RUNNING:
                    return False
                current.status.state = TaskState.ASSIGNED
                current.status.message = "scheduler confirmed node fit"
                current.status.timestamp = self.clock.now()
                tx.update(current)
                return True

            try:
                applied[t.id] = await batch.update(txn)
            except ErrSequenceConflict:
                applied[t.id] = False
        await batch.commit()
        for t, info in fits:
            if applied.get(t.id):
                self.preassigned.pop(t.id, None)
                self._m_decisions.labels(result="preassigned").inc()
            # re-book the reservation either way (the fit check removed it)
            info.add_task(t)

    async def _explain_unplaced(self, tasks: list) -> None:
        updates = []
        # tasks the placement treats alike (one common spec key, and the
        # task fields the filters read) get one explanation
        explained: dict[tuple, str] = {}
        for t in tasks:
            if t.node_id:
                # pinned (preassigned): explain the fit against ITS node
                self.pipeline.set_task(t)
                info = self.node_set.get(t.node_id)
                reasons = {self.pipeline.explain(info)} if info is not None \
                    else {f"node {t.node_id} not in scheduler view"}
                msg = "; ".join(sorted(r for r in reasons if r)) or \
                    "no suitable node"
            else:
                key = (self._common_spec_key(t),
                       repr((t.log_driver, t.networks, t.endpoint)))
                msg = explained.get(key)
                if msg is None:
                    self.pipeline.set_task(t)
                    reasons = {self.pipeline.explain(i)
                               for i in self.node_set.nodes.values()} \
                        or {"no nodes"}
                    msg = explained[key] = "; ".join(
                        sorted(r for r in reasons if r)) or \
                        "no suitable node"
            if msg != t.status.message:
                updates.append((t.id, msg))
        if not updates:
            return

        def txn(tx, tid, msg):
            cur = tx.get("task", tid)
            if cur is not None and cur.status.message != msg:
                cur.status.message = msg
                tx.update(cur)
        batch = self.store.batch()
        for tid, msg in updates:
            await batch.update(lambda tx, tid=tid, msg=msg: txn(tx, tid, msg))
        await batch.commit()

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
        """The group fan-out on the device (kernel.py); None → the host
        path for the cases the encoding does not cover."""
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

    async def _apply(self, decisions: list[tuple[object, str, object]]) -> None:
        """reference: applySchedulingDecisions :432."""
        batch = self.store.batch()
        applied: dict[str, bool] = {}
        for task, node_id, _assigned in decisions:
            def txn(tx, task=task, node_id=node_id, _assigned=_assigned):
                current = tx.get("task", task.id)
                if current is None:
                    return False
                if current.status.state != TaskState.PENDING \
                        or current.node_id \
                        or current.desired_state > TaskState.RUNNING:
                    return False  # changed underneath; event flow will retry
                current.status.state = TaskState.ASSIGNED
                current.status.message = "scheduler assigned task"
                current.status.timestamp = self.clock.now()
                current.node_id = node_id
                current.assigned_generic = dict(_assigned.assigned_generic)
                tx.update(current)
                return True

            try:
                applied[task.id] = await batch.update(txn)
            except ErrSequenceConflict:
                applied[task.id] = False
        await batch.commit()
        for task, node_id, assigned in decisions:
            self.unassigned.pop(task.id, None)
            if applied.get(task.id):
                self._m_decisions.labels(result="assigned").inc()
            else:
                # roll the phantom copy back out of the node mirror
                # (reference: applySchedulingDecisions failure path)
                info = self.node_set.get(node_id)
                if info is not None:
                    info.remove_task(assigned)
