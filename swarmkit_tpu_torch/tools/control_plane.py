"""The control plane's leader pipeline on one store, driven as an operator
drives it.

An operator creates a service through the control API; the replicated
orchestrator makes its tasks; the allocator makes them schedulable (NEW
to PENDING); the scheduler's store loop places them
(one ``sched_place`` launch a spec group a tick); the dispatcher streams
the assignments to the agents; each agent's worker runs its tasks through
an executor and writes their status back.  Everything here runs that
composition over one ``MemoryStore``, without the raft node:

- ``package(modules)``: the classes one run composes, from ``MODULES``
  (the port's modules, by their names in the package) or from another
  mapping of the same names (the tests build one from the JAX package
  to run the same script through it);
- ``run_script``: the orchestration script (4 nodes; 12 replicas; scale
  to 20, then 6; a task fails and is replaced after its restart delay;
  an image update with parallelism 2; a node drained; the service
  removed) on a ``FakeClock``, with a normalized store after every step;
- ``world_into_store`` and ``place_through_store``: Docker's published
  scale (``sched_world.describe_world``, 30,000 replicas of group A)
  written into a store and placed through the orchestrator and the store
  loop, with the decisions in the order the ticks made them;
- ``task_startup``: swarm-bench's task-startup flow (time from
  ``create_service`` until every replica reports RUNNING, with per-task
  latency percentiles) on the store pipeline.

Run as a program, it places Docker's scale through the store once and
prints one JSON line: the seconds to quiet and their split.

    python -m swarmkit_tpu_torch.tools.control_plane [--device cpu]
        [--nodes 1000] [--replicas 30000] [--seed 0]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import itertools
import json
import random
import time
import types
from typing import Callable, Optional

import numpy as np

import swarmkit_tpu_torch.agent
import swarmkit_tpu_torch.agent.testutils
import swarmkit_tpu_torch.api
import swarmkit_tpu_torch.api.objects
import swarmkit_tpu_torch.manager.allocator
import swarmkit_tpu_torch.manager.controlapi
import swarmkit_tpu_torch.manager.dispatcher
import swarmkit_tpu_torch.manager.dispatcher.nodes
import swarmkit_tpu_torch.manager.orchestrator.common
import swarmkit_tpu_torch.manager.orchestrator.replicated
import swarmkit_tpu_torch.manager.scheduler.filters
import swarmkit_tpu_torch.manager.scheduler.nodeinfo
import swarmkit_tpu_torch.manager.scheduler.scheduler
import swarmkit_tpu_torch.metrics.registry
import swarmkit_tpu_torch.store.by
import swarmkit_tpu_torch.store.memory
import swarmkit_tpu_torch.utils.clock
from swarmkit_tpu_torch.api.types import TaskState
from swarmkit_tpu_torch.tools import sched_world as W

# the modules a run composes, by their names in the package
MODULES = {
    "api": swarmkit_tpu_torch.api,
    "api.objects": swarmkit_tpu_torch.api.objects,
    "store.memory": swarmkit_tpu_torch.store.memory,
    "store.by": swarmkit_tpu_torch.store.by,
    "agent": swarmkit_tpu_torch.agent,
    "agent.testutils": swarmkit_tpu_torch.agent.testutils,
    "manager.orchestrator.common":
        swarmkit_tpu_torch.manager.orchestrator.common,
    "manager.orchestrator.replicated":
        swarmkit_tpu_torch.manager.orchestrator.replicated,
    "manager.controlapi": swarmkit_tpu_torch.manager.controlapi,
    "manager.allocator": swarmkit_tpu_torch.manager.allocator,
    "manager.scheduler.scheduler":
        swarmkit_tpu_torch.manager.scheduler.scheduler,
    "manager.scheduler.nodeinfo":
        swarmkit_tpu_torch.manager.scheduler.nodeinfo,
    "manager.scheduler.filters": swarmkit_tpu_torch.manager.scheduler.filters,
    "manager.dispatcher": swarmkit_tpu_torch.manager.dispatcher,
    "manager.dispatcher.nodes": swarmkit_tpu_torch.manager.dispatcher.nodes,
    "utils.clock": swarmkit_tpu_torch.utils.clock,
    "metrics.registry": swarmkit_tpu_torch.metrics.registry}

# the modules of the pipeline that mint object ids
ID_MINTERS = ("manager.orchestrator.common", "manager.controlapi",
              "manager.dispatcher.nodes")


def package(modules: Optional[dict] = None) -> types.SimpleNamespace:
    """The modules and classes of the leader pipeline, from `modules`
    (``MODULES`` by default: the port's)."""
    mod = (modules or MODULES).__getitem__
    return types.SimpleNamespace(
        api=mod("api"), objects=mod("api.objects"),
        MemoryStore=mod("store.memory").MemoryStore,
        match=mod("store.memory").match,
        by=mod("store.by"), common=mod("manager.orchestrator.common"),
        ControlApi=mod("manager.controlapi").ControlApi,
        Allocator=mod("manager.allocator").Allocator,
        ReplicatedOrchestrator=mod(
            "manager.orchestrator.replicated").ReplicatedOrchestrator,
        Scheduler=mod("manager.scheduler.scheduler").Scheduler,
        NodeInfo=mod("manager.scheduler.nodeinfo").NodeInfo,
        nodeinfo=mod("manager.scheduler.nodeinfo"),
        filters=mod("manager.scheduler.filters"),
        Dispatcher=mod("manager.dispatcher").Dispatcher,
        Agent=mod("agent").Agent, AgentConfig=mod("agent").AgentConfig,
        TestExecutor=mod("agent.testutils").TestExecutor,
        FakeClock=mod("utils.clock").FakeClock,
        SystemClock=mod("utils.clock").SystemClock,
        MetricsRegistry=mod("metrics.registry").MetricsRegistry,
        id_minters=[mod(m) for m in ID_MINTERS])


@contextlib.contextmanager
def counted_ids(pkg):
    """Mint ids from a counter instead of os.urandom while the block runs,
    in every module of `pkg` that mints them, so two runs of one script
    make the same ids, order the store's finds alike and iterate their
    id sets alike (within one process)."""
    mods = pkg.id_minters
    saved = [m.new_id for m in mods]
    counter = itertools.count(1)

    def new_id() -> str:
        return f"{next(counter):025d}"

    for m in mods:
        m.new_id = new_id
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.new_id = f


def service_spec(pkg, name: str, replicas: int, image: str = "nginx:1",
                 update=None, restart=None, placement=None,
                 resources=None, args=()):
    api = pkg.api
    return api.ServiceSpec(
        annotations=api.Annotations(name=name),
        task=api.TaskSpec(container=api.ContainerSpec(image=image,
                                                      args=list(args)),
                          restart=restart, placement=placement,
                          resources=resources),
        mode=api.Mode.REPLICATED, update=update,
        replicated=api.ReplicatedService(replicas=replicas))


# ---- the normalized store ------------------------------------------------

def normalized(store) -> dict:
    """What two runs of the pipeline must agree on, with ids replaced by
    what they stand for: per service (by name), each slot's tasks as
    sorted (desired, observed) states; per node, the count of its tasks
    by observed state; the nodes' status and availability; each service's
    update state.  The slot → node placement is kept apart, under
    "placement", as sorted node ids of each slot's tasks that still want
    to run."""
    services = {s.id: s.spec.annotations.name for s in store.find("service")}
    slots: dict = {}
    per_node: dict = {}
    placement: dict = {}
    for t in store.find("task"):
        name = services.get(t.service_id, "<removed>")
        key = str(t.slot) if t.slot else f"node:{t.node_id}"
        slots.setdefault(name, {}).setdefault(key, []).append(
            (int(t.desired_state), int(t.status.state)))
        if t.node_id:
            states = per_node.setdefault(t.node_id, {})
            st = t.status.state.name
            states[st] = states.get(st, 0) + 1
        if t.desired_state <= TaskState.RUNNING:
            placement.setdefault(name, {}).setdefault(key, []).append(
                t.node_id)
    for s in slots.values():
        for v in s.values():
            v.sort()
    for s in placement.values():
        for v in s.values():
            v.sort()
    nodes = {n.id: (n.status.state.name, n.spec.availability.name)
             for n in store.find("node")}
    updates = {s.spec.annotations.name:
               s.update_status.state if s.update_status else None
               for s in store.find("service")}
    return {"slots": slots, "per_node": per_node, "nodes": nodes,
            "updates": updates, "placement": placement}


# ---- the orchestration script -------------------------------------------

SCRIPT_NODES = 4
SCRIPT_REPLICAS = 12
SCRIPT_RESTART_DELAY = 5.0
SCRIPT_STEP = 0.05        # fake seconds per clock advance
SCRIPT_SETTLE = 20.0      # fake seconds each step runs for


class Pipeline:
    """The leader pipeline over one store on `clock`: a dispatcher, the
    scheduler's store loop, the allocator, the replicated orchestrator,
    the control API and one agent a node, each agent's executor from
    `executor(i)`."""

    def __init__(self, pkg, clock, sched_kw: dict, nodes: int,
                 executor: Callable[[int], object]) -> None:
        self.pkg = pkg
        self.clock = clock
        self.store = pkg.MemoryStore(clock=clock.now)
        self.obs = pkg.MetricsRegistry()
        self.dispatcher = pkg.Dispatcher(self.store, clock=clock,
                                         rng=random.Random(0), obs=self.obs)
        self.scheduler = pkg.Scheduler(self.store, clock=clock,
                                       obs=self.obs, **sched_kw)
        self.orchestrator = pkg.ReplicatedOrchestrator(self.store,
                                                       clock=clock)
        self.allocator = pkg.Allocator(self.store, clock=clock)
        self.control = pkg.ControlApi(self.store)
        self.n_nodes = nodes
        self.executors = [executor(i) for i in range(1, nodes + 1)]
        self.agents: list = []

    async def start(self) -> None:
        api, objects = self.pkg.api, self.pkg.objects
        for i in range(1, self.n_nodes + 1):
            node = api.Node(
                id=f"node{i}", spec=api.NodeSpec(
                    annotations=api.Annotations(name=f"node{i}")),
                status=objects.NodeStatus(state=api.NodeState.UNKNOWN))
            await self.store.update(lambda tx, n=node: tx.create(n))
        await self.dispatcher.start(mark_unknown=False)
        await self.scheduler.start()
        await self.allocator.start()
        await self.orchestrator.start()
        for i, ex in enumerate(self.executors, start=1):
            a = self.pkg.Agent(self.pkg.AgentConfig(
                node_id=f"node{i}", executor=ex,
                connect=lambda: self.dispatcher, clock=self.clock))
            await a.start()
            self.agents.append(a)

    async def settle(self, seconds: float, step: float = SCRIPT_STEP) -> None:
        """Let the pipeline run `seconds` of its clock, in `step`s."""
        spent = 0.0
        while spent < seconds - 1e-9:
            for _ in range(4):
                await asyncio.sleep(0)
            if isinstance(self.clock, self.pkg.FakeClock):
                await self.clock.advance(step)
            else:
                await asyncio.sleep(step)
            spent += step

    async def stop(self) -> None:
        for a in self.agents:
            await a.stop()
        await self.orchestrator.stop()
        await self.allocator.stop()
        await self.scheduler.stop()
        await self.dispatcher.stop()


def check_loops(*loops) -> None:
    """Raise the error of any of `loops` (control loops with a ``_task``)
    whose task has ended: a loop logs its crash and ends, so a run that
    waits on the store would otherwise wait out its timeout."""
    for loop in loops:
        task = loop._task
        if task is None or not task.done():
            continue
        exc = None if task.cancelled() else task.exception()
        if exc is not None:
            raise exc
        raise RuntimeError(f"the {type(loop).__name__}'s loop ended; its "
                           f"log says why")


LOOK = 0.5   # seconds between looks at the loops while waiting on a watch


async def next_event(watcher, loops, deadline: float,
                     what: Callable[[], str]):
    """The next event of `watcher`, raising a loop's error (check_loops)
    as soon as one of `loops` ends, and TimeoutError with `what()` once
    time.perf_counter() passes `deadline`."""
    while True:
        check_loops(*loops)
        left = deadline - time.perf_counter()
        if left <= 0:
            raise TimeoutError(what())
        try:
            return await asyncio.wait_for(watcher.get(), min(LOOK, left))
        except asyncio.TimeoutError:
            pass


def _first_live_task(store, service_id: str):
    """The live task of the service's lowest slot."""
    return min((t for t in store.find("task")
                if t.service_id == service_id
                and t.desired_state <= TaskState.RUNNING),
               key=lambda t: t.slot)


async def run_script(pkg, sched_kw: dict) -> list[tuple[str, dict]]:
    """The orchestration script on a FakeClock, with counted ids; returns
    (step, normalized store) after every step."""
    with counted_ids(pkg):
        return await _run_script(pkg, sched_kw)


async def _run_script(pkg, sched_kw: dict) -> list:
    api = pkg.api
    clock = pkg.FakeClock()
    p = Pipeline(pkg, clock, sched_kw, SCRIPT_NODES,
                 lambda i: pkg.TestExecutor(hostname=f"host{i}"))
    out: list[tuple[str, dict]] = []

    def snap(step: str) -> None:
        n = normalized(p.store)
        out.append((step, n))

    await p.start()
    await p.settle(2.0)
    restart = api.RestartPolicy(condition=api.RestartCondition.ANY,
                                delay=SCRIPT_RESTART_DELAY)
    update = api.UpdateConfig(parallelism=2, monitor=1.0)

    def spec(replicas, image="nginx:1"):
        return service_spec(pkg, "web", replicas, image=image,
                            update=update, restart=restart)

    try:
        svc = await p.control.create_service(spec(SCRIPT_REPLICAS))
        await p.settle(SCRIPT_SETTLE)
        snap("create 12")
        for replicas in (20, 6):
            cur = p.control.get_service(svc.id)
            await p.control.update_service(svc.id, spec(replicas),
                                           version=cur.meta.version.index)
            await p.settle(SCRIPT_SETTLE)
            snap(f"scale {replicas}")
        # one task fails: its replacement waits out the restart delay
        victim = _first_live_task(p.store, svc.id)
        ex = p.executors[int(victim.node_id[4:]) - 1]
        ex.controllers[victim.id].exit(fail="boom")
        await p.settle(SCRIPT_RESTART_DELAY / 2)
        snap("fail a task, within the delay")
        await p.settle(SCRIPT_SETTLE)
        snap("fail a task, replaced")
        cur = p.control.get_service(svc.id)
        await p.control.update_service(svc.id, spec(6, image="nginx:2"),
                                       version=cur.meta.version.index)
        await p.settle(SCRIPT_SETTLE)
        snap("image update")
        node = p.control.get_node(f"node{SCRIPT_NODES}")
        drained = node.spec.copy()
        drained.availability = api.NodeAvailability.DRAIN
        await p.control.update_node(node.id, drained,
                                    version=node.meta.version.index)
        await p.settle(SCRIPT_SETTLE)
        snap(f"drain node{SCRIPT_NODES}")
        await p.control.remove_service(svc.id)
        await p.settle(SCRIPT_SETTLE)
        snap("remove")
    finally:
        await p.stop()
    return out


def agreed(a: dict, b: dict) -> dict:
    """The entries of placement map `a` on which `b` agrees."""
    out = {}
    for name, slots in a.items():
        other = b.get(name, {})
        keep = {k: v for k, v in slots.items() if other.get(k) == v}
        if keep:
            out[name] = keep
    return out


def same_steps(want: list, got: list, trusted: Optional[list] = None
               ) -> list[str]:
    """The differences between two runs of the script: every part of the
    normalized store after every step, and the placement where `trusted`
    (a second run of the `want` side, or None for all of it) agrees with
    `want`."""
    diffs = []
    if [s for s, _ in want] != [s for s, _ in got]:
        return [f"steps {[s for s, _ in want]} != {[s for s, _ in got]}"]
    for i, ((step, w), (_, g)) in enumerate(zip(want, got)):
        for part in ("slots", "per_node", "nodes", "updates"):
            if w[part] != g[part]:
                diffs.append(f"{step}: {part} {w[part]} != {g[part]}")
        place = w["placement"] if trusted is None else \
            agreed(w["placement"], trusted[i][1]["placement"])
        for name, slots in place.items():
            for k, v in slots.items():
                if g["placement"].get(name, {}).get(k) != v:
                    diffs.append(f"{step}: {name} slot {k} on {v} != "
                                 f"{g['placement'].get(name, {}).get(k)}")
    return diffs


# ---- Docker's scale through the store -----------------------------------

# the running tasks that count for group A's spec
RUNNING_TWIN = "web-running"
OTHER = "other"


def docker_spec(pkg, replicas: int, name: str = W.SERVICE):
    """Group A's service: `replicas` replicas of 0.25 CPU / 512 MiB each,
    spread over node.labels.zone ("Scale Testing Docker Swarm to 30,000
    Containers", docker.com, 2015)."""
    api = pkg.api
    g = W.GROUPS["A"]
    return service_spec(
        pkg, name, replicas, image="nginx:alpine",
        placement=api.Placement(preferences=list(g["prefs"])),
        resources=api.ResourceRequirements(reservations=api.Resources(
            nano_cpus=g["cpus"], memory_bytes=g["mem"])))


async def _batched(store, objs: list) -> None:
    batch = store.batch()
    for o in objs:
        await batch.update(lambda tx, o=o: tx.create(o))
    await batch.commit()


async def world_into_store(pkg, store, desc: dict) -> dict:
    """Write `desc`'s nodes into `store` as node records (resources,
    zone label, availability, down state), and its running tasks as
    RUNNING task records: the ones `running_own` gives to group A's
    service belong to RUNNING_TWIN, a service with group A's spec (so
    they reserve what the world's do without counting toward the new
    service's replicas), the rest to OTHER, a service whose tasks reserve
    the same.  Returns the services by name."""
    api, objects = pkg.api, pkg.objects
    nodes = []
    for i in range(len(desc["zone"])):
        node_id = f"node-{i:04d}"
        nodes.append(api.Node(
            id=node_id,
            spec=api.NodeSpec(annotations=api.Annotations(
                name=node_id, labels={"zone": W.ZONES[desc["zone"][i]]}),
                availability=api.NodeAvailability.ACTIVE),
            description=api.NodeDescription(
                hostname=f"host-{i:04d}",
                platform=api.Platform(architecture="x86_64", os="linux"),
                resources=api.NodeResources(
                    nano_cpus=int(desc["cpus"][i]) * W.NANO,
                    memory_bytes=int(desc["mem_gib"][i]) * W.GIB)),
            status=objects.NodeStatus(state=api.NodeState.DOWN
                                      if desc["down"][i]
                                      else api.NodeState.READY)))
    await _batched(store, nodes)
    own = int(np.sum(desc["running_own"]))
    other = int(np.sum(desc["running"])) - own
    services = {
        RUNNING_TWIN: api.Service(id="svc-" + RUNNING_TWIN,
                                  spec=docker_spec(pkg, own, RUNNING_TWIN)),
        OTHER: api.Service(id="svc-" + OTHER, spec=service_spec(
            pkg, OTHER, other, image="redis:alpine",
            resources=api.ResourceRequirements(reservations=api.Resources(
                nano_cpus=W.RUNNING_CPUS, memory_bytes=W.RUNNING_MEM))))}
    await _batched(store, list(services.values()))
    tasks, slot = [], {RUNNING_TWIN: 0, OTHER: 0}
    for i in range(len(desc["zone"])):
        for j in range(int(desc["running"][i])):
            name = RUNNING_TWIN if j < int(desc["running_own"][i]) else OTHER
            slot[name] += 1
            t = pkg.common.new_task(None, services[name], slot=slot[name])
            t.id = f"run-{i:04d}-{j}"
            t.node_id = f"node-{i:04d}"
            t.status = api.TaskStatus(state=api.TaskState.RUNNING,
                                      message="started")
            tasks.append(t)
    await _batched(store, tasks)
    return services


async def taint_into_store(pkg, store, desc: dict, service) -> int:
    """The world's failure taints: FAILURE_LIMIT tasks of `service`'s
    spec on each tainted node, written RUNNING (desired SHUTDOWN, so
    nothing restarts them) and then FAILED, which the scheduler's store
    loop records as failures at its clock's now.  Returns their count."""
    api = pkg.api
    failed = []
    for i in np.flatnonzero(desc["tainted"]):
        for j in range(pkg.nodeinfo.FAILURE_LIMIT):
            t = pkg.common.new_task(None, service, slot=0)
            t.id = f"failed-{int(i):04d}-{j}"
            t.node_id = f"node-{int(i):04d}"
            t.desired_state = int(api.TaskState.SHUTDOWN)
            t.status = api.TaskStatus(state=api.TaskState.RUNNING)
            failed.append(t)
    await _batched(store, failed)

    def fail(tx, tid):
        cur = tx.get("task", tid)
        cur.status.state = api.TaskState.FAILED
        cur.status.err = "task exited"
        tx.update(cur)
    batch = store.batch()
    for t in failed:
        await batch.update(lambda tx, tid=t.id: fail(tx, tid))
    await batch.commit()
    return len(failed)


class Stopwatch:
    """Wall seconds and calls of the functions it wraps (methods of an
    object, or functions of a module); `restore` puts them back."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._saved: list = []

    def wrap(self, obj, name: str, label: Optional[str] = None,
             on_call=None) -> None:
        fn = getattr(obj, name, None)
        if fn is None:       # a method this package's class does not have
            return
        label = label or name
        self._saved.append((obj, name, obj.__dict__.get(name)
                            if isinstance(obj, types.ModuleType) else None))
        self.seconds.setdefault(label, 0.0)
        self.calls.setdefault(label, 0)
        if asyncio.iscoroutinefunction(fn):
            async def timed(*a, **kw):
                if on_call is not None:
                    on_call(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return await fn(*a, **kw)
                finally:
                    self.seconds[label] += time.perf_counter() - t0
                    self.calls[label] += 1
        else:
            def timed(*a, **kw):
                if on_call is not None:
                    on_call(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds[label] += time.perf_counter() - t0
                    self.calls[label] += 1
        setattr(obj, name, timed)

    def restore(self) -> None:
        for obj, name, fn in reversed(self._saved):
            if fn is not None:
                setattr(obj, name, fn)
            else:
                obj.__dict__.pop(name, None)
        self._saved.clear()


QUIET_STEP = 0.02   # seconds between looks at the store


async def place_through_store(pkg, desc: dict, replicas: int,
                              sched_kw: dict, clock=None,
                              timeout: float = 600.0,
                              stopwatch: Optional[Stopwatch] = None
                              ) -> dict:
    """Docker's world in a store, then group A's service of `replicas`
    replicas through ControlApi.create_service, the replicated
    orchestrator and the scheduler's store loop until the store is quiet:
    every task of the service ASSIGNED, or PENDING with the scheduler's
    explanation, and nothing left to tick.  Returns the store, the
    service, the placed (task id, node id) pairs in the order the ticks
    placed them, the ids left pending, the starting node set's store
    contents and the seconds: from create_service to quiet, and in the
    orchestrator's reconcile, the scheduler's ticks and their parts."""
    clock = clock or pkg.SystemClock()
    fake = isinstance(clock, pkg.FakeClock)
    store = pkg.MemoryStore(clock=clock.now)
    obs = pkg.MetricsRegistry()
    t0 = time.perf_counter()
    await world_into_store(pkg, store, desc)
    setup_s = time.perf_counter() - t0
    start_nodes = store.find("node")
    start_tasks = store.find("task")

    sched = pkg.Scheduler(store, clock=clock, obs=obs, **sched_kw)
    orch = pkg.ReplicatedOrchestrator(store, clock=clock)
    alloc = pkg.Allocator(store, clock=clock)
    sw = stopwatch or Stopwatch()
    order: list[tuple[str, str]] = []
    ticks: list[int] = []
    sw.wrap(orch, "_reconcile")
    sw.wrap(alloc, "_alloc_tasks")
    sw.wrap(sched, "tick", on_call=lambda: ticks.append(
        len(sched.unassigned)))
    sw.wrap(sched, "_place")
    sw.wrap(sched, "_apply", on_call=lambda decisions: order.extend(
        (t.id, n) for t, n, _ in decisions))
    sw.wrap(sched, "_explain_unplaced")
    await sched.start()
    await alloc.start()
    await orch.start()

    api = pkg.api
    state: dict[str, tuple] = {}
    watcher = store.watch(pkg.match(kind="task"))
    t0 = time.perf_counter()
    svc = await pkg.ControlApi(store).create_service(
        docker_spec(pkg, replicas))
    # nothing has yielded to the loops since create_service: the failure
    # taints land before the orchestrator sees the service
    n_failed = await taint_into_store(pkg, store, desc, svc)
    if len(store.find("task", pkg.by.ByService(svc.id))) != n_failed:
        raise RuntimeError("the orchestrator ran before the taints landed")
    quiet_at = None      # when the store was last seen quiet
    while True:
        check_loops(sched, alloc, orch)
        moved = False
        while (ev := watcher.try_get()) is not None:
            moved = True
            t = ev.object
            if t.service_id == svc.id and not t.id.startswith("failed-"):
                if ev.action == "remove":
                    state.pop(t.id, None)
                else:
                    state[t.id] = (t.status.state, t.status.message)
        done = len(state) == replicas and all(
            s == api.TaskState.ASSIGNED
            or (s == api.TaskState.PENDING
                and m.startswith("no suitable node"))
            for s, m in state.values())
        idle = not sched.unassigned or not sched._changed_since_tick
        if not (done and idle):
            quiet_at = None
        elif moved or quiet_at is None:
            quiet_at = time.perf_counter()
        else:
            break        # quiet, and a whole wait brought no event
        if time.perf_counter() - t0 > timeout:
            assigned = sum(s == api.TaskState.ASSIGNED
                           for s, _ in state.values())
            raise TimeoutError(f"not quiet after {timeout} s: {len(state)} "
                               f"tasks, {assigned} assigned")
        if fake:
            await clock.advance(QUIET_STEP)
        else:
            # longer than the scheduler's debounce, so a pending tick shows
            await asyncio.sleep(max(QUIET_STEP, 2 * sched.commit_debounce))
    quiet_s = quiet_at - t0
    watcher.close()
    await orch.stop()
    await alloc.stop()
    await sched.stop()
    pending = [tid for tid, (s, _) in state.items()
               if s == api.TaskState.PENDING]
    return dict(store=store, service=svc, order=order, pending=pending,
                start_nodes=start_nodes, start_tasks=start_tasks,
                n_failed=n_failed, setup_s=setup_s, quiet_s=quiet_s,
                seconds=dict(sw.seconds), calls=dict(sw.calls),
                ticks=ticks, obs=obs, scheduler=sched)


def direct_schedule(pkg, run: dict, sched_kw: dict, clock=None) -> list:
    """One Scheduler.schedule over the starting node set of `run` (the
    store's nodes and running tasks before create_service, the failure
    taints recorded at `clock`'s now) with the service's tasks in the
    order the ticks placed them, then the ones left pending: the
    (task id, node id) decisions."""
    clock = clock or pkg.SystemClock()
    sched = pkg.Scheduler(clock=clock, obs=pkg.MetricsRegistry(), **sched_kw)
    tasks_by_node: dict[str, dict] = {}
    for t in run["start_tasks"]:
        tasks_by_node.setdefault(t.node_id, {})[t.id] = t
    store = run["store"]
    failed = [t for t in store.find("task", pkg.by.ByService(
        run["service"].id)) if t.id.startswith("failed-")]
    for n in run["start_nodes"]:
        sched.node_set.add_or_update(
            pkg.NodeInfo(n, tasks_by_node.get(n.id, {})))
    now = clock.now()
    for t in failed:
        sched.node_set.get(t.node_id).record_failure(t, now)
    ids = [tid for tid, _ in run["order"]] + list(run["pending"])
    # the tasks as they were created: PENDING, no node
    tasks = []
    for tid in ids:
        t = store.get("task", tid)
        t.node_id = ""
        t.status = pkg.api.TaskStatus(state=pkg.api.TaskState.PENDING)
        t.assigned_generic = {}
        tasks.append(t)
    return [(t.id, n) for t, n, _ in sched.schedule(tasks)]


def placement_violations(pkg, store, service_id: str) -> list[str]:
    """What the store's final placement of `service_id` breaks: a node
    holding more than its resources (every task that counts toward its
    load reserved), a task of the service on a node that is down or
    drained, a task on a node its constraints exclude."""
    api = pkg.api
    by_node: dict[str, dict] = {}
    for t in store.find("task"):
        if t.node_id:
            by_node.setdefault(t.node_id, {})[t.id] = t
    out = []
    infos = {}
    for n in store.find("node"):
        info = infos[n.id] = pkg.NodeInfo(n, by_node.get(n.id, {}))
        if info.available_cpus < 0 or info.available_memory < 0:
            out.append(f"{n.id} over capacity: {info.available_cpus} cpu, "
                       f"{info.available_memory} bytes left")
    constraint = pkg.filters.ConstraintFilter()
    for t in store.find("task", pkg.by.ByService(service_id)):
        if not t.node_id or t.status.state != api.TaskState.ASSIGNED:
            continue
        n = infos[t.node_id].node
        if n.status.state != api.NodeState.READY \
                or n.spec.availability != api.NodeAvailability.ACTIVE:
            out.append(f"{t.id} on {n.id}, which is "
                       f"{n.status.state.name} / {n.spec.availability.name}")
        if constraint.set_task(t) and not constraint.check(infos[t.node_id]):
            out.append(f"{t.id} on {n.id} against its constraints")
    return out


# ---- swarm-bench's task-startup flow on the store pipeline ---------------

async def task_startup(pkg, replicas: int = 100, workers: int = 10,
                       sched_kw: Optional[dict] = None,
                       extra: Optional[object] = None, then=None,
                       timeout: float = 120.0) -> dict:
    """swarm-bench's task-startup flow without the raft quorum: `workers`
    agents with TestExecutors on the real clock, a service of `replicas`
    replicas, the time from create_service until every replica reports
    RUNNING, the per-task latency percentiles, and whether every task's
    observed states reached the store in FSM order.  With `extra`, one more
    agent runs that executor (its node is the last); `then(pipeline)` runs
    after the measurement, before the pipeline stops, and its result
    comes back under "then".  A control loop's error, or `timeout` seconds
    without every replica RUNNING, raises."""
    clock = pkg.SystemClock()
    n = workers + (extra is not None)
    p = Pipeline(pkg, clock, sched_kw or {}, n,
                 lambda i: extra if i > workers
                 else pkg.TestExecutor(hostname=f"w{i}"))
    await p.start()
    try:
        for a in p.agents:
            await a.ready()
        latencies: dict[str, float] = {}
        watcher = p.store.watch(pkg.match(kind="task", action="update"))
        start = time.perf_counter()
        svc = await p.control.create_service(
            service_spec(pkg, "bench", replicas, image="img",
                         placement=pkg.api.Placement(constraints=[
                             f"node.hostname!={h}"
                             for h in ([extra.hostname] if extra else [])])))
        running: set = set()
        seen: dict[str, list] = {}
        deadline = start + timeout
        while len(running) < replicas:
            ev = await next_event(
                watcher, (p.scheduler, p.allocator, p.orchestrator),
                deadline, lambda: f"{len(running)} of {replicas} tasks "
                f"RUNNING after {timeout} s")
            t = ev.object
            if t.service_id == svc.id:
                seen.setdefault(t.id, []).append(int(t.status.state))
            if t.service_id == svc.id \
                    and t.status.state == pkg.api.TaskState.RUNNING \
                    and t.id not in running:
                running.add(t.id)
                latencies[t.id] = time.perf_counter() - start
        watcher.close()
        total = time.perf_counter() - start
        lat = sorted(latencies.values())

        def pct(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        out = {"replicas": replicas, "workers": workers,
               "time_to_all_running_s": total,
               "tasks_per_s": replicas / total,
               "p50_s": pct(0.50), "p90_s": pct(0.90), "p99_s": pct(0.99),
               "fsm_ordered": all(v == sorted(v) for v in seen.values())}
        if then is not None:
            out["then"] = await then(p)
        return out
    finally:
        await p.stop()


async def run_program(p: Pipeline, executor, image: str, args: list,
                      replicas: int = 2, timeout: float = 600.0) -> dict:
    """A service of `replicas` replicas of program `image` with `args`,
    constrained to the node of `executor` (by hostname) with restart
    condition none, run through pipeline `p` until every task is
    COMPLETE (or one ends otherwise).  Returns, per task (by slot): the
    observed states in the order the store saw them, the final state and
    error, the result and the run seconds from the executor's log lines
    ("started on device" to "result: ...")."""
    api = p.pkg.api
    watcher = p.store.watch(p.pkg.match(kind="task"))
    spec = service_spec(
        p.pkg, "program", replicas, image=image, args=args,
        restart=api.RestartPolicy(condition=api.RestartCondition.NONE),
        placement=api.Placement(
            constraints=[f"node.hostname=={executor.hostname}"]))
    t0 = time.perf_counter()
    svc = await p.control.create_service(spec)
    seen: dict[str, list] = {}
    final: dict[str, object] = {}
    while len(final) < replicas:
        ev = await next_event(
            watcher, (p.scheduler, p.allocator, p.orchestrator),
            t0 + timeout, lambda: f"program tasks not done after {timeout} "
            f"s: { {k: v[-1] for k, v in seen.items()} }")
        t = ev.object
        if t.service_id != svc.id or ev.action == "remove":
            continue
        states = seen.setdefault(t.id, [])
        if not states or states[-1] != t.status.state:
            states.append(t.status.state)
        if t.status.state >= api.TaskState.COMPLETE:
            final[t.id] = t
    watcher.close()
    out = {}
    for tid, t in final.items():
        lines = {m.data.decode(): m.timestamp
                 for m in executor.logs.tail(tid)}
        result = next((float(line.split(": ", 1)[1]) for line in lines
                       if line.startswith("result: ")), None)
        started = lines.get("started on device")
        done = next((ts for line, ts in lines.items()
                     if line.startswith("result: ")), None)
        out[t.slot] = {
            "task": tid, "node": t.node_id, "states": [
                s.name for s in seen[tid]], "state": t.status.state.name,
            "err": t.status.err, "result": result,
            "run_s": (done - started) if started and done else None}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Docker's scale placed through the store pipeline")
    ap.add_argument("--device", default=None,
                    help="where the scheduler's kernel runs (default: the "
                    "CUDA card; cpu runs its plain loop)")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--replicas", type=int, default=30000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run = asyncio.run(place_through_store(
        package(), W.describe_world(seed=args.seed, nodes=args.nodes),
        args.replicas, {"device": args.device}))
    secs = run["seconds"]
    out = dict(device=args.device or "cuda", nodes=args.nodes, replicas=args.replicas,
               placed=len(run["order"]), pending=len(run["pending"]),
               setup_s=run["setup_s"], quiet_s=run["quiet_s"],
               orchestrator_s=secs["_reconcile"],
               allocator_s=secs["_alloc_tasks"], tick_s=secs["tick"],
               place_s=secs["_place"], apply_s=secs["_apply"],
               explain_s=secs["_explain_unplaced"])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
