"""The port's Manager and its services against the JAX package's.

The cases of tests/test_manager.py and tests/test_manager_services.py,
each written once over a package and run through both on a FakeClock,
with ids minted from a counter in both runs:

- one manager: bootstrap seeds the default cluster and its own node
  record, health SERVING, the leader gauge; a service scheduled onto two
  agents' nodes and RUNNING; the dirty-state check;
- a 3-manager quorum: elect, replicate, kill the leader, re-elect, a write
  after the failover, and the old leader restarted from its state_dir,
  whose store must then equal the leader's;
- the services on one store: the key manager's seeding and rotation, the
  role manager's promote and demote, the watch and resource APIs, the log
  broker, the metrics collector, the task reaper and the constraint
  enforcer;
- the global orchestrator: at 200 tasks or fewer equal to the JAX
  package's (tasks and events); at 250 eligible nodes, where the JAX
  package's one transaction refuses the 250 creates, every eligible node
  gets its task.

After each step every manager's raft state, log (index, term, type) and
store equal the JAX package's, except what the JAX package draws at
random or from its CA: the cluster's ``root_ca`` fields (the port has no
CA yet) and the key manager's key bytes.  Once agents run tasks, their
status reports reach the leader in an order that raft timing decides,
and the store is compared as tests/test_torch_orchestration.py compares
it (tools/control_plane.py's ``normalized``).  The scheduler runs in both of
its modes: the JAX package's ``sched_use_kernel=True`` against the port's
kernel path on the CPU (its plain loop), and the JAX default against the
port's host Pipeline.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import random
import tempfile
import types

import pytest

from swarmkit_tpu_torch.tools import control_plane as cp
from tests.test_torch_raft_node import (
    assert_same_trace, node_view, store_view,
)

ID_MINTERS = ("manager.orchestrator.common", "manager.controlapi",
              "manager.dispatcher.nodes", "manager.resourceapi",
              "manager.logbroker")
TICK = 1.0
# the scheduler's two modes, per package
MODES = {"kernel": ({"sched_use_kernel": True}, {"device": "cpu"}),
         "host": ({}, {"sched_use_kernel": False})}


def package(root: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, api=m("api"), objects=m("api.objects"),
        Manager=m("manager.manager").Manager,
        Network=m("raft.transport").Network,
        FakeClock=m("utils.clock").FakeClock,
        MemoryStore=m("store.memory").MemoryStore,
        match=m("store.memory").match, by=m("store.by"),
        Agent=m("agent").Agent, AgentConfig=m("agent").AgentConfig,
        TestExecutor=m("agent.testutils").TestExecutor,
        health=m("manager.health"), keymanager=m("manager.keymanager"),
        role_manager=m("manager.role_manager"),
        watchapi=m("manager.watchapi"), resourceapi=m("manager.resourceapi"),
        logbroker=m("manager.logbroker"), metrics=m("manager.metrics"),
        global_=m("manager.orchestrator.global_"),
        reaper=m("manager.orchestrator.taskreaper"),
        enforcer=m("manager.orchestrator.constraintenforcer"),
        id_minters=[m(x) for x in ID_MINTERS])


def comparable(store, stamps: bool = True) -> dict:
    """store_view without what the JAX package draws at random or from
    its CA: the cluster's root_ca and the network keys' bytes; without
    `stamps`, also without the meta timestamps, which each replica stamps
    with its own clock when it applies an entry."""
    view = store_view(store)
    for d in view.get("cluster", {}).values():
        d["root_ca"] = None
        d["network_bootstrap_keys"] = [
            {**k, "key": None} for k in d["network_bootstrap_keys"]]
    if not stamps:
        for objs in view.values():
            for d in objs.values():
                d["meta"] = {**d["meta"], "created_at": None,
                             "updated_at": None}
    return view


def manager_view(m, loose: bool = False) -> dict:
    """A manager's raft state, log and store; with `loose`, where the
    agents' status reports may reach the leader in either order, only
    cp.normalized's view of the store (slots, placement, per-node
    counts) and no raft indexes."""
    if loose:
        v = {"store": cp.normalized(m.store)}
    else:
        v = node_view(m.raft, data=False)
        v["store"] = comparable(m.store)
    v["leading"] = m._is_leader
    # the JAX package's leader also starts its CA server (ca/, not ported)
    v["components"] = [type(c).__name__ for c in m._leader_components
                       if type(c).__name__ != "CAServer"]
    v["health"] = {s: int(m.health.check(s)) for s in (
        "Raft", "ControlAPI", "Watch", "ResourceAllocator")}
    v["gauges"] = m.metrics.snapshot()
    return v


class ManagerHarness:
    def __init__(self, P, kw: dict) -> None:
        self.P = P
        self.kw = kw
        self.clock = P.FakeClock()
        self.network = P.Network(seed=11)
        self.tmp = tempfile.TemporaryDirectory(prefix="torch-mgr-")
        self.managers: dict = {}
        self.agents: list = []

    def new_manager(self, i: int, join_addr: str = ""):
        m = self.P.Manager(
            node_id=f"m{i}", addr=f"m{i}.test:4242", network=self.network,
            state_dir=os.path.join(self.tmp.name, f"m{i}"),
            clock=self.clock, join_addr=join_addr, election_tick=4,
            heartbeat_tick=1, seed=31 + i, **self.kw)
        # the dispatcher jitters heartbeat periods from an unseeded rng;
        # seed it so both packages' runs mark nodes down alike
        m.dispatcher.nodes._rng = random.Random(i)
        self.managers[m.node_id] = m
        return m

    async def pump(self, seconds=TICK, steps=8):
        for _ in range(steps):
            await asyncio.sleep(0)
        await self.clock.advance(seconds)
        for _ in range(steps):
            await asyncio.sleep(0)

    async def settle(self, ticks=12):
        for _ in range(ticks):
            await self.pump(TICK)

    def leader(self):
        return next((m for m in self.managers.values()
                     if m._running and m.is_leader() and m._is_leader), None)

    async def wait_leader(self, ticks=60):
        for _ in range(ticks):
            await self.pump(TICK)
            lead = self.leader()
            if lead is not None:
                return lead
        raise AssertionError("no leader elected")

    def views(self, loose: bool = False) -> dict:
        return {mid: manager_view(m, loose) for mid, m in
                self.managers.items() if m._running}

    async def add_agents(self, lead, n: int) -> None:
        api, objects = self.P.api, self.P.objects
        for i in range(1, n + 1):
            await lead.store.update(lambda tx, i=i: tx.create(api.Node(
                id=f"w{i}", spec=api.NodeSpec(
                    annotations=api.Annotations(name=f"w{i}"),
                    membership=api.MembershipState.ACCEPTED),
                status=objects.NodeStatus())))
        for i in range(1, n + 1):
            a = self.P.Agent(self.P.AgentConfig(
                node_id=f"w{i}", executor=self.P.TestExecutor(
                    hostname=f"w{i}"),
                connect=lambda: self.leader().dispatcher, clock=self.clock))
            await a.start()
            self.agents.append(a)

    async def close(self) -> None:
        for a in self.agents:
            await a.stop()
        for m in self.managers.values():
            try:
                await m.stop()
            except Exception:
                pass
        self.tmp.cleanup()


def service_spec(P, name="web", replicas=2):
    api = P.api
    return api.ServiceSpec(
        annotations=api.Annotations(name=name),
        task=api.TaskSpec(container=api.ContainerSpec(image="img")),
        replicated=api.ReplicatedService(replicas=replicas))


def running(P, m, sid) -> list:
    return [t for t in m.store.find("task", P.by.ByService(sid))
            if t.status.state == P.api.TaskState.RUNNING]


async def case_bootstrap_and_run(P, h, rec):
    m = h.new_manager(1)
    await m.start()
    assert await h.wait_leader() is m
    clusters = m.store.find("cluster")
    assert len(clusters) == 1
    me = m.store.get("node", "m1")
    assert me is not None and me.role == P.api.NodeRole.MANAGER
    assert m.health.check("Raft") == P.health.HealthStatus.SERVING
    assert m.metrics.snapshot()["swarm_manager_leader"] == 1.0
    assert not m.is_state_dirty()
    rec("bootstrapped")
    await h.add_agents(m, 2)
    await h.settle(4)
    rec("agents")
    svc = await m.control_api.create_service(service_spec(P, replicas=3))
    for _ in range(120):
        await h.pump(0.25)
        if len(running(P, m, svc.id)) == 3:
            break
    tasks = m.store.find("task", P.by.ByService(svc.id))
    assert len(running(P, m, svc.id)) == 3, [
        (t.id, int(t.status.state), t.node_id) for t in tasks]
    assert {t.node_id for t in tasks} == {"w1", "w2"}
    assert m.is_state_dirty()
    rec("running", loose=True)


async def case_quorum_failover_restart(P, h, rec):
    m1 = h.new_manager(1)
    await m1.start()
    await h.wait_leader()
    m2 = h.new_manager(2, join_addr=m1.addr)
    await m2.start()
    m3 = h.new_manager(3, join_addr=m1.addr)
    await m3.start()
    await h.settle(8)
    assert m1._is_leader and not m2._is_leader and not m3._is_leader
    assert all(len(m.store.find("cluster")) == 1 for m in (m2, m3))
    assert len(m1.raft.cluster.members) == 3
    rec("three managers")
    svc = await m1.control_api.create_service(service_spec(P))
    await h.settle(4)
    assert all(m.store.get("service", svc.id) is not None
               for m in (m2, m3))
    rec("replicated")
    await m1.stop()
    lead = await h.wait_leader()
    assert lead in (m2, m3) and lead._leader_components
    rec("re-elected")
    after = await lead.control_api.create_service(
        service_spec(P, name="after"))
    await h.settle(4)
    assert lead.store.get("service", after.id) is not None
    rec("post-failover write")
    m1b = h.new_manager(1)
    await m1b.start()
    await h.settle(12)
    assert m1b.raft.raft_id == m1.raft.raft_id and not m1b._is_leader
    lead = h.leader()
    assert comparable(m1b.store, stamps=False) == comparable(
        lead.store, stamps=False)
    assert m1b.store.get("service", after.id) is not None
    rec("old leader restarted")


CASES = {f.__name__[5:]: f for f in (case_bootstrap_and_run,
                                     case_quorum_failover_restart)}


def run_case(root: str, case, kw: dict) -> list:
    P = package(root)

    async def go():
        h = ManagerHarness(P, kw)
        rec = []
        try:
            with cp.counted_ids(P):
                await case(P, h, lambda step, loose=False: rec.append(
                    (step, h.views(loose))))
        finally:
            await h.close()
        return rec
    return asyncio.run(go())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_manager_equals_jax(name, mode):
    jkw, tkw = MODES[mode]
    want = run_case("swarmkit_tpu", CASES[name], jkw)
    got = run_case("swarmkit_tpu_torch", CASES[name], tkw)
    assert_same_trace(want, got)


def test_manager_refuses_what_the_port_lacks(monkeypatch, tmp_path):
    """A TLS identity needs ca/, the gRPC scrape service rpc.py; and the
    scheduler's card is resolved at construction."""
    import torch

    P = package("swarmkit_tpu_torch")
    net = P.Network(seed=1)
    d = str(tmp_path)
    with pytest.raises(NotImplementedError, match="ca/"):
        P.Manager("m1", "m1:1", net, d, security=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Manager("m1", "m1:1", net, d)
    host = P.Manager("m1", "m1:1", net, d, sched_use_kernel=False)
    assert host.device is None
    net.add_service = lambda addr, handlers: None
    m = P.Manager("m1", "m1:1", net, d, device="cpu")

    async def start():
        with pytest.raises(NotImplementedError, match="rpc.py"):
            await m.start()
    asyncio.run(start())


# ---- the services on one store ------------------------------------------

async def pump(steps=10):
    for _ in range(steps):
        await asyncio.sleep(0)


async def svc_keymanager(P, rec):
    clock = P.FakeClock()
    api = P.api
    store = P.MemoryStore(clock=clock.now)
    await store.update(lambda tx: tx.create(api.Cluster(
        id="c1", spec=api.ClusterSpec(
            annotations=api.Annotations(name="default")))))
    km = P.keymanager.KeyManager(store, clock=clock, rotation_interval=10.0)
    await km.start()
    cl = store.get("cluster", "c1")
    assert {k.subsystem for k in cl.network_bootstrap_keys} == {
        "networking:gossip", "networking:ipsec"}
    lamport0 = cl.encryption_key_lamport_clock
    rec(store)
    for _ in range(4):
        await clock.advance(10.0)
        await pump()
        rec(store)
    cl = store.get("cluster", "c1")
    assert cl.encryption_key_lamport_clock > lamport0
    rings = {}
    for k in cl.network_bootstrap_keys:
        rings.setdefault(k.subsystem, []).append(k)
    assert all(len(r) <= P.keymanager.KEYRING_SIZE for r in rings.values())
    await km.stop()


async def svc_role_manager(P, rec):
    api, objects = P.api, P.objects

    class FakeMember:
        def __init__(self, raft_id, node_id):
            self.raft_id, self.node_id, self.addr = raft_id, node_id, ""

    class FakeRaft:
        def __init__(self):
            self.raft_id = 1
            self.removed = []
            self.cluster = types.SimpleNamespace(members={
                1: FakeMember(1, "n1"), 2: FakeMember(2, "n2")})

        def is_leader(self):
            return True

        def can_remove_member(self, raft_id):
            return True

        async def remove_member(self, raft_id):
            self.removed.append(raft_id)
            self.cluster.members.pop(raft_id, None)

        async def transfer_leadership(self):
            raise RuntimeError("no transfer in test")

    clock = P.FakeClock()
    store = P.MemoryStore(clock=clock.now)
    raft = FakeRaft()

    def mk(i, role, desired):
        return api.Node(id=f"n{i}", spec=api.NodeSpec(
            annotations=api.Annotations(name=f"n{i}"), desired_role=desired),
            role=role, status=objects.NodeStatus(state=api.NodeState.READY))
    R = api.NodeRole
    await store.update(lambda tx: [
        tx.create(mk(1, R.MANAGER, R.MANAGER)),
        tx.create(mk(2, R.MANAGER, R.MANAGER)),
        tx.create(mk(3, R.WORKER, R.WORKER))])
    rm = P.role_manager.RoleManager(store, raft, clock=clock)
    await rm.start()
    await pump()

    def set_desired(nid, role):
        def txn(tx):
            n = tx.get("node", nid).copy()
            n.spec.desired_role = role
            tx.update(n)
        return txn
    await store.update(set_desired("n3", R.MANAGER))
    await clock.advance(17.0)
    await pump()
    assert store.get("node", "n3").role == R.MANAGER
    rec(store)
    await store.update(set_desired("n2", R.WORKER))
    for _ in range(3):
        await clock.advance(17.0)
        await pump()
        rec(store)
    assert raft.removed == [2]
    assert store.get("node", "n2").role == R.WORKER
    await rm.stop()


async def svc_watch_and_resources(P, rec):
    api = P.api
    clock = P.FakeClock()
    store = P.MemoryStore(clock=clock.now)
    ws = P.watchapi.WatchServer(store)
    got = []

    async def consume():
        async for m in ws.watch([P.watchapi.WatchSelector(kind="task")],
                                include_old_object=True):
            got.append((m.action, m.kind, m.object.id, m.version,
                        m.old_object.to_dict() if m.old_object else None))

    c = asyncio.get_running_loop().create_task(consume())
    await pump()
    await store.update(lambda tx: tx.create(api.Task(
        id="t1", spec=api.TaskSpec(), status=api.TaskStatus())))
    await store.update(lambda tx: tx.create(api.Node(
        id="n1", spec=api.NodeSpec(annotations=api.Annotations(name="n1")))))

    def upd(tx):
        t = tx.get("task", "t1").copy()
        t.status.state = api.TaskState.RUNNING
        tx.update(t)
    await store.update(upd)
    await pump()
    assert [(a, k) for a, k, *_ in got] == [("create", "task"),
                                           ("update", "task")]
    assert got[1][3] > got[0][3] > 0
    c.cancel()
    rec(got)
    await store.update(lambda tx: tx.create(api.Network(
        id="net1", spec=api.NetworkSpec(
            annotations=api.Annotations(name="overlay")))))
    res = P.resourceapi.ResourceApi(store)
    with pytest.raises(P.resourceapi.ResourceError):
        await res.attach_network("n1", "missing")
    tid = await res.attach_network("n1", "net1", container_id="abc")
    t = store.get("task", tid)
    assert t.node_id == "n1" and t.spec.networks == ["net1"]
    rec(store)
    await res.detach_network(tid)
    assert store.get("task", tid) is None
    rec(store)


async def svc_logbroker_and_collector(P, rec):
    api, objects = P.api, P.objects
    store = P.MemoryStore()
    await store.update(lambda tx: tx.create(api.Task(
        id="t1", node_id="n1", service_id="svc1", spec=api.TaskSpec(),
        status=api.TaskStatus(state=api.TaskState.RUNNING))))
    lb = P.logbroker.LogBroker(store)
    msgs, subs = [], []

    async def client():
        async for m in lb.subscribe_logs(
                P.logbroker.LogSelector(service_ids=["svc1"])):
            msgs.append(m.data)
            if len(msgs) >= 2:
                return

    async def agent():
        async for sub in lb.listen_subscriptions("n1"):
            if sub.close:
                continue
            subs.append(sub.id)
            await lb.publish_logs(sub.id, [
                P.logbroker.LogMessage(stream=P.logbroker.LogStream.STDOUT,
                                       data=b"hello"),
                P.logbroker.LogMessage(stream=P.logbroker.LogStream.STDERR,
                                       data=b"world")])

    loop = asyncio.get_running_loop()
    at = loop.create_task(agent())
    await pump()
    await asyncio.wait_for(loop.create_task(client()), timeout=5)
    assert msgs == [b"hello", b"world"] and len(subs) == 1
    at.cancel()
    rec((msgs, subs))

    coll = P.metrics.Collector(store)
    await coll.start()
    await store.update(lambda tx: [
        tx.create(api.Node(id="n1", spec=api.NodeSpec(
            annotations=api.Annotations(name="n1")),
            status=objects.NodeStatus(state=api.NodeState.READY))),
        tx.create(api.Task(id="t2", spec=api.TaskSpec(),
                           status=api.TaskStatus(
                               state=api.TaskState.RUNNING)))])
    await pump()
    snap = coll.snapshot()
    assert snap["swarm_node_ready"] == 1 and snap["swarm_task_running"] == 2
    saved = store.save()
    await store.update(lambda tx: tx.delete("task", "t1"))
    await pump()
    store.restore(saved)
    assert coll.snapshot()["swarm_task_running"] == 2
    coll.set_leader(True)
    rec(coll.snapshot())
    await coll.stop()


async def svc_reaper_and_enforcer(P, rec):
    """The task reaper keeps TaskHistoryRetentionLimit dead tasks a slot
    and deletes REMOVE-desired tasks; the constraint enforcer shuts down
    the tasks of a node that stops matching their constraints or fitting
    their reservations."""
    api, objects = P.api, P.objects
    clock = P.FakeClock()
    store = P.MemoryStore(clock=clock.now)
    spec = service_spec(P, replicas=1)
    spec.task.placement = api.Placement(constraints=["node.labels.ok==1"])
    svc = api.Service(id="svc1", spec=spec)
    node = api.Node(
        id="n1", spec=api.NodeSpec(annotations=api.Annotations(
            name="n1", labels={"ok": "1"})),
        description=api.NodeDescription(resources=api.NodeResources(
            nano_cpus=4 * 10 ** 9, memory_bytes=8 << 30)),
        status=objects.NodeStatus(state=api.NodeState.READY))
    S = api.TaskState

    gspec = api.ServiceSpec(
        annotations=api.Annotations(name="agent"),
        task=api.TaskSpec(container=api.ContainerSpec(image="img")),
        mode=api.Mode.GLOBAL, global_=api.GlobalService())

    def task(i, state, desired, ts, sid="svc1", slot=1):
        return api.Task(id=f"t{i}", service_id=sid, slot=slot, node_id="n1",
                        spec=spec.task.copy(), desired_state=int(desired),
                        status=api.TaskStatus(state=state, timestamp=ts))
    # slot 1 of svc1, and the node-keyed history of a global service on
    # n1 (tasks g0-g6, dead, two of them at one timestamp)
    await store.update(lambda tx: [
        tx.create(svc), tx.create(node),
        tx.create(api.Service(id="gsvc", spec=gspec)),
        *[tx.create(task(i, S.FAILED, S.SHUTDOWN, float(i)))
          for i in range(8)],
        tx.create(task(8, S.RUNNING, S.RUNNING, 9.0)),
        tx.create(task(9, S.NEW, S.REMOVE, 9.0)),
        *[tx.create(task(f"g{i}", S.FAILED, S.SHUTDOWN, float(i // 2),
                         sid="gsvc", slot=0)) for i in range(7)]])
    reaper = P.reaper.TaskReaper(store, clock=clock)
    enforcer = P.enforcer.ConstraintEnforcer(store, clock=clock)
    await reaper.start()
    await enforcer.start()
    await pump(30)
    left = sorted(t.id for t in store.find("task")
                  if t.service_id == "svc1")
    dead = [t for t in left if t != "t8"]
    # the REMOVE-desired task is gone, at most the retention limit of the
    # slot's dead tasks stay, and they are the newest
    assert "t8" in left and "t9" not in left, left
    assert 0 < len(dead) <= 5 and dead == [f"t{i}" for i in range(
        8 - len(dead), 8)], left
    ghist = sorted(t.id for t in store.find("task")
                   if t.service_id == "gsvc")
    assert 0 < len(ghist) <= 5 and "tg6" in ghist, ghist
    rec(store)

    def relabel(tx):
        n = tx.get("node", "n1").copy()
        n.spec.annotations.labels = {"ok": "0"}
        tx.update(n)
    await store.update(relabel)
    await pump(30)
    t8 = store.get("task", "t8")
    assert t8.desired_state == S.SHUTDOWN
    assert t8.status.message == "node no longer satisfies task constraints"
    rec(store)
    await enforcer.stop()
    await reaper.stop()


SERVICES = {f.__name__[4:]: f for f in (
    svc_keymanager, svc_role_manager, svc_watch_and_resources,
    svc_logbroker_and_collector, svc_reaper_and_enforcer)}


def _recorded(x):
    if hasattr(x, "find") and hasattr(x, "update"):
        return comparable(x)
    return x


def run_service(root: str, case) -> list:
    P = package(root)
    rec = []

    async def go():
        with cp.counted_ids(P):
            await case(P, lambda x: rec.append(_recorded(x)))
    asyncio.run(go())
    return rec


@pytest.mark.parametrize("name", sorted(SERVICES))
def test_service_equals_jax(name):
    want = run_service("swarmkit_tpu", SERVICES[name])
    got = run_service("swarmkit_tpu_torch", SERVICES[name])
    assert got == want


# ---- the global orchestrator ---------------------------------------------

async def global_service(P, nodes: int) -> tuple:
    """`nodes` READY nodes (every third labelled out) and one global
    service constrained to the labelled ones; the orchestrator's tasks
    and the store's task events, then the tasks after the service is
    removed."""
    api, objects = P.api, P.objects
    clock = P.FakeClock()
    store = P.MemoryStore(clock=clock.now)
    batch = store.batch()
    for i in range(nodes):
        await batch.update(lambda tx, i=i: tx.create(api.Node(
            id=f"node-{i:04d}", spec=api.NodeSpec(annotations=api.Annotations(
                name=f"node-{i:04d}", labels={"pool": "a" if i % 3 else "b"})),
            status=objects.NodeStatus(state=api.NodeState.READY))))
    await batch.commit()
    orch = P.global_.GlobalOrchestrator(store, clock=clock)
    await orch.start()
    watcher = store.watch(P.match(kind="task"))
    spec = api.ServiceSpec(
        annotations=api.Annotations(name="agent"),
        task=api.TaskSpec(container=api.ContainerSpec(image="img"),
                          placement=api.Placement(
                              constraints=["node.labels.pool==a"])),
        mode=api.Mode.GLOBAL)
    await store.update(lambda tx: tx.create(api.Service(id="svc-g",
                                                        spec=spec)))
    for _ in range(40):
        await pump()
    tasks = sorted((t.node_id, t.slot, int(t.desired_state),
                    int(t.status.state)) for t in store.find("task"))
    events = [(ev.action, ev.object.id, ev.object.node_id)
              for ev in watcher.poll()]
    await store.update(lambda tx: tx.delete("service", "svc-g"))
    for _ in range(40):
        await pump()
    left = len(store.find("task"))
    watcher.close()
    await orch.stop()
    return tasks, events, left


def _global(root, nodes):
    P = package(root)

    async def go():
        with cp.counted_ids(P):
            return await global_service(P, nodes)
    return asyncio.run(go())


@pytest.mark.parametrize("nodes", [30, 300])
def test_global_orchestrator_equals_jax_at_200_tasks_or_fewer(nodes):
    """30 and 300 nodes make 20 and 200 tasks: one transaction in both
    packages, with the same tasks and events."""
    want = _global("swarmkit_tpu", nodes)
    got = _global("swarmkit_tpu_torch", nodes)
    assert len(got[0]) == nodes * 2 // 3 and got[2] == 0
    assert got == want


def test_global_orchestrator_places_past_200_tasks():
    """375 nodes, 250 eligible: every eligible node gets its task, and a
    removed service's 250 tasks are deleted (the JAX package's single
    transaction refuses both)."""
    tasks, events, left = _global("swarmkit_tpu_torch", 375)
    assert len(tasks) == 250
    assert {n for n, *_ in tasks} == {f"node-{i:04d}" for i in range(375)
                                      if i % 3}
    assert [a for a, *_ in events] == ["create"] * 250
    assert left == 0


# ---- swarm-bench ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(replicas=8, workers=2, managers=3),
    dict(replicas=8, workers=2, managers=3, proposals=20),
    dict(replicas=8, workers=2, managers=3, proposals=20, batch=4)],
    ids=["startup", "proposals", "batch"])
def test_swarm_bench_device_transport(kw):
    """tests/test_integration.py's device-transport case of swarm-bench,
    and its proposal modes: the port on the device wire on the CPU
    returns the JAX package's keys (JAX's run on its in-process wire),
    every replica RUNNING, every proposal committed."""
    from swarmkit_tpu.cmd.swarm_bench import bench as jbench
    from swarmkit_tpu_torch.cmd.swarm_bench import bench

    got = asyncio.run(bench(**kw, transport="device", device="cpu"))
    want = asyncio.run(jbench(**kw, transport="inproc"))
    assert sorted(got) == sorted(want)
    assert got["transport"] == "device"
    if "proposals" in kw:
        assert got["proposals"] == 20 and got["proposals_per_s"] > 0
        assert got["propose_p99_ms"] >= got["propose_p50_ms"] > 0
        if "batch" in kw:
            assert got["batch"] == 4 and got["entries_per_proposal"] >= 1
    else:
        assert got["replicas"] == 8 and got["tasks_per_s"] > 0
        assert got["p99_s"] >= got["p50_s"] > 0


def test_swarm_bench_cli(capsys, monkeypatch):
    """The module's command line prints one JSON line; without a card and
    without --device it raises the port's error."""
    import json

    import torch

    from swarmkit_tpu_torch.cmd.swarm_bench import main

    assert main(["--managers", "3", "--transport", "device", "--device",
                 "cpu", "--proposals", "5"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["managers"] == 3 and out["proposals"] == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--proposals", "5"])


def test_swarm_bench_quorum_start_times_out_without_a_leader(monkeypatch):
    """Quorum.start bounds its wait for the first manager to lead: a
    manager that never leads raises a TimeoutError that names it."""
    from swarmkit_tpu_torch.cmd import swarm_bench

    monkeypatch.setattr(swarm_bench, "LEADER_WAIT_S", 0.3)

    async def run():
        q = swarm_bench.Quorum(1, device="cpu")
        make = q.new_manager

        def never_leads(i, join_addr=""):
            m = make(i, join_addr)
            m.is_leader = lambda: False
            return m
        q.new_manager = never_leads
        try:
            with pytest.raises(TimeoutError, match="manager m0"):
                await q.start()
        finally:
            await q.stop()
    asyncio.run(run())
