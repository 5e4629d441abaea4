"""The port's MemoryStore against the JAX package's, on one scripted
sequence of transactions with fixed object ids: create, update and delete
over every kind, a stale version, a name clash, 201 changes in one
transaction, a batch split at 200; every find under each selector, the
watch events in order, the versions, and save / restore across the two
packages (their snapshots are the same dicts, so each restores the
other's)."""

from __future__ import annotations

import asyncio
import importlib

import pytest

ROOTS = ("swarmkit_tpu", "swarmkit_tpu_torch")


def _pkg(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return m("api"), m("api.objects"), m("store"), m("store.memory"), \
        m("utils.clock")


def _objects(root):
    """One object of every kind, with fixed ids and names."""
    api, objects, _, _, _ = _pkg(root)
    specs = importlib.import_module(f"{root}.api.specs")
    secret = api.Secret(id="sec1", spec=api.SecretSpec(
        annotations=api.Annotations(name="db"), data=b"pw"))
    config = api.Config(id="cfg1", spec=api.ConfigSpec(
        annotations=api.Annotations(name="conf"), data=b"k=v"))
    svc = api.Service(id="svc1", spec=api.ServiceSpec(
        annotations=api.Annotations(name="web", labels={"tier": "front"}),
        task=api.TaskSpec(container=api.ContainerSpec(image="nginx:1")),
        replicated=api.ReplicatedService(replicas=2)))
    nodes = [api.Node(id=f"node{i}", role=role, spec=api.NodeSpec(
        annotations=api.Annotations(name=f"n{i}")),
        description=api.NodeDescription(hostname=f"host{i}"),
        status=objects.NodeStatus(state=api.NodeState.READY))
        for i, role in ((1, api.NodeRole.MANAGER), (2, api.NodeRole.WORKER))]
    tasks = [api.Task(
        id=f"task{i}", service_id="svc1", node_id=f"node{1 + i % 2}",
        slot=i, desired_state=int(api.TaskState.RUNNING),
        status=api.TaskStatus(state=api.TaskState.RUNNING
                              if i % 2 else api.TaskState.PENDING),
        spec=api.TaskSpec(container=api.ContainerSpec(
            image="nginx:1",
            secrets=[specs.SecretReference(secret_id="sec1",
                                           secret_name="db")]
            if i == 1 else [],
            configs=[specs.ConfigReference(config_id="cfg1",
                                           config_name="conf")]
            if i == 2 else [])))
        for i in (1, 2, 3)]
    return [
        *nodes, svc, *tasks,
        api.Network(id="net1", spec=api.NetworkSpec(
            annotations=api.Annotations(name="overlay"))),
        api.Cluster(id="cl1", spec=api.ClusterSpec(
            annotations=api.Annotations(name="default"))),
        secret, config,
        objects.Resource(id="res1", annotations=api.Annotations(
            name="gpu"), kind="ext", payload=b"x"),
        objects.Extension(id="ext1", annotations=api.Annotations(
            name="ext"), description="an extension"),
    ]


def _selectors(root):
    _, _, store, _, _ = _pkg(root)
    return {
        "All": store.All(), "ByID": store.ByID("task2"),
        "ByIDPrefix": store.ByIDPrefix("task"),
        "ByName": store.ByName("web"), "ByNamePrefix": store.ByNamePrefix("n"),
        "ByService": store.ByService("svc1"), "ByNode": store.ByNode("node2"),
        "BySlot": store.BySlot("svc1", 3),
        "ByDesiredState": store.ByDesiredState(448),
        "ByTaskState": store.ByTaskState(64), "ByRole": store.ByRole(1),
        "ByMembership": store.ByMembership(1),
        "ByReferencedSecret": store.ByReferencedSecret("sec1"),
        "ByReferencedConfig": store.ByReferencedConfig("cfg1"),
        "Or": store.Or(store.ByID("task1"), store.ByNode("node1")),
        "Custom": store.Custom(lambda o: o.id.endswith("1")),
    }


KINDS = ("node", "service", "task", "network", "cluster", "secret",
         "config", "resource", "extension")


def _finds(view, root) -> dict:
    """Every find under every selector over every kind, as dicts (or the
    error it raises)."""
    out = {}
    for name, by in _selectors(root).items():
        for kind in KINDS:
            try:
                out[(name, kind)] = [o.to_dict() for o in view.find(kind, by)]
            except Exception as e:   # an unsupported selector for a kind
                out[(name, kind)] = type(e).__name__
    return out


def _events(watcher, memory) -> list:
    out = []
    while (ev := watcher.try_get()) is not None:
        if isinstance(ev, memory.EventCommit):
            out.append(("commit", ev.version))
        else:
            out.append((ev.kind, ev.action, ev.object.to_dict(),
                        ev.old_object.to_dict() if ev.old_object else None))
    return out


async def _script(root) -> dict:
    api, objects, store_mod, memory, clock_mod = _pkg(root)
    clock = clock_mod.FakeClock(start=100.0)
    s = memory.MemoryStore(clock=clock.now)
    w = s.watch()
    trace: dict = {"steps": [], "finds": {}}

    async def step(name, cb, batch=None):
        try:
            if batch is None:
                result = await s.update(cb)
            else:
                b = s.batch()
                for one in batch:
                    await b.update(one)
                result = await b.commit()
            outcome = ("ok", result if isinstance(result, int) else None)
        except Exception as e:
            outcome = ("raises", type(e).__name__)
        await clock.advance(1.0)
        trace["steps"].append((name, outcome, s.version,
                               _events(w, memory)))

    objs = _objects(root)

    def create_all(tx):
        for o in objs:
            tx.create(o)
    await step("create every kind", create_all)
    trace["finds"]["created"] = _finds(s, root)

    def update_all(tx):
        for o in objs:
            cur = tx.get(objects.kind_of(o), o.id)
            if hasattr(cur, "spec") and hasattr(cur.spec, "annotations"):
                cur.spec.annotations.labels["step"] = "2"
            elif hasattr(cur, "annotations"):
                cur.annotations.labels["step"] = "2"
            if isinstance(cur, api.Task):
                cur.status.state = api.TaskState.COMPLETE
            tx.update(cur)
    await step("update every kind", update_all)

    stale = objs[0].copy()         # version 0 against the stored 2
    await step("stale version", lambda tx: tx.update(stale))
    clash = api.Node(id="node9", spec=api.NodeSpec(
        annotations=api.Annotations(name="n1")))
    await step("name clash", lambda tx: tx.create(clash))
    await step("existing id", lambda tx: tx.create(objs[0].copy()))

    def task(i):
        return api.Task(id=f"bulk{i:04d}", service_id="svc1", slot=100 + i,
                        desired_state=int(api.TaskState.RUNNING),
                        status=api.TaskStatus(state=api.TaskState.NEW))

    def too_large(tx):
        for i in range(memory.MAX_CHANGES_PER_TRANSACTION + 1):
            tx.create(task(i))
    await step("201 changes", too_large)
    await step("batch of 450", None, batch=[
        (lambda tx, i=i: tx.create(task(i))) for i in range(450)])

    def in_tx(tx):
        # reads inside a transaction see its own writes
        cur = tx.get("task", "task1")
        cur.status.state = api.TaskState.FAILED
        tx.update(cur)
        tx.delete("task", "task2")
        trace["finds"]["in_tx"] = _finds(tx, root)
    await step("reads in a transaction", in_tx)

    def delete_all(tx):
        for o in objs:
            if tx.get(objects.kind_of(o), o.id) is not None:
                tx.delete(objects.kind_of(o), o.id)
    await step("delete every kind", delete_all)
    trace["finds"]["deleted"] = _finds(s, root)
    trace["snapshot"] = s.save().to_dict()
    w.close()
    return trace


@pytest.fixture(scope="module")
def traces():
    return {root: asyncio.run(_script(root)) for root in ROOTS}


STEPS = ("create every kind", "update every kind", "stale version",
         "name clash", "existing id", "201 changes", "batch of 450",
         "reads in a transaction", "delete every kind")


@pytest.mark.parametrize("i", range(len(STEPS)), ids=STEPS)
def test_store_step_like_jax(traces, i):
    """Each step's outcome (or error), the store version after it and
    every watch event it published (kind, action, object and old object,
    in order, with the commit events) equal the JAX package's."""
    jax, port = traces["swarmkit_tpu"]["steps"], \
        traces["swarmkit_tpu_torch"]["steps"]
    assert len(jax) == len(port) == len(STEPS)
    assert port[i][0] == STEPS[i]
    assert port[i] == jax[i]


def test_store_errors_and_batch_split(traces):
    steps = {s[0]: s for s in traces["swarmkit_tpu_torch"]["steps"]}
    assert steps["stale version"][1] == ("raises", "ErrSequenceConflict")
    assert steps["name clash"][1] == ("raises", "ErrNameConflict")
    assert steps["existing id"][1] == ("raises", "ErrExist")
    assert steps["201 changes"][1] == ("raises", "ErrTxTooLarge")
    assert steps["201 changes"][3] == []
    # 450 changes through one batch: 200 + 200 + 50, three commits
    ok, applied = steps["batch of 450"][1]
    commits = [e for e in steps["batch of 450"][3] if e[0] == "commit"]
    sizes, n = [], 0
    for e in steps["batch of 450"][3]:
        if e[0] == "commit":
            sizes.append(n)
            n = 0
        else:
            n += 1
    assert (ok, applied) == ("ok", 450)
    assert len(commits) == 3 and sizes == [200, 200, 50]


@pytest.mark.parametrize("when", ("created", "in_tx", "deleted"))
def test_store_finds_like_jax(traces, when):
    """Every find under each selector, over every kind, equals the JAX
    package's: after the creates, inside a transaction over its own
    writes, and after the deletes."""
    jax = traces["swarmkit_tpu"]["finds"][when]
    port = traces["swarmkit_tpu_torch"]["finds"][when]
    assert set(port) == set(jax)
    for key in jax:
        assert port[key] == jax[key], key
    if when == "created":
        assert len(port[("All", "task")]) == 3
        assert [o["id"] for o in port[("ByReferencedSecret", "task")]] \
            == ["task1"]


@pytest.mark.parametrize("src,dst", [(ROOTS[0], ROOTS[1]),
                                     (ROOTS[1], ROOTS[0]),
                                     (ROOTS[1], ROOTS[1])])
def test_save_restore_across_packages(src, dst):
    """A snapshot of one package's store restores into the other's: the
    snapshot formats are the same dicts (StoreSnapshot of to_dict), so
    every object and every find come back equal."""
    async def fill(root):
        _, objects, _, memory, _ = _pkg(root)
        s = memory.MemoryStore(clock=lambda: 5.0)

        def create_all(tx):
            for o in _objects(root):
                tx.create(o)
        await s.update(create_all)
        return s

    source = asyncio.run(fill(src))
    snap = source.save()
    _, _, _, dmemory, _ = _pkg(dst)
    draft = importlib.import_module(f"{dst}.api.raft_msgs")
    target = dmemory.MemoryStore()
    target.restore(draft.StoreSnapshot.from_dict(snap.to_dict()),
                   version=source.version)
    assert target.version == source.version
    assert target.save().to_dict() == snap.to_dict()
    assert _finds(target, dst) == _finds(source, src)


def test_proposer_and_follower_like_jax():
    """The actions handed to a proposer, and a follower's replay of them,
    equal the JAX package's."""
    async def run(root):
        _, _, _, memory, _ = _pkg(root)
        p = memory.NopProposer()
        leader = memory.MemoryStore(proposer=p, clock=lambda: 7.0)

        def create_all(tx):
            for o in _objects(root):
                tx.create(o)
        await leader.update(create_all)
        follower = memory.MemoryStore(clock=lambda: 7.0)
        w = follower.watch()
        follower.apply_store_actions(p.proposed[0], version=1)
        return ([a.to_dict() for a in p.proposed[0]],
                follower.save().to_dict(), _events(w, memory))

    assert asyncio.run(run(ROOTS[1])) == asyncio.run(run(ROOTS[0]))
