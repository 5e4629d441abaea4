"""The control plane's leader pipeline on one store, the port against the
JAX package: ControlApi -> ReplicatedOrchestrator -> Allocator -> the
scheduler's store loop -> Dispatcher -> Agents with TestExecutors, on a
FakeClock with Dispatcher(rng=random.Random(0)) and ids minted from a
counter (tools/control_plane.py).

The script (tools/control_plane.run_script): 4 nodes; a service of 12
replicas; scale to 20, then to 6; one task fails and is replaced after
its restart delay; an image update with parallelism 2; a node drained;
the service removed.  After each step the normalized stores (ids become
what they stand for: per service each slot's desired and observed
states, per node the count of tasks by state, and slot -> node) must be
equal.  The JAX package runs with Scheduler(use_kernel=False), twice:
slot -> node is compared only where its two runs agree.  The port runs
with its kernel on device="cpu" (the plain loop) and with
use_kernel=False.

The runs stay in this process, not in a file shared between workers:
the allocator moves tasks to PENDING in the order of a set of ids, which
follows the process's string-hash seed, and the scheduler places them in
that order.

Above MAX_CHANGES_PER_TRANSACTION the two packages part: a probe of the
JAX package's pipeline (its ReplicatedOrchestrator._reconcile creates a
service's tasks in one store.update) with a 201-replica service logs
"replicated orchestrator crashed" with ErrTxTooLarge: 201 changes > 200,
and the service never gets a task; 200 replicas come up.  The port
writes the creates, a scale-down's removals and a removed service's
deletes through the store's batch, and places every one of 250 replicas
here; at 200 changes or fewer it equals the JAX package.
"""

from __future__ import annotations

import asyncio
import importlib

import pytest

from swarmkit_tpu_torch.tools import control_plane as cp
from swarmkit_tpu_torch.tools import sched_world as W

JAX, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
VARIANTS = {"kernel on the cpu": {"device": "cpu"},
            "host pipeline": {"use_kernel": False}}
STEPS = ("create 12", "scale 20", "scale 6", "fail a task, within the delay",
         "fail a task, replaced", "image update", "drain node4", "remove")


def package(root: str):
    """The pipeline's classes from package `root`: the port's own, or the
    JAX package's modules under the names of the port's."""
    if root == PORT:
        return cp.package()
    return cp.package({name: importlib.import_module(f"{root}.{name}")
                       for name in cp.MODULES})


@pytest.fixture(scope="module")
def script_runs():
    jp, tp = package(JAX), package(PORT)
    runs = {"jax": asyncio.run(cp.run_script(jp, {"use_kernel": False})),
            "jax again": asyncio.run(cp.run_script(jp, {"use_kernel": False}))}
    for name, kw in VARIANTS.items():
        runs[name] = asyncio.run(cp.run_script(tp, kw))
    return runs


def test_script_steps(script_runs):
    for run in script_runs.values():
        assert tuple(s for s, _ in run) == STEPS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("i", range(len(STEPS)), ids=STEPS)
def test_script_step_like_jax(script_runs, variant, i):
    """After each step the port's normalized store equals the JAX
    package's, slot -> node where two JAX runs agree."""
    want, again = script_runs["jax"], script_runs["jax again"]
    got = script_runs[variant]
    diffs = cp.same_steps(want[i:i + 1], got[i:i + 1],
                          trusted=again[i:i + 1])
    assert not diffs, diffs


def test_script_reaches_each_state(script_runs):
    """The script does what it says, on the port's kernel path."""
    run = dict(script_runs["kernel on the cpu"])
    running = 448

    def live(step):
        return {k: v for k, v in run[step]["slots"]["web"].items()
                if any(d <= running for d, _ in v)}

    assert len(live("create 12")) == 12
    assert all(v == [(running, running)]
               for v in live("create 12").values())
    assert len(live("scale 20")) == 20
    assert len(live("scale 6")) == 6
    parked = [v for v in live("fail a task, within the delay").values()
              if (320, 320) in v]
    assert len(parked) == 1          # the replacement waits in READY
    assert all(any(s == (running, running) for s in v)
               for v in live("fail a task, replaced").values())
    assert run["image update"]["updates"] == {"web": "completed"}
    assert "RUNNING" not in run["drain node4"]["per_node"]["node4"]
    assert run["drain node4"]["nodes"]["node4"] == ("READY", "DRAIN")
    assert run["remove"]["slots"] == {}
    # the JAX package agrees with itself on every placement here
    assert cp.same_steps(script_runs["jax"], script_runs["jax again"]) == []


def _place(root, replicas, sched_kw, nodes=40):
    pkg = package(root)
    desc = W.describe_world(seed=0, nodes=nodes)

    async def go():
        with cp.counted_ids(pkg):
            run = await cp.place_through_store(
                pkg, desc, replicas, sched_kw, clock=pkg.FakeClock(),
                timeout=120)
            # Scheduler.schedule (a tick without the store) is the port's
            return run, cp.direct_schedule(pkg, run, sched_kw,
                                           clock=pkg.FakeClock()) \
                if root == PORT else None
    return pkg, asyncio.run(go())


@pytest.fixture(scope="module")
def placed_250():
    return _place(PORT, 250, {"device": "cpu"})


def test_250_replicas_all_placed_through_the_batch(placed_250):
    """250 replicas (more than one transaction holds) through the
    orchestrator, the allocator and the store loop: every task placed,
    the store's assignment equal to one direct schedule() over the
    starting node set in the order the ticks placed the tasks, and every
    placement within capacity, on READY ACTIVE nodes, inside its
    constraints."""
    pkg, (run, direct) = placed_250
    store, svc = run["store"], run["service"]
    assert len(run["order"]) == 250 and run["pending"] == []
    final = {t.id: t.node_id
             for t in store.find("task", pkg.by.ByService(svc.id))
             if t.status.state == pkg.api.TaskState.ASSIGNED}
    assert final == dict(run["order"])
    assert direct == run["order"]
    assert cp.placement_violations(pkg, store, svc.id) == []
    # the world's failure taints reached the store loop's node set
    sample = store.get("task", run["order"][0][0])
    fkey = pkg.NodeInfo.failure_key(sample)
    tainted = sorted(
        n for n, info in run["scheduler"].node_set.nodes.items()
        if len(info.recent_failures.get(fkey, ()))
        >= W.port_nodeinfo.FAILURE_LIMIT)
    desc = W.describe_world(seed=0, nodes=40)
    assert tainted == [f"node-{i:04d}" for i in range(40)
                       if desc["tainted"][i]]
    assert run["n_failed"] == len(tainted) * W.port_nodeinfo.FAILURE_LIMIT


def test_250_replicas_scale_down_and_remove_through_the_batch(placed_250):
    """The other two writes of the orchestrator above 200 changes: a
    scale-down to 10 marks 240 tasks REMOVE, and removing the service
    deletes all 250 (plus its failed ones)."""
    pkg, (run, _) = placed_250
    store, svc = run["store"], run["service"]

    async def go():
        orch = pkg.ReplicatedOrchestrator(store, clock=pkg.FakeClock())
        await orch.start()
        cur = store.get("service", svc.id)
        cur.spec.replicated.replicas = 10
        await store.update(lambda tx: tx.update(cur))
        for _ in range(20):
            await asyncio.sleep(0)
        tasks = store.find("task", pkg.by.ByService(svc.id))
        removing = sum(t.desired_state == pkg.api.TaskState.REMOVE
                       for t in tasks)
        await store.update(lambda tx: tx.delete("service", svc.id))
        for _ in range(20):
            await asyncio.sleep(0)
        left = store.find("task", pkg.by.ByService(svc.id))
        await orch.stop()
        return removing, left

    removing, left = asyncio.run(go())
    assert removing == 240
    assert left == []


@pytest.mark.parametrize("replicas", (37, 200))
def test_place_through_store_like_jax(replicas):
    """At 200 changes or fewer a transaction, the port's pipeline (its
    kernel on the CPU) places exactly as the JAX package's (its host
    Pipeline), in the same tick order."""
    jpkg, (jrun, _) = _place(JAX, replicas, {"use_kernel": False}, nodes=12)
    tpkg, (trun, tdirect) = _place(PORT, replicas, {"device": "cpu"},
                                   nodes=12)
    assert trun["order"] == jrun["order"]
    assert sorted(trun["pending"]) == sorted(jrun["pending"])
    assert tdirect == trun["order"]
    assert cp.placement_violations(tpkg, trun["store"],
                                   trun["service"].id) == []


@pytest.mark.parametrize("call", ["rotate_root_ca", "rotate_unlock_key",
                                  "get_unlock_key", "generate_join_token",
                                  "rotate_worker_token", "autolock"])
def test_ca_bound_control_api_raises_by_name(call):
    """The ControlApi methods bound to the certificate authority answer as
    the JAX package's do on a cluster without a root CA and a manager
    without a CA server: the same error by type and message, or the same
    answer (the minted autolock key compared by its form); a cluster spec
    update without them still lands."""
    import re

    def run(root):
        controlapi = importlib.import_module(f"{root}.manager.controlapi")
        api = importlib.import_module(f"{root}.api")
        store_mod = importlib.import_module(f"{root}.store.memory")

        async def go():
            store = store_mod.MemoryStore()
            ctl = controlapi.ControlApi(store)
            cl = api.Cluster(id="cl1", spec=api.ClusterSpec(
                annotations=api.Annotations(name="default")))
            await store.update(lambda tx: tx.create(cl))
            spec = cl.spec.copy()
            spec.dispatcher.heartbeat_period = 7.0
            updated = await ctl.update_cluster("cl1", spec)
            assert updated.spec.dispatcher.heartbeat_period == 7.0
            locked = spec.copy()
            locked.encryption_config.auto_lock_managers = True
            calls = {
                "rotate_root_ca": ctl.rotate_root_ca,
                "rotate_unlock_key": ctl.rotate_unlock_key,
                "get_unlock_key": ctl.get_unlock_key,
                "generate_join_token": lambda: controlapi.generate_join_token(
                    ca_cert=b""),
                "rotate_worker_token": lambda: ctl.update_cluster(
                    "cl1", spec, rotate_worker_token=True),
                "autolock": lambda: ctl.update_cluster("cl1", locked)}
            try:
                out = calls[call]()
                if asyncio.iscoroutine(out):
                    out = await out
            except Exception as e:
                out = (type(e).__name__, str(e))
            if call == "autolock":
                keys = [k.key.decode() for k in
                        store.get("cluster", "cl1").unlock_keys]
                out = [re.sub(r"[0-9a-f]{64}$", "<key>", k) for k in keys]
            assert store.get("cluster", "cl1").spec.dispatcher \
                .heartbeat_period == 7.0
            return out
        return asyncio.run(go())

    want, got = run(JAX), run(PORT)
    assert got == want
    if call == "autolock":
        assert got == ["SWMKEY-1-<key>"]
    elif call == "get_unlock_key":
        assert got == {"unlock_key": "", "autolock": False}
    else:
        assert isinstance(got, tuple), got


@pytest.mark.parametrize("driver", ["place_through_store", "task_startup"])
def test_a_failed_store_loop_surfaces(monkeypatch, driver):
    """When the scheduler's store loop fails (on the card: a CUDA error
    of the kernel path), the drivers raise that error within a look at
    the loops, instead of waiting out their timeouts."""
    pkg = package(PORT)

    def fail(self, tasks):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pkg.Scheduler, "_place", fail)
    if driver == "place_through_store":
        run = cp.place_through_store(
            pkg, W.describe_world(seed=0, nodes=12), 20, {"device": "cpu"},
            clock=pkg.FakeClock(), timeout=60)
    else:
        run = cp.task_startup(pkg, replicas=4, workers=2,
                              sched_kw={"device": "cpu"}, timeout=60)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        asyncio.run(asyncio.wait_for(run, 10))


def test_main_places_through_the_store_on_the_cpu(capsys):
    """The program's one JSON line: every replica placed or explained,
    with the seconds to quiet and their split."""
    out = cp.main(["--device", "cpu", "--nodes", "12", "--replicas", "20"])
    assert out["placed"] + out["pending"] == 20 and out["placed"] > 0
    assert 0 < out["quiet_s"] < 60
    assert capsys.readouterr().out.strip().startswith('{"device": "cpu"')
