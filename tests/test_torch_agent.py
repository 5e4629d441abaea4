"""The port's agent against the JAX package's: the cases of
tests/test_agent.py (the task FSM, the shutdown and failure paths, the
worker's assign and remove, the TaskDB resume, the end-to-end lifecycle
with a dispatcher, a dispatcher restart, templated secrets), each written
once over a package and run through both; each run meets the JAX test's
own expectations and the two runs' traces are equal.

Then the port's TpuExecutor(device="cpu") under the port's own Agent,
through the whole leader pipeline on one store (tools/control_plane.py):
a service of 2 tpu://pallas_matmul n=64 steps=2 replicas, constrained to
the executor's node, restart condition none, run to COMPLETE; each task's
result equals the JAX package's executor on the same operands within
tests/test_torch_executor.py's tolerance (the chains within
rtol=atol=1e-1, the scalar within the sum of the chains' differences plus
1e-5 of the sum of |values|), and the store saw every task's states in
FSM order.
"""

from __future__ import annotations

import asyncio
import importlib
import random
import types

import numpy as np
import pytest

from swarmkit_tpu_torch.tools import control_plane as cp

ROOTS = ("swarmkit_tpu", "swarmkit_tpu_torch")


def _p(root) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    agent = m("agent")
    return types.SimpleNamespace(
        api=m("api"), objects=m("api.objects"), specs=m("api.specs"),
        msgs=m("api.dispatcher_msgs"), Agent=agent.Agent,
        AgentConfig=agent.AgentConfig, Worker=agent.Worker,
        do_task_state=agent.do_task_state, TaskDB=m("agent.storage").TaskDB,
        TaskManager=m("agent.task").TaskManager,
        TestExecutor=m("agent.testutils").TestExecutor,
        Dispatcher=m("manager.dispatcher").Dispatcher,
        MemoryStore=m("store.memory").MemoryStore,
        FakeClock=m("utils.clock").FakeClock,
        SystemClock=m("utils.clock").SystemClock, template=m("template"))


def make_task(P, i, state=None, desired=None):
    api = P.api
    return api.Task(id=f"task{i}", node_id="node1", spec=api.TaskSpec(),
                    status=api.TaskStatus(
                        state=api.TaskState.ASSIGNED if state is None
                        else state),
                    desired_state=int(api.TaskState.RUNNING if desired is None
                                      else desired))


async def eventually(pred, ticks=600):
    for _ in range(ticks):
        if pred():
            return
        # the dispatcher's debounce runs on the real clock here
        await asyncio.sleep(0.005)
    assert pred(), "condition not met"


def complete_msg(P, *tasks, secrets=()):
    m = P.msgs
    changes = [m.AssignmentChange(assignment=m.Assignment(task=t))
               for t in tasks]
    changes += [m.AssignmentChange(assignment=m.Assignment(secret=s))
                for s in secrets]
    return m.AssignmentsMessage(type=m.AssignmentsType.COMPLETE,
                                changes=changes)


# ---- the cases: each returns a trace and asserts the JAX test's checks --

async def case_fsm_walk(P):
    ex = P.TestExecutor()
    task = make_task(P, 1)
    ctl = await ex.controller(task)
    seen = []
    while True:
        st = await P.do_task_state(task, ctl, 0.0)
        if st is None or st.state == P.api.TaskState.RUNNING:
            if st is not None:
                seen.append(st.state)
            break
        task = task.copy()
        task.status = st
        seen.append(st.state)
    S = P.api.TaskState
    assert seen == [S.ACCEPTED, S.PREPARING, S.READY, S.STARTING, S.RUNNING]
    return [s.name for s in seen]


async def case_shutdown_short_circuits(P):
    S = P.api.TaskState
    ex = P.TestExecutor()
    task = make_task(P, 1, state=S.RUNNING, desired=S.SHUTDOWN)
    st = await P.do_task_state(task, await ex.controller(task), 0.0)
    assert st.state == S.SHUTDOWN
    return st.state.name


async def case_failure(P):
    S = P.api.TaskState
    ex = P.TestExecutor()
    ex.fail_start = True
    task = make_task(P, 1, state=S.STARTING)
    st = await P.do_task_state(task, await ex.controller(task), 0.0)
    assert st.state == S.FAILED and "start failed" in st.err
    return st.state.name, st.err


async def case_parks_at_ready(P):
    S = P.api.TaskState
    ex = P.TestExecutor()
    task = make_task(P, 1, desired=S.READY)
    ctl = await ex.controller(task)
    while True:
        st = await P.do_task_state(task, ctl, 0.0)
        if st is None:
            break
        task = task.copy()
        task.status = st
    assert task.status.state == S.READY
    task = task.copy()
    task.desired_state = int(S.RUNNING)
    st = await P.do_task_state(task, ctl, 0.0)
    assert st.state == S.STARTING
    return st.state.name


async def case_worker_runs_assigned(P):
    S = P.api.TaskState
    w = P.Worker(P.TestExecutor())
    statuses = []
    w.set_reporter(lambda tid, st: statuses.append((tid, st.state.name)))
    await w.assign(complete_msg(P, make_task(P, 1)))
    await eventually(lambda: ("task1", "RUNNING") in statuses)
    assert w.statuses["task1"].state == S.RUNNING
    await w.close()
    return statuses


async def case_worker_complete_set_removes(P):
    w = P.Worker(P.TestExecutor())
    w.set_reporter(lambda tid, st: None)
    await w.assign(complete_msg(P, make_task(P, 1), make_task(P, 2)))
    await eventually(lambda: len(w.task_managers) == 2)
    await w.assign(complete_msg(P, make_task(P, 1)))
    await eventually(lambda: len(w.task_managers) == 1)
    assert "task1" in w.task_managers
    assert w.db.get_task("task2") is None
    await w.close()
    return sorted(w.task_managers)


async def case_worker_secrets_follow(P):
    api, m = P.api, P.msgs
    w = P.Worker(P.TestExecutor())
    sec = api.Secret(id="s1", spec=api.SecretSpec(
        annotations=api.Annotations(name="s1"), data=b"x"))
    await w.assign(complete_msg(P, make_task(P, 1), secrets=[sec]))
    had = w.dependencies.secrets.get("s1") is not None
    await w.assign(m.AssignmentsMessage(
        type=m.AssignmentsType.INCREMENTAL,
        changes=[m.AssignmentChange(assignment=m.Assignment(secret=sec),
                                    action=m.AssignmentAction.REMOVE)]))
    gone = w.dependencies.secrets.get("s1") is None
    assert had and gone
    await w.close()
    return had, gone


async def case_worker_resumes_from_db(P):
    S = P.api.TaskState
    db = P.TaskDB()
    w = P.Worker(P.TestExecutor(), db=db)
    await w.assign(complete_msg(P, make_task(P, 1)))
    await eventually(lambda: w.statuses.get("task1") is not None
                     and w.statuses["task1"].state == S.RUNNING)
    await w.close()
    w2 = P.Worker(P.TestExecutor(), db=db)
    await w2.init()
    assert "task1" in w2.task_managers
    resumed = w2.task_managers["task1"].task.status.state
    assert resumed == S.RUNNING
    await w2.close()
    return resumed.name


async def _agent_setup(P):
    api = P.api
    store = P.MemoryStore()
    d = P.Dispatcher(store, rng=random.Random(0))
    await store.update(lambda tx: tx.create(api.Node(
        id="node1", spec=api.NodeSpec(annotations=api.Annotations(
            name="node1")),
        status=P.objects.NodeStatus(state=api.NodeState.UNKNOWN))))
    await d.start(mark_unknown=False)
    ex = P.TestExecutor()
    agent = P.Agent(P.AgentConfig(node_id="node1", executor=ex,
                                  connect=lambda: d))
    await agent.start()
    await agent.ready()
    return store, d, ex, agent


def _state(store, kind, oid):
    o = store.get(kind, oid)
    return o.status.state


async def case_agent_lifecycle(P):
    api, S = P.api, P.api.TaskState
    store, d, ex, agent = await _agent_setup(P)
    await eventually(lambda: _state(store, "node", "node1")
                     == api.NodeState.READY)
    assert store.get("node", "node1").description.hostname == "testhost"
    await store.update(lambda tx: tx.create(make_task(P, 1)))
    await eventually(lambda: _state(store, "task", "task1") == S.RUNNING)

    def shut(tx):
        t = tx.get("task", "task1").copy()
        t.desired_state = int(S.SHUTDOWN)
        tx.update(t)
    await store.update(shut)
    await eventually(lambda: _state(store, "task", "task1") == S.SHUTDOWN)
    await agent.stop()
    await d.stop()
    return store.get("node", "node1").description.to_dict(), \
        _state(store, "task", "task1").name


async def case_agent_workload_failure(P):
    S = P.api.TaskState
    store, d, ex, agent = await _agent_setup(P)
    await store.update(lambda tx: tx.create(make_task(P, 1)))
    await eventually(lambda: _state(store, "task", "task1") == S.RUNNING)
    ex.controllers["task1"].exit(fail="boom")
    await eventually(lambda: _state(store, "task", "task1") == S.FAILED)
    err = store.get("task", "task1").status.err
    assert "boom" in err
    await agent.stop()
    await d.stop()
    return err


async def case_agent_survives_dispatcher_restart(P):
    api, S = P.api, P.api.TaskState
    store, d, ex, agent = await _agent_setup(P)
    await store.update(lambda tx: tx.create(make_task(P, 1)))
    await eventually(lambda: _state(store, "task", "task1") == S.RUNNING)
    await d.stop()
    d2 = P.Dispatcher(store, rng=random.Random(1))
    await d2.start(mark_unknown=True)
    agent.config.connect = lambda: d2
    await eventually(lambda: _state(store, "node", "node1")
                     == api.NodeState.READY, ticks=2000)
    assert _state(store, "task", "task1") == S.RUNNING
    await agent.stop()
    await d2.stop()
    return _state(store, "task", "task1").name


async def case_task_manager_close_reaps(P):
    class BlockingController:
        async def update(self, task): pass
        async def prepare(self): pass
        async def start(self): pass
        async def wait(self):
            await asyncio.Event().wait()
        async def shutdown(self): pass
        async def close(self): pass

    statuses = []

    async def report(task_id, status):
        statuses.append(status.state)

    tm = P.TaskManager(make_task(P, 0), BlockingController(), report,
                       P.SystemClock())
    tm.start()
    await eventually(lambda: P.api.TaskState.RUNNING in statuses)
    await tm.close()
    await asyncio.sleep(0)
    leaked = [t for t in asyncio.all_tasks()
              if t.get_coro() is not None
              and getattr(t.get_coro(), "__name__", "") == "do_task_state"]
    assert not leaked
    return [s.name for s in statuses]


async def case_templated_secrets(P):
    api, specs = P.api, P.specs
    ex = P.TestExecutor()
    w = P.Worker(ex, clock=P.FakeClock())
    await w.init()
    node = P.objects.Node(id="n1", description=api.NodeDescription(
        hostname="host-a"))
    w.set_node(node)
    await ex.configure(node)
    secret = api.Secret(id="sec1", spec=api.SecretSpec(
        annotations=api.Annotations(name="dbcreds"),
        data=b"user={{.Service.Name}}-{{.Task.Slot}}\nhost={{.Node.Hostname}}",
        templating=specs.Driver(name="golang")))
    plain = api.Secret(id="sec2", spec=api.SecretSpec(
        annotations=api.Annotations(name="static"),
        data=b"value={{.Service.Name}}"))
    w.dependencies.secrets.add(secret, plain)
    task = api.Task(id="t1", service_id="s1", slot=4, node_id="n1",
                    desired_state=int(api.TaskState.RUNNING),
                    spec=api.TaskSpec(container=api.ContainerSpec(
                        image="img", secrets=[
                            specs.SecretReference(secret_id="sec1",
                                                  secret_name="dbcreds"),
                            specs.SecretReference(secret_id="sec2",
                                                  secret_name="static")])))
    task.service_annotations = api.Annotations(name="web")
    await w._start_manager(task)
    ctl = ex.controllers["t1"]
    for _ in range(50):
        if getattr(ctl, "resolved_secrets", None):
            break
        await asyncio.sleep(0.01)
    got = dict(ctl.resolved_secrets)
    assert got["dbcreds"] == b"user=web-4\nhost=host-a"
    assert got["static"] == b"value={{.Service.Name}}"
    assert b"{{.Service.Name}}" in \
        w.dependencies.secrets.get("sec1").spec.data
    await w.close()
    return got


async def case_binary_secret_template_error(P):
    api = P.api
    secret = api.Secret(id="sb", spec=api.SecretSpec(
        annotations=api.Annotations(name="binblob"),
        data=b"\xff\xfe\x00binary", templating=P.specs.Driver(name="golang")))
    task = api.Task(id="t1", service_id="s1", slot=1, node_id="n1")
    with pytest.raises(P.template.TemplateError) as e:
        P.template.expand_secret_spec(secret, task)
    assert "not valid UTF-8" in str(e.value)
    return str(e.value)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_agent_case_like_jax(name):
    """The case meets the JAX test's expectations in both packages, and
    the port's trace equals the JAX package's."""
    jax = asyncio.run(CASES[name](_p(ROOTS[0])))
    port = asyncio.run(CASES[name](_p(ROOTS[1])))
    assert port == jax


# ---- the port's TpuExecutor under the port's own Agent -----------------

N, STEPS = 64, 2
ARGS = [f"n={N}", f"steps={STEPS}", "seed=0"]


@pytest.fixture
def no_cuda_loader(monkeypatch):
    from swarmkit_tpu_torch import _build

    def refuse(name):
        raise AssertionError(f"CPU task tried to load the {name} kernel")
    monkeypatch.setattr(_build, "load", refuse)


def test_tpu_program_runs_to_complete_under_the_ports_agent(no_cuda_loader):
    """tpu://pallas_matmul through ControlApi, the orchestrator, the
    allocator, the store loop (its kernel on the CPU), the dispatcher and
    the port's Agent, to COMPLETE, the result equal to the JAX package's
    executor on the same operands."""
    from swarmkit_tpu import api as japi
    from swarmkit_tpu.agent import tpu as jtpu
    from swarmkit_tpu.parallel import pallas_ops
    from swarmkit_tpu_torch.agent.tpu import TpuExecutor, operands_from_numpy
    from swarmkit_tpu_torch.parallel import cuda_ops

    async def jax_run():
        task = japi.Task(id="j", spec=japi.TaskSpec(
            container=japi.ContainerSpec(image="tpu://pallas_matmul",
                                         args=ARGS)))
        ctl = await jtpu.TpuExecutor().controller(task)
        await ctl.prepare()
        await ctl.start()
        await ctl.wait()
        return float(np.asarray(ctl.result)), np.asarray(ctl._args[0])

    want, ja = asyncio.run(jax_run())
    ops = operands_from_numpy({"a": ja}, "cpu")

    class CarriedOperands(TpuExecutor):
        """The port's executor, handed the JAX program's operands."""

        async def controller(self, task, operands=None):
            return await super().controller(task, operands=ops)

    pkg = cp.package()
    ex = CarriedOperands(hostname="tpu-0", device="cpu")

    async def go():
        return await cp.task_startup(
            pkg, replicas=4, workers=2, sched_kw={"device": "cpu"},
            extra=ex, then=lambda p: cp.run_program(
                p, ex, "tpu://pallas_matmul", ARGS, timeout=120))

    out = asyncio.run(go())
    prog = out["then"]
    assert sorted(prog) == [1, 2]
    jout = np.asarray(pallas_ops.matmul_chain(ja, ja, STEPS,
                                              interpret=True), np.float32)
    pout = cuda_ops.matmul_chain(ops["a"], ops["a"], STEPS).float().numpy()
    np.testing.assert_allclose(pout, jout, rtol=1e-1, atol=1e-1)
    bound = np.abs(pout - jout).sum() + 1e-5 * np.abs(jout).sum()
    order = [s.name for s in sorted(pkg.api.TaskState)]
    for slot, t in prog.items():
        assert t["state"] == "COMPLETE", t
        assert t["node"] == f"node{out['workers'] + 1}"
        assert abs(t["result"] - want) <= bound, (t["result"], want, bound)
        idx = [order.index(s) for s in t["states"]]
        assert idx == sorted(idx), t["states"]
        assert t["run_s"] is not None and t["run_s"] >= 0
    assert out["time_to_all_running_s"] > 0
