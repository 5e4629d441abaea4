"""The port's task executor on the CPU, and its parity with the JAX
package's executor.

Counterparts of tests/test_tpu_executor.py with ``device="cpu"``: the
lifecycle, rejections, prepare-time failures, the generic advancer,
describe and the pallas_matmul tile rules.  Then the same task through
both executors, with the JAX program's operands carried across
(`operands_from_numpy`), the JAX package's own Task object driving both:

- pallas_matmul (n=128, steps=2, tile=64): the chain's output matrix
  within rtol=atol=1e-1 (the chain tolerance of tests/test_torch_ops.py),
  and the scalar result, the f32 sum of that matrix, within the sum of the
  matrices' absolute differences plus 1e-5 of the sum of |values| (f32
  summation in another order);
- matmul (n=32, steps=2): the result within 2**-8 * n (one bf16 rounding
  of an rms-1 element, 2**-8, differing independently in each of n*n
  elements grows as their square root);
- axpy: rtol=1e-6 (log2(65536) roundings of pairwise f32 sums);
- spin: rtol=1e-6 (XLA may fuse the multiply-add into one FMA);
- pmatmul (n=32, steps=2) at d=4 and d=1, with `x` and the rebuilt `a`
  carried across: the chains within rtol=atol=1e-1 and the results
  within the sum of the chains' differences, as pallas_matmul.

Then what the executor serves beside its programs: describe over every
local card, secret/config payloads as parameters (JAX's, with no value
logged), the log buffer's watch() and selectors against JAX's, and the
port's executor under the JAX package's cluster agent, a service run to
COMPLETE and its lines streamed by `service logs --follow`.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from swarmkit_tpu import api as japi
from swarmkit_tpu.agent import tpu as jtpu
from swarmkit_tpu.parallel import pallas_ops
from swarmkit_tpu_torch import _build
from swarmkit_tpu_torch.agent.exec import (
    TaskError, TaskRejected, do_task_state,
)
from swarmkit_tpu_torch.agent import tpu
from swarmkit_tpu_torch.agent.tpu import (
    TpuExecutor, operands_from_numpy, parse_program,
)
from swarmkit_tpu_torch.api import (
    ContainerSpec, Task, TaskSpec, TaskState, TaskStatus,
)
from swarmkit_tpu_torch.parallel import cuda_ops
from tests.conftest import async_test


@pytest.fixture(autouse=True)
def no_cuda_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU task tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)


def tpu_task(image="tpu://matmul", args=(), desired=TaskState.RUNNING):
    return Task(id="t1", service_id="s1",
                spec=TaskSpec(container=ContainerSpec(image=image,
                                                      args=list(args))),
                status=TaskStatus(state=TaskState.ASSIGNED),
                desired_state=desired)


def cpu_executor(hostname=""):
    return TpuExecutor(hostname=hostname, device="cpu")


async def run_task(ex, task, operands=None):
    ctl = await ex.controller(task, operands=operands)
    await ctl.prepare()
    await ctl.start()
    await ctl.wait()
    return ctl


async def advance(task, ctl, limit=10):
    seen = []
    for _ in range(limit):
        st = await do_task_state(task, ctl, now=0.0)
        if st is None:
            break
        task.status = st
        seen.append(st.state)
    return seen


@async_test
async def test_controller_full_lifecycle():
    ex = cpu_executor("w1")
    ctl = await run_task(ex, tpu_task(args=["n=32", "steps=2"]))
    assert isinstance(ctl.result, float) and np.isfinite(ctl.result)
    lines = [m.data.decode() for m in ex.logs.tail("t1")]
    assert lines[-2] == f"result: {ctl.result}"
    await ctl.close()
    assert ctl._fn is None and ctl._args is None


@async_test
async def test_unknown_program_rejected():
    ctl = await cpu_executor().controller(
        tpu_task(image="tpu://no-such-program"))
    with pytest.raises(TaskRejected):
        await ctl.prepare()


@async_test
async def test_non_tpu_image_rejected():
    ctl = await cpu_executor().controller(tpu_task(image="nginx:latest"))
    with pytest.raises(TaskRejected):
        await ctl.prepare()


@async_test
async def test_bad_params_fail_at_prepare():
    ex = cpu_executor()
    ctl = await ex.controller(tpu_task(args=["n=not-a-number"]))
    with pytest.raises(TaskError, match="preparation"):
        await ctl.prepare()
    assert ex.logs.tail("t1")[-1].stream == 2   # STDERR
    # carried-across operands of the wrong shape fail there too
    ctl = await ex.controller(
        tpu_task(args=["n=32"]),
        operands={"a": torch.zeros((16, 16), dtype=torch.bfloat16)})
    with pytest.raises(TaskError, match="operand a"):
        await ctl.prepare()


@async_test
async def test_start_and_wait_need_their_predecessor():
    ctl = await cpu_executor().controller(tpu_task())
    with pytest.raises(TaskError, match="start before prepare"):
        await ctl.start()
    with pytest.raises(TaskError, match="wait before start"):
        await ctl.wait()


@async_test
async def test_do_task_state_advances_to_complete():
    task = tpu_task(image="tpu://pallas_matmul", args=["n=16", "steps=1"])
    ctl = await cpu_executor().controller(task)
    seen = await advance(task, ctl)
    assert seen == [TaskState.ACCEPTED, TaskState.PREPARING, TaskState.READY,
                    TaskState.STARTING, TaskState.RUNNING,
                    TaskState.COMPLETE]
    assert task.status.state == TaskState.COMPLETE


@async_test
async def test_desired_shutdown_short_circuits():
    task = tpu_task(desired=TaskState.SHUTDOWN)
    ctl = await cpu_executor().controller(task)
    assert await advance(task, ctl) == [TaskState.SHUTDOWN]


@async_test
async def test_describe_advertises_the_cpu():
    desc = await cpu_executor("w9").describe()
    assert desc.hostname == "w9"
    assert desc.engine.labels["executor"] == "tpu"
    assert desc.engine.engine_version == "torch/cpu"
    assert desc.resources.generic == {"cpu-chip": 1}
    assert desc.resources.generic_named == {"cpu-chip": ["0"]}


def test_parse_program():
    spec = ContainerSpec(image="tpu://matmul", args=["n=64"],
                         env=["STEPS=3"])
    assert parse_program(spec) == ("matmul", {"n": "64", "steps": "3"})


@async_test
async def test_pallas_matmul_program_full_lifecycle():
    before = dict(cuda_ops.LAUNCHES)
    ctl = await run_task(cpu_executor(), tpu_task(
        image="tpu://pallas_matmul", args=["n=128", "steps=2", "tile=64"]))
    assert np.isfinite(ctl.result)
    assert cuda_ops.LAUNCHES == before   # CPU: the plain versions ran
    await ctl.close()


@async_test
async def test_pallas_matmul_rejects_misaligned_tile():
    ex = cpu_executor()
    ctl = await ex.controller(tpu_task(
        image="tpu://pallas_matmul", args=["n=100", "tile=64"]))
    with pytest.raises(TaskRejected):
        await ctl.prepare()
    # non-positive tile is a permanent rejection, not a retryable error
    ctl = await ex.controller(tpu_task(
        image="tpu://pallas_matmul", args=["tile=0"]))
    with pytest.raises(TaskRejected):
        await ctl.prepare()


@async_test
async def test_pallas_matmul_default_tile_divides_n():
    """No tile param: n=384 takes 128, not a blind 256 that would reject
    the task; the seed fixes the operands."""
    results = []
    for seed in (0, 0, 1):
        ctl = await run_task(cpu_executor(), tpu_task(
            image="tpu://pallas_matmul",
            args=["n=384", "steps=1", f"seed={seed}"]))
        assert np.isfinite(ctl.result)
        results.append(ctl.result)
    assert results[0] == results[1] != results[2]


def _jax_task(image, args):
    return japi.Task(
        id="p1", service_id="s1",
        spec=japi.TaskSpec(container=japi.ContainerSpec(image=image,
                                                        args=list(args))),
        status=japi.TaskStatus(state=japi.TaskState.ASSIGNED),
        desired_state=japi.TaskState.RUNNING)


async def _both(image, args, names):
    """Run one JAX-package Task through the JAX executor, then, with its
    operands carried across, through the port's (driven by the port's
    do_task_state); returns (jax result, port result, JAX operands, port
    operands)."""
    task = _jax_task(image, args)
    jctl = await jtpu.TpuExecutor().controller(task)
    await jctl.prepare()
    await jctl.start()
    await jctl.wait()
    ops = operands_from_numpy(
        {k: np.asarray(v) for k, v in zip(names, jctl._args)}, "cpu")
    pctl = await cpu_executor().controller(task, operands=ops)
    assert (await advance(task, pctl))[-1] == TaskState.COMPLETE
    return float(np.asarray(jctl.result)), pctl.result, jctl._args, ops


@async_test
async def test_pallas_matmul_matches_the_jax_executor():
    n, steps, tile = 128, 2, 64
    want, got, (ja,), ops = await _both(
        "tpu://pallas_matmul", [f"n={n}", f"steps={steps}", f"tile={tile}"],
        ["a"])
    a = ops["a"]
    jout = np.asarray(pallas_ops.matmul_chain(ja, ja, steps, tile=tile,
                                              interpret=True), np.float32)
    pout = cuda_ops.matmul_chain(a, a, steps, tile=tile).float().numpy()
    np.testing.assert_allclose(pout, jout, rtol=1e-1, atol=1e-1)
    assert np.isclose(want, jout.sum(dtype=np.float64), rtol=1e-5)
    bound = np.abs(pout - jout).sum() + 1e-5 * np.abs(jout).sum()
    assert abs(got - want) <= bound, (got, want, bound)


@async_test
async def test_matmul_matches_the_jax_executor():
    n = 32
    want, got, _, _ = await _both("tpu://matmul", [f"n={n}", "steps=2"], ["a"])
    assert abs(got - want) <= 2.0 ** -8 * n, (got, want)


@pytest.mark.parametrize("image,names", [("tpu://axpy", ["x", "y"]),
                                         ("tpu://spin", ["x"])])
@async_test
async def test_scalar_programs_match_the_jax_executor(image, names):
    want, got, _, _ = await _both(image, [], names)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_operands_from_numpy_keeps_bf16_bits_and_0d():
    import jax.numpy as jnp

    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8)),
                    dtype=jnp.bfloat16)
    ops = operands_from_numpy({"x": np.asarray(x), "s": np.float32(3.5)},
                              "cpu")
    assert ops["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ops["x"].float().numpy(),
                                  np.asarray(x, np.float32))
    assert ops["s"].shape == () and float(ops["s"]) == 3.5


def test_concurrent_tasks_give_their_lone_results():
    """Two pallas_matmul tasks prepared and run at once on the executor's
    worker threads give the results they give alone."""
    async def go():
        ex = cpu_executor()
        tasks = [tpu_task(image="tpu://pallas_matmul",
                          args=["n=64", "steps=2", f"seed={s}"])
                 for s in (3, 4)]
        for i, t in enumerate(tasks):
            t.id = f"c{i}"
        ctls = await asyncio.gather(*(run_task(ex, t) for t in tasks))
        alone = [await run_task(ex, t) for t in tasks]
        return [c.result for c in ctls], [c.result for c in alone]

    together, alone = asyncio.run(go())
    assert together == alone


# ---------------------------------------------------------------------------
# tpu://pmatmul: the batch sharded over the executor's local devices


def _jax_pmatmul_chain(x, a, steps, d):
    """The chain output of the JAX package's pmatmul program (the body of
    its shard_map, returning the activations instead of their sum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    mesh = Mesh(jax.devices()[:d], axis_names=("batch",))

    def local(xs):
        def body(carry, _):
            y = (carry @ a).astype(jnp.bfloat16)
            total = jax.lax.psum(jnp.mean(jnp.square(y.astype(jnp.float32))),
                                 "batch")
            y = y / jnp.maximum(jnp.sqrt(total / d),
                                1e-6).astype(jnp.bfloat16)
            return y, ()
        out, _ = jax.lax.scan(body, xs, None, length=steps)
        return out

    fn = shard_map(local, mesh=mesh, in_specs=P("batch"),
                   out_specs=P("batch"))
    x = jax.device_put(x, NamedSharding(mesh, P("batch")))
    return np.asarray(jax.jit(fn)(x), np.float32)


@async_test
async def test_pmatmul_runs_sharded_over_the_device_mesh():
    """tpu://pmatmul shards its batch over every local device: the CPU
    named 8 times (the counterpart of the JAX tests' 8 virtual CPU
    devices) gives 8 shards, one a device, and the task completes."""
    ex = TpuExecutor(hostname="h", device="cpu", devices=["cpu"] * 8)
    task = tpu_task(image="tpu://pmatmul",
                    args=["n=32", "steps=2", "batch=8"])
    ctl = await ex.controller(task)
    assert (await advance(task, ctl))[-1] == TaskState.COMPLETE
    assert len(ctl._args) == 8
    assert all(x.shape == (1, 32, 32) for x in ctl._args)
    assert np.isfinite(ctl.result)
    # the largest count <= the devices that divides the batch
    assert [tpu.pmatmul_shards(b, [0] * 8) for b in (8, 12, 7, 11, 1)] \
        == [8, 6, 7, 1, 1]
    await ctl.close()


@pytest.mark.parametrize("batch,devices,d", [(4, 8, 4), (11, 1, 1)])
@async_test
async def test_pmatmul_matches_the_jax_executor(batch, devices, d):
    """The JAX executor's pmatmul (n=32, steps=2) with its operands carried
    across: `x` from the task, `a` (a closure constant there) rebuilt from
    PRNGKey(seed).  batch=4 shards 4 ways in both packages (JAX takes 4 of
    its 8 devices, the port 4 of 8 CPU slices); batch=11 runs one shard
    (no count from 2 to 8 divides 11), the port on its default device
    list.  The chains within rtol=atol=1e-1, the results within the sum
    of the chains' differences."""
    import jax
    import jax.numpy as jnp

    n, steps = 32, 2
    task = _jax_task("tpu://pmatmul", [f"n={n}", f"steps={steps}",
                                       f"batch={batch}"])
    jctl = await jtpu.TpuExecutor().controller(task)
    await jctl.prepare()
    await jctl.start()
    await jctl.wait()
    want = float(np.asarray(jctl.result))
    ja = jax.random.normal(jax.random.PRNGKey(0), (n, n), dtype=jnp.bfloat16)
    jx = np.asarray(jctl._args[0])
    ops = operands_from_numpy({"a": np.asarray(ja), "x": jx}, "cpu")
    ex = TpuExecutor(device="cpu", devices=["cpu"] * devices)
    pctl = await ex.controller(task, operands=ops)
    assert (await advance(task, pctl))[-1] == TaskState.COMPLETE
    assert len(pctl._args) == d
    jout = _jax_pmatmul_chain(jx, ja, steps, d)
    assert np.isclose(want, jout.sum(dtype=np.float64), rtol=1e-5)
    pout = torch.cat(tpu.pmatmul_chain(list(pctl._args), [ops["a"]] * d,
                                       steps)).float().numpy()
    np.testing.assert_allclose(pout, jout, rtol=1e-1, atol=1e-1)
    bound = np.abs(pout - jout).sum() + 1e-5 * np.abs(jout).sum()
    assert abs(pctl.result - want) <= bound, (pctl.result, want, bound)


@async_test
async def test_pmatmul_seeds_and_rejects_like_the_other_programs():
    ex = TpuExecutor(device="cpu", devices=["cpu"] * 2)
    args = ["n=16", "steps=1", "batch=2"]
    r = [(await run_task(ex, tpu_task("tpu://pmatmul", args + [f"seed={s}"]))
          ).result for s in (0, 0, 1)]
    assert r[0] == r[1] != r[2]
    ctl = await ex.controller(tpu_task("tpu://pmatmul", ["batch=0"]))
    with pytest.raises(TaskRejected):
        await ctl.prepare()
    ctl = await ex.controller(
        tpu_task("tpu://pmatmul", args),
        operands={"a": torch.zeros((16, 16), dtype=torch.bfloat16),
                  "x": torch.zeros((3, 16, 16), dtype=torch.bfloat16)})
    with pytest.raises(TaskError, match="operand x"):
        await ctl.prepare()


# ---------------------------------------------------------------------------
# describe: every local card


@async_test
async def test_describe_lists_every_local_card(monkeypatch):
    """On CUDA the node advertises gpu-chip: torch.cuda.device_count(), each
    card's index named; on the CPU cpu-chip: 1, however many shards the
    CPU is named for."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    ex = TpuExecutor(device="cuda:0")
    assert ex.devices == [torch.device("cuda", i) for i in range(4)]
    desc = await ex.describe()
    assert desc.resources.generic == {"gpu-chip": 4}
    assert desc.resources.generic_named == {"gpu-chip": ["0", "1", "2",
                                                         "3"]}
    assert desc.engine.engine_version == "torch/gpu"
    for devices in (None, ["cpu"] * 8):
        desc = await TpuExecutor(device="cpu", devices=devices).describe()
        assert desc.resources.generic == {"cpu-chip": 1}
        assert desc.resources.generic_named == {"cpu-chip": ["0"]}


# ---------------------------------------------------------------------------
# secret/config payloads as program parameters


def _templated_secret(mod, specs):
    return mod.Secret(id="sec1", spec=mod.SecretSpec(
        annotations=mod.Annotations(name="tuning"),
        data=b"n=3{{.Task.Slot}}\nsteps=2",
        templating=specs.Driver(name="golang")))


@async_test
async def test_tpu_program_params_from_templated_secret():
    """Secret payload k=v lines (template-expanded per task) feed tpu://
    program parameters, as in the JAX package: the same secret and task
    give JAX's parameters and, with `a` carried across, its result; the
    prepare log names the parameters and never shows their values."""
    from swarmkit_tpu.agent.dependency import Dependencies as JDeps
    from swarmkit_tpu.api import specs as jspecs
    from swarmkit_tpu_torch import api as tapi
    from swarmkit_tpu_torch.agent.dependency import Dependencies

    jex = jtpu.TpuExecutor()
    jex.dependencies = JDeps()
    jex.dependencies.secrets.add(_templated_secret(japi, jspecs))
    ex = cpu_executor()
    ex.dependencies = Dependencies()
    ex.dependencies.secrets.add(_templated_secret(tapi, tapi))

    task = _jax_task("tpu://matmul", [])
    task.slot = 2
    task.service_annotations = japi.Annotations(name="trainer")
    task.spec.container.secrets = [jspecs.SecretReference(
        secret_id="sec1", secret_name="tuning")]
    jctl = await jex.controller(task)
    await jctl.prepare()
    await jctl.start()
    await jctl.wait()
    ptask = tpu_task("tpu://matmul")
    ptask.slot = 2
    ptask.service_annotations = tapi.Annotations(name="trainer")
    ptask.spec.container.secrets = [tapi.SecretReference(
        secret_id="sec1", secret_name="tuning")]
    ctl = await ex.controller(ptask, operands=operands_from_numpy(
        {"a": np.asarray(jctl._args[0])}, "cpu"))
    assert ctl._dep_params() == jctl._dep_params() == {"n": "32",
                                                        "steps": "2"}
    assert (await advance(ptask, ctl))[-1] == TaskState.COMPLETE
    # n expanded to 32 (= "3" + slot "2"); the program ran with it
    assert ctl._args[0].shape == (32, 32)
    assert abs(ctl.result - float(np.asarray(jctl.result))) <= 2.0 ** -8 * 32
    lines = [m.data.decode() for m in ex.logs.tail(ptask.id)]
    assert any("n=<from-dependency>" in ln and "steps=<from-dependency>" in ln
               for ln in lines), lines
    assert not any("n=32" in ln or "steps=2" in ln for ln in lines), lines


@async_test
async def test_config_params_and_a_missing_dependency():
    """Config payloads feed parameters too (untemplated ones verbatim); a
    reference the worker has no payload for ends the task REJECTED."""
    from swarmkit_tpu_torch import api as tapi
    from swarmkit_tpu_torch.agent.dependency import Dependencies

    ex = cpu_executor()
    ex.dependencies = Dependencies()
    ex.dependencies.configs.add(tapi.Config(id="cfg1", spec=tapi.ConfigSpec(
        data=b"# tuning\nN = 16\nsteps=1\n")))
    task = tpu_task("tpu://matmul", ["seed=3"])
    task.spec.container.configs = [tapi.ConfigReference(config_id="cfg1")]
    ctl = await ex.controller(task)
    assert (await advance(task, ctl))[-1] == TaskState.COMPLETE
    assert ctl._args[0].shape == (16, 16)
    assert "seed=3 n=<from-dependency> steps=<from-dependency>" in \
        ex.logs.tail(task.id)[0].data.decode()
    task = tpu_task("tpu://matmul")
    task.spec.container.secrets = [tapi.SecretReference(secret_id="gone")]
    ctl = await ex.controller(task)
    assert (await advance(task, ctl))[-1] == TaskState.REJECTED
    assert "missing dependency 'gone'" in task.status.err


# ---------------------------------------------------------------------------
# logs: watch, selectors, and `service logs --follow` through the JAX agent


@async_test
async def test_log_watch_and_selectors_equal_jax():
    from swarmkit_tpu.agent import logs as jlogs
    from swarmkit_tpu.manager.logbroker import LogSelector as JSel
    from swarmkit_tpu_torch.agent import logs as tlogs

    jbuf, tbuf = jlogs.TaskLogBuffer(maxlen=3), tlogs.TaskLogBuffer(maxlen=3)
    jw, tw = jbuf.watch(), tbuf.watch()
    lines = [(f"t{i % 2}", 1 + i % 2, f"line{i}".encode(), "s1", "n1",
              float(i)) for i in range(5)]
    for t_id, stream, data, svc, node, ts in lines:
        jbuf.publish(t_id, stream, data, service_id=svc, node_id=node,
                     timestamp=ts)
        tbuf.publish(t_id, stream, data, service_id=svc, node_id=node,
                     timestamp=ts)

    def fields(m):
        return (m.context.service_id, m.context.node_id, m.context.task_id,
                m.timestamp, int(m.stream), m.data, m.seq)

    for _ in lines:
        assert fields(await asyncio.wait_for(tw.__anext__(), 2)) \
            == fields(await asyncio.wait_for(jw.__anext__(), 2))
    for t_id in ("t0", "t1", "none"):
        for n in (-1, 1, 5):
            assert [fields(m) for m in tbuf.tail(t_id, n)] \
                == [fields(m) for m in jbuf.tail(t_id, n)]
    tw.close()
    assert tw.closed and len(tbuf._bus) == 0
    jw.close()

    class T:
        id = "t1"
        service_id = "s1"

    for sel in ({"task_ids": ["t1"]}, {"service_ids": ["s1"]},
                {"node_ids": ["n1"]}, {"service_ids": ["s2"]}, {},
                {"task_ids": ["t2"], "node_ids": ["n2"]}):
        for node in ("n1", "n2"):
            assert tlogs.selector_matches(JSel(**sel), T, node) \
                == jlogs.selector_matches(JSel(**sel), T, node), (sel, node)


@async_test
async def test_port_executor_serves_a_service_and_its_logs_follow():
    """The port's executor on the CPU as the executor of the JAX package's
    cluster nodes: a tpu://matmul n=64 service reaches COMPLETE through the
    JAX agent, and `service logs --follow` streams its lifecycle lines from
    the port's buffer, then a live line."""
    from swarmkit_tpu.api import RestartCondition, RestartPolicy
    from swarmkit_tpu.manager.logbroker import (
        LogSelector, SubscribeLogsOptions,
    )
    from tests.integration_harness import TestCluster

    c = TestCluster()
    try:
        await c.add_manager("m1", executor=TpuExecutor(hostname="m1",
                                                       device="cpu"))
        await c.add_agent("w1", executor=TpuExecutor(hostname="w1",
                                                     device="cpu"))
        lead = await c.wait_leader()
        svc = await lead.control_api.create_service(japi.ServiceSpec(
            annotations=japi.Annotations(name="burn"),
            task=japi.TaskSpec(
                container=japi.ContainerSpec(image="tpu://matmul",
                                             args=["n=64", "steps=2"]),
                restart=RestartPolicy(condition=RestartCondition.NONE)),
            replicated=japi.ReplicatedService(replicas=2)))

        def completed():
            done = [t for t in lead.store.find("task")
                    if t.service_id == svc.id
                    and t.status.state == TaskState.COMPLETE]
            return len(done) >= 2 and done or None

        done = await c.poll(completed, "2 tpu tasks complete", timeout=30)
        got: list = []

        async def consume():
            async for m in lead.logbroker.subscribe_logs(
                    LogSelector(service_ids=[svc.id]),
                    SubscribeLogsOptions(follow=True)):
                got.append(m)

        follow = asyncio.get_running_loop().create_task(consume())
        try:
            await c.poll(lambda: sum(m.data == b"task complete"
                                     for m in got) >= 2 or None,
                         "both tasks' lines", timeout=15)
            for t in done:
                lines = [m.data.decode() for m in got
                         if m.context.task_id == t.id]
                assert lines[0] == "prepared tpu://matmul n=64 steps=2 on cpu"
                assert lines[1:2] == ["started on device"]
                assert lines[2].startswith("result: ")
                assert np.isfinite(float(lines[2][len("result: "):]))
                assert lines[3:] == ["task complete"]
            t = done[0]
            ex = c.executors[t.node_id]
            ex.logs.publish(t.id, 1, b"live", service_id=t.service_id,
                            node_id=t.node_id)
            await c.poll(lambda: any(m.data == b"live" for m in got) or None,
                         "the live line", timeout=15)
        finally:
            follow.cancel()
    finally:
        await c.stop_all()


def test_chip_smoke_executor_phase_on_the_cpu(monkeypatch):
    """The card phase's checks with the CPU as the card, at n=64: pmatmul
    one shard a device, n=256 against the CPU, the secret-templated task
    with no value in its lines, and watch() giving the lifecycle lines in
    order."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PMATMUL_BATCH", 2)
    out = chip_smoke.phase_executor_rest(
        torch, {"xla_chain_run_s": [1.0]}, card="cpu", n=64, steps=2)
    assert out["pmatmul"]["shards"] == 1
    assert out["pmatmul_small"]["card"] == out["pmatmul_small"]["cpu"]
    assert out["secret_task_lines"][0] == (
        "prepared tpu://matmul seed=0 n=<from-dependency> "
        "steps=<from-dependency> on cpu")


def test_template_expansion_equals_jax():
    """The port's template.py against the JAX package's: the per-task
    context (with and without a node), expansion, and the errors of an
    unknown variable and of a templated payload that is not UTF-8."""
    from swarmkit_tpu import template as jtemplate
    from swarmkit_tpu.api import specs as jspecs
    from swarmkit_tpu.api.objects import Node as JNode
    from swarmkit_tpu_torch import api as tapi
    from swarmkit_tpu_torch import template as ttemplate

    def task(mod, slot):
        t = mod.Task(id="tid", service_id="sid", slot=slot, node_id="nid")
        t.service_annotations = mod.Annotations(name="svc",
                                                labels={"tier": "gold"})
        return t

    jnode = JNode(id="nid", description=japi.NodeDescription(
        hostname="h1", platform=japi.Platform(architecture="gpu",
                                              os="torch")))
    tnode = tapi.Node(id="nid", description=tapi.NodeDescription(
        hostname="h1", platform=tapi.Platform(architecture="gpu",
                                              os="torch")))
    text = ("{{.Service.Name}}/{{.Task.Name}}/{{ .Task.Slot }}/"
            "{{.Service.Labels.tier}}")
    for slot in (0, 3):
        for jn, tn in ((None, None), (jnode, tnode)):
            jctx = jtemplate.task_context(task(japi, slot), jn)
            tctx = ttemplate.task_context(task(tapi, slot), tn)
            assert tctx == jctx
            assert ttemplate.expand(text, tctx) == jtemplate.expand(
                text, jctx)
    jctx = jtemplate.task_context(task(japi, 1), jnode)
    assert ttemplate.expand("{{.Node.Hostname}}-{{.Node.Platform.OS}}",
                            jctx) == "h1-torch"
    with pytest.raises(ttemplate.TemplateError, match="unknown"):
        ttemplate.expand("{{.Task.Nope}}", jctx)
    bad = tapi.Secret(id="s", spec=tapi.SecretSpec(
        data=b"\xff", templating=tapi.Driver(name="golang")))
    with pytest.raises(ttemplate.TemplateError, match="UTF-8"):
        ttemplate.expand_secret_spec(bad, task(tapi, 1))
    plain = tapi.Secret(id="s", spec=tapi.SecretSpec(data=b"{{.Task.ID}}"))
    assert ttemplate.expand_secret_spec(plain, task(tapi, 1)) is plain
    jsec = japi.Secret(id="s", spec=japi.SecretSpec(
        data=b"k={{.Task.Slot}}", templating=jspecs.Driver(name="golang")))
    tsec = tapi.Secret(id="s", spec=tapi.SecretSpec(
        data=b"k={{.Task.Slot}}", templating=tapi.Driver(name="golang")))
    assert ttemplate.expand_secret_spec(tsec, task(tapi, 7)).spec.data \
        == jtemplate.expand_secret_spec(jsec, task(japi, 7)).spec.data \
        == b"k=7"
    assert tsec.spec.data == b"k={{.Task.Slot}}"   # expanded on a copy


@async_test
async def test_watch_queue_and_dependency_stores_equal_jax():
    """The port's copies of the event bus and the worker's secret/config
    stores behave as the JAX package's: filtered and bounded watchers
    (closed on overflow), poll/try_get/get, close; add/get/remove/reset."""
    from swarmkit_tpu.agent import dependency as jdep
    from swarmkit_tpu.watch import queue as jqueue
    from swarmkit_tpu_torch.agent import dependency as tdep
    from swarmkit_tpu_torch.watch import queue as tqueue

    def drive(mod):
        q = mod.Queue(limit=3)
        evens = q.watch(lambda e: e % 2 == 0)
        small = q.watch()
        q.publish_all(range(5))
        out = [evens.poll(), small.overflowed, small.closed, len(q)]
        q.publish(6)
        out += [evens.try_get(), evens.try_get(), len(evens)]
        q.close()
        out.append(evens.closed)
        return out

    assert drive(tqueue) == drive(jqueue) == [
        [0, 2, 4], True, True, 1, 6, None, 0, True]
    w = tqueue.Queue().watch()
    w.close()
    with pytest.raises(tqueue.WatcherClosed):
        await w.get()

    class Item:
        def __init__(self, i):
            self.id = i

    for mod in (tdep, jdep):
        deps = mod.Dependencies()
        deps.secrets.add(Item("a"), Item("b"))
        deps.configs.add(Item("c"))
        deps.secrets.remove(["a", "zz"])
        assert (len(deps.secrets), len(deps.configs)) == (1, 1)
        assert deps.secrets.get("a") is None
        assert deps.secrets.get("b").id == "b"
        deps.configs.reset()
        assert len(deps.configs) == 0
