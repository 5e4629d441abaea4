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
- spin: rtol=1e-6 (XLA may fuse the multiply-add into one FMA).
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
from swarmkit_tpu_torch.agent.tpu import (
    TpuExecutor, operands_from_numpy, parse_program,
)
from swarmkit_tpu_torch.api import (
    ContainerSpec, SecretReference, Task, TaskSpec, TaskState, TaskStatus,
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


@pytest.mark.parametrize("image,refs", [
    ("tpu://pmatmul", {}),
    ("tpu://matmul", {"secrets": [SecretReference(secret_id="sec1")]}),
])
@async_test
async def test_unported_paths_end_rejected(image, refs):
    """pmatmul and dependency parameters are not ported: the task ends
    REJECTED at prepare, with the reason in its status."""
    task = tpu_task(image=image, args=["n=32", "steps=2"])
    for k, v in refs.items():
        setattr(task.spec.container, k, v)
    ctl = await cpu_executor().controller(task)
    seen = await advance(task, ctl)
    assert seen[-1] == TaskState.REJECTED
    assert "not ported" in task.status.err


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
