"""The port on the CUDA card: the sm_90a kernels against their plain
versions, and the tick and the executor against the CPU.

Every test here is marked `cuda` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

The raft values compared are integers, so those comparisons are exact.
The float kernels are held to their plain versions on the same card
tensors: bf16 matmul within 2 bf16 ulps of max|ref| (both round one f32
sum, summed in another order), f32 matmul within 1e-5 of max|ref|, scaled
by sqrt(K / 512) past K = 512 (f32 sums in another order), sumsq within a
relative 1e-5 and bit-equal from call to call.
"""

from __future__ import annotations

import asyncio
import math

import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.agent.exec import do_task_state
from swarmkit_tpu_torch.agent.tpu import TpuExecutor
from swarmkit_tpu_torch.api import (
    ContainerSpec, Task, TaskSpec, TaskState, TaskStatus,
)
from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft import sim


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 (see README)")


def _band_args(rng, m, ring, c):
    term = rng.integers(-2**31, 2**31, (m, ring), dtype=np.int64)
    data = rng.integers(-2**31, 2**31, (m, ring), dtype=np.int64)
    src_t = rng.integers(-2**31, 2**31, (m, c), dtype=np.int64)
    src_d = rng.integers(-2**31, 2**31, (m, c), dtype=np.int64)
    write = rng.random((m, c)) < 0.3
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (term, data, src_t, src_d)] + [torch.from_numpy(write)]


@pytest.mark.cuda
@pytest.mark.parametrize("off,c", [(0, 128), (128, 256), (3, 125),
                                   (384, 128)])
def test_kernel_matches_plain_on_the_card(off, c):
    """The kernel against the plain version on the same card tensors, on
    the 16-byte vector path (aligned offset and width) and the scalar
    one; columns outside the chunk stay untouched."""
    _need_card()
    lt, ld, st, sd, w = (x.cuda() for x in _band_args(
        np.random.default_rng(off + c), 64, 512, c))
    want_t, want_d = lt.clone(), ld.clone()
    cuda_ops.append_band_copy_plain(want_t, want_d, off, st, sd, w)
    before = cuda_ops.LAUNCHES["append_band_copy"]
    cuda_ops.append_band_copy(lt, ld, off, st, sd, w)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["append_band_copy"] == before + 1
    assert torch.equal(lt, want_t) and torch.equal(ld, want_d)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    _need_card()

    def refuse(*a):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(cuda_ops, "append_band_copy_plain", refuse)
    args = [x.cuda() for x in _band_args(np.random.default_rng(0), 8, 256,
                                         128)]
    cuda_ops.append_band_copy(args[0], args[1], 128, *args[2:])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("log_chunk", [128, 0])
def test_tick_on_the_card_matches_the_cpu(log_chunk):
    """The same faulted run on the card and on the CPU, every field of
    every tick equal; the card run went through the kernel."""
    _need_card()
    cfg = sim.SimConfig(n=16, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=10, seed=4,
                        static_members=True, collect_stats=True,
                        log_chunk=log_chunk, peer_chunk=0, active_rows=0)
    rng = np.random.default_rng(9)
    states = {d: sim.init_state(cfg, device=d) for d in ("cuda", "cpu")}
    before = cuda_ops.LAUNCHES["append_band_copy"]
    for t in range(150):
        alive = rng.random(cfg.n) > 0.05
        drop = rng.random((cfg.n, cfg.n)) < 0.05
        cnt = int(rng.integers(0, 49))
        for d in states:
            states[d] = sim.step(
                states[d], cfg, alive=torch.from_numpy(alive).to(d),
                drop=torch.from_numpy(drop).to(d), prop_count=cnt,
                payload_fn=sim.run._payload_at, device=d)
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert int(states["cpu"].commit.max()) > 100
    assert cuda_ops.LAUNCHES["append_band_copy"] > before


def _matmul_tol(ref: torch.Tensor, k: int) -> float:
    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.frexp(top)[1] - 8)   # 2 ulps of max|ref|
    return 1e-5 * max(1.0, math.sqrt(k / 512)) * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(256, 128, 384), (128, 512, 128),
                                   (32, 32, 32), (100, 70, 130),
                                   (384, 384, 384), (1, 8, 1)])
def test_matmul_kernel_matches_plain(dtype, m, k, n):
    """Aligned, multi-K and edge shapes (K = 70 is not a multiple of 8, so
    the bf16 kernel loads those tiles element by element)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn((m, k), device="cuda", generator=g).to(dtype)
    b = torch.randn((k, n), device="cuda", generator=g).to(dtype)
    before = cuda_ops.LAUNCHES["matmul"]
    got = cuda_ops.matmul(a, b, tile_m=m, tile_n=n, tile_k=k)
    want = cuda_ops.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _matmul_tol(want, k), (err, _matmul_tol(want, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,offset", [(256, 192, 0), (2048, 1024, 0),
                                        (33, 7, 0), (64, 96, 1)])
def test_sumsq_kernel_matches_plain_and_repeats(dtype, m, n, offset):
    """Whole vectors, an element tail (33 x 7) and an unaligned base
    (offset 1: the scalar loop); two calls agree bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m * n + offset)
    flat = torch.randn(m * n + offset, device="cuda", generator=g).to(dtype)
    x = flat[offset:].view(m, n)
    before = cuda_ops.LAUNCHES["sumsq"]
    got = cuda_ops.sumsq(x, tile_m=m)
    again = cuda_ops.sumsq(x, tile_m=m)
    want = cuda_ops.sumsq_plain(x)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sumsq"] == before + 2
    assert got.dtype == torch.float32 and got.dim() == 0
    assert torch.equal(got, again)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


@pytest.mark.cuda
def test_float_kernels_never_take_the_plain_versions(monkeypatch):
    _need_card()

    def refuse(*a):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(cuda_ops, "matmul_plain", refuse)
    monkeypatch.setattr(cuda_ops, "sumsq_plain", refuse)
    x = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda")
    y = cuda_ops.matmul_chain(x, x, 2, tile=64)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()


@pytest.mark.cuda
def test_pallas_matmul_task_on_the_card_matches_the_cpu():
    """The executor runs tpu://pallas_matmul through the kernels, once per
    step each.  One seed gives both devices the same operand; the chains'
    matrices agree within the chain tolerance of tests/test_torch_ops.py
    (rtol=atol=1e-1), and the results, their f32 sums, within the sum of
    the matrices' differences plus 1e-5 of the sum of |values|."""
    _need_card()
    n, steps = 256, 3

    async def run(device):
        ex = TpuExecutor(device=device)
        task = Task(id="t", spec=TaskSpec(container=ContainerSpec(
            image="tpu://pallas_matmul", args=[f"n={n}", f"steps={steps}"])),
            status=TaskStatus(state=TaskState.ASSIGNED),
            desired_state=TaskState.RUNNING)
        ctl = await ex.controller(task)
        for _ in range(10):
            st = await do_task_state(task, ctl, now=0.0)
            if st is None:
                break
            task.status = st
        assert task.status.state == TaskState.COMPLETE, task.status.err
        return ctl.result, ctl._args[0]

    cuda_ops.reset_launches()
    on_card, a_card = asyncio.run(run("cuda"))
    assert cuda_ops.LAUNCHES["matmul"] == steps
    assert cuda_ops.LAUNCHES["sumsq"] == steps
    on_cpu, a_cpu = asyncio.run(run("cpu"))
    assert torch.equal(a_card.cpu(), a_cpu)
    got = cuda_ops.matmul_chain(a_card, a_card, steps).float().cpu()
    want = cuda_ops.matmul_chain(a_cpu, a_cpu, steps).float()
    torch.testing.assert_close(got, want, rtol=1e-1, atol=1e-1)
    bound = float((got - want).abs().sum() + 1e-5 * want.abs().sum())
    assert math.isfinite(on_card) and abs(on_card - on_cpu) <= bound
