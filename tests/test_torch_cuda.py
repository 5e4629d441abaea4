"""The port on the CUDA card: the sm_90a kernels against their plain
versions, and the tick and the executor against the CPU.

Every test here is marked `cuda` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

The raft values and the scheduler's placements compared are integers, so
those comparisons are exact.
The float kernels are held to their plain versions on the same card
tensors: bf16 matmul within 2 bf16 ulps of max|ref| (both round one f32
sum, summed in another order), f32 matmul within 1e-5 of max|ref|, scaled
by sqrt(K / 512) past K = 512 (f32 sums in another order), sumsq within a
relative 1e-5 and bit-equal from call to call.  Each matmul case also
checks which of the three matmul kernels its shape ran on.
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


@pytest.mark.cuda
def test_levers_on_the_card_match_the_cpu():
    """Banded peer counts and role-sparse progress through run_schedule,
    with a storm window that overflows the slab: card and CPU equal on
    every field, and the card took both the slab and the dense branch."""
    _need_card()
    from swarmkit_tpu_torch.raft.sim import kernel
    cfg = sim.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=10, seed=4,
                        static_members=True, collect_stats=True,
                        log_chunk=128, peer_chunk=8, active_rows=8)
    rng = np.random.default_rng(11)
    drop = rng.random((160, 32, 32)) < 0.03
    drop[60:90] |= ~np.eye(32, dtype=bool)
    alive = np.ones((160, 32), bool)
    out, counts = {}, {}
    for d in ("cuda", "cpu"):
        kernel.reset_counts()
        st, trace = sim.run_schedule(
            sim.init_state(cfg, device=d), cfg, torch.from_numpy(drop).to(d),
            torch.from_numpy(alive).to(d), prop_count=32, device=d)
        out[d] = (sim.state_to_numpy(st), trace.cpu())
        counts[d] = dict(kernel.COUNTS)
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    for name, want in out["cpu"][0].items():
        assert np.array_equal(out["cuda"][0][name], want), name
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["slab_ticks"] > 0
    assert counts["cuda"]["dense_fallback_ticks"] > 0


@pytest.mark.cuda
def test_mailbox_prevote_membership_on_the_card_match_the_cpu():
    """The mailbox wire (latency 2, jitter 1, 4 pipelined appends) with
    PreVote and dynamic membership on the [8, N] slab over a tiled log:
    drops, a storm that overflows the slab, and a follower removed and
    re-added through propose_conf; card and CPU equal on every field of
    every tick, and the card took both progress branches."""
    _need_card()
    from swarmkit_tpu_torch.raft.sim import kernel
    cfg = sim.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=14, seed=4,
                        latency=2, latency_jitter=1, inflight=4,
                        pre_vote=True, static_members=False,
                        collect_stats=True, log_chunk=128, peer_chunk=8,
                        active_rows=8)
    rng = np.random.default_rng(12)
    states = {d: sim.init_state(cfg, device=d) for d in ("cuda", "cpu")}
    counts = {d: {k: 0 for k in kernel.COUNTS} for d in states}
    for t in range(160):
        drop = rng.random((32, 32)) < 0.03
        if 110 <= t < 140:
            drop |= ~np.eye(32, dtype=bool)
        for d in states:
            if t in (60, 85):
                states[d] = sim.propose_conf(states[d], cfg, 31, t == 60,
                                             device=d)
            kernel.reset_counts()
            states[d] = sim.step(
                states[d], cfg, drop=torch.from_numpy(drop).to(d),
                prop_count=32, payload_fn=sim.run._payload_at, device=d)
            for k, v in kernel.COUNTS.items():
                counts[d][k] += v
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["slab_ticks"] > 0
    assert counts["cuda"]["dense_fallback_ticks"] > 0
    assert int(states["cpu"].commit.max()) > 100
    assert bool(states["cpu"].member[:, 31].all())


@pytest.mark.cuda
def test_reads_guard_cooldown_storage_on_the_card_match_the_cpu():
    """The read path, the vote guard, transfer cooldown and the gated
    storage model on the mailbox wire's [8, N] slab over a tiled log with
    banded counts: drops, stalled disks, flagged snapshot images, a
    transfer and a storm; card and CPU equal on every field of every
    tick, and the card took both progress branches."""
    _need_card()
    import dataclasses

    from swarmkit_tpu_torch.raft.sim import kernel
    cfg = sim.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=14, seed=4,
                        latency=2, latency_jitter=1, inflight=4,
                        static_members=True, collect_stats=True,
                        log_chunk=128, peer_chunk=8, active_rows=8,
                        read_batch=4, vote_guard=True,
                        transfer_cooldown_ticks=15, fsync_lag_ticks=2,
                        ack_gating=True)
    rng = np.random.default_rng(13)
    states = {d: sim.init_state(cfg, device=d) for d in ("cuda", "cpu")}
    counts = {d: {k: 0 for k in kernel.COUNTS} for d in states}
    for t in range(160):
        drop = rng.random((32, 32)) < 0.03
        if 110 <= t < 140:
            drop |= ~np.eye(32, dtype=bool)
        alive = np.ones(32, bool)
        alive[30] = not 40 <= t < 60
        flag = torch.from_numpy(np.arange(32) >= 28)
        for d in states:
            if 45 <= t < 50:
                states[d] = dataclasses.replace(
                    states[d], fsync_stall=flag.to(d))
            if 60 <= t < 64:
                states[d] = dataclasses.replace(
                    states[d], snap_bad=flag.to(d))
            if t == 80:
                ldr = int(sim.leader_mask(states[d]).int().argmax())
                states[d] = sim.transfer_leadership(states[d], cfg, ldr, 5)
            kernel.reset_counts()
            states[d] = sim.step(
                states[d], cfg, alive=torch.from_numpy(alive).to(d),
                drop=torch.from_numpy(drop).to(d), prop_count=32,
                payload_fn=sim.run._payload_at, device=d)
            for k, v in kernel.COUNTS.items():
                counts[d][k] += v
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["slab_ticks"] > 0
    assert counts["cuda"]["dense_fallback_ticks"] > 0
    cpu = states["cpu"]
    assert int(cpu.commit.max()) > 100 and int(sim.reads_served(cpu)) > 0
    assert bool((cpu.read_srv_idx >= cpu.read_srv_goal).all())


@pytest.mark.cuda
def test_observability_planes_on_the_card_match_the_cpu():
    """The flight recorder, telemetry and trace tags on the mailbox wire's
    [8, N] slab with PreVote, reads and banded counts over a tiled log:
    tagged proposes and reads, drops, a crashed row and a storm; card and
    CPU equal on every field (event ring and tel_* buffers included) of
    every tick, and both progress branches taken on the card."""
    _need_card()
    from swarmkit_tpu_torch.flightrec import decode_state
    from swarmkit_tpu_torch.raft.sim import kernel
    cfg = sim.SimConfig(n=32, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=14, seed=6,
                        latency=2, latency_jitter=1, inflight=4,
                        pre_vote=True, static_members=True,
                        collect_stats=True, log_chunk=128, peer_chunk=8,
                        active_rows=8, read_batch=4, record_events=True,
                        event_ring=64, collect_telemetry=True,
                        trace_tags=True, telemetry_prop_ring=64)
    rng = np.random.default_rng(17)
    states = {d: sim.init_state(cfg, device=d) for d in ("cuda", "cpu")}
    counts = {d: {k: 0 for k in kernel.COUNTS} for d in states}
    for t in range(140):
        drop = rng.random((32, 32)) < 0.03
        if 100 <= t < 120:
            drop |= ~np.eye(32, dtype=bool)
        alive = np.ones(32, bool)
        alive[29] = not 40 <= t < 60
        for d in states:
            if t % 10 == 5:
                states[d] = sim.submit_reads(states[d], cfg, 2,
                                             tag=0x51 + t, device=d)
            kernel.reset_counts()
            states[d] = sim.step(
                states[d], cfg, alive=torch.from_numpy(alive).to(d),
                drop=torch.from_numpy(drop).to(d), prop_count=32,
                payload_fn=sim.run._payload_at, prop_tag=0x77 + t, device=d)
            for k, v in kernel.COUNTS.items():
                counts[d][k] += v
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert counts["cuda"] == counts["cpu"]
    assert counts["cuda"]["slab_ticks"] > 0
    assert counts["cuda"]["dense_fallback_ticks"] > 0
    events, _ = decode_state(states["cuda"])
    assert {e.name for e in events if e.tag} == {"COMMIT_ADVANCE",
                                                 "READ_SERVED"}
    assert int(states["cuda"].tel_commit_hist.sum()) > 0


def _matmul_tol(ref: torch.Tensor, k: int) -> float:
    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.frexp(top)[1] - 8)   # 2 ulps of max|ref|
    return 1e-5 * max(1.0, math.sqrt(k / 512)) * top


def _variant_launches() -> dict:
    return {v: cuda_ops.LAUNCHES[f"matmul_{v}"]
            for v in cuda_ops.MATMUL_VARIANTS}


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bf16_variant", [
    (256, 128, 384, "wgmma"), (128, 512, 128, "wgmma"), (32, 32, 32, "wgmma"),
    (100, 70, 130, "wmma"), (384, 384, 384, "wgmma"), (1, 8, 1, "wmma"),
    (200, 72, 136, "wgmma"), (128, 32, 64, "wgmma")])
def test_matmul_kernel_matches_plain(dtype, m, k, n, bf16_variant):
    """Aligned, multi-K and edge shapes, each on the kernel its shape
    names: wgmma tiles ragged in M, N and K (384, 200 x 72 x 136) and K
    below one stage (32); the WMMA kernel where K = 70 or N = 1 is not a
    multiple of 8 (it loads those tiles element by element); f32 on the
    SIMT kernel."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _randn((m, k), dtype, m + k + n)
    b = _randn((k, n), dtype, m + k + n + 1)
    before, by_variant = cuda_ops.LAUNCHES["matmul"], _variant_launches()
    got = cuda_ops.matmul(a, b, tile_m=m, tile_n=n, tile_k=k)
    want = cuda_ops.matmul_plain(a, b)
    torch.cuda.synchronize()
    variant = bf16_variant if dtype == torch.bfloat16 else "simt"
    assert cuda_ops.LAUNCHES["matmul"] == before + 1
    assert _variant_launches() == {
        v: c + (v == variant) for v, c in by_variant.items()}
    assert got.dtype == dtype and got.shape == (m, n)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _matmul_tol(want, k), (err, _matmul_tol(want, k))


@pytest.mark.cuda
@pytest.mark.parametrize("encode", ["column", "row"])
def test_wgmma_layout_on_one_tile(encode):
    """One 128 x 256 tile, K = 64: A is a permutation (each row picks one
    K), B holds its own column or row index (integers below 256, exact in
    bf16), so any misplaced element of either operand's shared-memory
    layout shows as a wrong value."""
    _need_card()
    m, k, n = 128, 64, 256
    rng = np.random.default_rng(3)
    pick = np.concatenate([rng.permutation(k) for _ in range(m // k)])
    a = np.zeros((m, k), np.float32)
    a[np.arange(m), pick] = 1
    col, row = np.meshgrid(np.arange(n), np.arange(k))
    b = col if encode == "column" else row
    want = b[pick]                      # out[i, j] = b[pick[i], j]
    before = _variant_launches()["wgmma"]
    got = cuda_ops.matmul(*(torch.from_numpy(x.astype(np.float32))
                            .to("cuda", torch.bfloat16) for x in (a, b)))
    torch.cuda.synchronize()
    assert _variant_launches()["wgmma"] == before + 1
    np.testing.assert_array_equal(got.float().cpu().numpy(), want)


@pytest.mark.cuda
def test_wgmma_and_wmma_kernels_on_the_same_inputs():
    """The two bf16 kernels on one [512]^3 product, each within the
    tolerance of the plain version."""
    _need_card()
    a = _randn((512, 512), torch.bfloat16, 5)
    b = _randn((512, 512), torch.bfloat16, 6)
    assert cuda_ops._matmul_variant(a, b) == "wgmma"
    want = cuda_ops.matmul_plain(a, b)
    tol = _matmul_tol(want, 512)
    for variant in ("wgmma", "wmma"):
        before = _variant_launches()[variant]
        got = cuda_ops._matmul_launch(a, b, variant)
        torch.cuda.synchronize()
        assert _variant_launches()[variant] == before + 1
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (variant, err, tol)


@pytest.mark.cuda
def test_wgmma_kernel_raises_on_a_shape_it_does_not_take():
    """K = 70 breaks TMA's 16-byte row pitch: forced onto the wgmma kernel,
    the launch raises; nothing re-routes it."""
    _need_card()
    a = _randn((64, 70), torch.bfloat16, 7)
    b = _randn((70, 64), torch.bfloat16, 8)
    before = dict(cuda_ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="matmul_wgmma launch failed"):
        cuda_ops._matmul_launch(a, b, "wgmma")
    assert cuda_ops.LAUNCHES == before


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
    """With the plain versions and the WMMA and SIMT kernels refused, a
    [256, 256] bf16 chain still runs: each product is a wgmma launch."""
    _need_card()

    def refuse(*a):
        raise AssertionError("plain version called on CUDA tensors")

    real = cuda_ops._kernel

    def kernel(source, name=None):
        if name in ("matmul_wmma", "matmul_simt"):
            raise AssertionError(f"{name} called for a TMA-able bf16 chain")
        return real(source, name)

    monkeypatch.setattr(cuda_ops, "matmul_plain", refuse)
    monkeypatch.setattr(cuda_ops, "sumsq_plain", refuse)
    monkeypatch.setattr(cuda_ops, "_kernel", kernel)
    x = _randn((256, 256), torch.bfloat16, 9)
    before = _variant_launches()
    y = cuda_ops.matmul_chain(x, x, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    assert _variant_launches() == {**before,
                                   "wgmma": before["wgmma"] + 3}


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
    assert cuda_ops.LAUNCHES["matmul_wgmma"] == steps
    assert cuda_ops.LAUNCHES["sumsq"] == steps
    on_cpu, a_cpu = asyncio.run(run("cpu"))
    assert torch.equal(a_card.cpu(), a_cpu)
    got = cuda_ops.matmul_chain(a_card, a_card, steps).float().cpu()
    want = cuda_ops.matmul_chain(a_cpu, a_cpu, steps).float()
    torch.testing.assert_close(got, want, rtol=1e-1, atol=1e-1)
    bound = float((got - want).abs().sum() + 1e-5 * want.abs().sum())
    assert math.isfinite(on_card) and abs(on_card - on_cpu) <= bound


DST5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10, read_batch=2)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {}, dict(latency=2, latency_jitter=1, inflight=4, election_tick=14,
             pre_vote=True, fsync_lag_ticks=2, ack_gating=True,
             collect_telemetry=True, transfer_cooldown_ticks=15)],
    ids=["sync", "mailbox_storage_telemetry"])
def test_batched_tick_on_the_card_matches_the_cpu(extra):
    """The [B] tick on the card and on the CPU, 8 clusters under their own
    faults, every field of every tick equal, no host read-back, and the
    ring write one band-copy launch a tick over the [8*N, L] rows."""
    _need_card()
    from swarmkit_tpu_torch.raft.sim import kernel

    cfg = sim.SimConfig(**dict(DST5, **extra))
    rng = np.random.default_rng(3)
    states = {d: sim.broadcast_state(sim.init_state(cfg, device=d), 8)
              for d in ("cuda", "cpu")}
    kernel.reset_counts()
    before = cuda_ops.LAUNCHES["append_band_copy"]
    for t in range(80):
        alive = rng.random((8, cfg.n)) > 0.05
        drop = rng.random((8, cfg.n, cfg.n)) < 0.1
        for d in states:
            states[d] = sim.step(
                states[d], cfg, alive=torch.from_numpy(alive).to(d),
                drop=torch.from_numpy(drop).to(d), prop_count=2,
                payload_fn=sim.run._payload_at, device=d)
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert kernel.COUNTS["host_syncs"] == 0
    assert cuda_ops.LAUNCHES["append_band_copy"] == before + 80
    assert int(states["cpu"].commit.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", [None, "commit_no_quorum"])
def test_dst_explore_and_shrink_on_the_card_match_the_cpu(mutation):
    """explore on the card equals the CPU (masks, first ticks, per-tick
    bits, every final field), the schedules drawn the same on both; a
    mutated sweep's shrink gives the same schedule and evals."""
    _need_card()
    from swarmkit_tpu_torch import dst

    cfg = sim.SimConfig(**DST5)
    out = {}
    for d in ("cuda", "cpu"):
        sched, names = dst.make_batch(cfg, ticks=100, schedules=32, seed=0,
                                      device=d)
        res = dst.explore(sim.init_state(cfg, device=d), cfg, sched,
                          profiles=names, mutation=mutation, device=d)
        out[d] = (sched, res)
    (sc, rc), (sp, rp) = out["cuda"], out["cpu"]
    for k, v in sp.to_numpy().items():
        assert np.array_equal(sc.to_numpy()[k], v), k
    assert np.array_equal(rc.viol, rp.viol)
    assert np.array_equal(rc.first_tick, rp.first_tick)
    assert np.array_equal(rc.bits_by_tick, rp.bits_by_tick)
    got = sim.state_to_numpy(rc.final_state)
    for name, want in sim.state_to_numpy(rp.final_state).items():
        assert np.array_equal(got[name], want), name
    if mutation is None:
        assert rc.violating.size == 0
        return
    s = int(rc.violating[0])
    viol = int(rc.viol[s])
    small = {}
    for d in ("cuda", "cpu"):
        small[d] = dst.shrink(cfg, out[d][0].slice(s), viol, 2, mutation,
                              device=d)
    assert small["cuda"][1] == small["cpu"][1]
    for k, v in small["cpu"][0].to_numpy().items():
        assert np.array_equal(small["cuda"][0].to_numpy()[k], v), k
    assert dst.replay(cfg, small["cuda"][0], 2, mutation, device="cuda") \
        == dst.replay(cfg, small["cpu"][0], 2, mutation, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, dict(latency=1, latency_jitter=1,
                                            inflight=2)],
                         ids=["sync", "mailbox"])
def test_grouped_tick_on_the_card_matches_the_cpu(extra):
    """The multi-raft plane at G=8 on the card and on the CPU: the
    election, per-group fused counts, Router flushes with spills and
    reads, every field equal after every call; the steady grouped tick
    reads nothing back and its ring write is one band-copy launch."""
    _need_card()
    from swarmkit_tpu_torch import multiraft
    from swarmkit_tpu_torch.raft.sim import kernel

    cfg = sim.SimConfig(n=3, log_len=512, window=128, apply_batch=64,
                        max_props=32, keep=64, seed=7, election_tick=10,
                        read_batch=32, read_leases=True, static_members=True,
                        collect_telemetry=True, telemetry_prop_ring=64,
                        collect_stats=True, **extra)
    sides = {}
    for d in ("cuda", "cpu"):
        st, trace = multiraft.run_group_ticks(
            multiraft.init_groups(cfg, 8, device=d), cfg, 64,
            prop_count=1, device=d)
        calls = [sim.state_to_numpy(st), trace.cpu().numpy()]
        kernel.reset_counts()
        before = cuda_ops.LAUNCHES["append_band_copy"]
        st = multiraft.step_groups(
            st, cfg, prop_count=np.arange(8) % 5 * 8,
            payload_fn=sim.run._payload_at, device=d)
        if d == "cuda":
            assert kernel.COUNTS["host_syncs"] == 0
            assert cuda_ops.LAUNCHES["append_band_copy"] == before + 1
        calls.append(sim.state_to_numpy(st))
        r = multiraft.Router(cfg, 8, device=d)
        for i in range(8 * cfg.max_props * 2):
            r.offer(i, payload=i * 7919)
        r.offer_read("k", count=5)
        for _ in range(3):
            st = r.flush(st)
            calls.append(sim.state_to_numpy(st))
        sides[d] = calls
    for t, (got, want) in enumerate(zip(sides["cuda"], sides["cpu"])):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for name in want:
                assert np.array_equal(got[name], want[name]), (t, name)
        else:
            assert np.array_equal(got, want), t
    assert sides["cpu"][0]["commit"].max() > 0


@pytest.mark.cuda
def test_oracle_trace_on_the_card_matches_the_cpu():
    """oracle_trace with the tick on the card: the mutated commit path
    diverges at the CPU replay's tick with its fields and values; a clean
    schedule holds lockstep."""
    _need_card()
    from swarmkit_tpu_torch import dst

    cfg = sim.SimConfig(**dict(DST5, read_batch=2))
    sched, _ = dst.make_batch(cfg, ticks=100, schedules=16, seed=0,
                              device="cpu")
    res = dst.explore(sim.init_state(cfg, device="cpu"), cfg, sched,
                      mutation="commit_no_quorum", device="cpu")
    s = int(res.violating[0])
    clean = dst.make_schedule(cfg, 60, "random_drop", 0, 1, device="cpu")
    for one, mutation in ((sched.slice(s), "commit_no_quorum"),
                          (clean, None)):
        got = dst.oracle_trace(cfg, one.to("cuda"), 2, mutation,
                               device="cuda")
        assert got == dst.oracle_trace(cfg, one, 2, mutation, device="cpu")
        assert (got["diverged_at"] >= 0) == (mutation is not None)


BATCH_LEVERS = {
    "tiled_log": dict(log_len=512, log_chunk=128, record_events=True),
    "peer_chunk": dict(n=16, peer_chunk=8, active_rows=0),
    "active_rows": dict(n=16, active_rows=8),
    "planes": dict(record_events=True, collect_telemetry=True,
                   trace_tags=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("lever", sorted(BATCH_LEVERS))
def test_batched_levers_on_the_card_match_the_cpu(lever):
    """Each lever and plane under a batch axis on the card and on the
    CPU: 8 clusters under their own faults (and their own trace tags),
    every field of every tick equal, and the same host decisions."""
    _need_card()
    from swarmkit_tpu_torch.raft.sim import kernel

    cfg = sim.SimConfig(**dict(DST5, **BATCH_LEVERS[lever]))
    rng = np.random.default_rng(5)
    states = {d: sim.broadcast_state(sim.init_state(cfg, device=d), 8)
              for d in ("cuda", "cpu")}
    counts = {}
    for t in range(80):
        alive = rng.random((8, cfg.n)) > 0.05
        drop = rng.random((8, cfg.n, cfg.n)) < 0.1 * (t % 40 < 30)
        tags = torch.arange(8, dtype=torch.int32) + 100 * t
        for d in states:
            kernel.reset_counts()
            states[d] = sim.step(
                states[d], cfg, alive=torch.from_numpy(alive).to(d),
                drop=torch.from_numpy(drop).to(d), prop_count=2,
                payload_fn=sim.run._payload_at, prop_tag=tags.to(d),
                device=d)
            counts[d] = dict(kernel.COUNTS)
        assert counts["cuda"] == counts["cpu"], t
        got = sim.state_to_numpy(states["cuda"])
        want = sim.state_to_numpy(states["cpu"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), (t, name)
    assert int(states["cpu"].commit.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", [None, "commit_no_quorum"])
def test_mc_smoke_scan_on_the_card_matches_the_cpu(mutation, tmp_path):
    """The smoke scope's exhaustive scan on the card and on the CPU: the
    same summary (ladder, passes, violations), edges and .aut bytes."""
    _need_card()
    from swarmkit_tpu_torch import mc
    from swarmkit_tpu_torch.tools import mc_export

    sc = mc.SCOPES["smoke"]
    res = {d: mc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon,
                                 mutation=mutation, collect_edges=True,
                                 scope="smoke", device=d)
           for d in ("cuda", "cpu")}
    drop = ("elapsed_sec", "branches_per_sec")
    got, want = ({k: v for k, v in res[d].summary().items() if k not in drop}
                 for d in ("cuda", "cpu"))
    assert got == want
    assert res["cuda"].edges == res["cpu"].edges
    if mutation is None:
        assert [(lv["children"], lv["unique"]) for lv in got["levels"]] \
            == [(13, 4), (52, 29), (377, 225), (2925, 1403)]
        auts = []
        for d in ("cuda", "cpu"):
            path = str(tmp_path / f"{d}.aut")
            mc_export.export_scope("smoke", path, verbose=False, device=d)
            auts.append(open(path, "rb").read())
        assert auts[0] == auts[1]
    else:
        assert got["violations"]


def _group_columns(group: str, replicas: int):
    """sched_world's Docker-scale world (1,000 nodes) encoded for the
    first `replicas` tasks of `group`."""
    from swarmkit_tpu_torch.manager.scheduler import kernel as skernel
    from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo
    from swarmkit_tpu_torch.tools import sched_world

    tasks = sched_world.group_tasks(group, replicas)
    nodes = sched_world.build_nodes(sched_world.describe_world(0), tasks[0],
                                    0.0)
    p = tasks[0].spec.placement
    enc = skernel.encode_group(tasks[0], list(p.preferences), nodes,
                               NodeInfo.failure_key(tasks[0]), 0.0)
    assert enc is not None
    return skernel.group_columns(enc, replicas, device="cpu"), enc


@pytest.mark.cuda
@pytest.mark.parametrize("group,replicas", [("A", 6000), ("B", 6000),
                                            ("C", 1024)])
def test_place_greedy_matches_plain_on_the_card(group, replicas):
    """The placement kernel on the card against the plain loop on the CPU
    over every task of a Docker-scale group (exact); one launch."""
    _need_card()
    cols, enc = _group_columns(group, replicas)
    want = cuda_ops.place_greedy(cols, enc.n_branches, enc.has_service,
                                 replicas)
    before = cuda_ops.LAUNCHES["sched_place"]
    got = cuda_ops.place_greedy(cols.cuda(), enc.n_branches,
                                enc.has_service, replicas)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sched_place"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,spread", [(20000, True), (40000, False)])
def test_place_greedy_scratch_path_matches_plain(n, spread):
    """Columns too large for shared memory run on the global scratch."""
    _need_card()
    rng = np.random.default_rng(n)
    branch = np.arange(n) if spread else np.zeros(n, dtype=np.int64)
    cols = torch.from_numpy(np.stack([
        rng.random(n) < 0.7, rng.integers(0, 3, n), rng.integers(0, 4, n),
        rng.integers(0, 6, n), rng.random(n) < 0.1, branch,
    ]).astype(np.int32))
    nb = n if spread else 0
    assert cuda_ops._kernel("sched_place", "sched_place_scratch_words")(
        n, nb, 0) > 0
    want = cuda_ops.place_greedy(cols, nb, True, 300)
    got = cuda_ops.place_greedy(cols.cuda(), nb, True, 300)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _place_all(cols: torch.Tensor, nb: int, hs: bool, n_tasks: int) -> dict:
    """Each of sched_place.cu's kernels on the same card columns."""
    out = {v: cuda_ops._place_launch(cols, nb, hs, n_tasks, v)
           for v in cuda_ops.PLACE_VARIANTS}
    torch.cuda.synchronize()
    return {v: c.cpu() for v, c in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("group,replicas", [("A", 30_000), ("B", 30_000),
                                            ("C", 4_096)])
def test_place_tree_equals_rescan_on_every_task(group, replicas):
    """The tree kernel, two-word keys and field by field, against the
    rescan kernel over every task of a Docker-scale group, on the same
    card columns (exact)."""
    _need_card()
    cols, enc = _group_columns(group, replicas)
    got = _place_all(cols.cuda(), enc.n_branches, enc.has_service, replicas)
    assert torch.equal(got["tree"], got["rescan"])
    assert torch.equal(got["tree_fields"], got["rescan"])
    assert 0 < int((got["rescan"] >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [0, 3])
def test_place_tree_on_tie_heavy_columns(nb):
    """Every key equal, and with a spread level equal branch loads: the
    tie-breaks alone decide, down to the node index."""
    _need_card()
    n = 96
    cols = torch.zeros((6, n), dtype=torch.int32)
    cols[0], cols[1] = 1, 2
    if nb:
        cols[5] = torch.arange(n, dtype=torch.int32) % nb
    want = cuda_ops.place_greedy(cols, nb, True, 3 * n)
    got = _place_all(cols.cuda(), nb, True, 3 * n)
    for v, c in got.items():
        assert torch.equal(c, want), v
    assert int((want >= 0).sum()) == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 45, 999])
@pytest.mark.parametrize("spread", ["one branch", "three", "one a node"])
def test_place_tree_on_ragged_widths(n, spread):
    """N not a multiple of 32 with nb of 1, 3 and N, against the plain
    loop on the CPU."""
    _need_card()
    nb = {"one branch": 1, "three": 3, "one a node": n}[spread]
    rng = np.random.default_rng(n + nb)
    cols = torch.from_numpy(np.stack([
        rng.random(n) < 0.8, rng.integers(0, 4, n), rng.integers(0, 3, n),
        rng.integers(0, 5, n), rng.random(n) < 0.2,
        rng.permutation(n) % nb]).astype(np.int32))
    want = cuda_ops.place_greedy(cols, nb, True, 2 * n + 5)
    got = _place_all(cols.cuda(), nb, True, 2 * n + 5)
    for v, c in got.items():
        assert torch.equal(c, want), v


@pytest.mark.cuda
@pytest.mark.parametrize("count0", [2**30 - 13, 2**30 - 12, -1])
def test_place_tree_at_the_two_word_edge(count0):
    """Counts that reach 2^30 - 1 (keys in two words), one more, and a
    negative count (both field by field), against the plain loop."""
    _need_card()
    n, n_tasks = 6, 12
    cols = torch.tensor([[1] * n, [2] * n, [count0, 0, 5, count0, 1, 0],
                         [0, 1, 0, 1, 0, 1], [0] * n, [0] * n],
                        dtype=torch.int32)
    for nb in (0, 1):
        want = cuda_ops.place_greedy(cols, nb, True, n_tasks)
        for v, c in _place_all(cols.cuda(), nb, True, n_tasks).items():
            assert torch.equal(c, want), (v, nb)


@pytest.mark.cuda
def test_place_greedy_never_takes_the_plain_version(monkeypatch):
    _need_card()

    def refuse(*a):
        raise AssertionError("plain version called on CUDA tensors")

    cols, enc = _group_columns("A", 512)
    monkeypatch.setattr(cuda_ops, "place_greedy_plain", refuse)
    before = dict(cuda_ops.LAUNCHES)
    cuda_ops.place_greedy(cols.cuda(), enc.n_branches, enc.has_service, 512)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sched_place"] == before["sched_place"] + 1
    for v in cuda_ops.PLACE_VARIANTS:   # the tree kernel, never the rescan
        assert cuda_ops.LAUNCHES[f"sched_place_{v}"] == \
            before[f"sched_place_{v}"] + (v == cuda_ops.PLACE_VARIANT)


@pytest.mark.cuda
def test_differential_family_on_the_card():
    """One differential_sweep family on the card: the tick held to the
    host golden core on every field of every tick, one band-copy launch a
    tick, and the same result as on the CPU."""
    _need_card()
    from swarmkit_tpu_torch.tools import differential_sweep as ds

    before = cuda_ops.LAUNCHES["append_band_copy"]
    info = {}
    got = ds.run_family("sync7-membership", 0, device="cuda", info=info)
    assert got["ok"], got
    assert cuda_ops.LAUNCHES["append_band_copy"] - before == info["ticks"]
    want = ds.run_family("sync7-membership", 0, device="cpu")
    assert {k: got[k] for k in ("max_commit", "max_term", "n_ticks")} == \
        {k: want[k] for k in ("max_commit", "max_term", "n_ticks")}


@pytest.mark.cuda
def test_attack_sweep_append_flood_on_the_card(tmp_path):
    """fault_sweep's append_flood pipeline on the card: caught with the
    defense off, shrunk, replayed exactly (on the CPU too), the oracle in
    lockstep, clean with the inflight cap."""
    _need_card()
    from swarmkit_tpu_torch import dst
    from swarmkit_tpu_torch.tools import fault_sweep as fs

    stats = {}
    rows = fs.run_attack_sweep(["append_flood"], out_dir=str(tmp_path),
                               verbose=False, device="cuda", stats=stats)
    device = [r for r in rows if r["wire"] == "device"]
    assert len(device) == 1 and device[0]["ok"], device
    assert stats["append_flood"]["diverged_at"] == -1
    on_cpu = dst.replay_artifact(stats["append_flood"]["artifact"],
                                 device="cpu")
    assert on_cpu["matches_recorded"]


@pytest.mark.cuda
def test_pmatmul_task_on_the_card_matches_the_cpu():
    """tpu://pmatmul n=256 batch=4 on the card, one shard a card, and on
    the CPU: one seed gives both the same operands; the chains within
    rtol=atol=1e-1, the results within the sum of the chains' |diff|."""
    _need_card()
    from swarmkit_tpu_torch.agent import tpu

    n, steps, batch = 256, 3, 4

    async def run(device):
        ex = TpuExecutor(device=device)
        task = Task(id="t", spec=TaskSpec(container=ContainerSpec(
            image="tpu://pmatmul",
            args=[f"n={n}", f"steps={steps}", f"batch={batch}"])),
            status=TaskStatus(state=TaskState.ASSIGNED),
            desired_state=TaskState.RUNNING)
        ctl = await ex.controller(task)
        for _ in range(10):
            st = await do_task_state(task, ctl, now=0.0)
            if st is None:
                break
            task.status = st
        assert task.status.state == TaskState.COMPLETE, task.status.err
        return ctl

    card, cpu = asyncio.run(run("cuda")), asyncio.run(run("cpu"))
    assert len(card._args) == tpu.pmatmul_shards(batch, list(range(
        torch.cuda.device_count())))
    def on_host(shards):
        return torch.cat([x.cpu() for x in shards])

    assert torch.equal(on_host(card._args), on_host(cpu._args))
    a = tpu._seeded_normal((n, n), 0, "cpu")
    got = on_host(tpu.pmatmul_chain(
        list(card._args), [a.to(x.device) for x in card._args],
        steps)).float()
    want = on_host(tpu.pmatmul_chain(list(cpu._args), [a], steps)).float()
    torch.testing.assert_close(got, want, rtol=1e-1, atol=1e-1)
    bound = float((got - want).abs().sum() + 1e-5 * want.abs().sum())
    assert math.isfinite(card.result)
    assert abs(card.result - cpu.result) <= bound


@pytest.mark.cuda
def test_device_wire_flush_on_the_card_matches_the_cpu():
    """One mailbox of every edge of 8 rows through the exchange on the
    card and on the CPU: equal receiver-major words and lengths, each kept
    slot its message's bytes, each blocked slot length 0."""
    _need_card()
    from swarmkit_tpu_torch.raft.messages import Entry, Message, MsgType
    from swarmkit_tpu_torch.raft.wire import encode_message
    from swarmkit_tpu_torch.transport import DeviceMeshNet

    rng = np.random.default_rng(1)
    entries = [(f, t, k, encode_message(Message(
        type=MsgType.APP, to=t + 1, frm=f + 1, term=1, entries=(Entry(
            index=k + 1, term=1, data=rng.bytes(int(rng.integers(0, 3000)))),
        ))))
        for f in range(8) for t in range(8) for k in range(3)]
    card = DeviceMeshNet(rows=8, device="cuda")
    cpu = DeviceMeshNet(rows=8, device="cpu")
    words, lens, keep = card.pack(entries)
    keep[:] = rng.random(keep.shape) < 0.8
    got, want = card.run_exchange(words, lens, keep), \
        cpu.run_exchange(words, lens, keep)
    assert words.shape == (8, 8, 4, 1024)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for f, t, k, raw in entries:
        n = int(got[1][t, f, k])
        assert n == (len(raw) if keep[f, t, k] else 0)
        assert got[0][t, f, k].tobytes()[:n] == raw[:n]


def _card_mesh_devices():
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 4)


@pytest.mark.cuda
def test_sharded_explore_on_the_card_matches_unsharded():
    """explore over a schedule mesh of the card (cuda:0 named four times,
    or every card) against its unsharded card run, and the CPU: the same
    masks and final fields, one band-copy launch a tick a shard."""
    _need_card()
    from swarmkit_tpu_torch import dst, parallel

    cfg = sim.SimConfig(n=5, log_len=64, window=8, apply_batch=16,
                        max_props=8, keep=4, election_tick=10, seed=0,
                        read_batch=2)
    devices = _card_mesh_devices()
    mesh = parallel.schedule_mesh(32, devices)
    res = {}
    for label, d, kw in (("card", "cuda", dict(shard=False)),
                         ("sharded", "cuda", dict(mesh=mesh)),
                         ("cpu", "cpu", dict(shard=False))):
        sched, names = dst.make_batch(cfg, 40, 32, 0, device=d)
        cuda_ops.reset_launches()
        res[label] = dst.explore(sim.init_state(cfg, device=d), cfg, sched,
                                 profiles=names, device=d, **kw)
        torch.cuda.synchronize()
        res[label + "_launches"] = cuda_ops.LAUNCHES["append_band_copy"]
    assert res["sharded_launches"] == 40 * mesh.size
    for label in ("card", "cpu"):
        assert np.array_equal(res[label].bits_by_tick,
                              res["sharded"].bits_by_tick)
        want = sim.state_to_numpy(res[label].final_state)
        got = sim.state_to_numpy(res["sharded"].final_state)
        for name in want:
            assert np.array_equal(got[name], want[name]), name


@pytest.mark.cuda
def test_sharded_fleet_on_the_card_matches_unsharded():
    """A G=64 fleet of 3 over a group mesh of the card: the trace and
    every field of the unsharded card run."""
    _need_card()
    from swarmkit_tpu_torch import multiraft, parallel
    from swarmkit_tpu_torch.tools import bench

    cfg = bench.multiraft_cfg(3, 7)
    mesh = parallel.group_mesh(64, _card_mesh_devices())
    runs = []
    for shard in (False, True):
        g0 = multiraft.init_groups(cfg, 64, device="cuda")
        if shard:
            g0 = parallel.shard_rows(g0, mesh, axis=parallel.GROUP_AXIS,
                                     leading=64)
        out, trace = multiraft.run_group_ticks(g0, cfg, 48, prop_count=32,
                                               device="cuda")
        runs.append((sim.state_to_numpy(parallel.gather(out)),
                     trace.cpu().numpy()))
    (want, tw), (got, tg) = runs
    assert np.array_equal(tg, tw) and int(tg[-1, 1]) > 0
    for name in want:
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("lever", [{}, {"log_len": 1024, "log_chunk": 128,
                                    "peer_chunk": 8, "latency": 2,
                                    "latency_jitter": 1, "inflight": 3,
                                    "election_tick": 16, "read_batch": 4}])
def test_row_tick_on_the_card_matches_unsharded(lever):
    """One cluster's rows over a row mesh of the card (cuda:0 named four
    times, or every card): faults, a fused propose and host calls, every
    field and trace row equal to the unsharded card run and the CPU's,
    append_band_copy launched by every shard."""
    _need_card()
    from swarmkit_tpu_torch import parallel

    cfg = sim.SimConfig(**{**dict(n=64, log_len=128, window=16,
                                  apply_batch=32, max_props=16, keep=8,
                                  seed=11), **lever})
    devices = _card_mesh_devices()
    runs = {}
    for label, dev in (("card", "cuda"), ("sharded", "cuda"),
                       ("cpu", "cpu")):
        st = sim.init_state(cfg, device=dev)
        if label == "sharded":
            st = parallel.shard_rows(st, parallel.row_mesh(64, devices))
        cuda_ops.reset_launches()
        st, t = sim.run_until_leader(st, cfg, max_ticks=400, device=dev)
        st, trace = sim.run_ticks(st, cfg, 30, prop_count=4, drop_rate=0.1,
                                  crash_every=10, down_for=3, device=dev)
        st = sim.propose_dense(st, cfg, sim.run._payload_at, 3, device=dev)
        st, trace2 = sim.run_ticks(st, cfg, 10, prop_count=4, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[label] = (t, torch.cat([trace, trace2]).cpu(),
                       sim.state_to_numpy(parallel.gather(st)),
                       cuda_ops.LAUNCHES["append_band_copy"])
    want = runs["cpu"]
    assert int(want[1][:, 1].max()) > 0
    for label in ("card", "sharded"):
        t, trace, got, _ = runs[label]
        assert t == want[0] and torch.equal(trace, want[1]), label
        for name in want[2]:
            assert np.array_equal(got[name], want[2][name]), (label, name)
    assert runs["sharded"][3] >= runs["card"][3] > 0


@pytest.mark.cuda
def test_all_to_all_on_the_card_is_the_transpose():
    """The device wire's exchange over four mesh entries of the card."""
    _need_card()
    from swarmkit_tpu_torch import parallel
    from swarmkit_tpu_torch.transport import DeviceMeshNet

    rng = np.random.default_rng(5)
    words = rng.integers(-2**31, 2**31, (8, 8, 4, 64)).astype(np.int32)
    lens = rng.integers(1, 256, (8, 8, 4)).astype(np.int32)
    keep = rng.random((8, 8, 4)) < 0.9
    net = DeviceMeshNet(rows=8, device="cuda",
                        mesh=parallel.row_mesh(8, _card_mesh_devices()))
    got_w, got_l = net.run_exchange(words, lens, keep)
    assert np.array_equal(got_w, words.transpose(1, 0, 2, 3))
    assert np.array_equal(got_l, np.where(keep, lens, 0).transpose(1, 0, 2))


@pytest.mark.cuda
def test_store_loop_on_the_card_matches_the_cpu():
    """The orchestration script of tests/test_torch_orchestration.py with
    the scheduler's store loop on the card and on the CPU: the normalized
    stores are equal after every step, and the card ran sched_place."""
    _need_card()
    from swarmkit_tpu_torch.tools import control_plane as cp

    pkg = cp.package()
    cuda_ops.reset_launches()
    card = asyncio.run(cp.run_script(pkg, {"device": "cuda"}))
    launches = cuda_ops.LAUNCHES["sched_place"]
    cpu = asyncio.run(cp.run_script(pkg, {"device": "cpu"}))
    assert cp.same_steps(cpu, card) == []
    assert launches > 0


@pytest.mark.cuda
def test_pallas_matmul_service_under_the_ports_agent_on_the_card():
    """A service of two tpu://pallas_matmul replicas on the card's node,
    through the port's whole leader pipeline and its Agent, to COMPLETE:
    each result equals the same program driven directly on the card
    (both run the same kernels on the same seeded operand)."""
    _need_card()
    from swarmkit_tpu_torch.tools import control_plane as cp

    args = ["n=512", "steps=3", "seed=1"]
    pkg = cp.package()
    ex = TpuExecutor(hostname="card-0", device="cuda")

    async def direct():
        task = Task(id="t", spec=TaskSpec(container=ContainerSpec(
            image="tpu://pallas_matmul", args=args)),
            status=TaskStatus(state=TaskState.ASSIGNED),
            desired_state=TaskState.RUNNING)
        ctl = await TpuExecutor(device="cuda").controller(task)
        for _ in range(10):
            st = await do_task_state(task, ctl, now=0.0)
            if st is None:
                break
            task.status = st
        return ctl.result

    want = asyncio.run(direct())
    cuda_ops.reset_launches()
    out = asyncio.run(cp.task_startup(
        pkg, replicas=4, workers=2, extra=ex,
        then=lambda p: cp.run_program(p, ex, "tpu://pallas_matmul", args,
                                      timeout=300)))
    assert cuda_ops.LAUNCHES["matmul_wgmma"] == 2 * 3
    assert cuda_ops.LAUNCHES["sumsq"] == 2 * 3
    assert cuda_ops.LAUNCHES["sched_place"] > 0
    for t in out["then"].values():
        assert t["state"] == "COMPLETE", t
        assert t["result"] == want
