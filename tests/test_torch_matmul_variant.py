"""The rule that picks the port's matmul kernel, on the CPU.

`cuda_ops._matmul_variant` is the only way to reach each of the three
matmul kernels: the wgmma kernel for bf16 that TMA can load (K and N
multiples of 8, 16-byte aligned bases), the WMMA kernel for other bf16,
the SIMT kernel for f32.  The rule reads dtype, shape and address only,
so meta tensors (address 0) stand in for the executor's [8192]^3
operands without allocating them.
"""

from __future__ import annotations

import pytest
import torch

from swarmkit_tpu_torch.parallel import cuda_ops

BF16, F32 = torch.bfloat16, torch.float32


def _meta(m, k, n, dtype=BF16):
    return (torch.empty((m, k), dtype=dtype, device="meta"),
            torch.empty((k, n), dtype=dtype, device="meta"))


def _offset_by_one(rows, cols, dtype=BF16):
    """A contiguous [rows, cols] view one element past an aligned base."""
    return torch.zeros(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


@pytest.mark.parametrize("make,variant", [
    (lambda: _meta(8192, 8192, 8192), "wgmma"),      # the executor's step
    (lambda: _meta(200, 72, 136), "wgmma"),          # M is free
    (lambda: _meta(128, 32, 64), "wgmma"),           # K below one stage
    (lambda: _meta(100, 70, 130), "wmma"),           # K = 70
    (lambda: _meta(64, 64, 1), "wmma"),              # N = 1
    (lambda: _meta(64, 64, 68), "wmma"),             # N = 68
    (lambda: (_offset_by_one(64, 64), torch.zeros(64, 64, dtype=BF16)),
     "wmma"),                                        # a's base unaligned
    (lambda: (torch.zeros(64, 64, dtype=BF16), _offset_by_one(64, 64)),
     "wmma"),                                        # b's base unaligned
    (lambda: _meta(8192, 8192, 8192, F32), "simt"),
    (lambda: _meta(100, 70, 130, F32), "simt"),
])
def test_matmul_variant_rule(make, variant):
    a, b = make()
    assert cuda_ops._matmul_variant(a, b) == variant


def test_every_variant_has_a_launch_count():
    assert set(cuda_ops.MATMUL_VARIANTS) == {"wgmma", "wmma", "simt"}
    for v in cuda_ops.MATMUL_VARIANTS:
        assert f"matmul_{v}" in cuda_ops.LAUNCHES
    before = dict(cuda_ops.LAUNCHES)
    cuda_ops.reset_launches()
    try:
        assert not any(cuda_ops.LAUNCHES.values())
    finally:
        cuda_ops.LAUNCHES.update(before)
