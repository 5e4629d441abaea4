"""The port's matmul, sumsq and matmul_chain against the JAX package's
Pallas kernels (interpret mode), on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py holds
them against these plain versions there).  Inputs are made with numpy
from a seed and handed to both packages with the same values (bf16 goes
across as its uint16 bits).  The shapes are those of
tests/test_pallas_ops.py.  Tolerances:

- f32 matmul: rtol=1e-5, atol=1e-3 (f32 sums in another order);
- bf16 matmul: rtol=2e-2, atol=1e-2, the JAX test's own (one bf16
  rounding of an f32 sum that differs in its last bits);
- sumsq: rtol=1e-5 (f32 sums in another order);
- matmul_chain: rtol=atol=1e-1, as the JAX test compares its two chains
  (bf16 roundings feed the next step).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.parallel import pallas_ops
from swarmkit_tpu_torch import _build
from swarmkit_tpu_torch.agent.tpu import operands_from_numpy
from swarmkit_tpu_torch.parallel import cuda_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def no_cuda_loader(monkeypatch):
    """CPU tensors never reach the CUDA build or loader."""
    def refuse(name):
        raise AssertionError(f"CPU call tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)
    before = dict(cuda_ops.LAUNCHES)
    yield
    assert cuda_ops.LAUNCHES == before


def _pair(shape, dtype, seed):
    """The same standard-normal values as a JAX array and a torch tensor."""
    jdt, _ = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    dtype=jdt)
    return x, operands_from_numpy({"x": np.asarray(x)}, "cpu")["x"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_matches_pallas(dtype):
    ja, ta = _pair((256, 128), dtype, 0)
    jb, tb = _pair((128, 384), dtype, 1)
    want = pallas_ops.matmul(ja, jb, tile_m=128, tile_n=128, tile_k=64,
                             interpret=True)
    got = cuda_ops.matmul(ta, tb, tile_m=128, tile_n=128, tile_k=64)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (256, 384)
    np.testing.assert_allclose(
        _np(got), np.asarray(want, np.float32),
        rtol=2e-2 if dtype == "bfloat16" else 1e-5,
        atol=1e-2 if dtype == "bfloat16" else 1e-3)


def test_matmul_multi_k_matches_pallas():
    """K spans 4 of the TPU kernel's tiles (its scratch carry)."""
    ja, ta = _pair((128, 512), "float32", 2)
    jb, tb = _pair((512, 128), "float32", 3)
    want = pallas_ops.matmul(ja, jb, tile_m=128, tile_n=128, tile_k=128,
                             interpret=True)
    got = cuda_ops.matmul(ta, tb, tile_m=128, tile_n=128, tile_k=128)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("shape_a,shape_b,tiles,match", [
    ((100, 64), (64, 64), dict(tile_m=64, tile_n=64, tile_k=64), "divide"),
    ((64, 32), (64, 64), {}, "contraction"),
    ((64, 96), (96, 64), dict(tile_k=64), "divide"),
])
def test_matmul_rejects_what_pallas_rejects(shape_a, shape_b, tiles, match):
    with pytest.raises(ValueError, match=match):
        pallas_ops.matmul(jnp.zeros(shape_a, jnp.float32),
                          jnp.zeros(shape_b, jnp.float32), **tiles,
                          interpret=True)
    with pytest.raises(ValueError, match=match):
        cuda_ops.matmul(torch.zeros(shape_a), torch.zeros(shape_b), **tiles)


def test_tiles_clamp_to_the_dimension_before_the_check():
    """tile = min(tile, dim) first: a 32x32 product passes 256 tiles."""
    ja, ta = _pair((32, 32), "float32", 7)
    want = pallas_ops.matmul(ja, ja, interpret=True)
    np.testing.assert_allclose(_np(cuda_ops.matmul(ta, ta)),
                               np.asarray(want), rtol=1e-5, atol=1e-3)


def test_matmul_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((32, 32), dtype=torch.float32)
    with pytest.raises(ValueError, match="dtypes differ"):
        cuda_ops.matmul(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        cuda_ops.matmul(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.matmul(a.t(), a)


@pytest.mark.parametrize("dtype,shape,tile_m", [
    ("bfloat16", (256, 192), 64), ("float32", (256, 192), 256),
    ("bfloat16", (32, 32), 256)])
def test_sumsq_matches_pallas(dtype, shape, tile_m):
    jx, tx = _pair(shape, dtype, 4)
    want = pallas_ops.sumsq(jx, tile_m=tile_m, interpret=True)
    got = cuda_ops.sumsq(tx, tile_m=tile_m)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sumsq_rejects_what_pallas_rejects():
    with pytest.raises(ValueError, match="rows 100 must divide tile 64"):
        pallas_ops.sumsq(jnp.zeros((100, 64), jnp.float32), tile_m=64,
                         interpret=True)
    with pytest.raises(ValueError, match="rows 100 must divide tile 64"):
        cuda_ops.sumsq(torch.zeros((100, 64)), tile_m=64)


@pytest.mark.parametrize("steps", [0, 3])
def test_matmul_chain_matches_pallas(steps):
    n = 128
    ja, ta = _pair((n, n), "bfloat16", 5)
    jx, tx = _pair((n, n), "bfloat16", 6)
    want = pallas_ops.matmul_chain(jx, ja, steps, tile=64, interpret=True)
    got = cuda_ops.matmul_chain(tx, ta, steps, tile=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-1, atol=1e-1)
    assert np.isfinite(_np(got)).all()
