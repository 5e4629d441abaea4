"""The port's append_band_copy against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain PyTorch version, held here to exact
equality with pallas_ops.append_band_copy in interpret mode (integer
data: no tolerance).  The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py compares it with the plain version there.
"""

from __future__ import annotations

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.parallel import pallas_ops
from swarmkit_tpu_torch import _build
from swarmkit_tpu_torch.parallel import cuda_ops


def _inputs(rng, m, ring, c):
    """Rings with uint32 payload values >= 2**31 among them, and a chunk
    of sources and a mask."""
    term = rng.integers(0, 2**31, (m, ring), dtype=np.int64).astype(np.int32)
    data = rng.integers(0, 2**32, (m, ring), dtype=np.uint64) \
        .astype(np.uint32)
    src_t = rng.integers(0, 2**31, (m, c), dtype=np.int64).astype(np.int32)
    src_d = rng.integers(0, 2**32, (m, c), dtype=np.uint64).astype(np.uint32)
    write = rng.random((m, c)) < 0.3
    return term, data, src_t, src_d, write


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("m,c,tile_m,off", [
    (8, 128, 8, 0), (5, 256, 8, 128), (12, 128, 5, 384), (7, 384, 8, 128)])
def test_plain_matches_pallas_in_place(m, c, tile_m, off):
    """The uneven row tiles of tests/test_pallas_ops.py, embedded at a
    chunk offset of a wider ring: the chunk equals the Pallas result for
    both dtypes, and every column outside it is untouched."""
    ring = 512
    rng = np.random.default_rng(m * 1000 + c + off)
    term, data, src_t, src_d, write = _inputs(rng, m, ring, c)
    lt, ld = _t(term), _t(data)
    cuda_ops.append_band_copy(lt, ld, off, _t(src_t), _t(src_d),
                              torch.from_numpy(write))
    sl = slice(off, off + c)
    want_t = pallas_ops.append_band_copy(
        jnp.asarray(term[:, sl]), jnp.asarray(src_t), jnp.asarray(write),
        tile_m=tile_m, interpret=True)
    want_d = pallas_ops.append_band_copy(
        jnp.asarray(data[:, sl]), jnp.asarray(src_d), jnp.asarray(write),
        tile_m=tile_m, interpret=True)
    assert want_d.dtype == jnp.uint32
    np.testing.assert_array_equal(lt.numpy()[:, sl], np.asarray(want_t))
    np.testing.assert_array_equal(ld.numpy()[:, sl].view(np.uint32),
                                  np.asarray(want_d))
    outside = np.ones(ring, bool)
    outside[sl] = False
    np.testing.assert_array_equal(lt.numpy()[:, outside], term[:, outside])
    np.testing.assert_array_equal(ld.numpy()[:, outside].view(np.uint32),
                                  data[:, outside])


def test_cpu_tensors_never_touch_the_cuda_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CUDA loader called for {name}")

    monkeypatch.setattr(_build, "load", refuse)
    before = dict(cuda_ops.LAUNCHES)
    term, data, src_t, src_d, write = _inputs(np.random.default_rng(0),
                                              4, 256, 128)
    cuda_ops.append_band_copy(_t(term), _t(data), 128, _t(src_t),
                              _t(src_d), torch.from_numpy(write))
    assert cuda_ops.LAUNCHES == before   # the plain version is no launch


def _args(m=4, ring=256, c=128):
    term, data, src_t, src_d, write = _inputs(np.random.default_rng(1),
                                              m, ring, c)
    return [_t(term), _t(data), 0, _t(src_t), _t(src_d),
            torch.from_numpy(write)]


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(2, 200), "does not fit"),
    (lambda a: a.__setitem__(2, -1), "does not fit"),
    (lambda a: a.__setitem__(3, a[3].to(torch.int64)), "src_term"),
    (lambda a: a.__setitem__(4, a[4][:, :64]), "src_data"),
    (lambda a: a.__setitem__(5, a[5].to(torch.uint8)), "write"),
    (lambda a: a.__setitem__(1, a[1][:3]), "log_data"),
    (lambda a: a.__setitem__(
        3, torch.zeros(128, 4, dtype=torch.int32).T), "contiguous"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    args = _args()
    bad(args)
    with pytest.raises(ValueError, match=match):
        cuda_ops.append_band_copy(*args)


def test_concurrent_loads_build_once(monkeypatch, tmp_path):
    """Threads that need one kernel at once (tasks preparing together on
    the executor's worker threads) run one build and share one library."""
    builds = []

    def fake_start(name):
        builds.append(name)
        return None, None

    def fake_finish(name, proc, tmp):
        _build.lib_path(name).touch()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build, "_finish", fake_finish)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    barrier = threading.Barrier(16)
    got = []

    def worker():
        barrier.wait(timeout=10)
        got.append(_build.load("sumsq"))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert builds == ["sumsq"]
    assert len(got) == 16 and all(lib is got[0] for lib in got)
