"""The port's append_band_copy against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain PyTorch version, held here to exact
equality with pallas_ops.append_band_copy in interpret mode (integer
data: no tolerance).  The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py compares it with the plain version there.  Which
of the kernel's paths takes a call is plain Python (band_copy_path), so
the shapes of every call site are held to their path here.
"""

from __future__ import annotations

import collections
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.parallel import pallas_ops
from swarmkit_tpu_torch import _build
from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft import sim


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


def _addresses(*tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("m,ring", [(3 * 64, 32), (5 * 16, 64)])
@pytest.mark.parametrize("density", [0.0, 0.013, 1.0])
def test_plain_matches_pallas_on_whole_rings(m, ring, density):
    """The whole-ring write of the untiled tick and the batched tools
    (off 0, the chunk as wide as the ring; rings this small take the
    kernel's words path) on the model checker's and the DST sweep's narrow
    rings, with no element, a few and every element written."""
    rng = np.random.default_rng(m * ring + int(density * 1000))
    term, data, src_t, src_d, _ = _inputs(rng, m, ring, ring)
    write = rng.random((m, ring)) < density
    lt, ld, st, sd, w = (_t(term), _t(data), _t(src_t), _t(src_d),
                         torch.from_numpy(write))
    assert cuda_ops.band_copy_path(m, ring, 0, ring,
                                   *_addresses(lt, ld, st, sd, w)) == "words"
    cuda_ops.append_band_copy(lt, ld, 0, st, sd, w)
    want_t = pallas_ops.append_band_copy(
        jnp.asarray(term), jnp.asarray(src_t), jnp.asarray(write),
        interpret=True)
    want_d = pallas_ops.append_band_copy(
        jnp.asarray(data), jnp.asarray(src_d), jnp.asarray(write),
        interpret=True)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(ld.numpy().view(np.uint32),
                                  np.asarray(want_d))


@pytest.mark.parametrize("n,ring,off,width,path", [
    (4096, 8192, 1024, 1024, "chunk"),
    (4096, 8192, 0, 1024, "chunk"),
    (32768, 8192, 7168, 1024, "chunk"),
    (8192, 8192, 3072, 1024, "chunk"),
    (4096, 8192, 0, 8192, "flat"),
    (3145728, 32, 0, 32, "flat"),
    (81920, 64, 0, 64, "flat"),
    (3072, 512, 0, 512, "flat"),
    (16384, 64, 0, 64, "flat"),
    (16383, 64, 0, 64, "words"),
    (1280, 64, 0, 64, "words"),
    (128, 128, 0, 128, "words"),
    (40, 64, 0, 64, "words"),
    (64, 512, 3, 125, "scalar"),
    (64, 512, 4, 120, "scalar"),
], ids=["headline-chunk", "headline-first-chunk", "rung-chunk",
        "row-tick-chunk", "tiled-fallback", "n3h8-pass", "dst-16384",
        "multiraft-1024x3", "ring-of-2^20", "ring-below-2^20", "dst-256",
        "differential-128", "fault-sweep-explore", "misaligned",
        "width-not-16"])
def test_band_copy_path_of_each_shape(n, ring, off, width, path):
    """Each call site's shapes at full width take the path meant for them:
    the tiled chunks the 16-element chunk path, every whole ring (the
    untiled tick, the batched tools, the tiled tick's full-pass fallback)
    the flat path from FLAT_TILES_MIN elements up and the words path
    below, and any other offset or width the scalar one."""
    assert cuda_ops.band_copy_path(n, ring, off, width, *[512] * 5) == path


@pytest.mark.parametrize("misaligned", range(5))
def test_band_copy_path_needs_aligned_bases(misaligned):
    """Either vector path needs each of the five tensors 16-byte aligned;
    one base off by 4 bytes takes the scalar path."""
    addresses = [512] * 5
    addresses[misaligned] += 4
    for shape in ((3145728, 32, 0, 32), (4096, 8192, 1024, 1024)):
        assert cuda_ops.band_copy_path(*shape, *addresses) == "scalar"


@pytest.mark.parametrize("log_chunk,batch", [(128, 0), (0, 0), (0, 4)],
                         ids=["tiled", "untiled", "batched"])
def test_call_sites_take_their_paths(monkeypatch, log_chunk, batch):
    """Every call of a faulted run, as the tick makes it: the tiled tick's
    chunks take the chunk path and its full-pass fallback a whole-ring
    path; so does the untiled tick's whole ring, over [N, L] or [B*N, L]
    rows (words at these sizes, below FLAT_TILES_MIN)."""
    cfg = sim.SimConfig(n=16, log_len=1024, window=64, apply_batch=64,
                        max_props=64, keep=32, election_tick=10, seed=4,
                        static_members=True, log_chunk=log_chunk,
                        peer_chunk=0, active_rows=0)
    seen = collections.Counter()
    launch = cuda_ops.append_band_copy

    def record(lt, ld, off, s_t, s_d, w):
        n, ring = lt.shape
        width = w.shape[1]
        seen["ring" if width == ring else "chunk",
             cuda_ops.band_copy_path(n, ring, off, width,
                                     *_addresses(lt, ld, s_t, s_d, w))] += 1
        launch(lt, ld, off, s_t, s_d, w)

    monkeypatch.setattr(cuda_ops, "append_band_copy", record)
    st = sim.init_state(cfg, device="cpu")
    lead = (batch,) if batch else ()
    if batch:
        st = sim.broadcast_state(st, batch)
    rng = np.random.default_rng(9)
    for _ in range(60):
        alive = rng.random(lead + (cfg.n,)) > 0.05
        drop = rng.random(lead + (cfg.n, cfg.n)) < 0.05
        st = sim.step(st, cfg, alive=torch.from_numpy(alive),
                      drop=torch.from_numpy(drop), prop_count=16,
                      payload_fn=sim.run._payload_at, device="cpu")
    want = {("ring", "words")} | ({("chunk", "chunk")} if log_chunk
                                  else set())
    assert set(seen) == want, seen
    assert int(st.commit.max()) > 0


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


def test_band_copy_probe_needs_a_card(capsys):
    """The probe tool (tools/band_copy_probe.py) measures on the card only:
    here it prints why and exits 2, building nothing."""
    from swarmkit_tpu_torch.tools import band_copy_probe

    assert band_copy_probe.main() == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("density", [0.0, 0.013, 1.0])
def test_band_copy_bounds_agree(density):
    """The probe tool's bounds for a flat call are chip_smoke.py's: bytes
    (band_bytes) and whole 32-byte sectors (band_sector_bytes), the
    sectors counted once each however many written elements they hold."""
    import chip_smoke

    from swarmkit_tpu_torch.tools import band_copy_probe

    rng = np.random.default_rng(int(density * 1000))
    write = torch.from_numpy(rng.random((96, 32)) < density)
    ring = torch.zeros((96, 32), dtype=torch.int32)
    exact, whole = band_copy_probe._bounds_ms(write)
    rate = chip_smoke.HBM_BYTES_PER_S
    assert exact == chip_smoke.band_bytes(write) / rate * 1e3
    sector_bytes = chip_smoke.band_sector_bytes(torch, ring, 0, write)
    assert whole == sector_bytes / rate * 1e3
    sectors = write.view(-1, 8).any(1).sum().item()
    assert sector_bytes == write.numel() + 4 * 32 * sectors
