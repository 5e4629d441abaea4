"""The port on the CUDA card: the sm_90a kernel and the tick against the CPU.

Every test here is marked `cuda` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

All values compared are integers, so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
