"""Time band_copy.cu's kernel beside the variants its design was measured
against, and the parts of its memory traffic, on the card.

    python -m swarmkit_tpu_torch.tools.band_copy_probe

Builds tools/band_copy_probe.cu (which includes csrc/band_copy.cu) with
nvcc into build/probe/ at the checkout root and times whole-ring writes
(the flat and words paths' inputs).  First the model checker's n3h8 pass
(one 2^20-lane expand pass, as chip_smoke.py's phase 16 records it:
[3145728, 32] rings, 1.3% of the elements written, one in each written
row) and [3145728, 32] rings with no element and with every element
written: the kernel's flat and words paths forced, its first version
(band_copy_v1) and each probe of the .cu file (loop, lane16, paired,
mask, loads, stores).  Then the small rings of the batched tools
(SMALL_RINGS: fault_sweep, the differential sweep, the DST sweeps,
multiraft-1024x3), each row written with probability 0.5 in one run of
columns: flat, words and v1, which set cuda_ops.FLAT_TILES_MIN.  Device ms
from CUDA-graph replay in turns (forward, then backward), beside the
bytes bound and the bound at whole 32-byte sectors; every variant that
writes is held to the plain version first.  Prints one line a case and
variant, then one JSON line with the card's name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from swarmkit_tpu_torch import _build
from swarmkit_tpu_torch.parallel import cuda_ops

SOURCE = Path(__file__).resolve().parent / "band_copy_probe.cu"
LIBRARY = _build.BUILD_DIR.parent / "probe" / "libband_copy_probe.so"
PROBES = ("loop", "lane16", "paired", "mask", "loads", "stores")
WRITES = ("flat", "words", "v1", "loop", "lane16", "paired")   # = plain
# the batched tools' whole rings: fault_sweep's explore, the differential
# sweep's largest family, the DST sweep at S=256, a ring of 2^20 elements,
# multiraft-1024x3, the DST sweep at S=16384
SMALL_RINGS = ((40, 64), (128, 128), (1280, 64), (16384, 64), (3072, 512),
               (81920, 64))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
ROWS, RING = 3 * (1 << 20), 32


def _library() -> ctypes.CDLL:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(LIBRARY),
                    str(SOURCE)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(LIBRARY))
    lib.band_copy_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.band_copy_probe.restype = ctypes.c_int
    return lib


def n3h8_pass_call(dev: torch.device) -> tuple:
    """The band-copy call of one 2^20-lane expand pass of the n3h8 scope
    from a state 6 noop ticks past the root, each lane under action
    lane % A (chip_smoke.py's phase 16 pass): (term, data, src_term,
    src_data, write), cloned."""
    import importlib

    from swarmkit_tpu_torch import mc
    from swarmkit_tpu_torch.raft import sim

    frontier = importlib.import_module("swarmkit_tpu_torch.mc.frontier")
    scope = mc.SCOPES["n3h8"]
    cfg, alphabet = scope.cfg(), scope.alphabet()
    tables = alphabet.tables(dev)
    st = sim.broadcast_state(sim.init_state(cfg, device=dev), 1)
    noop = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(6):
        st, _, _ = frontier._expand(st, noop, tables, cfg, 1, None, False,
                                    dev)
    width = 1 << 20
    aids = torch.arange(width, device=dev) % alphabet.size
    chunk = frontier._take(st, torch.zeros((width,), dtype=torch.int64,
                                           device=dev))
    calls = []
    launch = cuda_ops.append_band_copy

    def record(lt, ld, off, s_t, s_d, w):
        calls.append((lt.clone(), ld.clone(), s_t.clone(), s_d.clone(),
                      w.clone()))
        launch(lt, ld, off, s_t, s_d, w)

    cuda_ops.append_band_copy = record
    try:
        frontier._expand(chunk, aids, tables, cfg, 1, None, False, dev)
    finally:
        cuda_ops.append_band_copy = launch
    torch.cuda.synchronize()
    (call,) = calls
    return call


def _graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device ms of fn(): `reps` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _bounds_ms(write: torch.Tensor) -> tuple[float, float]:
    """The bytes bound (chip_smoke.py's band_bytes) and the bound at whole
    32-byte sectors (band_sector_bytes) of a flat call, in ms."""
    written = write.view(-1).nonzero().view(-1)
    sectors = torch.unique_consecutive(written // 8).numel()
    exact = write.numel() + written.numel() * 16
    whole = write.numel() + 2 * 32 * (sectors + sectors)
    return exact / HBM_BYTES_PER_S * 1e3, whole / HBM_BYTES_PER_S * 1e3


def probe_case(lib, call: tuple, names) -> dict:
    """Each named variant on one whole-ring call: {variant: ms}, checked
    first."""
    term, data, src_t, src_d, write = call
    want_t, want_d = term.clone(), data.clone()
    cuda_ops.append_band_copy_plain(want_t, want_d, 0, src_t, src_d, write)
    stream = torch.cuda.current_stream
    n, ring = term.shape

    def launcher(name):
        t, d = term.clone(), data.clone()
        if name in cuda_ops.BAND_COPY_PATHS:   # the kernel, path forced
            return (t, d), lambda: cuda_ops._launch(
                "band_copy", t.device, t.data_ptr(), d.data_ptr(),
                src_t.data_ptr(), src_d.data_ptr(), write.data_ptr(), n,
                ring, 0, ring, cuda_ops.BAND_COPY_PATHS.index(name))
        if name == "v1":
            return (t, d), lambda: cuda_ops._band_copy_launch(
                t, d, 0, src_t, src_d, write, "v1")
        probe = PROBES.index(name)

        def run():
            rc = lib.band_copy_probe(
                probe, t.data_ptr(), d.data_ptr(), src_t.data_ptr(),
                src_d.data_ptr(), write.data_ptr(), write.numel(),
                stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe {name}: CUDA error {rc}")
        return (t, d), run

    runs = {}
    for name in names:
        (t, d), fn = launcher(name)
        fn()
        torch.cuda.synchronize()
        if name in WRITES and not (torch.equal(t, want_t)
                                   and torch.equal(d, want_d)):
            raise AssertionError(f"{name} != plain")
        runs[name] = fn
    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(_graph_ms(runs[name]))
    return {name: sum(ms) / len(ms) for name, ms in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("band_copy_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = _library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def ints(rows=ROWS, ring=RING):
        return torch.randint(-2**31, 2**31, (rows, ring), dtype=torch.int32,
                             device=dev, generator=g)
    every = ("flat", "words", "v1", *PROBES)
    cases = {"n3h8 pass": (n3h8_pass_call(dev), every)}
    for label, density in (("no element written", 0.0),
                           ("every element written", 1.0)):
        cases[label] = ((ints(), ints(), ints(), ints(),
                         torch.rand((ROWS, RING), device=dev, generator=g)
                         < density), every)
    for rows, ring in SMALL_RINGS:
        written = torch.rand(rows, device=dev, generator=g) < 0.5
        start = torch.randint(0, ring, (rows, 1), device=dev, generator=g)
        span = torch.randint(1, ring + 1, (rows, 1), device=dev, generator=g)
        col = torch.arange(ring, device=dev)
        write = written[:, None] & (col >= start) & (col < start + span)
        cases[f"[{rows}, {ring}]"] = ((ints(rows, ring), ints(rows, ring),
                                       ints(rows, ring), ints(rows, ring),
                                       write), ("flat", "words", "v1"))
    out = {"card": card, "cases": {}}
    for label, (call, names) in cases.items():
        bound, whole = _bounds_ms(call[4])
        ms = probe_case(lib, call, names)
        out["cases"][label] = dict(ms=ms, bound_ms=bound,
                                   sector_bound_ms=whole,
                                   written=int(call[4].sum()))
        print(f"{label} ({list(call[4].shape)}, {int(call[4].sum())} "
              f"written): "
              f"bound {bound:.4f} ms, whole sectors {whole:.4f} ms",
              flush=True)
        for name, t in ms.items():
            print(f"  {name:8s} {t:.4f} ms ({bound / t:.1%} of the bound)",
                  flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
