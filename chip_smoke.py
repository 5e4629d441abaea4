#!/usr/bin/env python3
"""Drive the PyTorch port (swarmkit_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: the card's name and power limit (nvidia-smi), then a parallel
   nvcc build of every CUDA source under swarmkit_tpu_torch/csrc/, timed.
2. kernel vs plain: append_band_copy against its plain PyTorch version on
   [4096, 1024] chunks of [4096, 8192] rings at several offsets and mask
   densities, plus an unaligned chunk (the scalar path); exact equality.
3. card vs CPU: the port's run at n=256 (L=8192, log_chunk=1024, the
   headline chunk width) on the card and on the CPU, through an election
   and 128 ticks with 5% drops and leader crashes; every SimState field
   and every trace row equal, and the kernel launched.
4. the main path at full width: the bench headline (n=4096, L=8192,
   window/apply/props 2048, keep 500, election_tick 24, static members,
   tiled log, dense peers and progress): chunked election, then 2 x 64
   ticks of run_ticks(prop_count=2048).  Prints election ticks/seconds,
   ms/tick, committed entries/s, kernel launches, full-pass fallback
   ticks and peak device memory; checks exactly one leader, a commit
   advance and checksum agreement (equal applied -> equal apply_chk).
5. the kernel on the main path's own inputs: the band-copy calls of one
   more headline tick are recorded, then kernel, plain version and
   torch.where (a yardstick the port never calls) are timed on them
   (device time, replayed from a CUDA graph; the eager per-call time is
   printed beside it) against the bytes bound at 3.35 TB/s.

Before the last line it prints the kernels' JSON record and the card's
`nvidia-smi` name/power line; the last line is the result JSON.  Without a
CUDA card, or run from a directory that holds nothing else of the repo,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
HEADLINE = dict(n=4096, log_len=8192, window=2048, apply_batch=2048,
                max_props=2048, keep=500, election_tick=24, seed=0,
                static_members=True, collect_stats=True, peer_chunk=0,
                active_rows=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def eager_ms(torch, fn, reps: int = 30) -> float:
    """Mean time of fn() in ms over `reps` back-to-back eager calls, CUDA
    events around them: for a small kernel this is the host's launch
    cost, as the main path pays it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() in ms: `reps` calls captured in one CUDA
    graph and replayed, so no host launch gap sits between them."""
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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def band_bytes(write) -> int:
    """Bytes the masked in-place write-back must move: the mask once, and
    for each written element its two int32 sources read and its two int32
    ring slots written."""
    return write.numel() + int(write.sum()) * 16


def phase_kernel_vs_plain(torch, cuda_ops) -> int:
    """Exact equality of kernel and plain version; returns max |diff|."""
    g = torch.Generator(device="cuda").manual_seed(1)
    n, ring = 4096, 8192
    worst = 0
    cases = [(0, 1024, 0.0), (1024, 1024, 0.3), (3072, 1024, 1.0),
             (7168, 1024, 0.5), (4100, 1020, 0.5)]
    for off, c, density in cases:
        lt = torch.randint(-2**31, 2**31, (n, ring), dtype=torch.int32,
                           device="cuda", generator=g)
        ld = torch.randint(-2**31, 2**31, (n, ring), dtype=torch.int32,
                           device="cuda", generator=g)
        st = torch.randint(-2**31, 2**31, (n, c), dtype=torch.int32,
                           device="cuda", generator=g)
        sd = torch.randint(-2**31, 2**31, (n, c), dtype=torch.int32,
                           device="cuda", generator=g)
        w = torch.rand((n, c), device="cuda", generator=g) < density
        want_t, want_d = lt.clone(), ld.clone()
        cuda_ops.append_band_copy_plain(want_t, want_d, off, st, sd, w)
        cuda_ops.append_band_copy(lt, ld, off, st, sd, w)
        torch.cuda.synchronize()
        diff = max(int((lt.long() - want_t.long()).abs().max()),
                   int((ld.long() - want_d.long()).abs().max()))
        log(f"  off={off} width={c} density={density}: max|diff|={diff}")
        check(diff == 0, f"kernel != plain at off={off} width={c}")
        worst = max(worst, diff)
    return worst


def phase_card_vs_cpu(torch, sim, cuda_ops, card: str = "cuda") -> None:
    cfg = sim.SimConfig(**{**HEADLINE, "n": 256})
    kw = dict(prop_count=cfg.max_props, drop_rate=0.05, crash_every=40,
              down_for=8)
    results = {}
    for dev in (card, "cpu"):
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        st, ticks = sim.run_until_leader(sim.init_state(cfg, device=dev),
                                         cfg, max_ticks=500, device=dev)
        check(bool(sim.has_leader(st)), f"n=256 on {dev}: no leader")
        st, trace = sim.run_ticks(st, cfg, 128, device=dev, **kw)
        if dev == card:
            torch.cuda.synchronize()
            launches = cuda_ops.LAUNCHES["append_band_copy"]
        log(f"  {dev}: election {ticks} ticks, then 128 ticks, "
            f"{time.perf_counter() - t0:.2f} s")
        results[dev] = (ticks, trace.cpu(), sim.state_to_numpy(st))
    (tg, trg, sg), (tc, trc, sc) = results[card], results["cpu"]
    check(tg == tc, f"election ticks differ: card {tg}, cpu {tc}")
    check(torch.equal(trg, trc), "run_ticks trace rows differ")
    check(sorted(sg) == sorted(sc), "state field sets differ")
    for name in sg:
        check((sg[name] == sc[name]).all(), f"field {name} differs")
    check(int(trc[:, 1].max()) > 0, "nothing committed at n=256")
    log(f"  all {len(sg)} fields and {len(trc)} trace rows equal; "
        f"kernel launches on the card: {launches}")
    check(launches > 0, "the card run never launched append_band_copy")


def phase_headline(torch, sim, cuda_ops) -> dict:
    cfg = sim.SimConfig(**HEADLINE)
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ticks = sim.init_state(cfg), 0
    while ticks < 2000 and not bool(sim.has_leader(st)):
        st, t = sim.run_until_leader(st, cfg, max_ticks=256)
        ticks += t
    torch.cuda.synchronize()
    t_elect = time.perf_counter() - t0
    check(bool(sim.has_leader(st)), "n=4096: no leader within 2000 ticks")
    log(f"  election: {ticks} ticks, {t_elect:.3f} s")
    base = int(sim.committed_entries(st))
    chunk_ms = []
    t_run = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        st, trace = sim.run_ticks(st, cfg, 64, prop_count=cfg.max_props)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t_run += dt
        chunk_ms.append(dt / 64 * 1e3)
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    # a banded tick launches the kernel once per band chunk, a full-pass
    # tick once over the whole ring: that splits the ticks
    n_ticks, bc = ticks + 128, cfg.band_chunks
    fallback, rem = divmod(bc * n_ticks - launches, bc - 1)
    check(rem == 0 and 0 <= fallback <= n_ticks,
          f"{launches} launches in {n_ticks} ticks is not a mix of banded "
          f"({bc} launches) and full-pass (1 launch) ticks")
    committed = int(sim.committed_entries(st)) - base
    n_leaders = int(sim.leader_mask(st).sum())
    applied, chk = (x.cpu().tolist() for x in sim.quorum_applied_checksum(st))
    seen = {}
    agree = all(seen.setdefault(a, c) == c for a, c in zip(applied, chk))
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(election_ticks=ticks, election_s=t_elect,
               ms_per_tick=chunk_ms, entries_per_s=committed / t_run,
               committed=committed, launches=launches,
               launches_per_tick=launches / n_ticks,
               fallback_ticks=fallback, peak_gib=peak)
    log(f"  run_ticks 2x64: ms/tick {chunk_ms[0]:.3f} / {chunk_ms[1]:.3f}, "
        f"committed {committed} entries, {committed / t_run:.1f} entries/s")
    log(f"  append_band_copy launches {launches} over {n_ticks} ticks; "
        f"full-pass fallback ticks {fallback}; peak device memory "
        f"{peak:.3f} GiB")
    check(n_leaders == 1, f"expected exactly one leader, got {n_leaders}")
    check(committed > 0, "commit did not advance")
    check(agree, "rows with equal applied disagree on apply_chk")
    check(launches > 0, "the main path never launched append_band_copy")
    out["state"] = st
    return out


def phase_main_path_inputs(torch, sim, cuda_ops, st) -> dict:
    """Time the kernel on the inputs one more headline tick gives it."""
    cfg = sim.SimConfig(**HEADLINE)
    calls = []
    launch = cuda_ops.append_band_copy

    def record(lt, ld, off, s_t, s_d, w):
        calls.append((lt.clone(), ld.clone(), off, s_t.clone(), s_d.clone(),
                      w.clone()))
        launch(lt, ld, off, s_t, s_d, w)

    cuda_ops.append_band_copy = record
    try:
        sim.run_ticks(st, cfg, 1, prop_count=cfg.max_props)
    finally:
        cuda_ops.append_band_copy = launch
    torch.cuda.synchronize()
    check(len(calls) > 0, "the timing tick made no band-copy call")
    err = 0
    times = {"kernel": [], "plain": [], "library": []}
    bound = []
    for lt, ld, off, s_t, s_d, w in calls:
        c = w.shape[1]
        kt, kd = lt.clone(), ld.clone()
        pt, pd = lt.clone(), ld.clone()
        launch(kt, kd, off, s_t, s_d, w)
        cuda_ops.append_band_copy_plain(pt, pd, off, s_t, s_d, w)
        torch.cuda.synchronize()
        err = max(err, int((kt.long() - pt.long()).abs().max()),
                  int((kd.long() - pd.long()).abs().max()))
        ct, cd = lt[:, off:off + c], ld[:, off:off + c]

        def run_kernel():
            launch(kt, kd, off, s_t, s_d, w)

        def run_plain():
            cuda_ops.append_band_copy_plain(pt, pd, off, s_t, s_d, w)

        def run_library():
            torch.where(w, s_t, ct)
            torch.where(w, s_d, cd)

        # device times from graph replay, in turns (plain, kernel, kernel,
        # plain) so drift hits both alike
        p1, k1 = graph_ms(torch, run_plain), graph_ms(torch, run_kernel)
        k2, p2 = graph_ms(torch, run_kernel), graph_ms(torch, run_plain)
        times["kernel"].append((k1 + k2) / 2)
        times["plain"].append((p1 + p2) / 2)
        times["library"].append(graph_ms(torch, run_library))
        bound.append(band_bytes(w) / HBM_BYTES_PER_S * 1e3)
        log(f"  chunk off={off} width={c} written={int(w.sum())}: device "
            f"kernel {times['kernel'][-1]:.4f} ms, plain "
            f"{times['plain'][-1]:.4f} ms, torch.where x2 "
            f"{times['library'][-1]:.4f} ms, bound {bound[-1]:.4f} ms; "
            f"eager call: kernel {eager_ms(torch, run_kernel):.4f} ms, "
            f"plain {eager_ms(torch, run_plain):.4f} ms")
    check(err == 0, f"kernel != plain on the main path's inputs ({err})")
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(calls=len(calls), err=err, ms=mean(times["kernel"]),
                plain_ms=mean(times["plain"]),
                library_ms=mean(times["library"]), bound_ms=mean(bound))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from swarmkit_tpu_torch import _build
        from swarmkit_tpu_torch.parallel import cuda_ops
        from swarmkit_tpu_torch.raft import sim
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    log("phase 1: card and build")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"  nvcc built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")

    log("phase 2: append_band_copy kernel vs plain")
    err2 = phase_kernel_vs_plain(torch, cuda_ops)

    log("phase 3: the port on the card vs on the CPU (n=256)")
    phase_card_vs_cpu(torch, sim, cuda_ops)

    log("phase 4: the main path at full width (n=4096)")
    head = phase_headline(torch, sim, cuda_ops)

    log("phase 5: append_band_copy on the main path's inputs")
    k = phase_main_path_inputs(torch, sim, cuda_ops, head.pop("state"))

    log("summary " + json.dumps({"card": card, **head,
                                 "band_copy_calls_per_tick": k["calls"]}))
    print(json.dumps({"kernels": [{
        "name": "append_band_copy", "route": "cuda",
        "source": "swarmkit_tpu_torch/csrc/band_copy.cu",
        "replaces": "swarmkit_tpu/parallel/pallas_ops.py:174",
        "launches": head["launches"], "max_abs_err": max(err2, k["err"]),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
