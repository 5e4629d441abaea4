"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Runs from the checkout's root on a machine with a CUDA card.  The cell
(`BENCHMARK.json`'s `workloads`) names a configuration and a traffic mix,
found by name under this folder (cells.py).  Set-up builds the cluster of
`swarmkit_tpu_torch` on the card with the run's seed, elects a leader and
warms every path the window takes; the window then drives the mix for
`--seconds` (drive.py).  With `--trace 0` the last line reports the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from the window's counts and failovers and from a profiled unit of the
mix run after the window has closed (trace.py, metrics/<name>.py), and
a breakdown.  Either way the program's final state is held to the plain
reference (reference.py) and the line says whether it was `correct`, with
every number compared and its limit last.

It exits 2 without printing a result when there is no card, fewer cards
than the cell asks for, or the process has loaded JAX or the JAX package.
`--control` runs the reference's control (a guarantee broken) in the
program's place after the window: its result must read not correct.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernel and build caches, at fixed paths inside the checkout (the
# program builds csrc/ into build/kernels/ of the checkout itself; it
# launches no Triton kernel)
CACHE = ROOT / "build" / "bench-cache"
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}
# top-level module names that no run may load, compared whole (the port's
# own name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "swarmkit_tpu")
MASK = 0xFFFF_FFFF


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def outputs(st, rec, seed: int, reads: dict | None):
    """The program's final state as the judge reads it (host arrays)."""
    import numpy as np
    import torch

    from benchmark import reference
    from benchmark.drive import rows_field
    from swarmkit_tpu_torch import parallel

    cpu = torch.device("cpu")

    def ints(name):
        return rows_field(st, name, cpu).to(torch.int64).numpy()

    def bits(name):
        return (rows_field(st, name, cpu).to(torch.int64) & MASK).numpy()

    role = ints("role")
    rows = np.union1d(reference.sample_rows(rec.n, seed),
                      np.flatnonzero(role == reference.LEADER))

    def ring(name):
        if not parallel.row_sharded(st):
            t = getattr(st, name)
            sel = torch.as_tensor(rows, device=t.device)
            return t.index_select(0, sel).to(cpu, torch.int64)
        nr = st.shards[0].term.shape[0]
        return torch.stack([getattr(st.shards[r // nr], name)[r % nr]
                            .to(cpu, torch.int64) for r in rows.tolist()])

    if reads is not None:
        reads = dict(reads, srv_idx=ints("read_srv_idx"),
                     srv_goal=ints("read_srv_goal"))
    return reference.Outputs(
        role=role, term=ints("term"), last=ints("last"),
        commit=ints("commit"), applied=ints("applied"),
        snap_idx=ints("snap_idx"), apply_chk=bits("apply_chk"),
        snap_chk=bits("snap_chk"), rows=rows,
        ring_term=ring("log_term").numpy(),
        ring_data=(ring("log_data") & MASK).numpy(), reads=reads)


def end_to_end(name: str, win: dict, setup_s: float):
    """The value of end-to-end metric `name` from the window's readings
    (None where the window has nothing to read).  A name split by a dot
    (``entries_per_s.device_paced``: the same quantity under a bound of
    its own in the cells it lists) reads as the part before the dot."""
    fo = [s for s, _ in win["failovers"]]
    values = {
        "setup_s": setup_s,
        "entries_per_s": win["committed"] / win["seconds"],
        "reads_per_s": win["reads"] / win["seconds"],
        "failover_s": sum(fo) / len(fo) if fo else None,
    }
    return values.get(name.split(".")[0])


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, control: bool = False, run=None) -> dict:
    """Set-up, window and check of one cell on `dev`; `run` replaces the
    port's raft.sim run loops (the tests break them underneath)."""
    import torch

    from benchmark import drive, reference
    from benchmark import trace as tracing
    from swarmkit_tpu_torch.parallel import cuda_ops
    from swarmkit_tpu_torch.raft import sim
    from swarmkit_tpu_torch.raft.sim import kernel

    cfg = drive.sim_config(cell, seed)
    driver = drive.Driver(cfg, cell.traffic, dev, run=run or sim)
    cards = [d for d in dict.fromkeys(driver.devices) if d.type == "cuda"]
    if cards:
        # the memory statistics need each card's context
        torch.cuda.set_device(dev)
        torch.cuda.init()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    stages = {"imports": time.perf_counter() - t_start}
    driver.elect()
    stages["election"] = time.perf_counter() - t_start
    driver.warm_up()
    setup_s = time.perf_counter() - t_start
    stages["warm_up"] = setup_s

    counts0 = dict(kernel.COUNTS)
    win = driver.window(seconds)
    counts = {k: v - counts0.get(k, 0) for k, v in kernel.COUNTS.items()}
    profiler = None
    if trace:
        # after the window, so that none of its readings runs in the
        # profiler's wake
        profiler = tracing.Profiler(driver, kernel, cuda_ops)
        profiler.run()
    # the fullest card's peak
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    banned = banned_modules()

    rec = driver.record
    reads = {"served": win["reads"], "blocked": win["blocked"]} \
        if cfg.read_batch else None
    t_check = time.perf_counter()
    out = outputs(driver.st, rec, seed, reads)
    driver.st = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log = reference.expected_log(rec)
    if control:
        out = reference.control_outputs(log, rec, cfg.max_props, seed,
                                        out.reads)
    checks = reference.judge(out, log, rec, cfg.max_props, win["ticks"],
                             **cell.traffic.get("judge", {}))
    stages["check (after the window)"] = time.perf_counter() - t_check
    # the window's elections each commit one empty entry
    end = win["tick0"] + win["ticks"]
    elections = sum(1 for e in rec.events
                    if e[0] == "elect" and win["tick0"] <= e[1] < end)
    return {"cfg": cfg, "window": win, "setup_s": setup_s, "peak": peak,
            "stages": stages,
            "banned": banned, "checks": checks,
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": win["offered"],
            "failed": max(0, win["offered"] - (win["committed"]
                                               - elections)),
            "counts": counts, "profiler": profiler}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference's control in the program's "
                         "place (it must read not correct)")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)
    from benchmark import cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)
    from benchmark import trace as tracing

    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   _T0, control=args.control)
    if res["banned"]:
        print(f"run.py: the process loaded {', '.join(res['banned'])}",
              file=sys.stderr)
        return 2
    win = res["window"]
    kind = torch.cuda.get_device_name(dev)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": res["peak"]}
    print("stages (s; set-up ones since the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stages"].items()), file=sys.stderr)
    if win["failovers"]:
        print("failovers (s, ticks): " + ", ".join(
            f"{s:.3f} {t}" for s, t in win["failovers"]), file=sys.stderr)
    ms = sorted(win["tick_ms"])
    if ms:
        print(f"host ms a tick of the window's {len(ms)} steady calls: "
              f"min {ms[0]:.3f}, median {ms[len(ms) // 2]:.3f}, max "
              f"{ms[-1]:.3f}", file=sys.stderr)
    print(f"peak device memory {res['peak']} bytes; window "
          f"{win['seconds']:.3f} s, {win['ticks']} ticks, "
          f"{win['committed']} entries committed", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"]}
    metrics = {}
    if args.trace:
        peaks = cells.load_json(ROOT / "benchmark" / "peaks.json")
        ctx = tracing.context(win, res["counts"], res["profiler"], kind,
                              peaks["cards"].get(kind))
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        sl = ctx["slice"]
        device["busy_s"] = tracing.busy_s(sl)
        device["window_s"] = sl["wall_s"]
        line["breakdown"] = tracing.breakdown(sl)
        bc = sl["calls"].get("append_band_copy", [])
        print(f"profiled slice: {sl['ticks']} ticks, {sl['wall_s']:.4f} s "
              f"wall, twin {sl['twin_ticks']} ticks {sl['twin_wall_s']:.4f}"
              f" s; {len(sl['kernels'])} kernels; append_band_copy "
              f"{len(bc)} calls, its kernels "
              f"{sorted({k[0][:40] for k in sl['kernels'] if 'band' in k[0]})}",
              file=sys.stderr)
    else:
        for m in cell.end_to_end:
            v = end_to_end(m["name"], win, res["setup_s"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v} <= {lim}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
