"""The bench headline on the port: bench.py::measure's flow on the CUDA card.

    python -m swarmkit_tpu_torch.tools.bench [--n 4096] [--entries 1000000]
        [--seed 42] [--no-configs] [--chunk-ticks 64] [--device cuda]

Per configuration, as `measure()` in the repo's bench.py: a chunked
election (run_until_leader in chunks of 256 ticks, at most 2000 ticks), a
warm pass of the timed run (from a copy of the elected state; torch has no
compile step, so it warms the caches and the kernels' first load), a
second election from a fresh state (post-warm-up election seconds), then
the timed pass: 64-tick run_ticks(prop_count=max_props) chunks, each ended
by a synchronize, until the entries are committed.  The levers are the
SimConfig defaults (banded peer counts, role-sparse progress, tiled log)
unless a configuration pins them.

After the headline (n=4096, 1M entries, seed 42) come BASELINE.json's
configs 3-5 (64-steady, 1024-crash-every-100, 4096-drop-5pct), the
mailbox wire (1024-mailbox-lat2-jitter1-inflight4: latency 2, jitter 1,
4 pipelined appends per edge, with its own safety line) and the two
lowering A/B pairs (1024-densepeer: banded vs dense peer counts;
4096-sparseprog: slab vs dense progress), seed 7, at the headline's entry
count.  Prints the card's `nvidia-smi` name and power limit, then one JSON
line with bench.py's keys.  KernelObs and the telemetry probe are not
ported: the line lists them under "absent".

It needs a card and raises without one, unless --device cpu is given
(the CPU runs exist for the tests: their numbers are CPU numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.raft.sim import kernel
from swarmkit_tpu_torch.raft.sim import (
    SimConfig, SimState, committed_entries, has_leader, init_state,
    leader_mask, run_ticks, run_until_leader,
)

BASELINE_RATE = 1_000_000 / 60.0   # the north star: 1M entries in 60 s
ELECT_CHUNK, MAX_ELECT_TICKS = 256, 2000
ABSENT = ["kernel_stats (no KernelObs in the port yet)",
          "commit_latency_ticks_p50/p99 (no telemetry probe in the port "
          "yet)"]


class MeasureError(Exception):
    pass


def election_tick_for(n: int) -> int:
    """bench.py's election timeout for n rows: timeouts lie in [T, 2T), and
    with thousands of rows a 10-tick window makes candidates collide, so T
    widens with log2(n)."""
    return max(10, round(2 * math.log2(max(n, 2))))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _clone(st: SimState) -> SimState:
    """A copy that a run may consume (step writes rings in place)."""
    return SimState(**{f.name: None if getattr(st, f.name) is None
                       else getattr(st, f.name).clone()
                       for f in dataclasses.fields(SimState)})


def measure(n: int, entries: int, seed: int, election_tick: int, dev,
            chunk: int = 64, peer_chunk: int | None = None,
            active_rows: int | None = None, latency: int = 0,
            latency_jitter: int = 0, inflight: int = 1,
            **run_kw) -> dict:
    """bench.py::measure on the port: elect, warm, re-elect, then time the
    chunked replication of ~`entries` committed entries.  latency,
    latency_jitter and inflight pick the wire, as in bench.py."""
    levers = {k: v for k, v in (("peer_chunk", peer_chunk),
                                ("active_rows", active_rows))
              if v is not None}
    cfg = SimConfig(n=n, log_len=8192, window=2048, apply_batch=2048,
                    max_props=2048, keep=500, seed=seed,
                    election_tick=election_tick, latency=latency,
                    latency_jitter=latency_jitter, inflight=inflight,
                    static_members=True, collect_stats=True, **levers)
    ticks_needed = max(1, -(-entries // cfg.max_props))
    n_chunks = -(-ticks_needed // chunk)

    def run_chunks(st):
        for _ in range(n_chunks):
            st, _ = run_ticks(st, cfg, chunk, prop_count=cfg.max_props,
                              device=dev, **run_kw)
            _sync(dev)
        return st

    def elect():
        st = init_state(cfg, device=dev)
        t0 = time.perf_counter()
        ticks = 0
        while ticks < MAX_ELECT_TICKS:
            st, t = run_until_leader(st, cfg, max_ticks=ELECT_CHUNK,
                                     device=dev)
            _sync(dev)
            ticks += t
            if bool(has_leader(st)):
                break
        if not bool(has_leader(st)):
            raise MeasureError(f"no leader elected within {MAX_ELECT_TICKS} "
                               f"ticks (n={n}, T={election_tick})")
        return st, ticks, time.perf_counter() - t0

    state, ticks, t_elect = elect()
    t0 = time.perf_counter()
    run_chunks(_clone(state))
    t_warm = time.perf_counter() - t0
    _, _, t_elect_post = elect()

    base = int(committed_entries(state))
    kernel.reset_counts()
    t0 = time.perf_counter()
    final = run_chunks(state)
    dt = time.perf_counter() - t0
    counts = dict(kernel.COUNTS)
    committed = int(committed_entries(final)) - base
    return {"cfg": cfg, "final": final, "committed": committed, "dt": dt,
            "rate": committed / dt, "election_ticks": ticks,
            "t_elect": t_elect, "t_elect_post": t_elect_post,
            "t_warm": t_warm, "timed_ticks": n_chunks * chunk,
            "counts": counts}


def _safety(m: dict) -> tuple[bool, int]:
    """(equal applied => equal checksum on every pair of rows, rows whose
    commit is within one proposal batch of the tip)."""
    final, cfg = m["final"], m["cfg"]
    commit = final.commit.cpu()
    seen: dict = {}
    ok = all(seen.setdefault(a, c) == c for a, c in
             zip(final.applied.tolist(), final.apply_chk.tolist()))
    return ok, int((commit >= commit.max() - cfg.max_props).sum())


def _card_line(dev) -> str | None:
    if dev.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _secondary(args, dev, log) -> dict:
    """BASELINE configs 3-5 and the two lowering A/B pairs."""
    extra: dict = {}

    def measured(cn: int, **kw) -> dict:
        return measure(cn, args.entries, 7, election_tick_for(cn), dev,
                       chunk=args.chunk_ticks, **kw)

    def run(cn: int, **kw) -> float:
        return measured(cn, **kw)["rate"]

    for name, cn, kw in (("64-steady", 64, {}),
                         ("1024-crash-every-100", 1024,
                          {"crash_every": 100, "down_for": 5}),
                         ("4096-drop-5pct", 4096, {"drop_rate": 0.05})):
        extra[name] = run(cn, **kw)
        log(f"config {name}: {extra[name]:,.1f} entries/s")
    # the device-mailbox wire: per-edge latency 2 + jitter 1 with a 4-deep
    # pipelined append window (vendor MaxInflightMsgs), under bench.py's
    # own safety checks
    name = "1024-mailbox-lat2-jitter1-inflight4"
    m = measured(1024, latency=2, latency_jitter=1, inflight=4)
    safety_ok, near_tip = _safety(m)
    n_leaders = int(leader_mask(m["final"]).sum())
    extra[name] = m["rate"]
    extra[name + "_detail"] = {
        "election_ticks": m["election_ticks"],
        "election_s_post_compile": m["t_elect_post"],
        "ms_per_tick": m["dt"] / m["timed_ticks"] * 1e3,
        "host_syncs_per_tick": m["counts"]["host_syncs"] / m["timed_ticks"],
        "leaders": n_leaders, "safety_ok": safety_ok,
        "replicas_near_tip": near_tip}
    if not safety_ok or n_leaders != 1 or near_tip < 1024 // 2 + 1:
        extra[name + "_detail"]["error"] = "safety check failed"
    log(f"config {name}: {m['rate']:,.1f} entries/s; "
        f"{extra[name + '_detail']}")
    del m
    pc = max(64, 1024 // 4)          # bench.py's band width at n=1024
    dense, banded = run(1024, peer_chunk=0), run(1024, peer_chunk=pc)
    extra["1024-densepeer"] = {"dense": dense, f"banded_pc{pc}": banded,
                               "banded_over_dense": banded / dense}
    ar = 16
    dense, sparse = run(4096, active_rows=0), run(4096, active_rows=ar)
    extra["4096-sparseprog"] = {"dense": dense, f"sparse_a{ar}": sparse,
                                "sparse_over_dense": sparse / dense}
    for name in ("1024-densepeer", "4096-sparseprog"):
        log(f"config {name}: {extra[name]}")
    return extra


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--entries", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--chunk-ticks", type=int, default=64)
    ap.add_argument("--no-configs", action="store_true",
                    help="the headline only")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    dev = resolve_device(args.device)
    card = _card_line(dev)
    if card is not None:
        print(card, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m = measure(args.n, args.entries, args.seed, election_tick_for(args.n),
                dev, chunk=args.chunk_ticks)
    safety_ok, near_tip = _safety(m)
    c = m["counts"]
    log(f"n={args.n}: election {m['election_ticks']} ticks in "
        f"{m['t_elect']:.3f} s (again after warm-up: "
        f"{m['t_elect_post']:.3f} s); committed {m['committed']} in "
        f"{m['dt']:.3f} s; {c}")
    result = {
        "metric": f"committed-log-entries/sec @ {args.n} simulated managers "
                  f"(election {m['election_ticks']} ticks in "
                  f"{m['t_elect']:.2f}s)",
        "value": m["rate"],
        "unit": "entries/s",
        "vs_baseline": m["rate"] / BASELINE_RATE,
        "election_ticks": m["election_ticks"],
        "election_s_incl_compile": m["t_elect"],
        "election_s_post_compile": m["t_elect_post"],
        "warm_pass_s": m["t_warm"],
        "ms_per_tick": m["dt"] / m["timed_ticks"] * 1e3,
        "host_syncs_per_tick": c["host_syncs"] / m["timed_ticks"],
        "slab_ticks": c["slab_ticks"],
        "dense_fallback_ticks": c["dense_fallback_ticks"],
        "safety_ok": safety_ok,
        "replicas_near_tip": near_tip,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"},
        "card": card,
        "absent": ABSENT,
    }
    if not safety_ok:
        result["error"] = "state-machine checksum divergence"
    elif near_tip < args.n // 2 + 1:
        result["error"] = f"only {near_tip}/{args.n} replicas near commit tip"
    del m
    result["configs_entries_per_s"] = "skipped (--no-configs)" \
        if args.no_configs else _secondary(args, dev, log)
    if not args.no_configs and any(
            isinstance(v, dict) and "error" in v
            for v in result["configs_entries_per_s"].values()):
        result.setdefault("error", "a secondary configuration failed its "
                                   "safety check")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(1 if "error" in main() else 0)
