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
4 pipelined appends per edge, with its own safety line), the log-capacity
tripwire (4096-longlog-L65536), the read mix (256-readmix-99to1: 99 reads
offered per committed entry, whose served reads/s is bench.py's second
headline), the durability A/B (256-fsyncgate: bare, then the storage
model with fsync every 4 ticks and ack gating, on a ring and window deep
enough for the fsync pipeline) and the two lowering A/B pairs
(1024-densepeer: banded vs dense peer counts; 4096-sparseprog: slab vs
dense progress), seed 7, at the headline's entry count.  Prints the card's
`nvidia-smi` name and power limit, then one JSON line with bench.py's keys.
KernelObs and the telemetry probe are not ported: the line lists them
under "absent".

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
    leader_mask, reads_blocked, reads_served, run_ticks, run_until_leader,
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
            log_len: int = 8192, window: int = 2048, read_batch: int = 0,
            read_leases: bool = True, fsync_lag_ticks: int = 0,
            ack_gating: bool = False, **run_kw) -> dict:
    """bench.py::measure on the port: elect, warm, re-elect, then time the
    chunked replication of ~`entries` committed entries.  latency,
    latency_jitter and inflight pick the wire, read_batch/read_leases the
    read path (reads served in the timed pass are counted), and
    fsync_lag_ticks/ack_gating the storage model, as in bench.py."""
    levers = {k: v for k, v in (("peer_chunk", peer_chunk),
                                ("active_rows", active_rows))
              if v is not None}
    if fsync_lag_ticks:
        levers.update(fsync_lag_ticks=fsync_lag_ticks, ack_gating=ack_gating)
    cfg = SimConfig(n=n, log_len=log_len, window=window, apply_batch=2048,
                    max_props=2048, keep=500, seed=seed,
                    election_tick=election_tick, latency=latency,
                    latency_jitter=latency_jitter, inflight=inflight,
                    static_members=True, collect_stats=True,
                    read_batch=read_batch, read_leases=read_leases, **levers)
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
    base_reads = int(reads_served(state))
    kernel.reset_counts()
    t0 = time.perf_counter()
    final = run_chunks(state)
    dt = time.perf_counter() - t0
    counts = dict(kernel.COUNTS)
    committed = int(committed_entries(final)) - base
    out = {"cfg": cfg, "final": final, "committed": committed, "dt": dt,
           "rate": committed / dt, "election_ticks": ticks,
           "t_elect": t_elect, "t_elect_post": t_elect_post,
           "t_warm": t_warm, "timed_ticks": n_chunks * chunk,
           "counts": counts}
    if read_batch:
        out["reads"] = int(reads_served(final)) - base_reads
        out["read_rate"] = out["reads"] / dt
        out["reads_blocked"] = int(reads_blocked(final))
    return out


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


def readmix(n: int, entries: int, dev, chunk: int = 64) -> dict:
    """bench.py's 256-readmix-99to1 at n rows: 99 reads offered per
    committed entry (99 * max_props / n per row per refill).  Returns the
    entries/s and bench.py's top-level read keys."""
    m = measure(n, entries, 7, election_tick_for(n), dev, chunk=chunk,
                read_batch=99 * 2048 // n)
    keys = {"read_metric": f"linearizable-reads/sec @ {n} simulated "
                           f"managers (99:1 offered read:write mix)",
            "reads_per_second": m["read_rate"],
            "read_write_ratio": m["read_rate"] / m["rate"],
            "reads_blocked": m["reads_blocked"]}
    if m["read_rate"] < 10 * m["rate"]:
        keys["note"] = (f"read-mix underperformed: {m['read_rate']:,.0f} "
                        f"reads/s < 10x {m['rate']:,.0f} entries/s")
    return {"rate": m["rate"], "keys": keys,
            "leaders": int(leader_mask(m["final"]).sum()),
            "linearizable": bool((m["final"].read_srv_idx
                                  >= m["final"].read_srv_goal).all())}


def fsyncgate(n: int, entries: int, dev, chunk: int = 64) -> dict:
    """bench.py's 256-fsyncgate A/B at n rows: the same shape bare and with
    the storage model (fsync every k=4 ticks, ack gating), both with a ring
    and an append window deep enough for k rounds of in-flight entries."""
    k = 4
    depth = dict(log_len=32768, window=(k + 1) * 2048 + 512)
    dm = measure(n, entries, 7, election_tick_for(n), dev, chunk=chunk,
                 **depth)
    gm = measure(n, entries, 7, election_tick_for(n), dev, chunk=chunk,
                 fsync_lag_ticks=k, ack_gating=True, **depth)
    g = gm["final"]
    return {"dense": dm["rate"], f"gated_k{k}": gm["rate"],
            "gated_over_dense": gm["rate"] / dm["rate"],
            "durable": int(g.ack_frontier.max()) <= int(g.last.max())
            and bool((g.sync_mark >= g.snap_idx).all())}


def _secondary(args, dev, log, result: dict) -> dict:
    """BASELINE configs 3-5, the mailbox wire, the log-capacity, read-mix
    and durability configs, and the two lowering A/B pairs; the read mix's
    keys go into `result`, as bench.py puts them."""
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
    # log capacity: with the tiled log an 8x ring should land near the
    # L=8192 headline's rate
    extra["4096-longlog-L65536"] = run(4096, log_len=65536)
    log(f"config 4096-longlog-L65536: {extra['4096-longlog-L65536']:,.1f} "
        f"entries/s")
    rm = readmix(256, args.entries, dev, args.chunk_ticks)
    extra["256-readmix-99to1"] = rm["rate"]
    note = rm["keys"].pop("note", None)
    result.update(rm["keys"])
    if note:
        result.setdefault("note", note)
    if rm["leaders"] != 1 or not rm["linearizable"]:
        result.setdefault("error", "256-readmix-99to1: not exactly one "
                                   "leader or a non-linearizable read")
    log(f"config 256-readmix-99to1: {rm['rate']:,.1f} entries/s, "
        f"{rm['keys']}")
    fg = fsyncgate(256, args.entries, dev, args.chunk_ticks)
    if not fg.pop("durable"):
        fg["error"] = "durability check failed"
    extra["256-fsyncgate"] = fg
    if fg["gated_over_dense"] < 0.8:
        result.setdefault("note", f"storage tripwire: gated rate "
                                  f"{fg['gated_k4']:,.0f} < 0.8x bare "
                                  f"{fg['dense']:,.0f} at 256-fsyncgate")
    pc = max(64, 1024 // 4)          # bench.py's band width at n=1024
    dense, banded = run(1024, peer_chunk=0), run(1024, peer_chunk=pc)
    extra["1024-densepeer"] = {"dense": dense, f"banded_pc{pc}": banded,
                               "banded_over_dense": banded / dense}
    ar = 16
    dense, sparse = run(4096, active_rows=0), run(4096, active_rows=ar)
    extra["4096-sparseprog"] = {"dense": dense, f"sparse_a{ar}": sparse,
                                "sparse_over_dense": sparse / dense}
    for name in ("256-fsyncgate", "1024-densepeer", "4096-sparseprog"):
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
        if args.no_configs else _secondary(args, dev, log, result)
    if not args.no_configs and any(
            isinstance(v, dict) and "error" in v
            for v in result["configs_entries_per_s"].values()):
        result.setdefault("error", "a secondary configuration failed its "
                                   "safety check")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(1 if "error" in main() else 0)
