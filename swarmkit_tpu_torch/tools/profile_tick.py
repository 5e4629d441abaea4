"""Where a headline tick's time goes on the CUDA card.

    python -m swarmkit_tpu_torch.tools.profile_tick [--n N] [--ticks 16]
        [--dense] [--config headline|mailbox|readmix|rung] [--log-len L]
        [--planes] [--entries D]

Elects a leader at the bench headline configuration (n=4096 unless --n
says otherwise; banded peer counts and role-sparse progress at their
SimConfig defaults, as bench.py runs them, or both pinned dense with
--dense), with --config mailbox at bench.py's
1024-mailbox-lat2-jitter1-inflight4 (n=1024, seed 7, election_tick 20,
latency 2, jitter 1, inflight 4), or with --config readmix at bench.py's
256-readmix-99to1 (n=256, seed 7, election_tick 16, read_batch 792),
or with --config rung at bench.py's 32768-sharded (n=32768, seed 7,
election_tick 30, peer_chunk 1024: the whole state on the card, about
60 GiB at its peak); --log-len changes the ring, --planes turns the three device observability
planes on (the flight recorder, telemetry, trace tags), and --entries D
shards the cluster's rows over a row mesh of D entries (every card when
there are several, else the card named D times: the multi-device row
tick).  It warms up with
proposing ticks, then runs --ticks ticks of run_ticks(prop_count=max_props)
three ways:

1. host clock around the window, ending in a synchronize: ms/tick;
2. CUDA events around the same window: device ms/tick;
3. torch.profiler over the same window: device time by kernel name and
   by operator.  Their sum over the event-timed window of step 2 is the
   device's busy share of an unprofiled tick.  In this window the tick's
   phase ranges are on (kernel.PHASE_RANGES: profiler ranges named as the
   JAX package's named_scope seams, phase_A_timers ... phase_F_compact,
   phase_R0..R2, plus phase_C_ring_write, tick_end and obs_planes), so the
   device time of the kernels each phase launched is printed per phase
   next to the per-operator table.  The ranges add no launch.

Prints the card's name and power limit first and one JSON line last, with
the entries committed (and, with reads on, the reads served) per tick over
the three windows.  It needs a card and never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from swarmkit_tpu_torch import parallel
from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft import sim
from swarmkit_tpu_torch.raft.sim import kernel

PHASE_PREFIXES = ("phase_", "phases_", "tick_end", "obs_planes")

HEADLINE = dict(n=4096, log_len=8192, window=2048, apply_batch=2048,
                max_props=2048, keep=500, election_tick=24, seed=0,
                static_members=True, collect_stats=True)
DENSE = dict(peer_chunk=0, active_rows=0)
MAILBOX = dict(n=1024, log_len=8192, window=2048, apply_batch=2048,
               max_props=2048, keep=500, election_tick=20, seed=7,
               latency=2, latency_jitter=1, inflight=4, heartbeat_tick=1,
               static_members=True, collect_stats=True)
READMIX = dict(n=256, log_len=8192, window=2048, apply_batch=2048,
               max_props=2048, keep=500, election_tick=16, seed=7,
               read_batch=99 * 2048 // 256, static_members=True,
               collect_stats=True)
RUNG = dict(HEADLINE, n=32768, election_tick=30, seed=7, peer_chunk=1024)
CONFIGS = {"headline": HEADLINE, "mailbox": MAILBOX, "readmix": READMIX,
           "rung": RUNG}
PLANES = dict(record_events=True, collect_telemetry=True, trace_tags=True)


def _device_total_us(evt) -> float:
    """Device time of the kernels launched inside a profiler range, in µs."""
    v = getattr(evt, "device_time_total", None)
    return float(v if v is not None else evt.cuda_time_total)


def _device_us(evt) -> float:
    """Self device time of a profiler row in µs (the attribute was renamed
    from *_cuda_* to *_device_* across torch releases)."""
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS),
                    default="headline")
    ap.add_argument("--n", type=int, default=None,
                    help="rows (default: the configuration's own)")
    ap.add_argument("--log-len", type=int, default=None,
                    help="ring slots (default: the configuration's own)")
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dense", action="store_true",
                    help="pin peer counts and progress dense (peer_chunk=0, "
                         "active_rows=0)")
    ap.add_argument("--planes", action="store_true",
                    help="turn on the flight recorder, telemetry and trace "
                         "tags")
    ap.add_argument("--entries", type=int, default=1,
                    help="shard the rows over a row mesh of this many "
                         "entries")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    base = CONFIGS[args.config]
    cfg = sim.SimConfig(**{**base, "n": args.n or base["n"],
                           "log_len": args.log_len or base["log_len"],
                           **(DENSE if args.dense else {}),
                           **(PLANES if args.planes else {})})
    st = sim.init_state(cfg)
    if args.entries > 1:
        cards = parallel.local_devices()
        devices = cards if len(cards) > 1 else cards * args.entries
        st = parallel.shard_rows(st, parallel.row_mesh(
            cfg.n, devices[:args.entries]))
    st, ticks = sim.run_until_leader(st, cfg, max_ticks=2000)
    if not bool(sim.has_leader(st)):
        raise SystemExit("profile_tick: no leader")
    st, _ = sim.run_ticks(st, cfg, args.warm, prop_count=cfg.max_props)
    torch.cuda.synchronize()

    def window(state):
        return sim.run_ticks(state, cfg, args.ticks,
                             prop_count=cfg.max_props)

    commit0 = int(sim.committed_entries(st))
    reads0 = int(sim.reads_served(st))
    t0 = time.perf_counter()
    st, _ = window(st)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.ticks

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st, _ = window(st)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / args.ticks

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda_ops.reset_launches()
    kernel.reset_counts()
    kernel.PHASE_RANGES = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            st, _ = window(st)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        kernel.PHASE_RANGES = False
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    counts = dict(kernel.COUNTS)
    committed = (int(sim.committed_entries(st)) - commit0) / (3 * args.ticks)
    reads = (int(sim.reads_served(st)) - reads0) / (3 * args.ticks)

    # the phase ranges also appear on the device's timeline: not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(PHASE_PREFIXES)]
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]
    phases = {e.key: e for e in ops if e.key.startswith(PHASE_PREFIXES)}
    ops = [e for e in ops if e.key not in phases]
    device_us = sum(_device_us(e) for e in kernels)
    # kernel time per tick over the unprofiled device window: the share of
    # a normal tick the device is busy (the profiler stretches host gaps)
    busy = device_us / 1e3 / args.ticks / event_ms
    print(f"{args.config} n={cfg.n}: host {host_ms:.3f} ms/tick, device (events) "
          f"{event_ms:.3f} ms/tick; profiled window {wall_us / 1e3:.3f} ms "
          f"wall, {device_us / 1e3:.3f} ms of kernels "
          f"({100 * device_us / wall_us:.1f}% busy under the profiler, "
          f"{100 * busy:.1f}% of the event-timed window); "
          f"append_band_copy launches {launches}; step host syncs "
          f"{counts['host_syncs'] / args.ticks:.2f}/tick, slab ticks "
          f"{counts['slab_ticks']}, dense-fallback ticks "
          f"{counts['dense_fallback_ticks']}; committed {committed:.1f} "
          f"entries/tick, served {reads:.1f} reads/tick", flush=True)
    print("top kernels by self device time (µs per tick, calls per tick):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / args.ticks:10.1f}  "
              f"{e.count / args.ticks:7.1f}  {e.key[:100]}")
    print("device time by tick phase (µs per tick of the kernels each phase "
          "launched, share of the kernels' sum, ranges per tick):")
    phase_us = {k: _device_total_us(e) / args.ticks
                for k, e in phases.items()}
    for k in sorted(phase_us, key=phase_us.get, reverse=True):
        share = phase_us[k] * args.ticks / max(device_us, 1e-9)
        print(f"  {phase_us[k]:10.1f}  {100 * share:5.1f}%  "
              f"{phases[k].count / args.ticks:5.2f}  {k}")
    print("top operators by self device time (µs per tick, calls per "
          "tick):")
    for e in sorted(ops, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / args.ticks:10.1f}  "
              f"{e.count / args.ticks:7.1f}  {e.key[:100]}")
    print(json.dumps({
        "card": card, "config": args.config, "n": cfg.n,
        "entries": args.entries,
        "log_len": cfg.log_len, "ticks": args.ticks,
        "committed_per_tick": committed, "reads_per_tick": reads,
        "levers": {"peer_chunk": cfg.peer_chunk,
                   "active_rows": cfg.active_rows},
        "planes": args.planes, "phase_device_us_per_tick": phase_us,
        "election_ticks": ticks, "host_ms_per_tick": host_ms,
        "event_ms_per_tick": event_ms, "profiled_wall_ms": wall_us / 1e3,
        "kernel_ms": device_us / 1e3, "busy_share": busy,
        "busy_share_profiled": device_us / wall_us,
        "kernel_launches_per_tick": sum(e.count for e in kernels)
        / args.ticks,
        "band_copy_launches": launches,
        "host_syncs_per_tick": counts["host_syncs"] / args.ticks,
        "slab_ticks": counts["slab_ticks"],
        "dense_fallback_ticks": counts["dense_fallback_ticks"]}), flush=True)


if __name__ == "__main__":
    main()
