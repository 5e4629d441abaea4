"""Where a headline tick's time goes on the CUDA card.

    python -m swarmkit_tpu_torch.tools.profile_tick [--n 4096] [--ticks 16]

Elects a leader at the bench headline configuration (n=4096 unless --n
says otherwise), warms up with proposing ticks, then runs --ticks ticks of
run_ticks(prop_count=max_props) three ways:

1. host clock around the window, ending in a synchronize: ms/tick;
2. CUDA events around the same window: device ms/tick;
3. torch.profiler over the same window: device time by kernel name and
   by operator.  Their sum over the event-timed window of step 2 is the
   device's busy share of an unprofiled tick.

Prints the card's name and power limit first and one JSON line last.  It
needs a card and never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft import sim

HEADLINE = dict(n=4096, log_len=8192, window=2048, apply_batch=2048,
                max_props=2048, keep=500, election_tick=24, seed=0,
                static_members=True, collect_stats=True, peer_chunk=0,
                active_rows=0)


def _device_us(evt) -> float:
    """Self device time of a profiler row in µs (the attribute was renamed
    from *_cuda_* to *_device_* across torch releases)."""
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=HEADLINE["n"])
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    cfg = sim.SimConfig(**{**HEADLINE, "n": args.n})
    st, ticks = sim.run_until_leader(sim.init_state(cfg), cfg,
                                     max_ticks=2000)
    if not bool(sim.has_leader(st)):
        raise SystemExit("profile_tick: no leader")
    st, _ = sim.run_ticks(st, cfg, args.warm, prop_count=cfg.max_props)
    torch.cuda.synchronize()

    def window(state):
        return sim.run_ticks(state, cfg, args.ticks,
                             prop_count=cfg.max_props)

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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st, _ = window(st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = cuda_ops.LAUNCHES["append_band_copy"]

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]
    device_us = sum(_device_us(e) for e in kernels)
    # kernel time per tick over the unprofiled device window: the share of
    # a normal tick the device is busy (the profiler stretches host gaps)
    busy = device_us / 1e3 / args.ticks / event_ms
    print(f"n={args.n}: host {host_ms:.3f} ms/tick, device (events) "
          f"{event_ms:.3f} ms/tick; profiled window {wall_us / 1e3:.3f} ms "
          f"wall, {device_us / 1e3:.3f} ms of kernels "
          f"({100 * device_us / wall_us:.1f}% busy under the profiler, "
          f"{100 * busy:.1f}% of the event-timed window); "
          f"append_band_copy launches {launches}", flush=True)
    print("top kernels by self device time (µs per tick, calls per tick):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / args.ticks:10.1f}  "
              f"{e.count / args.ticks:7.1f}  {e.key[:100]}")
    print("top operators by self device time (µs per tick, calls per "
          "tick):")
    for e in sorted(ops, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / args.ticks:10.1f}  "
              f"{e.count / args.ticks:7.1f}  {e.key[:100]}")
    print(json.dumps({
        "card": card, "n": args.n, "ticks": args.ticks,
        "election_ticks": ticks, "host_ms_per_tick": host_ms,
        "event_ms_per_tick": event_ms, "profiled_wall_ms": wall_us / 1e3,
        "kernel_ms": device_us / 1e3, "busy_share": busy,
        "busy_share_profiled": device_us / wall_us,
        "kernel_launches_per_tick": sum(e.count for e in kernels)
        / args.ticks,
        "band_copy_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
