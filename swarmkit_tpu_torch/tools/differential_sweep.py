"""Fresh-seed differential sweep on the port: drive the tick-vs-golden-core
gate (raft/sim/differential.py) over randomized schedules, the JAX
package's tools/differential_sweep.py on the port's tick.

Each iteration picks a family (wire x faults x membership x transfers x
snapshot-sleep), draws a fresh seed, and runs the per-tick field-by-field
comparison.  Any failure prints the family + seed so it can be pinned as
a regression test.  A seed draws the JAX tool's schedule, draw for draw.

    python -m swarmkit_tpu_torch.tools.differential_sweep [--minutes 30] \
        [--seed-base 0] [--device cpu]

It runs on the CUDA card and raises without one, unless --device cpu.
"""

from __future__ import annotations

import argparse
import time
import traceback

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.raft.sim.differential import run_differential
from swarmkit_tpu_torch.raft.sim.state import SimConfig

SYNC5 = SimConfig(n=5, log_len=64, window=8, apply_batch=16, max_props=8,
                  keep=4, election_tick=10, seed=77)
SYNC7 = SimConfig(n=7, log_len=64, window=8, apply_batch=16, max_props=8,
                  keep=4, election_tick=12, seed=9)
MB5 = SimConfig(n=5, log_len=64, window=8, apply_batch=16, max_props=8,
                keep=4, election_tick=14, seed=5, latency=2,
                latency_jitter=1, inflight=2, pre_vote=True)
MB7 = SimConfig(n=7, log_len=64, window=8, apply_batch=16, max_props=8,
                keep=4, election_tick=14, seed=6, latency=1,
                latency_jitter=2, inflight=3)
SYNC64 = SimConfig(n=64, log_len=128, window=16, apply_batch=32,
                   max_props=16, keep=8, election_tick=20, seed=6401)
MB64 = SimConfig(n=64, log_len=128, window=16, apply_batch=32, max_props=16,
                 keep=8, election_tick=24, seed=6402, latency=2,
                 latency_jitter=1, inflight=2, pre_vote=True)
SYNC128 = SimConfig(n=128, log_len=128, window=16, apply_batch=32,
                    max_props=16, keep=8, election_tick=24, seed=12801)

FAMILIES = [
    ("sync5-faults", SYNC5, dict(n_ticks=200, drop_rate=0.1,
                                 crash_prob=0.06)),
    ("sync7-membership", SYNC7, dict(n_ticks=220, drop_rate=0.05,
                                     conf_every=25, min_members=3)),
    ("sync7-remove-leader", SYNC7, dict(n_ticks=220,
                                        remove_leader_every=45,
                                        min_members=3)),
    ("sync5-transfer", SYNC5, dict(n_ticks=200, transfer_every=30,
                                   drop_rate=0.05)),
    ("mb5-prevote-faults", MB5, dict(n_ticks=220, drop_rate=0.08,
                                     crash_prob=0.04)),
    ("mb7-jitter-membership", MB7, dict(n_ticks=220, conf_every=30,
                                        min_members=3)),
    ("mb5-transfer", MB5, dict(n_ticks=200, transfer_every=35)),
    ("sync64-faults", SYNC64, dict(n_ticks=90, drop_rate=0.05,
                                   crash_prob=0.02)),
    ("sync64-snapshot", SYNC64, dict(n_ticks=100, prop_prob=0.9,
                                     sleep_node=(3, 20, 70))),
    ("mb64-pipelined", MB64, dict(n_ticks=90, drop_rate=0.03)),
    ("sync128-faults", SYNC128, dict(n_ticks=80, drop_rate=0.03,
                                     crash_prob=0.02, prop_prob=0.6)),
]
FAMILY = {name: (cfg, kw) for name, cfg, kw in FAMILIES}


def run_family(name: str, seed: int, device=None,
               info: dict | None = None) -> dict:
    """One schedule of family `name` at `seed`, tick by tick against the
    golden core.  Zero commits at the family's horizon reruns the SAME
    schedule at 3x the horizon, and a cluster that still commits nothing
    there fails ("no progress").  A failure prints the FAILURE line with
    its repro and the traceback.  Returns {family, seed, ok, max_commit,
    max_term, n_ticks (the horizon of the last run), reran}; `info` is
    passed to run_differential (it accumulates over both runs).  Runs on
    `device` (the CUDA card unless the caller names another)."""
    cfg, kw = FAMILY[name]
    dev = resolve_device(device)
    out = {"family": name, "seed": seed, "ok": False, "max_commit": 0,
           "max_term": 0, "n_ticks": kw["n_ticks"], "reran": False}
    eff_kw = kw
    try:
        stats = run_differential(cfg, seed=seed, device=dev, info=info,
                                 **kw)
        if stats["max_commit"] == 0:
            # Zero commits at the family's horizon is usually luck, not
            # livelock: heavy crash+drop schedules can kill every leader
            # before its first commit (seen at seed 2009343: 0 commits in
            # 220 ticks, 785 by tick 600, tick == oracle throughout).
            # Extend the SAME schedule 3x; a cluster that still commits
            # NOTHING at that horizon is flagged — election livelock must
            # not pass as clean.
            eff_kw = dict(kw, n_ticks=kw["n_ticks"] * 3)
            out.update(reran=True, n_ticks=eff_kw["n_ticks"])
            stats = run_differential(cfg, seed=seed, device=dev,
                                     info=info, **eff_kw)
            if stats["max_commit"] <= 0:
                raise AssertionError(
                    "no progress (stalled cluster even at 3x horizon)")
        out.update(stats, ok=True)
    except Exception:
        # the sweep's boundary: report the schedule and go on to the next
        out["repro"] = (f"run_differential(cfg, seed={seed}, "
                        f"**{eff_kw})")
        print(f"FAILURE family={name} seed={seed} (repro: {out['repro']})",
              flush=True)
        traceback.print_exc()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--seed-base", type=int,
                    default=int(time.time()) % 1_000_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    deadline = time.time() + args.minutes * 60
    counts: dict[str, int] = {}
    failures = 0
    i = 0
    while time.time() < deadline:
        name = FAMILIES[i % len(FAMILIES)][0]
        seed = args.seed_base + i
        i += 1
        if run_family(name, seed, device=dev)["ok"]:
            counts[name] = counts.get(name, 0) + 1
        else:
            failures += 1
        if i % 25 == 0:
            total = sum(counts.values())
            print(f"[{time.strftime('%H:%M:%S')}] {total} schedules clean, "
                  f"{failures} failures; per family: {counts}", flush=True)
    total = sum(counts.values())
    print(f"DONE: {total} fresh-seed schedules, {failures} failures")
    print(f"per family: {counts}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
