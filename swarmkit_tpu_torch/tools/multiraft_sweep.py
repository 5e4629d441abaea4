"""Multi-raft G-sweep on the port: aggregate serving throughput vs group count.

    python -m swarmkit_tpu_torch.tools.multiraft_sweep [--groups 64,256,1024]
        [--n 3] [--entries 2000000] [--seed 2024] [--single-n 4096]
        [--no-single] [--json] [--device cuda]

The port's counterpart of the repo's tools/multiraft_sweep.py.  Runs
tools/bench.py's `measure_multiraft` across a list of group counts
(default G in {64, 256, 1024}, N=3 voters each) plus the single-group
headline shape (G=1, n=4096) as the contrast row, and prints the
"Multi-raft serving" table: aggregate committed entries/s and
lease-served reads/s summed over groups, with the election's ticks and
the warm pass's seconds per point (torch compiles nothing: the warm pass
is the first timed pass, whose seconds the JAX tool reports as compile
time under the same `t_compile` key).  The contrast is the serving
plane's story: many small quorums vs one giant one on the SAME tick.

With --json every point also emits one JSON line on stdout, with the JAX
tool's keys, so sweeps diff like bench rounds; the human table goes
last.  It runs on the CUDA card and raises without one, unless --device
cpu is given (the CPU runs exist for the tests: their numbers are CPU
numbers).
"""

from __future__ import annotations

import argparse
import json
import sys

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.tools import bench

# the keys of one point, as the JAX tool prints them (bench.py's
# measure_multiraft)
POINT_KEYS = ("rate", "read_rate", "dt", "committed", "reads", "groups",
              "groups_with_leader", "elect_ticks", "t_elect", "t_compile")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--groups", default="64,256,1024",
                    help="comma-separated group counts (default 64,256,1024)")
    ap.add_argument("--n", type=int, default=3,
                    help="voters per group (default 3)")
    ap.add_argument("--entries", type=int, default=2_000_000,
                    help="aggregate entries to commit per point")
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--single-n", type=int, default=4096,
                    help="row count for the single-group contrast row")
    ap.add_argument("--no-single", action="store_true",
                    help="skip the G=1 single-group contrast row")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per point (before the table)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    for g in [int(x) for x in args.groups.split(",") if x]:
        print(f"measuring G={g} n={args.n} ...", file=sys.stderr, flush=True)
        m = bench.measure_multiraft(g, args.n, args.entries, args.seed, dev)
        r = {k: m[k] for k in POINT_KEYS}
        del m
        rows.append((f"{g} x n={args.n}", r))
        if args.json:
            print(json.dumps({"groups": g, "n": args.n, **{
                k: round(v, 1) if isinstance(v, float) else v
                for k, v in r.items()}}), flush=True)

    if not args.no_single:
        print(f"measuring single group n={args.single_n} ...",
              file=sys.stderr, flush=True)
        # the contrast row reports a RATE, so a few hundred ticks of
        # steady state suffice — don't scale its entry count with the
        # aggregate target (n=4096 single-group ticks are ~3 orders
        # costlier than a G x n=3 tick)
        s = bench.measure(args.single_n, min(args.entries, 200_000),
                          args.seed, bench.election_tick_for(args.single_n),
                          dev)
        rows.append((f"1 x n={args.single_n}",
                     {"rate": s["rate"], "read_rate": float("nan"),
                      "groups_with_leader": 1, "groups": 1,
                      "elect_ticks": s["election_ticks"],
                      "t_compile": s["t_warm"]}))
        del s
        if args.json:
            print(json.dumps({"groups": 1, "n": args.single_n,
                              "rate": round(rows[-1][1]["rate"], 1)}),
                  flush=True)

    print("\n| groups | agg entries/s | agg reads/s | led | elect ticks "
          "| warm s |")
    print("|---|---|---|---|---|---|")
    for label, r in rows:
        reads = ("-" if r["read_rate"] != r["read_rate"]
                 else f"{r['read_rate']:,.0f}")
        print(f"| {label} | {r['rate']:,.0f} | {reads} "
              f"| {r['groups_with_leader']}/{r['groups']} "
              f"| {r['elect_ticks']} | {r['t_compile']:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
