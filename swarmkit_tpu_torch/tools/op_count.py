"""Count the aten ops a steady tick runs, on the CPU.

    python -m swarmkit_tpu_torch.tools.op_count [--ticks 60]
        [--config static|mailbox|dynamic ...] [--planes off|on|both]
        [--batch B]

On the card every aten op of the tick is (about) one kernel launch, and
the headline tick is bound by the host's launches, so this count is the
quickest check that a change left a tick's program alone, and a
prediction of its launches before a chip run.  It elects a leader at a
small shape (n=64, L=1024, window/apply/props 64, keep 32, election_tick
12, collect_stats, tiled log, the [16, N] progress slab), then counts
every aten op dispatched during `--ticks` ticks of
run_ticks(prop_count=max_props) with a TorchDispatchMode, and prints ops
per tick for each configuration:

- static: the sync wire, static members (the bench headline's program);
- mailbox: latency 2, jitter 1, inflight 4;
- dynamic: the sync wire with PreVote and dynamic membership;

with the device observability planes off, on (the flight recorder,
telemetry and trace tags), or both.  `--batch B` counts the batched
program instead: the elected state is copied into B clusters on a leading
axis (dst.explore's and the multi-raft plane's shape) and `step` with the
fused propose runs on it, in the dense lowering (log_chunk 0, active_rows
0).
The counts are op counts, not times: they are the same on any machine.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from swarmkit_tpu_torch.raft import sim
from swarmkit_tpu_torch.raft.sim.run import _payload_at

BASE = dict(n=64, log_len=1024, window=64, apply_batch=64, max_props=64,
            keep=32, election_tick=12, log_chunk=128, collect_stats=True,
            static_members=True)
CONFIGS = {"static": {},
           "mailbox": dict(latency=2, latency_jitter=1, inflight=4),
           "dynamic": dict(pre_vote=True, static_members=False)}
PLANES = dict(record_events=True, collect_telemetry=True, trace_tags=True)
DENSE = dict(log_chunk=0, active_rows=0)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def ops_per_tick(kw: dict, ticks: int, batch=None) -> float:
    cfg = sim.SimConfig(**kw)
    st, _ = sim.run_until_leader(sim.init_state(cfg, device="cpu"), cfg,
                                 max_ticks=500, device="cpu")
    if not bool(sim.has_leader(st)):
        raise SystemExit(f"op_count: no leader for {kw}")
    count = _Count()
    if batch is None:
        with count:
            sim.run_ticks(st, cfg, ticks, prop_count=cfg.max_props,
                          device="cpu")
        return count.ops / ticks
    st = sim.broadcast_state(st, batch)
    with count:
        for _ in range(ticks):
            st = sim.step(st, cfg, prop_count=cfg.max_props,
                          payload_fn=_payload_at, device="cpu")
    return count.ops / ticks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--config", nargs="+", choices=sorted(CONFIGS),
                    default=list(CONFIGS))
    ap.add_argument("--planes", choices=("off", "on", "both"), default="both")
    ap.add_argument("--batch", type=int, default=None, metavar="B",
                    help="count the batched dense program on B clusters")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    modes = {"off": ["off"], "on": ["on"], "both": ["off", "on"]}[args.planes]
    out = {}
    for name in args.config:
        for mode in modes:
            kw = {**BASE, **CONFIGS[name], **(PLANES if mode == "on" else {})}
            if args.batch is not None:
                kw.update(DENSE)
            out[f"{name}/planes_{mode}"] = ops_per_tick(kw, args.ticks,
                                                        args.batch)
            print(f"{name}, planes {mode}: "
                  f"{out[f'{name}/planes_{mode}']:.2f} aten ops/tick",
                  flush=True)
    print(json.dumps({"ticks": args.ticks, "batch": args.batch,
                      "ops_per_tick": out}))
    return out


if __name__ == "__main__":
    main()
