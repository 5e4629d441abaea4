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
dense progress), the sharded rung (32768-sharded: n=32768, peer_chunk
1024, each fresh state placed on row_mesh(n) over the local cards: one
H100 holds the whole state, several cards each hold their rows and run
the row tick in lock step), seed 7, at the headline's entry count, and
bench.py's two multi-raft configurations
(`measure_multiraft`: multiraft-1024x3, G = 1024 groups of 3 with reads
and leases, and multiraft-telemetry, G = 256 bare against telemetry on,
here in turns with the ratio's spread), whose fleets shard their groups
over group_mesh(G) when the machine has several cards.
Prints the card's `nvidia-smi` name and power limit, then one JSON line
with bench.py's keys.

As in bench.py, every run-loop call is timed into
swarm_kernel_tick_seconds{call=...} (KernelObs.timed, one registry per
measured config), the timed run's
on-device counters are published (KernelObs.publish: the line's
`kernel_stats`), and after each measurement a telemetry probe runs apart
from the timed loop: the same shape with collect_telemetry on, from a
fresh state, for max(4 x election_tick, 64) ticks proposing
min(64, max_props) entries a tick, published into a private registry.
Its commit latency percentiles (ticks) give the line's
`commit_latency_ticks_p50/p99` and `configs_telemetry`.

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

from swarmkit_tpu_torch import multiraft, parallel
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.raft.sim import kernel
from swarmkit_tpu_torch.raft.sim import (
    SimConfig, SimState, committed_entries, has_leader, init_state,
    leader_mask, reads_blocked, reads_served, run_ticks, run_until_leader,
)
from swarmkit_tpu_torch.raft.sim.run import KernelObs
from swarmkit_tpu_torch.telemetry import TelemetryObs

BASELINE_RATE = 1_000_000 / 60.0   # the north star: 1M entries in 60 s
# bench.py's sharded headline rung (bench.py:722): rows over row_mesh(n),
# banded peer reductions
SHARDED_RUNG = ("32768-sharded", 32768, {"shard": True, "peer_chunk": 1024})
ELECT_CHUNK, MAX_ELECT_TICKS = 256, 2000


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
    """A copy that a run may consume (step writes rings in place); a
    row-sharded state's shards each copied on their own entry."""
    if isinstance(st, parallel.Sharded):
        return dataclasses.replace(st, shards=[_clone(s) for s in st.shards])
    return SimState(**{f.name: None if getattr(st, f.name) is None
                       else getattr(st, f.name).clone()
                       for f in dataclasses.fields(SimState)})


def _telemetry_probe(cfg: SimConfig, dev, place=lambda st: st) -> dict:
    """bench.py's telemetry probe: the measured shape with the telemetry
    plane on, from a fresh state placed as the measured one (`place`),
    for max(4 x election_tick, 64) ticks proposing min(64, max_props)
    entries a tick, scraped into a private registry; returns
    TelemetryObs.publish's summary.  It runs apart from the timed loop, so
    the histograms never cost the measured number."""
    tcfg = dataclasses.replace(cfg, collect_telemetry=True)
    st, _ = run_ticks(place(init_state(tcfg, device=dev)), tcfg,
                      max(4 * cfg.election_tick, 64),
                      prop_count=min(64, tcfg.max_props), device=dev)
    _sync(dev)
    return TelemetryObs(registry=MetricsRegistry()).publish(st, tcfg)


def telemetry_json(m: dict):
    """bench.py's per-config telemetry excerpt (None without a probe)."""
    tel = m.get("telemetry") or {}
    if not tel.get("enabled"):
        return None
    commit = tel.get("commit") or {}
    return {"election_ticks": m["election_ticks"],
            "commit_latency_ticks_p50": commit.get("p50"),
            "commit_latency_ticks_p99": commit.get("p99")}


def bench_cfg(n: int, seed: int, election_tick: int,
              peer_chunk: int | None = None, active_rows: int | None = None,
              latency: int = 0, latency_jitter: int = 0, inflight: int = 1,
              log_len: int = 8192, window: int = 2048, read_batch: int = 0,
              read_leases: bool = True, fsync_lag_ticks: int = 0,
              ack_gating: bool = False) -> SimConfig:
    """bench.py::measure's SimConfig: window, apply batch and proposals
    2048, keep 500, static members, collect_stats; the levers at the
    SimConfig defaults unless pinned, and the storage model only when
    fsync_lag_ticks is set."""
    levers = {k: v for k, v in (("peer_chunk", peer_chunk),
                                ("active_rows", active_rows))
              if v is not None}
    if fsync_lag_ticks:
        levers.update(fsync_lag_ticks=fsync_lag_ticks, ack_gating=ack_gating)
    return SimConfig(n=n, log_len=log_len, window=window, apply_batch=2048,
                     max_props=2048, keep=500, seed=seed,
                     election_tick=election_tick, latency=latency,
                     latency_jitter=latency_jitter, inflight=inflight,
                     static_members=True, collect_stats=True,
                     read_batch=read_batch, read_leases=read_leases, **levers)


def measure(n: int, entries: int, seed: int, election_tick: int, dev,
            chunk: int = 64, peer_chunk: int | None = None,
            active_rows: int | None = None, latency: int = 0,
            latency_jitter: int = 0, inflight: int = 1,
            log_len: int = 8192, window: int = 2048, read_batch: int = 0,
            read_leases: bool = True, fsync_lag_ticks: int = 0,
            ack_gating: bool = False, shard: bool = False,
            **run_kw) -> dict:
    """bench.py::measure on the port: elect, warm, re-elect, then time the
    chunked replication of ~`entries` committed entries.  latency,
    latency_jitter and inflight pick the wire, read_batch/read_leases the
    read path (reads served in the timed pass are counted), and
    fsync_lag_ticks/ack_gating the storage model, as in bench.py.  With
    `shard` every fresh state is placed by parallel.shard_rows on
    row_mesh(n) over the local devices of dev's type (bench.py's
    32768-sharded rung): on one card that is the whole state on the card
    (`mesh_devices` 1); over several, each holds its rows and the row
    tick runs on all of them in lock step (`final` is then a
    parallel.Sharded state).  The run loops' calls are timed by a
    KernelObs, which publishes the timed run's
    counters (`kernel_stats`); the telemetry probe follows.  Each call is
    a run of its own, so its KernelObs publishes into a registry of its
    own (see KernelObs on wrapping counters)."""
    obs = KernelObs(MetricsRegistry())
    cfg = bench_cfg(n, seed, election_tick, peer_chunk=peer_chunk,
                    active_rows=active_rows, latency=latency,
                    latency_jitter=latency_jitter, inflight=inflight,
                    log_len=log_len, window=window, read_batch=read_batch,
                    read_leases=read_leases,
                    fsync_lag_ticks=fsync_lag_ticks, ack_gating=ack_gating)
    mesh = parallel.row_mesh(n, parallel.local_devices(dev) if shard
                             else [dev])

    def place(st):
        return parallel.shard_rows(st, mesh) if shard else st

    ticks_needed = max(1, -(-entries // cfg.max_props))
    n_chunks = -(-ticks_needed // chunk)

    def run_chunks(st):
        for _ in range(n_chunks):
            with obs.timed("run_ticks"):
                st, _ = run_ticks(st, cfg, chunk, prop_count=cfg.max_props,
                                  device=dev, **run_kw)
                _sync(dev)
        return st

    def elect():
        st = place(init_state(cfg, device=dev))
        t0 = time.perf_counter()
        ticks = 0
        while ticks < MAX_ELECT_TICKS:
            with obs.timed("run_until_leader"):
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
           "counts": counts, "kernel_stats": obs.publish(final),
           "mesh_devices": mesh.size}
    if read_batch:
        out["reads"] = int(reads_served(final)) - base_reads
        out["read_rate"] = out["reads"] / dt
        out["reads_blocked"] = int(reads_blocked(final))
    with obs.timed("telemetry_probe"):
        out["telemetry"] = _telemetry_probe(cfg, dev, place)
    return out


def _safety(m: dict) -> tuple[bool, int]:
    """(equal applied => equal checksum on every pair of rows, rows whose
    commit is within one proposal batch of the tip)."""
    final, cfg = m["final"], m["cfg"]
    if parallel.row_sharded(final):
        final = parallel.gather(parallel.only(
            final, ("commit", "applied", "apply_chk")))
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
    return {"rate": m["rate"], "keys": keys, "telemetry": telemetry_json(m),
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
            and bool((g.sync_mark >= g.snap_idx).all()),
            "telemetry": telemetry_json(gm)}


def multiraft_cfg(n: int, seed: int,
                  collect_telemetry: bool = False) -> SimConfig:
    """bench.py::measure_multiraft's per-group shape: the untiled dense
    tick (L=512, window 128, 32 proposals a tick), the read path with
    leases, static members; with telemetry, the 64-deep batch ring."""
    return SimConfig(n=n, log_len=512, window=128, apply_batch=64,
                     max_props=32, keep=64, seed=seed, election_tick=10,
                     read_batch=32, read_leases=True, static_members=True,
                     collect_telemetry=collect_telemetry,
                     telemetry_prop_ring=64 if collect_telemetry else 0,
                     collect_stats=True)


def fleet(cfg: SimConfig, groups: int, dev):
    """bench.py's fleet: init_groups on dev, its groups sharded over
    group_mesh(G) of the local devices of dev's type when there are
    several (a parallel.Sharded fleet), as bench.py::measure_multiraft
    does on a machine with several devices."""
    gstate = multiraft.init_groups(cfg, groups, device=dev)
    mesh = parallel.group_mesh(groups, parallel.local_devices(dev))
    if mesh.size == 1:
        return gstate
    return parallel.shard_rows(gstate, mesh, axis=parallel.GROUP_AXIS,
                               leading=groups)


def _sync_fleet(gstate, dev) -> None:
    for d in ({s.term.device for s in gstate.shards}
              if isinstance(gstate, parallel.Sharded) else {dev}):
        _sync(d)


def elect_groups(gstate: SimState, cfg: SimConfig, dev, groups: int):
    """bench.py's fleet election: 32-tick run_group_ticks chunks (at most
    16) until 99% of the groups have a leader, reading the count once a
    chunk.  Returns (state, ticks, seconds)."""
    ticks, t0 = 0, time.perf_counter()
    for _ in range(16):
        gstate, _ = multiraft.run_group_ticks(gstate, cfg, 32, device=dev)
        ticks += 32
        if int(multiraft.groups_with_leader(gstate)) >= groups * 99 // 100:
            break
    t_elect = time.perf_counter() - t0
    led = int(multiraft.groups_with_leader(gstate))
    if led < groups // 2 + 1:
        raise MeasureError(f"multiraft: only {led}/{groups} groups elected "
                           f"a leader within {ticks} ticks")
    return gstate, ticks, t_elect


def _timed_groups(gstate, cfg, dev, n_chunks: int, chunk: int):
    """`n_chunks` chunks of fused-propose ticks (max_props per group a
    tick), each ended by a synchronize: (state, committed, reads, s)."""
    base = int(multiraft.aggregate_committed(gstate))
    base_reads = int(multiraft.aggregate_reads_served(gstate))
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        gstate, _ = multiraft.run_group_ticks(gstate, cfg, chunk,
                                              prop_count=cfg.max_props,
                                              device=dev)
        _sync_fleet(gstate, dev)
    dt = time.perf_counter() - t0
    return (gstate, int(multiraft.aggregate_committed(gstate)) - base,
            int(multiraft.aggregate_reads_served(gstate)) - base_reads, dt)


def _multiraft_chunks(groups: int, cfg: SimConfig, entries: int,
                      chunk: int) -> int:
    per_tick = groups * cfg.max_props
    return -(-max(100, -(-entries // per_tick)) // chunk)


def measure_multiraft(groups: int, n: int, entries: int, seed: int, dev,
                      collect_telemetry: bool = False,
                      chunk: int = 64) -> dict:
    """bench.py::measure_multiraft on the port: elect the [G, N] fleet
    (staggered timeouts), a warm pass, then the timed chunks of
    fused-propose ticks; aggregate committed entries/s and lease-served
    reads/s summed over groups.  As in bench.py the groups shard over a
    device mesh when the machine has several cards (`fleet`)."""
    cfg = multiraft_cfg(n, seed, collect_telemetry)
    gstate, elect_ticks, t_elect = elect_groups(
        fleet(cfg, groups, dev), cfg, dev, groups)
    n_chunks = _multiraft_chunks(groups, cfg, entries, chunk)
    t0 = time.perf_counter()
    warm, _, _, _ = _timed_groups(gstate, cfg, dev, n_chunks, chunk)
    t_warm = time.perf_counter() - t0
    kernel.reset_counts()
    final, committed, reads, dt = _timed_groups(warm, cfg, dev, n_chunks,
                                                chunk)
    counts = dict(kernel.COUNTS)
    summary = multiraft.MultiRaftObs(registry=MetricsRegistry()) \
        .publish(final)
    return {"cfg": cfg, "final": final, "rate": committed / dt,
            "read_rate": reads / dt, "dt": dt, "committed": committed,
            "reads": reads, "groups": groups,
            "groups_with_leader": summary["groups_with_leader"],
            "elect_ticks": elect_ticks, "t_elect": t_elect,
            "t_compile": t_warm, "timed_ticks": n_chunks * chunk,
            "counts": counts, "mesh_devices": len(gstate)
            if isinstance(gstate, parallel.Sharded) else 1}


def multiraft_telemetry_ab(groups: int, n: int, entries: int, dev,
                           pairs: int = 8, chunk: int = 64) -> dict:
    """bench.py's multiraft-telemetry A/B on one [G, N] shape, measured in
    turns: both fleets (bare, telemetry on) elect and warm, then `pairs`
    timed passes of each alternate, bare first.  Returns bench.py's keys
    (`dense`, `telemetry`: aggregate entries/s over every pass of each;
    `telemetry_over_dense`: the median of the per-pair ratios) with the
    ratios' spread, and each fleet's final state."""
    fleets = {}
    for tel in (False, True):
        cfg = multiraft_cfg(n, 7, tel)
        st, _, _ = elect_groups(fleet(cfg, groups, dev), cfg, dev, groups)
        fleets[tel] = [cfg, st, 0, 0.0]
    n_chunks = _multiraft_chunks(groups, fleets[False][0], entries, chunk)
    for f in fleets.values():                   # the warm pass
        f[1] = _timed_groups(f[1], f[0], dev, n_chunks, chunk)[0]
    ratios = []
    for _ in range(pairs):
        rate = {}
        for tel, f in fleets.items():
            f[1], committed, _, dt = _timed_groups(f[1], f[0], dev,
                                                   n_chunks, chunk)
            f[2] += committed
            f[3] += dt
            rate[tel] = committed / dt
        ratios.append(rate[True] / rate[False])
    dense = fleets[False][2] / fleets[False][3]
    tel = fleets[True][2] / fleets[True][3]
    return {"dense": round(dense, 1), "telemetry": round(tel, 1),
            "telemetry_over_dense": round(sorted(ratios)[len(ratios) // 2],
                                          3),
            "telemetry_over_dense_min": round(min(ratios), 3),
            "telemetry_over_dense_max": round(max(ratios), 3),
            "pairs": pairs, "final_bare": fleets[False][1],
            "final_telemetry": fleets[True][1], "cfg": fleets[True][0]}


def _multiraft(args, dev, log, result: dict, extra: dict) -> None:
    """bench.py's two multi-raft configurations: multiraft-1024x3 (its
    rate, and its reads as the -reads series) and the grouped-telemetry
    A/B at G=256 with bench.py's 0.8 tripwire."""
    name = "multiraft-1024x3"
    mm = measure_multiraft(1024, 3, args.entries, 7, dev,
                           chunk=args.chunk_ticks)
    extra[name] = round(mm["rate"], 1)
    extra[f"{name}-reads"] = round(mm["read_rate"], 1)
    extra[f"{name}_detail"] = {
        "groups_with_leader": mm["groups_with_leader"],
        "groups": mm["groups"], "election_ticks": mm["elect_ticks"],
        "election_s": mm["t_elect"], "warm_pass_s": mm["t_compile"],
        "ms_per_tick": mm["dt"] / mm["timed_ticks"] * 1e3,
        "host_syncs_per_tick":
            mm["counts"]["host_syncs"] / mm["timed_ticks"]}
    log(f"config {name}: {mm['rate']:,.0f} aggregate entries/s + "
        f"{mm['read_rate']:,.0f} reads/s across "
        f"{mm['groups_with_leader']}/{mm['groups']} led groups (elected in "
        f"{mm['elect_ticks']} ticks)")
    del mm
    name = "multiraft-telemetry"
    ab = multiraft_telemetry_ab(256, 3, args.entries, dev,
                                chunk=args.chunk_ticks)
    extra[name] = {k: ab[k] for k in (
        "dense", "telemetry", "telemetry_over_dense",
        "telemetry_over_dense_min", "telemetry_over_dense_max", "pairs")}
    log(f"config {name}: bare {ab['dense']:,.0f} vs telemetry "
        f"{ab['telemetry']:,.0f} aggregate entries/s (median ratio "
        f"{ab['telemetry_over_dense']:.3f}, "
        f"{ab['telemetry_over_dense_min']:.3f}-"
        f"{ab['telemetry_over_dense_max']:.3f} over {ab['pairs']} pairs) "
        f"across 256 groups")
    if ab["telemetry_over_dense"] < 0.8:
        result.setdefault("note", f"grouped-telemetry tripwire: telemetry "
                                  f"rate {ab['telemetry']:,.0f} < 0.8x bare "
                                  f"{ab['dense']:,.0f} at {name}")


def _secondary(args, dev, log, result: dict) -> dict:
    """BASELINE configs 3-5, the mailbox wire, the log-capacity, read-mix
    and durability configs, and the two lowering A/B pairs; the read mix's
    keys go into `result`, as bench.py puts them, and each config's
    telemetry excerpt into result["configs_telemetry"] (for an A/B pair,
    its lever side's)."""
    extra: dict = {}
    tel_extra = result["configs_telemetry"] = {}

    def measured(cn: int, name: str = None, **kw) -> dict:
        m = measure(cn, args.entries, 7, election_tick_for(cn), dev,
                    chunk=args.chunk_ticks, **kw)
        if name is not None and telemetry_json(m) is not None:
            tel_extra[name] = telemetry_json(m)
        return m

    def run(cn: int, name: str = None, **kw) -> float:
        return measured(cn, name, **kw)["rate"]

    for name, cn, kw in (("64-steady", 64, {}),
                         ("1024-crash-every-100", 1024,
                          {"crash_every": 100, "down_for": 5}),
                         ("4096-drop-5pct", 4096, {"drop_rate": 0.05})):
        extra[name] = run(cn, name, **kw)
        log(f"config {name}: {extra[name]:,.1f} entries/s")
    # the device-mailbox wire: per-edge latency 2 + jitter 1 with a 4-deep
    # pipelined append window (vendor MaxInflightMsgs), under bench.py's
    # own safety checks
    name = "1024-mailbox-lat2-jitter1-inflight4"
    m = measured(1024, name, latency=2, latency_jitter=1, inflight=4)
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
    extra["4096-longlog-L65536"] = run(4096, "4096-longlog-L65536",
                                       log_len=65536)
    log(f"config 4096-longlog-L65536: {extra['4096-longlog-L65536']:,.1f} "
        f"entries/s")
    rm = readmix(256, args.entries, dev, args.chunk_ticks)
    extra["256-readmix-99to1"] = rm["rate"]
    if rm["telemetry"] is not None:
        tel_extra["256-readmix-99to1"] = rm["telemetry"]
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
    if fg["telemetry"] is not None:
        tel_extra["256-fsyncgate"] = fg["telemetry"]
    del fg["telemetry"]
    if not fg.pop("durable"):
        fg["error"] = "durability check failed"
    extra["256-fsyncgate"] = fg
    if fg["gated_over_dense"] < 0.8:
        result.setdefault("note", f"storage tripwire: gated rate "
                                  f"{fg['gated_k4']:,.0f} < 0.8x bare "
                                  f"{fg['dense']:,.0f} at 256-fsyncgate")
    pc = max(64, 1024 // 4)          # bench.py's band width at n=1024
    dense, banded = (run(1024, peer_chunk=0),
                     run(1024, "1024-densepeer", peer_chunk=pc))
    extra["1024-densepeer"] = {"dense": dense, f"banded_pc{pc}": banded,
                               "banded_over_dense": banded / dense}
    ar = 16
    dense, sparse = (run(4096, active_rows=0),
                     run(4096, "4096-sparseprog", active_rows=ar))
    extra["4096-sparseprog"] = {"dense": dense, f"sparse_a{ar}": sparse,
                                "sparse_over_dense": sparse / dense}
    for name in ("256-fsyncgate", "1024-densepeer", "4096-sparseprog"):
        log(f"config {name}: {extra[name]}")
    name, cn, kw = SHARDED_RUNG
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m = measured(cn, name, **kw)
    extra[name] = m["rate"]
    extra[name + "_detail"] = {
        "mesh_devices": m["mesh_devices"],
        "election_ticks": m["election_ticks"], "election_s": m["t_elect"],
        "election_s_post_compile": m["t_elect_post"],
        "ms_per_tick": m["dt"] / m["timed_ticks"] * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None}
    log(f"config {name}: {m['rate']:,.1f} entries/s; "
        f"{extra[name + '_detail']}")
    del m
    _multiraft(args, dev, log, result, extra)
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
        "kernel_stats": m["kernel_stats"],
    }
    tel = telemetry_json(m)
    if tel is not None:
        result["commit_latency_ticks_p50"] = tel["commit_latency_ticks_p50"]
        result["commit_latency_ticks_p99"] = tel["commit_latency_ticks_p99"]
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
