#!/usr/bin/env python3
"""Drive the PyTorch port (swarmkit_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: the card's name and power limit (nvidia-smi), then a parallel
   nvcc build of every CUDA source under swarmkit_tpu_torch/csrc/, timed,
   with each kernel's registers, spills and static shared memory from
   `-Xptxas -v` (and any ptxas warning), and the wgmma kernel's dynamic
   shared memory.
2. kernel vs plain: append_band_copy against its plain PyTorch version on
   [4096, 1024] chunks of [4096, 8192] rings at several offsets and mask
   densities, plus an unaligned chunk (the scalar path); exact equality.
3. card vs CPU: the port's run at n=256 (L=8192, log_chunk=1024, the
   headline chunk width) on the card here and on the CPU in a second
   process (this script with --phase3-cpu), which runs beside phases
   4-18 and is compared after them: each run checks its own state, then
   the card's traces, every field at the end and, in the three scripted
   runs, a digest of every field after every call and tick are held to
   the CPU's (the first difference named by call and field).  Dense peers
   and progress through an election and 40 ticks with 5% drops and a
   leader crash; then peer_chunk=64 and active_rows=16 through
   run_schedule, 90 ticks with 2% drops and a 30-tick storm in which
   every non-self edge drops, so the progress slab overflows and the
   dense fallback runs.  Every SimState field (active_ttl included) and
   every trace row equal, the kernel launched, and the card took both
   progress branches (the counts are printed).  Third, the mailbox wire
   (latency 2, jitter 1, inflight 4) with PreVote, dynamic membership,
   peer_chunk=64 and active_rows=16: 155 ticks, every field compared
   after every call, a follower removed through
   propose_conf at tick 80 and re-added at 110, a storm at 123-152; both
   progress branches on the card, the flips on every row.  Fourth, the
   read path, the vote guard, transfer cooldown and the gated storage
   model on that wire (PreVote, static members, election_tick 16,
   read_batch 8, fsync every 2 ticks): from the first leader E, with
   stalled disks, a lagging row whose snapshot images
   come flagged corrupt, a transfer whose target goes down with its
   TIMEOUT_NOW on the wire and a second request refused by the cooldown,
   and a storm; every field after every call, both branches on the card.
   Fifth, the three device observability planes (flight recorder,
   telemetry, trace tags) on that wire with PreVote, dynamic members,
   read_batch 8 and gated fsync every 2 ticks: from the first leader E,
   tagged fused proposes, host proposes and reads, stalled disks, a row
   down long enough to need a snapshot restore, a storm; every field
   (event rings, tel_* buffers, read tags) after every call, both
   branches on the card, and the rings hold restores, fallback ticks and
   tagged commits and serves.
4. the main path at full width: the bench headline (n=4096, L=8192,
   window/apply/props 2048, keep 500, election_tick 24, static members,
   tiled log, and the SimConfig defaults that bench.py runs: banded peer
   counts (peer_chunk=1024) and role-sparse progress (active_rows=16)):
   chunked election, then 2 x 64 ticks of run_ticks(prop_count=2048).
   Prints election ticks/seconds, ms/tick on the host clock and between
   CUDA events, committed entries/s, step host syncs per tick, slab and
   dense-fallback ticks, kernel launches, full-pass ring-write ticks and
   peak device memory; checks exactly one leader, a commit advance,
   checksum agreement (equal applied -> equal apply_chk) and that the
   steady ticks ran on the slab.
4b. the same shape with both lowerings pinned dense, 64 ticks at a time
   in turns with the levers (dense, levers, levers, dense, twice) from
   one state; prints both ms/tick and the levers/dense ratios.
5. the kernel on the main path's own inputs: the band-copy calls of one
   more headline tick are recorded, then kernel, plain version and
   torch.where (a yardstick the port never calls) are timed on them
   (device time, replayed from a CUDA graph; the eager per-call time is
   printed beside it) against the bytes bound at 3.35 TB/s.
6. matmul and sumsq kernels vs plain: bf16 and f32 products on
   [256,128]@[128,384], a multi-K [128,512]@[512,128] and an edge case
   [32,32]@[32,32]; in bf16 also ragged wgmma tiles ([384]^3, M=200 K=72
   N=136), K below one stage (M=128 K=32 N=64), K=70 (not a multiple of
   8: the WMMA kernel) and the full [8192]^3; bf16 within 2 bf16 ulps of
   max|ref|, f32 within 1e-5 of max|ref| scaled by sqrt(K/512) past K=512.
   Each case checks which of the three matmul kernels ran (wgmma for bf16
   with K and N multiples of 8, WMMA for other bf16, SIMT for f32).
   sumsq on [8192, 8192] bf16 within a relative 1e-5 of plain, and two
   kernel calls bit-equal.
7. the executor path at full width: TpuExecutor(device="cuda") drives
   tpu://pallas_matmul n=8192 steps=16 ASSIGNED -> COMPLETE through
   do_task_state; prints prepare and run seconds, TFLOP/s and launches;
   checks a finite result and 16 launches of each kernel, the matmul's
   all on the wgmma kernel.  Then
   tpu://matmul at the same size (torch.matmul, for comparison), axpy and
   spin through the same executor, and pallas_matmul n=1024 steps=4 on
   the card and on the CPU: the chains' matrices within rtol=atol=1e-1,
   the results within the sum of the matrices' differences.
8. the kernels on the executor path's own inputs: the matmul and sumsq
   calls of one step of the full-width task are recorded, then kernel,
   plain version and library call (torch.matmul; the faster of
   vector_norm**2 and x.float().square().sum()) are timed on them from
   CUDA-graph replay, against the bound: operations at 989 TFLOP/s bf16
   for matmul, bytes at 3.35 TB/s for sumsq.  The WMMA matmul kernel,
   which the wgmma kernel replaced on this path, is timed and checked on
   the same inputs, in turns with it.

9. the mailbox path at full width: bench.py's
   1024-mailbox-lat2-jitter1-inflight4 as measure() builds it (n=1024,
   L=8192, window/apply/props 2048, keep 500, seed 7, election_tick 20,
   latency 2, jitter 1, inflight 4, heartbeat_tick 1, static members, the
   levers at their defaults: tiled log, one-pass counts, the [16, N]
   progress slab): chunked election, 2 x 64 ticks of run_ticks, then 4
   profiled ticks and 16 more counting the ticks whose leader had ring
   room for a batch.  Prints election ticks/seconds, ms/tick (host clock
   and CUDA events), entries/s, kernel launches and kernel ms per tick,
   the device's busy share, step host syncs per tick, append_band_copy
   launches, full-pass ring-write ticks and peak memory; checks exactly one leader, a commit advance,
   checksum agreement, band-copy launches and at most one step host sync
   per steady tick.  Then phase 5's check on this path: the band-copy
   calls of one more mailbox tick, kernel against plain, exact.
9b. the same shape with pre_vote=True and static_members=False: elect,
   remove a follower through propose_conf until every other row's view
   drops it, re-add it until every row's view holds it again (within 200
   ticks each); prints the ticks each took and the step host syncs.
   Phase 3 also runs this wire at n=256, card against CPU call by call.
10. the read path at full width: bench.py's 256-readmix-99to1 (n=256,
   L=8192, window/apply/props 2048, keep 500, seed 7, election_tick 16,
   read_batch 792, static members, the levers at their defaults): chunked
   election, 2 x 64 timed ticks; prints entries/s, reads/s, their ratio,
   reads blocked, ms/tick (host clock and CUDA events) and step host syncs;
   then the same shape at read_batch=0 in turns with it (32-tick chunks,
   then 4 profiled ticks each: kernel launches and ms per tick), and the
   band copy against plain on one more tick's calls.  Checks reads/s >= 10
   x entries/s, read_srv_idx >= read_srv_goal on every row, one leader,
   checksum agreement, <= 1 step host sync per steady tick, kernel = plain.
10b. the read path at the headline's width and levers (n=4096,
   read_batch 49): election (its dense-fallback ticks run the banded ack
   count), 64 ticks, kernel launches per tick in turns with the reads-off
   headline; checks linearizable serves and one leader.
11. bench.py's 256-fsyncgate: n=256, L=32768, window 10752, bare and with
   the storage model (fsync every 4 ticks, ack gating), each elected, then
   64-tick chunks in turns; prints both entries/s and their ratio (bench.py's
   0.8 tripwire as a note); after every gated chunk checks dur_commit never
   fell, max(ack_frontier) <= max(last), sync_mark >= snap_idx; one leader
   and checksum agreement on both.
12. the device observability planes at the headline's full width and
   levers (n=4096, the default 128-deep event ring), in turns with the
   same shape planes-off: each elected, then 4 profiled ticks of each in
   turns (kernel launches and ms per tick; the planes-off count against
   the headline's 1393.25; every window's band-copy launches, full-pass
   and dense-fallback ticks; the kernel records in which a config's two
   windows differ, and whether the host called the same aten ops in
   both), then 4 off/on pairs of 32-tick chunks in turns, each planes-on chunk
   tagged by a tracer span (span_trace_tag) and followed by a ClockSync
   sample.  Prints entries/s, host ms/tick (the median on/off pair ratio
   and its spread), launches, step host syncs (checked 1.00 per steady
   tick on both), each config's band-copy launches over its 128 timed
   ticks (checked a mix of banded and full-pass ticks), commit and
   election p50/p99 (summarize_state checked equal to
   percentile_edge_device), events recorded, overwritten and tagged on all
   rows, the clock fit, KernelObs and TelemetryObs published into a
   registry and the exposition's family count, a capture of rows 0-255
   exported as a Chrome trace (validate_chrome_trace must return [], with
   flow events), and the band copy against plain on one planes-on tick's
   calls.
13. the DST sweep on the batched tick (swarmkit_tpu_torch/dst/, the
   sweep configuration of tools/dst_sweep.py: n=5, L=64, reads 2): the
   port's explore on the card and on the CPU, each drawing its own batch,
   at 64 x 100 on PROFILES and at 32 x 100 on EXTRA_PROFILES with fsync
   every 4 ticks under ack gating, telemetry and the SLO bounds (the
   schedules, viol, first_tick, bits_by_tick and every final field
   equal); the documented 256 x 100 sweep (0 violations; schedules/s,
   step host syncs a tick (0), kernel launches and ms over 8 profiled
   ticks and the busy share against 8 unprofiled ones); 16384 x 100
   (schedules/s, peak memory); both mutation self-tests at 24 x 100
   (caught, shrunk: seconds, evals and batched replays; the artifact
   replayed exactly on the card and on the CPU); the term-inflation demo
   (8 x 60) and the disruptive-rejoin, transfer-abuse and lost-tail demos
   at 8 x DEMO_TICKS (neutralized).
   The sweep's ring write is one band-copy launch a tick over all
   clusters' rows ([S*5, 64]): both sweeps' launches are counted from 0,
   and the kernel is held to plain on one sweep tick's call.
13b. oracle_trace on the card: phase 13's commit_no_quorum artifact
   replayed through the tick on the card and the host golden core in
   lockstep must diverge where the CPU replay does, on the same fields
   with the same values on both sides; its lost-tail artifact must hold
   lockstep over the clean prefix (diverged_at -1).  Prints the ticks
   replayed, the host reads and the seconds on the card and on the CPU.
14. the multi-raft serving plane at full width: bench.py's
   multiraft-1024x3 (G=1024 groups of N=3, L=512, window 128, apply_batch
   64, max_props 32, keep 64, election_tick 10, read_batch 32, leases,
   static members, seed 7, collect_stats): the fleet's election in 32-tick
   chunks until 99% of the groups lead, 2 x 64 steady fused-propose ticks
   (aggregate entries/s and reads/s, ms/tick on the host clock and between
   CUDA events, step host syncs: checked 0 a tick), 4 unprofiled and 4
   profiled ticks (kernel launches, kernel ms, the device's busy share),
   the band copy of one grouped tick on its [3072, 512] rings against
   plain (exact) and timed as in phase 5, and the safety checks: at most
   one leader per group and term, checksum agreement inside each group.
   The path's band-copy launches are counted from 0: one a tick.
14b. bench.py's multiraft-telemetry: G=256 bare and with telemetry
   (telemetry_prop_ring=64), each elected and warmed, then 2 pairs of
   timed passes in turns (bench.py runs 8; cut here to make room for
   phases 24 and 26): the telemetry/bare ratio's median and spread
   (bench.py's 0.8 tripwire as a note) and per-group commit p50/p99 from
   summarize_groups for a few groups.
14c. the serving plane on the card and on the CPU at G=8 on both wires,
   every field compared after every call: the election, Router.flush with
   per-group payloads, spills past max_props and reads,
   run_groups_under_schedule on an [8, 60] schedule batch (the same viol
   and first), and FleetSource.scrape -> SloEngine.observe (the same
   readings and transitions).

15. the levers and planes on the batched tick: the JAX package's three
   lever cross-check configurations (n=5 L=512 log_chunk=128 against 0,
   n=16 peer_chunk=8 against 0, n=16 active_rows=8 against 0; window 8,
   apply_batch 16, max_props 8, keep 4, election_tick 10, seed 77) and
   DST5 with the flight recorder, telemetry and trace tags against
   without: one 256 x 100 schedule batch each, explored on the card with
   the lever on and off (equal viol, first_tick, bits_by_tick, 0
   violations), the lever on against the CPU on the first 16 schedules
   (masks and every final field), schedules/s, step host syncs a tick (1
   under the tiled log and the slab, the batch's one read-back; 0 else),
   slab and fallback ticks, band-copy launches, kernel launches and ms a
   tick over 4 profiled ticks, and the band copy of one more sweep tick
   against plain (timed on the tiled log's [1280, 128] chunks).
16. the exhaustive model checker (mc/): mc_sweep's n3h8 scope on the card
   must give the pinned ladder exactly (3,455,140 branches, 1,335,494
   states, 10 passes, 2^20 branches in the widest, 0 violations,
   exhaustive); prints branches/s, the seconds of the device passes and
   of the host dedup, peak device memory and the band-copy launches (one
   a pass); one profiled 2^20-lane pass (launches, kernel ms, the band
   copy on its [3145728, 32] rings against plain, timed); both mutation
   self-tests at n3h8 (caught, the shrunk artifact replayed exactly on
   the card and on the CPU); the smoke scope on the card and the CPU (the
   same summaries, violations, edges and .aut bytes).
17. the scheduler's group placement at Docker's published scale (1,000
   nodes and 30,000 containers; swarmkit_tpu_torch/tools/sched_world.py:
   three zones, 5% of the nodes down, 2% tainted, 0-3 tasks running on
   each).  Groups A (30,000 replicas reserving 0.25 CPU / 512 MiB, spread
   over the zones), B (30,000 on zone!=c, at most 40 a node) and C (4,096
   spread by node.id), each on a fresh copy of the world through
   Scheduler.schedule with the kernel on the card: exactly one
   sched_place launch (the tree kernel) and no host fallback a group, the
   decisions equal to the kernel's choices, each of sched_place.cu's
   kernels (the tree kernel, the same comparing every key field by field,
   and the rescan kernel it replaced) equal to the plain loop on the CPU
   over every task, and the host Pipeline (use_kernel=False) on the first
   128 tasks equal to the kernel's first 128.  Prints the schedule,
   encode_group, encode + place and grouping + decode seconds; each
   kernel's device ms between CUDA events, timed in turns on the same
   columns (3 launches after a warm one, twice each), and us a task; the
   bound; the host Pipeline's us a task; the plain
   loop on the card over a 512-task prefix (ms, and for group A its
   launches; a yardstick never on the path) beside the kernel on the same
   prefix; placed and unplaced counts; the chain alone (no spread, every
   task placed round robin) at 32 and 1,000 nodes for each kernel; and
   peak device memory.
18. the multi-raft tools on the card: multiraft_sweep's G=64 point
   (--entries 200000 --no-single --json; its JSON line parsed, the band
   copy launched) and three swarm_top frames over its in-process demo
   (the fleet's leader rows, hottest groups and SLO alerts present).
19. differential_sweep on the card: each of the JAX tool's 11 families
   (sync and mailbox wires, faults, membership churn, a leader removing
   itself, transfers, snapshot catch-up at n=64, a pipelined mailbox at
   n=64, drops and crashes at n=128) at seeds 0 .. DIFF_SEEDS-1 through
   run_family: the tick held to the host golden core (OracleCluster) on
   term, vote, role, lead, last, commit, applied, apply_chk and member
   after every tick, with the zero-commit rerun at 3x the horizon.  Per
   family: schedules, ticks, max commit and term, reruns, host ms a tick
   split into the card tick (step and the host calls, enqueued), the
   oracle, the view read and the schedule draw, device->host reads a tick
   and the band-copy launches (one a tick).  Then the kernel against
   plain on a sync128-faults tick's [128, 128] call, exact, and timed as
   in phase 5.
20. fault_sweep's device half on the card: run_device_precheck on the
   five fault plans at seed 2009343 (n=16, 45 ticks) at peer_chunk=8
   (banded = dense) and at active_rows=8 (sparse = dense), and two plans
   card = CPU on viol, first_tick and bits_by_tick; run_attack_sweep over
   the four attacks and run_storage_sweep over the four storage faults at
   seed 7, n=5, 8 schedules of at most FAULT_TICKS ticks: every row ok (caught with the defense off,
   shrunk, replayed exactly, the oracle in lockstep, clean with the
   defense on; or contained with recovery events), every card artifact
   replayed on the CPU with its recorded viol and first tick.  Per row:
   seconds, caught/schedules, fault events before and after the shrink,
   its evals, the oracle's diverged_at and the band-copy launches.  Each
   lowering and each row counts its launches from 0 (one a tick driven)
   and holds every band-copy call it made against the plain version,
   exactly; append_flood's explore call on [40, 64] rings is timed as in
   phase 5.
21. the executor's rest: tpu://pmatmul n=8192 steps=16 batch=8 (the JAX
   program's default batch; 1 GiB of bf16 activations, 140.7 TFLOP), one
   shard a card over every local card, twice: its prepare s, run s and
   TFLOP/s beside phase 7's tpu://matmul rate; the same program at n=256
   batch=4 on the card and on the CPU (the chains within rtol=atol=1e-1, the
   results within the sum of the chains' |diff|); a task whose n and
   steps come from a templated secret (n=3{{.Task.Slot}} at slot 2) runs
   on the card with no secret value in its log lines, and the buffer's
   watch() gives its lifecycle lines in order; describe names
   gpu-chip: torch.cuda.device_count().
22. the device wire: three raft/core.py nodes behind DeviceMeshTransports
   on a DeviceMeshNet(rows=8) on the card elect a leader, commit 256
   proposals on every node under 5% drops on every edge and a partition
   of the leader (half before it, half to the re-elected leader), heal,
   and end with equal logs; flushes, messages and the exchange's p50/p99
   from swarm_transport_exchange_seconds.  Then a scripted flush for
   each of the four width buckets (every edge of 8 rows, 1-3 messages an
   edge, 10% of the slots blocked): the card's receiver-major words and
   lengths equal the CPU's, every kept slot holds its message's bytes and
   every blocked slot comes back with length 0.
23. the meshes (swarmkit_tpu_torch/parallel/) on the card, over a mesh
   that names cuda:0 four times (every card where there are several):
   explore at 256 x 100 (PROFILES, reads 2) over schedule_mesh(256), the
   multiraft-1024x3 fleet for 128 fused-propose ticks from a fresh fleet
   over group_mesh(1024), and mc_sweep's n3h8 scan over
   schedule_mesh(2^20), each equal to its unsharded card run (the masks
   and every final field; the trace and every field; phase 16's summary,
   and the smoke scope's edges), each timed beside it, one band-copy
   launch a tick (a pass) a shard, and each shard's first call held to
   plain; the device wire's all-to-all over four entries equal to the
   one-card exchange on phase 22's scripted flushes; then bench.py's
   32768-sharded rung (n=32768, L=8192, peer_chunk 1024, bench.py's
   measure() config) whole on one card: peak memory at n=4096 and 8192
   (election and 64 steady ticks) fitted as a N^2 + b N L and
   extrapolated, the rung run only under 70 GiB, its chunked election
   and 2 x 64 steady ticks of run_ticks(prop_count=2048): entries/s,
   election ticks and seconds, host and CUDA-event ms a tick, step host
   syncs, slab and fallback ticks, peak memory after the election and
   after the steady ticks, one leader, checksums agreeing; and the band
   copy of one more tick on its [32768, 8192] rings against plain, timed
   against its bound; last, a fresh run of the rung whose every field is
   digested after each election tick and each of 16 steady ticks (phase
   24's reference).
24. the row tick (one cluster's rows over a row mesh that names cuda:0
   four times, or every card): phase 3's case (1) (n=256 dense, drops, a
   leader crash) and case (3) (the mailbox wire, PreVote, membership,
   the levers, a storm) each against phase 3's card run (every field;
   for case (3) also a digest of every field after every call and tick,
   the same step counts, both progress branches); peak memory of the
   rung's flow over the mesh at
   n=4096 and 8192 (their elections), fitted as in phase 23 (over the
   70 GiB cap the rung runs at the largest probe width and says why);
   bench.py's 32768-sharded rung over the mesh: its election and 16
   steady ticks held tick by tick to phase 23's digests, each call timed
   apart from the digests: entries/s, election ticks and seconds, host
   and CUDA-event ms a tick, cross-entry copies and bytes a tick, kernel
   launches and kernel ms a tick (2 profiled ticks) and step host syncs
   a tick, peak memory, each beside the card's name and power limit; one
   leader, checksums agreeing; the band copy held to plain on shard 0's
   chunks of one more tick, timed against its bound.
25. the control plane's leader pipeline on one store (tools/
   control_plane.py): Docker's 30,000 replicas through the store,
   swarm-bench's flow and 2 tpu://pallas_matmul tasks under the port's
   Agent, the orchestration script card = CPU.
26. the raft node shell and the Manager (cmd/swarm_bench.py's Quorum):
   (a) BASELINE.json config 2, 5 managers and 1,000 sequential
   ProposeValue appends on the in-process wire and on DeviceMeshNet(rows=8)
   on the card, each append applied on all 5 stores; (b) bench.py's
   cpl-batch64 pair (3 managers, 300 sequential appends, 600 at 64 in
   flight); (c) swarm-bench's 100 replicas on 10 agents through 3 managers
   on the device wire, then 2 tpu://pallas_matmul n=8192 tasks on a
   TpuExecutor worker, bit-equal to phase 7's, with sched_place,
   matmul_wgmma and sumsq counted from 0; (d) the leader killed, the ticks
   and seconds to a new one, a write, the old one restarted from its
   state_dir until its store equals the leader's; (e) Docker's 1,000-node
   world in a quorum's store and a global service, one task a READY node.

Each path's band-copy launches are counted from 0 (the kernels' record
carries them), and each phase-17 group's sched_place launches likewise.
Before the last line it prints the kernels' JSON record and the card's
`nvidia-smi` name/power line; the last line is the result JSON.  Without a CUDA card, or run from a directory that holds nothing
else of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12      # H100 SXM f32 rate outside the tensor cores
TASK_N, TASK_STEPS = 8192, 16   # the executor task at full width
# ticks in each torch.profiler window: the profiler's own processing costs
# seconds per window at ~1400 launches a tick, so the windows stay short
# (8 until the raft quorum's phase 26 needed the room)
PROFILED_TICKS = 4
PHASE3_STEADY = 40    # phase 3's first run: ticks after the election
# bench.py::measure's headline configuration; peer_chunk and active_rows
# stay at their SimConfig defaults (1024 and 16), as bench.py runs them
HEADLINE = dict(n=4096, log_len=8192, window=2048, apply_batch=2048,
                max_props=2048, keep=500, election_tick=24, seed=0,
                static_members=True, collect_stats=True)
DENSE = dict(peer_chunk=0, active_rows=0)   # both lowerings pinned dense
MAILBOX = dict(latency=2, latency_jitter=1, inflight=4)
# bench.py's 1024-mailbox-lat2-jitter1-inflight4 as measure() builds it:
# seed 7, election_tick_for(1024), the levers at their SimConfig defaults
MAILBOX_PATH = dict(n=1024, log_len=8192, window=2048, apply_batch=2048,
                    max_props=2048, keep=500, election_tick=20, seed=7,
                    heartbeat_tick=1, static_members=True,
                    collect_stats=True, **MAILBOX)
# bench.py's 256-readmix-99to1 as measure() builds it: 99 reads offered per
# committed entry (99 * max_props / n per row per refill), seed 7,
# election_tick_for(256), the levers at their SimConfig defaults
READMIX = dict(n=256, log_len=8192, window=2048, apply_batch=2048,
               max_props=2048, keep=500, election_tick=16, seed=7,
               read_batch=99 * 2048 // 256, static_members=True,
               collect_stats=True)
# bench.py's 256-fsyncgate: the same shape on a ring and an append window
# deep enough for FSYNC_K rounds of in-flight entries, bare and with the
# storage model (fsync every FSYNC_K ticks, ack gating)
FSYNC_K = 4
FSYNCGATE = dict(READMIX, read_batch=0, log_len=32768,
                 window=(FSYNC_K + 1) * 2048 + 512)
STORAGE = dict(fsync_lag_ticks=FSYNC_K, ack_gating=True)
# the three device observability planes: flight recorder, telemetry, trace
# tags (which need the other two)
PLANES = dict(record_events=True, collect_telemetry=True, trace_tags=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled function (its own name)."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names = []
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        names.append(rest[len(digits):end])
        rest = rest[end:]
    return names[-1] if names else mangled


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


def phase_card_vs_cpu(torch, sim, cuda_ops, dev: str = "cuda") -> dict:
    """Phase 3's five runs at n=256 on one device: the card's in this
    process, the CPU's in a second one (`PHASE3_CPU_FLAG`), held to each
    other by compare_card_cpu once both have run.  Each run checks on its
    own state what it can alone; its record carries what the comparison
    reads: the traces and every field at the end, and for the three
    scripted runs a digest of every field after every call and tick.
    Phase 24 holds its row mesh to the card's first and third."""
    on_card = dev != "cpu"
    out = {}
    cfg = sim.SimConfig(**{**HEADLINE, **DENSE, "n": 256})
    kw = dict(prop_count=cfg.max_props, drop_rate=0.05, crash_every=40,
              down_for=8)
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    st, ticks = sim.run_until_leader(sim.init_state(cfg, device=dev), cfg,
                                     max_ticks=500, device=dev)
    check(bool(sim.has_leader(st)), f"n=256 on {dev}: no leader")
    st, trace = sim.run_ticks(st, cfg, PHASE3_STEADY, device=dev, **kw)
    trace = trace.cpu()
    secs = time.perf_counter() - t0
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    check(int(trace[:, 1].max()) > 0, f"nothing committed at n=256 on {dev}")
    check(launches > 0 or not on_card,
          "the card run never launched append_band_copy")
    log(f"  dense peers and progress, run_until_leader + run_ticks on {dev}:"
        f" election {ticks} ticks, then {PHASE3_STEADY} ticks, {secs:.2f} s;"
        f" append_band_copy launches {launches}")
    out["case1"] = {"ticks": ticks, "trace": trace,
                    "final": sim.state_to_numpy(st)}

    # the bench's lowerings at n=256: two peer bands of 64 per count and a
    # 16-row progress slab, through run_schedule with a storm window in
    # which every non-self edge drops, so the slab overflows and the dense
    # fallback runs
    cfg = sim.SimConfig(**{**HEADLINE, "n": 256, "peer_chunk": 64,
                           "active_rows": 16})
    T, n = 90, cfg.n
    g = torch.Generator().manual_seed(3)
    drop = torch.rand((T, n, n), generator=g) < 0.02
    drop[40:70] |= ~torch.eye(n, dtype=torch.bool)
    alive = torch.ones((T, n), dtype=torch.bool)
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    t0 = time.perf_counter()
    st, trace = sim.run_schedule(
        sim.init_state(cfg, device=dev), cfg, drop.to(dev), alive.to(dev),
        prop_count=cfg.max_props, device=dev)
    trace = trace.cpu()
    counts = dict(sim.kernel.COUNTS)
    final = sim.state_to_numpy(st)
    log(f"  peer_chunk=64, active_rows=16, run_schedule of {T} ticks with a "
        f"storm at ticks 40-69 on {dev}: {time.perf_counter() - t0:.2f} s; "
        f"slab ticks {counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}, step host syncs "
        f"{counts['host_syncs']}, band-copy launches "
        f"{cuda_ops.LAUNCHES['append_band_copy']}")
    check("active_ttl" in final, f"{dev}: no active_ttl field")
    check(counts["slab_ticks"] > 0 and counts["dense_fallback_ticks"] > 0,
          f"{dev} did not take both progress branches: {counts}")
    check(int(trace[:, 1].max()) > 0, f"nothing committed at n=256 on {dev}")
    out["case2"] = {"trace": trace, "final": final, "counts": counts}
    out["case3"] = phase_mailbox_run(torch, sim, dev)
    out["case4"] = phase_levers_run(torch, sim, dev)
    out["case5"] = phase_planes_run(torch, sim, dev)
    return out


def _equal_fields(got: dict, want: dict, label: str) -> int:
    """Every field of `got` equal to `want`'s; the count."""
    check(sorted(got) == sorted(want), f"{label}: field sets differ")
    for name in want:
        check((got[name] == want[name]).all(), f"{label}: field {name} "
              f"differs between card and CPU")
    return len(want)


def compare_card_cpu(torch, card: dict, cpu: dict) -> None:
    """Phase 3's card runs held to its CPU runs: the election ticks, the
    trace rows and every field at the end of the first two; for the three
    scripted runs the digest of every field after every call and tick
    (the first difference named by call and field), the step counts and
    every field at the end."""
    a, b = card["case1"], cpu["case1"]
    check(a["ticks"] == b["ticks"], f"election ticks differ: card "
          f"{a['ticks']}, cpu {b['ticks']}")
    check(torch.equal(a["trace"], b["trace"]), "run_ticks trace rows differ")
    fields = _equal_fields(a["final"], b["final"], "case (1)")
    log(f"  case (1): the election ticks, all {fields} fields and "
        f"{len(a['trace'])} trace rows equal")
    a, b = card["case2"], cpu["case2"]
    check(torch.equal(a["trace"], b["trace"]),
          "run_schedule trace rows differ")
    check(a["counts"] == b["counts"], f"branch counts differ: card "
          f"{a['counts']}, cpu {b['counts']}")
    fields = _equal_fields(a["final"], b["final"], "case (2)")
    log(f"  case (2): all {fields} fields (active_ttl included), "
        f"{len(a['trace'])} trace rows and the branch counts equal")
    for key in ("case3", "case4", "case5"):
        a, b = card[key], cpu[key]
        check(a["tags"] == b["tags"], f"{key}: the runs made other calls")
        bad = (a["digests"] != b["digests"]).nonzero()
        if len(bad):
            fail(f"{key}: after {a['tags'][int(bad[0][0])]} field "
                 f"{a['fields'][int(bad[0][1])]} differs between card and "
                 f"CPU")
        check(a["counts"] == b["counts"], f"{key}: branch counts differ: "
              f"{a['counts']} vs {b['counts']}")
        fields = _equal_fields(a["final"], b["final"], key)
        log(f"  case ({key[-1]}): the digests of all {fields} fields after "
            f"each of {len(a['tags'])} calls and ticks, every field at the "
            f"end and the branch counts equal; {a['spent']:.2f} s of steps "
            f"on the card, {b['spent']:.2f} s on the CPU")


PHASE3_CPU_FLAG = "--phase3-cpu"   # the second process: phase 3 on the CPU
PHASE3_CPU_THREADS = 2             # its torch threads, beside the card's run
PHASE3_CPU_TIMEOUT = 900.0         # seconds the first process waits for it


def phase3_cpu_main(path: str) -> int:
    """The second process: phase 3's runs on the CPU, their records saved
    to `path` for compare_card_cpu."""
    import torch

    from swarmkit_tpu_torch.parallel import cuda_ops
    from swarmkit_tpu_torch.raft import sim

    torch.set_num_threads(PHASE3_CPU_THREADS)
    torch.save(phase_card_vs_cpu(torch, sim, cuda_ops, "cpu"), path)
    return 0


def start_phase3_cpu(outdir: str):
    """Start phase 3's CPU runs in a second process writing to `outdir`;
    it is killed if this process exits before it ends."""
    import atexit
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    with open(f"{outdir}/cpu3.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             PHASE3_CPU_FLAG, f"{outdir}/cpu3.pt"],
            cwd=here, stdout=out, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_phase3_cpu(torch, proc, outdir: str) -> dict:
    """Wait for the second process, print its log and load its records."""
    try:
        rc = proc.wait(timeout=PHASE3_CPU_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    with open(f"{outdir}/cpu3.log") as f:
        for line in f:
            log(f"  [cpu] {line.rstrip()}")
    check(rc == 0, f"phase 3's CPU runs exited with {rc}")
    return torch.load(f"{outdir}/cpu3.pt", weights_only=False)


def _member_flipped(st, target: int, removed: bool, rows) -> bool:
    """Whether every row in `rows` sees `target` removed (or re-added)."""
    col = st.member[:, target].cpu()[list(rows)]
    return bool((~col).all() if removed else col.all())


def _digest(torch, sim, rec: dict, st, tag: str) -> None:
    """Append to `rec` a digest of every field of `st`, after `tag`."""
    rec["tags"].append(tag)
    rec["digests"].append(state_digests(torch, sim, st, st.term.shape[0]))


def _record(torch, sim, rec: dict, st, **extra) -> dict:
    """`rec` closed: its digests stacked on the host, the fields they
    name, every field at the end, and `extra`."""
    rec["digests"] = torch.stack(rec["digests"]).cpu()
    rec["fields"] = [f for f in sim.state.FIELD_NAMES
                     if getattr(st, f) is not None]
    rec["final"] = sim.state_to_numpy(st)
    rec.update(extra)
    return rec


def _mailbox_case(sim, torch):
    """Phase 3's third case: its config, ticks and drop schedule."""
    cfg = sim.SimConfig(**{**HEADLINE, **MAILBOX, "n": 256, "pre_vote": True,
                           "static_members": False, "peer_chunk": 64,
                           "active_rows": 16})
    T, n = 155, cfg.n
    g = torch.Generator().manual_seed(5)
    drop = torch.rand((T, n, n), generator=g) < 0.02
    drop[123:153] |= ~torch.eye(n, dtype=torch.bool)
    return cfg, T, drop


def phase_mailbox_run(torch, sim, dev: str) -> dict:
    """The mailbox wire with PreVote and dynamic membership at n=256 on
    `dev`, a digest of every field after every call: 2% drops, a conf
    remove of a follower at tick 80 and its re-add at tick 110 through
    propose_conf, and a storm (every non-self edge dropped) at ticks
    123-152 so the dense fallback runs.  Returns the run's record with
    its conf target and step counts."""
    cfg, T, drop = _mailbox_case(sim, torch)
    n = cfg.n
    st = sim.init_state(cfg, device=dev)
    counts = {k: 0 for k in sim.kernel.COUNTS}
    rec = {"tags": [], "digests": []}
    spent, target = 0.0, None
    for t in range(T):
        if t in (80, 110):
            if target is None:
                roles = st.role.tolist()
                target = next(i for i in range(n - 1, -1, -1)
                              if roles[i] != sim.LEADER)
            st = sim.propose_conf(st, cfg, target, t == 80, device=dev)
            _digest(torch, sim, rec, st, f"propose_conf at tick {t}")
        sim.kernel.reset_counts()
        t0 = time.perf_counter()
        st = sim.step(st, cfg, drop=drop[t].to(dev),
                      prop_count=cfg.max_props,
                      payload_fn=sim.run._payload_at, device=dev)
        spent += time.perf_counter() - t0
        for k, v in sim.kernel.COUNTS.items():
            counts[k] += v
        _digest(torch, sim, rec, st, f"tick {t}")
        if t == 109:
            check(_member_flipped(st, target, True, set(range(n)) - {target}),
                  f"{dev}: row {target}'s removal did not land on every "
                  f"other row by tick 109")
    check(_member_flipped(st, target, False, range(n)),
          f"{dev}: row {target}'s re-add did not land on every row")
    check(counts["slab_ticks"] > 0 and counts["dense_fallback_ticks"] > 0,
          f"{dev} did not take both progress branches: {counts}")
    check(int(st.commit.max()) > 0, f"{dev}: nothing committed")
    log(f"  mailbox (latency 2, jitter 1, inflight 4), PreVote, dynamic "
        f"membership, peer_chunk=64, active_rows=16 on {dev}: {T} ticks, "
        f"conf remove at tick 80, re-add at 110, storm at ticks 123-152: "
        f"{spent:.2f} s; slab ticks {counts['slab_ticks']}, dense-fallback "
        f"ticks {counts['dense_fallback_ticks']}, step host syncs "
        f"{counts['host_syncs']}; commit {int(st.commit.max())}, max term "
        f"{int(st.term.max())}; row {target} left every other row's view "
        f"and came back to all")
    return _record(torch, sim, rec, st, target=target, counts=counts,
                   spent=spent)


def phase_levers_run(torch, sim, dev: str) -> dict:
    """This slice's levers at n=256 on the mailbox wire with PreVote, the
    banded counts and the slab on `dev`, a digest of every field after
    every call: reads (a closed loop of 8 per row, and a submit_reads
    call), the vote guard, transfer cooldown and the storage model with
    ack gating (fsync every 2 ticks).  The schedule, from the tick E when
    a leader first stands: 2% drops; two followers' disks stall at
    E+5..E+14; a third follower is down at E+15..E+24 and its snapshot
    images come flagged corrupt at E+25..E+29 (refused: it installs a
    clean one later); proposals stop at E+28 so followers catch up, and a
    transfer at E+32 to the follower furthest along has its target taken
    down once its TIMEOUT_NOW is on the wire, so the leader stays and its
    cooldown refuses a second request two ticks later; a storm at
    E+44..E+55 so the dense fallback runs; the run ends at E+60."""
    cfg = sim.SimConfig(**{**HEADLINE, **MAILBOX, "n": 256,
                           "election_tick": 16, "pre_vote": True,
                           "peer_chunk": 64, "active_rows": 16,
                           "read_batch": 8, "vote_guard": True,
                           "transfer_cooldown_ticks": 15,
                           "fsync_lag_ticks": 2, "ack_gating": True})
    n = cfg.n
    g = torch.Generator().manual_seed(7)
    eye = torch.eye(n, dtype=torch.bool)
    st = sim.init_state(cfg, device=dev)
    counts = {k: 0 for k in sim.kernel.COUNTS}
    rec = {"tags": [], "digests": []}
    spent = 0.0
    E = leader = target = lagging = second = second_at = None
    flags, down = {}, {}
    refused = False
    t = 0
    while E is None or t < E + 60:
        check(E is not None or t < 200, f"{dev}: no leader within 200 ticks")
        top = st
        if E is None and bool(sim.has_leader(top)):
            E = t
            roles = top.role.tolist()
            leader = roles.index(sim.LEADER)
            f = [i for i in range(n) if roles[i] != sim.LEADER]
            lagging, second = f[-1], f[-2]
            flags = {u: ("fsync_stall", f[:2]) for u in range(E + 5, E + 15)}
            flags.update({u: ("snap_bad", [lagging])
                          for u in range(E + 25, E + 30)})
            down = {u: [lagging] for u in range(E + 15, E + 25)}
        if t in flags:
            field, rows = flags[t]
            mask = torch.zeros(n, dtype=torch.bool)
            mask[rows] = True
            st = dataclasses.replace(st, **{
                field: getattr(st, field) | mask.to(dev)})
        if t == 30:
            st = sim.submit_reads(st, cfg, 5, rows=range(8), device=dev)
            _digest(torch, sim, rec, st, "submit_reads at tick 30")
        if E is not None and t == E + 32:
            ahead = top.match[leader].clone()
            ahead[[leader, lagging, second]] = -1
            target = int(ahead.argmax())
        if E is not None and t in (E + 32, second_at):
            to = target if t == E + 32 else second
            st = sim.transfer_leadership(st, cfg, leader, to)
            _digest(torch, sim, rec, st, f"transfer_leadership at tick {t}")
            if t == second_at:
                check(int(st.transferee[leader]) != second
                      and int(st.tx_cool[leader]) > 0,
                      f"{dev}, tick {t}: the cooling leader took a second "
                      f"transfer")
                refused = True
        drop = torch.rand((n, n), generator=g) < 0.02
        if E is not None and E + 44 <= t < E + 56:
            drop |= ~eye
        alive = torch.ones(n, dtype=torch.bool)
        alive[down.get(t, [])] = False
        props = dict(prop_count=cfg.max_props, payload_fn=sim.run._payload_at)
        if E is not None and t >= E + 28:
            props = {}
        sim.kernel.reset_counts()
        t0 = time.perf_counter()
        st = sim.step(st, cfg, alive=alive.to(dev), drop=drop.to(dev),
                      device=dev, **props)
        spent += time.perf_counter() - t0
        for k, v in sim.kernel.COUNTS.items():
            counts[k] += v
        _digest(torch, sim, rec, st, f"tick {t}")
        if E is not None and t >= E + 32 and second_at is None \
                and int(st.tn_at[target]) > 0:
            # the TIMEOUT_NOW is on the wire: take its target down before
            # it lands, then ask for a second transfer two ticks later
            down.update({u: [target] for u in range(t + 1, t + 9)})
            second_at = t + 2
        t += 1
    log(f"  mailbox, PreVote, election_tick 16, peer_chunk=64, active_rows="
        f"16 with read_batch=8, vote_guard, transfer_cooldown_ticks=15, "
        f"fsync_lag_ticks=2 and ack_gating on {dev}, from the first leader "
        f"E: stalled disks, a lagging row's images flagged corrupt, a "
        f"transfer and a second inside the cooldown, a storm: {t} ticks, "
        f"E={E}, {spent:.2f} s; slab ticks {counts['slab_ticks']}, "
        f"dense-fallback ticks {counts['dense_fallback_ticks']}, step host "
        f"syncs {counts['host_syncs']}; commit {int(st.commit.max())}, reads "
        f"served {int(sim.reads_served(st))}, blocked "
        f"{int(sim.reads_blocked(st))}, sync_mark max "
        f"{int(st.sync_mark.max())}, row {lagging}'s snap_idx "
        f"{int(st.snap_idx[lagging])}; the second transfer refused inside "
        f"the cooldown")
    check(counts["slab_ticks"] > 0 and counts["dense_fallback_ticks"] > 0,
          f"{dev} did not take both progress branches: {counts}")
    check(refused, f"{dev}: the second transfer was never asked for")
    check(int(st.snap_idx[lagging]) > 0,
          f"{dev}: row {lagging} never restored")
    check(int(sim.reads_served(st)) > 0 and bool(
        (st.read_srv_idx >= st.read_srv_goal).all()),
        f"{dev}: no reads served, or a served read missed its goal")
    check(int(st.ack_frontier.max()) <= int(st.last.max())
          and bool((st.sync_mark >= st.snap_idx).all()),
          f"{dev}: a durability reduction failed")
    return _record(torch, sim, rec, st, counts=counts, spent=spent)


def phase_planes_run(torch, sim, dev: str) -> dict:
    """The three device observability planes (flight recorder, telemetry,
    trace tags) at n=256 on the mailbox wire with PreVote, dynamic
    membership, election_tick 16, read_batch 8, the gated storage model
    (fsync every 2 ticks), peer_chunk=64 and active_rows=16 on `dev`, a
    digest of every field after every call (the event ring, its cursor
    and fault-edge registers, every tel_* buffer and the read tag
    included).  Tags on every call: the fused propose's step(prop_tag=),
    a host propose every 7th tick, submit_reads every 9th.  From the tick
    E when a leader first stands: 2% drops, two rows' disks stalled at
    E+5..E+10, a row down at E+8..E+19 that comes back to a compacted
    leader (a snapshot restore), a storm at E+35..E+47 so the dense
    fallback runs; the run ends at E+52."""
    import numpy as np

    from swarmkit_tpu_torch.flightrec import decode_state
    cfg = sim.SimConfig(**{**HEADLINE, **MAILBOX, **PLANES, "n": 256,
                           "election_tick": 16, "pre_vote": True,
                           "static_members": False, "peer_chunk": 64,
                           "active_rows": 16, "read_batch": 8,
                           "fsync_lag_ticks": 2, "ack_gating": True})
    n = cfg.n
    g = torch.Generator().manual_seed(9)
    eye = torch.eye(n, dtype=torch.bool)
    payloads = np.arange(1, cfg.max_props + 1, dtype=np.uint32) * 2654435761
    st = sim.init_state(cfg, device=dev)
    counts = {k: 0 for k in sim.kernel.COUNTS}
    rec = {"tags": [], "digests": []}
    spent = 0.0
    E, t = None, 0
    while E is None or t < E + 52:
        check(E is not None or t < 200, f"{dev}: no leader within 200 ticks")
        if E is None and bool(sim.has_leader(st)):
            E = t
        at = -1 if E is None else t - E     # ticks since the first leader
        tag = 0x4000 + t
        if t % 9 == 4:
            st = sim.submit_reads(st, cfg, 3, rows=range(0, n, 5), tag=tag,
                                  device=dev)
            _digest(torch, sim, rec, st, f"submit_reads at tick {t}")
        if 5 <= at < 11:
            st = dataclasses.replace(st, fsync_stall=(
                torch.arange(n) < 2).to(dev))
        drop = torch.rand((n, n), generator=g) < 0.02
        if 35 <= at < 48:
            drop |= ~eye
        alive = torch.ones(n, dtype=torch.bool)
        alive[n - 1] = not 8 <= at < 20
        host_prop = t % 7 == 3
        if host_prop:
            st = sim.propose(st, cfg, payloads, cfg.max_props,
                             alive=alive.to(dev), tag=tag, device=dev)
            _digest(torch, sim, rec, st, f"propose at tick {t}")
        props = {} if host_prop else dict(
            prop_count=cfg.max_props, payload_fn=sim.run._payload_at,
            prop_tag=tag)
        sim.kernel.reset_counts()
        t0 = time.perf_counter()
        st = sim.step(st, cfg, alive=alive.to(dev), drop=drop.to(dev),
                      device=dev, **props)
        spent += time.perf_counter() - t0
        for k, v in sim.kernel.COUNTS.items():
            counts[k] += v
        _digest(torch, sim, rec, st, f"tick {t}")
        t += 1
    events, dropped = decode_state(st)
    names = {e.name for e in events}
    tagged = {e.name for e in events if e.tag}
    log(f"  the device planes (flight recorder, telemetry, trace tags) on "
        f"the mailbox wire, PreVote, dynamic members, read_batch=8, gated "
        f"fsync every 2 ticks, peer_chunk=64, active_rows=16 on {dev}, from "
        f"the first leader E: tagged proposes and reads, stalled disks, a "
        f"restore, a storm: {t} ticks, E={E}, {spent:.2f} s; slab ticks "
        f"{counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}, step host syncs "
        f"{counts['host_syncs']}; commit {int(st.commit.max())}, row "
        f"{n - 1}'s snap_idx {int(st.snap_idx[n - 1])}, {len(events)} "
        f"events in the rings ({int(dropped.sum())} overwritten), codes "
        f"{sorted(names)}, tagged {sorted(tagged)}; commit histogram "
        f"{st.tel_commit_hist.tolist()}")
    check(counts["slab_ticks"] > 0 and counts["dense_fallback_ticks"] > 0,
          f"{dev} did not take both progress branches: {counts}")
    check({"SNAPSHOT_RESTORE", "FALLBACK_TICK", "FSYNC_ADVANCE",
           "COMMIT_ADVANCE", "READ_SERVED"} <= names,
          f"{dev}: events missing from the rings: {sorted(names)}")
    check(tagged == {"COMMIT_ADVANCE", "READ_SERVED"},
          f"{dev}: tagged events: {sorted(tagged)}")
    check(int(st.tel_commit_hist.sum()) > 0
          and int(st.tel_read_hist.sum()) > 0,
          f"{dev}: empty latency histograms")
    return _record(torch, sim, rec, st, counts=counts, spent=spent)


def _checksums_agree(sim, st) -> bool:
    applied, chk = (x.cpu().tolist() for x in sim.quorum_applied_checksum(st))
    seen = {}
    return all(seen.setdefault(a, c) == c for a, c in zip(applied, chk))


def _timed_ticks(torch, sim, cfg, st, ticks: int, **kw):
    """run_ticks(prop_count=max_props, **kw) for `ticks` ticks: (state, host
    ms per tick ending in a synchronize, ms per tick between CUDA events,
    entries committed)."""
    base = int(sim.committed_entries(st))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    st, _ = sim.run_ticks(st, cfg, ticks, prop_count=cfg.max_props, **kw)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ticks
    return st, host_ms, start.elapsed_time(end) / ticks, \
        int(sim.committed_entries(st)) - base


def _elect(torch, sim, cfg, label: str):
    """bench.py::measure's chunked election: (state, ticks, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ticks = sim.init_state(cfg), 0
    while ticks < 2000 and not bool(sim.has_leader(st)):
        st, t = sim.run_until_leader(st, cfg, max_ticks=256)
        ticks += t
    torch.cuda.synchronize()
    check(bool(sim.has_leader(st)), f"{label}: no leader within 2000 ticks")
    return st, ticks, time.perf_counter() - t0


def phase_headline(torch, sim, cuda_ops) -> dict:
    cfg = sim.SimConfig(**HEADLINE)
    check(cfg.peer_tiled and cfg.active_rows_on,
          "the headline must run banded peers and role-sparse progress")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    st, ticks, t_elect = _elect(torch, sim, cfg, "n=4096")
    elect_counts = dict(sim.kernel.COUNTS)
    log(f"  election: {ticks} ticks, {t_elect:.3f} s; slab ticks "
        f"{elect_counts['slab_ticks']}, dense-fallback ticks "
        f"{elect_counts['dense_fallback_ticks']}, step host syncs "
        f"{elect_counts['host_syncs']} (plus one has_leader read per tick)")
    sim.kernel.reset_counts()
    host_ms, event_ms, committed, t_run = [], [], 0, 0.0
    for _ in range(2):
        st, h, e, c = _timed_ticks(torch, sim, cfg, st, 64)
        host_ms.append(h)
        event_ms.append(e)
        committed += c
        t_run += h * 64 / 1e3
    counts = dict(sim.kernel.COUNTS)
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    n_ticks = ticks + 128
    full_pass = _full_pass_ticks(cfg, launches, n_ticks, "n=4096")
    n_leaders = int(sim.leader_mask(st).sum())
    agree = _checksums_agree(sim, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(election_ticks=ticks, election_s=t_elect,
               ms_per_tick=host_ms, event_ms_per_tick=event_ms,
               entries_per_s=committed / t_run, committed=committed,
               launches=launches, launches_per_tick=launches / n_ticks,
               ring_full_pass_ticks=full_pass, peak_gib=peak,
               host_syncs_per_tick=counts["host_syncs"] / 128,
               slab_ticks=counts["slab_ticks"],
               dense_fallback_ticks=counts["dense_fallback_ticks"],
               election_counts=elect_counts)
    log(f"  run_ticks 2x64: ms/tick (host clock) {host_ms[0]:.3f} / "
        f"{host_ms[1]:.3f}, (CUDA events) {event_ms[0]:.3f} / "
        f"{event_ms[1]:.3f}; committed {committed} entries, "
        f"{committed / t_run:.1f} entries/s")
    log(f"  steady 128 ticks: step host syncs "
        f"{counts['host_syncs'] / 128:.3f}/tick, slab ticks "
        f"{counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}")
    log(f"  append_band_copy launches {launches} over {n_ticks} ticks; "
        f"full-pass ring-write ticks {full_pass}; peak device memory "
        f"{peak:.3f} GiB")
    check(n_leaders == 1, f"expected exactly one leader, got {n_leaders}")
    check(committed > 0, "commit did not advance")
    check(agree, "rows with equal applied disagree on apply_chk")
    check(launches > 0, "the main path never launched append_band_copy")
    check(counts["slab_ticks"] + counts["dense_fallback_ticks"] == 128
          and counts["slab_ticks"] > 0,
          f"the steady ticks did not run on the progress slab: {counts}")
    out["state"] = st
    return out


def _device_window(torch, sim, cfg, st, ticks: int, by_name: bool = False):
    """`ticks` proposing ticks under torch.profiler: (state, kernel
    launches per tick, kernel ms per tick), and with `by_name` two dicts
    more: the kernel records and the aten ops the host called, name ->
    count."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st, _ = sim.run_ticks(st, cfg, ticks, prop_count=cfg.max_props)
        torch.cuda.synchronize()
    from swarmkit_tpu_torch.tools.profile_tick import _device_us
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(_device_us(e) for e in kernels)
    out = (st, sum(e.count for e in kernels) / ticks, us / 1e3 / ticks)
    if not by_name:
        return out
    ops = {e.key: e.count for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")}
    return out + ({e.key: e.count for e in kernels}, ops)


def phase_mailbox_path(torch, sim, cuda_ops) -> dict:
    """bench.py's 1024-mailbox-lat2-jitter1-inflight4 at full width: the
    chunked election, then 2 x 64 ticks of run_ticks(prop_count=2048),
    then 8 more under the profiler (launches and kernel time per tick)."""
    cfg = sim.SimConfig(**MAILBOX_PATH)
    check(cfg.mailboxes and cfg.tiled and cfg.active_rows_on
          and not cfg.peer_tiled,
          "the mailbox path must run the mailbox wire, the tiled log and "
          "the progress slab with one-pass counts")
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    st, ticks, t_elect = _elect(torch, sim, cfg, "n=1024 mailbox")
    elect_counts = dict(sim.kernel.COUNTS)
    log(f"  election: {ticks} ticks, {t_elect:.3f} s; slab ticks "
        f"{elect_counts['slab_ticks']}, dense-fallback ticks "
        f"{elect_counts['dense_fallback_ticks']}, step host syncs "
        f"{elect_counts['host_syncs']}")
    sim.kernel.reset_counts()
    host_ms, event_ms, committed, t_run = [], [], 0, 0.0
    for _ in range(2):
        st, h, e, c = _timed_ticks(torch, sim, cfg, st, 64)
        host_ms.append(h)
        event_ms.append(e)
        committed += c
        t_run += h * 64 / 1e3
    counts = dict(sim.kernel.COUNTS)
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    n_ticks = ticks + 128
    full_pass = _full_pass_ticks(cfg, launches, n_ticks, "n=1024 mailbox")
    st, per_tick, kernel_ms = _device_window(torch, sim, cfg, st,
                                             PROFILED_TICKS)
    # how often the leader's ring has room for a batch (_leader_ok): the
    # protocol's own bound on this path's entries per tick
    accepted = 0
    for _ in range(16):
        accepted += int(bool(sim.kernel._leader_ok(st, cfg).any()))
        st, _ = sim.run_ticks(st, cfg, 1, prop_count=cfg.max_props)
    n_leaders = int(sim.leader_mask(st).sum())
    agree = _checksums_agree(sim, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = counts["host_syncs"] / 128
    out = dict(election_ticks=ticks, election_s=t_elect,
               ms_per_tick=host_ms, event_ms_per_tick=event_ms,
               entries_per_s=committed / t_run, committed=committed,
               band_copy_launches=launches, ring_full_pass_ticks=full_pass,
               kernel_launches_per_tick=per_tick,
               kernel_ms_per_tick=kernel_ms,
               busy_share=kernel_ms / (sum(event_ms) / 2),
               host_syncs_per_tick=syncs, peak_gib=peak,
               proposals_accepted_of_16=accepted,
               slab_ticks=counts["slab_ticks"],
               dense_fallback_ticks=counts["dense_fallback_ticks"])
    log(f"  run_ticks 2x64: ms/tick (host clock) {host_ms[0]:.3f} / "
        f"{host_ms[1]:.3f}, (CUDA events) {event_ms[0]:.3f} / "
        f"{event_ms[1]:.3f}; committed {committed} entries, "
        f"{committed / t_run:.1f} entries/s")
    log(f"  steady 128 ticks: step host syncs {syncs:.3f}/tick, slab ticks "
        f"{counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}; {PROFILED_TICKS} profiled ticks: "
        f"{per_tick:.1f} kernel launches/tick, {kernel_ms:.3f} ms of "
        f"kernels/tick, busy share {out['busy_share']:.3f} of the "
        f"CUDA-event tick; the leader took a proposal batch on "
        f"{accepted} of 16 more ticks")
    log(f"  append_band_copy launches {launches} over {n_ticks} ticks; "
        f"full-pass ring-write ticks {full_pass}; peak device memory "
        f"{peak:.3f} GiB")
    check(n_leaders == 1, f"expected exactly one leader, got {n_leaders}")
    check(committed > 0, "commit did not advance")
    check(agree, "rows with equal applied disagree on apply_chk")
    check(launches > 0, "the mailbox path never launched append_band_copy")
    check(syncs <= 1.0, f"{syncs} step host syncs per steady tick")
    out["state"] = st
    return out


def phase_dynamic_members(torch, sim) -> dict:
    """The mailbox path's shape with PreVote and dynamic membership: a
    follower removed through propose_conf must leave every other row's
    view, and re-added, come back to every row's."""
    cfg = sim.SimConfig(**{**MAILBOX_PATH, "pre_vote": True,
                           "static_members": False})
    sim.kernel.reset_counts()
    st, ticks, t_elect = _elect(torch, sim, cfg, "n=1024 dynamic")
    n = cfg.n
    roles = st.role.tolist()
    target = next(i for i in range(n - 1, -1, -1) if roles[i] != sim.LEADER)
    t0, spent = time.perf_counter(), {}
    for removed in (True, False):
        st = sim.propose_conf(st, cfg, target, removed)
        rows = set(range(n)) - {target} if removed else range(n)
        spent[removed] = 0
        while spent[removed] < 200 \
                and not _member_flipped(st, target, removed, rows):
            st, _ = sim.run_ticks(st, cfg, 4, prop_count=cfg.max_props)
            spent[removed] += 4
        check(_member_flipped(st, target, removed, rows),
              f"row {target}'s {'removal' if removed else 're-add'} did not "
              f"land within 200 ticks")
    torch.cuda.synchronize()
    counts = dict(sim.kernel.COUNTS)
    all_ticks = ticks + spent[True] + spent[False]
    out = dict(election_ticks=ticks, election_s=t_elect, target=target,
               remove_ticks=spent[True], readd_ticks=spent[False],
               seconds=time.perf_counter() - t0,
               host_syncs_per_tick=counts["host_syncs"] / all_ticks,
               slab_ticks=counts["slab_ticks"],
               dense_fallback_ticks=counts["dense_fallback_ticks"])
    log(f"  election {ticks} ticks in {t_elect:.3f} s; row {target} left "
        f"every other row's view within {spent[True]} ticks and was back "
        f"on every row within {spent[False]} more ({out['seconds']:.3f} "
        f"s); step host syncs {out['host_syncs_per_tick']:.3f}/tick "
        f"(election included), slab ticks {counts['slab_ticks']}, "
        f"dense-fallback ticks {counts['dense_fallback_ticks']}")
    check(int(sim.leader_mask(st).sum()) == 1, "not exactly one leader")
    check(_checksums_agree(sim, st), "checksums disagree")
    return out


def phase_lever_ab(torch, sim, st) -> dict:
    """64-tick chunks of the headline dense and with the bench's levers, in
    turns (dense, levers, levers, dense, twice), continuing one state.  A
    dense step carries active_ttl unchanged, and in steady state every row
    that the slab needs is hot by its role, so the two configs can share
    it.  The tick is host-bound, so the CUDA events around a chunk time
    the host's pace too; the device's busy time is profile_tick's."""
    cfgs = {"levers": sim.SimConfig(**HEADLINE),
            "dense": sim.SimConfig(**{**HEADLINE, **DENSE})}
    t = {k: {"host": [], "event": [], "committed": 0, "s": 0.0}
         for k in cfgs}
    for name in ("dense", "levers", "levers", "dense") * 2:
        st, h, e, c = _timed_ticks(torch, sim, cfgs[name], st, 64)
        t[name]["host"].append(h)
        t[name]["event"].append(e)
        t[name]["committed"] += c
        t[name]["s"] += h * 64 / 1e3
        log(f"  {name}: ms/tick (host) {h:.3f}, (events) {e:.3f}, "
            f"committed {c}")
    out = {}
    for name, v in t.items():
        out[name] = dict(host_ms=sum(v["host"]) / len(v["host"]),
                         event_ms=sum(v["event"]) / len(v["event"]),
                         entries_per_s=v["committed"] / v["s"])
    out["levers_over_dense_entries_per_s"] = \
        out["levers"]["entries_per_s"] / out["dense"]["entries_per_s"]
    out["levers_over_dense_event_ms"] = \
        out["levers"]["event_ms"] / out["dense"]["event_ms"]
    log(f"  levers/dense: entries/s "
        f"{out['levers_over_dense_entries_per_s']:.3f}x, CUDA-event ms/tick "
        f"{out['levers_over_dense_event_ms']:.3f}x")
    n_leaders = int(sim.leader_mask(st).sum())
    check(n_leaders == 1, f"after 4b: {n_leaders} leaders")
    check(_checksums_agree(sim, st), "after 4b: checksums disagree")
    out["state"] = st
    return out


class _BandCopies:
    """Within the block, append_band_copy goes through a wrapper that keeps
    a copy of the inputs of its calls (the first `keep`, of `rows` ring
    rows when given) and then calls the wrapper as ever, so its launch
    count is the path's own."""

    def __init__(self, cuda_ops, keep=None, rows=None) -> None:
        self.cuda_ops, self.keep, self.rows = cuda_ops, keep, rows
        self.calls = []

    def __enter__(self):
        launch = self.launch = self.cuda_ops.append_band_copy

        def record(lt, ld, off, s_t, s_d, w):
            if (self.keep is None or len(self.calls) < self.keep) and (
                    self.rows is None or lt.shape[0] == self.rows):
                self.calls.append((lt.clone(), ld.clone(), off, s_t.clone(),
                                   s_d.clone(), w.clone()))
            launch(lt, ld, off, s_t, s_d, w)
        self.cuda_ops.append_band_copy = record
        return self

    def __exit__(self, *exc):
        self.cuda_ops.append_band_copy = self.launch

    def err(self, torch) -> int:
        """max |kernel - plain| over the recorded calls, all `keep` of
        them recorded."""
        check(len(self.calls) == self.keep,
              f"{len(self.calls)} band-copy calls recorded, not {self.keep}")
        return max(_kernel_vs_plain(torch, self.cuda_ops, c)
                   for c in self.calls)


def _record_band_copies(torch, sim, cuda_ops, cfg, st, tick=None) -> list:
    """The band-copy calls of one more proposing tick (or of `tick()`),
    with their inputs as the tick gave them."""
    with _BandCopies(cuda_ops) as rec:
        if tick is None:
            sim.run_ticks(st, cfg, 1, prop_count=cfg.max_props)
        else:
            tick()
    torch.cuda.synchronize()
    check(len(rec.calls) > 0, "the recorded tick made no band-copy call")
    return rec.calls


def _kernel_vs_plain(torch, cuda_ops, call) -> int:
    """max |kernel - plain| of one recorded band-copy call."""
    lt, ld, off, s_t, s_d, w = call
    kt, kd, pt, pd = lt.clone(), ld.clone(), lt.clone(), ld.clone()
    cuda_ops.append_band_copy(kt, kd, off, s_t, s_d, w)
    cuda_ops.append_band_copy_plain(pt, pd, off, s_t, s_d, w)
    torch.cuda.synchronize()
    return max(int((kt.long() - pt.long()).abs().max()),
               int((kd.long() - pd.long()).abs().max()))


def phase_mailbox_inputs(torch, sim, cuda_ops, st) -> int:
    """The kernel against its plain version on one mailbox-path tick's
    calls; returns the largest |diff|."""
    calls = _record_band_copies(torch, sim, cuda_ops,
                                sim.SimConfig(**MAILBOX_PATH), st)
    err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
    log(f"  {len(calls)} band-copy calls of one mailbox tick (chunks "
        f"{[c[2] for c in calls]}, {sum(int(c[5].sum()) for c in calls)} "
        f"slots written): max|kernel - plain| = {err}")
    check(err == 0, f"kernel != plain on the mailbox path's inputs ({err})")
    return err


def phase_main_path_inputs(torch, sim, cuda_ops, st) -> dict:
    """Time the kernel on the inputs one more headline tick gives it."""
    calls = _record_band_copies(torch, sim, cuda_ops,
                                sim.SimConfig(**HEADLINE), st)
    out = _time_band_copies(torch, cuda_ops, calls)
    check(out["err"] == 0,
          f"kernel != plain on the main path's inputs ({out['err']})")
    return out


def _time_band_copies(torch, cuda_ops, calls) -> dict:
    """Kernel, plain version and torch.where x2 (a yardstick the port never
    calls) timed on recorded band-copy calls (device time from CUDA-graph
    replay), against the bytes bound; the means over the calls, and the
    largest |kernel - plain|."""
    launch = cuda_ops.append_band_copy
    err = 0
    times = {"kernel": [], "plain": [], "library": []}
    bound = []
    for call in calls:
        lt, ld, off, s_t, s_d, w = call
        c = w.shape[1]
        err = max(err, _kernel_vs_plain(torch, cuda_ops, call))
        kt, kd = lt.clone(), ld.clone()
        pt, pd = lt.clone(), ld.clone()
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
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(calls=len(calls), err=err, ms=mean(times["kernel"]),
                plain_ms=mean(times["plain"]),
                library_ms=mean(times["library"]), bound_ms=mean(bound))


def _profiled_turns(torch, sim, cfgs: dict, st,
                    ticks: int = PROFILED_TICKS):
    """Kernel launches and kernel ms per tick of each config in `cfgs`, in
    turns (first, second, second, first) from one state; every config
    leaves the other's extra registers as they stand."""
    names = list(cfgs)
    out = {k: {"launches": [], "kernel_ms": []} for k in names}
    for name in (names[0], names[1], names[1], names[0]):
        st, per_tick, kms = _device_window(torch, sim, cfgs[name], st, ticks)
        out[name]["launches"].append(per_tick)
        out[name]["kernel_ms"].append(kms)
    return st, {k: {m: sum(v) / len(v) for m, v in d.items()}
                for k, d in out.items()}


def _linearizable(st) -> bool:
    return bool((st.read_srv_idx >= st.read_srv_goal).all())


def phase_readmix(torch, sim, cuda_ops) -> dict:
    """bench.py's 256-readmix-99to1 at its published width: the chunked
    election, 2 x 64 timed ticks, then the read path's cost in turns with
    the same shape at read_batch=0 (host and CUDA-event ms over 32-tick
    chunks, kernel launches and ms over 4 profiled ticks), and the band
    copy against its plain version on one more tick's calls."""
    cfg = sim.SimConfig(**READMIX)
    off = sim.SimConfig(**{**READMIX, "read_batch": 0})
    check(cfg.tiled and cfg.active_rows_on and not cfg.peer_tiled,
          "the read mix runs the tiled log and the slab, one-pass counts")
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    st, ticks, t_elect = _elect(torch, sim, cfg, "n=256 read mix")
    sim.kernel.reset_counts()
    reads0 = int(sim.reads_served(st))
    host_ms, event_ms, committed, t_run = [], [], 0, 0.0
    for _ in range(2):
        st, h, e, c = _timed_ticks(torch, sim, cfg, st, 64)
        host_ms.append(h)
        event_ms.append(e)
        committed += c
        t_run += h * 64 / 1e3
    reads = int(sim.reads_served(st)) - reads0
    counts = dict(sim.kernel.COUNTS)
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    entries_s, reads_s = committed / t_run, reads / t_run
    syncs = counts["host_syncs"] / 128
    n_leaders = int(sim.leader_mask(st).sum())
    agree, lin = _checksums_agree(sim, st), _linearizable(st)
    blocked = int(sim.reads_blocked(st))
    log(f"  election: {ticks} ticks, {t_elect:.3f} s; run_ticks 2x64: "
        f"ms/tick (host clock) {host_ms[0]:.3f} / {host_ms[1]:.3f}, (CUDA "
        f"events) {event_ms[0]:.3f} / {event_ms[1]:.3f}")
    log(f"  committed {committed} entries, {entries_s:.1f} entries/s; "
        f"served {reads} reads, {reads_s:.1f} reads/s, "
        f"{reads_s / entries_s:.2f}x entries/s; reads blocked {blocked}")
    log(f"  steady 128 ticks: step host syncs {syncs:.3f}/tick, slab ticks "
        f"{counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}; append_band_copy launches "
        f"{launches} over {ticks + 128} ticks")
    turns = {"reads_off": [], "reads_on": []}
    for name in ("reads_off", "reads_on", "reads_on", "reads_off"):
        st, h, e, _ = _timed_ticks(torch, sim, off if name == "reads_off"
                                   else cfg, st, 32)
        turns[name].append((h, e))
    ab = {k: dict(host_ms=sum(x[0] for x in v) / 2,
                  event_ms=sum(x[1] for x in v) / 2)
          for k, v in turns.items()}
    st, prof = _profiled_turns(torch, sim, {"reads_off": off,
                                            "reads_on": cfg}, st)
    for k in ab:
        ab[k].update(prof[k])
        log(f"  {k}: ms/tick (host) {ab[k]['host_ms']:.3f}, (events) "
            f"{ab[k]['event_ms']:.3f}; {ab[k]['launches']:.1f} kernel "
            f"launches/tick, {ab[k]['kernel_ms']:.3f} ms of kernels/tick")
    calls = _record_band_copies(torch, sim, cuda_ops, cfg, st)
    err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
    log(f"  {len(calls)} band-copy calls of one read-mix tick: "
        f"max|kernel - plain| = {err}")
    check(n_leaders == 1, f"expected exactly one leader, got {n_leaders}")
    check(committed > 0, "commit did not advance")
    check(agree, "rows with equal applied disagree on apply_chk")
    check(lin, "a served read batch missed its linearizability goal")
    check(reads_s >= 10 * entries_s,
          f"{reads_s:.0f} reads/s < 10x {entries_s:.0f} entries/s")
    check(syncs <= 1.0, f"{syncs} step host syncs per steady tick")
    check(launches > 0, "the read mix never launched append_band_copy")
    check(err == 0, f"kernel != plain on the read mix's inputs ({err})")
    return dict(election_ticks=ticks, election_s=t_elect,
                ms_per_tick=host_ms, event_ms_per_tick=event_ms,
                entries_per_s=entries_s, reads_per_s=reads_s,
                read_write_ratio=reads_s / entries_s, reads_blocked=blocked,
                host_syncs_per_tick=syncs, band_copy_launches=launches,
                slab_ticks=counts["slab_ticks"],
                dense_fallback_ticks=counts["dense_fallback_ticks"],
                reads_ab=ab, err=err)


def phase_readmix_headline_width(torch, sim, cuda_ops) -> dict:
    """The read path at the headline's width and levers (n=4096, banded
    counts of 1024, the [16, N] slab) with 99 reads offered per entry
    (read_batch 49): election, 64 timed ticks, then kernel launches per
    tick in turns with the reads-off headline."""
    cfg = sim.SimConfig(**{**HEADLINE, "read_batch": 99 * 2048 // 4096})
    check(cfg.peer_tiled and cfg.active_rows_on,
          "n=4096 runs banded counts and the slab")
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    st, ticks, t_elect = _elect(torch, sim, cfg, "n=4096 reads")
    elect_counts = dict(sim.kernel.COUNTS)
    reads0 = int(sim.reads_served(st))
    st, h, e, c = _timed_ticks(torch, sim, cfg, st, 64)
    reads = int(sim.reads_served(st)) - reads0
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    t_run = h * 64 / 1e3
    st, prof = _profiled_turns(torch, sim, {"reads_off": sim.SimConfig(
        **HEADLINE), "reads_on": cfg}, st)
    log(f"  election {ticks} ticks ({elect_counts['dense_fallback_ticks']} "
        f"on the dense fallback, banded counts), {t_elect:.3f} s; 64 ticks: "
        f"ms/tick (host) {h:.3f}, (events) {e:.3f}; {c / t_run:.1f} "
        f"entries/s, {reads / t_run:.1f} reads/s; kernel launches/tick "
        f"reads off {prof['reads_off']['launches']:.1f}, on "
        f"{prof['reads_on']['launches']:.1f}; kernel ms/tick off "
        f"{prof['reads_off']['kernel_ms']:.3f}, on "
        f"{prof['reads_on']['kernel_ms']:.3f}; band-copy launches "
        f"{launches}")
    check(int(sim.leader_mask(st).sum()) == 1, "not exactly one leader")
    check(_linearizable(st), "a served read missed its goal")
    check(reads > 0 and launches > 0, "no reads served or no band copy")
    check(elect_counts["dense_fallback_ticks"] > 0,
          "the election never ran the banded count on the dense rows")
    return dict(election_ticks=ticks, election_s=t_elect, ms_per_tick=h,
                event_ms_per_tick=e, entries_per_s=c / t_run,
                reads_per_s=reads / t_run, band_copy_launches=launches,
                election_counts=elect_counts, profile=prof)


def phase_fsyncgate(torch, sim, cuda_ops) -> dict:
    """bench.py's 256-fsyncgate at its published width: one state bare and
    one with the storage model (fsync every 4 ticks, ack gating), each
    elected, then 64-tick chunks in turns (bare, gated, gated, bare).
    Checks the durability reductions after every gated chunk."""
    cfgs = {"bare": sim.SimConfig(**FSYNCGATE),
            "gated": sim.SimConfig(**{**FSYNCGATE, **STORAGE})}
    cuda_ops.reset_launches()
    states, res = {}, {}
    for name, cfg in cfgs.items():
        states[name], ticks, t_elect = _elect(torch, sim, cfg,
                                              f"n=256 fsyncgate {name}")
        res[name] = dict(election_ticks=ticks, election_s=t_elect,
                         host_ms=[], event_ms=[], committed=0, s=0.0)
    dur = states["gated"].dur_commit.clone()
    for name in ("bare", "gated", "gated", "bare"):
        st, h, e, c = _timed_ticks(torch, sim, cfgs[name], states[name], 64)
        states[name] = st
        r = res[name]
        r["host_ms"].append(h)
        r["event_ms"].append(e)
        r["committed"] += c
        r["s"] += h * 64 / 1e3
        if name == "gated":
            check(bool((st.dur_commit >= dur).all()), "dur_commit fell")
            dur = st.dur_commit.clone()
            check(int(st.ack_frontier.max()) <= int(st.last.max()),
                  "an acked commit lies above every log's last")
            check(bool((st.sync_mark >= st.snap_idx).all()),
                  "sync_mark below snap_idx")
        log(f"  {name}: ms/tick (host) {h:.3f}, (events) {e:.3f}, "
            f"committed {c}")
    launches = cuda_ops.LAUNCHES["append_band_copy"]
    for name, st in states.items():
        res[name]["entries_per_s"] = res[name]["committed"] / res[name]["s"]
        check(int(sim.leader_mask(st).sum()) == 1,
              f"{name}: not exactly one leader")
        check(_checksums_agree(sim, st), f"{name}: checksums disagree")
    ratio = res["gated"]["entries_per_s"] / res["bare"]["entries_per_s"]
    g = states["gated"]
    log(f"  bare {res['bare']['entries_per_s']:.1f} vs gated "
        f"{res['gated']['entries_per_s']:.1f} entries/s: gated_over_dense "
        f"{ratio:.3f}; gated sync_mark min/max {int(g.sync_mark.min())}/"
        f"{int(g.sync_mark.max())}, dur_commit max {int(g.dur_commit.max())}"
        f", ack_frontier max {int(g.ack_frontier.max())}; band-copy "
        f"launches {launches}")
    if ratio < 0.8:
        log(f"  note: bench.py's storage tripwire (gated < 0.8x bare) "
            f"would trip: {ratio:.3f}")
    check(launches > 0, "the fsync-gate path never launched the band copy")
    return dict(res, gated_over_dense=ratio, band_copy_launches=launches)


def _full_pass_ticks(cfg, launches: int, ticks: int, label: str) -> int:
    """How many of `ticks` ticks wrote the ring in one full pass: a banded
    tick launches the band copy once per band chunk, a full-pass tick once
    over the whole ring.  Fails unless the launches are such a mix."""
    bc = cfg.band_chunks
    full_pass, rem = divmod(bc * ticks - launches, bc - 1)
    check(rem == 0 and 0 <= full_pass <= ticks,
          f"{label}: {launches} launches in {ticks} ticks is not a mix of "
          f"banded ({bc} launches) and full-pass (1 launch) ticks")
    return full_pass


def _counted_window(torch, sim, cuda_ops, cfg, st, ticks: int, label: str):
    """_device_window with this window's own counts: (state, dict of kernel
    launches and ms per tick, band-copy launches, full-pass ring-write
    ticks, slab and dense-fallback ticks, and the kernel records and aten
    ops by name)."""
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    st, per_tick, kms, kernels, ops = _device_window(torch, sim, cfg, st,
                                                     ticks, by_name=True)
    bc = cuda_ops.LAUNCHES["append_band_copy"]
    counts = dict(sim.kernel.COUNTS)
    out = dict(launches=per_tick, kernel_ms=kms, band_copy=bc,
               full_pass=_full_pass_ticks(cfg, bc, ticks, label),
               slab=counts["slab_ticks"],
               fallback=counts["dense_fallback_ticks"],
               kernels=kernels, ops=ops)
    log(f"  {label}: {per_tick:.2f} kernel launches/tick, {kms:.3f} ms of "
        f"kernels/tick; band copy {bc} launches ({out['full_pass']} "
        f"full-pass ticks), slab ticks {out['slab']}, dense-fallback ticks "
        f"{out['fallback']}")
    return st, out


def phase_planes_headline(torch, sim, cuda_ops) -> dict:
    """The three device observability planes at the headline's full width
    and levers (n=4096, banded counts of 1024, the [16, N] slab, the
    default 128-deep event ring), in turns with the same shape planes-off.
    Each is elected, then profiled for 4 ticks of each in turns (off, on,
    on, off): kernel launches and ms per tick, with each window's band-copy
    launches, full-pass and fallback ticks; the two windows of a config
    are compared by the aten ops the host called and by the kernel records
    the profiler kept.  Then 4 off/on pairs of 32-tick run_ticks chunks in
    turns (host ms/tick: the median pair ratio and its spread); every
    planes-on chunk runs inside a tracer span whose span_trace_tag tags its
    proposes, with a ClockSync sample after it.  The band-copy launches of
    each config's 128 timed ticks are counted apart.  Then the p50/p99 from
    summarize_state against percentile_edge_device, the event rings of all
    rows decoded, KernelObs and TelemetryObs published into a registry and
    rendered, a capture of rows 0-255 exported as a Chrome trace (checked
    by validate_chrome_trace, with flow events; all 4096 rows would make a
    JSON of half a million events), and the band copy against plain on one
    planes-on tick's calls."""
    import statistics
    import tempfile

    from swarmkit_tpu_torch import flightrec, telemetry
    from swarmkit_tpu_torch.metrics import exposition
    from swarmkit_tpu_torch.metrics import trace as mtrace
    from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
    from swarmkit_tpu_torch.telemetry.series import percentile_edge_device

    chunk, export_rows = 32, 256
    cfgs = {"off": sim.SimConfig(**HEADLINE),
            "on": sim.SimConfig(**HEADLINE, **PLANES)}
    check(cfgs["on"].peer_tiled and cfgs["on"].active_rows_on,
          "the headline runs banded counts and the slab")
    states, res, windows = {}, {}, {"off": [], "on": []}
    for name, cfg in cfgs.items():
        states[name], ticks, t_elect = _elect(torch, sim, cfg,
                                              f"n=4096 planes {name}")
        res[name] = dict(election_ticks=ticks, election_s=t_elect,
                         host_ms=[], event_ms=[], committed=0, s=0.0,
                         host_syncs=0, band_copy=0, slab=0, fallback=0,
                         launches=[], kernel_ms=[])
    for name in ("off", "on", "on", "off"):
        states[name], w = _counted_window(
            torch, sim, cuda_ops, cfgs[name], states[name], PROFILED_TICKS,
            f"planes {name}, {PROFILED_TICKS} profiled ticks")
        res[name]["launches"].append(w["launches"])
        res[name]["kernel_ms"].append(w["kernel_ms"])
        windows[name].append(w)
    for name, (a, b) in windows.items():
        # what the two windows of one config differ in: the aten ops the
        # host called, or only the kernel records the profiler kept
        differ = {k: (a["kernels"].get(k, 0), b["kernels"].get(k, 0))
                  for k in a["kernels"].keys() | b["kernels"].keys()
                  if a["kernels"].get(k, 0) != b["kernels"].get(k, 0)}
        same_ops = a["ops"] == b["ops"]
        res[name]["windows_same_aten_ops"] = same_ops
        res[name]["windows_kernel_records_differ"] = [
            [k[:80], x, y] for k, (x, y) in sorted(differ.items())]
        log(f"  planes {name}, its two profiled windows: "
            f"{'the same' if same_ops else 'different'} aten ops "
            f"({sum(a['ops'].values())} / {sum(b['ops'].values())} calls); "
            f"kernel records that differ: "
            + ("; ".join(f"{k} {x} / {y}" for k, x, y
                         in res[name]["windows_kernel_records_differ"])
               or "none"))
    tracer, clock = mtrace.Tracer(), flightrec.ClockSync()
    sim.sync_point(clock, states["on"])
    order = ("off", "on", "on", "off") * 2     # 4 pairs, one of each
    for i, name in enumerate(order):
        cuda_ops.reset_launches()
        sim.kernel.reset_counts()
        if name == "on":
            with tracer.span("raft.propose", chunk=i) as span:
                tag = mtrace.span_trace_tag(span)
                span.set(trace_tag=tag)
                st, h, e, c = _timed_ticks(torch, sim, cfgs[name],
                                           states[name], chunk, prop_tag=tag)
            sim.sync_point(clock, st)
        else:
            st, h, e, c = _timed_ticks(torch, sim, cfgs[name], states[name],
                                       chunk)
        states[name] = st
        r, counts = res[name], dict(sim.kernel.COUNTS)
        r["host_ms"].append(h)
        r["event_ms"].append(e)
        r["committed"] += c
        r["s"] += h * chunk / 1e3
        r["host_syncs"] += counts["host_syncs"]
        r["slab"] += counts["slab_ticks"]
        r["fallback"] += counts["dense_fallback_ticks"]
        r["band_copy"] += cuda_ops.LAUNCHES["append_band_copy"]
        log(f"  {name}: ms/tick (host) {h:.3f}, (events) {e:.3f}, "
            f"committed {c}, step host syncs "
            f"{counts['host_syncs'] / chunk:.3f}/tick")
    pairs = [res["on"]["host_ms"][k] / res["off"]["host_ms"][k]
             for k in range(len(order) // 2)]
    timed = chunk * len(order) // 2
    for name, r in res.items():
        r["host_ms_chunks"] = r["host_ms"]
        r["entries_per_s"] = r["committed"] / r["s"]
        r["host_syncs_per_tick"] = r["host_syncs"] / timed
        r["full_pass"] = _full_pass_ticks(cfgs[name], r["band_copy"], timed,
                                          f"planes {name}, timed ticks")
        for k in ("host_ms", "event_ms", "launches", "kernel_ms"):
            r[k] = sum(r[k]) / len(r[k])
        check(int(sim.leader_mask(states[name]).sum()) == 1,
              f"planes {name}: not exactly one leader")
        check(_checksums_agree(sim, states[name]),
              f"planes {name}: checksums disagree")
        log(f"  planes {name}: {r['entries_per_s']:.1f} entries/s, "
            f"{r['host_ms']:.3f} host ms/tick, {r['launches']:.2f} kernel "
            f"launches/tick, {r['kernel_ms']:.3f} ms of kernels/tick, "
            f"{r['host_syncs_per_tick']:.3f} step host syncs/tick; "
            f"{timed} timed ticks: band copy {r['band_copy']} launches "
            f"({r['full_pass']} full-pass ticks), slab ticks {r['slab']}, "
            f"dense-fallback ticks {r['fallback']}")
    on, off = res["on"], res["off"]
    ratios = dict(host_ms_pairs=pairs,
                  host_ms_median=statistics.median(pairs),
                  host_ms_min=min(pairs), host_ms_max=max(pairs),
                  launches=on["launches"] / off["launches"],
                  entries_per_s=on["entries_per_s"] / off["entries_per_s"])
    log(f"  on / off: host ms/tick median {ratios['host_ms_median']:.3f}x "
        f"over {len(pairs)} pairs (min {ratios['host_ms_min']:.3f}, max "
        f"{ratios['host_ms_max']:.3f}: "
        f"{', '.join(f'{p:.3f}' for p in pairs)}), launches/tick "
        f"{ratios['launches']:.3f}x, entries/s {ratios['entries_per_s']:.3f}x;"
        f" planes-off launches/tick {off['launches']:.2f} against 1393.25")

    st, cfg = states["on"], cfgs["on"]
    reg = MetricsRegistry()
    kstats = sim.KernelObs(reg, clock_sync=clock).publish(st)
    summary = telemetry.TelemetryObs(reg).publish(st, cfg)
    device_q = {}
    for short, field in (("commit", "tel_commit_hist"),
                         ("election", "tel_elect_hist")):
        for q in (50, 99):
            dev_edge = int(percentile_edge_device(getattr(st, field), q))
            device_q[f"{short}_p{q}"] = dev_edge
            check(summary[short][f"p{q}"] == min(dev_edge, 256),
                  f"{short} p{q}: summarize_state "
                  f"{summary[short][f'p{q}']} != device {dev_edge}")
    t0 = time.perf_counter()
    events, dropped = flightrec.decode_state(st)
    t_decode = time.perf_counter() - t0
    tagged = [e for e in events if e.tag]
    fit = clock.fit()
    text = exposition.render_all(reg, tracer=tracer)
    families = sum(line.startswith("# TYPE ") for line in text.splitlines())
    part = dataclasses.replace(st, ev_buf=st.ev_buf[:export_rows],
                               ev_pos=st.ev_pos[:export_rows])
    t0 = time.perf_counter()
    rec = flightrec.capture(part, trigger="manual", tracer=tracer, cfg=cfg,
                            clock=clock, obs=reg,
                            meta={"rows": f"0-{export_rows - 1} of {cfg.n}"})
    with tempfile.TemporaryDirectory() as tmp:
        trace = flightrec.export_record(rec, f"{tmp}/planes.json")
    problems = flightrec.validate_chrome_trace(trace)
    t_export = time.perf_counter() - t0
    flows = sum(e["ph"] in ("s", "t", "f") for e in trace["traceEvents"])
    log(f"  p50/p99 in ticks (summarize_state = percentile_edge_device): "
        f"commit {summary['commit']['p50']}/{summary['commit']['p99']}, "
        f"election {summary['election']['p50']}/"
        f"{summary['election']['p99']}; commit histogram "
        f"{summary['commit']['counts']}")
    log(f"  events: {len(events)} in the {cfg.event_ring}-deep rings of "
        f"{cfg.n} rows (decoded in {t_decode:.2f} s), {int(dropped.sum())} "
        f"overwritten, {sum(e.name == 'COMMIT_ADVANCE' for e in tagged)} "
        f"tagged COMMIT_ADVANCE; clock fit {fit.to_dict()}")
    log(f"  KernelObs {kstats}; exposition: {families} families, "
        f"{len(text)} bytes; Chrome trace of rows 0-{export_rows - 1}: "
        f"{len(trace['traceEvents'])} events, {flows} flow events, "
        f"problems {problems} (capture, export and check {t_export:.2f} s)")
    calls = _record_band_copies(torch, sim, cuda_ops, cfg, st)
    err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
    log(f"  {len(calls)} band-copy calls of one planes-on tick: max|kernel - "
        f"plain| = {err}")
    check(on["host_syncs_per_tick"] == 1.0 and off["host_syncs_per_tick"]
          == 1.0, "not one step host sync per steady tick")
    check(summary["commit"]["total"] > 0 and summary["election"]["total"]
          > 0, "empty latency histograms")
    check(any(e.name == "COMMIT_ADVANCE" for e in tagged),
          "no tagged COMMIT_ADVANCE in the rings")
    check(fit is not None and not fit.degenerate, "no clock fit")
    check(problems == [] and flows > 0,
          f"the Chrome trace: {problems}, {flows} flow events")
    check(err == 0, f"kernel != plain on the planes path's inputs ({err})")
    check(on["band_copy"] > 0, "the planes path never launched the band copy")
    return dict(res, ratios=ratios, quantiles=device_q, kernel_stats=kstats,
                events=len(events), dropped=int(dropped.sum()),
                tagged_commits=sum(e.name == "COMMIT_ADVANCE"
                                   for e in tagged),
                clock_fit=fit.to_dict(), families=families,
                decode_s=t_decode, export_s=t_export,
                trace_events=len(trace["traceEvents"]), flow_events=flows,
                band_copy_launches=on["band_copy"], err=err)


# the DST sweep's configuration for phase 13's storage batch: fsync every 4
# ticks with ack gating, telemetry and the SLO bounds
DST_STORAGE = dict(fsync_lag_ticks=4, ack_gating=True, collect_telemetry=True,
                   slo_p99_commit_ticks=32, slo_leader_changes=6,
                   slo_log_occupancy=40, slo_fsync_lag=40)
DST_TICKS = 100
DST_WIDE = 16384      # the sweep's width at scale
DEMO_TICKS = 80       # the rejoin, transfer-abuse and lost-tail demos


def _dst_card_vs_cpu(torch, sim, dst, cfg, schedules: int, profiles,
                     label: str, card: str) -> dict:
    """explore on the card and on the CPU, each drawing its own batch:
    the schedules, viol, first_tick, bits_by_tick and every final field
    must be equal."""
    import numpy as np

    runs = []
    for d in (card, "cpu"):
        sched, names = dst.make_batch(cfg, DST_TICKS, schedules, seed=0,
                                      profiles=profiles, device=d)
        t0 = time.perf_counter()
        res = dst.explore(sim.init_state(cfg, device=d), cfg, sched,
                          profiles=names, device=d)
        runs.append((sched.to_numpy(), res, time.perf_counter() - t0))
    (sc, rc, tc), (sp, rp, tp) = runs
    check(sorted(sc) == sorted(sp) and all(np.array_equal(sc[k], sp[k])
                                           for k in sp),
          f"{label}: the card drew other schedules than the CPU")
    check(np.array_equal(rc.viol, rp.viol)
          and np.array_equal(rc.first_tick, rp.first_tick)
          and np.array_equal(rc.bits_by_tick, rp.bits_by_tick),
          f"{label}: violation masks differ between card and CPU")
    got = sim.state_to_numpy(rc.final_state)
    want = sim.state_to_numpy(rp.final_state)
    check(sorted(got) == sorted(want), f"{label}: final field sets differ")
    for name in want:
        check(np.array_equal(got[name], want[name]),
              f"{label}: final field {name} differs between card and CPU")
    log(f"  {label}, {schedules} x {DST_TICKS}: card = CPU on the schedules,"
        f" viol, first_tick, bits_by_tick and all {len(want)} final fields;"
        f" {len(rc.violating)} violating; explore {tc:.3f} s on the card, "
        f"{tp:.3f} s on the CPU")
    return dict(schedules=schedules, fields=len(want),
                violating=int(len(rc.violating)), card_s=tc, cpu_s=tp)


def phase_dst(torch, sim, cuda_ops, outdir: str,
              card: str = "cuda") -> dict:
    """The DST sweep on the batched tick (swarmkit_tpu_torch/dst/): card =
    CPU at 64 x 100 (PROFILES, reads 2) and 32 x 100 (EXTRA_PROFILES, the
    storage configuration); the documented 256 x 100 sweep (0 violations;
    schedules/s, step host syncs a tick, launches a tick over 8 profiled
    ticks and the device busy share against 8 unprofiled ticks); 16384 x
    100 (schedules/s); both mutation self-tests at 24 x 100 (caught,
    shrunk, artifact replayed on the card and on the CPU); the four demos
    (neutralized; three at DEMO_TICKS ticks).  The commit_no_quorum and
    lost-tail artifacts are written to `outdir`, which the caller makes
    and removes, and their paths returned under "artifacts"."""
    import importlib

    from swarmkit_tpu_torch import dst
    from swarmkit_tpu_torch.tools import dst_sweep
    from swarmkit_tpu_torch.tools.profile_tick import _device_us

    dexp = importlib.import_module("swarmkit_tpu_torch.dst.explore")
    dev = torch.device(card)
    cfg = dst_sweep._cfg(5, 0, reads=2)
    out = {"card_vs_cpu": [
        _dst_card_vs_cpu(torch, sim, dst, cfg, 64, dst.PROFILES,
                         "PROFILES", card),
        _dst_card_vs_cpu(torch, sim, dst,
                         dataclasses.replace(cfg, **DST_STORAGE), 32,
                         dst.EXTRA_PROFILES, "EXTRA_PROFILES, storage",
                         card)]}

    # the documented sweep: 256 x 100 on PROFILES; its ring write is one
    # band-copy launch a tick over the [256*5, 64] rows
    sim.kernel.reset_counts()
    cuda_ops.reset_launches()
    sweep = dst_sweep.run_sweep(256, DST_TICKS, 0, 5, 2, dst.PROFILES,
                                reads=2, verbose=False, device=dev)
    launched = cuda_ops.LAUNCHES["append_band_copy"]
    res = sweep["_result"]
    syncs = sim.kernel.COUNTS["host_syncs"] / DST_TICKS
    check(sweep["violations"] == 0,
          f"the stock sweep found {sweep['violations']} violations")
    check(syncs == 0, f"{syncs} step host syncs a sweep tick")
    check(launched == DST_TICKS,
          f"the sweep launched append_band_copy {launched} times in "
          f"{DST_TICKS} ticks")
    # 8 unprofiled ticks (CUDA events), then 8 profiled ones, from tick 20
    sched = sweep["_batch"]
    st = sim.broadcast_state(sim.init_state(cfg, device=dev), 256)
    for t in range(20):
        st, _ = dexp._tick_one(st, cfg, sched.at_tick(t), 2, None, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for t in range(20, 28):
        st, _ = dexp._tick_one(st, cfg, sched.at_tick(t), 2, None, dev)
    end.record()
    torch.cuda.synchronize()
    tick_ms = start.elapsed_time(end) / 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(28, 36):
            st, _ = dexp._tick_one(st, cfg, sched.at_tick(t), 2, None, dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in kernels) / 8
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3 / 8
    # the kernel against its plain version on one more sweep tick's call
    box = {}

    def sweep_tick():
        box["st"], _ = dexp._tick_one(st, cfg, sched.at_tick(36), 2, None,
                                      dev)
    calls = _record_band_copies(torch, sim, cuda_ops, cfg, st, sweep_tick)
    err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
    rows = tuple(calls[0][0].shape)
    check(err == 0, f"kernel != plain on a sweep tick's inputs ({err})")
    out["sweep_256"] = dict(
        schedules_per_s=res.schedules_per_sec, explore_s=res.elapsed,
        violations=sweep["violations"], host_syncs_per_tick=syncs,
        band_copy_launches=launched, launches_per_tick=launches,
        kernel_ms_per_tick=kernel_ms, tick_ms=tick_ms,
        busy_share=kernel_ms / tick_ms, band_copy_rows=list(rows),
        err=err)
    log(f"  256 x {DST_TICKS} (PROFILES, reads 2): 0 violations, "
        f"{res.schedules_per_sec:.1f} schedules/s ({res.elapsed:.3f} s of "
        f"explore), step host syncs {syncs:.2f}/tick, append_band_copy "
        f"launches {launched}; 8 profiled ticks: "
        f"{launches:.2f} kernel launches/tick, {kernel_ms:.3f} ms of "
        f"kernels/tick against {tick_ms:.3f} ms/tick unprofiled (CUDA "
        f"events): busy share {kernel_ms / tick_ms:.3f}; {len(calls)} "
        f"band-copy call of one sweep tick on {list(rows)} rings: "
        f"max|kernel - plain| = {err}")

    # the sweep's width at scale
    torch.cuda.reset_peak_memory_stats()
    sim.kernel.reset_counts()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    wide = dst_sweep.run_sweep(DST_WIDE, DST_TICKS, 0, 5, 2, dst.PROFILES,
                               reads=2, verbose=False, device=dev)
    wide_s = time.perf_counter() - t0
    wide_launched = cuda_ops.LAUNCHES["append_band_copy"]
    check(wide_launched == DST_TICKS,
          f"the wide sweep launched append_band_copy {wide_launched} times")
    wres = wide["_result"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    wsyncs = sim.kernel.COUNTS["host_syncs"] / DST_TICKS
    check(wsyncs == 0, f"{wsyncs} step host syncs a tick at S={DST_WIDE}")
    out["sweep_wide"] = dict(schedules=DST_WIDE,
        schedules_per_s=wres.schedules_per_sec, explore_s=wres.elapsed,
        with_generation_s=wide_s, violations=wide["violations"],
        peak_gib=peak, host_syncs_per_tick=wsyncs,
        band_copy_launches=wide_launched)
    log(f"  {DST_WIDE} x {DST_TICKS}: {wres.schedules_per_sec:.1f} "
        f"schedules/s "
        f"({wres.elapsed:.3f} s of explore; {wide_s:.3f} s with the "
        f"schedules' generation), {wide['violations']} violations, step "
        f"host syncs {wsyncs:.2f}/tick, peak device memory {peak:.3f} GiB, "
        f"append_band_copy launches {wide_launched}")

    out["mutations"] = {}
    for mutation in ("commit_no_quorum", "stale_lease_read"):
        demo = dst_sweep.run_mutation_demo(
            24, DST_TICKS, 0, 5, 2, mutation, verbose=False,
            out_path=f"{outdir}/{mutation}.json", device=dev)
        check(demo["caught"], f"mutation {mutation} was not caught")
        check(demo["replay_matches"],
              f"{mutation}: the card's artifact did not replay exactly "
              f"on the card")
        on_cpu = dst.replay_artifact(demo["artifact"], device="cpu")
        check(on_cpu["matches_recorded"],
              f"{mutation}: the card's artifact replayed on the CPU to "
              f"{on_cpu['violations']} at tick {on_cpu['first_tick']}")
        out["mutations"][mutation] = {
            k: demo[k] for k in ("violations", "profile", "index", "bits",
                                 "fault_count_before",
                                 "fault_count_after", "shrink_evals",
                                 "shrink_batches", "shrink_ticks",
                                 "shrink_s", "first_tick")}
        log(f"  mutation {mutation}: caught in {demo['violations']} of "
            f"24 ({demo['bits']}, {demo['profile']} #{demo['index']}); "
            f"shrunk {demo['fault_count_before']} -> "
            f"{demo['fault_count_after']} fault-events in "
            f"{demo['shrink_s']:.3f} s: {demo['shrink_evals']} evals in "
            f"{demo['shrink_batches']} batched replays of "
            f"{demo['shrink_ticks']} ticks in all; the artifact "
            f"replays exactly on the card and on the CPU (first tick "
            f"{demo['first_tick']})")
    demos = {
        "term_inflation": dst_sweep.run_term_inflation_demo(device=dev),
        "disruptive_rejoin": dst_sweep.run_disruptive_rejoin_demo(
            ticks=DEMO_TICKS, device=dev),
        "transfer_abuse": dst_sweep.run_transfer_abuse_demo(
            ticks=DEMO_TICKS, device=dev),
        "lost_tail": dst_sweep.run_lost_tail_demo(
            ticks=DEMO_TICKS, out_path=f"{outdir}/lost_tail.json",
            device=dev)}
    out["artifacts"] = {"commit_no_quorum": f"{outdir}/commit_no_quorum.json",
                        "lost_tail": f"{outdir}/lost_tail.json"}
    for name, demo in demos.items():
        check(demo["neutralized"], f"the {name} demo was not neutralized")
    out["demos"] = {k: {kk: v for kk, v in d.items() if kk != "artifact"}
                    for k, d in demos.items()}
    log("  the four demos neutralized")
    return out


def _oracle_replay(torch, dst, path: str, device: str):
    """The oracle trace of an artifact as replay_artifact takes it (the
    clean prefix of an adversary-induced safety violation), on `device`:
    (trace, {"ticks", "reads"}, seconds)."""
    art = dst.load_artifact(path)
    cfg, sched, prop_count, mutation = dst.from_artifact(art, device=device)
    first = art["first_tick"]
    until = first if (mutation is None and art["violation_bits"]
                      & dst.SAFETY_BITS and first >= 0) else None
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = dst.oracle_trace(cfg, sched, prop_count, mutation, until=until,
                             device=device, info=info)
    torch.cuda.synchronize()
    return trace, info, time.perf_counter() - t0


def phase_oracle(torch, dst, dst13: dict, card: str = "cuda") -> dict:
    """oracle_trace on the card: phase 13's commit_no_quorum artifact (the
    same diverged_at, first fields and both sides' values as the CPU
    replay) and its lost-tail artifact (lockstep over the clean prefix,
    diverged_at -1), with the ticks replayed, host reads and seconds."""
    out = {}
    for name, path in dst13["artifacts"].items():
        got, info, secs = _oracle_replay(torch, dst, path, card)
        want, cinfo, csecs = _oracle_replay(torch, dst, path, "cpu")
        check(json.dumps(got, sort_keys=True)
              == json.dumps(want, sort_keys=True),
              f"{name}: the card's oracle trace differs from the CPU's "
              f"(diverged at {got['diverged_at']} vs {want['diverged_at']})")
        if name == "commit_no_quorum":
            check(got["diverged_at"] >= 0 and got["trace"],
                  "commit_no_quorum: the oracle trace did not localize the "
                  "mutated commit path")
            first = got["trace"][0]
            detail = (f"diverged at tick {got['diverged_at']} on "
                      f"{first['fields']} (card = CPU, values included: "
                      f"{ {f: first['kernel'][f] for f in first['fields']} }"
                      f" against the oracle's "
                      f"{ {f: first['oracle'][f] for f in first['fields']} })")
        else:
            check(got["diverged_at"] == -1,
                  f"lost_tail: the oracle diverged at tick "
                  f"{got['diverged_at']} inside the clean prefix")
            detail = "lockstep over the clean prefix (diverged_at -1)"
        out[name] = dict(diverged_at=got["diverged_at"],
                         fields=got["trace"][0]["fields"] if got["trace"]
                         else [], ticks=info["ticks"], reads=info["reads"],
                         card_s=secs, cpu_s=csecs)
        log(f"  {name}: {detail}; {info['ticks']} ticks replayed with "
            f"{info['reads']} host reads in {secs:.3f} s on the card "
            f"({csecs:.3f} s on the CPU)")
    demo = dst13["demos"]["lost_tail"]
    check(demo["oracle_diverged_at"] == -1,
          "the lost-tail demo's replay did not hold the oracle in lockstep")
    return out


MULTIRAFT_GROUPS = 1024      # bench.py's multiraft-1024x3
MULTIRAFT_TEL_GROUPS = 256   # bench.py's multiraft-telemetry
MULTIRAFT_TEL_PAIRS = 2      # timed pairs in turns (bench.py: 8)


def _group_safety(st) -> tuple[bool, bool]:
    """(at most one leader per group and term, equal applied -> equal
    apply_chk inside every group), on a [G, N] state."""
    import torch
    from swarmkit_tpu_torch import multiraft

    n = st.term.shape[1]
    off = ~torch.eye(n, dtype=torch.bool, device=st.term.device)
    lm = multiraft.group_leader_mask(st)
    two = lm[:, :, None] & lm[:, None, :] & off \
        & (st.term[:, :, None] == st.term[:, None, :])
    split = off & (st.applied[:, :, None] == st.applied[:, None, :]) \
        & (st.apply_chk[:, :, None] != st.apply_chk[:, None, :])
    return not bool(two.any()), not bool(split.any())


def _group_window(torch, cfg, st, ticks: int, profiled: bool, dev):
    """`ticks` fused-propose grouped ticks: unprofiled, (state, ms per tick
    between CUDA events); profiled, (state, kernel launches per tick,
    kernel ms per tick)."""
    from swarmkit_tpu_torch import multiraft
    from swarmkit_tpu_torch.tools.profile_tick import _device_us

    def run(st):
        st, _ = multiraft.run_group_ticks(st, cfg, ticks,
                                          prop_count=cfg.max_props,
                                          device=dev)
        return st
    if not profiled:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        st = run(st)
        end.record()
        torch.cuda.synchronize()
        return st, start.elapsed_time(end) / ticks
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st = run(st)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return st, sum(e.count for e in kernels) / ticks, \
        sum(_device_us(e) for e in kernels) / 1e3 / ticks


def phase_multiraft(torch, sim, cuda_ops, card: str = "cuda",
                    groups: int = MULTIRAFT_GROUPS) -> dict:
    """bench.py's multiraft-1024x3 at full width (G=1024 groups of N=3,
    L=512, window 128, apply_batch 64, max_props 32, keep 64,
    election_tick 10, read_batch 32, leases, static members, seed 7,
    collect_stats): the fleet's chunked election, 2 x 64 steady
    fused-propose ticks (host clock and CUDA events), 4 unprofiled and 4
    profiled ticks (launches, kernel ms, busy share), the band copy
    against plain on one grouped tick's [3072, 512] inputs, and the safety
    checks per group."""
    from swarmkit_tpu_torch import multiraft
    from swarmkit_tpu_torch.tools import bench

    G, dev = groups, torch.device(card)
    cfg = bench.multiraft_cfg(3, 7)
    torch.cuda.reset_peak_memory_stats()
    # the path's own launches, counted from 0 over its election and its
    # timed ticks
    cuda_ops.reset_launches()
    sim.kernel.reset_counts()
    torch.cuda.synchronize()
    st, elect_ticks, elect_s = bench.elect_groups(
        multiraft.init_groups(cfg, G, device=dev), cfg, dev, G)
    led = int(multiraft.groups_with_leader(st))
    check(led >= G * 99 // 100,
          f"only {led}/{G} groups led after {elect_ticks} ticks")
    elect_syncs = sim.kernel.COUNTS["host_syncs"]
    sim.kernel.reset_counts()
    steady = {"entries": 0, "reads": 0, "host_s": 0.0, "event_ms": 0.0}
    for _ in range(2):
        base = int(multiraft.aggregate_committed(st))
        base_r = int(multiraft.aggregate_reads_served(st))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        st, _ = multiraft.run_group_ticks(st, cfg, 64,
                                          prop_count=cfg.max_props,
                                          device=dev)
        end.record()
        torch.cuda.synchronize()
        steady["host_s"] += time.perf_counter() - t0
        steady["event_ms"] += start.elapsed_time(end)
        steady["entries"] += int(multiraft.aggregate_committed(st)) - base
        steady["reads"] += int(multiraft.aggregate_reads_served(st)) - base_r
    syncs = sim.kernel.COUNTS["host_syncs"] / 128
    launched = cuda_ops.LAUNCHES["append_band_copy"]
    check(syncs == 0, f"{syncs} step host syncs a steady grouped tick")
    check(launched == elect_ticks + 128,
          f"append_band_copy launched {launched} times in "
          f"{elect_ticks + 128} grouped ticks")
    rate = steady["entries"] / steady["host_s"]
    read_rate = steady["reads"] / steady["host_s"]
    tick_ms = steady["host_s"] * 1e3 / 128
    check(steady["entries"] > 0 and steady["reads"] > 0,
          "the fleet committed or served nothing in 128 steady ticks")
    # the device busy share: unprofiled ticks against profiled ones
    st, event_ms = _group_window(torch, cfg, st, PROFILED_TICKS, False, dev)
    st, launches, kernel_ms = _group_window(torch, cfg, st, PROFILED_TICKS,
                                            True, dev)
    one_leader, agree = _group_safety(st)
    check(one_leader, "two leaders in one group and term")
    check(agree, "equal applied with different checksums inside a group")
    box = {}

    def grouped_tick():
        box["st"], _ = multiraft.run_group_ticks(st, cfg, 1,
                                                 prop_count=cfg.max_props,
                                                 device=dev)
    calls = _record_band_copies(torch, sim, cuda_ops, cfg, st, grouped_tick)
    rows = tuple(calls[0][0].shape)
    check(len(calls) == 1 and rows == (G * 3, cfg.log_len),
          f"a grouped tick made {len(calls)} band-copy calls on {rows}")
    times = _time_band_copies(torch, cuda_ops, calls)
    check(times["err"] == 0,
          f"kernel != plain on a grouped tick's inputs ({times['err']})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(groups=G, groups_with_leader=led, election_ticks=elect_ticks,
               election_s=elect_s, election_host_syncs=elect_syncs,
               entries_per_s=rate, reads_per_s=read_rate,
               steady_ticks=128, host_ms_per_tick=tick_ms,
               event_ms_per_tick=steady["event_ms"] / 128,
               host_syncs_per_tick=syncs, band_copy_launches=launched,
               launches_per_tick=launches, kernel_ms_per_tick=kernel_ms,
               unprofiled_ms_per_tick=event_ms,
               busy_share=kernel_ms / event_ms, band_copy_rows=list(rows),
               band_copy=times, peak_gib=peak)
    log(f"  G={G} x N=3: {led}/{G} groups led after {elect_ticks} ticks "
        f"({elect_s:.3f} s; the led count read once a 32-tick chunk, "
        f"{elect_syncs} step host syncs); 128 steady ticks: {rate:,.1f} "
        f"aggregate entries/s, "
        f"{read_rate:,.1f} reads/s, {tick_ms:.3f} ms/tick on the host "
        f"clock ({steady['event_ms'] / 128:.3f} between CUDA events), step "
        f"host syncs {syncs:.2f}/tick, append_band_copy launches "
        f"{launched} in {elect_ticks + 128} ticks; {PROFILED_TICKS} "
        f"profiled ticks: "
        f"{launches:.2f} kernel launches/tick, {kernel_ms:.3f} ms of "
        f"kernels/tick against {event_ms:.3f} ms/tick unprofiled: busy "
        f"share {kernel_ms / event_ms:.3f}; one leader per group and term, "
        f"checksums agree in every group; peak device memory "
        f"{peak:.3f} GiB")
    log(f"  the band copy of one grouped tick on {list(rows)} rings: "
        f"max|kernel - plain| = {times['err']}, kernel {times['ms']:.4f} "
        f"ms, plain {times['plain_ms']:.4f} ms, torch.where x2 "
        f"{times['library_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms")
    return out


def phase_multiraft_telemetry(torch, sim, card: str = "cuda",
                              groups: int = MULTIRAFT_TEL_GROUPS) -> dict:
    """bench.py's multiraft-telemetry: G=256 groups of 3 bare and with
    telemetry (telemetry_prop_ring=64), elected and warmed, then
    MULTIRAFT_TEL_PAIRS pairs of timed passes in turns (bench.py: 8);
    the telemetry/bare ratio (median) and its spread, and per-group
    p50/p99 from summarize_groups."""
    from swarmkit_tpu_torch.telemetry import summarize_groups
    from swarmkit_tpu_torch.tools import bench

    G = groups
    t0 = time.perf_counter()
    ab = bench.multiraft_telemetry_ab(G, 3, 1_000_000, torch.device(card),
                                      pairs=MULTIRAFT_TEL_PAIRS)
    secs = time.perf_counter() - t0
    summ = summarize_groups(ab["final_telemetry"], ab["cfg"])
    check(all(s["enabled"] and s["commit"]["total"] > 0 for s in summ),
          "a telemetry group observed no commit")
    few = {g: (summ[g]["commit"]["p50"], summ[g]["commit"]["p99"])
           for g in (0, 1, G // 2, G - 1)}
    totals = sorted(s["commit"]["total"] for s in summ)
    out = {k: ab[k] for k in ("dense", "telemetry", "telemetry_over_dense",
                              "telemetry_over_dense_min",
                              "telemetry_over_dense_max", "pairs")}
    out.update(groups=G, commit_p50_p99=few, seconds=secs,
               commit_observations=[totals[0], totals[-1]])
    log(f"  G={G}: bare {ab['dense']:,.1f} vs telemetry "
        f"{ab['telemetry']:,.1f} aggregate entries/s: telemetry/bare median "
        f"{ab['telemetry_over_dense']:.3f} over {ab['pairs']} pairs in turns "
        f"({ab['telemetry_over_dense_min']:.3f}-"
        f"{ab['telemetry_over_dense_max']:.3f}); commit latency p50/p99 "
        f"(ticks) of groups {few}; {totals[0]}-{totals[-1]} commit "
        f"observations a group ({secs:.1f} s)")
    if ab["telemetry_over_dense"] < 0.8:
        log("  note: grouped-telemetry tripwire (bench.py's 0.8)")
    return out


def phase_multiraft_card_vs_cpu(torch, sim, card: str = "cuda") -> dict:
    """The serving plane on the card and on the CPU at G=8, on the sync
    and the mailbox wire, every field compared after every call: the
    election, Router.flush with per-group payloads, spills past max_props
    and reads, run_groups_under_schedule on an [8, T] schedule batch (the
    same viol and first), and FleetSource.scrape -> SloEngine.observe (the
    same readings and transitions)."""
    import numpy as np

    from swarmkit_tpu_torch import dst, multiraft, slo
    from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
    from swarmkit_tpu_torch.tools import bench

    G = 8
    base = bench.multiraft_cfg(3, 7, collect_telemetry=True)
    wires = {"sync": base,
             "mailbox": dataclasses.replace(base, latency=1,
                                            latency_jitter=1, inflight=2)}
    out = {}
    for wire, cfg in wires.items():
        sched, _ = dst.make_batch(cfg, 60, G, seed=3, device="cpu")
        arrs = sched.to_numpy()
        sides = {}
        for d in (card, "cpu"):
            steps = []
            st = multiraft.init_groups(cfg, G, device=d)
            steps.append(("init", sim.state_to_numpy(st)))
            st, trace = multiraft.run_group_ticks(st, cfg, 40, prop_count=1,
                                                  device=d)
            steps.append(("elect", sim.state_to_numpy(st),
                          trace.cpu().numpy()))
            src = slo.FleetSource(cfg)
            eng = slo.SloEngine(registry=MetricsRegistry())
            reads = [src.scrape(st)]
            fired = [eng.observe(reads[-1])]
            r = multiraft.Router(cfg, G, seed=5, device=d)
            for i in range(G * cfg.max_props * 3):
                r.offer(f"key/{i}", payload=(i * 2654435761) & 0xFFFFFFFF)
            r.offer_read("hot/key", count=9)
            for f in range(4):
                st = r.flush(st)
                steps.append((f"flush {f}", sim.state_to_numpy(st),
                              np.array(r.pending())))
            check(r.spilled > 0, f"{wire}: the router never spilled")
            reads.append(src.scrape(st, router=r))
            fired.append(eng.observe(reads[-1]))
            st, viol, first = multiraft.run_groups_under_schedule(
                st, cfg, dst.FaultSchedule.from_numpy(arrs, device=d),
                prop_count=2, device=d)
            steps.append(("schedule", sim.state_to_numpy(st),
                          viol.cpu().numpy(), first.cpu().numpy()))
            reads.append(src.scrape(st, router=r))
            fired.append(eng.observe(reads[-1]))
            sides[d] = (steps, reads, fired, list(eng.alerts))
        (sc, rc, fc, ac), (sp, rp, fp, ap) = sides[card], sides["cpu"]
        fields = 0
        for a, b in zip(sc, sp):
            check(a[0] == b[0], f"{wire}: call order differs")
            for x, y in zip(a[1:], b[1:]):
                if isinstance(x, dict):
                    check(sorted(x) == sorted(y),
                          f"{wire} {a[0]}: field sets differ")
                    for k in x:
                        check(np.array_equal(x[k], y[k]),
                              f"{wire} {a[0]}: field {k} differs between "
                              f"card and CPU")
                    fields = len(x)
                else:
                    check(np.array_equal(x, y),
                          f"{wire} {a[0]}: outputs differ")
        for x, y in zip(rc, rp):
            check(sorted(x) == sorted(y)
                  and all(np.array_equal(x[k], y[k]) for k in x),
                  f"{wire}: FleetSource readings differ")
        check(fc == fp and ac == ap, f"{wire}: SLO transitions differ")
        viol = sc[-1][2]
        out[wire] = dict(calls=len(sc), fields=fields,
                         violating=int((viol != 0).sum()),
                         slos=sorted(rc[-1]), transitions=len(ac))
        log(f"  {wire}: card = CPU on all {fields} fields after each of "
            f"{len(sc)} calls (init, election, 4 flushes with spills and "
            f"reads, an [{G}, 60] schedule batch: the same viol and first, "
            f"{out[wire]['violating']} violating), FleetSource readings "
            f"{sorted(rc[-1])} and {len(ac)} SLO transitions equal")
    return out


# ---- phase 15: the batched levers; phase 16: the model checker ----------

# the JAX package's lever cross-checks (tests/test_raft_sim.py
# TestTiledLog / TestTiledPeer / TestSparseProgress
# test_dst_cross_check_equal_bitmasks), each lever on against off, and
# DST5 with the three observability planes against without
LEVER_BASE = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8,
                  keep=4, election_tick=10, seed=77)
LEVER_CFGS = {
    "log_chunk=128": (dict(LEVER_BASE, log_len=512, log_chunk=128),
                      dict(LEVER_BASE, log_len=512, log_chunk=0)),
    "peer_chunk=8": (dict(LEVER_BASE, n=16, peer_chunk=8),
                     dict(LEVER_BASE, n=16, peer_chunk=0)),
    "active_rows=8": (dict(LEVER_BASE, n=16, active_rows=8),
                      dict(LEVER_BASE, n=16, active_rows=0)),
    "planes": (dict(LEVER_BASE, **PLANES), dict(LEVER_BASE)),
}
LEVER_S = 256        # the documented sweep width
LEVER_SUBSET = 16    # schedules run on the CPU beside the card


def _sweep_window(torch, sim, dexp, cfg, sched, dev) -> tuple:
    """20 sweep ticks, then PROFILED_TICKS profiled ones: (state, kernel
    launches a tick, kernel ms a tick)."""
    from swarmkit_tpu_torch.tools.profile_tick import _device_us

    st = sim.broadcast_state(sim.init_state(cfg, device=dev),
                             sched.target_leader.shape[0])
    for t in range(20):
        st, _ = dexp._tick_one(st, cfg, sched.at_tick(t), 2, None, dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(20, 20 + PROFILED_TICKS):
            st, _ = dexp._tick_one(st, cfg, sched.at_tick(t), 2, None, dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (st, sum(e.count for e in kernels) / PROFILED_TICKS,
            sum(_device_us(e) for e in kernels) / 1e3 / PROFILED_TICKS)


def phase_levers_batched(torch, sim, cuda_ops, card: str = "cuda") -> dict:
    """The levers and planes on the batched tick: each configuration of
    LEVER_CFGS swept at 256 x 100 on the card with the lever on and off
    (equal viol, first_tick, bits_by_tick; 0 violations), the lever on
    against the CPU on the first 16 schedules (masks and every final
    field), schedules/s, step host syncs and band-copy launches of each
    sweep (counted from 0), slab and fallback ticks, kernel launches a
    tick over 4 profiled ticks, and the band copy of one more sweep tick
    against plain (timed on the tiled log's [256*5, 128] chunks)."""
    import importlib

    import numpy as np

    from swarmkit_tpu_torch import dst
    from swarmkit_tpu_torch.dst.schedule import FaultSchedule

    dexp = importlib.import_module("swarmkit_tpu_torch.dst.explore")
    dev = torch.device(card)
    out = {}
    for name, (on_kw, off_kw) in LEVER_CFGS.items():
        on, off = sim.SimConfig(**on_kw), sim.SimConfig(**off_kw)
        sched, names = dst.make_batch(off, DST_TICKS, LEVER_S, seed=9,
                                      device=dev)
        runs = {}
        for tag, cfg in (("off", off), ("on", on)):
            sim.kernel.reset_counts()
            cuda_ops.reset_launches()
            res = dst.explore(sim.init_state(cfg, device=dev), cfg, sched,
                              profiles=names, device=dev)
            runs[tag] = (res, dict(sim.kernel.COUNTS),
                         cuda_ops.LAUNCHES["append_band_copy"])
        (r_off, c_off, l_off), (r_on, c_on, l_on) = runs["off"], runs["on"]
        check(np.array_equal(r_on.viol, r_off.viol)
              and np.array_equal(r_on.first_tick, r_off.first_tick)
              and np.array_equal(r_on.bits_by_tick, r_off.bits_by_tick),
              f"{name}: the masks differ between the lever on and off")
        check(len(r_on.violating) == 0,
              f"{name}: {len(r_on.violating)} violating schedules")
        syncs = c_on["host_syncs"] / DST_TICKS
        want_syncs = 1 if (on.tiled or on.active_rows_on) else 0
        check(syncs == want_syncs and c_off["host_syncs"] == 0,
              f"{name}: {syncs} step host syncs a tick (want "
              f"{want_syncs}), {c_off['host_syncs']} with the lever off")
        check(l_on >= DST_TICKS and l_off == DST_TICKS,
              f"{name}: append_band_copy launched {l_on} / {l_off} times "
              f"in {DST_TICKS} ticks")
        if on.active_rows_on:
            check(c_on["slab_ticks"] > 0, f"{name}: no tick ran on the slab")
        # the lever on, on the CPU, for the first 16 schedules
        sub = FaultSchedule(**{k: v[:LEVER_SUBSET].cpu()
                               for k, v in sched.leaves().items()})
        r_cpu = dst.explore(sim.init_state(on, device="cpu"), on, sub,
                            profiles=names[:LEVER_SUBSET], device="cpu")
        k = LEVER_SUBSET
        check(np.array_equal(r_cpu.viol, r_on.viol[:k])
              and np.array_equal(r_cpu.first_tick, r_on.first_tick[:k])
              and np.array_equal(r_cpu.bits_by_tick,
                                 r_on.bits_by_tick[:, :k]),
              f"{name}: the card's masks differ from the CPU's")
        got = sim.state_to_numpy(r_on.final_state)
        want = sim.state_to_numpy(r_cpu.final_state)
        check(sorted(got) == sorted(want),
              f"{name}: final field sets differ")
        for f in want:
            check(np.array_equal(got[f][:k], want[f]),
                  f"{name}: final field {f} differs between card and CPU")
        st, launches, kernel_ms = _sweep_window(torch, sim, dexp, on, sched,
                                                dev)
        # the band copies of the next sweep tick; under the tiled log, of
        # the next ticks up to the first banded one (the union band fits
        # only where no cluster elects or restores)
        box, calls = {"st": st}, []
        for t in range(20 + PROFILED_TICKS, DST_TICKS):
            def sweep_tick(t=t):
                box["st"], _ = dexp._tick_one(box["st"], on, sched.at_tick(t),
                                              2, None, dev)
            calls += _record_band_copies(torch, sim, cuda_ops, on, box["st"],
                                         sweep_tick)
            if not on.tiled or any(c[5].shape[1] == on.log_chunk
                                   for c in calls):
                break
        err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
        check(err == 0, f"{name}: kernel != plain on a sweep tick ({err})")
        shapes = sorted({tuple(c[5].shape) for c in calls})
        banded = (l_on - DST_TICKS) // (on.band_chunks - 1) if on.tiled \
            else 0
        row = dict(schedules_per_s=r_on.schedules_per_sec,
                   schedules_per_s_off=r_off.schedules_per_sec,
                   host_syncs_per_tick=syncs, band_copy_launches=l_on,
                   band_copy_launches_off=l_off,
                   slab_ticks=c_on["slab_ticks"],
                   fallback_ticks=c_on["dense_fallback_ticks"],
                   launches_per_tick=launches, kernel_ms_per_tick=kernel_ms,
                   fields=len(want), band_copy_shapes=shapes, err=err)
        if on.tiled:
            chunks = [c for c in calls if c[5].shape[1] == on.log_chunk]
            check(bool(chunks), f"{name}: no banded tick in the sweep")
            row["band_copy"] = _time_band_copies(torch, cuda_ops, chunks)
            row["banded_ticks"] = banded
        out[name] = row
        log(f"  {name}, {LEVER_S} x {DST_TICKS}: lever on = off on viol, "
            f"first_tick and bits_by_tick, 0 violations; card = CPU on "
            f"{k} schedules (masks and all {len(want)} final fields); "
            f"{r_on.schedules_per_sec:.1f} schedules/s on "
            f"({r_off.schedules_per_sec:.1f} off); step host syncs "
            f"{syncs:.2f}/tick; slab {c_on['slab_ticks']} / fallback "
            f"{c_on['dense_fallback_ticks']} ticks; append_band_copy "
            f"launches {l_on} on, {l_off} off"
            + (f" ({banded} banded ticks, {DST_TICKS - banded} full-pass)"
               if on.tiled else "") + f"; {PROFILED_TICKS} profiled ticks: "
            f"{launches:.2f} kernel launches/tick, {kernel_ms:.3f} ms of "
            f"kernels/tick; band copy of {len(calls)} sweep-tick calls on "
            f"{shapes}: max|kernel - plain| = {err}")
    return out


# the n3h8 scope's exact per-level (children, unique) ladder and totals,
# pinned as the JAX package's tests pin the smoke scope's
N3H8_LEVELS = ((13, 4), (52, 29), (377, 225), (2925, 1403), (18239, 7938),
               (103194, 42192), (548496, 213988), (2781844, 1069714))
N3H8_TOTALS = dict(branches_explored=3_455_140, states_discovered=1_335_494,
                   duplicates=2_119_647, passes=10,
                   max_branches_per_pass=1 << 20, frontier_peak=1_069_714)
MC_PASS_WIDTH = 1 << 20   # the scan's wide pass (exhaustive_scan pass_large)


def _mc_pass_on_the_card(torch, sim, cuda_ops, mc, dev) -> dict:
    """One 2^20-lane expand pass (the scan's wide width) from a state 6
    noop ticks past the root, each lane under action lane % A: kernel
    launches and kernel ms of the pass (profiled), and its band-copy call
    against plain, timed."""
    import importlib

    from swarmkit_tpu_torch.tools.profile_tick import _device_us

    frontier = importlib.import_module("swarmkit_tpu_torch.mc.frontier")
    sc = mc.SCOPES["n3h8"]
    cfg, alphabet = sc.cfg(), sc.alphabet()
    tables = alphabet.tables(dev)
    st = sim.broadcast_state(sim.init_state(cfg, device=dev), 1)
    noop = torch.zeros((1,), dtype=torch.int64, device=dev)
    for _ in range(6):
        st, _, _ = frontier._expand(st, noop, tables, cfg, 1, None, False,
                                    dev)
    width = MC_PASS_WIDTH
    aids = torch.arange(width, device=dev) % alphabet.size
    lanes = torch.zeros((width,), dtype=torch.int64, device=dev)

    def one_pass():
        chunk = frontier._take(st, lanes)
        return frontier._expand(chunk, aids, tables, cfg, 1, None, False,
                                dev)
    one_pass()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        one_pass()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = _record_band_copies(torch, sim, cuda_ops, cfg, st, one_pass)
    return dict(launches=sum(e.count for e in kernels),
                kernel_ms=sum(_device_us(e) for e in kernels) / 1e3,
                band_copy_shape=list(calls[0][5].shape),
                band_copy=_time_band_copies(torch, cuda_ops, calls))


def phase_mc(torch, sim, cuda_ops, outdir: str, card: str = "cuda") -> dict:
    """The exhaustive model checker (swarmkit_tpu_torch/mc/) on the card:
    mc_sweep's n3h8 scan (the ladder and totals above exactly, 0
    violations, exhaustive; branches/s, seconds in device passes and in the
    host dedup, peak device memory, band-copy launches counted from 0: one
    a pass), one profiled 2^20-lane pass (launches, kernel ms, the band
    copy on its [2^20*3, 32] rings against plain, timed), both mutation
    self-tests at n3h8 (caught; the shrunk artifact replays exactly on the
    card and on the CPU), and the smoke scope on the card and on the CPU
    (the same summaries, violations, edges and .aut bytes)."""
    from swarmkit_tpu_torch import dst, mc
    from swarmkit_tpu_torch.tools import mc_export, mc_sweep

    dev = torch.device(card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim.kernel.reset_counts()
    cuda_ops.reset_launches()
    res = mc_sweep.run_scan("n3h8", verbose=False, device=dev)
    launched = cuda_ops.LAUNCHES["append_band_copy"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ = res.summary()
    ladder = tuple((lv["children"], lv["unique"]) for lv in res.levels)
    check(ladder == N3H8_LEVELS, f"n3h8 ladder {ladder}")
    for key, want in N3H8_TOTALS.items():
        check(summ[key] == want, f"n3h8 {key} = {summ[key]}, want {want}")
    check(not res.violations and res.exhaustive,
          f"n3h8: {len(res.violations)} violations, exhaustive "
          f"{res.exhaustive}")
    check(launched == res.passes,
          f"n3h8: append_band_copy launched {launched} times in "
          f"{res.passes} passes")
    check(sim.kernel.COUNTS["host_syncs"] == 0,
          f"n3h8: {sim.kernel.COUNTS['host_syncs']} step host syncs")
    out = {"n3h8": dict(branches=res.branches_explored,
                        states=res.states_discovered, passes=res.passes,
                        seconds=res.elapsed, summary={
                            k: v for k, v in summ.items()
                            if k not in ("elapsed_sec", "branches_per_sec")},
                        branches_per_s=res.branches_per_sec,
                        device_s=res.timing["device_s"],
                        host_s=res.timing["host_s"], peak_gib=peak,
                        band_copy_launches=launched)}
    log(f"  n3h8: {res.branches_explored:,} branches over "
        f"{res.states_discovered:,} states (ladder and totals as pinned), "
        f"{res.passes} passes, max {res.max_branches_per_pass:,}/pass, 0 "
        f"violations, exhaustive; {res.elapsed:.3f} s "
        f"({res.branches_per_sec:,.1f} branches/s): "
        f"{res.timing['device_s']:.3f} s from gather to read-back of the "
        f"passes, {res.timing['host_s']:.3f} s in the host dedup; peak "
        f"device memory {peak:.3f} GiB; append_band_copy launches "
        f"{launched}")
    one = _mc_pass_on_the_card(torch, sim, cuda_ops, mc, dev)
    check(one["band_copy"]["err"] == 0,
          f"kernel != plain on an mc pass ({one['band_copy']['err']})")
    out["pass"] = one
    log(f"  one 2^20-lane pass: {one['launches']} kernel launches, "
        f"{one['kernel_ms']:.3f} ms of kernels; band copy on "
        f"{one['band_copy_shape']}: max|kernel - plain| = 0")
    out["mutations"] = {}
    for mutation in mc_sweep.MUTATIONS:
        t0 = time.perf_counter()
        demo = mc_sweep.run_self_test(
            "n3h8", mutation, out_path=f"{outdir}/mc_{mutation}.json",
            verbose=False, device=dev)
        secs = time.perf_counter() - t0
        check(demo["caught"], f"mc: mutation {mutation} was not caught")
        check(demo["replay_matches"],
              f"mc {mutation}: the artifact did not replay exactly")
        on_cpu = dst.replay_artifact(demo["artifact"], with_trace=False,
                                     device="cpu")
        check(on_cpu["matches_recorded"],
              f"mc {mutation}: the artifact replayed on the CPU to "
              f"{on_cpu['violations']} at tick {on_cpu['first_tick']}")
        out["mutations"][mutation] = dict(
            level=demo["level"], bits=demo["bits"],
            actions=demo["actions"], branches=demo["branches_explored"],
            seconds=secs)
        log(f"  mutation {mutation}: caught at level {demo['level']} "
            f"({demo['bits']}) after {demo['branches_explored']:,} "
            f"branches via {demo['actions']}; the shrunk artifact replays "
            f"exactly on the card and on the CPU; {secs:.3f} s")
    sc = mc.SCOPES["smoke"]
    drop = ("elapsed_sec", "branches_per_sec")
    for mutation in (None, "commit_no_quorum"):
        runs = [mc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon,
                                   mutation=mutation, collect_edges=True,
                                   scope="smoke", device=d)
                for d in (dev, "cpu")]
        a, b = ({k: v for k, v in r.summary().items() if k not in drop}
                for r in runs)
        check(a == b and runs[0].edges == runs[1].edges,
              f"smoke [{mutation}]: the card's scan differs from the CPU's")
    auts = []
    for d in (dev, "cpu"):
        path = f"{outdir}/smoke_{d}.aut"
        mc_export.export_scope("smoke", path, verbose=False, device=d)
        check(mc_export.validate_aut(path) == [], f"{path} does not validate")
        with open(path, "rb") as f:
            auts.append(f.read())
    check(auts[0] == auts[1], "the card's .aut differs from the CPU's")
    log(f"  smoke scope: card = CPU on the summary, edges and violations "
        f"(stock and commit_no_quorum) and the .aut bytes "
        f"({len(auts[0])} bytes)")
    return out


# ---- phase 17: the scheduler's group placement at Docker's scale -------

SCHED_HOST_PREFIX = 128      # tasks the host Pipeline places per group
SCHED_PLAIN_PREFIX = 512     # tasks of the plain loop on the card
# the group whose plain-loop launches are counted: tracing ~50,000
# launches costs the profiler ~10 s a group
SCHED_PROFILED_GROUP = "A"
# the chain alone, no spread: one warp of nodes, and Docker's 1,000
SCHED_CHAIN_NODES = (32, 1000)


def place_bound_ms(n: int, n_branches: int, tasks: int, ran: int) -> tuple:
    """The least time of one place_greedy call, from what the placement
    needs rather than from the kernel's rescan: bytes (the [6, N] int32
    columns read once, the choices written) over the memory rate, and
    integer operations over the card's rate outside the tensor cores.
    Between tasks only a[choice] changes, so one node's key and one
    branch's (load, first) change: an incremental argmin (a tournament
    tree over the nodes, and one over the branches with a spread level)
    needs ceil(log2 N) + ceil(log2 B) tuple compares of up to 4 integer
    operations each, for each task the loop ran.  Returns
    (ms, "bytes" | "operations")."""
    bytes_ = 24 * n + 4 * tasks
    levels = math.ceil(math.log2(max(n, 2)))
    if n_branches:
        levels += math.ceil(math.log2(max(n_branches, 2)))
    ops = ran * 4 * levels
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def events_ms(torch, fn, reps: int = 3, warm: bool = True) -> float:
    """Mean device time of fn() in ms between CUDA events, after one
    warm call unless `warm` is false (the caller has just run it)."""
    if warm:
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


def _profiled_launches(torch, fn) -> int:
    """The kernel launches of fn(), under torch.profiler tracing the card
    only (tracing the host's ops too costs seconds at ~50,000 launches)."""
    return _profiled_kernels(torch, fn)[0]


def _profiled_kernels(torch, fn) -> tuple:
    """(kernel launches, kernel ms) of fn(), the card traced alone."""
    from swarmkit_tpu_torch.tools.profile_tick import _device_us

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kernels),
            sum(_device_us(e) for e in kernels) / 1e3)


def phase_scheduler(torch, cuda_ops, card: str = "cuda") -> dict:
    """Each group of sched_world.GROUPS on a fresh copy of the Docker-scale
    world through Scheduler.schedule on the card (one launch a group), the
    kernel against the plain loop on the CPU over every task, the host
    Pipeline on the first SCHED_HOST_PREFIX tasks against the kernel's
    choices, and the timings."""
    from swarmkit_tpu_torch.manager.scheduler import Scheduler
    from swarmkit_tpu_torch.manager.scheduler import kernel as skernel
    from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
    from swarmkit_tpu_torch.tools import sched_world as W
    from swarmkit_tpu_torch.utils.clock import SystemClock

    desc = W.describe_world(seed=0)
    log(f"  world: {len(desc['zone'])} nodes in zones {W.ZONES}, "
        f"{int(desc['down'].sum())} down, {int(desc['tainted'].sum())} "
        f"tainted, {int(desc['running'].sum())} tasks running "
        f"({int(desc['running_own'].sum())} of {W.SERVICE!r})")
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for name in sorted(W.GROUPS):
        t0 = time.perf_counter()
        tasks = W.group_tasks(name)
        n_tasks = len(tasks)
        make_s = time.perf_counter() - t0
        # the main path: one scheduler pass on the card
        obs = MetricsRegistry()
        sched = Scheduler(obs=obs, use_kernel=True, device=card)
        W.fill(sched, desc, tasks[0])
        node_ids = list(sched.node_set.nodes)
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        decisions = sched.schedule(tasks)
        schedule_s = time.perf_counter() - t0
        launches = cuda_ops.LAUNCHES["sched_place"]
        variant = {v: cuda_ops.LAUNCHES[f"sched_place_{v}"]
                   for v in cuda_ops.PLACE_VARIANTS}
        paths = catalog.get(obs, "swarm_sched_kernel_groups_total").snapshot()
        check(launches == 1 and variant[cuda_ops.PLACE_VARIANT] == 1,
              f"group {name}: sched_place launched {launches} times "
              f"({variant}), not once as {cuda_ops.PLACE_VARIANT}")
        check(paths == {"path=kernel": 1.0}, f"group {name}: encode_group "
              f"fell back to the host Pipeline ({paths})")
        snap = obs.snapshot()
        kernel_s = snap["swarm_sched_kernel_seconds"]["sum"]
        latency_s = snap["swarm_scheduler_latency_seconds"]["sum"]

        # the same group's pieces on a fresh copy: encode, the launch
        # timed between CUDA events, the plain loop on the CPU
        clock = SystemClock()
        nodes = W.build_nodes(desc, tasks[0], clock.now())
        prefs = list(tasks[0].spec.placement.preferences)
        t0 = time.perf_counter()
        enc = skernel.encode_group(tasks[0], prefs, nodes,
                                   NodeInfo.failure_key(tasks[0]),
                                   clock.now())
        encode_s = time.perf_counter() - t0
        check(enc is not None, f"group {name}: encode_group returned None")
        cols_cpu = skernel.group_columns(enc, n_tasks, device="cpu")
        cols = cols_cpu.to(card)
        nb, hs = enc.n_branches, enc.has_service

        def run(cols=cols, k=n_tasks):
            return cuda_ops.place_greedy(cols, nb, hs, k)

        def launch(variant, cols=cols, k=n_tasks):
            return cuda_ops._place_launch(cols, nb, hs, k, variant)

        got = {v: launch(v).cpu() for v in cuda_ops.PLACE_VARIANTS}
        t0 = time.perf_counter()
        want = cuda_ops.place_greedy_plain(cols_cpu, nb, hs, n_tasks)
        plain_cpu_s = time.perf_counter() - t0
        errs = {v: int((c.long() - want.long()).abs().max())
                for v, c in got.items()}
        err = errs[cuda_ops.PLACE_VARIANT]
        check(max(errs.values()) == 0, f"group {name}: a kernel differs "
              f"from the plain loop (max |diff| {errs})")
        # each kernel timed in turns on the same columns
        turns = {v: [] for v in cuda_ops.PLACE_VARIANTS}
        for v in (*cuda_ops.PLACE_VARIANTS,
                  *reversed(cuda_ops.PLACE_VARIANTS)):
            turns[v].append(events_ms(torch, lambda v=v: launch(v)))
        kernel_ms = {v: sum(t) / len(t) for v, t in turns.items()}
        device_ms = kernel_ms[cuda_ops.PLACE_VARIANT]
        choices = want.tolist()
        placed = sum(c >= 0 for c in choices)
        check([(t.id, n) for t, n, _ in decisions] ==
              [(tasks[i].id, node_ids[c]) for i, c in enumerate(choices)
               if c >= 0], f"group {name}: Scheduler.schedule's decisions "
              f"differ from the kernel's choices")
        check(placed > 0, f"group {name}: nothing placed")

        # the host Pipeline on the prefix: the greedy loop makes task i's
        # choice depend only on tasks < i
        host = Scheduler(obs=MetricsRegistry(), use_kernel=False)
        W.fill(host, desc, tasks[0])
        prefix = tasks[:SCHED_HOST_PREFIX]
        t0 = time.perf_counter()
        host_dec = host.schedule(prefix)
        host_s = time.perf_counter() - t0
        check([(t.id, n) for t, n, _ in host_dec] ==
              [(tasks[i].id, node_ids[c])
               for i, c in enumerate(choices[:SCHED_HOST_PREFIX])
               if c >= 0], f"group {name}: the host Pipeline differs from "
              f"the kernel on the first {SCHED_HOST_PREFIX} tasks")

        # the yardstick, never on the path: the plain loop on the card
        # over a prefix, and the kernel on the same prefix
        k = SCHED_PLAIN_PREFIX
        plain_launches = _profiled_launches(
            torch, lambda: cuda_ops.place_greedy_plain(cols, nb, hs, k)) \
            if name == SCHED_PROFILED_GROUP else None
        plain_ms = events_ms(
            torch, lambda: cuda_ops.place_greedy_plain(cols, nb, hs, k), 1,
            warm=False)
        prefix_ms = events_ms(torch, lambda: run(k=k))
        ran = min(n_tasks, placed + 1)
        bound, bound_by = place_bound_ms(len(nodes), nb, n_tasks, ran)
        out[name] = dict(
            tasks=n_tasks, nodes=len(nodes), branches=nb, placed=placed,
            unplaced=n_tasks - placed, tasks_run=ran, launches=launches,
            schedule_s=schedule_s, encode_place_s=kernel_s,
            latency_s=latency_s, grouping_decode_s=latency_s - kernel_s,
            encode_s=encode_s, ms=device_ms,
            us_per_task=device_ms * 1e3 / n_tasks,
            us_per_task_run=device_ms * 1e3 / ran,
            previous_ms=kernel_ms["rescan"], kernel_ms=kernel_ms,
            kernel_turns_ms=turns, kernel_errs=errs, bound_ms=bound,
            bound_by=bound_by, plain_cpu_s=plain_cpu_s, host_s=host_s,
            host_us_per_task=host_s * 1e6 / len(prefix),
            plain_prefix_ms=plain_ms, plain_prefix_launches=plain_launches,
            prefix_ms=prefix_ms, err=err, make_tasks_s=make_s)
        log(f"  group {name}: {n_tasks} tasks over {len(nodes)} nodes "
            f"({nb} spread branches): placed {placed}, unplaced "
            f"{n_tasks - placed}; Scheduler.schedule {schedule_s:.3f} s "
            f"(encode + place {kernel_s:.4f} s, grouping + decode "
            f"{latency_s - kernel_s:.3f} s), sched_place launches "
            f"{launches}; encode_group {encode_s:.4f} s; device ms "
            f"between CUDA events, in turns: "
            + ", ".join(f"{v} {ms:.3f} ({ms * 1e3 / n_tasks:.4f} us a "
                        f"task, {ms * 1e3 / ran:.4f} a task run; turns "
                        f"{turns[v]})" for v, ms in kernel_ms.items())
            + f"; bound {bound:.3e} ms ({bound_by}); every kernel = plain "
            f"loop on the CPU over all {n_tasks} tasks (plain "
            f"{plain_cpu_s:.2f} s); host "
            f"Pipeline {host_s:.3f} s for {len(prefix)} tasks "
            f"({host_s * 1e6 / len(prefix):.1f} us a task) = the kernel's "
            f"first {len(prefix)}; plain loop on the card over {k} tasks "
            f"{plain_ms:.2f} ms in "
            f"{plain_launches if plain_launches is not None else 'uncounted'}"
            f" launches, the kernel {prefix_ms:.3f} ms")

    # the chain alone: no spread, every key equal, every task placed
    # (round robin by index), each kernel in turns
    t_a = out["A"]["tasks"]
    out["chain"] = {}
    for n in SCHED_CHAIN_NODES:
        chain_cols = torch.zeros((6, n), dtype=torch.int32, device=card)
        chain_cols[0] = 1
        chain_cols[1] = 1 << 20
        expect = torch.arange(t_a, dtype=torch.int32) % n
        turns = {v: [] for v in cuda_ops.PLACE_VARIANTS}
        for v in (*cuda_ops.PLACE_VARIANTS,
                  *reversed(cuda_ops.PLACE_VARIANTS)):
            def go(v=v):
                return cuda_ops._place_launch(chain_cols, 0, True, t_a, v)
            check(torch.equal(go().cpu(), expect),
                  f"the chain at {n} nodes: {v} is not round robin")
            turns[v].append(events_ms(torch, go, warm=False))
        ms = {v: sum(t) / len(t) for v, t in turns.items()}
        out["chain"][n] = dict(
            tasks=t_a, ms=ms, turns_ms=turns,
            us_per_task={v: m * 1e3 / t_a for v, m in ms.items()})
        log(f"  the chain alone ({n} nodes, no spread, {t_a} tasks all "
            f"placed), in turns: " + ", ".join(
                f"{v} {m:.3f} ms ({m * 1e3 / t_a:.4f} us a task)"
                for v, m in ms.items()))
    out["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"  peak device memory {out['peak_mem_mib']:.3f} MiB")
    return out


# ---- phase 18: the multi-raft tools on the card -------------------------

SWEEP_ARGS = ["--groups", "64", "--entries", "200000", "--no-single",
              "--json"]
TOP_FRAMES = 3


def phase_tools(torch, cuda_ops) -> dict:
    """multiraft_sweep's G=64 point and three swarm_top frames over its
    in-process demo, both on the card."""
    import contextlib
    import io

    from swarmkit_tpu_torch.tools import multiraft_sweep, swarm_top

    cuda_ops.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = multiraft_sweep.main(SWEEP_ARGS)
    sweep_s = time.perf_counter() - t0
    text = buf.getvalue()
    sweep_launches = cuda_ops.LAUNCHES["append_band_copy"]
    check(rc == 0, f"multiraft_sweep exited {rc}")
    points = [json.loads(line) for line in text.splitlines()
              if line.startswith("{")]
    check(len(points) == 1, f"multiraft_sweep printed {len(points)} JSON "
          f"lines, not 1")
    point = points[0]
    check(set(point) == {"groups", "n", *multiraft_sweep.POINT_KEYS},
          f"multiraft_sweep's keys {sorted(point)}")
    check(point["groups"] == 64 and point["committed"] > 0
          and point["groups_with_leader"] >= 64 * 99 // 100,
          f"multiraft_sweep's point {point}")
    check(sweep_launches > 0, "multiraft_sweep never launched the band copy")
    for line in text.rstrip().splitlines()[-3:]:
        log(f"  {line}")
    log(f"  multiraft_sweep {' '.join(SWEEP_ARGS)}: {sweep_s:.2f} s, "
        f"append_band_copy launches {sweep_launches}; {json.dumps(point)}")

    cuda_ops.reset_launches()
    poll = swarm_top.source_demo()
    state = swarm_top.TopState()
    t0 = time.perf_counter()
    for _ in range(TOP_FRAMES):
        snaps = poll()
        state.observe(snaps)
        frame = swarm_top.render_frame(snaps, state)
    top_s = time.perf_counter() - t0
    top_launches = cuda_ops.LAUNCHES["append_band_copy"]
    fleet = snaps["sim-fleet"]
    led = fleet["metrics"]["swarm_multiraft_groups_with_leader"]
    for want in ("== sim-quorum", "== sim-fleet",
                 "swarm_multiraft_groups_with_leader", "hottest groups:",
                 "SLO ALERTS", "swarm_kernel_commit_advance_total"):
        check(want in frame, f"swarm_top's frame lacks {want!r}")
    check(led == fleet["objects"]["groups"],
          f"swarm_top's fleet: {led} of {fleet['objects']['groups']} groups "
          f"lead")
    check(top_launches > 0, "swarm_top's demo never launched the band copy")
    log(f"  swarm_top --demo: {TOP_FRAMES} frames in {top_s:.2f} s, "
        f"append_band_copy launches {top_launches}; the fleet's "
        f"{int(led)} groups lead, hottest {fleet['hottest']}, "
        f"{len(fleet['slo_active'])} SLO states active, "
        f"{len(fleet['alerts'])} alerts; the last frame's fleet panel:")
    for line in frame.splitlines():
        if "hottest" in line or "SLO" in line or "⚠" in line \
                or "groups_with_leader" in line:
            log(f"  | {line}")
    return dict(sweep=point, sweep_s=sweep_s, sweep_launches=sweep_launches,
                top_s=top_s, top_launches=top_launches,
                top_slo_active=len(fleet["slo_active"]))


# ---- phase 19: differential_sweep; phase 20: fault_sweep's device half ---

# seeds 0 .. DIFF_SEEDS-1 of every differential_sweep family (one keeps
# phases 19 and 20 within 240 s; see PERF.md)
DIFF_SEEDS = 1
# fault_sweep's pinned seeds and sizes (the JAX tool's defaults)
FAULT_SEED, FAULT_SCHEDULES, FAULT_N = 7, 8, 5
PRECHECK_CPU_PLANS = ("drop", "crash")
# the precheck's depth: the JAX tool's 60 ticks cut to 45 (the plans'
# fault window is ticks [10, 40), so 5 ticks after the heal; banded =
# dense, sparse = dense and card = CPU hold over them alike)
PRECHECK_TICKS = 45
# the attack row whose explore band-copy call phase 20 times
FAULT_TIMED = "append_flood"
# the attack and storage rows' depth: their scenarios' 120-140 ticks cut
# to 80, as phase 13's demos (every row still catches or contains its
# fault; 60 loses two rows)
FAULT_TICKS = 80


def _per_tick_ms(info: dict, key: str) -> float:
    return info[key] * 1e3 / info["ticks"]


def phase_differential(torch, sim, cuda_ops, card: str = "cuda") -> dict:
    """differential_sweep on the card: every family at seeds 0 ..
    DIFF_SEEDS-1 through run_family, the tick held to the host golden core
    on the nine fields every tick; per family the ticks, maxima, reruns,
    the host ms a tick split four ways, the device->host reads a tick and
    the band-copy launches (one a tick); then the kernel against plain on
    one sync128-faults tick's [128, 128] call, timed."""
    from swarmkit_tpu_torch.raft.sim.differential import run_differential
    from swarmkit_tpu_torch.tools import differential_sweep as ds

    dev = torch.device(card)
    out = {"families": {}, "seeds": DIFF_SEEDS}
    t_phase = time.perf_counter()
    launches_all = 0
    for name, cfg, _ in ds.FAMILIES:
        info = {}
        cuda_ops.reset_launches()
        runs = []
        t0 = time.perf_counter()
        for seed in range(DIFF_SEEDS):
            r = ds.run_family(name, seed, device=dev, info=info)
            check(r["ok"], f"differential family {name} seed {seed} "
                  f"diverged or stalled (repro: {r.get('repro')})")
            runs.append(r)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = cuda_ops.LAUNCHES["append_band_copy"]
        launches_all += launched
        ticks = info["ticks"]
        check(launched == ticks, f"{name}: append_band_copy launched "
              f"{launched} times in {ticks} ticks")
        row = dict(
            n=cfg.n, schedules=len(runs), ticks=ticks, secs=secs,
            max_commit=max(r["max_commit"] for r in runs),
            max_term=max(r["max_term"] for r in runs),
            reruns=sum(r["reran"] for r in runs),
            host_ms_per_tick=secs * 1e3 / ticks,
            draw_ms=_per_tick_ms(info, "draw_s"),
            tick_ms=_per_tick_ms(info, "tick_s"),
            oracle_ms=_per_tick_ms(info, "oracle_s"),
            view_ms=_per_tick_ms(info, "view_s"),
            reads_per_tick=(info["reads"] + info["step_syncs"]) / ticks,
            step_syncs_per_tick=info["step_syncs"] / ticks,
            band_copy_launches=launched)
        out["families"][name] = row
        log(f"  {name} (n={cfg.n}): {row['schedules']} schedules, {ticks} "
            f"ticks in {secs:.2f} s, tick = golden core on every field; "
            f"max commit {row['max_commit']}, max term {row['max_term']}, "
            f"zero-commit reruns {row['reruns']}; host ms a tick "
            f"{row['host_ms_per_tick']:.3f}: card tick (step + host calls, "
            f"enqueue) {row['tick_ms']:.3f}, oracle {row['oracle_ms']:.3f}, "
            f"view read {row['view_ms']:.3f}, schedule draw "
            f"{row['draw_ms']:.3f}; device->host reads a tick "
            f"{row['reads_per_tick']:.2f} (step syncs "
            f"{row['step_syncs_per_tick']:.2f}); append_band_copy "
            f"launches {launched}")
    out["secs"] = time.perf_counter() - t_phase
    out["band_copy_launches"] = launches_all

    # the kernel against plain on a sync128-faults tick's [128, 128] call:
    # the call of the first 30 ticks of seed 0 that writes the most slots
    cfg, kw = ds.FAMILY["sync128-faults"]
    calls = _record_band_copies(
        torch, sim, cuda_ops, cfg, None,
        lambda: run_differential(cfg, seed=0, device=dev,
                                 **dict(kw, n_ticks=30)))
    best = max(calls, key=lambda c: int(c[5].sum()))
    check(tuple(best[0].shape) == (cfg.n, cfg.log_len),
          f"the sync128 ring write ran on {tuple(best[0].shape)}")
    timed = _time_band_copies(torch, cuda_ops, [best])
    check(timed["err"] == 0,
          f"kernel != plain on a sync128 tick's inputs ({timed['err']})")
    out["band_copy"] = dict(timed, rows=list(best[0].shape),
                            written=int(best[5].sum()))
    log(f"  phase 19 in {out['secs']:.1f} s; {launches_all} band-copy "
        f"launches; the [128, 128] call ({out['band_copy']['written']} "
        f"slots written): kernel {timed['ms']:.4f} ms, plain "
        f"{timed['plain_ms']:.4f}, torch.where x2 {timed['library_ms']:.4f},"
        f" bound {timed['bound_ms']:.6f}, max|kernel - plain| = "
        f"{timed['err']}")
    return out


def _replays_on_cpu(dst, path: str) -> dict:
    verdict = dst.replay_artifact(path, with_trace=False, device="cpu")
    check(verdict["matches_recorded"],
          f"{path}: the card's artifact replayed on the CPU to "
          f"{verdict['violations']} at tick {verdict['first_tick']}")
    return verdict


def _fault_run(torch, sim, cuda_ops, what: str, run):
    """`run()` on the card with the band-copy counts set to 0 just before
    it and every band-copy call recorded: (its result, the launches, the
    recorded calls).  The launches must equal the ticks it drove (each a
    call of the tick's `step`, batched or not, makes one full-pass ring
    write), and every recorded call is then held against the plain
    version on its own inputs, exactly."""
    import importlib

    dexp = importlib.import_module("swarmkit_tpu_torch.dst.explore")
    homes = (sim.kernel, dexp)
    steps = [m.step for m in homes]
    ticks, box = [0], {}

    def counted(step):
        def tick(*args, **kw):
            ticks[0] += 1
            return step(*args, **kw)
        return tick

    for m, step in zip(homes, steps):
        m.step = counted(step)
    cuda_ops.reset_launches()
    try:
        calls = _record_band_copies(torch, sim, cuda_ops, None, None,
                                    lambda: box.update(out=run()))
    finally:
        for m, step in zip(homes, steps):
            m.step = step
    launched = cuda_ops.LAUNCHES["append_band_copy"]
    check(launched == ticks[0] > 0, f"{what}: append_band_copy launched "
          f"{launched} times in {ticks[0]} ticks")
    err = max(_kernel_vs_plain(torch, cuda_ops, c) for c in calls)
    check(err == 0, f"{what}: kernel != plain on the path's inputs ({err})")
    return box["out"], launched, calls


def phase_fault_sweep(torch, sim, cuda_ops, outdir: str,
                      card: str = "cuda") -> dict:
    """fault_sweep's device half on the card: the lowering precheck on
    all five plans at seed 2009343 (banded = dense at peer_chunk=8, sparse
    = dense at active_rows=8), two plans card = CPU on viol, first_tick
    and bits_by_tick; the four attack and four storage pipelines at seed
    7, n=5, 8 schedules, each row ok and each card artifact replayed on
    the CPU with its recorded viol and first tick (each scenario cut to
    FAULT_TICKS ticks).  Each lowering and each row counts its band-copy launches from 0 (one a tick driven) and
    holds every band-copy call it made against the plain version; the
    append_flood row's explore call that writes the most slots is timed
    as in phase 5."""
    import numpy as np

    from swarmkit_tpu_torch import dst
    from swarmkit_tpu_torch.tools import fault_sweep as fs

    dev = torch.device(card)
    out = {"precheck": {}, "rows": {}}
    t_phase = time.perf_counter()
    launches_all = 0
    seed = fs.DEFAULT_SEEDS[0]
    on_card = {}
    for lowering, ar in (("banded", None), ("sparse", 8)):
        rows, launched, _ = _fault_run(
            torch, sim, cuda_ops, f"precheck {lowering}",
            lambda: fs.run_device_precheck(
                fs.PLANS, [seed], peer_chunk=8, active_rows=ar,
                ticks=PRECHECK_TICKS, verbose=False, device=dev,
                stats=on_card if ar is None else None))
        launches_all += launched
        want = "== dense-progress" if ar else "== dense-peer"
        for r in rows:
            check(r["ok"] and want in r["notes"],
                  f"precheck {lowering} {r['plan']}: {r['notes']} "
                  f"{r['error']}")
        out["precheck"][lowering] = dict(
            secs=sum(r["secs"] for r in rows), band_copy_launches=launched,
            notes={r["plan"]: r["notes"] for r in rows})
        log(f"  precheck {rows[0]['wire']} at seed {seed} (n=16, "
            f"{PRECHECK_TICKS} ticks): " + "; ".join(f"{r['plan']} {r['notes']} "
                                    f"({r['secs']} s)" for r in rows)
            + f"; append_band_copy launches {launched}, one a tick, each "
            f"call = plain")
    on_cpu = {}
    fs.run_device_precheck(PRECHECK_CPU_PLANS, [seed], peer_chunk=8,
                           ticks=PRECHECK_TICKS, verbose=False,
                           device="cpu", stats=on_cpu)
    for plan in PRECHECK_CPU_PLANS:
        a, b = on_card[(plan, seed)], on_cpu[(plan, seed)]
        check(all(np.array_equal(getattr(a, k), getattr(b, k))
                  for k in ("viol", "first_tick", "bits_by_tick")),
              f"precheck {plan}: the card's masks differ from the CPU's")
        log(f"  precheck {plan}: card = CPU on viol 0x{int(b.viol[0]):x}, "
            f"first_tick {int(b.first_tick[0])} and bits_by_tick")

    rows_of = FAULT_SCHEDULES * FAULT_N
    for kind, table, sweep in (
            ("attack", fs.ATTACK_SCENARIOS, fs.run_attack_sweep),
            ("storage", fs.STORAGE_SCENARIOS, fs.run_storage_sweep)):
        for name, sc in table.items():
            stats = {}
            full = sc["ticks"]
            sc["ticks"] = min(full, FAULT_TICKS)
            try:
                rows, launched, calls = _fault_run(
                    torch, sim, cuda_ops, f"{kind} {name}",
                    lambda: sweep([name], seed=FAULT_SEED,
                                  schedules=FAULT_SCHEDULES, n=FAULT_N,
                                  out_dir=outdir, wires=(), verbose=False,
                                  device=dev, stats=stats))
            finally:
                sc["ticks"] = full
            launches_all += launched
            r, st = rows[0], stats[name]
            check(r["ok"], f"{kind} {name}: {r['error']}")
            if name == FAULT_TIMED:
                explore = [c for c in calls if c[0].shape[0] == rows_of]
                check(explore, f"{name}: no band-copy call on the "
                      f"explore's [{rows_of}, L] rings")
                best = max(explore, key=lambda c: int(c[5].sum()))
                timed = _time_band_copies(torch, cuda_ops, [best])
                check(timed["err"] == 0, f"kernel != plain on an {name} "
                      f"explore tick's inputs ({timed['err']})")
                out["band_copy"] = dict(timed, rows=list(best[0].shape),
                                        written=int(best[5].sum()))
            if "artifact" in st:
                _replays_on_cpu(dst, st["artifact"])
                what = (f"caught {st['caught']}/{st['schedules']}, fault "
                        f"events {st['faults_before']} -> "
                        f"{st['faults_after']} in {st['shrink_evals']} "
                        f"evals, oracle diverged_at {st['diverged_at']}, "
                        f"the card's artifact replays on the CPU")
            else:
                what = (f"contained: 0/{st['schedules']} violations, "
                        f"{st['recovery_events']} recovery events")
            out["rows"][name] = dict(
                {k: v for k, v in st.items() if k != "artifact"},
                kind=kind, band_copy_launches=launched)
            log(f"  {kind} {name} ({min(full, FAULT_TICKS)} ticks): ok in "
                f"{st['secs']:.2f} s; {what}; "
                f"append_band_copy launches {launched}, one a tick, "
                f"each of {len(calls)} calls = plain")
    out["secs"] = time.perf_counter() - t_phase
    out["band_copy_launches"] = launches_all
    bc = out["band_copy"]
    log(f"  phase 20 in {out['secs']:.1f} s; {launches_all} band-copy "
        f"launches; {FAULT_TIMED}'s {bc['rows']} explore call "
        f"({bc['written']} slots written): kernel {bc['ms']:.4f} ms, plain "
        f"{bc['plain_ms']:.4f}, torch.where x2 {bc['library_ms']:.4f}, "
        f"bound {bc['bound_ms']:.6f}, max|kernel - plain| = {bc['err']}")
    return out


def matmul_tol(torch, ref, k: int) -> float:
    """bf16: 2 bf16 ulps of max|ref|; f32: 1e-5 of max|ref|, scaled by
    sqrt(K / 512) past K = 512."""
    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.frexp(top)[1] - 8)
    return 1e-5 * max(1.0, math.sqrt(k / 512)) * top


def variant_launches(cuda_ops) -> dict:
    return {v: cuda_ops.LAUNCHES[f"matmul_{v}"]
            for v in cuda_ops.MATMUL_VARIANTS}


def phase_float_kernels_vs_plain(torch, cuda_ops) -> dict:
    """Returns the largest |kernel - plain| of each kernel."""
    g = torch.Generator(device="cuda").manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [(256, 128, 384), (128, 512, 128), (32, 32, 32)]
    cases = [(s, dt) for s in shapes for dt in (bf16, f32)]
    cases += [((384, 384, 384), bf16), ((200, 72, 136), bf16),
              ((128, 32, 64), bf16), ((100, 70, 130), bf16),
              ((TASK_N, TASK_N, TASK_N), bf16)]
    worst = {"matmul": 0.0, "sumsq": 0.0}
    for (m, k, n), dt in cases:
        # the shape rule, written out independently of cuda_ops
        want_variant = "simt" if dt == f32 else \
            "wgmma" if k % 8 == 0 and n % 8 == 0 else "wmma"
        a = torch.randn((m, k), device="cuda", generator=g).to(dt)
        b = torch.randn((k, n), device="cuda", generator=g).to(dt)
        before = variant_launches(cuda_ops)
        got = cuda_ops.matmul(a, b, tile_m=m, tile_n=n, tile_k=k)
        ran = {v: c - before[v] for v, c in variant_launches(cuda_ops).items()}
        want = cuda_ops.matmul_plain(a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = matmul_tol(torch, want, k)
        log(f"  matmul {str(dt)[6:]} [{m},{k}]@[{k},{n}] on {want_variant}: "
            f"max|diff|={err:.6g}, tolerance {tol:.6g}")
        check(ran == {v: int(v == want_variant) for v in ran},
              f"[{m},{k}]@[{k},{n}] {dt} ran {ran}, not {want_variant}")
        check(err <= tol, f"matmul kernel != plain on [{m},{k}]@[{k},{n}]")
        worst["matmul"] = max(worst["matmul"], err)
    x = torch.randn((TASK_N, TASK_N), device="cuda",
                    generator=g).to(torch.bfloat16)
    got, again = cuda_ops.sumsq(x), cuda_ops.sumsq(x)
    want = cuda_ops.sumsq_plain(x)
    torch.cuda.synchronize()
    err = abs(float(got) - float(want))
    log(f"  sumsq bf16 [{TASK_N},{TASK_N}]: kernel {float(got)!r}, plain "
        f"{float(want)!r}, relative diff {err / float(want):.3g} "
        f"(tolerance 1e-5); two calls bit-equal: {torch.equal(got, again)}")
    check(err <= 1e-5 * float(want), "sumsq kernel != plain")
    check(torch.equal(got, again), "sumsq is not deterministic")
    worst["sumsq"] = err
    return worst


def drive_task(image: str, args: list, device: str, operands=None,
               executor=None, slot: int = 0, secrets=()):
    """One task ASSIGNED -> COMPLETE through do_task_state, the way the
    agent's worker drives a controller (on `executor`, else a fresh one on
    `device`).  Returns (controller, describe, prepare s, run s): the
    seconds of the prepare call and of the start+wait calls."""
    from swarmkit_tpu_torch.agent.exec import do_task_state
    from swarmkit_tpu_torch.agent.tpu import TpuExecutor
    from swarmkit_tpu_torch.api import (
        Annotations, ContainerSpec, Task, TaskSpec, TaskState, TaskStatus,
    )

    async def go():
        ex = executor or TpuExecutor(hostname="chip", device=device)
        task = Task(id="t", slot=slot, spec=TaskSpec(container=ContainerSpec(
            image=image, args=list(args), secrets=list(secrets))),
            status=TaskStatus(state=TaskState.ASSIGNED),
            desired_state=TaskState.RUNNING,
            service_annotations=Annotations(name="chip"))
        ctl = await ex.controller(task, operands=operands)
        spent = {}
        while True:
            state = task.status.state
            t0 = time.perf_counter()
            st = await do_task_state(task, ctl, now=time.time())
            spent[state] = time.perf_counter() - t0
            if st is None:
                break
            task.status = st
        check(task.status.state == TaskState.COMPLETE,
              f"{image} {args} on {device} ended {task.status.state.name}: "
              f"{task.status.err}")
        return ctl, (await ex.describe()), spent[TaskState.PREPARING], \
            spent[TaskState.STARTING] + spent[TaskState.RUNNING]

    return asyncio.run(go())


def phase_executor(torch, cuda_ops) -> dict:
    args = [f"n={TASK_N}", f"steps={TASK_STEPS}", "seed=0"]
    flop = TASK_STEPS * 2 * TASK_N ** 3
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    ctl, desc, prep_s, run_s = drive_task("tpu://pallas_matmul", args,
                                          "cuda")
    launches = dict(cuda_ops.LAUNCHES)
    log(f"  tpu://pallas_matmul {' '.join(args)}: prepare {prep_s:.3f} s, "
        f"run {run_s:.3f} s, {flop / run_s / 1e12:.1f} TFLOP/s "
        f"({flop / 1e12:.2f} TFLOP), result {ctl.result!r}, launches "
        f"{launches}")
    log(f"  describe: {desc.resources.generic} "
        f"{desc.resources.generic_named}, {desc.engine.engine_version}")
    check(math.isfinite(ctl.result), "pallas_matmul result is not finite")
    check(launches["matmul"] == TASK_STEPS,
          f"matmul launched {launches['matmul']} times, not {TASK_STEPS}")
    check(launches["matmul_wgmma"] == TASK_STEPS,
          f"the wgmma kernel ran {launches['matmul_wgmma']} of the "
          f"{TASK_STEPS} products")
    check(launches["sumsq"] == TASK_STEPS,
          f"sumsq launched {launches['sumsq']} times, not {TASK_STEPS}")
    check(desc.resources.generic == {"gpu-chip": 1}, "describe on the card")
    out = dict(prepare_s=prep_s, run_s=run_s, tflop_per_s=flop / run_s / 1e12,
               launches=launches, result=ctl.result, a=ctl._args[0])
    # twice: the first run in a fresh executor thread also sets up cuBLAS
    out["xla_chain_run_s"] = []
    for _ in range(2):
        _, _, prep_x, run_x = drive_task("tpu://matmul", args, "cuda")
        log(f"  tpu://matmul (torch.matmul chain) same size: prepare "
            f"{prep_x:.3f} s, run {run_x:.3f} s, {flop / run_x / 1e12:.1f} "
            f"TFLOP/s")
        out["xla_chain_run_s"].append(run_x)
    for image in ("tpu://axpy", "tpu://spin"):
        c, _, p, r = drive_task(image, [], "cuda")
        check(math.isfinite(c.result), f"{image} result is not finite")
        log(f"  {image}: result {c.result!r}, prepare {p:.3f} s, run "
            f"{r:.3f} s")

    small = ["n=1024", "steps=4", "seed=1"]
    card = drive_task("tpu://pallas_matmul", small, "cuda")[0]
    cpu = drive_task("tpu://pallas_matmul", small, "cpu")[0]
    a_card, a_cpu = card._args[0], cpu._args[0]
    check(torch.equal(a_card.cpu(), a_cpu), "seeded operands differ")
    got = cuda_ops.matmul_chain(a_card, a_card, 4).float().cpu()
    want = cuda_ops.matmul_chain(a_cpu, a_cpu, 4).float()
    diff = (got - want).abs()
    check(bool((diff <= 1e-1 + 1e-1 * want.abs()).all()),
          "card and CPU chains differ beyond rtol=atol=1e-1")
    bound = float(diff.sum() + 1e-5 * want.abs().sum())
    log(f"  pallas_matmul n=1024 steps=4: card {card.result!r}, cpu "
        f"{cpu.result!r}, |diff| {abs(card.result - cpu.result):.6g} <= "
        f"{bound:.6g} (sum of the chains' |diff| {float(diff.sum()):.6g}, "
        f"max {float(diff.max()):.6g}; tolerance rtol=atol=1e-1)")
    check(abs(card.result - cpu.result) <= bound, "card and CPU results")
    return out


def phase_float_kernels_on_path(torch, cuda_ops, a) -> dict:
    """Time matmul and sumsq on the calls one step of the task makes."""
    calls = {"matmul": [], "sumsq": []}
    kernel = {"matmul": cuda_ops.matmul, "sumsq": cuda_ops.sumsq}

    def rec_matmul(x, b, **kw):
        calls["matmul"].append((x, b, kw))
        return kernel["matmul"](x, b, **kw)

    def rec_sumsq(x, **kw):
        calls["sumsq"].append((x, kw))
        return kernel["sumsq"](x, **kw)

    cuda_ops.matmul, cuda_ops.sumsq = rec_matmul, rec_sumsq
    try:
        cuda_ops.matmul_chain(a, a, 1)
    finally:
        cuda_ops.matmul, cuda_ops.sumsq = kernel["matmul"], kernel["sumsq"]
    torch.cuda.synchronize()
    check(len(calls["matmul"]) == 1 and len(calls["sumsq"]) == 1,
          f"one step made {len(calls['matmul'])} matmul and "
          f"{len(calls['sumsq'])} sumsq calls")
    (x, b, kw), = calls["matmul"]
    (y, skw), = calls["sumsq"]
    m, k = x.shape
    n = b.shape[1]
    plain_mm = cuda_ops.matmul_plain(x, b).float()
    before = variant_launches(cuda_ops)["wgmma"]
    err_mm = float((kernel["matmul"](x, b, **kw).float() - plain_mm)
                   .abs().max())
    check(variant_launches(cuda_ops)["wgmma"] == before + 1,
          "the task's product did not run on the wgmma kernel")
    err_wmma = float((cuda_ops._matmul_launch(x, b, "wmma").float()
                      - plain_mm).abs().max())
    tol = matmul_tol(torch, plain_mm.to(x.dtype), k)
    check(max(err_mm, err_wmma) <= tol,
          f"matmul kernels != plain on the task's inputs ({err_mm}, "
          f"{err_wmma} > {tol})")
    plain_ss = float(cuda_ops.sumsq_plain(y))
    err_ss = abs(float(kernel["sumsq"](y, **skw)) - plain_ss)

    def timed(fns: dict, reps: int, replays: int) -> dict:
        # the kernel in turns with the others (plain, previous, kernel,
        # kernel, previous, plain) so drift hits them alike
        others = [name for name in fns if name not in ("kernel", "library")]
        t = {}
        for name in others + ["kernel", "kernel"] + others[::-1]:
            t.setdefault(name, []).append(
                graph_ms(torch, fns[name], reps, replays))
        out = {name: sum(v) / len(v) for name, v in t.items()}
        out["library"] = min(graph_ms(torch, f, reps, replays)
                             for f in fns["library"])
        return out

    mm = timed({"kernel": lambda: kernel["matmul"](x, b, **kw),
                "plain": lambda: cuda_ops.matmul_plain(x, b),
                "previous": lambda: cuda_ops._matmul_launch(x, b, "wmma"),
                "library": [lambda: torch.matmul(x, b)]}, 4, 3)
    flop = 2 * m * n * k
    mm_bytes = (m * k + k * n + m * n) * x.element_size()
    mm["bound"] = max(flop / BF16_FLOP_PER_S, mm_bytes / HBM_BYTES_PER_S) \
        * 1e3
    mm["err"] = err_mm
    log(f"  matmul [{m},{k}]@[{k},{n}] bf16: device wgmma kernel "
        f"{mm['kernel']:.4f} ms ({flop / mm['kernel'] / 1e9:.1f} TFLOP/s), "
        f"WMMA kernel {mm['previous']:.4f} ms "
        f"({flop / mm['previous'] / 1e9:.1f} TFLOP/s, "
        f"{mm['previous'] / mm['kernel']:.2f}x the wgmma time), plain "
        f"{mm['plain']:.4f} ms, torch.matmul {mm['library']:.4f} ms, "
        f"bound {mm['bound']:.4f} ms (operations); max|diff| wgmma "
        f"{err_mm:.6g}, WMMA {err_wmma:.6g} (tolerance {tol:.6g})")

    ss = timed({"kernel": lambda: kernel["sumsq"](y, **skw),
                "plain": lambda: cuda_ops.sumsq_plain(y),
                "library": [
                    lambda: torch.linalg.vector_norm(
                        y, dtype=torch.float32) ** 2,
                    lambda: y.float().square().sum()]}, 20, 5)
    ss_bytes = y.numel() * y.element_size()
    ss["bound"] = max(ss_bytes / HBM_BYTES_PER_S,
                      2 * y.numel() / F32_FLOP_PER_S) * 1e3
    ss["err"] = err_ss
    log(f"  sumsq [{y.shape[0]},{y.shape[1]}] bf16: device kernel "
        f"{ss['kernel']:.4f} ms ({ss_bytes / ss['kernel'] / 1e6:.0f} GB/s), "
        f"plain {ss['plain']:.4f} ms, library {ss['library']:.4f} ms, bound "
        f"{ss['bound']:.4f} ms (bytes); |diff| {err_ss:.6g} (relative "
        f"{err_ss / plain_ss:.3g})")
    return {"matmul": mm, "sumsq": ss}


# ---- phase 21: the executor's rest; phase 22: the device wire ----------

PMATMUL_BATCH = 8            # the JAX program's default batch
PMATMUL_SMALL = dict(n=256, batch=4, steps=4)   # card against the CPU
# the templated secret of the JAX package's executor test: slot 2 expands
# n=3{{.Task.Slot}} to n=32
SECRET_DATA = b"n=3{{.Task.Slot}}\nsteps=2"
WIRE_MANAGERS = 3            # Docker's smallest fault-tolerant quorum
WIRE_ROWS = 8                # mailbox rows: room for a quorum of 7
WIRE_PROPOSALS = 256
WIRE_DROP = 0.05


def _pmatmul_args(n: int, batch: int, steps: int, seed: int = 0) -> list:
    return [f"n={n}", f"steps={steps}", f"batch={batch}", f"seed={seed}"]


def _on_host(shards):
    """The shards of a sharded task, in order, as one CPU tensor."""
    import torch

    return torch.cat([x.cpu() for x in shards])


def phase_executor_rest(torch, task7: dict, card: str = "cuda",
                        n: int = TASK_N, steps: int = TASK_STEPS) -> dict:
    """tpu://pmatmul at the JAX program's default batch over every card (at
    n x n activations, `steps` steps), and at n=256 against the CPU; a
    task whose parameters come from a templated secret; describe; the
    buffer's watch()."""
    from swarmkit_tpu_torch import api
    from swarmkit_tpu_torch.agent import tpu
    from swarmkit_tpu_torch.agent.dependency import Dependencies

    out = {}
    cards = tpu.TpuExecutor(device=card).devices
    args = _pmatmul_args(n, PMATMUL_BATCH, steps)
    flop = steps * 2 * PMATMUL_BATCH * n ** 3
    # twice: a card's first product in a fresh executor thread also sets
    # up cuBLAS there (phase 7 has done so on the first card only)
    runs = [drive_task("tpu://pmatmul", args, card) for _ in range(2)]
    ctl, desc = runs[-1][:2]
    prep_s = [r[2] for r in runs]
    run_s = [r[3] for r in runs]
    d = tpu.pmatmul_shards(PMATMUL_BATCH, cards)
    check(len(ctl._args) == d and all(
        x.device == dev for x, dev in zip(ctl._args, cards)),
        f"pmatmul ran {len(ctl._args)} shards, not one on each of {d} "
        f"cards")
    check(math.isfinite(ctl.result), "pmatmul result is not finite")
    chain = [TASK_STEPS * 2 * TASK_N ** 3 / r / 1e12
             for r in task7.get("xla_chain_run_s", [])]
    rates = [flop / r / 1e12 for r in run_s]
    log(f"  tpu://pmatmul {' '.join(args)} on {d} card(s) "
        f"({PMATMUL_BATCH * n * n * 2 / 2**30:.2f} GiB of bf16 "
        f"activations, {flop / 1e12:.2f} TFLOP), twice: prepare "
        f"{', '.join(f'{p:.3f}' for p in prep_s)} s, run "
        f"{', '.join(f'{r:.3f}' for r in run_s)} s, "
        f"{', '.join(f'{r:.1f}' for r in rates)} TFLOP/s; tpu://matmul "
        f"(phase 7, batch 1) {', '.join(f'{c:.1f}' for c in chain)} "
        f"TFLOP/s; result {ctl.result!r}")
    check(runs[0][0].result == ctl.result, "pmatmul gave two results")
    out["pmatmul"] = dict(shards=d, prepare_s=prep_s, run_s=run_s,
                          tflop=flop / 1e12, tflop_per_s=rates,
                          matmul_tflop_per_s=chain)
    gen = ", ".join(f"{k}: {v}" for k, v in desc.resources.generic.items())
    log(f"  describe: {gen} {desc.resources.generic_named}")
    if card == "cuda":
        want = {"gpu-chip": torch.cuda.device_count()}
        check(desc.resources.generic == want, f"describe {gen} != {want}")
        check(desc.resources.generic_named["gpu-chip"] == [
            str(i) for i in range(torch.cuda.device_count())],
            "describe does not name every card")
    del ctl, runs

    sm = PMATMUL_SMALL
    args = _pmatmul_args(sm["n"], sm["batch"], sm["steps"], seed=1)
    got = drive_task("tpu://pmatmul", args, card)[0]
    ref = drive_task("tpu://pmatmul", args, "cpu")[0]
    a_card = tpu._seeded_normal((sm["n"], sm["n"]), 1, card)
    a_cpu = a_card.cpu()
    check(torch.equal(_on_host(got._args), _on_host(ref._args)),
          "seeded pmatmul operands differ between card and CPU")
    x_card = _on_host(tpu.pmatmul_chain(
        list(got._args), [a_card.to(x.device) for x in got._args],
        sm["steps"])).float()
    x_cpu = _on_host(tpu.pmatmul_chain(
        list(ref._args), [a_cpu] * len(ref._args), sm["steps"])).float()
    diff = (x_card - x_cpu).abs()
    check(bool((diff <= 1e-1 + 1e-1 * x_cpu.abs()).all()),
          "pmatmul chains differ beyond rtol=atol=1e-1")
    bound = float(diff.sum() + 1e-5 * x_cpu.abs().sum())
    log(f"  pmatmul {' '.join(args)}: card {got.result!r}, cpu "
        f"{ref.result!r}, |diff| {abs(got.result - ref.result):.6g} <= "
        f"{bound:.6g} (chains' max|diff| {float(diff.max()):.6g}; "
        f"tolerance rtol=atol=1e-1)")
    check(abs(got.result - ref.result) <= bound, "pmatmul card and CPU")
    out["pmatmul_small"] = dict(card=got.result, cpu=ref.result,
                                max_abs_err=float(diff.max()))

    ex = tpu.TpuExecutor(hostname="chip", device=card)
    ex.dependencies = Dependencies()
    ex.dependencies.secrets.add(api.Secret(id="sec1", spec=api.SecretSpec(
        annotations=api.Annotations(name="tuning"), data=SECRET_DATA,
        templating=api.Driver(name="golang"))))
    watcher = ex.logs.watch()
    ctl = drive_task("tpu://matmul", ["seed=0"], card, executor=ex, slot=2,
                     secrets=[api.SecretReference(secret_id="sec1",
                                                  secret_name="tuning")])[0]
    lines = [m.data.decode() for m in watcher.poll()]
    watcher.close()
    check(ctl._args[0].shape == (32, 32) and ctl._args[0].device.type
          == torch.device(card).type, "the secret's n=32 did not reach the "
          "program on the card")
    check(any("n=<from-dependency>" in ln and "steps=<from-dependency>" in ln
              for ln in lines), f"prepare line names no dependency: {lines}")
    check(not any("n=32" in ln or "steps=2" in ln for ln in lines),
          f"a secret value reached the logs: {lines}")
    want = ["prepared tpu://matmul seed=0 n=<from-dependency> "
            f"steps=<from-dependency> on {ex.device}", "started on device",
            f"result: {ctl.result}", "task complete"]
    check(lines == want, f"watch() gave {lines}, not {want}")
    log(f"  secret-templated task on {ex.device}: watch() gave "
        f"{len(lines)} lines in order: {lines}")
    out["secret_task_lines"] = lines
    return out


class _WireClock:
    """The wire's clock: raft ticks, advanced by the run loop."""

    def __init__(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(0)


class WireNode:
    """One raft/core.py Raft behind a DeviceMeshTransport: the server the
    wire delivers to and the handlers its transport reports to.  Each
    step's outbox goes out through the transport; entries are stable as
    soon as appended, and committed entries are applied at once."""

    def __init__(self, net, raft_id: int, peers: tuple, clock,
                 seed: int) -> None:
        from swarmkit_tpu_torch.raft.core import Config, Raft
        from swarmkit_tpu_torch.transport import DeviceMeshTransport

        self.raft = Raft(Config(id=raft_id, peers=peers, election_tick=10,
                                heartbeat_tick=1, check_quorum=True,
                                seed=seed))
        self.addr = f"manager-{raft_id}"
        self.transport = DeviceMeshTransport(net, self, self.addr, clock)
        for p in peers:
            if p != raft_id:
                self.transport.add_peer(p, f"manager-{p}")
        net.register(self.addr, self)

    def ready(self) -> None:
        log_ = self.raft.log
        log_.stabilized(log_.last_index())
        log_.applied_to(log_.committed)
        msgs, self.raft.msgs = self.raft.msgs, []
        for m in msgs:
            self.transport.send(m)

    def step(self, m) -> None:
        self.raft.step(m)
        self.ready()

    async def process_raft_message(self, m) -> None:
        self.step(m)

    def report_unreachable(self, raft_id: int, failures: int = 1) -> None:
        from swarmkit_tpu_torch.raft.messages import Message, MsgType

        if failures and self.raft.state == "leader":
            self.step(Message(type=MsgType.UNREACHABLE, frm=raft_id))

    def report_snapshot(self, raft_id: int, ok: bool) -> None:
        from swarmkit_tpu_torch.raft.messages import Message, MsgType

        if self.raft.state == "leader":
            self.step(Message(type=MsgType.SNAP_STATUS, frm=raft_id,
                              reject=not ok))

    def is_id_removed(self, raft_id: int) -> bool:
        return False

    def node_removed(self) -> None:
        pass

    def committed(self) -> list:
        log_ = self.raft.log
        return [(e.index, e.term, int(e.type), e.data)
                for e in log_.slice(log_.first_index(), log_.committed + 1)]


async def _wire_quorum_run(net, seed: int, proposals: int, drop: float):
    """Three WireNodes on `net`: elect, commit `proposals` entries (half
    before and half after a partition of the leader) under `drop` loss on
    every edge, heal, and run until the logs are equal.  Returns the nodes
    and the counts of the run."""
    from swarmkit_tpu_torch.raft.messages import Entry, Message, MsgType

    clock = _WireClock()
    ids = tuple(range(1, WIRE_MANAGERS + 1))
    nodes = [WireNode(net, i, ids, clock, seed) for i in ids]
    ticks = 0

    async def settle():
        for _ in range(64):
            await asyncio.sleep(0)
            if not net._staged:
                return

    async def tick(n: int = 1):
        nonlocal ticks
        for _ in range(n):
            clock.t += 1.0
            ticks += 1
            for nd in nodes:
                if nd.addr not in net._down:
                    nd.raft.tick()
                    nd.ready()
            await settle()

    def leaders(among):
        return [nd for nd in among if nd.raft.state == "leader"]

    async def until(pred, what: str, limit: int = 400):
        for _ in range(limit):
            if pred():
                return
            await tick()
        fail(f"device wire: {what} within {limit} ticks")

    await until(lambda: len(leaders(nodes)) == 1, "no leader elected")
    first = leaders(nodes)[0]
    elected_at = ticks
    for a in nodes:
        for b in nodes:
            if a is not b:
                net.set_drop(a.addr, b.addr, drop)
    payloads = [f"proposal-{i}".encode() for i in range(proposals)]

    async def propose(batch, among):
        for p in batch:
            await until(lambda: len(leaders(among)) == 1,
                        "no leader for a proposal")
            leaders(among)[0].step(Message(type=MsgType.PROP,
                                           entries=(Entry(data=p),)))
            await settle()

    def committed_everywhere(among, batch):
        want = set(batch)
        return all(want <= {e[3] for e in nd.committed()} for nd in among)

    half = proposals // 2
    await propose(payloads[:half], nodes)
    await until(lambda: committed_everywhere(nodes, payloads[:half]),
                "the first half committed on every node")
    rest = [nd for nd in nodes if nd is not first]
    net.partition({first.addr}, {nd.addr for nd in rest})
    await until(lambda: len(leaders(rest)) == 1
                and first.raft.state != "leader",
                "re-election after the leader's partition")
    second = leaders(rest)[0]
    reelected_at = ticks
    await propose(payloads[half:], rest)
    await until(lambda: committed_everywhere(rest, payloads[half:]),
                "the second half committed on the majority")
    net.heal()
    for a in nodes:
        for b in nodes:
            if a is not b:
                net.set_drop(a.addr, b.addr, drop)
    await until(lambda: committed_everywhere(nodes, payloads)
                and len({tuple(nd.committed()) for nd in nodes}) == 1
                and len({nd.raft.log.last_index() for nd in nodes}) == 1,
                "equal logs after the heal")
    return nodes, dict(ticks=ticks, elected_at=elected_at,
                       reelected_at=reelected_at, first_leader=first.raft.id,
                       second_leader=second.raft.id, dropped=net.dropped,
                       delivered=net.delivered)


def _histogram_quantile(fam, q: float) -> float:
    """The upper edge of the histogram bucket that holds quantile q."""
    child = fam._default()
    counts = child.cumulative()
    total = counts[-1]
    for edge, c in zip(list(child.buckets) + [math.inf], counts):
        if c >= q * total:
            return edge
    return math.inf


def wire_flush_script(seed: int = 0) -> list:
    """(frm, to, k, raw) slots of a scripted flush for each width bucket
    of the mailbox: every edge among WIRE_ROWS rows, one to three messages
    an edge, the widest of each exchange needing that bucket."""
    import random

    from swarmkit_tpu_torch.raft.messages import Entry, Message, MsgType
    from swarmkit_tpu_torch.raft.wire import encode_message
    from swarmkit_tpu_torch.transport import device_mesh

    rng = random.Random(seed)
    scripts = []
    for w in device_mesh.W_BUCKETS:
        entries = []
        for frm in range(WIRE_ROWS):
            for to in range(WIRE_ROWS):
                for k in range(rng.randint(1, 3)):
                    size = rng.randint(0, 4 * w - 200)
                    if (frm, to, k) == (0, 1, 0):
                        size = 4 * w - 200   # the widest fills the bucket
                    m = Message(type=MsgType.APP, to=to + 1, frm=frm + 1,
                                term=rng.randint(1, 9), index=rng.randint(
                                    0, 1 << 40),
                                entries=(Entry(index=1, term=1,
                                               data=rng.randbytes(size)),))
                    entries.append((frm, to, k, encode_message(m)))
        scripts.append(entries)
    return scripts


def phase_device_wire(torch, card: str = "cuda",
                      proposals: int = WIRE_PROPOSALS) -> dict:
    """Three raft/core.py nodes over DeviceMeshTransports on a card's
    DeviceMeshNet, and a scripted flush through every width bucket on the
    card and on the CPU."""
    import numpy as np

    from swarmkit_tpu_torch.metrics import catalog, registry
    from swarmkit_tpu_torch.transport import DeviceMeshNet, device_mesh

    reg = registry.MetricsRegistry()
    net = DeviceMeshNet(seed=0, rows=WIRE_ROWS, device=card, obs=reg)
    t0 = time.perf_counter()
    try:
        nodes, run = asyncio.run(_wire_quorum_run(net, 0, proposals,
                                                  WIRE_DROP))
    finally:
        net.close()
    secs = time.perf_counter() - t0
    logs = {tuple(nd.committed()) for nd in nodes}
    check(len(logs) == 1, "the managers' logs differ")
    n_entries = len(next(iter(logs)))
    fam = catalog.get(reg, "swarm_transport_exchange_seconds")
    p50, p99 = (_histogram_quantile(fam, q) for q in (0.5, 0.99))
    mean = fam._default().sum / max(fam._default().count, 1)
    check(net.device_flushes > 0 and
          catalog.get(reg, "swarm_transport_device_flushes_total").value
          == net.device_flushes, "flush counter and metric disagree")
    log(f"  {WIRE_MANAGERS} managers on {net.device}: leader "
        f"{run['first_leader']} at tick {run['elected_at']}, partitioned, "
        f"{run['second_leader']} re-elected at tick {run['reelected_at']}; "
        f"{proposals} proposals committed on every node ({n_entries} "
        f"entries, equal logs) in {run['ticks']} ticks, {secs:.2f} s; "
        f"{net.device_flushes} flushes, {net.device_messages} messages, "
        f"{run['dropped']} dropped ({WIRE_DROP:.0%} an edge), exchange "
        f"p50 <= {p50} s, p99 <= {p99} s (histogram bucket edges), mean "
        f"{mean:.6f} s")
    out = dict(run, secs=secs, entries=n_entries,
               flushes=net.device_flushes, messages=net.device_messages,
               exchange_p50_le_s=p50, exchange_p99_le_s=p99,
               exchange_mean_s=mean)

    nets = {dev: DeviceMeshNet(rows=WIRE_ROWS, device=dev)
            for dev in (card, "cpu")}
    rng = np.random.default_rng(0)
    out["flush"] = []
    for entries in wire_flush_script():
        words, lens, keep = nets[card].pack(entries)
        keep[:] = rng.random(keep.shape) < 0.9
        res = {dev: n.run_exchange(words, lens, keep)
               for dev, n in nets.items()}
        for a, b in zip(res[card], res["cpu"]):
            check(np.array_equal(a, b), "card and CPU exchanges differ")
        d_words, d_lens = res[card]
        for frm, to, k, raw in entries:
            n = int(d_lens[to, frm, k])
            if keep[frm, to, k]:
                check(d_words[to, frm, k].tobytes()[:n] == raw,
                      "a delivered slot's bytes differ")
            else:
                check(n == 0, "a blocked slot came back with a length")
        blocked = int((~keep & (lens > 0)).sum())
        out["flush"].append(dict(shape=list(words.shape),
                                 messages=len(entries), blocked=blocked))
        log(f"  scripted flush {tuple(words.shape)} "
            f"({words.nbytes / 2**20:.2f} MiB, {len(entries)} messages, "
            f"{blocked} blocked): card = CPU, bytes and lengths")
    widths = [f["shape"][3] for f in out["flush"]]
    check(widths == list(device_mesh.W_BUCKETS),
          f"the script used widths {widths}")
    return out


# ---- phase 23: the meshes (parallel/) on the card -----------------------

SHARD_ENTRIES = 4        # one card named this many times when alone
SHARD_DST_S = 256        # tools/dst_sweep.py's documented sweep width
SHARD_GROUPS = 1024      # bench.py's multiraft-1024x3 fleet
SHARD_GROUP_TICKS = 128
RUNG = 32768             # bench.py's 32768-sharded rung
RUNG_STEADY = 2          # 64-tick run_ticks chunks after the election
RUNG_PROBES = (4096, 8192)   # peak-memory probes before the rung
RUNG_MEMORY_CAP_GIB = 70.0   # the rung runs only if predicted below this


def shard_devices(torch) -> list:
    """The mesh entries of phase 23: every card where there are several,
    else cuda:0 named SHARD_ENTRIES times (each entry one shard, as the
    CPU's repeated device is in the tests)."""
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * SHARD_ENTRIES


def _sync_all(torch, devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _same_fields(sim, a, b, label: str) -> int:
    import numpy as np

    got, want = sim.state_to_numpy(a), sim.state_to_numpy(b)
    check(sorted(got) == sorted(want), f"{label}: field sets differ")
    for name in want:
        check(np.array_equal(got[name], want[name]),
              f"{label}: field {name} differs from the unsharded run")
    return len(want)


def _sharded_dst(torch, sim, cuda_ops, devices, dev) -> dict:
    """explore at SHARD_DST_S x DST_TICKS on PROFILES (reads 2): unsharded
    on the card, then over schedule_mesh(S) of `devices`; equal masks and
    final fields, one band-copy launch a tick a shard."""
    import numpy as np

    from swarmkit_tpu_torch import dst, parallel
    from swarmkit_tpu_torch.tools import dst_sweep

    cfg = dst_sweep._cfg(5, 0, reads=2)
    sched, names = dst.make_batch(cfg, DST_TICKS, SHARD_DST_S, seed=0,
                                  profiles=dst.PROFILES, device=dev)
    mesh = parallel.schedule_mesh(SHARD_DST_S, devices)
    d = mesh.size
    runs = {}
    for label, kw in (("unsharded", dict(shard=False)),
                      ("sharded", dict(mesh=mesh))):
        cuda_ops.reset_launches()
        with _BandCopies(cuda_ops, d if label == "sharded" else 0) \
                as rec:
            t0 = time.perf_counter()
            res = dst.explore(sim.init_state(cfg, device=dev), cfg, sched,
                              profiles=names, device=dev, **kw)
            _sync_all(torch, devices)
            secs = time.perf_counter() - t0
        runs[label] = (res, secs, cuda_ops.LAUNCHES["append_band_copy"], rec)
    (ru, su, lu, _), (rs, ss, ls, rec) = runs["unsharded"], runs["sharded"]
    check(np.array_equal(ru.viol, rs.viol)
          and np.array_equal(ru.first_tick, rs.first_tick)
          and np.array_equal(ru.bits_by_tick, rs.bits_by_tick),
          "sharded explore: masks differ from the unsharded run")
    fields = _same_fields(sim, rs.final_state, ru.final_state,
                          "sharded explore")
    check(lu == DST_TICKS and ls == DST_TICKS * d,
          f"explore launched append_band_copy {lu} (unsharded) and {ls} "
          f"(sharded over {d}) times in {DST_TICKS} ticks")
    err = rec.err(torch)
    check(err == 0, f"kernel != plain on a shard's sweep tick ({err})")
    log(f"  explore {SHARD_DST_S} x {DST_TICKS} over {d} entries "
        f"({SHARD_DST_S // d} schedules a shard): = unsharded on viol, "
        f"first_tick, bits_by_tick and all {fields} final fields; "
        f"{len(rs.violating)} violating; {su:.3f} s unsharded, {ss:.3f} s "
        f"sharded; append_band_copy launches {lu} / {ls} (one a tick a "
        f"shard); each shard's first call {list(rec.calls[0][0].shape)} = "
        f"plain")
    return dict(shards=d, unsharded_s=su, sharded_s=ss, launches=ls,
                unsharded_launches=lu, fields=fields, err=err)


def _sharded_fleet(torch, sim, cuda_ops, devices, dev) -> dict:
    """bench.py's multiraft-1024x3 fleet for SHARD_GROUP_TICKS ticks of
    fused proposals from a fresh fleet: unsharded, then over
    group_mesh(G) of `devices`; equal traces and fields."""
    import numpy as np

    from swarmkit_tpu_torch import multiraft, parallel
    from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
    from swarmkit_tpu_torch.tools import bench

    cfg = bench.multiraft_cfg(3, 7)
    mesh = parallel.group_mesh(SHARD_GROUPS, devices)
    d = mesh.size
    runs = {}
    for label in ("unsharded", "sharded"):
        g0 = multiraft.init_groups(cfg, SHARD_GROUPS, device=dev)
        if label == "sharded":
            g0 = parallel.shard_rows(g0, mesh, axis=parallel.GROUP_AXIS,
                                     leading=SHARD_GROUPS)
        cuda_ops.reset_launches()
        with _BandCopies(cuda_ops, d if label == "sharded" else 0) \
                as rec:
            _sync_all(torch, devices)
            t0 = time.perf_counter()
            out, trace = multiraft.run_group_ticks(
                g0, cfg, SHARD_GROUP_TICKS, prop_count=cfg.max_props,
                device=dev)
            _sync_all(torch, devices)
            secs = time.perf_counter() - t0
        runs[label] = (out, trace.cpu().numpy(), secs,
                       cuda_ops.LAUNCHES["append_band_copy"], rec)
    (ou, tu, su, lu, _), (os_, ts, ss, ls, rec) = (runs["unsharded"],
                                                   runs["sharded"])
    check(np.array_equal(tu, ts), "sharded fleet: trace rows differ")
    fields = _same_fields(sim, parallel.gather(os_), ou, "sharded fleet")
    led, committed = int(ts[-1, 0]), int(ts[-1, 1])
    check(led >= SHARD_GROUPS * 99 // 100 and committed > 0,
          f"sharded fleet: {led} groups led, {committed} committed")
    summ = multiraft.MultiRaftObs(registry=MetricsRegistry()).publish(os_)
    check(summ["groups_with_leader"] == led
          and summ["committed_entries"] == committed,
          f"MultiRaftObs on the sharded fleet: {summ}")
    check(lu == SHARD_GROUP_TICKS and ls == SHARD_GROUP_TICKS * d,
          f"the fleet launched append_band_copy {lu} / {ls} times")
    err = rec.err(torch)
    check(err == 0, f"kernel != plain on a shard's grouped tick ({err})")
    log(f"  fleet G={SHARD_GROUPS} x N=3, {SHARD_GROUP_TICKS} ticks over "
        f"{d} entries ({SHARD_GROUPS // d} groups a shard): = unsharded on "
        f"every trace row and all {fields} fields; {led} groups led, "
        f"{committed} committed (MultiRaftObs adds the shards up); "
        f"{su:.3f} s unsharded, {ss:.3f} s sharded; append_band_copy "
        f"launches {lu} / {ls}; each shard's first call "
        f"{list(rec.calls[0][0].shape)} = plain")
    return dict(shards=d, unsharded_s=su, sharded_s=ss, launches=ls,
                unsharded_launches=lu, fields=fields, err=err)


def _sharded_scan(torch, cuda_ops, devices, dev, n3h8: dict) -> dict:
    """mc_sweep's n3h8 scan over schedule_mesh(2^20) of `devices` against
    phase 16's unsharded run (summary: ladder, passes, widest pass, states,
    violations), and the smoke scope sharded against unsharded (summary,
    edges)."""
    from swarmkit_tpu_torch import mc, parallel

    sc = mc.SCOPES["n3h8"]
    mesh = parallel.schedule_mesh(MC_PASS_WIDTH, devices)
    d = mesh.size
    block = MC_PASS_WIDTH // d * sc.cfg().n
    cuda_ops.reset_launches()
    drop = ("elapsed_sec", "branches_per_sec")
    with _BandCopies(cuda_ops, d, rows=block) as rec:
        res = mc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon,
                                 prop_count=sc.prop_count,
                                 budget=sc.budget, mesh=mesh, scope="n3h8",
                                 device=dev)
        _sync_all(torch, devices)
    launched = cuda_ops.LAUNCHES["append_band_copy"]
    got = {k: v for k, v in res.summary().items() if k not in drop}
    check(got == n3h8["summary"],
          "sharded n3h8: the summary differs from phase 16's unsharded scan")
    err = rec.err(torch)
    check(err == 0, f"kernel != plain on a shard of an n3h8 pass ({err})")
    check(launched > res.passes, f"n3h8 over {d} entries: {launched} "
          f"band-copy launches in {res.passes} passes")
    s = mc.SCOPES["smoke"]
    smoke = [mc.exhaustive_scan(s.cfg(), s.alphabet(), s.horizon,
                                prop_count=s.prop_count, collect_edges=True,
                                scope="smoke", device=dev, **kw)
             for kw in (dict(shard=False),
                        dict(mesh=parallel.schedule_mesh(4096, devices)))]
    a, b = ({k: v for k, v in r.summary().items() if k not in drop}
            for r in smoke)
    check(a == b and smoke[0].edges == smoke[1].edges,
          "sharded smoke scan differs from the unsharded one")
    log(f"  n3h8 over {d} entries: = phase 16's unsharded scan on the "
        f"summary ({res.branches_explored:,} branches, "
        f"{res.states_discovered:,} states, {res.passes} passes, the "
        f"ladder); {res.elapsed:.3f} s against {n3h8['seconds']:.3f} s "
        f"unsharded ({res.timing['device_s']:.3f} s in device passes); "
        f"append_band_copy launches {launched} (one a pass a shard with "
        f"lanes); each shard's block of a wide pass "
        f"{list(rec.calls[0][0].shape)} = plain; smoke scope sharded = "
        f"unsharded on the summary and {len(smoke[1].edges)} edges")
    return dict(shards=d, seconds=res.elapsed,
                unsharded_s=n3h8["seconds"], launches=launched, err=err)


def _sharded_wire(torch, devices, dev) -> dict:
    """The device wire's all-to-all over a row mesh of `devices` against
    the one-card exchange, on phase 22's scripted flushes."""
    import numpy as np

    from swarmkit_tpu_torch import parallel
    from swarmkit_tpu_torch.transport import DeviceMeshNet

    mesh = parallel.row_mesh(WIRE_ROWS, devices)
    nets = [DeviceMeshNet(rows=WIRE_ROWS, device=dev,
                          mesh=parallel.row_mesh(WIRE_ROWS, [dev])),
            DeviceMeshNet(rows=WIRE_ROWS, device=dev, mesh=mesh)]
    rng = np.random.default_rng(1)
    for entries in wire_flush_script(seed=1):
        words, lens, keep = nets[0].pack(entries)
        keep[:] = rng.random(keep.shape) < 0.9
        one, many = (n.run_exchange(words, lens, keep) for n in nets)
        for a, b in zip(one, many):
            check(np.array_equal(a, b),
                  "the all-to-all differs from the one-card exchange")
        check(np.array_equal(many[0], words.transpose(1, 0, 2, 3)),
              "the all-to-all is not the transpose")
    log(f"  the wire's all-to-all over {mesh.size} entries "
        f"({WIRE_ROWS // mesh.size} rows an entry, {mesh.size ** 2} blocks "
        f"a tensor) = the one-card exchange on the four width buckets' "
        f"scripted flushes")
    return dict(shards=mesh.size)


def _cards(devices) -> list:
    """The distinct cards of a mesh's entries (None: the current card)."""
    cards = sorted({d.index for d in devices or ()
                    if d.type == "cuda" and d.index is not None})
    return cards or [None]


def _sync_cards(torch, devices=None) -> None:
    for c in _cards(devices):
        torch.cuda.synchronize(c)


def _reset_peaks(torch, devices=None) -> None:
    for c in _cards(devices):
        torch.cuda.reset_peak_memory_stats(c)


def _peak(torch, devices=None) -> int:
    """The highest card's peak device memory since the last reset."""
    return max(torch.cuda.max_memory_allocated(c) for c in _cards(devices))


def _held(torch, devices=None) -> int:
    """The device memory the fullest card holds now."""
    return max(torch.cuda.memory_allocated(c) for c in _cards(devices))


def _rung_run(torch, sim, cuda_ops, parallel, cfg, dev, steady: int,
              label: str, devices=None) -> dict:
    """bench.py's rung flow at cfg.n: the state placed on row_mesh(n)
    over the local cards (or over `devices`, every entry a shard),
    bench.py's chunked election, then `steady` 64-tick chunks of
    run_ticks(prop_count=max_props): host and device ms per tick, peaks
    after the election and after the steady ticks."""
    _sync_cards(torch, devices)
    torch.cuda.empty_cache()
    _reset_peaks(torch, devices)
    mesh = parallel.row_mesh(cfg.n, devices if devices is not None
                             else parallel.local_devices(dev))
    if devices is not None:
        check(mesh.size == len(devices),
              f"{label}: a row mesh of {mesh.size} of {len(devices)} entries")
    base = _held(torch, devices)
    st = parallel.shard_rows(sim.init_state(cfg, device=dev), mesh)
    peak_init = _peak(torch, devices)
    sim.kernel.reset_counts()
    t0 = time.perf_counter()
    ticks = 0
    while ticks < 2000 and not bool(sim.has_leader(st)):
        st, t = sim.run_until_leader(st, cfg, max_ticks=256, device=dev)
        ticks += t
    _sync_cards(torch, devices)
    t_elect = time.perf_counter() - t0
    check(bool(sim.has_leader(st)), f"{label}: no leader in 2000 ticks")
    e_counts = dict(sim.kernel.COUNTS)
    peak_elect = _peak(torch, devices)
    out = dict(n=cfg.n, election_ticks=ticks, election_s=t_elect,
               election_counts=e_counts, base_bytes=base,
               peak_init_bytes=peak_init, peak_election_bytes=peak_elect)
    if steady:
        sim.kernel.reset_counts()
        cuda_ops.reset_launches()
        parallel.reset_exchange()
        host, dev_ms, committed = [], [], 0
        for _ in range(steady):
            st, h, e, c = _timed_ticks(torch, sim, cfg, st, 64, device=dev)
            host.append(h)
            dev_ms.append(e)
            committed += c
        out.update(host_ms=host, device_ms=dev_ms, committed=committed,
                   entries_per_s=committed / (sum(host) * 64 / 1e3),
                   steady_counts=dict(sim.kernel.COUNTS),
                   exchange=dict(parallel.EXCHANGE),
                   band_copy_launches=cuda_ops.LAUNCHES["append_band_copy"])
    out["peak_bytes"] = _peak(torch, devices)
    out["state"] = st
    return out


def phase_rung(torch, sim, cuda_ops, card: str = "cuda", n: int = RUNG,
               probes=RUNG_PROBES) -> dict:
    """bench.py's 32768-sharded rung on one card: peak memory at the
    RUNG_PROBES widths first (election + 64 steady ticks), fitted as a N^2
    + b N L and extrapolated; the rung runs only if that stays under
    RUNG_MEMORY_CAP_GIB.  Then the rung itself: the election and
    RUNG_STEADY x 64 steady ticks, and the band copy on its rings against
    plain, timed."""
    from swarmkit_tpu_torch import parallel
    from swarmkit_tpu_torch.tools import bench

    dev = torch.device(card)
    name, rung_n, kw = bench.SHARDED_RUNG
    check(rung_n == RUNG and kw == {"shard": True, "peer_chunk": 1024},
          f"the bench's rung is {bench.SHARDED_RUNG}")

    def cfg_at(width):
        return bench.bench_cfg(width, 7, bench.election_tick_for(width),
                               peer_chunk=kw["peer_chunk"])
    runs = []
    for width in probes:
        r = _rung_run(torch, sim, cuda_ops, parallel, cfg_at(width), dev, 1,
                      f"n={width}")
        del r["state"]
        runs.append(r)
        log(f"  probe n={width}: election {r['election_ticks']} ticks in "
            f"{r['election_s']:.2f} s, peak {r['peak_bytes'] / 2**30:.3f} "
            f"GiB ({r['peak_init_bytes'] / 2**30:.3f} after init_state, "
            f"{r['peak_election_bytes'] / 2**30:.3f} after the election; "
            f"{r['base_bytes'] / 2**30:.3f} held before)")
    L = cfg_at(n).log_len
    a, b, predicted = _peak_fit(runs, n, L)
    log(f"  the run's own peak memory fit a N^2 + b N L: a = {a:.3f} B, "
        f"b = {b:.3f} B; predicted at n={n}: {predicted / 2**30:.2f} GiB")
    check(predicted + torch.cuda.memory_allocated()
          < RUNG_MEMORY_CAP_GIB * 2**30,
          f"the rung would need {predicted / 2**30:.1f} GiB")
    cfg = cfg_at(n)
    r = _rung_run(torch, sim, cuda_ops, parallel, cfg, dev, RUNG_STEADY,
                  name)
    st = r.pop("state")
    leaders = int(sim.leader_mask(st).sum())
    check(leaders == 1, f"{name}: {leaders} leaders")
    check(r["committed"] > 0, f"{name}: nothing committed")
    check(_checksums_agree(sim, st), f"{name}: checksum divergence")
    check(r["band_copy_launches"] > 0, f"{name}: no band-copy launch")
    torch.cuda.synchronize()
    calls = _record_band_copies(
        torch, sim, cuda_ops, cfg, st,
        lambda: sim.run_ticks(st, cfg, 1, prop_count=cfg.max_props,
                              device=dev))
    del st
    bc = _time_band_copies(torch, cuda_ops, calls)
    bc["chunks"] = [list(c[5].shape) for c in calls]
    bc["ring"] = list(calls[0][0].shape)
    del calls
    check(bc["err"] == 0, f"kernel != plain on the rung's rings "
          f"({bc['err']})")
    sc = r["steady_counts"]
    steady_ticks = RUNG_STEADY * 64
    log(f"  {name} (n={n}, L={L}, peer_chunk 1024, active_rows "
        f"{cfg.active_rows}, the whole state on one card): election "
        f"{r['election_ticks']} ticks in {r['election_s']:.2f} s (slab "
        f"{r['election_counts']['slab_ticks']}, dense fallback "
        f"{r['election_counts']['dense_fallback_ticks']}); "
        f"{steady_ticks} steady ticks: {r['entries_per_s']:,.1f} entries/s, "
        f"ms/tick host {[round(x, 3) for x in r['host_ms']]}, CUDA events "
        f"{[round(x, 3) for x in r['device_ms']]}; step host syncs "
        f"{sc['host_syncs'] / steady_ticks:.2f}/tick, slab "
        f"{sc['slab_ticks']} / fallback {sc['dense_fallback_ticks']}; "
        f"append_band_copy launches {r['band_copy_launches']}; peak "
        f"device memory {r['peak_init_bytes'] / 2**30:.3f} GiB after "
        f"init_state, {r['peak_election_bytes'] / 2**30:.3f} after the "
        f"election, {r['peak_bytes'] / 2**30:.3f} after the steady ticks "
        f"({r['base_bytes'] / 2**30:.3f} held before; the run's own "
        f"predicted {predicted / 2**30:.2f}); one leader, checksums "
        f"agree; band copy of one more tick ({bc['calls']} calls, chunks "
        f"{bc['chunks']} of {bc['ring']} rings): kernel "
        f"{bc['ms']:.4f} ms, plain {bc['plain_ms']:.4f}, torch.where x2 "
        f"{bc['library_ms']:.4f}, bound {bc['bound_ms']:.4f}")
    r.update(probes=runs, predicted_bytes=predicted, band_copy=bc,
             leaders=leaders)
    # phase 24's reference: a fresh run of the rung, a digest of every field
    # after each election tick and each of ROW_STEADY steady ticks (so the
    # one-card state and the sharded one are never alive at once)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    st = parallel.shard_rows(sim.init_state(cfg, device=dev),
                             parallel.row_mesh(n, parallel.local_devices(
                                 dev)))
    st, ref = _digest_run(torch, sim, cfg, st, ROW_STEADY, dev)
    del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r["digests"] = ref
    log(f"  digests of all {ref['digests'].shape[1]} fields after each of "
        f"{ref['election_ticks']} election and {ROW_STEADY} steady ticks "
        f"of a fresh run (phase 24's reference) in "
        f"{time.perf_counter() - t0:.1f} s")
    return r


def _peak_fit(runs: list, n: int, L: int) -> tuple:
    """(a, b, predicted bytes at n) of peak = a N^2 + b N L through the
    two probes' own peaks (their peak less what was held before)."""
    (n1, p1), (n2, p2) = ((r["n"], r["peak_bytes"] - r["base_bytes"])
                          for r in runs)
    det = n1 * n1 * n2 * L - n2 * n2 * n1 * L
    a = (p1 * n2 * L - p2 * n1 * L) / det
    b = (n1 * n1 * p2 - n2 * n2 * p1) / det
    return a, b, a * n * n + b * n * L


def _weights(torch, k: int, start: int, salt: int, dev):
    """k int32 hash weights of the indexes start .. start + k - 1."""
    h = (torch.arange(start, start + k, dtype=torch.int64, device=dev)
         + salt) * 0x5851F42D4C957F2D
    return ((h ^ (h >> 29)) >> 17).to(torch.int32)


def _leaf_digest(torch, x, r0: int):
    """int32 digest of a tensor whose row i is the cluster's row r0 + i:
    the sum over rows of a row weight times the row's weighted element
    sum (int32 arithmetic wraps, so the shards' digests add up to the
    whole tensor's)."""
    rows = x.shape[0] if x.dim() else 1
    flat = x.reshape(rows, -1)
    if flat.dtype != torch.int32:
        flat = flat.to(torch.int32)
    wc = _weights(torch, flat.shape[1], 0, 0x9E37, x.device)
    w = torch.int32
    row_sums = (flat * wc).sum(1, dtype=w)
    wr = _weights(torch, rows, r0, 0x85EB, x.device)
    return (row_sums * wr).sum(dtype=w)


def state_digests(torch, sim, st, n: int):
    """An int32 digest of every present SimState field (FIELD_NAMES
    order), one [F] tensor on the first entry; a row-sharded state's
    digests equal its gathered state's (the cluster's own leaves are
    gathered, a row field's shards add up)."""
    from swarmkit_tpu_torch import parallel

    sharded = isinstance(st, parallel.Sharded)
    shards = st.shards if sharded else [st]
    d, dev = len(shards), shards[0].term.device
    nr = n // d
    names = [f for f in sim.state.FIELD_NAMES
             if getattr(shards[0], f) is not None]
    cluster = {f for f in names if parallel._cluster_leaf(
        f, getattr(shards[0], f), n,
        bool(sharded and getattr(st.specs, f)), d)}
    whole = parallel.gather(parallel.only(st, cluster)) if sharded else st
    out = []
    for f in names:
        if f in cluster:
            out.append(_leaf_digest(torch, getattr(whole, f), 0).to(dev))
        else:
            out.append(sum(_leaf_digest(torch, getattr(sh, f), i * nr)
                           .to(dev) for i, sh in enumerate(shards)))
    return torch.stack(out)


def _digest_run(torch, sim, cfg, st, steady: int, dev, cuda_ops=None,
                devices=None) -> tuple:
    """The election one tick a call (run_until_leader(max_ticks=1)), then
    `steady` proposing ticks one run_ticks call each, with a digest of
    every field after each tick: (state, {"election_ticks",
    "election_s": the calls' own seconds, each ended by a synchronize,
    "digests": [ticks, F] int32 on the host, and for the steady calls
    "host_ms" / "event_ms" a tick (host clock and CUDA events around each
    call, ended by a synchronize; the digests outside), "committed", and
    the step counts, cross-entry copies and band-copy launches (with
    `cuda_ops`) over them}.  Every card of `devices` is synchronized."""
    from swarmkit_tpu_torch import parallel

    digs, ticks, t_elect = [], 0, 0.0
    sim.kernel.reset_counts()
    while ticks < 2000 and not bool(sim.has_leader(st)):
        _sync_cards(torch, devices)
        t0 = time.perf_counter()
        st, t = sim.run_until_leader(st, cfg, max_ticks=1, device=dev)
        _sync_cards(torch, devices)
        t_elect += time.perf_counter() - t0
        ticks += t
        digs.append(state_digests(torch, sim, st, cfg.n))
    check(bool(sim.has_leader(st)), f"n={cfg.n}: no leader in 2000 ticks")
    e_counts = dict(sim.kernel.COUNTS)
    peak_elect = _peak(torch, devices)
    sim.kernel.reset_counts()
    parallel.reset_exchange()
    if cuda_ops is not None:
        cuda_ops.reset_launches()
    host, event, base = 0.0, 0.0, int(sim.committed_entries(st))
    for _ in range(steady):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _sync_cards(torch, devices)
        t0 = time.perf_counter()
        start.record()
        st, _ = sim.run_ticks(st, cfg, 1, prop_count=cfg.max_props,
                              device=dev)
        end.record()
        _sync_cards(torch, devices)
        host += time.perf_counter() - t0
        event += start.elapsed_time(end)
        digs.append(state_digests(torch, sim, st, cfg.n))
    out = {"election_ticks": ticks, "election_s": t_elect,
           "election_counts": e_counts, "peak_election_bytes": peak_elect,
           "digests": torch.stack(digs).cpu()}
    if steady:
        out.update(host_ms=host * 1e3 / steady, event_ms=event / steady,
                   committed=int(sim.committed_entries(st)) - base,
                   steady_counts=dict(sim.kernel.COUNTS),
                   exchange=dict(parallel.EXCHANGE))
        if cuda_ops is not None:
            out["band_copy_launches"] = cuda_ops.LAUNCHES["append_band_copy"]
    return st, out


ROW_STEADY = 16      # the rung's steady ticks held tick by tick to phase 23's
ROW_PROFILED = 2     # ticks under the profiler: kernel launches a tick


def _first_diff(want, got) -> str:
    bad = (want != got).nonzero()
    return "none" if not len(bad) else f"tick {int(bad[0][0])} field " \
        f"#{int(bad[0][1])}"


def _row_case_faults(torch, sim, parallel, devices, dev, one: dict) -> dict:
    """Phase 3's first case (the headline dense at n=256: an election,
    then PHASE3_STEADY ticks with 5% drops and a leader crash every 40
    ticks) over the row mesh, against phase 3's card run `one`: the
    election ticks, the trace rows and every field equal."""
    cfg = sim.SimConfig(**{**HEADLINE, **DENSE, "n": 256})
    kw = dict(prop_count=cfg.max_props, drop_rate=0.05, crash_every=40,
              down_for=8)
    st = parallel.shard_rows(sim.init_state(cfg, device=dev),
                             parallel.row_mesh(cfg.n, devices))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, ticks = sim.run_until_leader(st, cfg, max_ticks=500, device=dev)
    st, trace = sim.run_ticks(st, cfg, PHASE3_STEADY, device=dev, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, want = sim.state_to_numpy(parallel.gather(st)), one["final"]
    check(ticks == one["ticks"], f"row mesh: election ticks {ticks}, one "
          f"card {one['ticks']}")
    check(torch.equal(trace.cpu(), one["trace"]),
          "row mesh: run_ticks trace rows differ")
    check(sorted(got) == sorted(want), "row mesh: field sets differ")
    for name in want:
        check((got[name] == want[name]).all(),
              f"row mesh: field {name} differs from the one-card run")
    log(f"  case (1), n=256 dense, 5% drops, a leader crash every 40 ticks: "
        f"election {ticks} ticks + {PHASE3_STEADY} ticks over "
        f"{len(devices)} entries in {secs:.2f} s; all {len(want)} fields "
        f"and {len(trace)} trace rows equal to phase 3's card run")
    return {"fields": len(want), "sharded_s": secs, "election_ticks": ticks}


def _row_case_mailbox(torch, sim, parallel, devices, dev, one: dict) -> dict:
    """Phase 3's third case (the mailbox wire, PreVote, dynamic members,
    peer_chunk=64, active_rows=16 at n=256: 155 ticks, a follower removed
    at tick 80 and re-added at 110, a storm at 123-152) over the row mesh,
    against phase 3's card run `one`: a digest of every field after every
    call and tick, every field at the end, the same step counts, and both
    progress branches taken."""
    cfg, T, drop = _mailbox_case(sim, torch)
    n, target = cfg.n, one["target"]
    st = parallel.shard_rows(sim.init_state(cfg, device=dev),
                             parallel.row_mesh(n, devices))
    counts = {c: 0 for c in sim.kernel.COUNTS}
    digs, spent = [], 0.0
    for t in range(T):
        if t in (80, 110):
            st = sim.propose_conf(st, cfg, target, t == 80, device=dev)
            digs.append(state_digests(torch, sim, st, n))
        sim.kernel.reset_counts()
        t0 = time.perf_counter()
        st = sim.step(st, cfg, drop=drop[t].to(dev),
                      prop_count=cfg.max_props,
                      payload_fn=sim.run._payload_at, device=dev)
        spent += time.perf_counter() - t0
        for c, v in sim.kernel.COUNTS.items():
            counts[c] += v
        digs.append(state_digests(torch, sim, st, n))
    got = torch.stack(digs).cpu()
    check(torch.equal(got, one["digests"]), f"row mesh: field digests "
          f"differ ({_first_diff(one['digests'], got)})")
    final = sim.state_to_numpy(parallel.gather(st))
    check(sorted(final) == sorted(one["final"]),
          "row mesh: field sets differ")
    for name in final:
        check((final[name] == one["final"][name]).all(),
              f"row mesh: field {name} differs at the end")
    check(counts == one["counts"], f"branch counts differ: {counts} vs "
          f"{one['counts']}")
    check(counts["slab_ticks"] > 0 and counts["dense_fallback_ticks"] > 0,
          f"the row mesh did not take both progress branches: {counts}")
    log(f"  case (3), n=256 mailbox + PreVote + membership: {T} ticks over "
        f"{len(devices)} entries in {spent:.2f} s; the digests of all "
        f"{len(final)} fields after every call and tick and every field at "
        f"the end equal to phase 3's card run; slab ticks "
        f"{counts['slab_ticks']}, dense-fallback ticks "
        f"{counts['dense_fallback_ticks']}, step host syncs "
        f"{counts['host_syncs']}")
    return {"fields": len(final), "sharded_s": spent, "counts": counts}


def phase_row_tick(torch, sim, cuda_ops, rung23: dict, cases3: dict,
                   card: str = "cuda", n: int = RUNG,
                   probes=RUNG_PROBES) -> dict:
    """Phase 24: the multi-device row tick.  One cluster's rows over a row
    mesh (cuda:0 named SHARD_ENTRIES times, or every card): phase 3's
    cases (1) and (3) against its card runs (`cases3`); peak memory at the
    probe widths (election and 64 steady ticks) fitted as a N^2 + b N L;
    bench.py's 32768-sharded rung (at the largest probe width if the fit
    says the cap would not hold, said so) election and ROW_STEADY steady
    ticks held tick by tick to phase 23's field digests (the steady ones
    timed apart from the digests); the band copy held to plain on one
    shard's chunks."""
    from swarmkit_tpu_torch import parallel
    from swarmkit_tpu_torch.tools import bench

    if card == "cuda":
        devices = shard_devices(torch)
        dev = torch.device("cuda", torch.cuda.current_device())
        line = card_line()
    else:
        dev = torch.device(card)
        devices = [dev] * SHARD_ENTRIES
        line = card
    d = len(devices)
    out = {"entries": [str(x) for x in devices], "card": line}
    out["case1"] = _row_case_faults(torch, sim, parallel, devices, dev,
                                    cases3["case1"])
    out["case3"] = _row_case_mailbox(torch, sim, parallel, devices, dev,
                                     cases3["case3"])

    name, rung_n, kw = bench.SHARDED_RUNG

    def cfg_at(width):
        return bench.bench_cfg(width, 7, bench.election_tick_for(width),
                               peer_chunk=kw["peer_chunk"])
    runs = []
    for width in probes:
        # the peak comes in the election (phase 23): no steady ticks
        r = _rung_run(torch, sim, cuda_ops, parallel, cfg_at(width), dev, 0,
                      f"n={width} over {d} entries", devices=devices)
        del r["state"]
        runs.append(r)
        log(f"  probe n={width} over {d} entries: election "
            f"{r['election_ticks']} ticks in {r['election_s']:.2f} s, peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB ({r['base_bytes'] / 2**30:.3f}"
            f" held before) [{line}]")
    a, b, predicted = _peak_fit(runs, n, cfg_at(n).log_len)
    held = _held(torch, devices)
    width, why = n, None
    if predicted + held >= RUNG_MEMORY_CAP_GIB * 2**30:
        width = max(w for w, r in zip(probes, runs)
                    if r["peak_bytes"] < RUNG_MEMORY_CAP_GIB * 2**30)
        why = (f"the fit predicts {predicted / 2**30:.2f} GiB at n={n} over "
               f"{d} entries, above the {RUNG_MEMORY_CAP_GIB} GiB cap: the "
               f"rung runs at n={width}, the largest probe width")
        log(f"  {why}")
    log(f"  peak fit a N^2 + b N L over {d} entries: a = {a:.3f} B, b = "
        f"{b:.3f} B; predicted at n={n}: {predicted / 2**30:.2f} GiB "
        f"[{line}]")
    cfg = cfg_at(width)
    if width == n:
        ref = rung23["digests"]
    else:
        st = sim.init_state(cfg, device=dev)
        st, ref = _digest_run(torch, sim, cfg, st, ROW_STEADY, dev)
        del st
    _sync_cards(torch, devices)
    torch.cuda.empty_cache()
    _reset_peaks(torch, devices)
    base = _held(torch, devices)
    st = parallel.shard_rows(sim.init_state(cfg, device=dev),
                             parallel.row_mesh(width, devices))
    peak_init = _peak(torch, devices)
    t0 = time.perf_counter()
    st, got = _digest_run(torch, sim, cfg, st, ROW_STEADY, dev, cuda_ops,
                          devices)
    t_digest_run = time.perf_counter() - t0
    check(got["election_ticks"] == ref["election_ticks"],
          f"row-sharded rung: election {got['election_ticks']} ticks, one "
          f"card {ref['election_ticks']}")
    check(torch.equal(got["digests"], ref["digests"]),
          f"row-sharded rung: field digests differ from the one-card run "
          f"({_first_diff(ref['digests'], got['digests'])})")
    ticks_held, fields = got["digests"].shape
    host_ms, event_ms = got["host_ms"], got["event_ms"]
    committed, counts = got["committed"], got["steady_counts"]
    exch, bc_launches = got["exchange"], got["band_copy_launches"]
    peak = _peak(torch, devices)
    box = [st]
    del st
    # kernel launches and kernel time a tick, the card alone profiled

    def profiled():
        box[0], _ = sim.run_ticks(box[0], cfg, ROW_PROFILED,
                                  prop_count=cfg.max_props, device=dev)
    launches, kernel_ms = (x / ROW_PROFILED
                           for x in _profiled_kernels(torch, profiled))
    leaders = int(sim.leader_mask(box[0]).sum())
    check(leaders == 1, f"row-sharded rung: {leaders} leaders")
    check(committed > 0, "row-sharded rung: nothing committed")
    check(_checksums_agree(sim, box[0]),
          "row-sharded rung: checksum divergence")
    check(bc_launches > 0, "row-sharded rung: no band-copy launch")
    check(exch["copies"] > 0, "row-sharded rung: no cross-entry copy")
    # the band copy on one shard's chunks: the first shard's calls of one
    # more tick (each shard writes its chunks before the next one runs)
    with _BandCopies(cuda_ops, keep=cfg.band_chunks) as rec:
        box[0], _ = sim.run_ticks(box[0], cfg, 1, prop_count=cfg.max_props,
                                  device=dev)
    _sync_cards(torch, devices)
    check(len(rec.calls) == cfg.band_chunks,
          f"{len(rec.calls)} band-copy calls recorded")
    box.clear()
    bc = _time_band_copies(torch, cuda_ops, rec.calls)
    bc["chunks"] = [list(c[5].shape) for c in rec.calls]
    bc["ring"] = list(rec.calls[0][0].shape)
    del rec
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(bc["err"] == 0, f"kernel != plain on a shard's chunks "
          f"({bc['err']})")
    t = ROW_STEADY
    rate = committed / (host_ms * t / 1e3)
    ec = got["election_counts"]
    log(f"  {name} over {d} entries (n={width}, {width // d} rows an "
        f"entry), held to phase 23's one-card run: election "
        f"{ref['election_ticks']} ticks and {ROW_STEADY} steady ticks, "
        f"all {fields} field digests equal after each of the "
        f"{ticks_held} ticks ({t_digest_run:.1f} s with the digests)")
    for figure in (
            f"election {got['election_ticks']} ticks in "
            f"{got['election_s']:.2f} s (slab {ec['slab_ticks']}, dense "
            f"fallback {ec['dense_fallback_ticks']})",
            f"{t} steady ticks (one run_ticks call each, timed apart from "
            f"the digests): {rate:,.1f} entries/s; ms/tick host "
            f"{host_ms:.3f}, CUDA events {event_ms:.3f}, kernels "
            f"{kernel_ms:.3f} (profiled)",
            f"cross-entry copies {exch['copies'] / t:.1f}/tick, "
            f"{exch['bytes'] / t / 2**20:.3f} MiB/tick, collectives "
            f"{exch['collectives'] / t:.1f}/tick",
            f"kernel launches {launches:.1f}/tick (profiled, "
            f"{ROW_PROFILED} ticks); append_band_copy {bc_launches / t:.2f}"
            f"/tick; step host syncs {counts['host_syncs'] / t:.2f}/tick; "
            f"slab {counts['slab_ticks']} / fallback "
            f"{counts['dense_fallback_ticks']}",
            f"peak device memory {peak_init / 2**30:.3f} GiB after "
            f"init_state, {got['peak_election_bytes'] / 2**30:.3f} after "
            f"the election, {peak / 2**30:.3f} after the steady ticks "
            f"({base / 2**30:.3f} held before; fit {predicted / 2**30:.2f})",
            f"band copy on shard 0's chunks {bc['chunks']} of {bc['ring']} "
            f"rings: kernel {bc['ms']:.4f} ms, plain {bc['plain_ms']:.4f}, "
            f"torch.where x2 {bc['library_ms']:.4f}, bound "
            f"{bc['bound_ms']:.4f}"):
        log(f"  [{line}] {figure}")
    out.update(n=width, cut=why, probes=runs, predicted_bytes=predicted,
               election_ticks=got["election_ticks"],
               election_s=got["election_s"], election_counts=ec,
               ticks_held=ticks_held, fields=fields, host_ms=host_ms,
               device_ms=event_ms, committed=committed, entries_per_s=rate,
               copies_per_tick=exch["copies"] / t,
               bytes_per_tick=exch["bytes"] / t,
               collectives_per_tick=exch["collectives"] / t,
               launches_per_tick=launches, kernel_ms=kernel_ms,
               band_copy_launches=bc_launches,
               host_syncs_per_tick=counts["host_syncs"] / t,
               steady_counts=counts, peak_init_bytes=peak_init,
               peak_election_bytes=got["peak_election_bytes"],
               peak_bytes=peak, base_bytes=base, band_copy=bc)
    return out


def phase_sharded(torch, sim, cuda_ops, mc16: dict, card: str = "cuda",
                  **rung) -> dict:
    """Phase 23: the three batch paths sharded over a mesh of the card
    (SHARD_ENTRIES entries naming cuda:0, or every card) against their
    unsharded card runs, the wire's all-to-all, and bench.py's n=32768
    rung whole on one card (`rung`: phase_rung's n and probes)."""
    if card == "cuda":
        devices = shard_devices(torch)
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(card)
        devices = [dev] * SHARD_ENTRIES
    out = {"entries": [str(d) for d in devices]}
    out["dst"] = _sharded_dst(torch, sim, cuda_ops, devices, dev)
    out["fleet"] = _sharded_fleet(torch, sim, cuda_ops, devices, dev)
    out["mc"] = _sharded_scan(torch, cuda_ops, devices, dev, mc16["n3h8"])
    out["wire"] = _sharded_wire(torch, devices, dev)
    out["rung"] = phase_rung(torch, sim, cuda_ops, card=str(dev), **rung)
    return out


# ---- phase 25: the control plane on the card ---------------------------

CP_REPLICAS = 30_000       # Docker's published scale, not cut
CP_STARTUP = (100, 10)     # swarm-bench's defaults: replicas, agents
CP_PROGRAM_REPLICAS = 2


def _sched_place_timed(torch, cuda_ops, calls: list):
    """cuda_ops.place_greedy wrapped to record each call's columns, its
    output and device ms between CUDA events (read after the run); the
    launch and its count are the wrapper's own."""
    inner = cuda_ops.place_greedy

    def timed(cols, n_branches, has_service, n_tasks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(cols, n_branches, has_service, n_tasks)
        end.record()
        calls.append((cols, n_branches, has_service, n_tasks, out, start,
                      end))
        return out
    return inner, timed


def phase_control_plane(torch, cuda_ops, task7: dict, card: str = "cuda"
                        ) -> dict:
    """(a) Docker's 30,000 replicas through the store: the world of
    sched_world.describe_world as store records, group A's service through
    ControlApi.create_service, the orchestrator, the allocator and the
    scheduler's store loop (its kernel on the card) until the store is
    quiet; the placement checked and held to one direct schedule().
    (b) swarm-bench's task-startup flow with 10 TestExecutor agents, then
    one agent on the port's TpuExecutor running 2 tpu://pallas_matmul
    replicas to COMPLETE.  (c) The orchestration script of
    tests/test_torch_orchestration.py with the store loop on the card and
    on the CPU, equal after every step."""
    from swarmkit_tpu_torch.agent.tpu import TpuExecutor
    from swarmkit_tpu_torch.manager.scheduler import kernel as skernel
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.tools import control_plane as cp
    from swarmkit_tpu_torch.tools import sched_world as W

    card_name = card_line()
    pkg = cp.package()
    out = {}

    # (a) ------------------------------------------------------------------
    desc = W.describe_world(seed=0)
    calls: list = []
    inner, timed = _sched_place_timed(torch, cuda_ops, calls)
    sw = cp.Stopwatch()
    sw.wrap(skernel, "encode_group")
    sw.wrap(skernel, "group_columns")
    cuda_ops.place_greedy = timed
    cuda_ops.reset_launches()
    try:
        run = asyncio.run(cp.place_through_store(
            pkg, desc, CP_REPLICAS, {"device": card}, stopwatch=sw,
            timeout=600))
    finally:
        cuda_ops.place_greedy = inner
        sw.restore()
    sw_enc = dict(sw.seconds)
    launches = cuda_ops.LAUNCHES["sched_place"]
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for *_, s, e in calls]
    groups = catalog.get(run["obs"], "swarm_sched_kernel_groups_total") \
        .snapshot()
    store, svc = run["store"], run["service"]
    ticked = sum(1 for n in run["ticks"] if n)   # ticks with work to place
    check(launches == len(calls) == ticked and launches > 0,
          f"control plane: sched_place launched {launches} times for "
          f"{ticked} ticks of one group")
    check(groups == {"path=kernel": float(launches)},
          f"control plane: a group left the kernel path ({groups})")
    viol = cp.placement_violations(pkg, store, svc.id)
    check(not viol, f"control plane: placement violations {viol[:5]}")
    placed, pending = len(run["order"]), len(run["pending"])
    check(placed + pending == CP_REPLICAS and placed > 0,
          f"control plane: {placed} placed + {pending} pending")
    final = {t.id: t.node_id
             for t in store.find("task", pkg.by.ByService(svc.id))
             if t.status.state == pkg.api.TaskState.ASSIGNED}
    check(final == dict(run["order"]), "control plane: the store's "
          "assignment differs from the decisions the ticks applied")
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    direct = cp.direct_schedule(pkg, run, {"device": card})
    direct_s = time.perf_counter() - t0
    check(cuda_ops.LAUNCHES["sched_place"] == 1,
          "control plane: the direct schedule() did not launch once")
    check(direct == run["order"], "control plane: the store loop's "
          "placement differs from one direct schedule() over the "
          "starting node set")
    # the first tick's columns: the kernel against the plain loop
    cols, nb, hs, k = calls[0][:4]
    want = cuda_ops.place_greedy_plain(cols.cpu(), nb, hs, k)
    got = inner(cols, nb, hs, k).cpu()
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"control plane: sched_place differs from the plain "
          f"loop on the first tick's columns ({err})")
    secs = run["seconds"]
    kernel_s = sum(kernel_ms) / 1e3
    out["a"] = dict(
        card=card_name, replicas=CP_REPLICAS, nodes=len(desc["zone"]),
        placed=placed, pending=pending, failed_taints=run["n_failed"],
        setup_s=run["setup_s"], quiet_s=run["quiet_s"],
        tasks_placed_per_s=placed / run["quiet_s"],
        orchestrator_s=secs["_reconcile"], allocator_s=secs["_alloc_tasks"],
        ticks=len(run["ticks"]), tick_tasks=run["ticks"],
        tick_s=secs["tick"], place_s=secs["_place"],
        encode_s=sw_enc["encode_group"] + sw_enc["group_columns"],
        kernel_ms_per_tick=kernel_ms, apply_s=secs["_apply"],
        explain_s=secs["_explain_unplaced"],
        group_decode_s=secs["_place"] - sw_enc["encode_group"]
        - sw_enc["group_columns"] - kernel_s,
        launches=launches, direct_s=direct_s, err=err)
    a = out["a"]
    log(json.dumps({"phase": "25a", **{k: v for k, v in a.items()}},
                   default=str))
    log(f"  {CP_REPLICAS} replicas over {a['nodes']} nodes: placed "
        f"{placed}, pending {pending}, quiet {a['quiet_s']:.2f} s after "
        f"create_service ({a['tasks_placed_per_s']:.0f} tasks placed a "
        f"second); orchestrator {a['orchestrator_s']:.2f} s, allocator "
        f"{a['allocator_s']:.2f} s, {a['ticks']} ticks {a['tick_s']:.2f} s "
        f"(place {a['place_s']:.2f} s: encode {a['encode_s']:.3f} s, kernel "
        f"{kernel_ms} ms, grouping + decode {a['group_decode_s']:.3f} s; "
        f"apply "
        f"{a['apply_s']:.2f} s; explain {a['explain_s']:.2f} s); "
        f"sched_place launches {launches}; = direct schedule() "
        f"({direct_s:.2f} s); the first tick's kernel = plain loop")
    del run, store, final, direct, calls

    # (b) ------------------------------------------------------------------
    replicas, workers = CP_STARTUP
    ex = TpuExecutor(hostname="card-0", device=card)
    args = [f"n={TASK_N}", f"steps={TASK_STEPS}", "seed=0"]

    async def program(p):
        res = await cp.run_program(p, ex, "tpu://pallas_matmul", args,
                                   replicas=CP_PROGRAM_REPLICAS,
                                   timeout=300)
        return res, catalog.get(
            p.obs, "swarm_sched_kernel_groups_total").snapshot()

    cuda_ops.reset_launches()
    b = asyncio.run(cp.task_startup(pkg, replicas, workers,
                                    sched_kw={"device": card}, extra=ex,
                                    then=program))
    launches = {k: cuda_ops.LAUNCHES[k]
                for k in ("matmul_wgmma", "sumsq", "sched_place")}
    prog, groups = b.pop("then")
    flop = TASK_STEPS * 2 * TASK_N ** 3
    check(b["fsm_ordered"], "control plane: a bench task's states reached "
          "the store out of FSM order")
    check(groups.get("path=kernel", 0) == launches["sched_place"] > 0
          and "path=host" not in groups, f"control plane: sched_place "
          f"launches {launches['sched_place']} for the groups {groups}")
    check(launches["matmul_wgmma"] == CP_PROGRAM_REPLICAS * TASK_STEPS
          and launches["sumsq"] == CP_PROGRAM_REPLICAS * TASK_STEPS,
          f"control plane: the program tasks launched {launches}")
    order = [s.name for s in sorted(pkg.api.TaskState)]
    tasks = []
    for slot, t in sorted(prog.items()):
        idx = [order.index(x) for x in t["states"]]
        check(t["state"] == "COMPLETE", f"control plane: program task "
              f"{slot} ended {t['state']}: {t['err']}")
        check(idx == sorted(idx), f"control plane: program task {slot}'s "
              f"states {t['states']} are out of FSM order")
        check(t["result"] == task7["result"], f"control plane: program "
              f"task {slot}'s result {t['result']!r} != phase 7's "
              f"{task7['result']!r}")
        tasks.append(dict(slot=slot, node=t["node"], run_s=t["run_s"],
                          tflop_per_s=flop / t["run_s"] / 1e12,
                          result=t["result"], states=t["states"]))
    out["b"] = dict(card=card_name, **b, program=tasks,
                    phase7_run_s=task7["run_s"],
                    phase7_tflop_per_s=task7["tflop_per_s"],
                    launches=launches, groups=groups)
    log(json.dumps({"phase": "25b", **out["b"]}, default=str))
    log(f"  swarm-bench flow ({replicas} replicas, {workers} agents): all "
        f"RUNNING in {b['time_to_all_running_s']:.3f} s "
        f"({b['tasks_per_s']:.1f} tasks/s; p50 {b['p50_s']:.3f}, p90 "
        f"{b['p90_s']:.3f}, p99 {b['p99_s']:.3f} s); "
        + "; ".join(f"pallas_matmul slot {t['slot']}: run {t['run_s']:.3f} s "
                    f"({t['tflop_per_s']:.1f} TFLOP/s), result = phase 7's"
                    for t in tasks)
        + f" (phase 7: {task7['run_s']:.3f} s, "
        f"{task7['tflop_per_s']:.1f} TFLOP/s); launches {launches}")

    # (c) ------------------------------------------------------------------
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    on_card = asyncio.run(cp.run_script(pkg, {"device": card}))
    card_s = time.perf_counter() - t0
    launches = cuda_ops.LAUNCHES["sched_place"]
    on_cpu = asyncio.run(cp.run_script(pkg, {"device": "cpu"}))
    diffs = cp.same_steps(on_cpu, on_card)
    check(not diffs, f"control plane: the script on the card differs from "
          f"the CPU: {diffs[:3]}")
    check(launches > 0, "control plane: the script never launched "
          "sched_place")
    out["c"] = dict(card=card_name, steps=[s for s, _ in on_card],
                    launches=launches, card_s=card_s)
    log(json.dumps({"phase": "25c", **out["c"]}))
    log(f"  the orchestration script: card = CPU after each of its "
        f"{len(on_card)} steps ({launches} sched_place launches, "
        f"{card_s:.2f} s on the card)")
    return out


# ---- phase 26: the raft node shell and the Manager on the card ---------

Q_MANAGERS, Q_APPENDS = 5, 1000      # BASELINE.json config 2
CPL_MANAGERS = 3                     # bench.py's cpl-batch64 pair
CPL_SEQ, CPL_BATCHED, CPL_BATCH = 300, 600, 64
Q_STARTUP_MANAGERS = 3               # swarm-bench's flow on a quorum
Q_TIMEOUT = 120.0                    # seconds any one wait may take


def replica_view(store) -> dict:
    """Every object of `store` by kind and id, as its serde dict, without
    the meta timestamps, which each replica stamps with its own clock
    when it applies an entry."""
    out = {}
    for kind in ("node", "service", "task", "network", "cluster", "secret",
                 "config", "resource", "extension"):
        objs = {}
        for o in store.find(kind):
            d = o.to_dict()
            d["meta"] = {**d["meta"], "created_at": None, "updated_at": None}
            objs[o.id] = d
        if objs:
            out[kind] = objs
    return out


async def _until(pred, what: str, timeout: float = Q_TIMEOUT,
                 every: float = 0.005) -> float:
    """Wait (polling every `every` seconds) until pred(); the seconds it
    took.  Raises TimeoutError naming `what` after `timeout` seconds."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: not within {timeout} s")
        await asyncio.sleep(every)
    return time.perf_counter() - t0


async def _all_applied(q, what: str) -> None:
    """Every running manager of `q` applied the leader's commit index."""
    lead = q.leader()
    idx = lead.raft._raw.raft.log.committed
    await _until(lambda: all(m.raft._applied >= idx for m in q.mgrs
                             if m._running), what)


def _leader_parts(lead) -> dict:
    """The leader's control loops by class name."""
    return {type(c).__name__: c for c in lead._leader_components}


def _proposal_stopwatch(q):
    """A Stopwatch over each manager's raft loop: its whole Ready pass,
    and inside it the WAL save (frames and fsync), the sends and the
    apply of committed entries, labelled leader or follower; on the
    device wire also the exchange.  The managers share one thread, so the
    seconds add up across them."""
    from swarmkit_tpu_torch.tools import control_plane as cp

    sw = cp.Stopwatch()
    lead = q.leader()
    for m in q.mgrs:
        role = "leader" if m is lead else "follower"
        sw.wrap(m.raft, "_process_ready", f"{role}_ready")
        sw.wrap(m.raft.storage, "save", f"{role}_wal_save")
        sw.wrap(m.raft.transport, "send", f"{role}_send")
        sw.wrap(m.raft, "_process_committed", f"{role}_apply")
    if hasattr(q.net, "run_exchange"):
        sw.wrap(q.net, "run_exchange", "exchange")
    return sw


async def _appends_case(sb, transport: str, card) -> dict:
    """(a) Q_MANAGERS managers on `transport`, Q_APPENDS sequential
    appends; every one committed and applied on every store; the split
    of a proposal's wall time over the raft loops' parts."""
    q = sb.Quorum(Q_MANAGERS, transport, device=card)
    await q.start()
    try:
        await _all_applied(q, f"{transport}: the quorum's joins")
        check(len(q.mgrs[0].raft.cluster.members) == Q_MANAGERS,
              f"{transport}: {len(q.mgrs[0].raft.cluster.members)} members")
        sw = _proposal_stopwatch(q)
        t0 = time.perf_counter()
        try:
            r = await q.appends(Q_APPENDS)
        finally:
            sw.restore()
        wall = time.perf_counter() - t0
        # ms a proposal in each part; "loop_rest" is the wall time outside
        # every Ready pass: the ticks' waits, the store's transaction and
        # encode, the event loop
        split = {k: v / Q_APPENDS * 1e3 for k, v in sw.seconds.items()}
        split["wall"] = wall / Q_APPENDS * 1e3
        split["loop_rest"] = split["wall"] - split["leader_ready"] \
            - split["follower_ready"]
        r["split_ms"] = split
        r["calls"] = dict(sw.calls)
        await _all_applied(q, f"{transport}: the appends")
        want = {f"bench-cfg-{i}" for i in range(Q_APPENDS)}
        for m in q.mgrs:
            got = {c.id for c in m.store.find("config")}
            check(got == want, f"{transport}: {m.node_id} holds "
                  f"{len(got & want)} of {Q_APPENDS} appends")
        r["commit_index"] = q.mgrs[0].raft._raw.raft.log.committed
        r["flushes"] = getattr(q.net, "device_flushes", None)
        r["messages"] = getattr(q.net, "device_messages", None)
        return r
    finally:
        await q.stop()


async def _cpl_case(sb, card) -> dict:
    """(b) bench.py's cpl-batch64 pair: CPL_SEQ sequential appends on one
    quorum, CPL_BATCHED at CPL_BATCH in flight on another; every append
    committed on every store."""
    out = {}
    for name, n, batch in (("sequential", CPL_SEQ, 1),
                           ("batched", CPL_BATCHED, CPL_BATCH)):
        q = sb.Quorum(CPL_MANAGERS, device=card)
        await q.start()
        try:
            r = await q.appends(n, batch=batch)
            await _all_applied(q, f"cpl {name}")
            for m in q.mgrs:
                got = len(m.store.find("config"))
                check(got == n, f"cpl {name}: {m.node_id} holds {got} of "
                      f"{n} appends")
            out[name] = r
        finally:
            await q.stop()
    check(out["batched"]["entries_per_proposal"] > 1,
          f"cpl: 64 appends in flight packed "
          f"{out['batched']['entries_per_proposal']} a proposal")
    out["ratio"] = (out["batched"]["proposals_per_s"]
                    / out["sequential"]["proposals_per_s"])
    return out


def _held_to_plain(torch, cuda_ops, calls: list) -> tuple[int, list]:
    """Each recorded sched_place call's output held to the plain loop on
    its own columns: the largest difference over all calls, and each
    call's device ms."""
    torch.cuda.synchronize()
    err = 0
    for cols, nb, hs, k, got, *_ in calls:
        want = cuda_ops.place_greedy_plain(cols.cpu(), nb, hs, k)
        err = max(err, int((got.cpu().long() - want.long()).abs().max()))
    return err, [s.elapsed_time(e) for *_, s, e in calls]


async def _trace_tasks(watcher, rows: list) -> None:
    """Append (seconds, kind, action, state, raft index) for each event of
    `watcher` as this loop wakes for it, until the watcher is closed."""
    async for ev in watcher:
        o = ev.object
        state = o.status.state.name if ev.kind == "task" else ""
        rows.append((time.perf_counter(), ev.kind, ev.action, state,
                     o.meta.version.index))


def _startup_split(rows: list) -> dict:
    """The start-up flow's task events by the state they carry: the
    seconds after the service's create event of the first and the last
    event, and how many raft commits carried them."""
    t0 = next(t for t, kind, action, *_ in rows
              if kind == "service" and action == "create")
    out: dict = {}
    for t, kind, action, state, index in rows:
        if kind != "task":
            continue
        first, last, commits = out.get(state, (t - t0, t - t0, set()))
        commits.add(index)
        out[state] = (first, t - t0, commits)
    return {state: dict(first_s=first, last_s=last, commits=len(commits))
            for state, (first, last, commits) in out.items()}


async def _startup_failover(sb, torch, cuda_ops, task7: dict, card
                            ) -> dict:
    """(c) swarm-bench's start-up flow through a quorum of
    Q_STARTUP_MANAGERS on the device wire, then CP_PROGRAM_REPLICAS
    tpu://pallas_matmul tasks on a TpuExecutor worker, every sched_place
    call of the leader's store loop held to the plain loop; (d) the leader
    killed, a new one elected and written through, the old one restarted
    from its state_dir until its store equals the leader's."""
    from swarmkit_tpu_torch.agent.tpu import TpuExecutor
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.store.memory import match
    from swarmkit_tpu_torch.tools import control_plane as cp

    pkg = cp.package()
    api = pkg.api
    out = {}
    q = sb.Quorum(Q_STARTUP_MANAGERS, "device", device=card)
    await q.start()
    try:
        await _all_applied(q, "startup: the quorum's joins")
        replicas, workers = CP_STARTUP
        calls: list = []
        inner, timed = _sched_place_timed(torch, cuda_ops, calls)
        cuda_ops.place_greedy = timed
        lead = q.leader()
        rows: list = []
        watcher = lead.store.watch(match(kind="task"),
                                   match(kind="service", action="create"))
        tracer = asyncio.ensure_future(_trace_tasks(watcher, rows))
        try:
            cuda_ops.reset_launches()
            r = await q.startup(replicas, workers)
            watcher.close()
            await tracer
            svc = next(s for s in lead.store.find("service")
                       if s.spec.annotations.name == "bench")
            tasks = lead.store.find("task", pkg.by.ByService(svc.id))
            check(len(tasks) == replicas and all(
                t.status.state == api.TaskState.RUNNING for t in tasks),
                f"startup: {len(tasks)} tasks, not all RUNNING")
            ex = TpuExecutor(hostname="card-0", device=card)
            agent = await q.add_agent("card-0", ex)
            await agent.ready()
            parts = _leader_parts(lead)
            p = types.SimpleNamespace(
                pkg=pkg, store=lead.store, control=lead.control_api,
                scheduler=parts["Scheduler"], allocator=parts["Allocator"],
                orchestrator=parts["ReplicatedOrchestrator"])
            prog = await cp.run_program(
                p, ex, "tpu://pallas_matmul",
                [f"n={TASK_N}", f"steps={TASK_STEPS}", "seed=0"],
                replicas=CP_PROGRAM_REPLICAS, timeout=300)
            launches = {k: cuda_ops.LAUNCHES[k]
                        for k in ("sched_place", "matmul_wgmma", "sumsq")}
        finally:
            cuda_ops.place_greedy = inner
            watcher.close()
            tracer.cancel()
        split = _startup_split(rows)
        check(split.get("RUNNING", {}).get("last_s", -1) >= 0,
              f"startup: the trace saw no task reach RUNNING ({split})")
        check(len(calls) == launches["sched_place"], f"startup: "
              f"{len(calls)} recorded sched_place calls for "
              f"{launches['sched_place']} launches")
        err, kernel_ms = _held_to_plain(torch, cuda_ops, calls)
        check(err == 0, f"startup: sched_place differs from the plain loop "
              f"on the store loop's columns ({err})")
        shapes = [[int(cols.shape[-1]), int(k)]
                  for cols, _, _, k, *_ in calls]
        del calls
        groups = catalog.get(lead.obs,
                             "swarm_sched_kernel_groups_total").snapshot()
        check(groups.get("path=kernel", 0) == launches["sched_place"] > 0
              and "path=host" not in groups, f"startup: sched_place "
              f"launches {launches['sched_place']} for the groups {groups}")
        check(launches["matmul_wgmma"] == CP_PROGRAM_REPLICAS * TASK_STEPS
              and launches["sumsq"] == CP_PROGRAM_REPLICAS * TASK_STEPS,
              f"startup: the program tasks launched {launches}")
        order = [s.name for s in sorted(api.TaskState)]
        flop = TASK_STEPS * 2 * TASK_N ** 3
        progs = []
        for slot, t in sorted(prog.items()):
            idx = [order.index(x) for x in t["states"]]
            check(t["state"] == "COMPLETE" and idx == sorted(idx),
                  f"startup: program task {slot}: {t['state']} "
                  f"{t['states']} {t['err']}")
            check(t["result"] == task7["result"], f"startup: program task "
                  f"{slot}'s result {t['result']!r} != phase 7's "
                  f"{task7['result']!r}")
            progs.append(dict(slot=slot, run_s=t["run_s"],
                              tflop_per_s=flop / t["run_s"] / 1e12,
                              result=t["result"]))
        out["c"] = dict(r, program=progs, launches=launches, groups=groups,
                        split=split, place_err=err,
                        place_kernel_ms=kernel_ms,
                        place_shapes=shapes, flushes=q.net.device_flushes)

        # (d) ---------------------------------------------------------------
        old = q.leader()
        i = q.mgrs.index(old)
        survivors = [m for m in q.mgrs if m is not old]
        raw = survivors[0].raft._raw
        ticks = [0]
        tick = raw.tick

        def counted():
            ticks[0] += 1
            tick()
        raw.tick = counted
        await _all_applied(q, "failover: before the kill")
        await old.stop()
        elect_s = await _until(lambda: any(
            m.is_leader() and m._is_leader for m in survivors),
            "failover: a new leader")
        elect_ticks = ticks[0]
        raw.tick = tick
        new = q.leader()
        check(new is not old and new in survivors, "failover: no new leader")
        t0 = time.perf_counter()
        await new.store.update(lambda tx: tx.create(api.Config(
            id="after-failover", spec=api.ConfigSpec(
                annotations=api.Annotations(name="after-failover"),
                data=b"x"))))
        write_s = time.perf_counter() - t0
        back = q.new_manager(i)
        t0 = time.perf_counter()
        await back.start()
        q.mgrs[i] = back
        check(back.raft.raft_id == old.raft.raft_id,
              "failover: the restarted manager has another raft id")
        await _all_applied(q, "failover: the restarted manager's catch-up")
        await _until(lambda: replica_view(back.store)
                     == replica_view(new.store),
                     "failover: the restarted store equal to the leader's")
        rejoin_s = time.perf_counter() - t0
        check(back.store.get("config", "after-failover") is not None,
              "failover: the restarted store lacks the post-failover write")
        out["d"] = dict(killed=old.node_id, leader=new.node_id,
                        elect_s=elect_s, elect_ticks=elect_ticks,
                        write_s=write_s, rejoin_s=rejoin_s,
                        objects=sum(len(v) for v in
                                    replica_view(back.store).values()))
    finally:
        await q.stop()
    return out


async def _global_case(sb, card) -> dict:
    """(e) Docker's 1,000-node world written into the store of a quorum of
    Q_STARTUP_MANAGERS on the device wire, then a global service: one
    task on every READY node, ASSIGNED, on every replica."""
    from swarmkit_tpu_torch.tools import control_plane as cp
    from swarmkit_tpu_torch.tools import sched_world as W

    pkg = cp.package()
    api = pkg.api
    q = sb.Quorum(Q_STARTUP_MANAGERS, "device", device=card)
    await q.start()
    try:
        await _all_applied(q, "global: the quorum's joins")
        lead = q.leader()
        desc = W.describe_world(seed=0)
        t0 = time.perf_counter()
        await cp.world_into_store(pkg, lead.store, desc)
        world_s = time.perf_counter() - t0
        eligible = {f"node-{j:04d}" for j in range(len(desc["zone"]))
                    if not desc["down"][j]}
        spec = api.ServiceSpec(
            annotations=api.Annotations(name="node-agent"),
            task=api.TaskSpec(container=api.ContainerSpec(image="agent")),
            mode=api.Mode.GLOBAL, global_=api.GlobalService())
        t0 = time.perf_counter()
        gsvc = await lead.control_api.create_service(spec)

        def placed():
            return {t.node_id for t in lead.store.find(
                "task", pkg.by.ByService(gsvc.id))
                if t.status.state == api.TaskState.ASSIGNED}
        quiet_s = await _until(lambda: placed() == eligible,
                               "global: one ASSIGNED task a READY node",
                               timeout=300, every=0.1)
        gtasks = lead.store.find("task", pkg.by.ByService(gsvc.id))
        check(len(gtasks) == len(eligible), f"global: {len(gtasks)} tasks "
              f"for {len(eligible)} READY nodes")
        await _all_applied(q, "global: the replicas")
        for m in q.mgrs:
            check(len(m.store.find("task", pkg.by.ByService(gsvc.id)))
                  == len(eligible), f"global: {m.node_id}'s replica")
        return dict(nodes=len(desc["zone"]), eligible=len(eligible),
                    tasks=len(gtasks), world_s=world_s, quiet_s=quiet_s,
                    flushes=q.net.device_flushes)
    finally:
        await q.stop()


class GcPauses:
    """The cyclic collector's collections and pause seconds by generation
    while the `with` block runs (gc.callbacks): a long pause stalls every
    manager on the one event loop."""

    def __init__(self) -> None:
        self.collections = [0, 0, 0]
        self.pause_s = [0.0, 0.0, 0.0]
        self.max_pause_s = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = time.perf_counter() - self._t0
        self.collections[info["generation"]] += 1
        self.pause_s[info["generation"]] += dt
        self.max_pause_s = max(self.max_pause_s, dt)

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)

    def summary(self) -> dict:
        return dict(collections=self.collections, pause_s=self.pause_s,
                    max_pause_s=self.max_pause_s)


def phase_quorum(torch, cuda_ops, task7: dict, card: str = "cuda") -> dict:
    """(a) BASELINE.json config 2: Q_MANAGERS port Managers, Q_APPENDS
    sequential ProposeValue appends, on the in-process wire and on the
    device wire (DeviceMeshNet(rows=8) on the card): proposals/s, p50/p99
    ms, every append committed and applied on every store.  (b) bench.py's
    cpl-batch64 pair (3 managers; 300 sequential appends, 600 at 64 in
    flight): proposals/s each, their ratio, entries a proposal.  (c)
    swarm-bench's start-up flow (100 replicas, 10 TestExecutor agents)
    through a 3-manager quorum on the device wire, then 2
    tpu://pallas_matmul tasks on a TpuExecutor worker, results bit-equal
    to phase 7's; the launches of sched_place, matmul_wgmma and sumsq.
    (d) the leader killed: ticks and seconds to a new leader, a write, the
    old one restarted from its state_dir until its store equals the
    leader's.  (e) Docker's 1,000-node world in the quorum's store and a
    global service: one task a READY node (the JAX package's single
    transaction refuses more than 200), seconds to quiet.  Each case
    reports the collector's pauses in it, and the phase the objects the
    collector tracks when it starts."""
    from swarmkit_tpu_torch.cmd import swarm_bench as sb

    card_name = card_line()
    out = {"gc_objects": len(gc.get_objects())}
    log(f"  the cyclic collector tracks {out['gc_objects']} objects")
    for transport in ("inproc", "device"):
        with GcPauses() as pauses:
            r = asyncio.run(_appends_case(sb, transport, card))
        r["gc"] = pauses.summary()
        out[f"a_{transport}"] = r
        log(json.dumps({"phase": f"26a-{transport}", "card": card_name,
                        **r}))
        log(f"  {Q_MANAGERS} managers on the {transport} wire: "
            f"{Q_APPENDS} appends at {r['proposals_per_s']} proposals/s "
            f"(p50 {r['propose_p50_ms']} ms, p99 {r['propose_p99_ms']} ms), "
            f"committed and applied on all {Q_MANAGERS} stores; ms a "
            f"proposal: " + ", ".join(f"{k} {v:.3f}" for k, v
                                      in r["split_ms"].items()))
    with GcPauses() as pauses:
        b = asyncio.run(_cpl_case(sb, card))
    b["gc"] = pauses.summary()
    out["b"] = b
    log(json.dumps({"phase": "26b", "card": card_name, **b}))
    log(f"  cpl-batch64: sequential {b['sequential']['proposals_per_s']} "
        f"proposals/s, batched {b['batched']['proposals_per_s']} "
        f"({b['batched']['entries_per_proposal']} entries a proposal); "
        f"ratio {b['ratio']:.2f}")
    with GcPauses() as pauses:
        out.update(asyncio.run(_startup_failover(sb, torch, cuda_ops, task7,
                                                 card)))
    out["c"]["gc"] = pauses.summary()
    with GcPauses() as pauses:
        out["e"] = asyncio.run(_global_case(sb, card))
    out["e"]["gc"] = pauses.summary()
    c, d, e = out["c"], out["d"], out["e"]
    for k in "cde":
        log(json.dumps({"phase": f"26{k}", "card": card_name, **out[k]},
                       default=str))
    running = c["split"]["RUNNING"]
    log(f"  swarm-bench through {Q_STARTUP_MANAGERS} managers on the device "
        f"wire: {c['replicas']} RUNNING in {c['time_to_all_running_s']} s "
        f"(p50 {c['p50_s']}, p90 {c['p90_s']}, p99 {c['p99_s']} s, over "
        f"{running['commits']} RUNNING commit(s)); the task events by "
        f"state (first s, last s, commits): "
        + ", ".join(f"{st} {v['first_s']:.3f}/{v['last_s']:.3f}/"
                    f"{v['commits']}" for st, v in c["split"].items())
        + f"; sched_place {len(c['place_shapes'])} calls, each equal "
        f"to the plain loop ({c['place_shapes']} nodes/tasks); "
        + "; ".join(f"pallas_matmul slot {t['slot']} {t['run_s']:.3f} s, "
                    f"result = phase 7's" for t in c["program"])
        + f"; launches {c['launches']}")
    log(f"  failover: {d['killed']} killed, {d['leader']} elected in "
        f"{d['elect_ticks']} ticks ({d['elect_s']:.3f} s), a write in "
        f"{d['write_s']:.3f} s, {d['killed']} back from its state_dir "
        f"and equal to the leader's {d['objects']} objects in "
        f"{d['rejoin_s']:.2f} s")
    log(f"  global service over {e['nodes']} nodes: {e['tasks']} tasks on "
        f"the {e['eligible']} READY nodes, quiet {e['quiet_s']:.2f} s after "
        f"create_service (the world written in {e['world_s']:.2f} s)")
    parts = (("(a) in-process", out["a_inproc"]), ("(a) device",
             out["a_device"]), ("(b)", b), ("(c)-(d)", c), ("(e)", e))
    log("  the cyclic collector's pauses, collections and seconds by "
        "generation, the longest: " + "; ".join(
            f"{name} {r['gc']['collections']} "
            f"{[round(x, 3) for x in r['gc']['pause_s']]} "
            f"{r['gc']['max_pause_s']:.3f} s" for name, r in parts))
    return out


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

    started = time.perf_counter()

    def stage(msg: str) -> None:
        log(f"{msg} [at {time.perf_counter() - started:.1f} s]")

    stage("phase 1: card and build")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"  nvcc built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        kernel = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = kernel_name(entry.group(1))
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower()):
                log(f"  [{name}:{kernel}] {line.strip()}")
    smem = cuda_ops._kernel("matmul", "matmul_wgmma_smem_bytes")()
    log(f"  [matmul:mm_bf16_wgmma] dynamic shared memory {smem} bytes per "
        f"block")

    stage("phase 2: append_band_copy kernel vs plain")
    err2 = phase_kernel_vs_plain(torch, cuda_ops)

    stage("phase 3: the port on the card (n=256); its CPU runs go in a "
          "second process beside phases 4-18, and are compared after them")
    cases3 = phase_card_vs_cpu(torch, sim, cuda_ops)
    cpu3_dir = tempfile.mkdtemp(prefix="chip_smoke_cpu3_")
    cpu3 = start_phase3_cpu(cpu3_dir)

    stage("phase 4: the main path at full width (n=4096, the bench's levers)")
    head = phase_headline(torch, sim, cuda_ops)

    stage("phase 4b: the same shape dense and with the levers, in turns")
    ab = phase_lever_ab(torch, sim, head.pop("state"))

    stage("phase 5: append_band_copy on the main path's inputs")
    k = phase_main_path_inputs(torch, sim, cuda_ops, ab.pop("state"))

    stage("phase 6: matmul and sumsq kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is full f32
    err6 = phase_float_kernels_vs_plain(torch, cuda_ops)

    stage(f"phase 7: the executor path at full width (n={TASK_N}, "
        f"steps={TASK_STEPS})")
    task = phase_executor(torch, cuda_ops)

    stage("phase 8: matmul and sumsq on the executor path's inputs")
    f8 = phase_float_kernels_on_path(torch, cuda_ops, task.pop("a"))

    stage("phase 9: the mailbox path at full width (bench.py's "
        "1024-mailbox-lat2-jitter1-inflight4)")
    cuda_ops.reset_launches()
    mbox = phase_mailbox_path(torch, sim, cuda_ops)
    mbox_launches = mbox["band_copy_launches"]
    err9 = phase_mailbox_inputs(torch, sim, cuda_ops, mbox.pop("state"))
    stage("phase 9b: the same shape with PreVote and dynamic membership, a "
        "follower removed and re-added through propose_conf")
    dyn = phase_dynamic_members(torch, sim)

    stage("phase 10: bench.py's 256-readmix-99to1 at full width")
    rmix = phase_readmix(torch, sim, cuda_ops)
    stage("phase 10b: the read path at the headline's width (n=4096, "
        "read_batch 49)")
    rwide = phase_readmix_headline_width(torch, sim, cuda_ops)
    stage("phase 11: bench.py's 256-fsyncgate, bare and gated (k=4), in turns")
    fgate = phase_fsyncgate(torch, sim, cuda_ops)
    stage("phase 12: the device observability planes at the headline's full "
        "width (n=4096), in turns with planes off")
    planes = phase_planes_headline(torch, sim, cuda_ops)
    stage("phase 13: the DST sweep on the batched tick (n=5, reads 2)")
    from swarmkit_tpu_torch import dst
    outdir = tempfile.mkdtemp(prefix="chip_smoke_dst_")
    try:
        dst13 = phase_dst(torch, sim, cuda_ops, outdir=outdir)
        stage("phase 13b: oracle_trace on the card (the commit_no_quorum "
              "and lost-tail artifacts)")
        oracle = phase_oracle(torch, dst, dst13)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    del dst13["artifacts"]
    stage("phase 14: bench.py's multiraft-1024x3 at full width (G=1024 "
          "groups of 3)")
    mraft = phase_multiraft(torch, sim, cuda_ops)
    stage("phase 14b: bench.py's multiraft-telemetry (G=256), bare and "
          "telemetry on, in turns")
    mtel = phase_multiraft_telemetry(torch, sim)
    stage("phase 14c: the serving plane on the card vs on the CPU (G=8, "
          "both wires)")
    mcpu = phase_multiraft_card_vs_cpu(torch, sim)
    stage(f"phase 15: the levers and planes on the batched tick ("
          f"{LEVER_S} x {DST_TICKS} sweeps, lever on against off)")
    levers = phase_levers_batched(torch, sim, cuda_ops)
    stage("phase 16: mc_sweep's n3h8 scope on the card, the mutation "
          "self-tests, the smoke scope against the CPU")
    outdir = tempfile.mkdtemp(prefix="chip_smoke_mc_")
    try:
        mc16 = phase_mc(torch, sim, cuda_ops, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    stage("phase 17: the scheduler's group placement at Docker's published "
          "scale (1,000 nodes, groups A-C)")
    sched17 = phase_scheduler(torch, cuda_ops)
    stage("phase 18: the multi-raft tools on the card (multiraft_sweep at "
          "G=64, swarm_top's demo)")
    tools18 = phase_tools(torch, cuda_ops)
    stage("phase 3, its CPU half: the second process's runs, then the "
          "card's held to them")
    try:
        compare_card_cpu(torch, cases3,
                         finish_phase3_cpu(torch, cpu3, cpu3_dir))
    finally:
        shutil.rmtree(cpu3_dir, ignore_errors=True)
    stage(f"phase 19: differential_sweep on the card (all 11 families, "
          f"{DIFF_SEEDS} seed a family, tick = golden core)")
    diff19 = phase_differential(torch, sim, cuda_ops)
    stage("phase 20: fault_sweep's device half on the card (precheck, "
          "attacks, storage)")
    outdir = tempfile.mkdtemp(prefix="chip_smoke_fault_")
    try:
        fault20 = phase_fault_sweep(torch, sim, cuda_ops, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    stage(f"phase 21: the executor's rest (tpu://pmatmul n={TASK_N} "
          f"batch={PMATMUL_BATCH}, secret parameters, describe, watch)")
    t21 = time.perf_counter()
    exec21 = phase_executor_rest(torch, task)
    exec21["secs"] = time.perf_counter() - t21
    stage(f"phase 22: the device wire ({WIRE_MANAGERS} raft nodes over "
          f"DeviceMeshTransports, rows={WIRE_ROWS}; scripted flushes)")
    t22 = time.perf_counter()
    wire22 = phase_device_wire(torch)
    wire22["secs"] = time.perf_counter() - t22
    log(f"  phases 21-22 in {exec21['secs']:.1f} + {wire22['secs']:.1f} s")
    stage(f"phase 23: the meshes: explore, the fleet and the scan sharded "
          f"over {len(shard_devices(torch))} entries, the wire's "
          f"all-to-all, bench.py's n={RUNG} rung on one card")
    t23 = time.perf_counter()
    mesh23 = phase_sharded(torch, sim, cuda_ops, mc16)
    mesh23["secs"] = time.perf_counter() - t23
    mc16["n3h8"].pop("summary")
    log(f"  phase 23 in {mesh23['secs']:.1f} s")
    stage(f"phase 24: the row tick: one cluster's rows over "
          f"{len(shard_devices(torch))} entries (phase 3's cases (1) and (3), "
          f"bench.py's n={RUNG} rung held to phase 23's)")
    t24 = time.perf_counter()
    row24 = phase_row_tick(torch, sim, cuda_ops, mesh23["rung"], cases3)
    del cases3
    row24["secs"] = time.perf_counter() - t24
    del mesh23["rung"]["digests"]
    log(f"  phase 24 in {row24['secs']:.1f} s")
    stage(f"phase 25: the control plane on the card ({CP_REPLICAS} replicas "
          f"through the store; swarm-bench's flow and "
          f"{CP_PROGRAM_REPLICAS} tpu://pallas_matmul tasks under the "
          f"port's Agent; the orchestration script card = CPU)")
    t25 = time.perf_counter()
    cp25 = phase_control_plane(torch, cuda_ops, task)
    cp25["secs"] = time.perf_counter() - t25
    log(f"  phase 25 in {cp25['secs']:.1f} s")
    stage(f"phase 26: the raft node shell and the Manager ({Q_MANAGERS} "
          f"managers x {Q_APPENDS} appends on both wires, cpl-batch64, "
          f"swarm-bench through a quorum, failover and restart, a global "
          f"service over Docker's world)")
    t26 = time.perf_counter()
    q26 = phase_quorum(torch, cuda_ops, task)
    q26["secs"] = time.perf_counter() - t26
    log(f"  phase 26 in {q26['secs']:.1f} s")

    elapsed = time.perf_counter() - started
    log(f"all phases passed in {elapsed:.1f} s")
    log("summary " + json.dumps({"card": card, "elapsed_s": elapsed,
                                 **head, "lever_ab": ab,
                                 "band_copy_calls_per_tick": k["calls"],
                                 "task": task, "mailbox": mbox,
                                 "dynamic_members": dyn, "readmix": rmix,
                                 "readmix_4096": rwide, "fsyncgate": fgate,
                                 "planes": planes, "dst": dst13,
                                 "oracle": oracle, "multiraft": mraft,
                                 "multiraft_telemetry": mtel,
                                 "multiraft_card_vs_cpu": mcpu,
                                 "levers_batched": levers, "mc": mc16,
                                 "scheduler": sched17, "tools": tools18,
                                 "differential": diff19,
                                 "fault_sweep": fault20,
                                 "executor_rest": exec21,
                                 "device_wire": wire22, "meshes": mesh23,
                                 "row_tick": row24, "control_plane": cp25,
                                 "quorum": q26},
                                default=str))
    records = [{
        "name": "append_band_copy", "route": "cuda",
        "source": "swarmkit_tpu_torch/csrc/band_copy.cu",
        "replaces": "swarmkit_tpu/parallel/pallas_ops.py:175",
        "launches": head["launches"], "mailbox_launches": mbox_launches,
        "readmix_launches": rmix["band_copy_launches"],
        "readmix_4096_launches": rwide["band_copy_launches"],
        "fsyncgate_launches": fgate["band_copy_launches"],
        "planes_launches": planes["band_copy_launches"],
        "dst_launches": dst13["sweep_256"]["band_copy_launches"],
        "dst_wide_launches": dst13["sweep_wide"]["band_copy_launches"],
        "multiraft_launches": mraft["band_copy_launches"],
        "multiraft_sweep_launches": tools18["sweep_launches"],
        "swarm_top_launches": tools18["top_launches"],
        "multiraft_ms": mraft["band_copy"]["ms"],
        "multiraft_plain_ms": mraft["band_copy"]["plain_ms"],
        "multiraft_bound_ms": mraft["band_copy"]["bound_ms"],
        "multiraft_library_ms": mraft["band_copy"]["library_ms"],
        "levers_launches": {n: r["band_copy_launches"]
                            for n, r in levers.items()},
        "levers_tiled_ms": levers["log_chunk=128"]["band_copy"]["ms"],
        "levers_tiled_plain_ms":
            levers["log_chunk=128"]["band_copy"]["plain_ms"],
        "levers_tiled_bound_ms":
            levers["log_chunk=128"]["band_copy"]["bound_ms"],
        "levers_tiled_library_ms":
            levers["log_chunk=128"]["band_copy"]["library_ms"],
        "mc_launches": mc16["n3h8"]["band_copy_launches"],
        "mc_ms": mc16["pass"]["band_copy"]["ms"],
        "mc_plain_ms": mc16["pass"]["band_copy"]["plain_ms"],
        "mc_bound_ms": mc16["pass"]["band_copy"]["bound_ms"],
        "mc_library_ms": mc16["pass"]["band_copy"]["library_ms"],
        "differential_launches": diff19["band_copy_launches"],
        "fault_sweep_launches": fault20["band_copy_launches"],
        "differential_ms": diff19["band_copy"]["ms"],
        "differential_plain_ms": diff19["band_copy"]["plain_ms"],
        "differential_bound_ms": diff19["band_copy"]["bound_ms"],
        "differential_library_ms": diff19["band_copy"]["library_ms"],
        "fault_sweep_ms": fault20["band_copy"]["ms"],
        "fault_sweep_plain_ms": fault20["band_copy"]["plain_ms"],
        "fault_sweep_bound_ms": fault20["band_copy"]["bound_ms"],
        "fault_sweep_library_ms": fault20["band_copy"]["library_ms"],
        "sharded_dst_launches": mesh23["dst"]["launches"],
        "sharded_fleet_launches": mesh23["fleet"]["launches"],
        "sharded_mc_launches": mesh23["mc"]["launches"],
        "rung_launches": mesh23["rung"]["band_copy_launches"],
        "rung_ms": mesh23["rung"]["band_copy"]["ms"],
        "rung_plain_ms": mesh23["rung"]["band_copy"]["plain_ms"],
        "rung_bound_ms": mesh23["rung"]["band_copy"]["bound_ms"],
        "rung_library_ms": mesh23["rung"]["band_copy"]["library_ms"],
        "row_tick_launches": row24["band_copy_launches"],
        "row_tick_ms": row24["band_copy"]["ms"],
        "row_tick_plain_ms": row24["band_copy"]["plain_ms"],
        "row_tick_bound_ms": row24["band_copy"]["bound_ms"],
        "row_tick_library_ms": row24["band_copy"]["library_ms"],
        "max_abs_err": max(err2, k["err"], err9, rmix["err"], planes["err"],
                           dst13["sweep_256"]["err"],
                           mraft["band_copy"]["err"],
                           max(r["err"] for r in levers.values()),
                           mc16["pass"]["band_copy"]["err"],
                           diff19["band_copy"]["err"],
                           fault20["band_copy"]["err"],
                           mesh23["dst"]["err"], mesh23["fleet"]["err"],
                           mesh23["mc"]["err"],
                           mesh23["rung"]["band_copy"]["err"],
                           row24["band_copy"]["err"]),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k["library_ms"]}]
    for name, line, bound_by in (("matmul", 76, "operations"),
                                 ("sumsq", 141, "bytes")):
        t = f8[name]
        records.append({
            "name": name, "route": "cuda",
            "source": f"swarmkit_tpu_torch/csrc/{name}.cu",
            "replaces": f"swarmkit_tpu/parallel/pallas_ops.py:{line}",
            "launches": task["launches"][name],
            "control_plane_launches":
                cp25["b"]["launches"]["matmul_wgmma" if name == "matmul"
                                      else name],
            "quorum_launches":
                q26["c"]["launches"]["matmul_wgmma" if name == "matmul"
                                     else name],
            "max_abs_err": max(err6[name], t["err"]), "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": bound_by, "library_ms": t["library"]})
    # the WMMA kernel that the wgmma kernel replaced, on the same inputs
    records[1]["previous_ms"] = f8["matmul"]["previous"]
    groups = sorted(g for g in sched17 if len(g) == 1)
    a17 = sched17["A"]
    records.append({
        "name": "sched_place", "route": "cuda",
        "source": "swarmkit_tpu_torch/csrc/sched_place.cu",
        # no Pallas ancestor: the JAX package's jitted greedy fori_loop
        "replaces": "swarmkit_tpu/manager/scheduler/kernel.py:183",
        "launches": sum(sched17[g]["launches"] for g in groups),
        # phase 25: the store loop's ticks at Docker's scale, the
        # swarm-bench flow's ticks, and the orchestration script's
        "control_plane_launches": cp25["a"]["launches"],
        "control_plane_kernel_ms": cp25["a"]["kernel_ms_per_tick"],
        "control_plane_startup_launches":
            cp25["b"]["launches"]["sched_place"],
        "control_plane_script_launches": cp25["c"]["launches"],
        # phase 26 (c): the store loop of a raft quorum's leader
        "quorum_launches": q26["c"]["launches"]["sched_place"],
        "max_abs_err": max(max(sched17[g]["err"] for g in groups),
                           cp25["a"]["err"], q26["c"]["place_err"]),
        "ms": a17["ms"], "tasks": a17["tasks"],
        # the plain loop on the card over the first plain_tasks tasks,
        # and the kernel on the same prefix
        "plain_ms": a17["plain_prefix_ms"],
        "plain_tasks": SCHED_PLAIN_PREFIX, "prefix_ms": a17["prefix_ms"],
        "plain_launches": a17["plain_prefix_launches"],
        "bound_ms": a17["bound_ms"], "bound_by": a17["bound_by"],
        "library_ms": None,
        # the rescan kernel the tree kernel replaced, on the same columns
        "previous_ms": a17["previous_ms"],
        "chain_ms": sched17["chain"][SCHED_CHAIN_NODES[0]]["ms"][
            cuda_ops.PLACE_VARIANT],
        "chain": {n: c["ms"] for n, c in sched17["chain"].items()},
        "groups": {g: {k: sched17[g][k] for k in (
            "tasks", "tasks_run", "launches", "ms", "previous_ms",
            "kernel_ms", "us_per_task", "us_per_task_run", "bound_ms",
            "plain_prefix_ms", "prefix_ms", "host_us_per_task")}
            for g in groups}})
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [PHASE3_CPU_FLAG]:
        sys.exit(phase3_cpu_main(sys.argv[2]))
    sys.exit(main())
