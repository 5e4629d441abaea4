"""Fault-injection sweep on the port: the device half of the JAX package's
tools/fault_sweep.py.

Three device runs, each on the port's tick:

- ``--peer-chunk`` / ``--active-rows`` (the lowering precheck): each
  selected fault plan (down, drop, partition, delay, crash) is lowered to
  a device fault schedule (``raft.faults.plan_to_schedule``) and run
  through the DST tick in the requested peer-axis lowering
  (``SimConfig.peer_chunk``, banded quorum reductions) with a dense
  cross-check: the violation bitmasks, first-violation ticks and per-tick
  bit traces must match bit for bit.  ``--peer-chunk 0`` pins the dense
  path only.  ``--active-rows`` does the same for the role-sparse progress
  lowering (``SimConfig.active_rows``): a nonzero A runs the [A, N] slab
  with a dense-progress cross-check, 0 pins the dense path.
- ``--attacks``: the Byzantine-ish adversary scenarios
  (``ATTACK_SCENARIOS``).  For each attack a seed-pinned DST sweep must
  catch the named invariant bit with the defense off, shrink the first
  counterexample to a replay-exact artifact, hold the differential oracle
  in lockstep, and come back clean with the defense on.
- ``--storage``: the storage-fault scenarios (``STORAGE_SCENARIOS``): disk
  truncation, torn writes, corrupt snapshots and fsync stalls against the
  tick's durability model (``SimConfig.fsync_lag_ticks`` /
  ``ack_gating``).  Trip scenarios follow the attack pipeline;
  containment scenarios must stay violation-free while the recovery
  signature code proves the fault actually bit.

The attack and storage verbs force device state, so each host wire gets
an explicit skip row.  The host-wire sweep itself (a 3-node cluster of the
host raft ``Node`` over a store on each of the inproc, devmesh and grpc
wires) runs host-only layers the port does not carry: without one of the
four device flags the tool stops with an error rather than report a pass
it did not run.

    python -m swarmkit_tpu_torch.tools.fault_sweep --peer-chunk 8
    python -m swarmkit_tpu_torch.tools.fault_sweep --active-rows 8
    python -m swarmkit_tpu_torch.tools.fault_sweep --attacks all
    python -m swarmkit_tpu_torch.tools.fault_sweep --storage all \
        --device cpu

It runs on the CUDA card and raises without one, unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch import dst
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.raft.faults import FaultPlan
from swarmkit_tpu_torch.raft.sim.state import SimConfig, init_state
from swarmkit_tpu_torch.tools import _cli_common

WIRES = ("inproc", "devmesh", "grpc")
PLANS = ("down", "drop", "partition", "delay", "crash")
DEFAULT_SEEDS = (2009343,)

# Byzantine-ish adversary scenarios (--attacks): each row pins the
# defense-off / defense-on SimConfig deltas, the invariant bit that
# witnesses the attack, and the schedule shape validated end-to-end by
# the DST pipeline (catch -> shrink -> artifact -> replay -> oracle).
# These run on the DEVICE wire only — the verbs are FaultSchedule leaves
# that force kernel state arrays (vote registers, election timers,
# transfer requests) between ticks, and the three host wires expose no
# equivalent state-injection seam on a live Node — so the sweep emits an
# explicit per-wire skip row for inproc/devmesh/grpc instead of
# silently narrowing coverage.
ATTACK_SCENARIOS = {
    "disruptive_rejoin": dict(
        off=dict(pre_vote=False, check_quorum=False,
                 collect_telemetry=True, slo_leader_changes=2),
        on=dict(pre_vote=True, check_quorum=True,
                collect_telemetry=True, slo_leader_changes=2),
        ticks=120, prop_count=2, bit="slo_leader_churn",
        defense="PreVote + CheckQuorum"),
    "vote_equivocation": dict(
        # check_quorum off on BOTH sides: the lease refuses the rival's
        # re-requests for the unrelated reason of fresh leader contact,
        # which would mask the vote-guard hole under test
        off=dict(check_quorum=False),
        on=dict(check_quorum=False, vote_guard=True),
        ticks=40, prop_count=2, bit="election_safety",
        defense="persisted-vote guard"),
    "append_flood": dict(
        off=dict(slo_log_occupancy=24),
        on=dict(slo_log_occupancy=24, prop_inflight_cap=8),
        ticks=120, prop_count=0, bit="slo_log_occupancy",
        defense="per-row inflight cap"),
    "transfer_abuse": dict(
        off=dict(collect_telemetry=True, slo_leader_changes=8),
        on=dict(collect_telemetry=True, slo_leader_changes=8,
                transfer_cooldown_ticks=60),
        ticks=120, prop_count=2, bit="slo_leader_churn",
        defense="transfer cooldown"),
}

ATTACK_WIRE_SKIP = (
    "attack verbs force kernel state arrays between ticks; host Node "
    "wires have no state-injection seam (device-only by design)")

# Storage-fault scenarios (--storage): the durability boundary of the
# explicit per-row storage model (SimConfig.fsync_lag_ticks arms the
# sync_mark watermark, SimConfig.ack_gating pins acks/votes/commit to
# it).  Two shapes:
#   mode="trip":    defense-off must CATCH the named invariant bit, the
#                   first counterexample shrinks to a replay-exact
#                   artifact, defense-on is clean on the SAME schedules
#                   (the attack-sweep pipeline).
#   mode="contain": the fault must be ABSORBED — the gated config stays
#                   violation-free while the recovery signature code
#                   (STORAGE_SIGNATURE_CODES) proves the verb actually
#                   fired and was repaired, not silently skipped.
# `oracle` picks the differential-oracle bound for trip artifacts:
#   "violation" — the bit is a SAFETY bit and the verb tick IS the
#                 violation tick, so replay_artifact's SAFETY_BITS
#                 truncation already compares exactly the clean prefix;
#   "verb"      — kernel-side divergence precedes the trip (poisoned
#                 install, stall-refused votes), so the sweep bounds its
#                 own oracle_trace at the first storage-verb tick (the
#                 host oracle models a perfect disk; see dst/repro.py).
STORAGE_SCENARIOS = {
    "lost_tail": dict(
        off=dict(fsync_lag_ticks=6),
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=120, prop_count=2, bit="durability", mode="trip",
        oracle="violation", defense="durable-watermark ack gating"),
    "torn_write": dict(
        off=None,
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=120, prop_count=2, bit=None, mode="contain",
        defense="checksummed-scan truncation + quorum re-replication"),
    "snap_corrupt": dict(
        off=dict(fsync_lag_ticks=6),
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=140, prop_count=2, bit="checksum_agreement", mode="trip",
        oracle="verb", defense="pre-install snapshot checksum verify"),
    "disk_stall": dict(
        off=dict(fsync_lag_ticks=2, slo_fsync_lag=8),
        on=dict(fsync_lag_ticks=2, slo_fsync_lag=8, ack_gating=True,
                prop_inflight_cap=8),
        ticks=120, prop_count=2, bit="slo_fsync_lag", mode="trip",
        oracle="verb",
        defense="ack gating + per-row inflight cap backpressure"),
}

STORAGE_WIRE_SKIP = (
    "storage verbs rewrite kernel log/watermark registers between ticks; "
    "the host wires' real on-disk WAL is covered by the raft/storage.py "
    "truncation-parity tests instead")

HOST_WIRES = (
    "the host-wire sweep (inproc, devmesh, grpc) drives the host raft "
    "Node over a store, host-only layers the port does not carry")


# --------------------------------------------------------------------------
# device-side precheck: the same fault vocabulary in a chosen peer lowering


def _device_plan(name: str, addrs: list[str]) -> FaultPlan:
    """The host sweep's plan shapes rebuilt over synthetic tick rows."""
    lead, victim = addrs[0], addrs[1]
    if name == "down":
        return FaultPlan.down(victim)
    if name == "drop":
        return FaultPlan.drop(lead, victim, p=0.6)
    if name == "partition":
        return FaultPlan.split([victim], [a for a in addrs if a != victim])
    if name == "delay":
        return FaultPlan.delay(lead, victim, 2.0)
    if name == "crash":
        return FaultPlan.crash(victim)
    raise ValueError(f"unknown fault plan {name!r}")


def _precheck_cfg(n: int, seed: int, peer_chunk: int,
                  active_rows=None) -> SimConfig:
    """The precheck's cluster in a peer and progress lowering."""
    return SimConfig(n=n, log_len=64, window=8, apply_batch=16,
                     max_props=8, keep=4, election_tick=10, seed=seed,
                     log_chunk=0, peer_chunk=peer_chunk,
                     **_cli_common.active_rows_kw(active_rows))


def _precheck_schedule(cfg: SimConfig, plan_name: str, ticks: int,
                       seed: int, dev) -> dst.FaultSchedule:
    """Plan `plan_name` lowered over cfg.n synthetic rows, as the
    one-schedule batch explore takes: a [1, T, ...] FaultSchedule."""
    addrs = [f"row-{i}.sweep:4242" for i in range(cfg.n)]
    rows = {a: i for i, a in enumerate(addrs)}
    sched = dst.from_fault_plan(
        cfg, _device_plan(plan_name, addrs), rows, ticks=ticks,
        inject_at=10, heal_at=40, seed=seed, device=dev)
    return dst.FaultSchedule(
        **{k: v[None] for k, v in sched.leaves().items()})


def _precheck_run(cfg: SimConfig, batched: dst.FaultSchedule, dev):
    return dst.explore(init_state(cfg, device=dev), cfg, batched,
                       device=dev)


def _same_masks(a, b) -> bool:
    """Two explore results with equal violation bitmasks, first-violation
    ticks and per-tick bit traces."""
    return (np.array_equal(a.viol, b.viol)
            and np.array_equal(a.first_tick, b.first_tick)
            and np.array_equal(a.bits_by_tick, b.bits_by_tick))


def run_device_precheck(plans=PLANS, seeds=DEFAULT_SEEDS, peer_chunk: int = 8,
                        n: int = 16, ticks: int = 60,
                        verbose: bool = True, active_rows=None,
                        device=None, stats: Optional[dict] = None
                        ) -> list[dict]:
    """Lower every (plan, seed) to a device fault schedule and run it
    through the DST tick with ``SimConfig.peer_chunk=peer_chunk`` and
    ``SimConfig.active_rows=active_rows`` (None = default), on `device`
    (the CUDA card unless the caller names another).

    When the chunk selects the banded lowering the run is cross-checked
    against the dense tick: violation bitmasks, first-violation ticks,
    and per-tick bit traces must match exactly (the hierarchical quorum
    reductions are integer sums, so any drift is a bug, not noise).
    ``peer_chunk=0`` runs the dense lowering alone.  Likewise, when
    ``active_rows`` selects the role-sparse progress slabs the run is
    cross-checked against the dense elementwise progress tick
    (``active_rows=0``) under the same peer lowering.  `stats`, when
    given, receives under (plan, seed) the requested lowering's explore
    result (its ``viol``, ``first_tick`` and ``bits_by_tick``).
    """
    dev = resolve_device(device)
    results = []
    for plan_name in plans:
        for seed in seeds:
            t0 = time.monotonic()
            cfg = _precheck_cfg(n, seed, peer_chunk, active_rows)
            sched = _precheck_schedule(cfg, plan_name, ticks, seed, dev)
            res = _precheck_run(cfg, sched, dev)
            if stats is not None:
                stats[(plan_name, seed)] = res
            ok, err = True, ""
            notes = (f"viol=0x{int(res.viol[0]):x} "
                     f"lowering={'banded' if cfg.peer_tiled else 'dense'}"
                     + ("+sparse" if cfg.active_rows_on else ""))
            if cfg.peer_tiled:
                ref = _precheck_run(
                    _precheck_cfg(n, seed, 0, active_rows), sched, dev)
                if not _same_masks(res, ref):
                    ok = False
                    err = (f"banded/dense divergence: viol "
                           f"{res.viol.tolist()} vs {ref.viol.tolist()}")
                else:
                    notes += " == dense-peer"
            if ok and cfg.active_rows_on:
                ref = _precheck_run(
                    _precheck_cfg(n, seed, peer_chunk, 0), sched, dev)
                if not _same_masks(res, ref):
                    ok = False
                    err = (f"sparse/dense progress divergence: viol "
                           f"{res.viol.tolist()} vs {ref.viol.tolist()}")
                else:
                    notes += " == dense-progress"
            wire = f"device(pc={peer_chunk}" + (
                f",ar={active_rows})" if active_rows is not None else ")")
            results.append({"wire": wire,
                            "plan": plan_name, "seed": seed, "ok": ok,
                            "notes": notes, "error": err,
                            "secs": round(time.monotonic() - t0, 2)})
            if verbose:
                r = results[-1]
                state = "ok  " if ok else "FAIL"
                line = (f"{state} {r['wire']:8s} {plan_name:10s} "
                        f"seed={seed} ({r['secs']}s)  {notes}")
                if not ok:
                    line += f"  {err}"
                print(line, flush=True)
    return results


# --------------------------------------------------------------------------
# the trip pipeline the attack and storage scenarios share


def _catch_and_shrink(off: SimConfig, on: SimConfig, sc: dict, name: str,
                      seed: int, schedules: int, bit: int, dev, st: dict):
    """Defense off must catch `bit`, defense on must be clean on the SAME
    schedules; the first counterexample is shrunk and replayed.  Returns
    (its index, the shrunk schedule, the replayed viol and first tick);
    `st` receives the caught count, the schedules, the fault events
    before and after the shrink and its evals."""
    batch, names = dst.make_batch(off, ticks=sc["ticks"],
                                  schedules=schedules, seed=seed,
                                  profiles=(name,), device=dev)
    r_off = dst.explore(init_state(off, device=dev), off, batch,
                        profiles=names, prop_count=sc["prop_count"],
                        device=dev)
    caught = [int(s) for s in r_off.violating if int(r_off.viol[s]) & bit]
    if not caught:
        raise AssertionError(f"defense-off sweep never tripped {sc['bit']}")
    r_on = dst.explore(init_state(on, device=dev), on, batch,
                       profiles=names, prop_count=sc["prop_count"],
                       device=dev)
    if int((r_on.viol != 0).sum()):
        raise AssertionError(
            f"defense-on ({sc['defense']}) not clean: "
            f"{[hex(int(v)) for v in r_on.viol]}")
    s = caught[0]
    one = batch.slice(s)
    before = dst.fault_count(one)
    small, evals = dst.shrink(off, one, bit, sc["prop_count"], device=dev)
    v2, f2 = dst.replay(off, small, sc["prop_count"], device=dev)
    st.update(caught=len(caught), schedules=schedules, faults_before=before,
              faults_after=dst.fault_count(small), shrink_evals=evals)
    return s, small, v2, f2


def _trip_notes(st: dict, sc: dict, tail: str, path: str) -> str:
    return (f"caught {st['caught']}/{st['schedules']} ({sc['bit']}), "
            f"shrunk {st['faults_before']}->{st['faults_after']} "
            f"fault-events in {st['shrink_evals']} replays, replay exact, "
            f"{tail}, defense-on ({sc['defense']}) clean [{path}]")


def _report(results: list, name: str, seed: int, ok: bool,
            notes: str, err: str, t0: float, wires, skip: str,
            verbose: bool, st: dict) -> None:
    results.append({"wire": "device", "plan": name, "seed": seed,
                    "ok": ok, "notes": notes, "error": err,
                    "secs": round(time.monotonic() - t0, 2)})
    st["secs"] = time.monotonic() - t0
    if verbose:
        r = results[-1]
        state = "ok  " if ok else "FAIL"
        line = (f"{state} {'device':8s} {name:18s} seed={seed} "
                f"({r['secs']}s)  {notes}")
        if not ok:
            line += f"  {err}"
        print(line, flush=True)
    for wire in wires:
        results.append({"wire": wire, "plan": name, "seed": seed,
                        "ok": True, "skipped": skip,
                        "notes": f"SKIP: {skip}", "secs": 0.0})
        if verbose:
            print(f"skip {wire:8s} {name:18s} seed={seed} ({skip})",
                  flush=True)


def _out_path(out_dir: Optional[str], name: str) -> str:
    return _cli_common.artifact_path(
        None if out_dir is None else out_dir.rstrip(os.sep) + os.sep, name)


# --------------------------------------------------------------------------
# adversary attack scenarios (device wire): full counterexample pipeline


def run_attack_sweep(attacks=None, seed: int = 7, schedules: int = 8,
                     n: int = 5, out_dir: Optional[str] = None,
                     wires=WIRES, verbose: bool = True, device=None,
                     stats: Optional[dict] = None) -> list[dict]:
    """Seed-pinned end-to-end run of each ATTACK_SCENARIOS row, on
    `device` (the CUDA card unless the caller names another).

    For every attack: the defense-off sweep must CATCH it (the named
    invariant bit trips), the first counterexample is shrunk and dumped
    as a replayable artifact (replay must reproduce bits + first tick
    exactly, the differential oracle must stay in lockstep over the
    clean prefix), and the defense-on sweep over the SAME schedules must
    come back violation-free.  Host wires get explicit skip rows — see
    ATTACK_WIRE_SKIP.  `stats`, when given, receives per attack the
    caught count, the fault events before and after the shrink, its
    evals, the oracle's diverged_at, the artifact path and the seconds."""
    dev = resolve_device(device)
    attacks = list(attacks or ATTACK_SCENARIOS)
    base = SimConfig(n=n, log_len=64, window=8, apply_batch=16, max_props=8,
                     keep=4, election_tick=10, seed=seed)
    bit_of = {name: bit for bit, name in dst.BIT_NAMES.items()}
    results = []
    for attack in attacks:
        sc = ATTACK_SCENARIOS[attack]
        t0 = time.monotonic()
        off = dataclasses.replace(base, **sc["off"])
        on = dataclasses.replace(base, **sc["on"])
        bit = bit_of[sc["bit"]]
        st = {} if stats is None else stats.setdefault(attack, {})
        ok, err, notes = True, "", ""
        try:
            s, small, v2, f2 = _catch_and_shrink(
                off, on, sc, attack, seed, schedules, bit, dev, st)
            art = dst.to_artifact(off, small, seed=seed, profile=attack,
                                  index=s, prop_count=sc["prop_count"],
                                  mutation=None, viol=v2, first_tick=f2)
            path = _out_path(out_dir, f"dst_attack_{attack}.json")
            dst.save_artifact(path, art)
            verdict = dst.replay_artifact(path, device=dev)
            if not verdict["matches_recorded"]:
                raise AssertionError("artifact replay did not reproduce "
                                     "the recorded violation")
            tr = verdict["oracle"]
            st.update(diverged_at=tr["diverged_at"], artifact=path)
            if tr["diverged_at"] != -1:
                raise AssertionError(f"differential oracle diverged at "
                                     f"tick {tr['diverged_at']}")
            notes = _trip_notes(st, sc, "oracle lockstep", path)
        except AssertionError as e:
            ok, err = False, str(e)
        _report(results, attack, seed, ok, notes, err, t0, wires,
                ATTACK_WIRE_SKIP, verbose, st)
    return results


# --------------------------------------------------------------------------
# storage-fault scenarios (device wire): the durability boundary


def run_storage_sweep(faults=None, seed: int = 7, schedules: int = 8,
                      n: int = 5, out_dir: Optional[str] = None,
                      wires=WIRES, verbose: bool = True, device=None,
                      stats: Optional[dict] = None) -> list[dict]:
    """Seed-pinned end-to-end run of each STORAGE_SCENARIOS row (see the
    table above for the trip/contain split and the oracle bounds), on
    `device` (the CUDA card unless the caller names another).  `stats` as
    run_attack_sweep's (a contain row: its violations and recovery
    events)."""
    dev = resolve_device(device)
    faults = list(faults or STORAGE_SCENARIOS)
    base = SimConfig(n=n, log_len=64, window=8, apply_batch=16, max_props=8,
                     keep=4, election_tick=10, seed=seed)
    bit_of = {name: bit for bit, name in dst.BIT_NAMES.items()}
    results = []
    for fault in faults:
        sc = STORAGE_SCENARIOS[fault]
        t0 = time.monotonic()
        on = dataclasses.replace(base, **sc["on"])
        st = {} if stats is None else stats.setdefault(fault, {})
        ok, err, notes = True, "", ""
        try:
            if sc["mode"] == "contain":
                batch, names = dst.make_batch(on, ticks=sc["ticks"],
                                              schedules=schedules, seed=seed,
                                              profiles=(fault,), device=dev)
                r_on = dst.explore(init_state(on, device=dev), on, batch,
                                   profiles=names,
                                   prop_count=sc["prop_count"], device=dev)
                if int((r_on.viol != 0).sum()):
                    raise AssertionError(
                        f"gated config not clean under {fault}: "
                        f"{[hex(int(v)) for v in r_on.viol]}")
                code = dst.STORAGE_SIGNATURE_CODES[fault]
                fl = dst.capture_flight(on, batch.slice(0),
                                        sc["prop_count"], window=400,
                                        device=dev)
                hits = sum(code in e.describe()
                           for e in fl["record"].window(400))
                st.update(schedules=schedules, violations=0,
                          recovery_events=hits)
                if not hits:
                    raise AssertionError(
                        f"{code} never fired — the {fault} verb was "
                        f"absorbed without any recovery evidence")
                notes = (f"contained: 0/{schedules} violations with "
                         f"{sc['defense']}, {hits} {code} recovery "
                         f"event(s) on schedule 0")
            else:
                off = dataclasses.replace(base, **sc["off"])
                bit = bit_of[sc["bit"]]
                s, small, v2, f2 = _catch_and_shrink(
                    off, on, sc, fault, seed, schedules, bit, dev, st)
                art = dst.to_artifact(off, small, seed=seed, profile=fault,
                                      index=s, prop_count=sc["prop_count"],
                                      mutation=None, viol=v2, first_tick=f2)
                path = _out_path(out_dir, f"dst_storage_{fault}.json")
                dst.save_artifact(path, art)
                want_trace = sc["oracle"] == "violation"
                verdict = dst.replay_artifact(path, with_trace=want_trace,
                                              device=dev)
                if not verdict["matches_recorded"]:
                    raise AssertionError("artifact replay did not reproduce "
                                         "the recorded violation")
                if want_trace:
                    div = verdict["oracle"]["diverged_at"]
                else:
                    # the first tick the verb fires, reduced on the device
                    # (one read); the oracle is compared before it
                    leaf = getattr(small, dst.STORAGE_LEAVES[fault])
                    ticks = torch.arange(leaf.shape[0], device=leaf.device)
                    first_verb = int(torch.where(leaf.any(dim=1), ticks,
                                                 leaf.shape[0]).min())
                    div = dst.oracle_trace(
                        off, small, sc["prop_count"], until=first_verb,
                        device=dev)["diverged_at"]
                st.update(diverged_at=div, artifact=path)
                if div != -1:
                    raise AssertionError(f"differential oracle diverged at "
                                         f"tick {div}")
                notes = _trip_notes(
                    st, sc, f"oracle lockstep ({sc['oracle']}-bounded)", path)
        except AssertionError as e:
            ok, err = False, str(e)
        _report(results, fault, seed, ok, notes, err, t0, wires,
                STORAGE_WIRE_SKIP, verbose, st)
    return results


# --------------------------------------------------------------------------
# the command line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--wires", default=",".join(WIRES),
                    help=f"comma list from {WIRES} (the host wires get "
                    f"skip rows in --attacks / --storage)")
    ap.add_argument("--plans", default=",".join(PLANS),
                    help=f"comma list from {PLANS}")
    ap.add_argument("--seeds", default=",".join(map(str, DEFAULT_SEEDS)),
                    help="comma list of seeds")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="write the attack and storage repro artifacts "
                    "here (default: the system temp dir)")
    ap.add_argument("--peer-chunk", type=int, default=None, metavar="PC",
                    help="run every plan through the DST tick in this "
                         "peer-axis lowering (SimConfig.peer_chunk; 0 = "
                         "dense, else banded + dense cross-check)")
    ap.add_argument("--attacks", default=None, metavar="LIST",
                    help=f"run ONLY the seed-pinned adversary attack "
                    f"scenarios ('all' or a comma list from "
                    f"{tuple(ATTACK_SCENARIOS)}): device-wire "
                    f"counterexample pipeline + explicit per-host-wire "
                    f"skip rows (the verbs have no host seam)")
    ap.add_argument("--storage", default=None, metavar="LIST",
                    help=f"run ONLY the seed-pinned storage-fault "
                    f"scenarios ('all' or a comma list from "
                    f"{tuple(STORAGE_SCENARIOS)}): device-wire durability "
                    f"pipeline (catch -> shrink -> replay-exact -> "
                    f"gating-on clean) + explicit per-host-wire skip rows")
    _cli_common.add_active_rows_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    args = ap.parse_args(argv)

    wires = [w for w in args.wires.split(",") if w]
    plans = [p for p in args.plans.split(",") if p]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for w in wires:
        if w not in WIRES:
            ap.error(f"unknown wire {w!r}")
    for p in plans:
        if p not in PLANS:
            ap.error(f"unknown plan {p!r}")
    attacks = faults = None
    if args.attacks:
        attacks = (list(ATTACK_SCENARIOS) if args.attacks == "all"
                   else [a for a in args.attacks.split(",") if a])
        for a in attacks:
            if a not in ATTACK_SCENARIOS:
                ap.error(f"unknown attack {a!r}; "
                         f"known: {tuple(ATTACK_SCENARIOS)}")
    if args.storage:
        faults = (list(STORAGE_SCENARIOS) if args.storage == "all"
                  else [f for f in args.storage.split(",") if f])
        for f in faults:
            if f not in STORAGE_SCENARIOS:
                ap.error(f"unknown storage fault {f!r}; "
                         f"known: {tuple(STORAGE_SCENARIOS)}")
    precheck = args.peer_chunk is not None or args.active_rows is not None
    if not (attacks or faults or precheck):
        ap.error(f"{HOST_WIRES}; pass one of the device runs: "
                 f"--peer-chunk, --active-rows, --attacks or --storage")
    dev = resolve_device(args.device)

    if attacks:
        results = run_attack_sweep(attacks, seed=seeds[0], wires=wires,
                                   out_dir=args.flight_dir, device=dev)
        failed = [r for r in results if not r["ok"]]
        ran = [r for r in results if "skipped" not in r]
        print(f"\n{len(ran) - len(failed)}/{len(ran)} attack scenarios "
              f"passed ({len(results) - len(ran)} host-wire skips)")
        return 1 if failed else 0

    if faults:
        results = run_storage_sweep(faults, seed=seeds[0], wires=wires,
                                    out_dir=args.flight_dir, device=dev)
        failed = [r for r in results if not r["ok"]]
        ran = [r for r in results if "skipped" not in r]
        print(f"\n{len(ran) - len(failed)}/{len(ran)} storage scenarios "
              f"passed ({len(results) - len(ran)} host-wire skips)")
        return 1 if failed else 0

    results = run_device_precheck(
        plans, seeds,
        peer_chunk=args.peer_chunk if args.peer_chunk is not None else 8,
        active_rows=args.active_rows, device=dev)
    failed = [r for r in results if not r["ok"]]
    print(f"\n{len(results) - len(failed)}/{len(results)} device precheck "
          f"scenarios passed (not run: {HOST_WIRES})")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
