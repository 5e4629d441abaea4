"""Deterministic-simulation sweep on the port: fault-schedule search with
on-device raft invariant checking (swarmkit_tpu_torch/dst/), the JAX
package's tools/dst_sweep.py on the [S] tick.

    python -m swarmkit_tpu_torch.tools.dst_sweep --schedules 256 --ticks 100
    python -m swarmkit_tpu_torch.tools.dst_sweep --mutate commit_no_quorum \
        --out repro.json
    python -m swarmkit_tpu_torch.tools.dst_sweep --replay repro.json
    python -m swarmkit_tpu_torch.tools.dst_sweep --term-inflation-demo
    (and --disruptive-rejoin-demo, --transfer-abuse-demo, --lost-tail-demo)

It runs on the CUDA card and raises without one, unless --device cpu.

1. **Sweep** (default): S adversarial schedules over the named profiles,
   S x N clusters advanced together, with ElectionSafety / LogMatching /
   LeaderCompleteness / commit monotonicity / applied-checksum agreement /
   read linearizability checked every tick (``--reads`` arms the last).
   The stock kernel must report ZERO violations.
2. **Mutation self-test** (after the sweep unless suppressed): a smaller
   sweep against a deliberately broken kernel knob must be caught; the
   first counterexample is shrunk, dumped as a JSON artifact (the JAX
   package's format) and replayed — bits and first tick must reproduce
   exactly.  Two knobs: ``commit_no_quorum`` and ``stale_lease_read``
   (swept under EXTRA_PROFILES, whose stale_leader_reads adversary
   realizes it).

The schedules follow the JAX package's profile laws but not its random
stream (dst/schedule.py), so a seed's schedules, and the demos' numbers,
are the port's own.  A replay also runs the artifact through the host
golden core in lockstep (dst.oracle_trace) and reports where the two first
diverge.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from swarmkit_tpu_torch import dst
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.raft.sim.state import SimConfig, init_state

DEFAULT_MUTATION = "commit_no_quorum"

# each mutation is swept under the adversary rotation that realizes the
# scenario it breaks: the stale-read knob needs the pinned-victim
# stale-leader overlap, which lives in EXTRA_PROFILES
MUTATION_PROFILES = {
    "stale_lease_read": dst.EXTRA_PROFILES,
}


# ---- the CLI plumbing the JAX package keeps in tools/_cli_common.py -------

def add_common_args(ap: argparse.ArgumentParser) -> None:
    """The flags every sweep shares: determinism pin + artifact routing."""
    ap.add_argument("--seed", type=int, default=0,
                    help="seed pinned into every schedule and every repro "
                    "artifact (replays are exact)")
    ap.add_argument("--out", default=None,
                    help="repro-artifact destination: a .json path, or a "
                    "directory to drop default-named artifacts into "
                    "(default: the system temp dir)")
    ap.add_argument("--prop-count", type=int, default=None,
                    help="proposals injected per tick (default: the "
                    "sweep's own)")
    ap.add_argument("--replay", default=None, metavar="ARTIFACT",
                    help="replay a JSON repro artifact and exit")


def add_demo_arg(ap: argparse.ArgumentParser, name: str,
                 help_text: str) -> None:
    """Register a ``--<name>-demo`` flag: run ONLY the named defense-off vs
    defense-on scenario, print the contrast, exit 0 iff the defense
    neutralizes the attack with zero violations."""
    ap.add_argument(f"--{name}-demo", action="store_true", help=help_text)


def add_active_rows_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--active-rows", type=int, default=None, metavar="A",
                    help="role-sparse progress lowering "
                    "(SimConfig.active_rows): 0 = dense; a multiple of 8 < n "
                    "= [A, N] slab (the batch's, with the dense rows "
                    "when a cluster's active rows overflow it); "
                    "default = SimConfig default")


def active_rows_kw(active_rows) -> dict:
    """SimConfig kwargs for an --active-rows value (None = default)."""
    return {} if active_rows is None else {"active_rows": active_rows}


def artifact_path(out, default_name: str) -> str:
    """Resolve --out (None | directory | file path) to a file path."""
    if out is None:
        return os.path.join(tempfile.gettempdir(), default_name)
    if os.path.isdir(out) or out.endswith(os.sep):
        os.makedirs(out, exist_ok=True)
        return os.path.join(out, default_name)
    parent = os.path.dirname(os.path.abspath(out))
    os.makedirs(parent, exist_ok=True)
    return out


# ---- the sweep ------------------------------------------------------------

def _cfg(n: int, seed: int, reads: int = 2,
         peer_chunk=None, active_rows=None) -> SimConfig:
    """The DST cluster shape: small rows, small ring — schedule diversity,
    not cluster size, is the search dimension.  `reads` enables the
    linearizable read path (0 sweeps the read-free kernel); `peer_chunk`
    and `active_rows` pick the lowerings (None = SimConfig default, which
    is dense at these sizes)."""
    kw = {} if peer_chunk is None else {"peer_chunk": peer_chunk}
    kw.update(active_rows_kw(active_rows))
    return SimConfig(n=n, log_len=64, window=8, apply_batch=16, max_props=8,
                     keep=4, election_tick=10, seed=seed, read_batch=reads,
                     **kw)


def run_sweep(schedules: int = 256, ticks: int = 100, seed: int = 0,
              n: int = 5, prop_count: int = 2, profiles=dst.PROFILES,
              mutation=None, reads: int = 2, verbose: bool = True,
              peer_chunk=None, active_rows=None, device=None) -> dict:
    """One explore() call; returns a result summary dict (importable)."""
    dev = resolve_device(device)
    cfg = _cfg(n, seed, reads, peer_chunk, active_rows)
    batch, names = dst.make_batch(cfg, ticks=ticks, schedules=schedules,
                                  seed=seed, profiles=profiles, device=dev)
    res = dst.explore(init_state(cfg, device=dev), cfg, batch,
                      profiles=names, prop_count=prop_count,
                      mutation=mutation, device=dev)
    by_profile: dict[str, int] = {}
    for s in res.violating:
        by_profile[names[s]] = by_profile.get(names[s], 0) + 1
    out = {
        "schedules": schedules, "ticks": ticks, "seed": seed, "n": n,
        "mutation": mutation,
        "violations": int((res.viol != 0).sum()),
        "violating_profiles": by_profile,
        "elapsed": round(res.elapsed, 3),
        "schedules_per_sec": round(res.schedules_per_sec, 1),
    }
    if verbose:
        tag = f" [mutation={mutation}]" if mutation else ""
        print(f"explored {schedules} schedules x {ticks} ticks x {n} rows"
              f"{tag} on {dev}: {out['violations']} violation(s), "
              f"{out['elapsed']}s ({out['schedules_per_sec']} schedules/s)",
              flush=True)
    out["_result"] = res
    out["_batch"] = batch
    out["_names"] = names
    out["_cfg"] = cfg
    return out


def run_mutation_demo(schedules: int = 24, ticks: int = 100, seed: int = 0,
                      n: int = 5, prop_count: int = 2,
                      mutation: str = DEFAULT_MUTATION,
                      out_path=None, profiles=None,
                      verbose: bool = True, peer_chunk=None,
                      active_rows=None, device=None) -> dict:
    """Detect -> shrink -> dump -> replay one seeded mutation repro."""
    dev = resolve_device(device)
    if profiles is None:
        profiles = MUTATION_PROFILES.get(mutation, dst.PROFILES)
    sweep = run_sweep(schedules, ticks, seed, n, prop_count, profiles,
                      mutation=mutation, verbose=verbose,
                      peer_chunk=peer_chunk, active_rows=active_rows,
                      device=dev)
    res, batch, names, cfg = (sweep["_result"], sweep["_batch"],
                              sweep["_names"], sweep["_cfg"])
    demo = {"mutation": mutation, "caught": bool(len(res.violating)),
            "violations": sweep["violations"]}
    if not demo["caught"]:
        if verbose:
            print(f"mutation {mutation!r} NOT caught "
                  f"({schedules}x{ticks}, seed {seed})", flush=True)
        return demo

    s = int(res.violating[0])
    sched = batch.slice(s)
    viol = int(res.viol[s])
    before = dst.fault_count(sched)
    info: dict = {}
    t0 = time.perf_counter()
    small, evals = dst.shrink(cfg, sched, viol, prop_count, mutation,
                              device=dev, info=info)
    shrink_s = time.perf_counter() - t0
    v2, f2 = dst.replay(cfg, small, prop_count, mutation, device=dev)
    # post-mortem: re-run the shrunk schedule with the flight recorder on
    # so the artifact carries the event window explaining the violation
    flight = dst.capture_flight(cfg, small, prop_count, mutation,
                                first_tick=f2, device=dev)
    art = dst.to_artifact(cfg, small, seed=seed, profile=names[s], index=s,
                          prop_count=prop_count, mutation=mutation,
                          viol=v2, first_tick=f2, flight=flight)
    out_path = artifact_path(out_path, f"dst_repro_{mutation}.json")
    dst.save_artifact(out_path, art)
    verdict = dst.replay_artifact(out_path, device=dev)
    demo.update({
        "profile": names[s], "index": s,
        "bits": dst.bits_to_names(viol),
        "fault_count_before": before,
        "fault_count_after": dst.fault_count(small),
        "shrink_evals": evals,
        "shrink_batches": info["batches"],
        "shrink_ticks": info["ticks"],
        "shrink_s": shrink_s,
        "artifact": out_path,
        "replay_matches": verdict["matches_recorded"],
        "oracle_diverged_at": verdict["oracle"]["diverged_at"],
        "first_tick": f2,
        "flight_events": len(flight["window"]),
    })
    if verbose:
        print(f"mutation {mutation!r} caught ({demo['bits']}, profile "
              f"{demo['profile']}): shrunk {before} -> "
              f"{demo['fault_count_after']} fault-events in {evals} replays "
              f"({info['batches']} batched replays, {shrink_s:.2f} s)",
              flush=True)
        replayed = "reproduces exactly" if demo["replay_matches"] \
            else "DIVERGED"
        oracle_note = (
            f"oracle trace localizes divergence at tick "
            f"{demo['oracle_diverged_at']}"
            if demo["oracle_diverged_at"] >= 0 else
            "oracle view agrees (mutation corrupts only read registers, "
            "outside the oracle's field view)")
        print(f"repro artifact: {out_path} — replay {replayed}, "
              f"{oracle_note}", flush=True)
        tail = flight["record"].window(6)
        if tail:
            print(f"flight window (last {len(tail)} device events before "
                  f"the violation):", flush=True)
            for e in tail:
                print("  " + e.describe(), flush=True)
    return demo


def run_term_inflation_demo(schedules: int = 8, ticks: int = 60,
                            seed: int = 7, n: int = 5, prop_count: int = 2,
                            verbose: bool = True, device=None) -> dict:
    """The `term_inflation` adversary forces one victim row's election
    timer over and over: without PreVote every forced campaign bumps the
    term, with PreVote the poll is non-binding and terms stay near the
    fault-free baseline.  Safety must hold either way."""
    dev = resolve_device(device)
    out = {"schedules": schedules, "ticks": ticks, "seed": seed, "n": n}
    base = _cfg(n, seed)
    for key, pv in (("no_prevote", False), ("prevote", True)):
        cfg = dataclasses.replace(base, pre_vote=pv)
        batch, names = dst.make_batch(cfg, ticks=ticks, schedules=schedules,
                                      seed=seed, profiles=("term_inflation",),
                                      device=dev)
        res = dst.explore(init_state(cfg, device=dev), cfg, batch,
                          profiles=names, prop_count=prop_count, device=dev)
        out[key] = {
            "max_term": int(res.final_state.term.max()),
            "violations": int((res.viol != 0).sum()),
        }
    out["neutralized"] = (
        out["no_prevote"]["max_term"] >= 2 * out["prevote"]["max_term"]
        and out["no_prevote"]["violations"] == 0
        and out["prevote"]["violations"] == 0)
    if verbose:
        print(f"term_inflation x{schedules} schedules x {ticks} ticks: "
              f"max term {out['no_prevote']['max_term']} without PreVote "
              f"vs {out['prevote']['max_term']} with it "
              f"({out['no_prevote']['violations']}/"
              f"{out['prevote']['violations']} safety violations) — "
              + ("PreVote neutralizes the storm" if out["neutralized"]
                 else "NOT neutralized"), flush=True)
    return out


def _churn_demo(profile: str, cfgs: dict, schedules: int, ticks: int,
                seed: int, prop_count: int, dev) -> dict:
    """Defense-off vs defense-on sweeps of one attack profile: each side's
    most leader changes (election-histogram mass), SLO_LEADER_CHURN trips
    and violations."""
    out = {}
    for key, cfg in cfgs.items():
        batch, names = dst.make_batch(cfg, ticks=ticks, schedules=schedules,
                                      seed=seed, profiles=(profile,),
                                      device=dev)
        res = dst.explore(init_state(cfg, device=dev), cfg, batch,
                          profiles=names, prop_count=prop_count, device=dev)
        wins = res.final_state.tel_elect_hist.sum(1).cpu().numpy()
        out[key] = {
            "max_leader_changes": int(wins.max()),
            "churn_violations":
                int(((res.viol & dst.SLO_LEADER_CHURN) != 0).sum()),
            "violations": int((res.viol != 0).sum()),
        }
    out["neutralized"] = (out["defense_off"]["churn_violations"] > 0
                          and out["defense_on"]["violations"] == 0)
    return out


def run_disruptive_rejoin_demo(schedules: int = 8, ticks: int = 120,
                               seed: int = 7, n: int = 5,
                               prop_count: int = 2, verbose: bool = True,
                               device=None) -> dict:
    """The `disruptive_rejoin` adversary heals a partitioned victim that
    campaigns every other timeout: without PreVote + CheckQuorum each
    barrage deposes the leader (SLO_LEADER_CHURN trips), with them the
    cluster keeps its leader."""
    dev = resolve_device(device)
    base = dataclasses.replace(_cfg(n, seed, reads=0),
                               collect_telemetry=True, slo_leader_changes=2)
    out = {"schedules": schedules, "ticks": ticks, "seed": seed, "n": n}
    out.update(_churn_demo(
        "disruptive_rejoin",
        {"defense_off": dataclasses.replace(base, pre_vote=False,
                                            check_quorum=False),
         "defense_on": dataclasses.replace(base, pre_vote=True,
                                           check_quorum=True)},
        schedules, ticks, seed, prop_count, dev))
    if verbose:
        print(f"disruptive_rejoin x{schedules} schedules x {ticks} ticks: "
              f"{out['defense_off']['max_leader_changes']} leader changes "
              f"without PreVote+CheckQuorum "
              f"({out['defense_off']['churn_violations']} SLO_LEADER_CHURN "
              f"trips) vs {out['defense_on']['max_leader_changes']} with "
              f"them ({out['defense_on']['violations']} violations) — "
              + ("defenses neutralize the rejoin storm"
                 if out["neutralized"] else "NOT neutralized"), flush=True)
    return out


def run_transfer_abuse_demo(schedules: int = 8, ticks: int = 120,
                            seed: int = 7, n: int = 5, prop_count: int = 2,
                            cooldown: int = 60, verbose: bool = True,
                            device=None) -> dict:
    """The `transfer_abuse` adversary keeps requesting transfers toward
    alternating targets: without a cooldown leadership ping-pongs (
    SLO_LEADER_CHURN trips), with `transfer_cooldown_ticks` churn stays
    near the initial election."""
    dev = resolve_device(device)
    base = dataclasses.replace(_cfg(n, seed, reads=0),
                               collect_telemetry=True, slo_leader_changes=8)
    out = {"schedules": schedules, "ticks": ticks, "seed": seed, "n": n,
           "cooldown": cooldown}
    out.update(_churn_demo(
        "transfer_abuse",
        {"defense_off": dataclasses.replace(base, transfer_cooldown_ticks=0),
         "defense_on": dataclasses.replace(
             base, transfer_cooldown_ticks=cooldown)},
        schedules, ticks, seed, prop_count, dev))
    if verbose:
        print(f"transfer_abuse x{schedules} schedules x {ticks} ticks: "
              f"{out['defense_off']['max_leader_changes']} leader changes "
              f"without a transfer cooldown "
              f"({out['defense_off']['churn_violations']} SLO_LEADER_CHURN "
              f"trips) vs {out['defense_on']['max_leader_changes']} with "
              f"cooldown={cooldown} ({out['defense_on']['violations']} "
              f"violations) — "
              + ("cooldown neutralizes the thrash" if out["neutralized"]
                 else "NOT neutralized"), flush=True)
    return out


def run_lost_tail_demo(schedules: int = 8, ticks: int = 120, seed: int = 7,
                       n: int = 5, prop_count: int = 2, out_path=None,
                       verbose: bool = True, device=None) -> dict:
    """The `lost_tail` storage fault crashes every row on one tick and
    truncates each log to its fsynced watermark.  Without ack gating the
    cluster can commit entries no surviving copy holds (DURABILITY trips
    at the crash tick); with ``ack_gating`` the same schedules come back
    clean.  The first counterexample is shrunk and dumped as a
    replay-exact artifact, whose replay holds the host oracle in lockstep
    over the clean prefix (the crash tick is the violation tick)."""
    dev = resolve_device(device)
    out = {"schedules": schedules, "ticks": ticks, "seed": seed, "n": n}
    off = dataclasses.replace(_cfg(n, seed, reads=0), fsync_lag_ticks=6)
    on = dataclasses.replace(off, ack_gating=True)
    batch, names = dst.make_batch(off, ticks=ticks, schedules=schedules,
                                  seed=seed, profiles=("lost_tail",),
                                  device=dev)
    r_off = dst.explore(init_state(off, device=dev), off, batch,
                        profiles=names, prop_count=prop_count, device=dev)
    caught = [int(s) for s in r_off.violating
              if int(r_off.viol[s]) & dst.DURABILITY]
    out["caught"] = len(caught)
    r_on = dst.explore(init_state(on, device=dev), on, batch,
                       profiles=names, prop_count=prop_count, device=dev)
    out["gated_violations"] = int((r_on.viol != 0).sum())
    if not caught:
        out["neutralized"] = False
        if verbose:
            print(f"lost_tail NOT caught with gating off "
                  f"({schedules}x{ticks}, seed {seed})", flush=True)
        return out

    s = caught[0]
    sched = batch.slice(s)
    before = dst.fault_count(sched)
    small, evals = dst.shrink(off, sched, dst.DURABILITY, prop_count,
                              device=dev)
    v2, f2 = dst.replay(off, small, prop_count, device=dev)
    flight = dst.capture_flight(off, small, prop_count, first_tick=f2,
                                device=dev)
    art = dst.to_artifact(off, small, seed=seed, profile=names[s], index=s,
                          prop_count=prop_count, mutation=None,
                          viol=v2, first_tick=f2, flight=flight)
    out_path = artifact_path(out_path, "dst_repro_lost_tail.json")
    dst.save_artifact(out_path, art)
    verdict = dst.replay_artifact(out_path, device=dev)
    out.update({
        "bits": dst.bits_to_names(v2),
        "first_tick": f2,
        "fault_count_before": before,
        "fault_count_after": dst.fault_count(small),
        "shrink_evals": evals,
        "artifact": out_path,
        "replay_matches": verdict["matches_recorded"],
        "oracle_diverged_at": verdict["oracle"]["diverged_at"],
    })
    out["neutralized"] = (out["gated_violations"] == 0
                          and out["replay_matches"]
                          and out["oracle_diverged_at"] == -1)
    if verbose:
        print(f"lost_tail x{schedules} schedules x {ticks} ticks: "
              f"gating-off caught {out['caught']} DURABILITY trips "
              f"(first at tick {f2}), shrunk {before} -> "
              f"{out['fault_count_after']} fault-events in {evals} replays",
              flush=True)
        replayed = "reproduces exactly" if out["replay_matches"] \
            else "DIVERGED"
        verdict = "ack-gating makes committed mean durable" \
            if out["neutralized"] else "NOT neutralized"
        lock = "lockstep over the clean prefix" \
            if out["oracle_diverged_at"] == -1 \
            else f"diverged at tick {out['oracle_diverged_at']}"
        print(f"repro artifact: {out_path} — replay {replayed}, oracle "
              f"{lock}, gating-on {out['gated_violations']} violations — "
              f"{verdict}", flush=True)
    return out


def replay_artifact_file(path: str, verbose: bool = True,
                         device=None) -> dict:
    verdict = dst.replay_artifact(path, device=resolve_device(device))
    if verbose:
        print(f"replayed {path}: {verdict['violations']} at tick "
              f"{verdict['first_tick']} — "
              + ("matches recorded run" if verdict["matches_recorded"]
                 else "MISMATCH"), flush=True)
        tr = verdict["oracle"]
        if tr["trace"]:
            print(f"oracle divergence at tick {tr['diverged_at']}: "
                  f"fields {tr['trace'][0]['fields']}", flush=True)
        else:
            print("differential oracle agrees with the tick on every "
                  "compared tick", flush=True)
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    add_common_args(ap)
    ap.add_argument("--schedules", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--n", type=int, default=5, help="cluster rows")
    ap.add_argument("--profiles", default=",".join(dst.PROFILES),
                    help=f"comma list from "
                    f"{dst.PROFILES + dst.EXTRA_PROFILES}")
    ap.add_argument("--reads", type=int, default=2,
                    help="per-row linearizable read batch size; arms the "
                    "LINEARIZABLE_READ checker (0 = read-free kernel)")
    ap.add_argument("--peer-chunk", type=int, default=None,
                    help="peer-axis lowering: 0 = dense; a divisor of --n "
                    "(multiple of 8) = banded counts; default = "
                    "SimConfig default")
    add_active_rows_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    ap.add_argument("--mutate", default=None,
                    help="run ONLY a mutation sweep with this broken-kernel "
                    "knob (e.g. commit_no_quorum) instead of stock+demo")
    ap.add_argument("--no-mutation-demo", action="store_true",
                    help="skip the detection self-test after the sweep")
    add_demo_arg(ap, "term-inflation",
                 "run ONLY the seed-pinned PreVote-neutralizes-term-"
                 "inflation scenario and exit")
    add_demo_arg(ap, "disruptive-rejoin",
                 "run ONLY the seed-pinned PreVote+CheckQuorum-neutralize-"
                 "rejoin-storm scenario and exit")
    add_demo_arg(ap, "transfer-abuse",
                 "run ONLY the seed-pinned cooldown-neutralizes-transfer-"
                 "thrash scenario and exit")
    add_demo_arg(ap, "lost-tail",
                 "run ONLY the seed-pinned ack-gating-makes-committed-"
                 "durable scenario (correlated power-loss tail truncation) "
                 "and exit")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prop_count = 2 if args.prop_count is None else args.prop_count

    if args.replay:
        return 0 if replay_artifact_file(args.replay, device=dev)[
            "matches_recorded"] else 1

    demo_seed = args.seed if args.seed else 7
    if args.term_inflation_demo:
        demo = run_term_inflation_demo(
            min(args.schedules, 8), min(args.ticks, 60), demo_seed, args.n,
            prop_count, device=dev)
        return 0 if demo["neutralized"] else 1
    # the attack demos pin their tick counts: the churn bounds they assert
    # against are calibrated to the 120-tick window
    if args.disruptive_rejoin_demo:
        demo = run_disruptive_rejoin_demo(
            min(args.schedules, 8), seed=demo_seed, n=args.n,
            prop_count=prop_count, device=dev)
        return 0 if demo["neutralized"] else 1
    if args.transfer_abuse_demo:
        demo = run_transfer_abuse_demo(
            min(args.schedules, 8), seed=demo_seed, n=args.n,
            prop_count=prop_count, device=dev)
        return 0 if demo["neutralized"] else 1
    if args.lost_tail_demo:
        demo = run_lost_tail_demo(
            min(args.schedules, 8), seed=demo_seed, n=args.n,
            prop_count=prop_count, out_path=args.out, device=dev)
        return 0 if demo["neutralized"] else 1

    profiles = tuple(p for p in args.profiles.split(",") if p)
    for p in profiles:
        if p not in dst.PROFILES + dst.EXTRA_PROFILES:
            ap.error(f"unknown profile {p!r}")

    if args.mutate:
        demo = run_mutation_demo(args.schedules, args.ticks, args.seed,
                                 args.n, prop_count, args.mutate,
                                 out_path=args.out,
                                 peer_chunk=args.peer_chunk,
                                 active_rows=args.active_rows, device=dev)
        return 0 if demo["caught"] and demo.get("replay_matches") else 1

    sweep = run_sweep(args.schedules, args.ticks, args.seed, args.n,
                      prop_count, profiles, reads=args.reads,
                      peer_chunk=args.peer_chunk,
                      active_rows=args.active_rows, device=dev)
    ok = sweep["violations"] == 0
    if not ok:
        res, names = sweep["_result"], sweep["_names"]
        for s in res.violating[:8]:
            print(f"  VIOLATION schedule {s} ({names[s]}): "
                  f"{dst.bits_to_names(int(res.viol[s]))} "
                  f"at tick {int(res.first_tick[s])}", flush=True)

    if not args.no_mutation_demo:
        for mutation in (DEFAULT_MUTATION, "stale_lease_read"):
            demo = run_mutation_demo(
                min(args.schedules, 24), args.ticks, args.seed, args.n,
                prop_count, mutation,
                out_path=args.out if mutation == DEFAULT_MUTATION else None,
                peer_chunk=args.peer_chunk, active_rows=args.active_rows,
                device=dev)
            ok = ok and demo["caught"] and demo.get("replay_matches", False)

    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
