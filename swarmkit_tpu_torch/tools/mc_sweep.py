"""Exhaustive model-checking sweep on the port (swarmkit_tpu_torch/mc/):
the JAX package's tools/mc_sweep.py, with the same flags and JSON summary,
on the batched tick.  It runs on the CUDA card and raises without one,
unless --device cpu.

Where ``dst_sweep.py`` SAMPLES fault schedules, this tool ENUMERATES
them: every per-tick fault action from the scope's counted alphabet,
every sequence to the horizon, deduplicating reached states by
fingerprint between levels — and checks all armed raft invariants on
every reached state.  Three jobs, all deterministic (the scan has no
seed at all; ``--seed`` only stamps artifacts):

1. **Scan** (default): exhaustively enumerate a documented scope preset
   against the stock kernel.  Must report ZERO violations, and the JSON
   summary must show the scope's full schedule space covered
   (``exhaustive: true``) with millions of branches per big device pass.

2. **Mutation self-test** (after the scan unless suppressed): re-scan a
   smaller horizon against a deliberately broken kernel knob
   (``commit_no_quorum``, ``stale_lease_read``), assert the enumeration
   CATCHES it, lower the first violating branch to a FaultSchedule,
   shrink it, dump a seed-pinned artifact with a flight-recorder
   post-mortem, and replay the artifact — bits and first tick must
   reproduce exactly (``dst_sweep.py --replay`` works on these too).

3. **Budget-bounded scan** (``--budget`` or the preset's own): cap the
   per-level frontier; truncation is LOGGED per level and the summary
   flips to ``exhaustive: false`` — the tool never silently narrows an
   exhaustiveness claim.

Usage:
    python -m swarmkit_tpu_torch.tools.mc_sweep          # n3h8 + self-tests
    python -m swarmkit_tpu_torch.tools.mc_sweep --smoke --device cpu
    python -m swarmkit_tpu_torch.tools.mc_sweep --scope n3h12 --budget 1048576
    python -m swarmkit_tpu_torch.tools.mc_sweep --mutate commit_no_quorum
    python -m swarmkit_tpu_torch.tools.mc_sweep --json summary.json
"""

from __future__ import annotations

import argparse
import json

from swarmkit_tpu_torch import mc
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.dst import repro
from swarmkit_tpu_torch.tools._cli_common import add_common_args, artifact_path

MUTATIONS = ("commit_no_quorum", "stale_lease_read")


def run_scan(scope_name: str = "n3h8", budget=None, mutation=None,
             symmetry: bool = False, verbose: bool = True,
             collect_edges: bool = False, device=None) -> mc.ScanResult:
    """One exhaustive_scan over a documented preset (importable)."""
    scope = mc.SCOPES[scope_name]
    budget = scope.budget if budget is None else (budget or None)
    res = mc.exhaustive_scan(
        scope.cfg(), scope.alphabet(), scope.horizon,
        prop_count=scope.prop_count, mutation=mutation, budget=budget,
        symmetry=symmetry, collect_edges=collect_edges, scope=scope_name,
        log=print if verbose else None, device=resolve_device(device))
    if verbose:
        tag = f" [mutation={mutation}]" if mutation else ""
        print(f"scope {scope_name}{tag}: {res.branches_explored:,} branches "
              f"over {res.states_discovered:,} states in "
              f"{res.elapsed:.1f}s ({res.branches_per_sec:,.0f} branches/s, "
              f"max {res.max_branches_per_pass:,}/pass) — "
              f"{len(res.violations)} violation(s), "
              f"exhaustive={res.exhaustive}", flush=True)
    return res


def run_self_test(scope_name: str, mutation: str, out_path=None,
                  verbose: bool = True, device=None) -> dict:
    """Detect -> lower -> shrink -> dump -> replay one mutation repro."""
    dev = resolve_device(device)
    scope = mc.SCOPES[scope_name]
    res = run_scan(scope_name, mutation=mutation, verbose=False, device=dev)
    demo = {"mutation": mutation, "scope": scope_name,
            "caught": bool(res.violations),
            "branches_explored": res.branches_explored}
    if not demo["caught"]:
        if verbose:
            print(f"mutation {mutation!r} NOT caught by exhaustive scan "
                  f"at scope {scope_name}", flush=True)
        return demo

    v = res.violations[0]
    art = mc.violation_artifact(scope.cfg(), scope.alphabet(), v,
                                prop_count=scope.prop_count,
                                mutation=mutation, scope=scope_name,
                                device=dev)
    out_path = artifact_path(
        out_path, f"mc_repro_{scope_name}_{mutation}.json")
    repro.save_artifact(out_path, art)
    verdict = repro.replay_artifact(out_path, with_trace=False, device=dev)
    demo.update({
        "level": v["level"], "path": v["path"],
        "actions": art["mc"]["actions"],
        "bits": v["invariants"],
        "artifact": out_path,
        "replay_matches": verdict["matches_recorded"],
    })
    if verbose:
        print(f"mutation {mutation!r} caught at level {v['level']} "
              f"({v['invariants']}) after {res.branches_explored:,} "
              f"branches; minimal branch: {art['mc']['actions']}",
              flush=True)
        print(f"repro artifact: {out_path} — replay "
              f"{'reproduces exactly' if demo['replay_matches'] else 'DIVERGED'}",
              flush=True)
    return demo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    add_common_args(ap)
    ap.add_argument("--scope", default="n3h8", choices=sorted(mc.SCOPES),
                    help="documented scope preset (default: n3h8, the "
                    "headline exhaustive claim)")
    ap.add_argument("--smoke", action="store_true",
                    help="shorthand for --scope smoke with smoke-sized "
                    "self-tests (tier-1 wall)")
    ap.add_argument("--budget", type=int, default=None,
                    help="per-level frontier cap (0 = force unbounded); "
                    "truncation is logged and flips exhaustive=false")
    ap.add_argument("--symmetry", action="store_true",
                    help="opt-in node-relabeling dedup (heuristic: NOT "
                    "part of the exhaustive claim, see mc/fingerprint.py)")
    ap.add_argument("--mutate", default=None, choices=MUTATIONS,
                    help="run ONLY the mutation self-test for this "
                    "broken-kernel knob")
    ap.add_argument("--no-mutation-demo", action="store_true",
                    help="skip the detection self-tests after the scan")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the scan's JSON summary here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.replay:
        verdict = repro.replay_artifact(args.replay, with_trace=False,
                                        device=dev)
        print(f"replayed {args.replay}: {verdict['violations']} at tick "
              f"{verdict['first_tick']} — "
              f"{'matches recorded run' if verdict['matches_recorded'] else 'MISMATCH'}",
              flush=True)
        return 0 if verdict["matches_recorded"] else 1

    scope_name = "smoke" if args.smoke else args.scope
    # mutation self-tests need horizon >= 8 at n=3 (stale_lease_read's
    # shortest counterexample is 5 ticks past a commit); any other scope
    # delegates to the documented catch scope n3h8
    sc = mc.SCOPES[scope_name]
    test_scope = scope_name if sc.n == 3 and sc.horizon >= 8 else "n3h8"

    if args.mutate:
        demo = run_self_test(test_scope, args.mutate, out_path=args.out,
                             device=dev)
        return 0 if demo["caught"] and demo.get("replay_matches") else 1

    res = run_scan(scope_name, budget=args.budget, symmetry=args.symmetry,
                   device=dev)
    ok = not res.violations
    for v in res.violations:
        print(f"  VIOLATION at level {v['level']}: {v['invariants']} via "
              f"{[mc.SCOPES[scope_name].alphabet().names[a] for a in v['path']]}",
              flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(res.summary(), f, indent=2)
        print(f"summary: {args.json}", flush=True)

    if not args.no_mutation_demo and not args.smoke:
        for mutation in MUTATIONS:
            demo = run_self_test(test_scope, mutation, out_path=args.out,
                                 device=dev)
            ok = ok and demo["caught"] and demo.get("replay_matches", False)

    print("PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
