"""Export the model checker's reached LTS as an Aldebaran ``.aut`` file
(the port's form of the JAX package's tools/mc_export.py: the same writer,
the same validator, the same bytes for the same scan).  The scan runs on
the CUDA card unless --device cpu.

The formal-model cross-validation bridge: the mCRL2/LNT Raft models
(PAPERS.md arXiv:2403.18916, arXiv:2004.13284) verify a hand-written
abstraction with explicit-state tools whose common interchange format is
Aldebaran —

    des (<initial>, <transitions>, <states>)
    (<src>, "<action label>", <dst>)
    ...

This tool runs ``mc.exhaustive_scan(collect_edges=True)`` on a smoke-
sized scope against the REAL tick kernel and emits the reached labeled
transition system in that format, so the kernel-derived behavior can be
loaded into the same toolchains (ltsconvert / ltscompare / CADP) that
checked the paper models — e.g. to minimize modulo branching
bisimulation or diff against an abstraction.  Labels are the scan's
action alphabet ("noop", "crash_1", "part_0v12", ...).

``--check`` validates the emitted file with the dependency-free
structural validator below (no mCRL2/CADP in this container): header
arity, transition count, id ranges, label quoting, determinism of the
(src, label) relation, and reachability of every state from the initial
one.

Usage:
    python -m swarmkit_tpu_torch.tools.mc_export --scope smoke \
        --out cluster.aut --check [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile

_AUT_HEADER = re.compile(r'^des\s*\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)\s*$')
_AUT_EDGE = re.compile(r'^\(\s*(\d+)\s*,\s*"([^"]*)"\s*,\s*(\d+)\s*\)\s*$')


def write_aut(path: str, edges, num_states: int, names,
              initial: int = 0) -> None:
    """Write (src, action_idx, dst) edges as an Aldebaran LTS."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"des ({initial}, {len(edges)}, {num_states})\n")
        for src, aid, dst in edges:
            f.write(f'({src}, "{names[aid]}", {dst})\n')


def validate_aut(path: str, deterministic: bool = True) -> list[str]:
    """Structural problems with an ``.aut`` file (empty = valid).

    Checks: one well-formed ``des`` header; exactly the declared number
    of well-formed transition lines; every state id in range; the
    initial state in range; every state reachable from the initial one
    (the scan emits the REACHED LTS, so an orphan means an exporter
    bug); and — for the kernel's deterministic tick — at most one
    successor per (src, label) pair.
    """
    problems: list[str] = []
    try:
        with open(path, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    except OSError as e:
        return [f"unreadable: {e}"]
    if not lines:
        return ["empty file"]
    m = _AUT_HEADER.match(lines[0])
    if not m:
        return [f"bad header {lines[0]!r} (want 'des (i, t, s)')"]
    initial, ntrans, nstates = (int(g) for g in m.groups())
    if initial >= nstates:
        problems.append(f"initial state {initial} >= state count {nstates}")
    if len(lines) - 1 != ntrans:
        problems.append(f"header declares {ntrans} transitions, file has "
                        f"{len(lines) - 1}")
    succ: dict[tuple, int] = {}
    adj: dict[int, list] = {}
    for i, ln in enumerate(lines[1:], start=2):
        e = _AUT_EDGE.match(ln)
        if not e:
            problems.append(f"line {i}: bad transition {ln!r}")
            continue
        src, label, dst = int(e.group(1)), e.group(2), int(e.group(3))
        if src >= nstates or dst >= nstates:
            problems.append(f"line {i}: state id out of range "
                            f"({src}, {dst}) >= {nstates}")
            continue
        if deterministic:
            prev = succ.setdefault((src, label), dst)
            if prev != dst:
                problems.append(f"line {i}: ({src}, {label!r}) maps to both "
                                f"{prev} and {dst} (kernel tick must be "
                                "deterministic)")
        adj.setdefault(src, []).append(dst)
    if not problems:
        seen = {initial}
        stack = [initial]
        while stack:
            for dst in adj.get(stack.pop(), ()):
                if dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        if len(seen) != nstates:
            problems.append(f"only {len(seen)} of {nstates} states "
                            "reachable from the initial state")
    return problems


def export_scope(scope_name: str, out_path: str, mutation=None,
                 verbose: bool = True, device=None):
    """Scan a scope with edge collection on and write its ``.aut``."""
    from swarmkit_tpu_torch import mc
    from swarmkit_tpu_torch.device import resolve_device

    scope = mc.SCOPES[scope_name]
    res = mc.exhaustive_scan(
        scope.cfg(), scope.alphabet(), scope.horizon,
        prop_count=scope.prop_count, mutation=mutation,
        budget=scope.budget, collect_edges=True, scope=scope_name,
        stop_on_violation=False,
        log=print if verbose else None, device=resolve_device(device))
    write_aut(out_path, res.edges, res.num_states, scope.alphabet().names)
    if verbose:
        print(f"wrote {out_path}: {res.num_states:,} states, "
              f"{len(res.edges):,} transitions "
              f"({len(scope.alphabet().names)} labels, horizon "
              f"{scope.horizon})", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--scope", default="smoke",
                    help="scope preset to export (default smoke: edge "
                    "collection walks every child on the host, keep it "
                    "small)")
    ap.add_argument("--out", default=None,
                    help=".aut destination (default: temp dir)")
    ap.add_argument("--mutate", default=None,
                    help="export the LTS of a mutated kernel instead "
                    "(violating states become deadlocks: their branches "
                    "are pruned)")
    ap.add_argument("--check", action="store_true",
                    help="validate the emitted file and exit nonzero on "
                    "any structural problem")
    ap.add_argument("--validate", default=None, metavar="AUT",
                    help="only validate an existing .aut file and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    args = ap.parse_args(argv)

    if args.validate:
        problems = validate_aut(args.validate)
        for p in problems:
            print(f"AUT: {p}", flush=True)
        print(f"{len(problems)} problem(s) in {args.validate}", flush=True)
        return 1 if problems else 0

    out = args.out or os.path.join(tempfile.gettempdir(),
                                   f"mc_{args.scope}.aut")
    export_scope(args.scope, out, mutation=args.mutate, device=args.device)
    if args.check:
        problems = validate_aut(out)
        for p in problems:
            print(f"AUT: {p}", flush=True)
        print(("PASS" if not problems else "FAIL")
              + f" — {len(problems)} problem(s)", flush=True)
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
