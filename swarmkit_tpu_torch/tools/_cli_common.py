"""The CLI plumbing the port's sweep tools share: the JAX package's
tools/_cli_common.py (the determinism pin, artifact routing, the demo
flags and the role-sparse lowering knob)."""

from __future__ import annotations

import argparse
import os
import tempfile


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
    """The role-sparse progress lowering knob the sweeps share
    (SimConfig.active_rows)."""
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
