"""The counted branch space: action alphabet, codecs, scope presets
(PyTorch port of the JAX package's mc/space.py).

One model-checking step is "pick action a from a fixed alphabet, apply it
for one tick".  An action is a full per-tick fault assignment drawn from
the `FaultSchedule` vocabulary — crash one row, drop one directed edge,
cut one bipartition, force one row's election timer (term_inflation), or
do nothing — so a branch of depth H is an integer in [0, A^H) read as H
base-A digits, and the entire schedule space at a scope is COUNTED:
exhaustion is a loop bound, not a sampling budget.

The single-fault-per-tick alphabet is the scope's documented coverage
choice (compound faults arise as sequences across ticks: a 3-tick
partition is the same cut chosen 3 times; crash-then-restart is crash_i
followed by any non-crash_i action).  What it deliberately excludes is
SIMULTANEOUS distinct faults within one tick — the standard small-scope
trade (the mCRL2/LNT models' schedules are one-event-per-transition for
the same reason), stated in README "Exhaustive model checking".
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.dst.schedule import FaultSchedule
from swarmkit_tpu_torch.raft.sim.state import SimConfig


@dataclass(frozen=True)
class Alphabet:
    """The per-tick action tables: action k applies row k of each table.

    names    (A,) action labels ("noop", "crash_1", "drop_0to2",
             "part_0v12", "inflate_2") — also the LTS edge labels.
    alive    [A, n] bool  row liveness under the action
    drop     [A, n, n] bool  directed-edge drops under the action
    inflate  [A, n] bool or None  forced-campaign mask (None when the
             scope excludes term_inflation, keeping the compiled tick
             bit-identical to the pre-extension program)
    """

    n: int
    names: tuple
    alive: np.ndarray
    drop: np.ndarray
    inflate: Optional[np.ndarray]

    @property
    def size(self) -> int:
        return len(self.names)

    def tables(self, device=None):
        """Copies on `device` (the CUDA card unless the caller names
        another) for the expand pass."""
        dev = resolve_device(device)
        inflate = None if self.inflate is None \
            else torch.from_numpy(self.inflate).to(dev)
        return (torch.from_numpy(self.alive).to(dev),
                torch.from_numpy(self.drop).to(dev), inflate)


def build_alphabet(n: int, *, crashes: bool = True, drops: bool = True,
                   partitions: bool = True,
                   term_inflation: bool = False) -> Alphabet:
    """The full single-fault alphabet for an n-row cluster.

    noop + n crashes + n(n-1) directed drops + (2^(n-1) - 1) bipartitions
    (+ n term inflations): 13 actions at n=3, 24 at n=4, 41 at n=5.
    """
    names = ["noop"]
    alive = [np.ones(n, bool)]
    drop = [np.zeros((n, n), bool)]
    inflate = [np.zeros(n, bool)]
    if crashes:
        for i in range(n):
            a = np.ones(n, bool)
            a[i] = False
            names.append(f"crash_{i}")
            alive.append(a)
            drop.append(np.zeros((n, n), bool))
            inflate.append(np.zeros(n, bool))
    if drops:
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                d = np.zeros((n, n), bool)
                d[i, j] = True
                names.append(f"drop_{i}to{j}")
                alive.append(np.ones(n, bool))
                drop.append(d)
                inflate.append(np.zeros(n, bool))
    if partitions:
        # every bipartition once: enumerate the side NOT containing row 0
        for mask in range(1, 1 << n):
            if mask & 1:
                continue
            side_b = [i for i in range(n) if mask >> i & 1]
            side_a = [i for i in range(n) if not mask >> i & 1]
            d = np.zeros((n, n), bool)
            for i in side_a:
                for j in side_b:
                    d[i, j] = d[j, i] = True
            names.append(f"part_{''.join(map(str, side_a))}"
                         f"v{''.join(map(str, side_b))}")
            alive.append(np.ones(n, bool))
            drop.append(d)
            inflate.append(np.zeros(n, bool))
    if term_inflation:
        for i in range(n):
            m = np.zeros(n, bool)
            m[i] = True
            names.append(f"inflate_{i}")
            alive.append(np.ones(n, bool))
            drop.append(np.zeros((n, n), bool))
            inflate.append(m)
    return Alphabet(
        n=n, names=tuple(names),
        alive=np.stack(alive), drop=np.stack(drop),
        inflate=np.stack(inflate) if term_inflation else None)


def branch_to_path(branch: int, size: int, depth: int) -> list:
    """Base-`size` digits of `branch`, tick 0 first (little-endian)."""
    if not 0 <= branch < size ** depth:
        raise ValueError(f"branch {branch} outside [0, {size}^{depth})")
    path = []
    for _ in range(depth):
        path.append(branch % size)
        branch //= size
    return path


def path_to_branch(path, size: int) -> int:
    """Inverse of `branch_to_path` (python int — A^H overflows i64 fast)."""
    branch = 0
    for a in reversed(list(path)):
        if not 0 <= a < size:
            raise ValueError(f"action {a} outside alphabet of {size}")
        branch = branch * size + a
    return branch


def path_to_schedule(alphabet: Alphabet, path,
                     device=None) -> FaultSchedule:
    """Lower an action path to a replayable single FaultSchedule [T, ...]
    on `device` (the CUDA card unless the caller names another).

    The lowered schedule drives `dst.repro.replay` through the same
    `_tick_one` program the scan's expand pass runs, so a violating
    branch reproduces bit-identically — and flows through the standard
    shrink / flight-capture / artifact pipeline unchanged.
    """
    path = list(path)
    ticks = len(path)
    drop = np.stack([alphabet.drop[a] for a in path]) if ticks else \
        np.zeros((0, alphabet.n, alphabet.n), bool)
    alive = np.stack([alphabet.alive[a] for a in path]) if ticks else \
        np.ones((0, alphabet.n), bool)
    arrs = {"drop": drop, "alive": alive,
            "target_leader": np.zeros((ticks,), bool),
            "crash_campaign": np.zeros((ticks,), bool)}
    if alphabet.inflate is not None:
        arrs["term_inflate"] = (
            np.stack([alphabet.inflate[a] for a in path]) if ticks
            else np.zeros((0, alphabet.n), bool))
    return FaultSchedule.from_numpy(arrs, device=resolve_device(device))


# ---------------------------------------------------------------------------
# documented scope presets (PERF.md carries the measured branches/s and
# frontier-memory table per scope)


@dataclass(frozen=True)
class Scope:
    """One documented model-checking scope.

    `budget` is the default frontier cap (None = exhaustive); scopes whose
    raw frontier outgrows one host are shipped budget-bounded and their
    summaries say so (`exhaustive: false`, truncation counts per level).
    """

    name: str
    n: int
    horizon: int
    term_inflation: bool = False
    budget: Optional[int] = None
    prop_count: int = 1

    def alphabet(self) -> Alphabet:
        return build_alphabet(self.n, term_inflation=self.term_inflation)

    def cfg(self) -> SimConfig:
        # Small-scope tick config: election_tick=2 keeps randomized
        # timeouts in [2, 4), so elections, commits and re-elections all
        # fit inside an 8-tick horizon; the read path is armed
        # (read_batch=1) so LINEARIZABLE_READ is checked and the
        # stale_lease_read mutation self-test has a surface.  The log
        # ring is the smallest legal shape for 1 proposal/tick
        # (log_len > keep + 2*max_props + window).
        return SimConfig(n=self.n, log_len=32, window=4, apply_batch=4,
                         max_props=4, keep=2, election_tick=2,
                         read_batch=1)

    def space_size(self) -> int:
        return self.alphabet().size ** self.horizon


SCOPES = {
    # tier-1 smoke: seconds on one CPU core; also the .aut export scope
    "smoke": Scope(name="smoke", n=3, horizon=4),
    # the headline exhaustive claim: full crash/partition/drop alphabet,
    # 13^8 =~ 8.2e8 schedules collapsing to ~3.5M explored branches over
    # ~1.3M distinct reachable states; ~2 min on one CPU core
    "n3h8": Scope(name="n3h8", n=3, horizon=8),
    # widened branch alphabet (+ term_inflation, A=16); same horizon
    "n3h8t": Scope(name="n3h8t", n=3, horizon=8, term_inflation=True),
    # deeper horizon, budget-bounded (the level-9+ frontier outgrows the
    # exhaustive claim; truncation is logged per level)
    "n3h12": Scope(name="n3h12", n=3, horizon=12, budget=1 << 20),
    # wider cluster, budget-bounded (A=24)
    "n4h8": Scope(name="n4h8", n=4, horizon=8, budget=1 << 20),
}
