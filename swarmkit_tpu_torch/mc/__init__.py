"""Exhaustive on-device model checking for tiny clusters (PyTorch port of
the JAX package's mc/).

Where :mod:`swarmkit_tpu_torch.dst` SAMPLES fault schedules (256 counter-seeded
adversaries x 100 ticks), this package ENUMERATES them: every per-tick
fault action from a counted alphabet (crash / directed drop / partition /
optional term_inflation, the FaultSchedule vocabulary), every sequence up
to a small horizon — the explicit-state discipline of the mCRL2/LNT Raft
models (PAPERS.md arXiv:2403.18916, arXiv:2004.13284) run against the
REAL tick kernel instead of a hand-written abstraction, by running the
batch-native ``raft/sim/kernel.step`` over a [B, N, ...] frontier of
reachable states on the card.

Layout:

- :mod:`space`       — the action alphabet (integer -> per-tick fault
  arrays), branch/path codecs, the lowering of a violating branch to a
  replayable `FaultSchedule`, and the documented scope presets.
- :mod:`fingerprint` — Zobrist-style SimState hashing (order-salted
  hash32 fold, 64-bit), node-relabeling and the optional symmetry-
  canonical fingerprint.
- :mod:`frontier`    — `exhaustive_scan()`: the batched BFS loop
  (frontier expand -> invariant bitmask -> fingerprint dedup -> next
  level), `--budget` truncation, LTS edge collection, and the violation
  -> shrink -> artifact -> flight-recorder pipeline reusing dst/repro.
- :mod:`metrics`     — the swarm_mc_* metric-name constants, declared
  in metrics/catalog.py.

Soundness notes: the tick kernel is PURE in (state, action) — the PRNG is
counter-based and ``tick`` is part of SimState — so two states with equal
fingerprints have identical futures and exact-fingerprint dedup preserves
the full reachable set (fingerprints are 64-bit Zobrist hashes; collision
odds at the documented scopes are ~1e-6, and any collision only MERGES
states, i.e. could hide but never fabricate a violation).  The symmetry
(node-relabeling) reduction is NOT exact — ``rand_timeout`` keys on the
row index, so relabeled states draw different timeouts — and is therefore
an opt-in heuristic, off for every headline claim.
"""

from swarmkit_tpu_torch.mc.space import (
    SCOPES, Alphabet, Scope, branch_to_path, build_alphabet, path_to_branch,
    path_to_schedule,
)
from swarmkit_tpu_torch.mc.fingerprint import (
    canonical_fingerprint, fingerprint, relabel_state,
)
from swarmkit_tpu_torch.mc.frontier import (
    ScanResult, exhaustive_scan, violation_artifact,
)
from swarmkit_tpu_torch.mc.metrics import METRIC_NAMES

__all__ = [
    "SCOPES", "Alphabet", "Scope", "branch_to_path", "build_alphabet",
    "path_to_branch", "path_to_schedule",
    "canonical_fingerprint", "fingerprint", "relabel_state",
    "ScanResult", "exhaustive_scan", "violation_artifact",
    "METRIC_NAMES",
]
