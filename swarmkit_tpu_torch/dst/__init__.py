"""Deterministic simulation testing (DST) for the batched raft tick
(PyTorch port of the JAX package's dst/).

FoundationDB-style schedule search on the card: the tick already advances
N simulated managers as rows of device tensors, and the batch-native tick
advances S clusters at once on a leading [S] axis, each under its own
adversarial fault schedule, with raft's safety properties checked on the
device every tick.

Layout:

- :mod:`schedule`  — `FaultSchedule` (stacked per-tick drop/partition
  matrices, crash windows, adversary gates and verb leaves), the nine
  pre-step verbs and the seeded generator of the 16 named profiles (its
  own torch.Generator stream per (seed, index): JAX's laws, not its
  draws).
- :mod:`invariants` — the on-device checkers, reduced into a per-cluster
  violation bitmask.
- :mod:`explore`   — `explore()`: the host loop over T of the [S] tick.
- :mod:`repro`     — replay, speculatively batched greedy shrinking, the
  field-level differential trace against the host golden core
  (`oracle_trace`) and JSON repro artifacts in the JAX package's format.
"""

from swarmkit_tpu_torch.dst.schedule import (
    ATTACK_LEAVES, ATTACK_PROFILES, ATTACK_SIGNATURE_CODES, EXTRA_PROFILES,
    PROFILES, STORAGE_LEAVES, STORAGE_PROFILES, STORAGE_SIGNATURE_CODES,
    FaultSchedule, apply_append_flood, apply_disk_stall, apply_lost_tail,
    apply_rejoin_campaign, apply_snap_corrupt, apply_term_inflation,
    apply_torn_write, apply_transfer_abuse, apply_vote_equivocation,
    from_fault_plan, make_batch, make_schedule,
)
from swarmkit_tpu_torch.dst.invariants import (
    BIT_NAMES, CHECKSUM_AGREEMENT, COMMIT_MONOTONIC, DURABILITY,
    ELECTION_SAFETY, LEADER_COMPLETENESS, LINEARIZABLE_READ, LOG_MATCHING,
    RECOVERY_MONOTONIC, SAFETY_BITS, SLO_COMMIT_P99, SLO_FSYNC_LAG,
    SLO_LEADER_CHURN, SLO_LOG_OCCUPANCY,
    bits_to_names, check_state, check_transition,
)
from swarmkit_tpu_torch.dst.explore import ExploreResult, explore, postmortem
from swarmkit_tpu_torch.dst.repro import (
    capture_flight, fault_count, from_artifact, load_artifact, oracle_trace,
    replay, replay_artifact, save_artifact, shrink, to_artifact,
)

__all__ = [
    "ATTACK_LEAVES", "ATTACK_PROFILES", "ATTACK_SIGNATURE_CODES",
    "EXTRA_PROFILES", "PROFILES", "STORAGE_LEAVES", "STORAGE_PROFILES",
    "STORAGE_SIGNATURE_CODES", "FaultSchedule", "apply_append_flood",
    "apply_disk_stall", "apply_lost_tail", "apply_rejoin_campaign",
    "apply_snap_corrupt", "apply_term_inflation", "apply_torn_write",
    "apply_transfer_abuse", "apply_vote_equivocation", "from_fault_plan",
    "make_batch", "make_schedule",
    "BIT_NAMES", "CHECKSUM_AGREEMENT", "COMMIT_MONOTONIC", "DURABILITY",
    "ELECTION_SAFETY", "LEADER_COMPLETENESS", "LINEARIZABLE_READ",
    "LOG_MATCHING", "RECOVERY_MONOTONIC", "SAFETY_BITS", "SLO_COMMIT_P99",
    "SLO_FSYNC_LAG", "SLO_LEADER_CHURN", "SLO_LOG_OCCUPANCY",
    "bits_to_names", "check_state", "check_transition",
    "ExploreResult", "explore", "postmortem",
    "capture_flight", "fault_count", "from_artifact", "load_artifact",
    "oracle_trace", "replay", "replay_artifact", "save_artifact", "shrink",
    "to_artifact",
]
