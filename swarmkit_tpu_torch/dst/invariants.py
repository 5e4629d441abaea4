"""Raft safety checkers on the device, reduced to a violation bitmask
(PyTorch port of the JAX package's dst/invariants.py).

Each checker is a tensor reduction over one cluster's SimState, or over
each cluster of a batched one (leading [B] axis), with no host read: the
explore loop evaluates all of them for B x N clusters every tick.  The bits,
their names and their semantics are the JAX package's:

ELECTION_SAFETY      at most one leader per term among current leaders.
LOG_MATCHING         two logs holding the same (index, term) hold the same
                     payload there.
LEADER_COMPLETENESS  a leader at the globally-maximal term holds every
                     committed entry (last >= max commit).
COMMIT_MONOTONIC     per-row commit/applied never regress across one tick,
                     and applied never passes commit (transition check).
CHECKSUM_AGREEMENT   equal applied index => equal applied-state checksum.
LINEARIZABLE_READ    every served read batch saw the writes acknowledged
                     before its submit (read_srv_idx >= read_srv_goal);
                     only with the read path (cfg.read_batch > 0).
SLO_COMMIT_P99       optional: the p99 propose->commit latency bucket edge
                     exceeds cfg.slo_p99_commit_ticks (telemetry on).
SLO_LEADER_CHURN     optional: cumulative election wins exceed
                     cfg.slo_leader_changes (telemetry on).
SLO_LOG_OCCUPANCY    optional: some row's uncommitted tail max(last -
                     commit) exceeds cfg.slo_log_occupancy.
DURABILITY           max(ack_frontier) <= max(last): nothing ever acked as
                     committed vanished from every log (storage model on).
RECOVERY_MONOTONIC   dur_commit never falls across a tick (transition
                     check, storage model on).
SLO_FSYNC_LAG        optional: some row's unsynced suffix max(last -
                     sync_mark) exceeds cfg.slo_fsync_lag.

A mask is an int32 tensor holding the bits (0-d for one cluster, [B] for a
batch); the highest bit is 1 << 11, so the int32 value equals JAX's uint32
one.  Host code reads them back as uint32.
"""

from __future__ import annotations

import torch

from swarmkit_tpu_torch.raft.sim.run import quorum_applied_checksum
from swarmkit_tpu_torch.raft.sim.state import (
    LEADER, SimConfig, SimState, batch_size,
)
from swarmkit_tpu_torch.telemetry import series as ts

I32 = torch.int32

ELECTION_SAFETY = 1 << 0
LOG_MATCHING = 1 << 1
LEADER_COMPLETENESS = 1 << 2
COMMIT_MONOTONIC = 1 << 3
CHECKSUM_AGREEMENT = 1 << 4
LINEARIZABLE_READ = 1 << 5
SLO_COMMIT_P99 = 1 << 6
SLO_LEADER_CHURN = 1 << 7
SLO_LOG_OCCUPANCY = 1 << 8
DURABILITY = 1 << 9
RECOVERY_MONOTONIC = 1 << 10
SLO_FSYNC_LAG = 1 << 11

BIT_NAMES = {
    ELECTION_SAFETY: "election_safety",
    LOG_MATCHING: "log_matching",
    LEADER_COMPLETENESS: "leader_completeness",
    COMMIT_MONOTONIC: "commit_monotonic",
    CHECKSUM_AGREEMENT: "checksum_agreement",
    LINEARIZABLE_READ: "linearizable_read",
    SLO_COMMIT_P99: "slo_commit_p99",
    SLO_LEADER_CHURN: "slo_leader_churn",
    SLO_LOG_OCCUPANCY: "slo_log_occupancy",
    DURABILITY: "durability",
    RECOVERY_MONOTONIC: "recovery_monotonic",
    SLO_FSYNC_LAG: "slo_fsync_lag",
}
ALL_BITS = tuple(BIT_NAMES)
# Bits whose violation leaves the kernel in a state correct raft cannot
# represent; the SLO_* bits are telemetry bounds (state stays legal).
SAFETY_BITS = (ELECTION_SAFETY | LOG_MATCHING | LEADER_COMPLETENESS
               | COMMIT_MONOTONIC | CHECKSUM_AGREEMENT | LINEARIZABLE_READ
               | DURABILITY | RECOVERY_MONOTONIC)


def bits_to_names(bits: int) -> list[str]:
    return [name for bit, name in BIT_NAMES.items() if bits & bit]


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(I32)


def _as_batch(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """The checkers run on [B, ...] tensors; one cluster is B = 1."""
    return x if batched else x[None]


def _any(x: torch.Tensor) -> torch.Tensor:
    """Per cluster: any over everything but the leading axis."""
    return x.reshape(x.shape[0], -1).any(1)


def _max(x: torch.Tensor) -> torch.Tensor:
    """Per cluster: max over everything but the leading axis."""
    return x.reshape(x.shape[0], -1).amax(1)


def _live_index(snap_idx: torch.Tensor, last: torch.Tensor, L: int):
    """Per (row, slot): the live 1-based log index stored there and its
    validity.  The ring holds (snap_idx, last], so slot l of row r holds
    snap_idx[r] + 1 + ((l - snap_idx[r]) mod L) iff that is <= last[r]."""
    slot = torch.arange(L, dtype=I32, device=snap_idx.device)
    snap = snap_idx[..., None]
    idx = snap + 1 + torch.remainder(slot - snap, L)
    return idx, idx <= last[..., None]


def check_state(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Bitmask of the per-tick (non-transition) invariants: 0-d for one
    cluster, [B] for a batched state."""
    batched = batch_size(state) is not None
    b = lambda x: _as_batch(x, batched)  # noqa: E731
    role, term = b(state.role), b(state.term)
    last, commit = b(state.last), b(state.commit)
    leaders = role == LEADER
    n = cfg.n
    eye = torch.eye(n, dtype=torch.bool, device=term.device)

    # ELECTION_SAFETY: no two current leaders share a term
    lterm = torch.where(leaders, term, -1)
    same = (lterm[:, :, None] == lterm[:, None, :]) \
        & leaders[:, :, None] & leaders[:, None, :] & ~eye
    bits = _bit(_any(same), ELECTION_SAFETY)

    # LOG_MATCHING: same (index, term) in two rings => same payload
    idx, valid = _live_index(b(state.snap_idx), last, cfg.log_len)
    lt, ld = b(state.log_term), b(state.log_data)
    clash = valid[:, :, None, :] & valid[:, None, :, :] \
        & (idx[:, :, None, :] == idx[:, None, :, :]) \
        & (lt[:, :, None, :] == lt[:, None, :, :]) \
        & (ld[:, :, None, :] != ld[:, None, :, :])
    bits = bits | _bit(_any(clash), LOG_MATCHING)

    # LEADER_COMPLETENESS: max-term leaders hold every committed entry
    top = leaders & (term == _max(term)[:, None])
    bits = bits | _bit(_any(top & (last < _max(commit)[:, None])),
                       LEADER_COMPLETENESS)

    # CHECKSUM_AGREEMENT: equal applied => equal checksum
    applied, chk = (b(x) for x in quorum_applied_checksum(state))
    agree = (applied[:, :, None] == applied[:, None, :]) \
        & (chk[:, :, None] != chk[:, None, :])
    bits = bits | _bit(_any(agree), CHECKSUM_AGREEMENT)

    # LINEARIZABLE_READ (gated on the read registers)
    if state.read_srv_idx is not None:
        bits = bits | _bit(_any(b(state.read_srv_idx)
                                < b(state.read_srv_goal)),
                           LINEARIZABLE_READ)

    # SLO_COMMIT_P99 (gated on the bound and the telemetry plane)
    if cfg.slo_p99_commit_ticks > 0 and state.tel_commit_hist is not None:
        hist = b(state.tel_commit_hist)
        edge = ts.percentile_edge_device(hist, 99)
        bits = bits | _bit((hist.sum(1, dtype=I32) > 0)
                           & (edge > cfg.slo_p99_commit_ticks),
                           SLO_COMMIT_P99)

    # SLO_LEADER_CHURN: cumulative election wins under the budget
    if cfg.slo_leader_changes > 0 and state.tel_elect_hist is not None:
        bits = bits | _bit(b(state.tel_elect_hist).sum(1, dtype=I32)
                           > cfg.slo_leader_changes, SLO_LEADER_CHURN)

    # SLO_LOG_OCCUPANCY: every row's uncommitted tail under the budget
    if cfg.slo_log_occupancy > 0:
        bits = bits | _bit(_max(last - commit) > cfg.slo_log_occupancy,
                           SLO_LOG_OCCUPANCY)

    # DURABILITY (gated on the storage model)
    if state.ack_frontier is not None:
        bits = bits | _bit(_max(b(state.ack_frontier)) > _max(last),
                           DURABILITY)

    # SLO_FSYNC_LAG: every row's unsynced suffix under the budget
    if cfg.slo_fsync_lag > 0 and state.sync_mark is not None:
        bits = bits | _bit(_max(last - b(state.sync_mark))
                           > cfg.slo_fsync_lag, SLO_FSYNC_LAG)
    return bits if batched else bits[0]


def check_transition(prev: SimState, new: SimState,
                     recovering=None) -> torch.Tensor:
    """Bitmask of the across-one-tick invariants (0-d, or [B]).

    `recovering` (bool [N] / [B, N], optional) marks rows a storage-fault
    verb legally truncated this tick (lost_tail / torn_write), excused from
    COMMIT_MONOTONIC for this transition; RECOVERY_MONOTONIC still pins
    every row's dur_commit.  Only prev's commit, applied and dur_commit
    are read, so the caller keeps those three and need not keep a copy of
    the whole pre-tick state."""
    batched = batch_size(new) is not None
    b = lambda x: _as_batch(x, batched)  # noqa: E731
    commit_ok = b(new.commit >= prev.commit)
    applied_ok = b(new.applied >= prev.applied)
    if recovering is not None:
        commit_ok = commit_ok | b(recovering)
        applied_ok = applied_ok | b(recovering)
    regress = _any(~commit_ok) | _any(~applied_ok) \
        | _any(b(new.applied > new.commit))
    bits = _bit(regress, COMMIT_MONOTONIC)
    if new.dur_commit is not None and prev.dur_commit is not None:
        bits = bits | _bit(_any(b(new.dur_commit < prev.dur_commit)),
                           RECOVERY_MONOTONIC)
    return bits if batched else bits[0]
