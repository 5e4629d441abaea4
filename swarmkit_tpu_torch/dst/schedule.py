"""Fault schedules: stacked tensors + the seeded adversary generator
(PyTorch port of the JAX package's dst/schedule.py).

A `FaultSchedule` is the compiled, data-only form of an adversary: per-tick
base drop matrices and liveness masks plus two STATE-CONDITIONED gates
(`target_leader`, `crash_campaign`) that the explore and replay loops resolve
against the cluster's current roles each tick, and the optional attack and
storage-fault leaves that drive the pre-step verbs below.  The leaves,
their shapes and dtypes, the verbs and their composition order are the JAX
package's, so a schedule carries across either way (`FaultSchedule.
from_numpy` / `to_numpy`) and replays to the same bits in both packages.

Generation differs on purpose.  Each schedule draws from its own CPU
``torch.Generator`` seeded from (seed, index) and then moves to the
device, so schedule (seed, profile, index) is the same arrays however wide
the batch is and on the card or the CPU.  The port does not reproduce
``jax.random``'s threefry stream: its draws are not JAX's, but each profile
follows the same law (the same leaves, shapes, dtypes, ranges and gating).
To replay a schedule JAX generated, carry it across with `from_numpy`.

Tick-latency note: the synchronous wire retries every message each tick, so
a directed edge that a schedule drops on d consecutive ticks delays that
edge's traffic by d ticks — delay masks lower to drop runs (see
``from_fault_plan`` and raft/faults.py ``plan_to_schedule``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.flightrec import codes as fc
from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.raft.sim.kernel import _first_true, propose_dense
from swarmkit_tpu_torch.raft.sim.state import (
    CANDIDATE, LEADER, NONE, SimConfig,
)

I32 = torch.int32

# Named adversary profiles.  `make_batch` deals them round-robin across the
# schedule axis.  PROFILES is the default rotation; special-purpose
# adversaries live in EXTRA_PROFILES and are requested explicitly.
PROFILES = ("random_drop", "partition_flapper", "leader_targeted",
            "asymmetric_links", "crash_restart", "crash_during_campaign")
# The arXiv:2601.00273 attack suite: each profile drives one counted
# FaultSchedule verb below, and each verb has a matching kernel defense
# knob (see SimConfig) whose cost is bounded by an SLO invariant.
ATTACK_PROFILES = ("disruptive_rejoin", "vote_equivocation",
                   "append_flood", "transfer_abuse")
# The storage-fault suite: each profile drives one storage leaf below.
# These adversaries attack the durable/volatile boundary instead of the
# wire, so they require the storage model (cfg.fsync_lag_ticks >= 1) — the
# verbs are pure no-ops on a storage-off state — and the matching defense
# is the ack-gating contract (cfg.ack_gating) plus the SLO_FSYNC_LAG budget.
STORAGE_PROFILES = ("lost_tail", "torn_write", "snap_corrupt",
                    "disk_stall")
EXTRA_PROFILES = ("stale_leader_reads", "term_inflation") \
    + ATTACK_PROFILES + STORAGE_PROFILES
# The FaultSchedule leaf each attack profile drives (gate firings feed the
# swarm_dst_attack_ticks_total counter) and the flightrec signature code
# its apply verb emits.
ATTACK_LEAVES = {
    "disruptive_rejoin": "rejoin_campaign",
    "vote_equivocation": "vote_equivocate",
    "append_flood": "append_flood",
    "transfer_abuse": "transfer_abuse",
}
ATTACK_SIGNATURE_CODES = {
    "disruptive_rejoin": "ATTACK_REJOIN",
    "vote_equivocation": "ATTACK_EQUIVOCATE",
    "append_flood": "ATTACK_FLOOD",
    "transfer_abuse": "ATTACK_TRANSFER",
}
STORAGE_LEAVES = {
    "lost_tail": "lost_tail",
    "torn_write": "torn_write",
    "snap_corrupt": "snap_corrupt",
    "disk_stall": "disk_stall",
}
STORAGE_SIGNATURE_CODES = {
    "lost_tail": "RECOVER_TRUNCATE",
    "torn_write": "RECOVER_TORN",
    "snap_corrupt": "SNAP_CORRUPT",
    "disk_stall": "FSYNC_STALL",
}

# FaultSchedule leaves that default to None (absent: the verb does not run)
# and their gate shape: "T" -> [ticks], "TN" -> [ticks, n].  make_batch
# promotes absent leaves to all-False of this shape when any schedule in
# the batch carries the leaf.
_OPTIONAL_LEAVES = {
    "term_inflate": "TN",
    "rejoin_campaign": "TN",
    "vote_equivocate": "TN",
    "append_flood": "T",
    "transfer_abuse": "TN",
    "lost_tail": "TN",
    "torn_write": "TN",
    "snap_corrupt": "TN",
    "disk_stall": "TN",
}


@dataclass
class FaultSchedule:
    """Stacked bool fault tensors for T ticks (optionally with a leading S
    axis); the JAX package's FaultSchedule leaf for leaf:

    drop           [.., T, N, N]  base per-tick drops, [i, j] = i -> j
    alive          [.., T, N]     row liveness (False = crashed)
    target_leader  [.., T]        gate: drop all edges touching any row
                                  that is CURRENTLY leader
    crash_campaign [.., T]        gate: rows CURRENTLY candidate are
                                  treated as crashed this tick
    term_inflate, rejoin_campaign, vote_equivocate, transfer_abuse,
    lost_tail, torn_write, snap_corrupt, disk_stall   [.., T, N]
    append_flood   [.., T]
                                  the attack and storage-fault verbs'
                                  gates (see the apply_* verbs); None =
                                  the verb is absent.
    """

    drop: torch.Tensor
    alive: torch.Tensor
    target_leader: torch.Tensor
    crash_campaign: torch.Tensor
    term_inflate: Optional[torch.Tensor] = None
    rejoin_campaign: Optional[torch.Tensor] = None
    vote_equivocate: Optional[torch.Tensor] = None
    append_flood: Optional[torch.Tensor] = None
    transfer_abuse: Optional[torch.Tensor] = None
    lost_tail: Optional[torch.Tensor] = None
    torn_write: Optional[torch.Tensor] = None
    snap_corrupt: Optional[torch.Tensor] = None
    disk_stall: Optional[torch.Tensor] = None

    @property
    def ticks(self) -> int:
        return self.target_leader.shape[-1]

    def leaves(self) -> dict:
        """The present leaves by name."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def _map(self, fn) -> "FaultSchedule":
        return FaultSchedule(**{k: fn(v) for k, v in self.leaves().items()})

    def slice(self, s: int) -> "FaultSchedule":
        """Extract one schedule from a batched [S, ...] stack."""
        return self._map(lambda a: a[s])

    def at_tick(self, t: int) -> "FaultSchedule":
        """One tick's leaves ([S, ...] at tick t of an [S, T, ...] batch,
        or [...] at tick t of one schedule): views, no copy."""
        batched = self.target_leader.dim() == 2
        return self._map((lambda a: a[:, t]) if batched
                         else (lambda a: a[t]))

    def to(self, device) -> "FaultSchedule":
        dev = torch.device(device)
        return self._map(lambda a: a.to(dev))

    @classmethod
    def from_numpy(cls, src, device=None) -> "FaultSchedule":
        """A schedule from numpy-convertible leaves: a dict keyed by leaf
        name, or any object with the leaves as attributes (the JAX
        package's FaultSchedule).  On `device` (the CUDA card unless the
        caller names another)."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(cls):
            a = src.get(f.name) if isinstance(src, dict) \
                else getattr(src, f.name, None)
            if a is not None:
                out[f.name] = torch.from_numpy(
                    np.array(a, dtype=bool, order="C", copy=True)).to(dev)
        return cls(**out)

    def to_numpy(self) -> dict:
        """Every present leaf as a bool numpy array."""
        return {k: v.detach().cpu().numpy().copy()
                for k, v in self.leaves().items()}


def _batched(role: torch.Tensor) -> bool:
    return role.dim() == 2


def effective_faults(role: torch.Tensor, drop_t: torch.Tensor,
                     alive_t: torch.Tensor, target_leader_t: torch.Tensor,
                     crash_campaign_t: torch.Tensor):
    """Resolve one tick's state-conditioned gates against current roles.

    Returns (alive, drop) in the shapes `kernel.step` consumes; pure in
    (role, schedule slice), so replays reproduce the original faults.  On
    a batched state role is [B, N] and the gates [B]."""
    leaders = role == LEADER
    if _batched(role):
        isolate = target_leader_t[:, None, None] \
            & (leaders[:, :, None] | leaders[:, None, :])
        crash = crash_campaign_t[:, None] & (role == CANDIDATE)
    else:
        isolate = target_leader_t & (leaders[:, None] | leaders[None, :])
        crash = crash_campaign_t & (role == CANDIDATE)
    return alive_t & ~crash, drop_t | isolate


# ---------------------------------------------------------------------------
# The pre-step verbs.  Each is pure in (state, schedule slice), row-local,
# runs on one cluster's state or a batched one, and emits its flightrec
# signature when the state carries an event ring (a batched state's rings
# take each cluster's events, as JAX's vmap gives them).  COMPOSITION
# ORDER (explore and repro apply them in this fixed sequence so two active
# attacks never silently mask each other):
#   term_inflate -> rejoin_campaign -> vote_equivocate -> transfer_abuse
#   -> append_flood -> disk_stall -> snap_corrupt -> lost_tail
#   -> torn_write


def _emit_attack(state, mask, code: int, a0, a1):
    """Append an attack-signature event on masked rows (a no-op when the
    state carries no ring); on a batched state each argument is [B, N] or
    a per-cluster [B, 1]."""
    if state.ev_buf is None:
        return state
    ev_buf, ev_pos = fc.ring_append(state.ev_buf, state.ev_pos, mask,
                                    state.tick, code, a0, a1)
    return dataclasses.replace(state, ev_buf=ev_buf, ev_pos=ev_pos)


def _force_timer(state, gate: torch.Tensor, alive: torch.Tensor):
    """(forced rows, the state with their election timer forced due)."""
    force = gate & alive & (state.role != LEADER)
    elapsed = torch.where(force, torch.maximum(state.elapsed, state.timeout),
                          state.elapsed)
    return force, dataclasses.replace(state, elapsed=elapsed)


def apply_term_inflation(state, term_inflate_t: torch.Tensor,
                         alive: torch.Tensor):
    """One tick of the ``term_inflate`` action: flagged live non-leader
    rows get their election timer forced to the firing point, so the
    kernel's own campaign path runs this tick — with ``cfg.pre_vote`` off
    each forced campaign bumps the row's term; with PreVote on it is a
    non-binding poll CheckQuorum-leased voters refuse."""
    return _force_timer(state, term_inflate_t, alive)[1]


def apply_rejoin_campaign(state, rejoin_t: torch.Tensor,
                          alive: torch.Tensor):
    """One tick of the ``rejoin_campaign`` action (disruptive rejoin): the
    timer force of ``apply_term_inflation``, which the generator pairs
    with a partition that HEALS; neutralized by PreVote + CheckQuorum."""
    force, out = _force_timer(state, rejoin_t, alive)
    return _emit_attack(out, force, fc.ATTACK_REJOIN, state.term,
                        state.timeout)


def apply_vote_equivocation(state, equiv_t: torch.Tensor,
                            alive: torch.Tensor):
    """One tick of the ``vote_equivocate`` action: wipe the flagged row's
    in-memory vote (crash-restart without fsyncing it), so it may grant a
    second candidate in the same term unless the persisted-vote guard
    (cfg.vote_guard), which this verb cannot touch, is on."""
    wipe = equiv_t & alive & (state.vote != NONE)
    out = dataclasses.replace(state,
                              vote=torch.where(wipe, NONE, state.vote))
    return _emit_attack(out, wipe, fc.ATTACK_EQUIVOCATE, state.vote,
                        state.term)


def _flood_payload(tick, k: torch.Tensor) -> torch.Tensor:
    """Deterministic on-device flood payloads, as uint32 bits (distinct
    from the sweeps' own payload streams so log matching stays
    meaningful): hash32(tick * 0x9E3779B9 ^ k ^ 0xF100D)."""
    t = u32.unsigned(torch.as_tensor(tick, dtype=I32, device=k.device))
    return u32.to_bits(u32.hash32(u32.mul(t, 0x9E3779B9)
                                  ^ u32.unsigned(k) ^ 0xF100D))


def apply_append_flood(state, cfg: SimConfig, flood_t: torch.Tensor,
                       alive: torch.Tensor):
    """One tick of the ``append_flood`` action: every row currently
    accepting proposals takes cfg.max_props extra dense appends (a count
    of 0 on unflagged ticks, which still runs the propose); bounded by
    cfg.prop_inflight_cap and witnessed by SLO_LOG_OCCUPANCY."""
    cnt = torch.where(flood_t, cfg.max_props, 0).to(I32)
    gate = flood_t[:, None] if _batched(state.role) else flood_t
    sig = gate & alive & (state.role == LEADER)
    out = propose_dense(state, cfg, _flood_payload, cnt, alive,
                        device=state.term.device)
    if out.ev_buf is None:
        return out
    return _emit_attack(out, sig, fc.ATTACK_FLOOD,
                        cnt[:, None] if _batched(state.role)
                        else cnt.expand(cfg.n), state.last - state.commit)


def apply_transfer_abuse(state, cfg: SimConfig, abuse_t: torch.Tensor,
                         alive: torch.Tensor):
    """One tick of the ``transfer_abuse`` action: every live current
    leader is asked to transfer leadership to the (lowest) flagged row,
    with ``kernel.transfer_leadership``'s semantics row-wise, the cooldown
    consult included (cfg.transfer_cooldown_ticks)."""
    n = cfg.n
    node = torch.arange(n, dtype=I32, device=abuse_t.device)
    if _batched(state.role):
        has_tgt = abuse_t.any(-1, keepdim=True)
        tgt = _first_true(abuse_t, 1)[:, None]                  # [B, 1]
        in_view = state.member.gather(
            2, tgt[:, :, None].to(torch.int64).expand(-1, n, 1))[:, :, 0]
    else:
        has_tgt = abuse_t.any()
        tgt = _first_true(abuse_t, 0)                           # 0-d
        in_view = state.member.gather(
            1, tgt.to(torch.int64).expand(n, 1))[:, 0]
    req = (state.role == LEADER) & alive & has_tgt & (node != tgt) & in_view
    ok = req
    cool = torch.zeros_like(state.term)
    if cfg.transfer_cooldown_ticks > 0 and state.tx_cool is not None:
        cool = state.tx_cool
        ok = ok & (cool == 0)
    changed = ok & (state.transferee != tgt)
    out = dataclasses.replace(
        state, transferee=torch.where(changed, tgt, state.transferee),
        elapsed=torch.where(changed, 0, state.elapsed))
    if out.ev_buf is None:
        return out
    return _emit_attack(out, req, fc.ATTACK_TRANSFER,
                        tgt if _batched(state.role) else tgt.expand(n), cool)


def _recover_fields(state, g, new_last):
    """The shared recovery rebuild: volatile state on `g` rows restarts
    from durable registers only (commit re-clamps to the surviving log,
    apply restarts from the snapshot, the read batch and lease die);
    dur_commit, the durable record RECOVERY_MONOTONIC pins, is not
    touched."""
    last = torch.where(g, new_last, state.last)
    fields = dict(
        last=last,
        commit=torch.where(g, torch.minimum(state.commit, last),
                           state.commit),
        applied=torch.where(g, state.snap_idx, state.applied),
        apply_chk=torch.where(g, state.snap_chk, state.apply_chk))
    if state.read_pend is not None:
        fields.update(
            read_pend=torch.where(g, 0, state.read_pend),
            read_goal=torch.where(g, 0, state.read_goal),
            read_idx=torch.where(g, NONE, state.read_idx),
            lease_until=torch.where(g, 0, state.lease_until))
    return fields


def apply_lost_tail(state, lost_t: torch.Tensor, alive: torch.Tensor):
    """One tick of the ``lost_tail`` action: the flagged row crashed with
    an unsynced log suffix, so its image truncates back to the durable
    watermark max(min(last, sync_mark), snap_idx) and volatile state
    rebuilds (liveness is not consulted: the gate fires on the crash
    tick).  A no-op on a storage-off state."""
    if state.sync_mark is None:
        return state
    new_last = torch.maximum(torch.minimum(state.last, state.sync_mark),
                             state.snap_idx)
    out = dataclasses.replace(state,
                              **_recover_fields(state, lost_t, new_last))
    return _emit_attack(out, lost_t & (state.last > new_last),
                        fc.RECOVER_TRUNCATE, new_last,
                        state.last - new_last)


def apply_torn_write(state, torn_t: torch.Tensor, alive: torch.Tensor):
    """One tick of the ``torn_write`` action: recovery finds the flagged
    row's last durable entry torn, so last and sync_mark truncate to
    max(sync_mark - 1, snap_idx) and volatile state rebuilds.  A no-op on
    a storage-off state."""
    if state.sync_mark is None:
        return state
    new_last = torch.maximum(state.sync_mark - 1, state.snap_idx)
    fields = _recover_fields(state, torn_t, new_last)
    fields["sync_mark"] = torch.where(torn_t, new_last, state.sync_mark)
    out = dataclasses.replace(state, **fields)
    return _emit_attack(out, torn_t & (state.sync_mark > new_last),
                        fc.RECOVER_TORN, new_last, state.sync_mark)


def apply_disk_stall(state, stall_t: torch.Tensor, alive: torch.Tensor):
    """One tick of the ``disk_stall`` action: the flagged live row's fsync
    makes no progress this tick (the one-tick fsync_stall flag)."""
    if state.fsync_stall is None:
        return state
    g = stall_t & alive
    out = dataclasses.replace(state, fsync_stall=state.fsync_stall | g)
    return _emit_attack(out, g, fc.FSYNC_STALL,
                        state.last - state.sync_mark, state.sync_mark)


def apply_snap_corrupt(state, corrupt_t: torch.Tensor, alive: torch.Tensor):
    """One tick of the ``snap_corrupt`` action: a snapshot arriving at the
    flagged live row this tick fails its checksum (the one-tick snap_bad
    flag): refused under ack_gating, installed and poisoned without."""
    if state.snap_bad is None:
        return state
    g = corrupt_t & alive
    out = dataclasses.replace(state, snap_bad=state.snap_bad | g)
    return _emit_attack(out, g, fc.SNAP_CORRUPT, state.snap_idx,
                        state.commit)


# ---------------------------------------------------------------------------
# Profile generators: (generator, cfg, ticks) -> FaultSchedule for ONE
# schedule, on the CPU.  Every draw comes from the schedule's own
# torch.Generator, in a fixed order; the laws follow the JAX package's
# generators (jax.random.randint(lo, hi) -> torch.randint(lo, hi),
# uniform -> torch.rand, permutation -> torch.randperm).


def _randint(g, lo: int, hi: int, shape=()) -> torch.Tensor:
    """Uniform int32 in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=g, dtype=I32)


def _uniform(g, shape=()) -> torch.Tensor:
    """Uniform float32 in [0, 1)."""
    return torch.rand(shape, generator=g, dtype=torch.float32)


def _windows(g, ticks: int, period_lo: int, period_hi: int) -> torch.Tensor:
    """[T] bool square-wave gate with a random period in
    [period_lo, period_hi] and phase in [0, period_hi)."""
    period = _randint(g, period_lo, period_hi + 1)
    phase = _randint(g, 0, period_hi)
    t = torch.arange(ticks, dtype=I32)
    return torch.div(t + phase, period, rounding_mode="floor") % 2 == 1


def _no_faults(cfg: SimConfig, ticks: int) -> FaultSchedule:
    n = cfg.n
    return FaultSchedule(
        drop=torch.zeros((ticks, n, n), dtype=torch.bool),
        alive=torch.ones((ticks, n), dtype=torch.bool),
        target_leader=torch.zeros((ticks,), dtype=torch.bool),
        crash_campaign=torch.zeros((ticks,), dtype=torch.bool))


def _gen_random_drop(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """iid Bernoulli edge drops at a per-schedule rate in [0.05, 0.4)."""
    rate = 0.05 + 0.35 * _uniform(g)
    drop = _uniform(g, (ticks, cfg.n, cfg.n)) < rate
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop)


def _gen_partition_flapper(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """A two-sided split that flaps open/closed: a random cut point, and a
    flap period straddling the election timeout."""
    cut = _randint(g, 1, cfg.n)
    side = torch.arange(cfg.n, dtype=I32) < cut
    cross = side[:, None] != side[None, :]
    gate = _windows(g, ticks, cfg.election_tick // 2, 2 * cfg.election_tick)
    drop = gate[:, None, None] & cross[None, :, :]
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop)


def _gen_leader_targeted(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Windows during which whoever currently leads is fully isolated,
    over a light (5%) random-drop background."""
    gate = _windows(g, ticks, cfg.election_tick, 3 * cfg.election_tick)
    drop = _uniform(g, (ticks, cfg.n, cfg.n)) < 0.05
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               target_leader=gate)


def _gen_asymmetric_links(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Persistent one-directional loss: each directed edge its own loss
    rate, skewed low (uniform cubed), with no symmetry."""
    edge_rate = _uniform(g, (cfg.n, cfg.n)) ** 3
    drop = _uniform(g, (ticks, cfg.n, cfg.n)) < edge_rate[None]
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop)


def _gen_crash_restart(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Random crash/restart windows: each row draws a crash tick and an
    outage length; about half the rows crash somewhere in the run."""
    victims = _uniform(g, (cfg.n,)) < 0.5
    crash_at = _randint(g, 0, max(1, ticks - 2), (cfg.n,))
    down_for = _randint(g, 2, max(3, 3 * cfg.election_tick), (cfg.n,))
    t = torch.arange(ticks, dtype=I32)[:, None]
    downed = victims[None, :] & (t >= crash_at[None, :]) \
        & (t < (crash_at + down_for)[None, :])
    return dataclasses.replace(_no_faults(cfg, ticks), alive=~downed)


def _gen_crash_during_campaign(g, cfg: SimConfig, ticks: int
                               ) -> FaultSchedule:
    """Windows during which any row mid-campaign is crashed, over a light
    (10%) random-drop background."""
    gate = _windows(g, ticks, cfg.election_tick, 2 * cfg.election_tick)
    drop = _uniform(g, (ticks, cfg.n, cfg.n)) < 0.1
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               crash_campaign=gate)


def _gen_stale_leader_reads(g, cfg: SimConfig, ticks: int
                            ) -> FaultSchedule:
    """The stale-read attack shape: ONE random victim row fully isolated
    for 3 election timeouts, starting after the first election settles,
    over a 2% random-drop background.  A correct lease expires inside the
    window; a lease-disabled serve (the ``stale_lease_read`` mutation)
    trips LINEARIZABLE_READ."""
    T = cfg.election_tick
    width = 3 * T
    victim = _randint(g, 0, cfg.n)
    start = _randint(g, 2 * T, max(2 * T + 1, ticks - width))
    t = torch.arange(ticks, dtype=I32)
    gate = (t >= start) & (t < start + width)
    row = torch.arange(cfg.n, dtype=I32)
    touches = (row[:, None] == victim) | (row[None, :] == victim)
    isolate = gate[:, None, None] & touches[None, :, :]
    drop = (_uniform(g, (ticks, cfg.n, cfg.n)) < 0.02) | isolate
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop)


def _gen_term_inflation(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """ONE random victim row is partitioned away on flapping windows and
    fires its election timer every windowed tick."""
    victim = _randint(g, 0, cfg.n)
    gate = _windows(g, ticks, 2, max(3, cfg.election_tick))
    is_victim = torch.arange(cfg.n, dtype=I32) == victim
    inflate = gate[:, None] & is_victim[None, :]
    cut = is_victim[None, :, None] | is_victim[None, None, :]
    drop = gate[:, None, None] & cut
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               term_inflate=inflate)


def _gen_disruptive_rejoin(g, cfg: SimConfig, ticks: int
                           ) -> FaultSchedule:
    """ONE random victim row partitioned for 2 election timeouts, firing a
    campaign every other timeout from the cut on, through the heal to the
    end of the run."""
    T = cfg.election_tick
    victim = _randint(g, 0, cfg.n)
    start = _randint(g, 2 * T, max(2 * T + 1, ticks - 5 * T))
    heal = start + 2 * T
    t = torch.arange(ticks, dtype=I32)
    cut_gate = (t >= start) & (t < heal)
    barrage = (t >= start) & ((t - start) % (2 * T) == 0)
    is_victim = torch.arange(cfg.n, dtype=I32) == victim
    touches = is_victim[None, :, None] | is_victim[None, None, :]
    drop = cut_gate[:, None, None] & touches
    rejoin = barrage[:, None] & is_victim[None, :]
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               rejoin_campaign=rejoin)


def _gen_vote_equivocation(g, cfg: SimConfig, ticks: int
                           ) -> FaultSchedule:
    """Faulty voters that forget their grant under engineered rival
    candidacies: rows A and B campaign on the same tick k, each kept one
    voter short; from k+1 the f = 2*quorum - n equivocators' votes are
    wiped every tick and the cuts steer a second same-term grant to B
    while the bystanders complete A's quorum (the dual election the vote
    guard makes unrepresentable)."""
    n = cfg.n
    T = cfg.election_tick
    q = n // 2 + 1
    f = 2 * q - n
    perm = torch.randperm(n, generator=g).to(I32)
    pos = torch.zeros((n,), dtype=I32)
    pos[perm.to(torch.int64)] = torch.arange(n, dtype=I32)
    a, b = perm[0], perm[1]
    is_v = (pos >= 2) & (pos < 2 + f)
    is_loy = (pos >= 2 + f) & (pos < 1 + q)
    is_x = pos >= 1 + q
    k = _randint(g, 1, max(2, min(T, ticks - 3)))
    t = torch.arange(ticks, dtype=I32)
    row = torch.arange(n, dtype=I32)
    at_k = t == k
    after = t > k
    row_a, row_b = row == a, row == b
    rejoin = at_k[:, None] & (row_a | row_b)[None, :]
    cut_k = (row_a[:, None] & (~is_v & ~row_a)[None, :]) \
        | (row_b[:, None] & (~is_loy & ~row_b)[None, :])
    cut_after = (row_a[:, None] & (is_v | row_b)[None, :]) \
        | (row_b[:, None] & (is_x | row_a)[None, :])
    drop = (at_k[:, None, None] & cut_k[None, :, :]) \
        | (after[:, None, None] & cut_after[None, :, :])
    equiv = after[:, None] & is_v[None, :]
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               rejoin_campaign=rejoin,
                               vote_equivocate=equiv)


def _gen_append_flood(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Targeted client flood against an isolated leader: a 2-timeout window
    after the first election isolates whoever leads while every tick of
    it floods all proposal-accepting rows, over a 2% background."""
    T = cfg.election_tick
    start = _randint(g, 2 * T, max(2 * T + 1, ticks - 3 * T))
    t = torch.arange(ticks, dtype=I32)
    window = (t >= start) & (t < start + 2 * T)
    drop = _uniform(g, (ticks, cfg.n, cfg.n)) < 0.02
    return dataclasses.replace(_no_faults(cfg, ticks), drop=drop,
                               target_leader=window,
                               append_flood=window)


def _gen_transfer_abuse(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Leadership ping-pong: after the first election, two random rows
    alternate as the demanded transfer target on a fast flap."""
    T = cfg.election_tick
    a = _randint(g, 0, cfg.n)
    b = _randint(g, 0, cfg.n)
    t = torch.arange(ticks, dtype=I32)
    settled = t >= 2 * T
    flip = _windows(g, ticks, 2, max(3, T // 2))
    row = torch.arange(cfg.n, dtype=I32)
    tgt = torch.where(flip, a, b)
    abuse = settled[:, None] & (row[None, :] == tgt[:, None])
    return dataclasses.replace(_no_faults(cfg, ticks),
                               transfer_abuse=abuse)


def _gen_lost_tail(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """Correlated power loss: every row crashes on the same tick (after
    the first election) for a short outage, each losing its unsynced log
    suffix."""
    T = cfg.election_tick
    crash_at = _randint(g, 2 * T, max(2 * T + 1, ticks - 3))
    down_for = _randint(g, 2, max(3, T))
    t = torch.arange(ticks, dtype=I32)
    downed = (t >= crash_at) & (t < crash_at + down_for)
    alive = (~downed)[:, None].expand(ticks, cfg.n).contiguous()
    lost = (t == crash_at)[:, None].expand(ticks, cfg.n).contiguous()
    return dataclasses.replace(_no_faults(cfg, ticks), alive=alive,
                               lost_tail=lost)


def _gen_torn_write(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """ONE victim row crashes mid-run and recovery finds its last durable
    entry torn; replication covers it."""
    T = cfg.election_tick
    victim = _randint(g, 0, cfg.n)
    crash_at = _randint(g, 2 * T, max(2 * T + 1, ticks - 3))
    down_for = _randint(g, 2, max(3, T))
    t = torch.arange(ticks, dtype=I32)
    is_v = torch.arange(cfg.n, dtype=I32) == victim
    downed = ((t >= crash_at) & (t < crash_at + down_for))[:, None] \
        & is_v[None, :]
    torn = (t == crash_at)[:, None] & is_v[None, :]
    return dataclasses.replace(_no_faults(cfg, ticks), alive=~downed,
                               torn_write=torn)


def _gen_snap_corrupt(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """ONE victim row crashed past the compaction horizon, then every
    snapshot reaching it in the 2 timeouts after its restart fails its
    checksum."""
    T = cfg.election_tick
    victim = _randint(g, 0, cfg.n)
    start = _randint(g, 2 * T, max(2 * T + 1, ticks - 8 * T))
    heal = start + 5 * T
    t = torch.arange(ticks, dtype=I32)
    cut = (t >= start) & (t < heal)
    is_v = torch.arange(cfg.n, dtype=I32) == victim
    alive = ~(cut[:, None] & is_v[None, :])
    bad = ((t >= heal) & (t < heal + 2 * T))[:, None] & is_v[None, :]
    return dataclasses.replace(_no_faults(cfg, ticks), alive=alive,
                               snap_corrupt=bad)


def _gen_disk_stall(g, cfg: SimConfig, ticks: int) -> FaultSchedule:
    """A random majority shares a slow disk: their fsyncs freeze on
    flapping windows after the first election."""
    q = cfg.n // 2 + 1
    perm = torch.randperm(cfg.n, generator=g)
    pos = torch.zeros((cfg.n,), dtype=I32)
    pos[perm] = torch.arange(cfg.n, dtype=I32)
    stalled = pos < q
    T = cfg.election_tick
    gate = _windows(g, ticks, T, 3 * T)
    settled = torch.arange(ticks, dtype=I32) >= 2 * T
    stall = (gate & settled)[:, None] & stalled[None, :]
    return dataclasses.replace(_no_faults(cfg, ticks), disk_stall=stall)


_GENERATORS = {
    "random_drop": _gen_random_drop,
    "partition_flapper": _gen_partition_flapper,
    "leader_targeted": _gen_leader_targeted,
    "asymmetric_links": _gen_asymmetric_links,
    "crash_restart": _gen_crash_restart,
    "crash_during_campaign": _gen_crash_during_campaign,
    "stale_leader_reads": _gen_stale_leader_reads,
    "term_inflation": _gen_term_inflation,
    "disruptive_rejoin": _gen_disruptive_rejoin,
    "vote_equivocation": _gen_vote_equivocation,
    "append_flood": _gen_append_flood,
    "transfer_abuse": _gen_transfer_abuse,
    "lost_tail": _gen_lost_tail,
    "torn_write": _gen_torn_write,
    "snap_corrupt": _gen_snap_corrupt,
    "disk_stall": _gen_disk_stall,
}

_MASK64 = (1 << 64) - 1


def _stream(seed: int, index: int) -> torch.Generator:
    """The CPU generator of schedule `index` of sweep `seed`: seeded by a
    splitmix64 mix of (seed, index), so neighbouring indexes and seeds get
    unrelated streams and the stream does not depend on the batch."""
    z = ((int(seed) & 0xFFFF_FFFF) << 32 | (int(index) & 0xFFFF_FFFF))
    z = (z + 0x9E37_79B9_7F4A_7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58_476D_1CE4_E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D0_49BB_1331_11EB) & _MASK64
    g = torch.Generator(device="cpu")
    g.manual_seed((z ^ (z >> 31)) & _MASK64)
    return g


def _generate(cfg: SimConfig, ticks: int, profile: str, seed: int,
              index: int) -> FaultSchedule:
    gen = _GENERATORS.get(profile)
    if gen is None:
        raise KeyError(f"unknown adversary profile {profile!r}; "
                       f"known: {PROFILES + EXTRA_PROFILES}")
    return gen(_stream(seed, index), cfg, ticks)


def make_schedule(cfg: SimConfig, ticks: int, profile: str, seed: int,
                  index: int = 0, device=None) -> FaultSchedule:
    """One schedule of `profile`, drawn from the (seed, index) stream on the
    CPU and moved to `device` (the CUDA card unless the caller names
    another)."""
    dev = resolve_device(device)
    return _generate(cfg, ticks, profile, seed, index).to(dev)


def make_batch(cfg: SimConfig, ticks: int, schedules: int, seed: int,
               profiles=PROFILES, device=None
               ) -> tuple[FaultSchedule, list[str]]:
    """[S, ...] stacked schedules + the profile name of each index, on
    `device` (the CUDA card unless the caller names another).

    Profiles are dealt round-robin over the schedule axis; index s draws
    from the (seed, s) stream, so schedule (seed, profile, index) is stable
    however wide the sweep runs.  Absent optional leaves are promoted to
    all-False gates when any schedule of the batch carries the leaf (every
    verb is the identity on an all-False mask)."""
    dev = resolve_device(device)
    profiles = tuple(profiles)
    names = [profiles[s % len(profiles)] for s in range(schedules)]
    scheds = [_generate(cfg, ticks, name, seed, s)
              for s, name in enumerate(names)]
    stacked = {}
    for f in dataclasses.fields(FaultSchedule):
        parts = [getattr(s, f.name) for s in scheds]
        if all(p is None for p in parts):
            continue
        if any(p is None for p in parts):
            shape = (ticks,) if _OPTIONAL_LEAVES[f.name] == "T" \
                else (ticks, cfg.n)
            zero = torch.zeros(shape, dtype=torch.bool)
            parts = [zero if p is None else p for p in parts]
        stacked[f.name] = torch.stack(parts).to(dev)
    return FaultSchedule(**stacked), names


def from_fault_plan(cfg: SimConfig, plan, rows: dict[str, int], ticks: int,
                    inject_at: int = 0, heal_at=None, seed: int = 0,
                    device=None) -> FaultSchedule:
    """Lower a declarative `raft.faults.FaultPlan` into a FaultSchedule on
    `device`, with the state-conditioned gates off; the lowering itself is
    ``raft.faults.plan_to_schedule``."""
    from swarmkit_tpu_torch.raft.faults import plan_to_schedule

    arrs = plan_to_schedule(plan, rows, n=cfg.n, ticks=ticks,
                            inject_at=inject_at, heal_at=heal_at, seed=seed)
    return FaultSchedule.from_numpy(
        dict(arrs, target_leader=np.zeros((ticks,), bool),
             crash_campaign=np.zeros((ticks,), bool)), device=device)
