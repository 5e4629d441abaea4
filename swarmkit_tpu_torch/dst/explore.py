"""Batched schedule exploration: S clusters through the [B] tick
(PyTorch port of the JAX package's dst/explore.py).

`explore()` broadcasts one init state across a leading schedule axis S and
advances all S clusters with the batch-native tick (kernel.step on a
batched state), each under its own `FaultSchedule`.  Where the JAX package
compiles one scan of a vmap, the port runs a host loop over T: per tick
the verbs, the [S] tick, the mutation and the checkers, all on the device.
The violation mask `viol` [S] and the per-tick masks `bits_by_tick`
[T, S] stay on the device and come back in one read at the end, so a
sweep tick makes no host sync.

With `shard` (the default, as in the JAX package) the S schedules split
over a schedule mesh (parallel.schedule_mesh: every local card, or the
devices a caller names with `mesh=`), one shard an entry; each tick is
issued on every shard before the next, each shard is read back once, and
viol, first_tick and bits_by_tick come back in schedule order.  The
clusters are independent, so the sharded run gives the unsharded bits.

The `mutation` knob runs a DELIBERATELY broken kernel variant (e.g.
``commit_no_quorum``) — the detection self-test: the checkers must catch
it and the repro pipeline must shrink it (tools/dst_sweep.py --mutate).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from swarmkit_tpu_torch import parallel
from swarmkit_tpu_torch.dst.invariants import (
    ALL_BITS, BIT_NAMES, check_state, check_transition,
)
from swarmkit_tpu_torch.dst.schedule import (
    ATTACK_LEAVES, STORAGE_LEAVES, FaultSchedule, apply_append_flood,
    apply_disk_stall, apply_lost_tail, apply_rejoin_campaign,
    apply_snap_corrupt, apply_term_inflation, apply_torn_write,
    apply_transfer_abuse, apply_vote_equivocation, effective_faults,
)
from swarmkit_tpu_torch.raft.sim.kernel import step
from swarmkit_tpu_torch.raft.sim.run import _payload_at
from swarmkit_tpu_torch.raft.sim.state import (
    LEADER, SimConfig, SimState, batch_size, broadcast_state, check_device,
)

I32 = torch.int32

MUTATIONS = ("commit_no_quorum", "stale_lease_read")

__all__ = ["MUTATIONS", "ExploreResult", "apply_mutation", "broadcast_state",
           "explore", "postmortem"]


def apply_mutation(state: SimState, cfg: SimConfig,
                   mutation: Optional[str]) -> SimState:
    """Post-step state corruption implementing a named kernel bug."""
    if mutation is None:
        return state
    if mutation == "commit_no_quorum":
        # a leader commits its whole log without waiting for a quorum of
        # match acks: invisible while messages flow, fatal once a minority
        # leader keeps accepting proposals behind a partition
        leaders = state.role == LEADER
        commit = torch.where(leaders, torch.maximum(state.commit,
                                                    state.last),
                             state.commit)
        return dataclasses.replace(state, commit=commit)
    if mutation == "stale_lease_read":
        # leases force-disabled: any row still claiming leadership serves
        # its pending read batch at its own applied index, skipping every
        # gate; a partitioned stale leader trips LINEARIZABLE_READ
        if state.read_pend is None:
            raise ValueError("stale_lease_read requires cfg.read_batch > 0")
        leaders = state.role == LEADER
        serve = leaders & (state.read_pend > 0)
        return dataclasses.replace(
            state,
            read_srv=state.read_srv + torch.where(serve, state.read_pend, 0),
            read_srv_idx=torch.where(serve, state.applied,
                                     state.read_srv_idx),
            read_srv_goal=torch.where(serve, state.read_goal,
                                      state.read_srv_goal),
            read_pend=torch.where(serve, 0, state.read_pend),
            read_idx=torch.where(serve, -1, state.read_idx))
    raise KeyError(f"unknown mutation {mutation!r}; known: {MUTATIONS}")


class _Prev(NamedTuple):
    """What check_transition reads of the pre-step state: step consumes
    the rings, so the loop keeps these three instead of a copy."""
    commit: torch.Tensor
    applied: torch.Tensor
    dur_commit: Optional[torch.Tensor]


def _tick_one(st: SimState, cfg: SimConfig, sched_t: FaultSchedule,
              prop_count: int, mutation: Optional[str], device=None):
    """Advance one cluster, or each cluster of a batched state, one tick
    under its schedule slice (one tick's leaves, [S, ...] when batched);
    returns the new state and this tick's violation bits (0-d or [S])."""
    alive, drop = effective_faults(st.role, sched_t.drop, sched_t.alive,
                                   sched_t.target_leader,
                                   sched_t.crash_campaign)
    # protocol-speaking adversary verbs, in schedule.py's composition order
    if sched_t.term_inflate is not None:
        st = apply_term_inflation(st, sched_t.term_inflate, alive)
    if sched_t.rejoin_campaign is not None:
        st = apply_rejoin_campaign(st, sched_t.rejoin_campaign, alive)
    if sched_t.vote_equivocate is not None:
        st = apply_vote_equivocation(st, sched_t.vote_equivocate, alive)
    if sched_t.transfer_abuse is not None:
        st = apply_transfer_abuse(st, cfg, sched_t.transfer_abuse, alive)
    if sched_t.append_flood is not None:
        st = apply_append_flood(st, cfg, sched_t.append_flood, alive)
    # storage-fault verbs (no-ops on a storage-off state); lost_tail and
    # torn_write legally regress volatile commit/applied, so their rows
    # are excused from COMMIT_MONOTONIC for exactly this transition
    recovering = None
    if st.sync_mark is not None:
        if sched_t.disk_stall is not None:
            st = apply_disk_stall(st, sched_t.disk_stall, alive)
        if sched_t.snap_corrupt is not None:
            st = apply_snap_corrupt(st, sched_t.snap_corrupt, alive)
        if sched_t.lost_tail is not None:
            st = apply_lost_tail(st, sched_t.lost_tail, alive)
            recovering = sched_t.lost_tail
        if sched_t.torn_write is not None:
            st = apply_torn_write(st, sched_t.torn_write, alive)
            recovering = sched_t.torn_write if recovering is None \
                else recovering | sched_t.torn_write
    prev = _Prev(st.commit, st.applied, st.dur_commit)
    if prop_count:
        new = step(st, cfg, alive=alive, drop=drop, prop_count=prop_count,
                   payload_fn=_payload_at, device=device)
    else:
        new = step(st, cfg, alive=alive, drop=drop, device=device)
    new = apply_mutation(new, cfg, mutation)
    return new, check_state(new, cfg) | check_transition(prev, new,
                                                         recovering)


def _first_tick(bits_by_tick: torch.Tensor) -> torch.Tensor:
    """[S] first tick with a nonzero mask, -1 where there is none."""
    any_t = (bits_by_tick != 0).to(I32)
    return torch.where(any_t.any(0), any_t.argmax(0).to(I32), -1)


def _run_shards(states: list, cfg: SimConfig, schedules: list,
                prop_count: int, mutation: Optional[str], devices: list):
    """The explore loop on the device, over shards of the schedule axis
    (one shard when unsharded): each tick is issued on every shard before
    the next tick, so shards on different cards overlap.  Returns, per
    shard, (final, viol [S_i], bits [T, S_i])."""
    viol, bits_by_tick = [], []
    for st, sc in zip(states, schedules):
        s_count, ticks = sc.target_leader.shape
        dev = st.term.device
        viol.append(torch.zeros((s_count,), dtype=I32, device=dev))
        bits_by_tick.append(torch.zeros((ticks, s_count), dtype=I32,
                                        device=dev))
    sts = list(states)
    for t in range(schedules[0].ticks):
        for i, (sc, dev) in enumerate(zip(schedules, devices)):
            sts[i], bits = _tick_one(sts[i], cfg, sc.at_tick(t), prop_count,
                                     mutation, dev)
            viol[i] = viol[i] | bits
            bits_by_tick[i][t] = bits
    return sts, viol, bits_by_tick


def _run_batch(batched: SimState, cfg: SimConfig, schedule: FaultSchedule,
               prop_count: int, mutation: Optional[str], device):
    """The explore loop on one device: (final, viol [S], bits [T, S])."""
    (st,), (viol,), (bits,) = _run_shards([batched], cfg, [schedule],
                                          prop_count, mutation, [device])
    return st, viol, bits


def _schedule_shards(state: SimState, schedule: FaultSchedule, dev,
                     shard: bool, mesh) -> tuple:
    """(per-shard batched init states, per-shard schedules, devices): the
    broadcast state and the [S, T, ...] schedule split over `mesh`
    (default: schedule_mesh(S) over the local devices of dev's type), or
    one shard on dev when `shard` is off or the mesh has one entry."""
    s_count = schedule.target_leader.shape[0]
    if shard and mesh is None:
        mesh = parallel.schedule_mesh(s_count, parallel.local_devices(dev))
    if not shard or mesh.size == 1:
        return [broadcast_state(state, s_count)], [schedule], [dev]
    devices = mesh.device_list()
    if s_count % len(devices) or any(torch.device(d).type != dev.type
                                     for d in devices):
        raise ValueError(f"a mesh of {len(devices)} {devices} cannot split "
                         f"{s_count} schedules on {dev}")
    per = s_count // len(devices)
    states = [broadcast_state(parallel.tree_map(lambda t, d=d: t.to(d),
                                                state), per)
              for d in devices]
    return (states, parallel.shard_rows(schedule, mesh,
                                        axis=parallel.SCHEDULE_AXIS).shards,
            devices)


@dataclass
class ExploreResult:
    viol: np.ndarray          # [S] uint32 violation bitmasks
    first_tick: np.ndarray    # [S] int32 first violating tick, -1 = clean
    bits_by_tick: np.ndarray  # [T, S] per-tick uint32 bitmasks
    final_state: SimState     # batched [S, ...] on the device
    profiles: list            # profile name per schedule index (may be [])
    elapsed: float
    schedules_per_sec: float

    @property
    def violating(self) -> np.ndarray:
        return np.nonzero(self.viol)[0]


def postmortem(result: ExploreResult, cfg: SimConfig,
               schedule: FaultSchedule, prop_count: int = 2,
               mutation: Optional[str] = None, window: int = 40,
               limit: int = 4, obs=None, device=None) -> dict:
    """Flight-record the violating schedules of an explore batch: each
    violating index (up to `limit`) re-runs alone with the recorder on,
    stopping right after its first violating tick; returns {index:
    capture dict} (see :func:`swarmkit_tpu_torch.dst.repro.capture_flight`).
    """
    from swarmkit_tpu_torch.dst import repro  # late: repro imports this

    out: dict[int, dict] = {}
    for idx in result.violating[:limit]:
        idx = int(idx)
        out[idx] = repro.capture_flight(
            cfg, schedule.slice(idx), prop_count, mutation,
            first_tick=int(result.first_tick[idx]), window=window,
            trigger="dst_violation", obs=obs, device=device)
    return out


def explore(state: SimState, cfg: SimConfig, schedule: FaultSchedule,
            profiles=(), prop_count: int = 2,
            mutation: Optional[str] = None, shard: bool = True,
            mesh: Optional[parallel.Mesh] = None, obs=None,
            device=None) -> ExploreResult:
    """Run every schedule in the batch to completion and check invariants.

    `state` is ONE cluster's init state (copied S times); `schedule` is an
    [S, T, ...] batch from `schedule.make_batch`, on the state's device.
    Runs on `device` (the CUDA card unless the caller names another).
    With `shard` the schedules split over `mesh` (default: schedule_mesh(S)
    over every local card; the CPU once), one shard an entry, and the
    results come back in schedule order; a one-entry mesh is the unsharded
    run.  The final state is gathered onto `device`.
    """
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.metrics import registry as obs_registry

    dev = check_device(state, device)
    if batch_size(state) is not None:
        raise ValueError("explore takes one cluster's init state")
    s_count = schedule.target_leader.shape[0]
    ticks = schedule.ticks
    gates = {attack: getattr(schedule, leaf) for attack, leaf in
             {**ATTACK_LEAVES, **STORAGE_LEAVES}.items()
             if getattr(schedule, leaf) is not None}
    states, schedules, devices = _schedule_shards(state, schedule, dev,
                                                  shard, mesh)

    t0 = time.monotonic()
    finals, viols, bitss = _run_shards(states, cfg, schedules, prop_count,
                                       mutation, devices)
    fired = [g.sum(dtype=torch.int64).reshape(1) for g in gates.values()]
    # one read-back per shard, in schedule order
    viol_h, first_h, bits_h = [], [], []
    for i, (viol, bits) in enumerate(zip(viols, bitss)):
        s_i = viol.shape[0]
        host = torch.cat([viol.to(torch.int64),
                          _first_tick(bits).to(torch.int64),
                          bits.reshape(-1).to(torch.int64)]
                         + (fired if i == 0 else [])).cpu().numpy()
        viol_h.append(host[:s_i].astype(np.uint32))
        first_h.append(host[s_i:2 * s_i].astype(np.int32))
        bits_h.append(host[2 * s_i:2 * s_i + ticks * s_i]
                      .reshape(ticks, s_i).astype(np.uint32))
        if i == 0:
            fired_h = host[2 * s_i + ticks * s_i:]
    elapsed = time.monotonic() - t0
    rate = s_count / elapsed if elapsed > 0 else float("inf")
    viol_h = np.concatenate(viol_h)
    first_h = np.concatenate(first_h)
    bits_h = np.concatenate(bits_h, axis=1)
    final = finals[0] if len(finals) == 1 else parallel.tree_map(
        lambda *xs: torch.cat([x.to(dev) for x in xs]), *finals)

    obs = obs or obs_registry.DEFAULT
    m_sched = catalog.get(obs, "swarm_dst_schedules_total")
    m_viol = catalog.get(obs, "swarm_dst_violations_total")
    m_rate = catalog.get(obs, "swarm_dst_schedules_per_second")
    m_att = catalog.get(obs, "swarm_dst_attack_ticks_total")
    clean = int((viol_h == 0).sum())
    if clean:
        m_sched.labels(result="clean").inc(clean)
    if s_count - clean:
        m_sched.labels(result="violation").inc(s_count - clean)
    for bit in ALL_BITS:
        hits = int(((viol_h & bit) != 0).sum())
        if hits:
            m_viol.labels(invariant=BIT_NAMES[bit]).inc(hits)
    m_rate.labels(config=f"n{cfg.n}x{ticks}t").set(rate)
    for attack, count in zip(gates, fired_h):
        if count:
            m_att.labels(attack=attack).inc(int(count))

    return ExploreResult(viol=viol_h, first_tick=first_h,
                         bits_by_tick=bits_h, final_state=final,
                         profiles=list(profiles), elapsed=elapsed,
                         schedules_per_sec=rate)
