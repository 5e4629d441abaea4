"""Counterexample pipeline: replay, greedy shrinking and seed-pinned JSON
repro artifacts (PyTorch port of the JAX package's dst/repro.py).

A violating schedule index found by `explore()` flows through:

1. `replay()` — re-run the one schedule through the unbatched tick and
   confirm the violation bits + first tick reproduce (exact: everything
   is counter-seeded integer math).
2. `shrink()` — greedy delta-debugging over the schedule arrays: clear
   tick chunks, then whole edges, then whole-row outages and the gates,
   keeping each clearing iff the violation persists.  It returns the
   schedule and the evaluation count the sequential walk gives, but it
   evaluates the walk's candidates speculatively in batches through the
   [B] tick (see there).
3. `to_artifact()`/`save_artifact()` — the shrunk schedule (sparse), the
   SimConfig and the pinned provenance as JSON, in the JAX package's
   format: either package loads and replays the other's artifacts.

`oracle_trace()` drives one schedule through the tick AND the host golden
core (raft/sim/oracle.py) and names the first fields that diverge.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.dst.explore import _tick_one
from swarmkit_tpu_torch.dst.invariants import SAFETY_BITS, bits_to_names
from swarmkit_tpu_torch.dst.schedule import _OPTIONAL_LEAVES, FaultSchedule
from swarmkit_tpu_torch.raft.sim.differential import (
    VIEW_FIELDS, kernel_view,
)
from swarmkit_tpu_torch.raft.sim.state import (
    FIELD_NAMES, SimConfig, SimState, broadcast_state, init_state,
)

ARTIFACT_VERSION = 1

# candidates a speculative shrink batch replays at once (the card's [B]
# tick costs about the same for 8 or 64 clusters: it is launch-bound)
SHRINK_BATCH = 64


# ---------------------------------------------------------------------------
# single-schedule replay


def _replay_final(cfg: SimConfig, schedule: FaultSchedule, prop_count: int,
                  mutation: Optional[str], dev):
    """Run one schedule from the init state, unbatched: (final, viol,
    first) with viol/first as 0-d device tensors."""
    st = init_state(cfg, device=dev)
    viol = torch.zeros((), dtype=torch.int32, device=dev)
    first = torch.full((), -1, dtype=torch.int32, device=dev)
    for t in range(schedule.ticks):
        st, bits = _tick_one(st, cfg, schedule.at_tick(t), prop_count,
                             mutation, dev)
        first = torch.where((first < 0) & (bits != 0), t, first)
        viol = viol | bits
    return st, viol, first


def replay(cfg: SimConfig, schedule: FaultSchedule, prop_count: int = 2,
           mutation: Optional[str] = None, device=None) -> tuple[int, int]:
    """(violation bits, first violating tick or -1) for ONE schedule, on
    `device` (the CUDA card unless the caller names another)."""
    dev = resolve_device(device)
    _, viol, first = _replay_final(cfg, schedule.to(dev), prop_count,
                                   mutation, dev)
    viol, first = torch.stack([viol, first]).tolist()
    return viol, first


# ---------------------------------------------------------------------------
# flight-recorder post-mortem (re-run one schedule with recording on)


def capture_flight(cfg: SimConfig, schedule: FaultSchedule,
                   prop_count: int = 2, mutation: Optional[str] = None, *,
                   first_tick: int = -1, window: int = 40,
                   trigger: str = "dst_violation", obs=None,
                   device=None) -> dict:
    """Re-run ONE schedule, unbatched, with the flight recorder and the
    telemetry plane on, and return the decoded post-mortem: the event
    window leading up to the violation plus the re-run's own verdict.

    The re-run stops right after `first_tick` (when known), so the ring's
    tail holds the ticks that produced the violation.  Recording and
    telemetry only add write-only side buffers, so the trajectory and the
    verdict are the sweep's."""
    from swarmkit_tpu_torch.flightrec import record as flight_record
    from swarmkit_tpu_torch.telemetry import summarize_state

    dev = resolve_device(device)
    rcfg = dataclasses.replace(cfg, record_events=True,
                               event_ring=max(cfg.event_ring, 128),
                               collect_telemetry=True)
    schedule = schedule.to(dev)
    if first_tick >= 0:
        stop = min(int(schedule.ticks), first_tick + 1)
        schedule = schedule._map(lambda a: a[:stop])
    final, viol, first = _replay_final(rcfg, schedule, prop_count, mutation,
                                       dev)
    viol, first = torch.stack([viol, first]).tolist()
    rec = flight_record.capture(
        final, trigger=trigger, obs=obs, cfg=rcfg,
        meta={"mutation": mutation, "prop_count": prop_count,
              "violation_bits": viol, "violations": bits_to_names(viol),
              "first_tick": first})
    return {
        "violation_bits": viol,
        "violations": bits_to_names(viol),
        "first_tick": first,
        "dropped": rec.dropped,
        "window": [e.to_dict() for e in rec.window(window)],
        "telemetry": summarize_state(final, rcfg),
        "record": rec,
    }


# ---------------------------------------------------------------------------
# greedy shrinking


def fault_count(schedule: FaultSchedule) -> int:
    """Total injected fault-events: dropped edge-ticks + downed row-ticks
    + active adversary-gate ticks + attack-verb gate ticks (the shrinker's
    minimization metric)."""
    arrs = schedule.to_numpy()
    verbs = sum(int(arrs[leaf].sum()) for leaf in _OPTIONAL_LEAVES
                if leaf in arrs)
    return (int(arrs["drop"].sum()) + int((~arrs["alive"]).sum())
            + int(arrs["target_leader"].sum())
            + int(arrs["crash_campaign"].sum()) + verbs)


def _clear_ticks(arrs: dict, lo: int, hi: int) -> dict:
    out = {k: v.copy() for k, v in arrs.items()}
    out["drop"][lo:hi] = False
    out["alive"][lo:hi] = True
    out["target_leader"][lo:hi] = False
    out["crash_campaign"][lo:hi] = False
    for leaf in _OPTIONAL_LEAVES:
        if leaf in out:
            out[leaf][lo:hi] = False
    return out


def _shrink_moves(n: int, ticks: int, leaves) -> list:
    """The sequential greedy walk as a fixed list of moves; each move maps
    the current arrays to a candidate, or to None when the walk skips it
    (nothing to clear).  Pass 1: tick windows at halving sizes; pass 2:
    whole directed edges; pass 3: whole-row outages, each verb leaf (per
    row for [T, N] leaves), then the two gates."""
    moves = []
    size = max(1, ticks // 2)
    while size >= 1:
        for lo in range(0, ticks, size):
            hi = min(ticks, lo + size)

            def clear(a, lo=lo, hi=hi):
                cand = _clear_ticks(a, lo, hi)
                changed = any((cand[k] != a[k]).any() for k in a)
                return cand if changed else None
            moves.append(clear)
        if size == 1:
            break
        size //= 2

    def edit(test, apply):
        def move(a):
            if not test(a):
                return None
            cand = {k: v.copy() for k, v in a.items()}
            apply(cand)
            return cand
        return move

    for i in range(n):
        for j in range(n):
            def drop_edge(c, i=i, j=j):
                c["drop"][:, i, j] = False
            moves.append(edit(lambda a, i=i, j=j:
                              a["drop"][:, i, j].any(), drop_edge))
    for r in range(n):
        def revive(c, r=r):
            c["alive"][:, r] = True
        moves.append(edit(lambda a, r=r: (~a["alive"][:, r]).any(),
                          revive))
    for leaf, shape in _OPTIONAL_LEAVES.items():
        if leaf not in leaves:
            continue
        if shape == "TN":
            for r in range(n):
                def clear_row(c, leaf=leaf, r=r):
                    c[leaf][:, r] = False
                moves.append(edit(lambda a, leaf=leaf, r=r:
                                  a[leaf][:, r].any(), clear_row))
        else:
            def clear_leaf(c, leaf=leaf):
                c[leaf][:] = False
            moves.append(edit(lambda a, leaf=leaf: a[leaf].any(),
                              clear_leaf))
    for gate in ("target_leader", "crash_campaign"):
        def clear_gate(c, gate=gate):
            c[gate][:] = False
        moves.append(edit(lambda a, gate=gate: a[gate].any(),
                          clear_gate))
    return moves


def _first_diff(a: dict, b: dict) -> int:
    """The first tick at which two schedules' arrays differ (T: none)."""
    ticks = a["target_leader"].shape[0]
    first = ticks
    for k in a:
        diff = (a[k] != b[k]).reshape(ticks, -1).any(1)
        if diff.any():
            first = min(first, int(diff.argmax()))
    return first


def _pack(st: SimState) -> tuple:
    """A batched state's present fields as one [B, P] matrix per dtype (a
    launch each), in FIELD_NAMES order."""
    groups: dict = {}
    for name in FIELD_NAMES:
        t = getattr(st, name)
        if t is not None:
            groups.setdefault(t.dtype, []).append(t.reshape(t.shape[0], -1))
    return tuple(torch.cat(g, 1) for g in groups.values())


def _unpack(like: SimState, rows: tuple) -> SimState:
    """One cluster's state from one row of each of _pack's matrices,
    shaped as the one-cluster state `like`'s fields (views of the rows)."""
    src: dict = {}
    for name in FIELD_NAMES:
        t = getattr(like, name)
        if t is not None and t.dtype not in src:
            src[t.dtype] = rows[len(src)]
    at = dict.fromkeys(src, 0)
    out = {}
    for name in FIELD_NAMES:
        t = getattr(like, name)
        if t is not None:
            lo = at[t.dtype]
            at[t.dtype] += t.numel()
            out[name] = src[t.dtype][lo:at[t.dtype]].view(t.shape)
    if any(at[d] != src[d].numel() for d in src):
        raise ValueError("packed rows do not hold this state's fields")
    return SimState(**out)


class _Trajectory(NamedTuple):
    """The accepted schedule's run as far as it is known: its packed state
    before each tick 0..known (None: the init state) and the OR of its
    violation bits over the ticks before each, as host ints.  A candidate
    that first differs from that schedule at tick d runs as it did up to
    d."""
    rows: list
    before: list

    def prefix(self, d: int) -> int:
        """The bits a candidate first differing at tick d has before d
        (past the known ticks: at least those of the known ones)."""
        return self.before[min(d, len(self.before) - 1)]

    def upto(self, d: int) -> "_Trajectory":
        return _Trajectory(self.rows[:d + 1], self.before[:d + 1])


def _replay_from(cfg: SimConfig, traj: Optional[_Trajectory], start: int,
                 cands: list, prop_count: int, mutation: Optional[str],
                 dev) -> tuple:
    """Replay candidate arrays as one batch through the [B] tick from tick
    `start`, each from the trajectory's state there (the init state when
    there is none).  Returns (the packed state after each tick, the
    per-tick bits as a host [T - start, B] array)."""
    sched = FaultSchedule.from_numpy(
        {k: np.stack([c[k] for c in cands]) for k in cands[0]}, device=dev)
    one = init_state(cfg, device=dev)
    if traj is not None and traj.rows[start] is not None:
        one = _unpack(one, traj.rows[start])
    st = broadcast_state(one, len(cands))
    packed, bits = [], []
    for t in range(start, sched.ticks):
        st, b = _tick_one(st, cfg, sched.at_tick(t), prop_count, mutation,
                          dev)
        packed.append(_pack(st))
        bits.append(b)
    # the one read-back of the batch
    return packed, torch.stack(bits).to(torch.int64).cpu().numpy()


def _follow(traj: Optional[_Trajectory], start: int, packed: list,
            host: np.ndarray, k: int) -> _Trajectory:
    """The run of row k of a batch replayed from tick `start`."""
    base = traj.upto(start) if traj is not None else _Trajectory([None], [0])
    rows, before = list(base.rows), list(base.before)
    for t, p in enumerate(packed):
        rows.append(tuple(m[k].clone() for m in p))
        before.append(before[-1] | int(host[t, k]))
    return _Trajectory(rows, before)


def shrink(cfg: SimConfig, schedule: FaultSchedule, required_bits: int,
           prop_count: int = 2, mutation: Optional[str] = None, obs=None,
           device=None,
           info: Optional[dict] = None) -> tuple[FaultSchedule, int]:
    """Greedily drop faults while any of `required_bits` still trips.

    Returns (minimal schedule, replay evaluations): the JAX package's
    sequential greedy walk (tick chunks at halving granularity, then
    whole directed edges, then whole-row crash histories and the gates),
    its result and its evaluation count exactly.  The candidates are
    evaluated speculatively: the next SHRINK_BATCH candidates are built as if
    each will be rejected, replayed as one batch through the [B] tick, and
    the first that still fails is accepted (the walk then rebuilds from
    there); the ones after it are discarded, unevaluated as far as the
    walk, its `evals` and the swarm_dst_shrink_rounds_total labels go.

    A batch does not replay the ticks its candidates share with the
    accepted schedule: the run is deterministic, so a candidate that first
    differs from that schedule at tick d runs as it did up to d.  The
    batch starts from the accepted schedule's state at the least such d,
    with its bits up to there, and a candidate whose d lies past a tick at
    which the accepted schedule already tripped `required_bits` fails
    without a replay.  (The first batch starts at tick 0 with the input
    schedule as an extra row, to learn its run.)  `info`, when given,
    receives {"batches", "replayed", "settled", "ticks"}: the batches run,
    the candidates replayed in them, the accepted candidates that needed
    no replay, and the ticks the batches ran.
    """
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.metrics import registry as obs_registry

    dev = resolve_device(device)
    obs = obs or obs_registry.DEFAULT
    m_rounds = catalog.get(obs, "swarm_dst_shrink_rounds_total")
    arrs = schedule.to_numpy()
    moves = _shrink_moves(cfg.n, arrs["target_leader"].shape[0], arrs)
    traj: Optional[_Trajectory] = None
    evals = batches = replayed = settled = ticks = 0
    i = 0
    while i < len(moves):
        cands, at = [], []
        j = i
        while j < len(moves) and len(cands) < SHRINK_BATCH:
            cand = moves[j](arrs)
            if cand is not None:
                cands.append(cand)
                at.append(j)
            j += 1
        if not cands:
            break
        if traj is None:
            firsts = [0] * len(cands)
            sure = len(cands)
        else:
            firsts = [_first_diff(arrs, c) for c in cands]
            # the first candidate that fails on the shared prefix alone
            sure = next((c for c, d in enumerate(firsts)
                         if traj.prefix(d) & required_bits), len(cands))
        k = sure if sure < len(cands) else None
        if sure:
            start = min(firsts[:sure])
            rows = cands[:sure] + ([arrs] if traj is None else [])
            packed, host = _replay_from(cfg, traj, start, rows, prop_count,
                                        mutation, dev)
            batches += 1
            replayed += sure
            ticks += len(packed)
            pre = traj.before[start] if traj is not None else 0
            viol = pre | np.bitwise_or.reduce(host, axis=0)
            hits = [c for c in range(sure) if viol[c] & required_bits]
            if traj is None:
                traj = _follow(None, 0, packed, host, sure)
            if hits:
                k = hits[0]
                traj = _follow(traj, start, packed, host, k)
        if k is None:
            evals += len(cands)
            m_rounds.labels(result="required").inc(len(cands))
            i = j
            continue
        if k == sure:
            # accepted on the prefix: its run is known as far as it is
            # the accepted schedule's
            settled += 1
            traj = traj.upto(firsts[k])
        evals += k + 1
        if k:
            m_rounds.labels(result="required").inc(k)
        m_rounds.labels(result="removed").inc()
        arrs = cands[k]
        i = at[k] + 1
    if info is not None:
        info.update(batches=batches, replayed=replayed, settled=settled,
                    ticks=ticks)
    return FaultSchedule.from_numpy(arrs, device=dev), evals


# ---------------------------------------------------------------------------
# differential-oracle replay (field-level trace)


def oracle_trace(cfg: SimConfig, schedule: FaultSchedule,
                 prop_count: int = 2, mutation: Optional[str] = None,
                 stop_after_first: bool = True,
                 until: Optional[int] = None, device=None,
                 info: Optional[dict] = None) -> dict:
    """Replay one schedule through the tick AND the host golden core
    (raft/sim/oracle.py), comparing every comparable field per tick (the
    `run_differential` protocol of the JAX package).

    The state-conditioned gates are resolved against the TICK's pre-step
    roles on the host, and the realized (alive, drop) arrays feed both
    sides, so a mutated (or genuinely buggy) tick diverges from the
    correct oracle at a deterministic tick; the returned trace names the
    first differing fields with both sides' values.

    `until` bounds the comparison to ticks t < until.  Callers replaying
    an adversary-induced SAFETY violation pass the first violating tick:
    past it the tick is in a state correct raft cannot represent (e.g.
    two leaders in one term after vote_equivocation), so the two sides'
    resolutions of the impossible state are incomparable by construction.

    The tick runs unbatched on `device` (the CUDA card unless the caller
    names another).  It is a host replay: the compared fields come back
    in one read a tick, plus one of the initial state; the pre-step roles
    and votes of a tick are the previous read's (no verb changes them
    before the gates read them).  `info`, when given, receives the ticks
    replayed and the reads made.
    """
    from swarmkit_tpu_torch.dst.explore import apply_mutation
    from swarmkit_tpu_torch.dst.schedule import (
        _flood_payload, apply_append_flood, apply_disk_stall,
        apply_lost_tail, apply_snap_corrupt, apply_torn_write,
        apply_transfer_abuse,
    )
    from swarmkit_tpu_torch.raft.sim.kernel import propose, step
    from swarmkit_tpu_torch.raft.sim.oracle import OracleCluster
    from swarmkit_tpu_torch.raft.sim.state import CANDIDATE, LEADER, NONE

    dev = resolve_device(device)
    state = init_state(cfg, device=dev)
    oracle = OracleCluster(cfg)
    n = cfg.n
    arrs = schedule.to_numpy()
    drop_s, alive_s = arrs["drop"], arrs["alive"]
    tl_s, cc_s = arrs["target_leader"], arrs["crash_campaign"]
    ti_s = arrs.get("term_inflate")
    rj_s = arrs.get("rejoin_campaign")
    eq_s = arrs.get("vote_equivocate")
    fl_s = arrs.get("append_flood")
    tx_s = arrs.get("transfer_abuse")
    storage_verbs = {"disk_stall": apply_disk_stall,
                     "snap_corrupt": apply_snap_corrupt,
                     "lost_tail": apply_lost_tail,
                     "torn_write": apply_torn_write}

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    trace: list[dict] = []
    diverged_at = -1
    kv = kernel_view(state)
    reads = 1
    stop = schedule.ticks if until is None else min(until, schedule.ticks)
    t = -1
    for t in range(stop):
        role = kv["role"]
        leaders = role == LEADER
        drop = drop_s[t] | (tl_s[t] & (leaders[:, None] | leaders[None, :]))
        alive = alive_s[t] & ~(cc_s[t] & (role == CANDIDATE))
        alive_d = on_dev(alive)
        # the forced campaign, resolved against the tick's pre-step roles
        # and mirrored on both sides (elapsed := timeout on the oracle's
        # scheduler); term_inflate and rejoin_campaign share the transform
        force = np.zeros(n, bool)
        if ti_s is not None:
            force |= ti_s[t]
        if rj_s is not None:
            force |= rj_s[t]
        force &= alive & (role != LEADER)
        if force.any():
            state = dataclasses.replace(state, elapsed=torch.where(
                on_dev(force), torch.maximum(state.elapsed, state.timeout),
                state.elapsed))
            for i in range(n):
                if force[i]:
                    oracle.elapsed[i] = max(oracle.elapsed[i],
                                            oracle.timeout[i])
        if eq_s is not None and eq_s[t].any():
            # adversarial vote wipe against the pre-step votes; core's
            # vote is 1-based (0 = none)
            wipe = eq_s[t] & alive & (kv["vote"] != NONE)
            if wipe.any():
                state = dataclasses.replace(state, vote=torch.where(
                    on_dev(wipe), NONE, state.vote))
                for i in range(n):
                    if wipe[i]:
                        oracle.nodes[i].vote = 0
        if tx_s is not None and tx_s[t].any():
            # the oracle mirror holds with the cooldown off (how the
            # differential sweeps run); repeats are no-ops on both sides
            tgt = int(np.argmax(tx_s[t]))
            state = apply_transfer_abuse(state, cfg, on_dev(tx_s[t]),
                                         alive_d)
            for i in range(n):
                if leaders[i] and alive[i] and i != tgt:
                    oracle.transfer(i, tgt)
        if fl_s is not None and fl_s[t]:
            # cfg.max_props dense proposals on every accepting leader; the
            # oracle replays the same payloads (computed on the host)
            cnt = cfg.max_props
            fl_pl = _flood_payload(t, torch.arange(cnt, dtype=torch.int64)
                                   ).numpy().view(np.uint32)
            state = apply_append_flood(state, cfg, on_dev(fl_s[t]), alive_d)
            oracle._phase_propose(alive, fl_pl, cnt)
        # storage verbs on the tick's side only: the oracle's disk is
        # perfect, so a compared range stops before the first one fires
        # (replay_artifact's SAFETY_BITS `until`)
        if state.sync_mark is not None:
            for leaf, verb in storage_verbs.items():
                if leaf in arrs and arrs[leaf][t].any():
                    state = verb(state, on_dev(arrs[leaf][t]), alive_d)

        payloads = np.zeros(cfg.max_props, np.uint32)
        if prop_count:
            k = np.arange(prop_count, dtype=np.uint32)
            payloads[:prop_count] = \
                (np.uint32(t) * np.uint32(1 << 16) + k + np.uint32(1)) \
                & np.uint32(0x7FFFFFFF)
            state = propose(state, cfg, payloads, prop_count, alive=alive_d,
                            device=dev)
        state = step(state, cfg, alive=alive_d, drop=on_dev(drop),
                     device=dev)
        state = apply_mutation(state, cfg, mutation)
        oracle.tick(alive, drop, payloads, prop_count)
        kv = kernel_view(state)
        reads += 1
        ov = oracle.view()
        diffs = [f for f in VIEW_FIELDS
                 if not np.array_equal(kv[f], getattr(ov, f))]
        if diffs:
            if diverged_at < 0:
                diverged_at = t
            trace.append({
                "tick": t,
                "fields": diffs,
                "kernel": {f: kv[f].tolist() for f in diffs},
                "oracle": {f: np.asarray(getattr(ov, f)).tolist()
                           for f in diffs},
            })
            if stop_after_first:
                break
    if info is not None:
        info.update(ticks=t + 1, reads=reads)
    return {"diverged_at": diverged_at, "trace": trace}


# ---------------------------------------------------------------------------
# JSON artifacts (the JAX package's format, both ways)


def to_artifact(cfg: SimConfig, schedule: FaultSchedule, *, seed: int,
                profile: str, index: int, prop_count: int,
                mutation: Optional[str], viol: int,
                first_tick: int, flight: Optional[dict] = None) -> dict:
    """Sparse JSON form of one (usually shrunk) repro schedule; with
    `flight` (see :func:`capture_flight`) its decoded event window rides
    along."""
    arrs = schedule.to_numpy()
    t, i, j = np.nonzero(arrs["drop"])
    dt, dr = np.nonzero(~arrs["alive"])
    art = {
        "version": ARTIFACT_VERSION,
        "seed": seed,
        "profile": profile,
        "index": index,
        "cfg": dataclasses.asdict(cfg),
        "ticks": int(schedule.ticks),
        "prop_count": prop_count,
        "mutation": mutation,
        "violation_bits": viol,
        "violations": bits_to_names(viol),
        "first_tick": first_tick,
        "fault_count": fault_count(schedule),
        "faults": {
            "drop": np.stack([t, i, j], axis=1).tolist(),
            "down": np.stack([dt, dr], axis=1).tolist(),
            "target_leader": np.nonzero(arrs["target_leader"])[0].tolist(),
            "crash_campaign":
                np.nonzero(arrs["crash_campaign"])[0].tolist(),
        },
    }
    # verb leaves go in sparse (an absent leaf is an absent key)
    for leaf, shape in _OPTIONAL_LEAVES.items():
        if leaf not in arrs:
            continue
        if shape == "TN":
            it, ir = np.nonzero(arrs[leaf])
            art["faults"][leaf] = np.stack([it, ir], axis=1).tolist()
        else:
            art["faults"][leaf] = np.nonzero(arrs[leaf])[0].tolist()
    if flight is not None:
        art["flight"] = {
            "window": flight.get("window", []),
            "dropped": flight.get("dropped", []),
            "first_tick": flight.get("first_tick", -1),
            "violations": flight.get("violations", []),
            "telemetry": flight.get("telemetry", {}),
        }
    return art


def from_artifact(art: dict, device=None):
    """(cfg, schedule, prop_count, mutation) reconstructed from JSON, the
    schedule on `device` (the CUDA card unless the caller names another)."""
    if art.get("version") != ARTIFACT_VERSION:
        raise ValueError(f"unsupported artifact version {art.get('version')}")
    cfg = SimConfig(**art["cfg"])
    ticks, n = art["ticks"], cfg.n
    arrs = {"drop": np.zeros((ticks, n, n), bool),
            "alive": np.ones((ticks, n), bool),
            "target_leader": np.zeros(ticks, bool),
            "crash_campaign": np.zeros(ticks, bool)}
    for t, i, j in art["faults"]["drop"]:
        arrs["drop"][t, i, j] = True
    for t, r in art["faults"]["down"]:
        arrs["alive"][t, r] = False
    arrs["target_leader"][art["faults"]["target_leader"]] = True
    arrs["crash_campaign"][art["faults"]["crash_campaign"]] = True
    for leaf, shape in _OPTIONAL_LEAVES.items():
        if leaf not in art["faults"]:
            continue
        if shape == "TN":
            m = np.zeros((ticks, n), bool)
            for t, r in art["faults"][leaf]:
                m[t, r] = True
        else:
            m = np.zeros((ticks,), bool)
            m[art["faults"][leaf]] = True
        arrs[leaf] = m
    return (cfg, FaultSchedule.from_numpy(arrs, device=device),
            art["prop_count"], art["mutation"])


def save_artifact(path: str, art: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(art, f, indent=1, sort_keys=True)


def load_artifact(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def replay_artifact(art, with_trace: bool = True, device=None) -> dict:
    """Re-run an artifact (a dict or a path): the recorded violation must
    reproduce exactly (bits AND first tick).  Returns the verdict and,
    with `with_trace`, the oracle trace (`out["oracle"]`)."""
    if isinstance(art, str):
        art = load_artifact(art)
    cfg, schedule, prop_count, mutation = from_artifact(art, device=device)
    viol, first = replay(cfg, schedule, prop_count, mutation,
                         device=schedule.drop.device)
    out = {
        "violation_bits": viol,
        "violations": bits_to_names(viol),
        "first_tick": first,
        "matches_recorded": (viol == art["violation_bits"]
                             and first == art["first_tick"]),
    }
    if with_trace:
        # adversary-induced safety violations (no mutation) put the tick
        # into spec-unrepresentable territory at the violation tick:
        # compare the oracle only over the clean prefix there.  Mutation
        # artifacts keep the full trace: the divergence IS the diagnostic
        # localizing the injected bug.
        until = (first if mutation is None and (viol & SAFETY_BITS)
                 and first >= 0 else None)
        out["oracle"] = oracle_trace(cfg, schedule, prop_count, mutation,
                                     until=until,
                                     device=schedule.drop.device)
    return out
