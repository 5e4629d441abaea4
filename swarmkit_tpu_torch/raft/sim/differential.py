"""The differential gate: the tick against the host golden core, tick by
tick (PyTorch port of the JAX package's `run_differential` test harness).

The tick (raft/sim/kernel.py) and the host golden core
(raft/sim/oracle.py's `OracleCluster`, over the copied etcd/raft core) are
driven with IDENTICAL timeout/drop/crash/proposal/transfer/membership
schedules and compared after every tick, field by field: term, vote,
role, lead, last, commit, applied, apply_chk (the applied-log-content
checksum) and member.  The schedule is drawn from one
``np.random.default_rng(seed)`` in the JAX harness's order, draw for
draw, so a seed names the same schedule in both packages.

`kernel_view` is the one host view of the compared fields; the DST
oracle replay (dst/repro.py::oracle_trace) reads the tick through it too.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.raft.sim import kernel
from swarmkit_tpu_torch.raft.sim.kernel import (
    propose, propose_conf, read_many, step, transfer_leadership,
)
from swarmkit_tpu_torch.raft.sim.oracle import OracleCluster
from swarmkit_tpu_torch.raft.sim.state import (
    LEADER, SimConfig, SimState, init_state,
)

VIEW_FIELDS = ("term", "vote", "role", "lead", "last", "commit", "applied",
               "apply_chk", "member")


def kernel_view(state: SimState) -> dict:
    """The compared fields on the host, in the JAX package's dtypes, in
    one device->host read."""
    out = dict(zip(VIEW_FIELDS, read_many(
        [getattr(state, f) for f in VIEW_FIELDS])))
    for f, a in out.items():
        if f == "member":
            out[f] = a.astype(bool)
        elif f == "apply_chk":
            out[f] = (a & 0xFFFFFFFF).astype(np.uint32)
        else:
            out[f] = a.astype(np.int32)
    return out


def _add(info: Optional[dict], **kw) -> None:
    if info is not None:
        for k, v in kw.items():
            info[k] = info.get(k, 0) + v


def run_differential(cfg: SimConfig, n_ticks: int, seed: int,
                     drop_rate: float = 0.0, crash_prob: float = 0.0,
                     prop_prob: float = 0.5, partition_at: tuple = (),
                     crash_leader_every: int = 0,
                     transfer_every: int = 0,
                     conf_every: int = 0, voters=None,
                     min_members: int = 3,
                     remove_leader_every: int = 0,
                     sleep_node: tuple = (), device=None,
                     info: Optional[dict] = None) -> dict:
    """Drive the tick and the golden core on one random schedule; raise
    AssertionError naming the seed, tick and field at the first
    difference.  Returns {"max_commit", "max_term"} so callers can assert
    progress.  The tick runs on `device` (the CUDA card unless the caller
    names another).

    conf_every: every k ticks propose ONE membership change through the
    replicated log (propose_conf / the oracle's CONF_CHANGE entry) — a
    remove of a random non-leader member while the intended config stays
    above `min_members`, else a re-add of a previously removed row.

    remove_leader_every: every k ticks the SITTING LEADER proposes its own
    removal; the shell then stops the removed process 8 ticks later
    (swarmkit removeMember -> node shutdown) so the survivors elect.

    sleep_node: (row, start, wake) — force ONE follower down through the
    compaction window so it returns far enough behind that only the
    snapshot path can catch it up.

    Each tick copies `alive` and `drop` to the device once and reads the
    compared fields back once (`kernel_view`).  The leader lookups of the
    crash-leader, transfer and membership schedules read the roles of the
    previous tick's view: no host call before them changes a role.

    `info`, when given, accumulates across calls: ticks, reads (views),
    step_syncs (the tick's own read-backs, kernel.COUNTS), and the host
    seconds of the schedule draw (draw_s), the tick and its host calls
    (tick_s, enqueue only: the tick is not synchronized), the oracle
    (oracle_s) and the view read, which waits for the tick (view_s).
    """
    dev = resolve_device(device)
    clock = time.perf_counter
    rng = np.random.default_rng(seed)
    n = cfg.n
    state = init_state(cfg, voters=voters, device=dev)
    oracle = OracleCluster(cfg, voters=voters)
    syncs0 = kernel.COUNTS["host_syncs"]

    alive = np.ones(n, bool)
    down_until = np.zeros(n, np.int64)
    # intended config for picking conf targets (actual membership follows
    # the committed log; this is only the scheduler's bookkeeping)
    intended = set(range(n) if voters is None else voters)
    removed = set(range(n)) - intended
    stop_at: dict = {}   # node -> tick of permanent shell stop
    t0 = clock()
    kv = kernel_view(state)
    reads, view_s = 1, clock() - t0
    draw_s = tick_s = oracle_s = 0.0

    for t in range(n_ticks):
        t0 = clock()
        # -- crash schedule
        alive = down_until <= t
        for v, at in stop_at.items():
            if t >= at:
                alive[v] = False
        if crash_prob and rng.random() < crash_prob:
            victim = int(rng.integers(n))
            down_until[victim] = t + int(rng.integers(3, 25))
            alive[victim] = False
        if sleep_node and t == sleep_node[1]:
            down_until[sleep_node[0]] = sleep_node[2]
            alive[sleep_node[0]] = False
        if crash_leader_every and t > 0 and t % crash_leader_every == 0:
            leaders = np.nonzero((kv["role"] == LEADER) & alive)[0]
            if len(leaders):
                victim = int(leaders[0])
                down_until[victim] = t + int(rng.integers(5, 20))
                alive[victim] = False

        # -- drop schedule (per-edge Bernoulli + optional block partition)
        drop = rng.random((n, n)) < drop_rate if drop_rate else np.zeros(
            (n, n), bool)
        if partition_at:
            start, end, cut = partition_at
            if start <= t < end:
                side = np.arange(n) < cut
                drop = drop | (side[:, None] != side[None, :])

        # -- leader-transfer schedule: ask the sitting leader to hand off
        transfer = None
        if transfer_every and t > 0 and t % transfer_every == 0:
            leaders = np.nonzero((kv["role"] == LEADER) & alive)[0]
            if len(leaders):
                transfer = (int(leaders[0]), int(rng.integers(n)))

        # -- proposal schedule
        prop_count = 0
        payloads = np.zeros(cfg.max_props, np.uint32)
        if prop_prob and rng.random() < prop_prob:
            prop_count = int(rng.integers(1, cfg.max_props + 1))
            payloads[:prop_count] = rng.integers(
                1, 1 << 31, prop_count, dtype=np.uint32)

        # -- membership-change schedule (log-driven conf proposals)
        conf = None
        if remove_leader_every and t > 0 and t % remove_leader_every == 0 \
                and len(intended) > min_members:
            leaders = np.nonzero((kv["role"] == LEADER) & alive)[0]
            lset = [int(x) for x in leaders if int(x) in intended]
            if lset:
                tgt = lset[0]
                conf = (tgt, True)
                intended.discard(tgt)
                removed.add(tgt)
                # shell stops the removed process after a grace window
                # (the entry must replicate first)
                stop_at[tgt] = t + 8
        if conf is None and conf_every and t > 0 and t % conf_every == 0:
            leaders = set(np.nonzero((kv["role"] == LEADER)
                                     & alive)[0].tolist())
            if removed and (len(intended) <= min_members
                            or rng.random() < 0.5):
                tgt = int(rng.choice(sorted(removed)))
                conf = (tgt, False)
                removed.discard(tgt)
                intended.add(tgt)
            else:
                cands = sorted(intended - leaders)
                if len(intended) > min_members and cands:
                    tgt = int(rng.choice(cands))
                    conf = (tgt, True)
                    intended.discard(tgt)
                    removed.add(tgt)
        t1 = clock()

        # -- advance both sides with the identical schedule (proposals
        # consult liveness: clients cannot reach a crashed claimant)
        alive_d = torch.from_numpy(alive).to(dev)
        drop_d = torch.from_numpy(drop).to(dev)
        if transfer is not None:
            state = transfer_leadership(state, cfg, *transfer)
        if prop_count:
            state = propose(state, cfg, payloads, prop_count, alive=alive_d,
                            device=dev)
        if conf is not None:
            state = propose_conf(state, cfg, conf[0], conf[1],
                                 alive=alive_d, device=dev)
        state = step(state, cfg, alive=alive_d, drop=drop_d, device=dev)
        t2 = clock()
        if transfer is not None:
            oracle.transfer(*transfer)
        oracle.tick(alive, drop, payloads, prop_count, conf)
        ov = oracle.view()
        t3 = clock()
        kv = kernel_view(state)
        reads += 1
        t4 = clock()
        draw_s += t1 - t0
        tick_s += t2 - t1
        oracle_s += t3 - t2
        view_s += t4 - t3

        for f in VIEW_FIELDS:
            ke, oe = kv[f], getattr(ov, f)
            if not np.array_equal(ke, oe):
                raise AssertionError(
                    f"seed={seed} tick={t} field={f}\n"
                    f"  kernel: {ke}\n  oracle: {oe}\n"
                    f"  terms k/o: {kv['term']}/{ov.term}\n"
                    f"  roles k/o: {kv['role']}/{ov.role}")
        _add(info, ticks=1)

    _add(info, reads=reads,
         step_syncs=kernel.COUNTS["host_syncs"] - syncs0, draw_s=draw_s,
         tick_s=tick_s, oracle_s=oracle_s, view_s=view_s)
    return {"max_commit": int(kv["commit"].max()),
            "max_term": int(kv["term"].max())}
