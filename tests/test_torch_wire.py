"""The mailbox wire on the port against the JAX package, tick by tick.

The port's `step` and the JAX package's run in lockstep on the CPU from
one seeded numpy schedule, the generator of run_differential
(tests/test_raft_sim_differential.py): per-edge drops, crashes, block
partitions, leader crash cycles, leader transfers, host proposals and
conf changes.  Every SimState field (the mailbox slots included) must be
equal on every tick: all raft state is integer, so the tolerance is exact.
For a few seeds the port is also held to the host golden core
(OracleCluster) on the differential's fields.

The configurations are the differential suite's own mailbox ones
(latency, jitter, forced slots at latency 0, a 4-deep pipeline with
PreVote) and TestSparseProgress's mailbox combo (n=16, the [8, N] slab),
untiled and tiled, with a storm window so the dense fallback runs too.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu.raft.sim.oracle import OracleCluster
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import CPU, assert_same, t_bool

_jstep = jax.jit(jkernel.step, static_argnames=("cfg",))
_jstep_fused = jax.jit(
    lambda st, cfg, alive, drop, cnt: jkernel.step(
        st, cfg, alive=alive, drop=drop, prop_count=cnt,
        payload_fn=jrun._payload_at),
    static_argnames=("cfg",))
_jpropose = jax.jit(jkernel.propose, static_argnames=("cfg",))
_jpropose_conf = jax.jit(jkernel.propose_conf, static_argnames=("cfg",))

SMALL = dict(log_len=64, window=8, apply_batch=16, max_props=8, keep=4)
CFG3_LAT = dict(SMALL, n=3, election_tick=12, seed=501, latency=1)
CFG5_JIT = dict(SMALL, n=5, election_tick=16, seed=503, latency=1,
                latency_jitter=2)
CFG3_SYNC_BOX = dict(SMALL, n=3, election_tick=10, seed=505,
                     force_mailboxes=True)
CFG5_K4_JIT = dict(SMALL, n=5, election_tick=18, seed=803, latency=2,
                   latency_jitter=2, inflight=4, pre_vote=True)
# TestSparseProgress's mailbox combo (tests/test_raft_sim.py)
SPARSE_MB = dict(n=16, log_len=1024, window=64, apply_batch=64,
                 max_props=64, keep=32, election_tick=14, seed=3,
                 latency=2, latency_jitter=1, inflight=2, active_rows=8)

ORACLE_FIELDS = ("term", "vote", "role", "lead", "last", "commit",
                 "applied", "apply_chk", "member")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These ticks are thousands of ops on tensors of a few hundred
    elements, where intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lockstep(kw: dict, n_ticks: int, seed: int, drop_rate: float = 0.0,
             crash_prob: float = 0.0, prop_prob: float = 0.5,
             partition_at: tuple = (), crash_leader_every: int = 0,
             transfer_every: int = 0, conf_every: int = 0, voters=None,
             min_members: int = 3, remove_leader_every: int = 0,
             sleep_node: tuple = (), storm: tuple = (), fused: bool = False,
             oracle: bool = False, isolate_leader: tuple = (),
             reads_at: dict = None, flags_at: dict = None,
             transfer_at: dict = None) -> dict:
    """Drive the JAX tick and the port's on run_differential's schedule,
    asserting every SimState field equal after every host call and tick
    (and, with `oracle`, the port equal to OracleCluster on the
    differential's fields).  `storm` = (start, end) drops every non-self
    edge in that window; `isolate_leader` = (start, end) cuts the row that
    leads at `start` off from every peer until `end`; `fused` proposes
    through step's fused dense propose (a random count per tick) instead of
    host payloads.  Hooks, keyed by tick: `reads_at` {t: (count, rows)}
    submits a read batch (submit_reads), `flags_at` {t: {field: rows}} sets
    the storage model's one-tick flags (fsync_stall, snap_bad) on those
    rows, `transfer_at` {t: target} asks the sitting leader to transfer.
    Returns the final commit/term maxima, the port's branch counts and the
    final states."""
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    rng = np.random.default_rng(seed)
    n = jcfg.n
    js = jstate.init_state(jcfg, voters=voters)
    ts = tstate.init_state(tcfg, voters=voters, device=CPU)
    assert_same("init", js, ts)
    reads_at, flags_at = reads_at or {}, flags_at or {}
    transfer_at = transfer_at or {}
    isolated = None
    orc = OracleCluster(jcfg, voters=voters) if oracle else None
    alive = np.ones(n, bool)
    down_until = np.zeros(n, np.int64)
    intended = set(range(n) if voters is None else voters)
    removed = set(range(n)) - intended
    stop_at: dict = {}
    tkernel.reset_counts()

    def leaders():
        return np.nonzero((np.asarray(js.role) == jstate.LEADER)
                          & alive)[0]

    for t in range(n_ticks):
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
            ls = leaders()
            if len(ls):
                down_until[int(ls[0])] = t + int(rng.integers(5, 20))
                alive[int(ls[0])] = False

        drop = rng.random((n, n)) < drop_rate if drop_rate \
            else np.zeros((n, n), bool)
        if partition_at:
            start, end, cut = partition_at
            if start <= t < end:
                side = np.arange(n) < cut
                drop = drop | (side[:, None] != side[None, :])
        if storm and storm[0] <= t < storm[1]:
            drop = drop | ~np.eye(n, dtype=bool)
        if isolate_leader and t == isolate_leader[0]:
            isolated = int(leaders()[0])
        if isolated is not None and t < isolate_leader[1]:
            drop[isolated, :] = drop[:, isolated] = True

        ls = leaders()
        tgt = transfer_at.get(t)
        if transfer_every and t > 0 and t % transfer_every == 0 and len(ls):
            tgt = int(rng.integers(n))
        if tgt is not None and len(ls):
            ldr = int(ls[0])
            js = jkernel.transfer_leadership(js, jcfg, ldr, tgt)
            ts = tkernel.transfer_leadership(ts, tcfg, ldr, tgt)
            assert_same(f"seed={seed} transfer t={t}", js, ts)
            if orc is not None:
                orc.transfer(ldr, tgt)
        if t in reads_at:
            count, rows = reads_at[t]
            js = jrun.submit_reads(js, jcfg, count, rows=rows)
            ts = trun.submit_reads(ts, tcfg, count, rows=rows, device=CPU)
            assert_same(f"seed={seed} submit_reads t={t}", js, ts)
        for field, rows in flags_at.get(t, {}).items():
            mask = np.zeros(n, bool)
            mask[list(rows)] = True
            js = dataclasses.replace(
                js, **{field: getattr(js, field) | jnp.asarray(mask)})
            ts = dataclasses.replace(
                ts, **{field: getattr(ts, field) | t_bool(mask)})

        prop_count = 0
        payloads = np.zeros(jcfg.max_props, np.uint32)
        if prop_prob and rng.random() < prop_prob:
            prop_count = int(rng.integers(1, jcfg.max_props + 1))
            payloads[:prop_count] = rng.integers(1, 1 << 31, prop_count,
                                                 dtype=np.uint32)

        conf = None
        if remove_leader_every and t > 0 and t % remove_leader_every == 0 \
                and len(intended) > min_members:
            lset = [int(x) for x in leaders() if int(x) in intended]
            if lset:
                conf = (lset[0], True)
                intended.discard(lset[0])
                removed.add(lset[0])
                stop_at[lset[0]] = t + 8
        if conf is None and conf_every and t > 0 and t % conf_every == 0:
            ls = set(leaders().tolist())
            if removed and (len(intended) <= min_members
                            or rng.random() < 0.5):
                tgt = int(rng.choice(sorted(removed)))
                conf = (tgt, False)
                removed.discard(tgt)
                intended.add(tgt)
            else:
                cands = sorted(intended - ls)
                if len(intended) > min_members and cands:
                    tgt = int(rng.choice(cands))
                    conf = (tgt, True)
                    intended.discard(tgt)
                    removed.add(tgt)

        # host proposals, then the conf proposal, then the tick (a fused
        # tick proposes inside step, judged on the post-conf state)
        if prop_count and not fused:
            js = _jpropose(js, jcfg, payloads, np.int32(prop_count),
                           alive=alive)
            ts = tkernel.propose(ts, tcfg, payloads, prop_count,
                                 alive=t_bool(alive), device=CPU)
            assert_same(f"seed={seed} propose t={t}", js, ts)
        if conf is not None:
            js = _jpropose_conf(js, jcfg, np.int32(conf[0]),
                                np.bool_(conf[1]), alive=alive)
            ts = tkernel.propose_conf(ts, tcfg, conf[0], conf[1],
                                      alive=t_bool(alive), device=CPU)
            assert_same(f"seed={seed} propose_conf t={t}", js, ts)
        if fused:
            cnt = prop_count * (jcfg.max_props // 8)
            js = _jstep_fused(js, jcfg, alive, drop, np.int32(cnt))
            ts = tkernel.step(ts, tcfg, alive=t_bool(alive),
                              drop=t_bool(drop), prop_count=cnt,
                              payload_fn=trun._payload_at, device=CPU)
        else:
            js = _jstep(js, jcfg, alive=alive, drop=drop)
            ts = tkernel.step(ts, tcfg, alive=t_bool(alive),
                              drop=t_bool(drop), device=CPU)
        assert_same(f"seed={seed} tick {t}", js, ts)
        if orc is not None:
            orc.tick(alive, drop, payloads, prop_count, conf)
            ov = orc.view()
            for f in ORACLE_FIELDS:
                got = np.asarray(getattr(ts, f))
                if f == "apply_chk":
                    got = got.view(np.uint32)
                assert np.array_equal(got, getattr(ov, f)), \
                    f"seed={seed} tick {t}: {f} port {got} oracle " \
                    f"{getattr(ov, f)}"
    return {"max_commit": int(np.asarray(js.commit).max()),
            "max_term": int(np.asarray(js.term).max()),
            "counts": dict(tkernel.COUNTS), "js": js, "ts": ts}


@pytest.mark.parametrize("seed", [500, 502])
def test_latency1_n3(seed):
    stats = lockstep(CFG3_LAT, 120, seed, drop_rate=[0.0, 0.05, 0.15][
        seed % 3], oracle=seed == 500)
    assert stats["max_commit"] > 0


@pytest.mark.parametrize("seed,kw", [
    (560, dict(drop_rate=0.1, crash_prob=0.04)),
    (561, dict(drop_rate=0.05, partition_at=(30, 60, 2))),
    (562, dict(crash_leader_every=30, prop_prob=0.7)),
], ids=["drops-crashes", "partition", "leader-crash-cycles"])
def test_jitter_reordering_n5(seed, kw):
    stats = lockstep(CFG5_JIT, 100, seed, oracle=seed == 560, **kw)
    assert stats["max_commit"] > 0


@pytest.mark.parametrize("seed", [630, 631])
def test_forced_mailboxes_at_latency_zero(seed):
    lockstep(CFG3_SYNC_BOX, 90, seed, drop_rate=0.1, crash_prob=0.05,
             oracle=seed == 630)


@pytest.mark.parametrize("seed,kw", [
    (880, dict(drop_rate=0.1, crash_prob=0.04)),
    (881, dict(transfer_every=40, prop_prob=0.7)),
], ids=["faults", "transfers"])
def test_pipelined_k4_jitter_prevote(seed, kw):
    stats = lockstep(CFG5_K4_JIT, 140, seed, **kw)
    assert stats["max_commit"] > 0


@pytest.mark.parametrize("log_chunk", [0, 128], ids=["untiled", "tiled"])
def test_sparse_mailbox_static(log_chunk):
    """TestSparseProgress's static mailbox combo on the [8, N] slab, with
    transfers, crashes, drops and fused proposals, and a storm window that
    overflows the slab: both branches run and every field matches."""
    kw = dict(SPARSE_MB, static_members=True, log_chunk=log_chunk)
    stats = lockstep(kw, 80, 42, drop_rate=0.05, crash_prob=0.2,
                     transfer_every=37, storm=(35, 65), fused=True)
    c = stats["counts"]
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    assert c["slab_ticks"] + c["dense_fallback_ticks"] == 80
    assert stats["max_commit"] > 50


def test_first_true_all_false_and_ties():
    """The argmax-over-bool rule the slot pickers rely on: first True
    index, 0 on an all-False row, along either axis."""
    m = torch.tensor([[False, True, True], [False, False, False],
                      [True, False, True]])
    assert tkernel._first_true(m, 1).tolist() == [1, 0, 0]
    assert tkernel._first_true(m, 0).tolist() == [2, 0, 0]
    assert tkernel._first_true(m, 1).dtype == torch.int32
