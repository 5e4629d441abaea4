"""PreVote and log-driven membership on the port against the JAX package.

The lockstep driver of tests/test_torch_wire.py (run_differential's
schedule, every SimState field equal after every host call and tick)
drives PreVote on both wires, conf changes through `propose_conf` (adds,
removes, a partial `voters` bootstrap that grows, the sitting leader
removing itself), a follower sleeping through compaction so only a
snapshot (which carries the sender's configuration) can catch it up, and
membership under the levers: TestSparseProgress's dynamic mailbox combo
on the [8, N] slab (untiled, and tiled with peer bands of 8) and banded
peer counts on the dense rows.  A few seeds are also held to the host
golden core (OracleCluster).
"""

from __future__ import annotations

import numpy as np
import pytest

from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import CPU, assert_same
from tests.test_torch_wire import (  # noqa: F401 (one_torch_thread: fixture)
    SMALL, SPARSE_MB, _jpropose_conf, _jstep, lockstep, one_torch_thread,
)

CFG5_PV = dict(SMALL, n=5, election_tick=12, seed=702, pre_vote=True)
CFG7_PV_JIT = dict(SMALL, n=7, election_tick=16, seed=704, pre_vote=True,
                   latency=1, latency_jitter=2)
CFG5_LAT = dict(SMALL, n=5, election_tick=14, seed=502, latency=2)
PEER8 = dict(SMALL, n=16, election_tick=10, seed=77, peer_chunk=8,
             active_rows=0)


@pytest.mark.parametrize("seed,kw", [
    (730, dict(drop_rate=0.1, crash_prob=0.06)),
    (760, dict(drop_rate=0.02, partition_at=(30, 80, 1))),
    (925, dict(drop_rate=0.05, transfer_every=30, prop_prob=0.6)),
    (1055, dict(drop_rate=0.05, conf_every=22, prop_prob=0.6)),
], ids=["faults", "partition", "transfers", "conf-churn"])
def test_prevote_sync_n5(seed, kw):
    stats = lockstep(CFG5_PV, 100, seed, oracle=seed in (760, 1055), **kw)
    if "partition_at" in kw:
        # the point of PreVote: the cut-off row does not inflate terms
        assert stats["max_term"] <= 4
    assert stats["max_commit"] > 0


@pytest.mark.parametrize("seed,kw", [
    (800, dict(drop_rate=0.12, crash_prob=0.05)),
    (965, dict(drop_rate=0.08, transfer_every=35)),
    (1095, dict(drop_rate=0.08, conf_every=28, min_members=4)),
], ids=["faults", "transfers", "conf-churn"])
def test_prevote_mailbox_jitter_n7(seed, kw):
    lockstep(CFG7_PV_JIT, 90, seed, oracle=seed == 1095, **kw)


@pytest.mark.parametrize("seed,kw", [
    (1110, dict(drop_rate=0.05, conf_every=15, voters=range(3),
                prop_prob=0.7)),
    (1165, dict(drop_rate=0.05, remove_leader_every=40, conf_every=27)),
    (6435, dict(prop_prob=0.9, sleep_node=(3, 25, 85))),
], ids=["bootstrap-grow", "remove-leader", "snapshot-sleeper"])
def test_membership_mailbox_n5(seed, kw):
    stats = lockstep(CFG5_LAT, 120, seed, oracle=seed == 1110, **kw)
    assert stats["max_commit"] > 0
    if "sleep_node" in kw:
        # the sleeper fell behind the ring: only a snapshot caught it up
        assert stats["max_commit"] > SMALL["log_len"]


@pytest.mark.parametrize("log_chunk,peer_chunk", [(0, 0), (128, 8)],
                         ids=["untiled", "tiled-banded"])
def test_sparse_mailbox_dynamic(log_chunk, peer_chunk):
    """TestSparseProgress's dynamic mailbox combo on the [8, N] slab with
    conf churn, transfers, crashes and fused proposals, and a storm that
    overflows the slab: both branches run, every field matches."""
    kw = dict(SPARSE_MB, log_chunk=log_chunk, peer_chunk=peer_chunk)
    stats = lockstep(kw, 80, 42, drop_rate=0.05, crash_prob=0.2,
                     transfer_every=37, conf_every=9, min_members=10,
                     storm=(35, 65), fused=True)
    c = stats["counts"]
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    assert c["slab_ticks"] + c["dense_fallback_ticks"] == 80
    # one read-back per slab tick, two per (tiled) storm tick: the conf
    # gates' band rides the ring write's probe
    per_fallback = 2 if log_chunk else 1
    assert c["host_syncs"] == c["slab_ticks"] \
        + per_fallback * c["dense_fallback_ticks"], c
    assert stats["max_commit"] > 50


@pytest.mark.parametrize("seed", [1000, 1030])
def test_banded_peers_dynamic_n16(seed):
    """peer_chunk=8 with static_members=False: every quorum count folds
    the deciding row's view into each band."""
    stats = lockstep(PEER8, 90, seed, drop_rate=0.05, crash_prob=0.05,
                     conf_every=12, min_members=9)
    assert stats["max_commit"] > 0


def test_propose_conf_degrades_like_jax():
    """One conf change in flight per leader: a second one, and one for a
    target outside [0, n), degrade to an empty normal entry; both tick
    on to equal states."""
    jcfg, tcfg = jstate.SimConfig(**CFG5_PV), tstate.SimConfig(**CFG5_PV)
    js, ts = jstate.init_state(jcfg), tstate.init_state(tcfg, device=CPU)
    for _ in range(60):
        js = _jstep(js, jcfg)
        ts = tkernel.step(ts, tcfg, device=CPU)
        if (np.asarray(js.role) == jstate.LEADER).any():
            break
    assert (np.asarray(js.role) == jstate.LEADER).any()
    for target, remove in ((4, True), (3, True), (9, False), (-1, True)):
        js = _jpropose_conf(js, jcfg, np.int32(target), np.bool_(remove))
        ts = tkernel.propose_conf(ts, tcfg, target, remove, device=CPU)
        assert_same(f"propose_conf({target}, {remove})", js, ts)
    assert np.asarray(ts.pending_conf).any()
    for t in range(30):
        js = _jstep(js, jcfg)
        ts = tkernel.step(ts, tcfg, device=CPU)
        assert_same(f"tick {t}", js, ts)
    # every row but the removed one (no longer replicated to) applied it
    assert not np.asarray(ts.member)[:4, 4].any()
