"""The port's host golden core (raft/core.py, log.py, messages.py and the
OracleCluster scheduler of raft/sim/oracle.py) and its `oracle_trace`
against the JAX package's.

The golden core is pure Python in both packages: the same seeded
schedules (crashes, drops, host proposals, conf changes and transfers)
drive both OracleClusters, and every compared field (the differential
view, with the [N, N] member views) must be equal after every tick, on
the sync and the mailbox wire.  `oracle_trace` replays one schedule
through the port's tick and its oracle: on JAX's `commit_no_quorum`
schedules and on a lost-tail storage artifact it must give JAX's
`diverged_at` and trace (fields and both sides' values), and -1 on a
clean schedule.  Every compared value is an integer: exact equality.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.raft.sim.oracle import OracleCluster as JOracle
from swarmkit_tpu.raft.sim.oracle import hash32_py as jhash32
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.raft.sim.oracle import OracleCluster, hash32_py

from tests.test_torch_dst import CPU, DST5, SWEEP, both_explore, configs

VIEW = ("term", "vote", "role", "lead", "last", "commit", "applied",
        "apply_chk", "member")
SYNC = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10, seed=3, static_members=False, pre_vote=True)
MAILBOX = dict(SYNC, latency=2, latency_jitter=1, inflight=3,
               election_tick=14)


def test_hash32_masks_like_jax():
    rng = np.random.default_rng(0)
    for x in [0, 1, 0xFFFFFFFF, 0x1_0000_0000, -1, 2 ** 63 - 1] \
            + rng.integers(0, 2 ** 62, 64).tolist():
        assert hash32_py(int(x)) == jhash32(int(x))


@pytest.mark.parametrize("wire,kw", [("sync", SYNC), ("mailbox", MAILBOX)])
def test_oracle_cluster_equals_jax_tick_by_tick(wire, kw):
    """200 ticks of crashes, drops, uint32 payloads with bit 31 set, conf
    changes and transfers: every view field equal after every tick."""
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    jo, to = JOracle(jcfg), OracleCluster(tcfg)
    rng = np.random.default_rng(41 if wire == "sync" else 43)
    n = kw["n"]
    commits = 0
    for t in range(200):
        alive = rng.random(n) >= 0.08
        drop = rng.random((n, n)) < (0.3 if 60 <= t < 80 else 0.05)
        pc = int(rng.integers(0, kw["max_props"] + 1))
        payloads = rng.integers(0, 2 ** 32, kw["max_props"],
                                dtype=np.uint64).astype(np.uint32)
        conf = None
        if t % 37 == 20:
            conf = (int(rng.integers(n)), bool(rng.random() < 0.5))
        if t % 53 == 30:
            leaders = np.nonzero(jo.view().role == jstate.LEADER)[0]
            if len(leaders):
                tgt = int(rng.integers(n))
                jo.transfer(int(leaders[0]), tgt)
                to.transfer(int(leaders[0]), tgt)
        jo.tick(alive, drop, payloads, pc, conf)
        to.tick(alive, drop, payloads, pc, conf)
        jv, tv = jo.view(), to.view()
        for f in VIEW:
            a, b = getattr(jv, f), getattr(tv, f)
            assert a.dtype == b.dtype, f"{wire} tick {t}: {f} dtype"
            assert np.array_equal(a, b), f"{wire} tick {t}: {f}"
        commits = int(tv.commit.max())
    assert commits > 0


def _same_trace(tr, jr):
    assert json.dumps(tr, sort_keys=True) == json.dumps(jr, sort_keys=True)


def test_oracle_trace_equals_jax_on_commit_no_quorum():
    """The mutated commit path diverges from the oracle at JAX's tick with
    JAX's fields and values; a clean schedule never diverges."""
    jcfg, tcfg = configs(SWEEP)
    jres, _, jb, tb, _ = both_explore(tuple(SWEEP.items()), jdst.PROFILES,
                                      "commit_no_quorum")
    for s in [int(i) for i in jres.violating[:2]]:
        want = jdst.oracle_trace(jcfg, jb.slice(s), 2, "commit_no_quorum")
        info = {}
        got = tdst.oracle_trace(tcfg, tb.slice(s), 2, "commit_no_quorum",
                                device=CPU, info=info)
        _same_trace(got, want)
        assert got["diverged_at"] >= 0 and got["trace"][0]["fields"]
        # a host replay: one read of the compared fields a tick, plus one
        assert info == {"ticks": got["diverged_at"] + 1,
                        "reads": got["diverged_at"] + 2}
    clean = int(np.nonzero(jres.viol == 0)[0][0])
    got = tdst.oracle_trace(tcfg, tb.slice(clean), 2, device=CPU)
    _same_trace(got, jdst.oracle_trace(jcfg, jb.slice(clean), 2))
    assert got == {"diverged_at": -1, "trace": []}


def test_oracle_trace_on_a_lost_tail_artifact_equals_jax(tmp_path):
    """A lost_tail DURABILITY artifact: both packages replay it exactly,
    and their oracle traces hold lockstep over the clean prefix (until the
    crash tick), equal to each other."""
    kw = dict(DST5, fsync_lag_ticks=6)
    jcfg, tcfg = configs(kw)
    jb, names = jdst.make_batch(jcfg, ticks=120, schedules=8, seed=7,
                                profiles=("lost_tail",))
    jres = jdst.explore(jstate.init_state(jcfg), jcfg, jb, profiles=names)
    hits = [int(s) for s in jres.violating
            if int(jres.viol[s]) & jdst.DURABILITY]
    assert hits
    s = hits[0]
    art = jdst.to_artifact(jcfg, jb.slice(s), seed=7, profile=names[s],
                           index=s, prop_count=2, mutation=None,
                           viol=int(jres.viol[s]),
                           first_tick=int(jres.first_tick[s]))
    path = str(tmp_path / "lost_tail.json")
    jdst.save_artifact(path, art)
    want = jdst.replay_artifact(path)
    got = tdst.replay_artifact(path, device=CPU)
    assert got["matches_recorded"] and want["matches_recorded"]
    _same_trace(got["oracle"], want["oracle"])
    assert got["oracle"]["diverged_at"] == -1
    assert tdst.replay_artifact(path, with_trace=False,
                                device=CPU).keys() == {
        "violation_bits", "violations", "first_tick", "matches_recorded"}
