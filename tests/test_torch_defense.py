"""The vote guard, transfer cooldown and the storage model on the port
against the JAX package.

Hand-built states (the JAX package's own cases in tests/test_threat_model.py
and tests/test_durability.py) go through one tick of both packages, and
seeded schedules run in lockstep (tests/test_torch_wire.py::lockstep):
every SimState field equal after every host call and tick, exact.  The
storage model's one-tick flags (fsync_stall, snap_bad) are set on both
states between ticks, as the JAX tests set them.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import CPU, assert_same, t_bool
from tests.test_torch_wire import (  # noqa: F401 (one_torch_thread: fixture)
    SPARSE_MB, lockstep, one_torch_thread,
)

_jstep = jax.jit(jkernel.step, static_argnames=("cfg",))

CFG5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10, seed=0)
# tests/test_threat_model.py's configurations
EQ_OFF = dict(CFG5, check_quorum=False)
EQ_ON = dict(EQ_OFF, vote_guard=True)
DEFENDED = dict(CFG5, vote_guard=True, prop_inflight_cap=63,
                transfer_cooldown_ticks=15)
# tests/test_durability.py's: fsyncs complete on ticks 3, 7, 11, ...
SCFG = dict(CFG5, fsync_lag_ticks=4, ack_gating=True)
NOGATE = dict(CFG5, fsync_lag_ticks=4)
MAILBOX = dict(latency=2, latency_jitter=1, inflight=2)


class Both:
    """One configuration and one state in each package, kept equal."""

    def __init__(self, kw: dict, **updates):
        self.jcfg, self.tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
        self.js = jstate.init_state(self.jcfg)
        self.ts = tstate.init_state(self.tcfg, device=CPU)
        self.set(**updates)

    def set(self, **updates):
        """field=[(row, value), ...] on both states."""
        for name, pairs in updates.items():
            j, t = getattr(self.js, name), getattr(self.ts, name).clone()
            for idx, val in pairs:
                j = j.at[idx].set(val)
                t[idx] = val
            self.js = dataclasses.replace(self.js, **{name: j})
            self.ts = dataclasses.replace(self.ts, **{name: t})
        assert_same("set", self.js, self.ts)
        return self

    def at_tick(self, t: int):
        self.js = dataclasses.replace(self.js, tick=np.int32(t))
        self.ts = dataclasses.replace(self.ts, tick=torch.tensor(
            t, dtype=torch.int32))
        return self

    def step(self, alive=None, drop=None):
        n = self.jcfg.n
        alive = np.ones(n, bool) if alive is None else np.asarray(alive)
        drop = np.zeros((n, n), bool) if drop is None else drop
        self.js = _jstep(self.js, self.jcfg, alive=alive, drop=drop)
        self.ts = tkernel.step(self.ts, self.tcfg, alive=t_bool(alive),
                               drop=t_bool(drop), device=CPU)
        assert_same(f"tick {int(self.ts.tick)}", self.js, self.ts)
        return self.ts

    def transfer(self, leader: int, target: int):
        self.js = jkernel.transfer_leadership(self.js, self.jcfg, leader,
                                              target)
        self.ts = tkernel.transfer_leadership(self.ts, self.tcfg, leader,
                                              target)
        assert_same("transfer", self.js, self.ts)
        return self.ts


# ---- the vote guard -------------------------------------------------------

@pytest.mark.parametrize("kw,regrants", [(EQ_ON, False), (EQ_OFF, True)],
                         ids=["guard", "no-guard"])
def test_vote_guard_under_a_wiped_vote(kw, regrants):
    """Rows 1 and 2 voted for row 0, now leader of term 3, and then lost
    `vote` (the vote_equivocation wipe); candidate 4 asks at term 3.  With
    the guard their durable record refuses a second candidate; without it
    they grant, and row 4 wins a second leadership of term 3."""
    b = Both(kw, term=[(i, 3) for i in range(5)],
             role=[(0, jstate.LEADER), (4, jstate.CANDIDATE)],
             lead=[(0, 0), (1, 0), (2, 0)], vote=[(0, 0), (3, 4), (4, 4)],
             granted=[((4, 4), True), ((4, 3), True)])
    if kw.get("vote_guard"):
        b.set(vg_vote=[(0, 0), (1, 0), (2, 0), (3, 4), (4, 4)],
              vg_term=[(i, 3) for i in range(5)])
    ts = b.step()
    assert (ts.vote[1:3] == 4).all().item() == regrants
    assert (int(ts.role[4]) == tstate.LEADER) == regrants


# ---- transfer cooldown ----------------------------------------------------

def test_cooldown_register_counts_down_to_zero():
    b = Both(DEFENDED, tx_cool=[(0, 2)])
    assert [int(b.step().tx_cool[0]) for _ in range(3)] == [1, 0, 0]


def test_transfer_leadership_refused_while_cooling():
    """tests/test_threat_model.py's boundary: one tick left still refuses,
    zero accepts, a cooldown-free config ignores the register."""
    lead0 = dict(role=[(0, jstate.LEADER)], term=[(0, 1)])
    cooling = Both(DEFENDED, tx_cool=[(0, 1)], **lead0)
    assert int(cooling.transfer(0, 2).transferee[0]) == tstate.NONE
    assert int(Both(DEFENDED, **lead0).transfer(0, 2).transferee[0]) == 2
    assert int(Both(CFG5, **lead0).transfer(0, 2).transferee[0]) == 2


def test_defended_lockstep_cooldown_binds():
    """DEFENDED (vote guard, prop_inflight_cap, cooldown) with a binding
    inflight cap: a transfer fires TIMEOUT_NOW at tick 40 while its target
    sleeps, so the leader stays and its cooldown arms; a second request at
    tick 43 is refused, and the leader still leads at the end."""
    kw = dict(DEFENDED, prop_inflight_cap=10)
    stats = lockstep(kw, 50, 11, prop_prob=1.0, drop_rate=0.02,
                     transfer_at={40: 3, 43: 2}, sleep_node=(3, 41, 60))
    ts = stats["ts"]
    ldr = int(np.argmax(ts.role.numpy() == tstate.LEADER))
    assert int(ts.role[ldr]) == tstate.LEADER and ldr not in (2, 3)
    assert int(ts.tx_cool[ldr]) > 0 and int(ts.transferee[ldr]) != 2
    assert int((ts.last - ts.commit).max()) < 10 + kw["max_props"]


# ---- the storage model ----------------------------------------------------

def test_fsync_cadence_batch_and_durable_fold():
    b = Both(SCFG, last=[(0, 10)], commit=[(0, 8)])
    assert int(b.step().sync_mark[0]) == 0                # tick 0: not due
    b = Both(SCFG, last=[(0, 10)], commit=[(0, 8)]).at_tick(3)
    ts = b.step()
    assert int(ts.sync_mark[0]) == 10                     # due, unlimited
    assert int(ts.dur_commit[0]) >= 8 and int(ts.ack_frontier[0]) >= 8
    b = Both(dict(SCFG, fsync_batch=4), last=[(0, 10)]).at_tick(3)
    assert int(b.step().sync_mark[0]) == 4                # clamped


def test_fsync_freezes_on_stall_and_crash_and_flags_clear():
    b = Both(SCFG, last=[(0, 10), (1, 10), (2, 10)],
             fsync_stall=[(1, True)], snap_bad=[(3, True)]).at_tick(3)
    ts = b.step(alive=[True, True, False, True, True])
    assert ts.sync_mark[:3].tolist() == [10, 0, 0]
    assert not ts.fsync_stall.any() and not ts.snap_bad.any()


@pytest.mark.parametrize("stall", [False, True])
def test_stalled_disk_refuses_vote_grants(stall):
    b = Both(SCFG, elapsed=[(0, 100)])
    for _ in range(3):
        if stall:
            b.set(fsync_stall=[(i, True) for i in range(1, 5)])
        ts = b.step()
    if stall:
        assert not (ts.role == tstate.LEADER).any()
        assert (ts.vote[1:] == tstate.NONE).all()
    else:
        assert int(ts.role[0]) == tstate.LEADER


@pytest.mark.parametrize("kw,poisoned", [(SCFG, False), (NOGATE, True)],
                         ids=["gated-refused", "ungated-poisoned"])
def test_corrupt_snapshot(kw, poisoned):
    """Row 4 sleeps through ticks 10-49 while the ring compacts past it, so
    it needs a snapshot when it wakes; its images arrive flagged snap_bad
    for ten ticks.  Gated, the flagged installs are refused and a clean one
    lands later; ungated, the first installs unverified and poisons the
    row's checksum chain."""
    flags = {t: {"snap_bad": [4]} for t in range(50, 60)}
    stats = lockstep(kw, 75, 21, prop_prob=1.0, fused=True,
                     sleep_node=(4, 10, 50), flags_at=flags)
    ts = stats["ts"]
    assert int(ts.snap_idx[4]) > 0                        # it restored
    assert int(ts.sync_mark[4]) >= int(ts.snap_idx[4])
    chk = {}
    agree = all(chk.setdefault(a, c) == c for a, c in
                zip(ts.applied.tolist(), ts.apply_chk.tolist()))
    assert (ts.applied[:4] == ts.applied[4]).any()
    assert agree != poisoned


@pytest.mark.parametrize("wire", ["sync", "mailbox"])
def test_storage_ungated_equals_storage_off(wire):
    """tests/test_durability.py's transparency: the storage model armed
    without ack gating changes no decision; only its registers (and the
    vote guard it folds in) differ from the storage-off run."""
    extra = {} if wire == "sync" else MAILBOX
    out = {}
    for kw in (dict(CFG5, **extra), dict(NOGATE, **extra)):
        cfg = tstate.SimConfig(**kw)
        out[cfg.storage_on], _ = trun.run_ticks(
            tstate.init_state(cfg, device=CPU), cfg, 120, prop_count=2,
            device=CPU)
    skip = {"sync_mark", "dur_commit", "ack_frontier", "fsync_stall",
            "snap_bad", "vg_vote", "vg_term"}
    for f in dataclasses.fields(tstate.SimState):
        if f.name in skip:
            continue
        a, b = getattr(out[False], f.name), getattr(out[True], f.name)
        assert (a is None) == (b is None), f.name
        assert a is None or torch.equal(a, b), f"{f.name} ({wire})"
    assert int(out[True].sync_mark.max()) > 0
    assert int(out[True].dur_commit.max()) > 0


def test_gated_commit_on_the_mailbox_wire():
    """Ack gating on the mailbox wire: appends' acks are clamped to the
    durable watermark, and the unsolicited durable-frontier ack after each
    fsync round commits the rest.  Durability holds at the end."""
    stats = lockstep(dict(SCFG, **MAILBOX), 100, 17, drop_rate=0.03,
                     fused=True, flags_at={40: {"fsync_stall": [1, 2]},
                                           41: {"fsync_stall": [1, 2]}})
    ts = stats["ts"]
    assert stats["max_commit"] > 100
    assert int(ts.ack_frontier.max()) <= int(ts.last.max())
    assert (ts.dur_commit <= ts.sync_mark).all()
    assert (ts.sync_mark >= ts.snap_idx).all()


def test_all_levers_on_the_slab_banded_and_tiled():
    """Every lever of this slice at once (reads, vote guard, cooldown, the
    gated storage model) on TestSparseProgress's mailbox combo with banded
    counts, the tiled log and a storm, disks stalling and images flagged:
    slab and dense-fallback ticks both run."""
    kw = dict(SPARSE_MB, static_members=True, log_chunk=128, peer_chunk=8,
              read_batch=3, vote_guard=True, transfer_cooldown_ticks=15,
              fsync_lag_ticks=2, ack_gating=True)
    stats = lockstep(kw, 90, 42, drop_rate=0.05, crash_prob=0.2,
                     transfer_every=37, storm=(35, 60), fused=True,
                     flags_at={20: {"fsync_stall": [1, 2, 3]},
                               66: {"snap_bad": list(range(16))}},
                     reads_at={10: (5, [0, 3])})
    c = stats["counts"]
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    ts = stats["ts"]
    assert int(trun.reads_served(ts)) > 0
    assert bool((ts.read_srv_idx >= ts.read_srv_goal).all())
    assert stats["max_commit"] > 50
