"""The read path on the port against the JAX package.

The port's raft/read/ functions take the same crafted vectors as the JAX
package's (tests/test_read_path.py's lease cases, and seeded random
registers through submit, stamp and settle).  The tick with reads on runs
in lockstep with JAX (tests/test_torch_wire.py::lockstep: every SimState
field equal after every host call and tick, exact) on test_read_path.py's
three wires, on TestSparseProgress's mailbox combo with banded counts and
a storm (slab and dense-fallback ticks), and through the stale-leader
partition and the leader crash mid-lease.  With reads off the port's tick
leaves every other field as a reads-on run leaves it.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft import read as jread
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.raft import read as tread
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import CPU, assert_same
from tests.test_torch_wire import (  # noqa: F401 (one_torch_thread: fixture)
    SPARSE_MB, lockstep, one_torch_thread,
)

SMALL5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8,
              keep=4, election_tick=10, seed=3)
WIRES = {
    "sync": {},
    "force_mailboxes": {"force_mailboxes": True},
    "mailbox_lat2": {"latency": 2, "latency_jitter": 1, "inflight": 4},
}


def _read_cfg(**kw):
    return dict(SMALL5, read_batch=2, **kw)


def _linearizable(st) -> bool:
    return bool((st.read_srv_idx >= st.read_srv_goal).all())


# ---- the functions of raft/read/, on crafted vectors -----------------------

def _both(a, dtype=None):
    a = np.asarray(a, dtype=dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eq(j, t, what):
    assert np.array_equal(np.asarray(j), t.numpy()), \
        f"{what}: jax {np.asarray(j)} port {t.numpy()}"


@pytest.mark.parametrize("kw", [dict(), dict(latency=2, latency_jitter=1),
                                dict(lease_margin=3)],
                         ids=["sync", "mailbox", "margin3"])
def test_lease_span_matches(kw):
    cfg = _read_cfg(**kw)
    assert tread.lease_span(tstate.SimConfig(**cfg)) \
        == jread.lease_span(jstate.SimConfig(**cfg)) \
        == tstate.SimConfig(**cfg).lease_ticks


@pytest.mark.parametrize("leases", [True, False])
def test_lease_renew_and_valid_crafted(leases):
    """tests/test_read_path.py's crafted case: a quorum-acked leader, a
    transferring leader, followers; then the strict expiry edge."""
    jcfg = jstate.SimConfig(**_read_cfg(read_leases=leases))
    tcfg = tstate.SimConfig(**_read_cfg(read_leases=leases))
    role = _both([jstate.LEADER, 0, 0, jstate.LEADER, 0], np.int32)
    q_ok = _both([True, False, False, False, False])
    transferee = _both([-1, -1, -1, 1, -1], np.int32)
    now = _both(20, np.int32)
    prev = _both(np.full(5, 15), np.int32)
    ju = jread.renew(jcfg, prev[0], role[0], q_ok[0], transferee[0], now[0])
    tu = tread.renew(tcfg, prev[1], role[1], q_ok[1], transferee[1], now[1])
    _eq(ju, tu, "renew")
    assert tu.tolist() == [20 + tcfg.lease_ticks, 0, 0, 15, 0]
    is_leader = (role[0] == jstate.LEADER, role[1] == tstate.LEADER)
    for until in ((ju, tu), _both(np.full(5, 20), np.int32)):
        jv = jread.valid(jcfg, until[0], is_leader[0], transferee[0], now[0])
        tv = tread.valid(tcfg, until[1], is_leader[1], transferee[1], now[1])
        _eq(jv, tv, "valid")
    assert tv.tolist() == [False] * 5          # now == lease_until expired


@pytest.mark.parametrize("leases", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_submit_stamp_settle_random_registers(seed, leases):
    """Seeded random registers and tick inputs through the three phases of
    serve.py in both packages: every output equal."""
    n = 8
    rng = np.random.default_rng(seed)
    jcfg = jstate.SimConfig(**dict(_read_cfg(read_leases=leases), n=n))
    tcfg = tstate.SimConfig(**dict(_read_cfg(read_leases=leases), n=n))

    def vec(lo, hi):
        return _both(rng.integers(lo, hi, n), np.int32)

    def mask(p=0.5):
        return _both(rng.random(n) < p)

    regs = [vec(0, 3), vec(0, 30), vec(-1, 30), vec(0, 40), vec(0, 99),
            vec(0, 99), vec(0, 30), vec(0, 30)]
    jregs = jread.ReadRegs(*(r[0] for r in regs))
    tregs = tread.ReadRegs(*(r[1] for r in regs))
    alive, commit = mask(0.8), vec(0, 40)
    jregs = jread.submit(jcfg, jregs, alive[0], commit[0])
    tregs = tread.submit(tcfg, tregs, alive[1], commit[1])
    for f, j, t in zip(jread.ReadRegs._fields, jregs, tregs):
        _eq(j, t, f"submit {f}")

    role = _both(rng.choice([0, 1, 2], n, p=[0.5, 0.2, 0.3]), np.int32)
    lead, term = vec(-1, n), vec(1, 4)
    kw = dict(now=_both(30, np.int32), drop=_both(rng.random((n, n)) < 0.2),
              alive=alive, role=role, lead=lead, term=term, commit=commit,
              commit_term_ok=mask(), q_ok=mask(), transferee=vec(-1, 2))
    jregs, jconf = jread.stamp(jcfg, jregs, **{k: v[0] for k, v in kw.items()})
    tregs, tconf = tread.stamp(tcfg, tregs, **{k: v[1] for k, v in kw.items()})
    _eq(jconf, tconf, "stamp confirm")
    for f, j, t in zip(jread.ReadRegs._fields, jregs, tregs):
        _eq(j, t, f"stamp {f}")

    kw = dict(alive=alive, applied=vec(0, 45), role=role,
              was_leader=mask(0.4), now=_both(30, np.int32),
              prev_lease_until=vec(28, 33))
    jout = jread.settle(jcfg, jregs, **{k: v[0] for k, v in kw.items()})
    tout = tread.settle(tcfg, tregs, **{k: v[1] for k, v in kw.items()})
    for f, j, t in zip(jread.ReadRegs._fields, jout[0], tout[0]):
        _eq(j, t, f"settle {f}")
    for i, (j, t) in enumerate(zip(jout[1:], tout[1:])):
        _eq(j, t, f"settle output {i + 1}")


# ---- the tick with reads on, in lockstep -----------------------------------

@pytest.mark.parametrize("wire", sorted(WIRES))
def test_reads_lockstep_three_wires(wire):
    stats = lockstep(_read_cfg(**WIRES[wire]), 90, 31, drop_rate=0.05,
                     crash_prob=0.03, transfer_every=35, fused=True,
                     reads_at={20: (7, [0, 2]), 50: (3, None)})
    ts = stats["ts"]
    assert int(trun.reads_served(ts)) > 0 and _linearizable(ts)


@pytest.mark.parametrize("leases,log_chunk", [(True, 128), (False, 0)],
                         ids=["leases-tiled", "readindex-untiled"])
def test_reads_lockstep_sparse_mailbox_storm(leases, log_chunk):
    """TestSparseProgress's mailbox combo with banded counts (peer_chunk=8)
    and a storm that overflows the [8, N] slab: R1's ack count runs on the
    slab and banded on the dense fallback."""
    kw = dict(SPARSE_MB, static_members=True, log_chunk=log_chunk,
              peer_chunk=8, read_batch=3, read_leases=leases)
    stats = lockstep(kw, 90, 42, drop_rate=0.05, crash_prob=0.05,
                     transfer_every=37, storm=(25, 50), fused=True)
    c = stats["counts"]
    assert c["slab_ticks"] > 0 and c["dense_fallback_ticks"] > 0, c
    ts = stats["ts"]
    assert int(trun.reads_served(ts)) > 0 and _linearizable(ts)


def test_stale_leader_partition_lockstep():
    """tests/test_read_path.py's stale-leader schedule: the sitting leader
    is cut off from every peer; it serves only while its lease holds, then
    refuses, while the majority elects a successor."""
    stats = lockstep(_read_cfg(), 90, 5, prop_prob=1.0, fused=True,
                     isolate_leader=(30, 90))
    js, ts = stats["js"], stats["ts"]
    assert _linearizable(ts)
    assert int(trun.reads_blocked(ts)) > 0
    lm = np.asarray(trun.leader_mask(ts))
    assert lm.sum() >= 1 and int(np.asarray(js.term).max()) > 1


def test_leader_crash_mid_lease_lockstep():
    stats = lockstep(_read_cfg(), 90, 9, prop_prob=1.0, fused=True,
                     crash_leader_every=40)
    ts = stats["ts"]
    assert _linearizable(ts) and int(trun.reads_served(ts)) > 0
    assert int(np.asarray(stats["js"].term).max()) > 1


# ---- reads off leaves the tick alone, and submit_reads ---------------------

@pytest.mark.parametrize("wire", sorted(WIRES))
def test_reads_off_equals_reads_on(wire):
    """The port's read_batch=0 run equals its reads-on run on every field
    but the read registers (the read path only adds them)."""
    out = {}
    for rb in (0, 2):
        cfg = tstate.SimConfig(**dict(SMALL5, read_batch=rb, **WIRES[wire]))
        st = tstate.init_state(cfg, device=CPU)
        out[rb], _ = trun.run_ticks(st, cfg, 50, prop_count=1, device=CPU)
    assert out[0].read_pend is None and int(trun.reads_served(out[2])) > 0
    for f in dataclasses.fields(tstate.SimState):
        if f.name.startswith(("read_", "lease_")):
            continue
        a, b = getattr(out[0], f.name), getattr(out[2], f.name)
        assert (a is None) == (b is None), f.name
        assert a is None or torch.equal(a, b), f"{f.name} ({wire})"


def test_submit_reads_matches_jax():
    """tests/test_read_path.py's host-API case on both packages."""
    jcfg = jstate.SimConfig(**_read_cfg())
    tcfg = tstate.SimConfig(**_read_cfg())
    js, ts = jstate.init_state(jcfg), tstate.init_state(tcfg, device=CPU)
    js = dataclasses.replace(js, commit=js.commit.at[3].set(4))
    ts.commit[3] = 4
    for count, rows in ((7, [0, 2]), (3, [0, 1]), (5, None)):
        js = jrun.submit_reads(js, jcfg, count, rows=rows)
        ts = trun.submit_reads(ts, tcfg, count, rows=rows, device=CPU)
        assert_same(f"submit_reads {count} {rows}", js, ts)
    assert ts.read_pend.tolist() == [7, 3, 7, 5, 5]
    assert ts.read_goal.tolist() == [4] * 5
    assert int(trun.reads_served(ts)) == int(jrun.reads_served(js)) == 0
    off = tstate.SimConfig(**SMALL5)
    with pytest.raises(ValueError, match="read path is off"):
        trun.submit_reads(tstate.init_state(off, device=CPU), off, 1,
                          device=CPU)
    st = tstate.init_state(off, device=CPU)
    assert int(trun.reads_served(st)) == int(trun.reads_blocked(st)) == 0
