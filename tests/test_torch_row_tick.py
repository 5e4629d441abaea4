"""The multi-device row tick: one cluster's rows sharded over a row mesh
(`parallel.shard_rows(state, row_mesh(n, devices))`, or `host_row_mesh`
with HOST_ROW_AXES) through the tick's entry points, against the
unsharded port run and the JAX package's unsharded run, on the CPU.

tests/test_sharded_sim.py's sharded cases with its configs: CFG (n=64,
seed 11) with faults and every host call, the banded `peer_chunk=8`
config, the mailbox wire with PreVote and a leadership transfer, the
static-members config; and one config with the levers on (tiled log,
banded peers, the progress slab) and the device planes, the stats and
the read path, at D = 2 and 4 (the [4] stats vector and the [10]
histograms are split by the layout at D = 2, the [4] ones at D = 4).
The meshes: 2, 4 and 8 CPU entries and host_row_mesh(64, 2) over 8.
After every call the gathered sharded state equals the unsharded port
state and JAX's on every field, and the returned trace rows or tick
counts agree.  JAX's unsharded results are the reference (its sharded
CPU programs can abort under xdist load, ROADMAP "Red tests"); each
script's JAX run is computed once a session and shared through a file
under pytest's temporary root.  All values are integers, so every
comparison is exact.
"""

from __future__ import annotations

import fcntl
import functools
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft import sim as jsim
from swarmkit_tpu.raft.sim import kernel as jkernel
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import parallel as tpar
from swarmkit_tpu_torch.raft import sim as tsim
from swarmkit_tpu_torch.raft.sim import kernel as tkernel
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.tools import op_count

from tests.test_torch_step import jax_numpy
from tests.test_torch_wire import one_torch_thread  # noqa: F401 (fixture)

CPU = torch.device("cpu")
N = 64
# tests/test_sharded_sim.py's configs
CFG = dict(n=N, log_len=128, window=16, apply_batch=32, max_props=16, keep=8,
           seed=11)
CFG_B = dict(CFG, peer_chunk=8)
MCFG = dict(n=N, log_len=128, window=16, apply_batch=32, max_props=16,
            keep=8, seed=19, election_tick=16, latency=2, latency_jitter=1,
            inflight=3, pre_vote=True)
CFG_S = dict(CFG, static_members=True)
# the levers on (tiled log, banded peers, the [16, N] slab), the planes,
# the stats and the read path
CFG_L = dict(CFG, log_len=1024, log_chunk=128, peer_chunk=8,
             collect_stats=True, record_events=True, event_ring=16,
             collect_telemetry=True, telemetry_window=8,
             telemetry_prop_ring=64, trace_tags=True, read_batch=4)
FAULTS = (("prop_count", 4), ("drop_rate", 0.1), ("crash_every", 10),
          ("down_for", 3))
PROP4 = (("prop_count", 4),)

# Each script is a list of calls; a call the JAX run resolves against its
# state (the transfer's leader, the conf change's target) is recorded
# with its concrete arguments, which the port's runs replay.
SCRIPTS = {
    "cfg": (CFG, [("until", 400), ("ticks", 10, FAULTS),
                  ("ticks", 10, FAULTS), ("propose", 5, None),
                  ("step", 1), ("dense", 3), ("conf",),
                  ("ticks", 10, PROP4), ("transfer",), ("ticks", 10, PROP4),
                  ("sched", 8, 2)]),
    "banded": (CFG_B, [("ticks", 10, FAULTS)] * 6),
    "mailbox": (MCFG, [("until", 800), ("transfer",)]
                + [("ticks", 10, (("prop_count", 8), ("drop_rate", 0.05)))]
                * 4),
    "static": (CFG_S, [("ticks", 10, (("prop_count", 8),))] * 5),
    "levers": (CFG_L, [("until", 400), ("reads", 3, None, 7),
                       ("ticks", 10, FAULTS), ("propose", 5, 9),
                       ("reads", 2, (0, 5, 33), 4), ("step", 3),
                       ("dense", 4), ("ticks", 10, PROP4),
                       ("ticks", 10, FAULTS)]),
}


def _payloads(cfg) -> np.ndarray:
    return (np.arange(cfg.max_props, dtype=np.uint32) + 7)


def _faults(seed: int, ticks=None):
    """Seeded alive [N] (or [T, N]) and drop [N, N] (or [T, N, N])."""
    rng = np.random.default_rng(seed)
    lead = () if ticks is None else (ticks,)
    return rng.random(lead + (N,)) > 0.05, rng.random(lead + (N, N)) < 0.05


def _leader(role: np.ndarray, member: np.ndarray) -> int:
    return int(np.flatnonzero((role == jstate.LEADER)
                              & member.diagonal())[0])


def _jax_script(name: str) -> dict:
    """JAX's run of a script: every call's resolved form, the state's
    fields after it and its extra result (trace rows or ticks)."""
    kw, calls = SCRIPTS[name]
    cfg = jstate.SimConfig(**kw)
    st = jstate.init_state(cfg)
    out = {"calls": [], "states": [], "extras": []}
    for call in calls:
        extra = None
        op = call[0]
        if op == "until":
            st, extra = jsim.run_until_leader(st, cfg, max_ticks=call[1])
            extra = int(extra)
        elif op == "ticks":
            st, extra = jsim.run_ticks(st, cfg, call[1], **dict(call[2]))
        elif op == "propose":
            st = jsim.propose(st, cfg, jnp.asarray(_payloads(cfg)), call[1],
                              tag=call[2])
        elif op == "step":
            alive, drop = _faults(call[1])
            st = jsim.step(st, cfg, alive=jnp.asarray(alive),
                           drop=jnp.asarray(drop))
        elif op == "dense":
            st = jkernel.propose_dense(st, cfg, jrun._payload_at, call[1])
        elif op == "conf":
            s = jax_numpy(st)
            lead = _leader(s["role"], s["member"])
            target = max(i for i in range(N) if i != lead)
            call = ("conf", target, True)
            st = jsim.propose_conf(st, cfg, target, True)
        elif op == "transfer":
            s = jax_numpy(st)
            lead = _leader(s["role"], s["member"])
            call = ("transfer", lead, (lead + 1) % N)
            st = jsim.transfer_leadership(st, cfg, lead, (lead + 1) % N)
        elif op == "reads":
            rows = None if call[2] is None else list(call[2])
            st = jsim.submit_reads(st, cfg, call[1], rows=rows, tag=call[3])
        elif op == "sched":
            alive, drop = _faults(call[2], call[1])
            st, extra = jsim.run_schedule(st, cfg, jnp.asarray(drop),
                                          jnp.asarray(alive), prop_count=2)
        out["calls"].append(call)
        out["states"].append(jax_numpy(st))
        out["extras"].append(None if extra is None else np.asarray(extra))
    return out


@pytest.fixture(scope="session")
def jax_scripts(request, tmp_path_factory):
    """jax_scripts(name) -> _jax_script(name), computed once a session:
    under xdist the first worker to need it computes it under a file lock
    and leaves it for the others."""
    shared = (tmp_path_factory.getbasetemp().parent
              if hasattr(request.config, "workerinput") else None)

    @functools.lru_cache(maxsize=None)
    def get(name):
        if shared is None:
            return _jax_script(name)
        out = shared / f"torch_row_tick_jax_{name}.pkl"
        with open(shared / f"torch_row_tick_jax_{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not out.exists():
                    tmp = out.with_suffix(".tmp")
                    tmp.write_bytes(pickle.dumps(_jax_script(name)))
                    tmp.replace(out)
                return pickle.loads(out.read_bytes())
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    return get


def _port_call(st, cfg, call):
    """One resolved script call on a port state (sharded or not):
    (state, extra)."""
    op = call[0]
    if op == "until":
        return trun.run_until_leader(st, cfg, max_ticks=call[1], device=CPU)
    if op == "ticks":
        return trun.run_ticks(st, cfg, call[1], device=CPU, **dict(call[2]))
    if op == "propose":
        return tsim.propose(st, cfg, _payloads(cfg), call[1], tag=call[2],
                            device=CPU), None
    if op == "step":
        alive, drop = _faults(call[1])
        return tsim.step(st, cfg, alive=torch.from_numpy(alive),
                         drop=torch.from_numpy(drop), device=CPU), None
    if op == "dense":
        return tsim.propose_dense(st, cfg, trun._payload_at, call[1],
                                  device=CPU), None
    if op == "conf":
        return tsim.propose_conf(st, cfg, call[1], call[2],
                                 device=CPU), None
    if op == "transfer":
        return tsim.transfer_leadership(st, cfg, call[1], call[2]), None
    if op == "reads":
        rows = None if call[2] is None else list(call[2])
        return tsim.submit_reads(st, cfg, call[1], rows=rows, tag=call[3],
                                 device=CPU), None
    alive, drop = _faults(call[2], call[1])
    return trun.run_schedule(st, cfg, torch.from_numpy(drop),
                             torch.from_numpy(alive), prop_count=2,
                             device=CPU)


def _mesh(kind: str, d: int):
    if kind == "host":
        return tpar.host_row_mesh(N, 2, [CPU] * d), tpar.HOST_ROW_AXES
    return tpar.row_mesh(N, [CPU] * d), tpar.MANAGER_AXIS


def _same(tag: str, want: dict, got: dict) -> None:
    assert sorted(want) == sorted(got), f"{tag}: field sets differ"
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, f"{tag}: {name} dtype {g.dtype}"
        if not np.array_equal(g, w):
            bad = np.argwhere(g != w)[:5].tolist()
            raise AssertionError(f"{tag}: field {name} diverged at {bad}")


def _placed(sh: tpar.Sharded, d: int) -> None:
    """Every shard's leaves on its own entry, its rows only, sharing no
    storage with another shard."""
    assert isinstance(sh, tpar.Sharded) and len(sh) == d
    seen: dict = {}
    for i, (shard, dev) in enumerate(zip(sh.shards, sh.devices)):
        for name in tstate.FIELD_NAMES:
            leaf = getattr(shard, name)
            if leaf is None:
                continue
            assert leaf.device == dev, f"shard {i}: {name} on {leaf.device}"
            if name not in tpar.CLUSTER_FIELDS:
                assert leaf.shape[0] == N // d, f"shard {i}: {name} whole"
            if leaf.numel():
                ptr = leaf.untyped_storage().data_ptr()
                assert seen.setdefault(ptr, i) == i, \
                    f"shard {i}: {name} shares storage with another shard"


CASES = [("cfg", "row", 2), ("cfg", "row", 4), ("cfg", "row", 8),
         ("cfg", "host", 8), ("banded", "row", 4), ("mailbox", "row", 4),
         ("static", "row", 2), ("levers", "row", 2), ("levers", "row", 4)]


@pytest.mark.parametrize("name,kind,d", CASES,
                         ids=[f"{s}-{k}{d}" for s, k, d in CASES])
def test_row_sharded_calls_equal_unsharded_and_jax(name, kind, d,
                                                   jax_scripts):
    jx = jax_scripts(name)
    cfg = tstate.SimConfig(**SCRIPTS[name][0])
    mesh, axis = _mesh(kind, d)
    assert mesh.size == d
    unsharded = tstate.init_state(cfg, device=CPU)
    sharded = tpar.shard_rows(tstate.init_state(cfg, device=CPU), mesh,
                              axis=axis)
    tpar.reset_exchange()
    for i, call in enumerate(jx["calls"]):
        tag = f"{name} call {i} {call[0]}"
        unsharded, ex_u = _port_call(unsharded, cfg, call)
        sharded, ex_s = _port_call(sharded, cfg, call)
        _placed(sharded, d)
        want = jx["states"][i]
        _same(tag + " (unsharded)", want, tstate.state_to_numpy(unsharded))
        _same(tag + " (sharded)", want,
              tstate.state_to_numpy(tpar.gather(sharded)))
        if jx["extras"][i] is not None:
            for ex in (ex_u, ex_s):
                got = ex.numpy() if isinstance(ex, torch.Tensor) else ex
                assert np.array_equal(np.asarray(got), jx["extras"][i]), tag
    assert tpar.EXCHANGE["copies"] > 0 and tpar.EXCHANGE["bytes"] > 0
    # the host reads of a sharded state give the cluster's values
    assert torch.equal(trun.leader_mask(sharded),
                       trun.leader_mask(unsharded))
    assert bool(trun.has_leader(sharded)) == bool(
        trun.has_leader(unsharded))
    assert int(trun.committed_entries(sharded)) \
        == int(trun.committed_entries(unsharded)) > 0
    for a, b in zip(trun.quorum_applied_checksum(sharded),
                    trun.quorum_applied_checksum(unsharded)):
        assert torch.equal(a, b)
    if name == "mailbox":
        # the transfer moved leadership to its target
        target = jx["calls"][1][2]
        assert int(sharded.shards[target // (N // d)].role[
            target % (N // d)]) == tstate.LEADER
    if cfg.read_batch:
        assert int(trun.reads_served(sharded)) \
            == int(trun.reads_served(unsharded)) > 0


def test_shard_slabs_hold_the_unsharded_slab_rows():
    """At active_rows=48 the slab lowering is not dense's (a row that
    campaigns and steps down in one tick gets no active_ttl, so a slab
    tick leaves its due vote requests in flight; the JAX package's rule,
    masked at active_rows=16 by the fit), so the shards' slabs must hold
    exactly the unsharded slab's rows: a run over 2 and 4 entries (32 and
    16 rows an entry, every entry's slab padded with rows that write
    nothing back) equals the unsharded slab run, and differs from the
    dense one."""
    kw = dict(MCFG, peer_chunk=0, seed=0)
    T = 40
    g = torch.Generator().manual_seed(0)
    drop = torch.rand((T, N, N), generator=g) < 0.05
    runs = []
    for active, d in ((0, 1), (48, 1), (48, 2), (48, 4)):
        cfg = tstate.SimConfig(**dict(kw, active_rows=active))
        st = tpar.shard_rows(tstate.init_state(cfg, device=CPU),
                             tpar.row_mesh(N, [CPU] * d))
        st, trace = trun.run_schedule(st, cfg, drop,
                                      torch.ones((T, N), dtype=torch.bool),
                                      prop_count=4, device=CPU)
        got = tstate.state_to_numpy(tpar.gather(st))
        got.pop("active_ttl", None)
        runs.append((got, trace))
    dense, slab = runs[0][0], runs[1][0]
    assert any(not np.array_equal(dense[k], slab[k]) for k in dense)
    for got, trace in runs[2:]:
        _same("sharded slab", slab, got)
        assert torch.equal(trace, runs[1][1])


def test_steady_sharded_tick_reads_once_for_the_mesh():
    """A steady tick of the tiled, slab config over four entries makes one
    step host sync for the whole mesh (the band probe, the slab's fit
    riding it), as the unsharded tick does."""
    cfg = tstate.SimConfig(**dict(CFG_L, collect_stats=False,
                                  record_events=False,
                                  collect_telemetry=False, trace_tags=False,
                                  read_batch=0, static_members=True))
    counts = []
    for mesh in (tpar.row_mesh(N, [CPU]), tpar.row_mesh(N, [CPU] * 4)):
        st = tpar.shard_rows(tstate.init_state(cfg, device=CPU), mesh)
        st, _ = trun.run_until_leader(st, cfg, max_ticks=400, device=CPU)
        st, _ = trun.run_ticks(st, cfg, 4, prop_count=4, device=CPU)
        tkernel.reset_counts()
        st, _ = trun.run_ticks(st, cfg, 10, prop_count=4, device=CPU)
        counts.append(dict(tkernel.COUNTS))
    assert counts[0] == counts[1] == {"host_syncs": 10, "slab_ticks": 10,
                                      "dense_fallback_ticks": 0}


def test_row_exchange_collectives_are_the_whole_cluster_ops():
    """Each collective of the row exchange on four entries against the
    whole tensor's op: all-gather, all-reduce, reduce-scatter, the
    all-to-all transpose, the remote row, element and ring-window
    gathers, and the mesh-wide read."""
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-50, 50, (N, N, 3), generator=g, dtype=torch.int32)
    ids = torch.randint(0, N, (N,), generator=g)
    cols = torch.randint(0, N, (N, 5), generator=g)
    starts = torch.randint(0, N, (N,), generator=g)
    mesh = tpar.row_mesh(N, [CPU] * 4)
    sh = tpar.shard_rows(tstate.init_state(tstate.SimConfig(**CFG),
                                           device=CPU), mesh)

    def body(st, rx):
        mine = slice(rx.r0, rx.r1)
        xl = x[mine]
        out = {
            "gather": rx.allgather(xl[:, 0, 0]),
            "sum": rx.allreduce(xl.sum(), "sum"),
            "scatter": rx.reduce_scatter(xl[:, :, 0].amax(0), "max"),
            "transpose": rx.transpose(xl),
            "rows": rx.take(xl, ids[mine]),
            "elems": rx.take(xl[:, :, 1], ids[mine][:, None], cols[mine]),
            "window": rx.take_window((xl[:, :, 0], xl[:, :, 2]), ids[mine],
                                     starts[mine], 7),
            "read": rx.read([xl.amin(), xl.amax(), (xl > 40).any()],
                            ["min", "max", "or"]),
        }
        return out

    res = tpar.over_rows(sh, N, body)
    nr = N // 4
    for i, r in enumerate(res):
        mine = slice(i * nr, (i + 1) * nr)
        assert torch.equal(r["gather"], x[:, 0, 0])
        assert int(r["sum"]) == int(x.sum())
        assert torch.equal(r["scatter"], x[:, :, 0].amax(0)[mine])
        assert torch.equal(r["transpose"], x.transpose(0, 1)[mine])
        assert torch.equal(r["rows"], x[ids[mine]])
        assert torch.equal(r["elems"], x[:, :, 1][ids[mine][:, None],
                                                  cols[mine]])
        win = (starts[mine][:, None] + torch.arange(7)[None, :]) % N
        for got, lane in zip(r["window"], (0, 2)):
            assert torch.equal(got, x[:, :, lane][ids[mine][:, None], win])
        assert r["read"] == [int(x.min()), int(x.max()),
                             int((x > 40).any())]


def test_a_failing_shard_unwinds_the_mesh():
    """A shard that raises stops every shard waiting at a collective, the
    error reaches the caller, and the next call runs."""
    mesh = tpar.row_mesh(N, [CPU] * 4)
    sh = tpar.shard_rows(tstate.init_state(tstate.SimConfig(**CFG),
                                           device=CPU), mesh)

    def body(st, rx):
        if rx.i == 2:
            raise ValueError("shard 2 failed")
        return rx.allgather(st.term)

    with pytest.raises(ValueError, match="shard 2 failed"):
        tpar.over_rows(sh, N, body)
    # the shard threads serve the next call
    out = tpar.over_rows(sh, N, lambda st, rx: rx.allgather(st.term))
    assert all(torch.equal(t, tstate.init_state(
        tstate.SimConfig(**CFG), device=CPU).term) for t in out)


def test_unsharded_op_counts_unchanged():
    """The row exchange leaves the unsharded tick's program alone:
    tools/op_count's figures (ROADMAP), planes off and on, and the
    batched program planes off."""
    got = op_count.main(["--planes", "both", "--ticks", "60"])
    assert {k: round(v, 2) for k, v in got.items()} == {
        "static/planes_off": 1393.07, "mailbox/planes_off": 1999.07,
        "dynamic/planes_off": 1625.07, "static/planes_on": 1592.07,
        "mailbox/planes_on": 2198.10, "dynamic/planes_on": 1824.07}
    got = op_count.main(["--planes", "off", "--ticks", "60", "--batch", "4"])
    assert {k: round(v, 2) for k, v in got.items()} == {
        "static/planes_off": 1171.98, "mailbox/planes_off": 1647.00,
        "dynamic/planes_off": 1350.00}
