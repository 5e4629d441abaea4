"""The port's meshes (swarmkit_tpu_torch/parallel/) against the JAX
package's (swarmkit_tpu/parallel/), and the batch paths sharded over them,
on the CPU.

Mesh helpers: `pick_host_shape` and the shapes and axis names of
`row_mesh`, `schedule_mesh`, `group_mesh` and `host_row_mesh` over 8 CPU
entries equal JAX's over its 8 virtual CPU devices (tests/conftest.py), on
tests/test_sharded_sim.py's cases and on hypothesis draws; the multi-host
branch runs on fake devices that carry a `process_index`.
`state_shardings` gives JAX's PartitionSpec leaf by leaf on `init_state`,
`init_groups(cfg, 64)` with leading=64 and tests/test_multiraft.py's
placement tree (G=6 replicates).

Batch paths, bit for bit: `explore` (S=16, DST5, 60 ticks, PROFILES), the
smoke scope's `exhaustive_scan` and the fleet (G=16 x 30 ticks) sharded
over 4 and 8 CPU entries equal their unsharded port runs and JAX's
unsharded runs (JAX's own tests hold its sharded runs to those; its
sharded CPU programs can abort under xdist load, ROADMAP "Red tests").
Each JAX result is computed once a session and shared by the xdist
workers through a file under pytest's temporary root.

The wire: the 4-entry all-to-all equals the transpose and is built from
D^2 blocks a tensor; raft nodes replicate over a 4-entry wire.  A
row-sharded state over two entries runs through the tick as the
unsharded one (tests/test_torch_row_tick.py holds every entry point to
JAX).  All values are integers, so every comparison is exact.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import importlib
import pickle

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from swarmkit_tpu import dst as jdst
from swarmkit_tpu import multiraft as jmr
from swarmkit_tpu import parallel as jpar
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch import mc as tmc
from swarmkit_tpu_torch import multiraft as tmr
from swarmkit_tpu_torch import parallel as tpar
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.raft.sim.run import KernelObs
from swarmkit_tpu_torch.transport import device_mesh

from tests.conftest import async_test
from tests.test_torch_device_transport import (
    PortWireHarness, has_obj, propose,
)
from tests.test_torch_mc import SMOKE, _jax_scan, _same_scan, _scan_kw
from tests.test_torch_mc import _shared_jax_scan
from tests.test_torch_step import jax_numpy
from tests.test_torch_wire import one_torch_thread  # noqa: F401 (fixture)

CPU = torch.device("cpu")
DST5 = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
            election_tick=10, seed=0)
S, T = 16, 60
# tests/test_multiraft.py's CFG (TestGroupPlacement)
FLEET = dict(n=5, log_len=96, window=16, apply_batch=16, max_props=8,
             keep=8, seed=7, election_tick=10, collect_stats=True,
             read_batch=4, read_leases=True)
G, FLEET_TICKS = 16, 30
WIDTHS = (4, 8)


def cpus(d):
    return [CPU] * d


# ---------------------------------------------------------------------------
# JAX's results, once a session


def _jax_explore():
    jcfg = jstate.SimConfig(**DST5)
    jb, names = jdst.make_batch(jcfg, ticks=T, schedules=S, seed=0,
                                profiles=jdst.PROFILES)
    res = jdst.explore(jstate.init_state(jcfg), jcfg, jb, profiles=names,
                       shard=False)
    leaves = {f.name: np.asarray(getattr(jb, f.name))
              for f in dataclasses.fields(jb)
              if getattr(jb, f.name) is not None}
    return {"batch": leaves, "names": list(names), "viol": res.viol,
            "first": res.first_tick, "bits": res.bits_by_tick,
            "final": jax_numpy(res.final_state)}


def _jax_fleet():
    jcfg = jstate.SimConfig(**FLEET)
    out, trace = jmr.run_group_ticks(jmr.init_groups(jcfg, G), jcfg,
                                     FLEET_TICKS, prop_count=1)
    return {"final": jax_numpy(out), "trace": np.asarray(trace)}


_JAX = {"explore": _jax_explore, "fleet": _jax_fleet}


@pytest.fixture(scope="session")
def jax_runs(request, tmp_path_factory):
    """jax_runs(name) -> JAX's result for `name`, computed once for the
    session: under xdist the first worker to need it computes it under a
    file lock and leaves it for the others."""
    shared = (tmp_path_factory.getbasetemp().parent
              if hasattr(request.config, "workerinput") else None)

    @functools.lru_cache(maxsize=None)
    def get(name):
        if shared is None:
            return _JAX[name]()
        out = shared / f"torch_parallel_jax_{name}.pkl"
        with open(shared / "torch_parallel_jax.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not out.exists():
                    tmp = out.with_suffix(".tmp")
                    tmp.write_bytes(pickle.dumps(_JAX[name]()))
                    tmp.replace(out)
                return pickle.loads(out.read_bytes())
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    return get


def assert_fields(tag, want: dict, tst):
    got = tstate.state_to_numpy(tst)
    assert sorted(want) == sorted(got), f"{tag}: field sets differ"
    for name, w in want.items():
        if not np.array_equal(got[name], w):
            bad = np.argwhere(got[name] != w)[:5].tolist()
            raise AssertionError(f"{tag}: field {name} diverged at {bad}")


# ---------------------------------------------------------------------------
# mesh helpers


HOST_CASES = [(64, 2), (6, 2), (7, 2), (11, 2), (10, 2), (4096, 2),
              (12, 3), (8, 1), (1, 4)]


def same_mesh(jm, tm):
    assert tm.devices.shape == jm.devices.shape
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)


@pytest.mark.parametrize("rows,hosts", HOST_CASES)
def test_host_row_mesh_equals_jax(rows, hosts):
    """tests/test_sharded_sim.py's cases (2 x 4 at 64 rows, 1 x 7 at 7,
    1 x 5 at 10, 1 x 1 at 11, ...) on the single-process branch."""
    jm = jpar.host_row_mesh(rows, hosts=hosts)
    tm = tpar.host_row_mesh(rows, hosts=hosts, devices=cpus(8))
    same_mesh(jm, tm)
    assert all(d == CPU for d in tm.device_list())


@given(rows=st.integers(1, 5000), ndev=st.integers(1, 8),
       hosts=st.integers(1, 4))
@settings(max_examples=200, deadline=None)
def test_meshes_equal_jax_on_draws(rows, ndev, hosts):
    devs = jax.devices()[:ndev]
    for jfn, tfn in ((jpar.row_mesh, tpar.row_mesh),
                     (jpar.schedule_mesh, tpar.schedule_mesh),
                     (jpar.group_mesh, tpar.group_mesh)):
        same_mesh(jfn(rows, devs), tfn(rows, cpus(ndev)))
    same_mesh(jpar.host_row_mesh(rows, hosts, devs),
              tpar.host_row_mesh(rows, hosts, cpus(ndev)))
    h = min(hosts, ndev)
    assert tpar.pick_host_shape(rows, h, None, total=ndev) \
        == jpar.pick_host_shape(rows, h, None, total=ndev)


@dataclasses.dataclass(frozen=True)
class FakeDevice:
    id: int
    process_index: int


@pytest.mark.parametrize("rows,hosts,sizes", [
    (10, 2, (4, 4)), (64, 2, (4, 4)), (64, 2, (4, 2)), (64, 1, (4, 2)),
    (4, 2, (1, 4)), (48, 3, (4, 4, 4)), (7, 2, (4, 4))])
def test_pick_host_shape_and_multi_host_mesh(rows, hosts, sizes):
    """The multi-host branch on devices of several processes: hosts
    largest-first, the chips axis inside one host, the shape JAX's
    pick_host_shape gives (tests/test_sharded_sim.py's cases)."""
    devs, i = [], 0
    for p, size in enumerate(sizes):
        for _ in range(size):
            devs.append(FakeDevice(i, p))
            i += 1
    order = sorted(range(len(sizes)), key=lambda p: (-sizes[p], p))
    ordered = [sizes[p] for p in order]
    want = jpar.pick_host_shape(rows, min(hosts, len(sizes)), ordered)
    assert tpar.pick_host_shape(rows, min(hosts, len(sizes)), ordered) \
        == want
    m = tpar.host_row_mesh(rows, hosts=hosts, devices=devs)
    h, c = want
    assert m.devices.shape == (h, c) and m.axis_names == ("hosts", "chips")
    for row, p in zip(m.devices, order[:h]):
        assert [d.process_index for d in row] == [p] * c
        assert list(row) == [d for d in devs if d.process_index == p][:c]


def jax_specs(shardings) -> dict:
    return {k: tuple(v.spec) for k, v in shardings.items()}


def test_state_shardings_equal_jax_on_states():
    """init_state on row_mesh(16) (the [4] stats vector and the scalar
    tick replicate) and init_groups(cfg, 64) on group_mesh(64) with
    leading=64, leaf by leaf."""
    kw = dict(FLEET, n=16, collect_telemetry=True, telemetry_prop_ring=64)
    jcfg, tcfg = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    cases = [
        (jstate.init_state(jcfg), tstate.init_state(tcfg, device=CPU),
         jpar.row_mesh(16), tpar.row_mesh(16, cpus(8)), {}),
        (jmr.init_groups(jcfg, 64), tmr.init_groups(tcfg, 64, device=CPU),
         jpar.group_mesh(64), tpar.group_mesh(64, cpus(8)),
         {"axis": jpar.GROUP_AXIS, "leading": 64})]
    for jtree, ttree, jm, tm, kw in cases:
        js = jpar.state_shardings(jm, jtree, **kw)
        ts = tpar.state_shardings(tm, ttree, **kw)
        want = {f: tuple(getattr(js, f).spec) for f in tstate.FIELD_NAMES
                if getattr(jtree, f) is not None}
        got = {f: getattr(ts, f) for f in tstate.FIELD_NAMES
               if getattr(ttree, f) is not None}
        assert got == want
    assert want["stats"][0] == jpar.GROUP_AXIS
    js = jpar.state_shardings(jpar.row_mesh(16), jstate.init_state(jcfg))
    assert tuple(js.stats.spec) == () and tuple(js.tick.spec) == ()


def test_state_shardings_leading_rule_equals_jax():
    """tests/test_multiraft.py's placement tree: grouped leaves shard,
    a shared [8, 2] table and a scalar replicate, and an indivisible G=6
    replicates rather than erroring."""
    shapes = {"grouped": (64, 5, 7), "grouped_vec": (64,), "shared": (8, 2),
              "scalar": ()}
    jm, tm = jpar.group_mesh(64), tpar.group_mesh(64, cpus(8))
    for tree_shapes, leading in ((shapes, 64), ({"g": (6, 3)}, 6)):
        jt = {k: jax.numpy.zeros(s) for k, s in tree_shapes.items()}
        tt = {k: torch.zeros(s) for k, s in tree_shapes.items()}
        want = jax_specs(jpar.state_shardings(jm, jt, axis=jpar.GROUP_AXIS,
                                              leading=leading))
        got = tpar.state_shardings(tm, tt, axis=tpar.GROUP_AXIS,
                                   leading=leading)
        assert got == want
    assert got == {"g": ()}
    assert tpar.row_spec(3, tpar.HOST_ROW_AXES) \
        == tuple(jpar.row_spec(3, jpar.HOST_ROW_AXES))


def test_shard_rows_places_copies_and_gathers():
    """One entry: the tree itself (a placement, no copy).  D entries: D
    shards of the tree's type, split leaves cut on dim 0 and replicated
    ones copied, no storage shared with the input; gather rebuilds it."""
    cfg = tstate.SimConfig(**dict(FLEET, n=16))
    st0 = tstate.init_state(cfg, device=CPU)
    same = tpar.shard_rows(st0, tpar.row_mesh(16, cpus(1)))
    assert isinstance(same, tstate.SimState) and same.term is st0.term
    sh = tpar.shard_rows(st0, tpar.row_mesh(16, cpus(8)))
    assert isinstance(sh, tpar.Sharded) and len(sh) == 8
    assert all(isinstance(s, tstate.SimState) for s in sh.shards)
    assert sh.shards[3].match.shape == (2, 16)
    assert sh.shards[3].stats.shape == (4,)          # replicated
    ptrs = {t.data_ptr() for s in sh.shards
            for t in (s.log_term, s.stats)} | {st0.log_term.data_ptr(),
                                               st0.stats.data_ptr()}
    assert len(ptrs) == 18
    assert_fields("gather", tstate.state_to_numpy(st0), tpar.gather(sh))
    # a tuple of leaves, as JAX's scan shards (chunk, aids) together
    aids = torch.arange(16)
    pair = tpar.shard_rows((st0.term, aids), tpar.schedule_mesh(16, cpus(4)),
                           axis=tpar.SCHEDULE_AXIS)
    assert [tuple(s[1].tolist()) for s in pair.shards][1] == (4, 5, 6, 7)


def test_executor_shares_the_meshes_divisor_rule():
    from swarmkit_tpu_torch.agent import tpu

    assert tpu.pmatmul_shards is tpar.shard_count
    for rows in (8, 12, 7, 11, 1, 4096):
        assert tpar.shard_count(rows, cpus(8)) \
            == jpar.row_mesh(rows).devices.size
    totals = tpar.psum([torch.tensor(float(i)) for i in range(4)], cpus(4))
    assert [float(t) for t in totals] == [6.0] * 4


def test_no_card_no_default_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.row_mesh(8)
    assert tpar.local_devices("cpu") == [CPU]


# ---------------------------------------------------------------------------
# the batch paths, sharded = unsharded = JAX


@pytest.fixture(scope="module")
def explore_runs(jax_runs):
    j = jax_runs("explore")
    cfg = tstate.SimConfig(**DST5)
    batch = tdst.FaultSchedule.from_numpy(j["batch"], device=CPU)

    def run(mesh, shard=True):
        return tdst.explore(tstate.init_state(cfg, device=CPU), cfg, batch,
                            profiles=j["names"], shard=shard, mesh=mesh,
                            device=CPU)
    return j, run


@pytest.mark.parametrize("d", (1,) + WIDTHS)
def test_explore_sharded_equals_unsharded_and_jax(explore_runs, d):
    j, run = explore_runs
    res = run(tpar.schedule_mesh(S, cpus(d)))
    for got, want in ((res.viol, j["viol"]), (res.first_tick, j["first"]),
                      (res.bits_by_tick, j["bits"])):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert_fields(f"explore D={d}", j["final"], res.final_state)
    if d == WIDTHS[-1]:
        plain = run(None, shard=False)
        assert np.array_equal(plain.bits_by_tick, res.bits_by_tick)
        assert_fields("unsharded", tstate.state_to_numpy(plain.final_state),
                      res.final_state)


def test_explore_launches_each_shards_ticks_in_turn(monkeypatch):
    """Each tick is issued on every shard before the next tick."""
    ex = importlib.import_module("swarmkit_tpu_torch.dst.explore")
    calls = []
    real = ex._tick_one

    def spy(st, *a, **k):
        calls.append(int(st.tick.shape[0]))
        return real(st, *a, **k)
    monkeypatch.setattr(ex, "_tick_one", spy)
    cfg = tstate.SimConfig(**DST5)
    batch, _ = tdst.make_batch(cfg, 3, 8, 0, device=CPU)
    tdst.explore(tstate.init_state(cfg, device=CPU), cfg, batch,
                 mesh=tpar.schedule_mesh(8, cpus(4)), device=CPU)
    assert calls == [2] * 12


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("mutation", [None, "commit_no_quorum"])
def test_scan_sharded_equals_unsharded_and_jax(request, tmp_path_factory,
                                               d, mutation):
    """exhaustive_scan(shard=True) on the smoke scope over D CPU entries:
    the summary (ladder, passes, widest pass), the LTS edges and state
    count (the fingerprints' ids) and the violations equal the unsharded
    scan's and JAX's."""
    shared = (tmp_path_factory.getbasetemp().parent
              if hasattr(request.config, "workerinput") else None)
    j = (_jax_scan(mutation, None) if shared is None
         else _shared_jax_scan(shared, mutation, None))
    sc = tmc.SCOPES[SMOKE]
    kw = _scan_kw(mutation, None)
    t = tmc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon, shard=True,
                            mesh=tpar.schedule_mesh(4096, cpus(d)),
                            device=CPU, **kw)
    _same_scan(j, t)
    assert t.violations == j.violations
    one = tmc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon,
                              shard=False, device=CPU, **kw)
    _same_scan(one, t)


@pytest.fixture(scope="module")
def fleet_runs(jax_runs):
    j = jax_runs("fleet")
    cfg = tstate.SimConfig(**FLEET)

    def run(d):
        g0 = tmr.init_groups(cfg, G, device=CPU)
        if d > 1:
            g0 = tpar.shard_rows(g0, tpar.group_mesh(G, cpus(d)),
                                 axis=tpar.GROUP_AXIS, leading=G)
        return tmr.run_group_ticks(g0, cfg, FLEET_TICKS, prop_count=1,
                                   device=CPU)
    return j, run, {d: run(d) for d in (1,) + WIDTHS}


@pytest.mark.parametrize("d", WIDTHS)
def test_fleet_sharded_equals_unsharded_and_jax(fleet_runs, d):
    """G=16 x 30 ticks over D entries: every SimState field and every
    trace row equal the unsharded fleet's and JAX's."""
    j, _, runs = fleet_runs
    out, trace = runs[d]
    assert isinstance(out, tpar.Sharded) and len(out) == d
    assert all(s.tick.shape == (G // d,) for s in out.shards)
    assert trace.dtype == torch.int32
    assert np.array_equal(trace.numpy(), j["trace"])
    assert np.array_equal(trace.numpy(), runs[1][1].numpy())
    assert_fields(f"fleet D={d}", j["final"], tpar.gather(out))
    assert_fields("unsharded", j["final"], runs[1][0])


@pytest.mark.parametrize("d", WIDTHS)
def test_fleet_aggregates_add_the_shards_up(fleet_runs, d):
    """The aggregates, MultiRaftObs and KernelObs on a sharded fleet are
    the whole fleet's, not shard 0's."""
    _, _, runs = fleet_runs
    out, ref = runs[d][0], runs[1][0]
    assert tmr.groups_of(out) == G
    for fn in (tmr.groups_with_leader, tmr.aggregate_committed,
               tmr.aggregate_reads_served, tmr.aggregate_reads_blocked,
               tmr.group_leaders, tmr.group_commits, tmr.group_leader_mask):
        got, want = fn(out), fn(ref)
        assert got.dtype == want.dtype and torch.equal(got, want), fn
    assert int(tmr.groups_with_leader(out)) > 0
    assert tmr.MultiRaftObs(registry=MetricsRegistry()).publish(out) \
        == tmr.MultiRaftObs(registry=MetricsRegistry()).publish(ref)
    assert KernelObs(MetricsRegistry()).publish(out) \
        == KernelObs(MetricsRegistry()).publish(ref)
    for g in (0, G // d, G - 1):
        assert torch.equal(tmr.slice_group(out, g).commit,
                           tmr.slice_group(ref, g).commit)


def test_step_groups_splits_per_group_inputs():
    """step_groups on a sharded fleet cuts [G, ...] fault inputs and a [G]
    propose count into each shard's groups."""
    cfg = tstate.SimConfig(**FLEET)
    rng = np.random.default_rng(3)
    alive = torch.from_numpy(rng.random((8, 5)) > 0.2)
    drop = torch.from_numpy(rng.random((8, 5, 5)) < 0.1)
    counts = torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))

    def go(d):
        st_ = tmr.init_groups(cfg, 8, device=CPU)
        if d > 1:
            st_ = tpar.shard_rows(st_, tpar.group_mesh(8, cpus(d)),
                                  axis=tpar.GROUP_AXIS, leading=8)
        for _ in range(40):
            st_ = tmr.step_groups(st_, cfg, alive=alive, drop=drop,
                                  prop_count=counts,
                                  payload_fn=trun._payload_at, device=CPU)
        return tpar.gather(st_)
    want = tstate.state_to_numpy(go(1))
    assert_fields("step_groups D=4", want, go(4))


# ---------------------------------------------------------------------------
# the wire's all-to-all and the row tick


def test_all_to_all_is_the_transpose_from_d_squared_blocks(monkeypatch):
    rng = np.random.default_rng(11)
    R, K, W = 8, 4, 64
    words = rng.integers(-2 ** 31, 2 ** 31, (R, R, K, W)).astype(np.int32)
    lens = rng.integers(1, 4 * W, (R, R, K)).astype(np.int32)
    keep = rng.random((R, R, K)) > 0.1
    blocks = []
    real = device_mesh._block

    def spy(x, j, rows, dev):
        blocks.append((x.shape, j))
        return real(x, j, rows, dev)
    monkeypatch.setattr(device_mesh, "_block", spy)
    net = device_mesh.DeviceMeshNet(rows=R, device="cpu",
                                    mesh=tpar.row_mesh(R, cpus(4)))
    got_w, got_l = net.run_exchange(words, lens, keep)
    assert len(blocks) == 2 * 4 * 4        # D^2 blocks of words and lens
    assert {shape[:2] for shape, _ in blocks} == {(2, R)}
    one_w, one_l = device_mesh.DeviceMeshNet(
        rows=R, device="cpu").run_exchange(words, lens, keep)
    assert np.array_equal(got_w, words.transpose(1, 0, 2, 3))
    assert np.array_equal(got_l, np.where(keep, lens, 0).transpose(1, 0, 2))
    assert np.array_equal(got_w, one_w) and np.array_equal(got_l, one_l)
    with pytest.raises(ValueError, match="divide"):
        device_mesh.DeviceMeshNet(rows=6, device="cpu",
                                  mesh=tpar.Mesh(cpus(4), ("managers",)))


class MeshWireHarness(PortWireHarness):
    def __init__(self, seed: int = 7) -> None:
        super().__init__(seed=seed)
        self.network = device_mesh.DeviceMeshNet(
            seed=seed, rows=8, device="cpu", mesh=tpar.row_mesh(8, cpus(4)))


@async_test
async def test_three_nodes_replicate_over_a_four_entry_wire():
    """tests/test_torch_device_transport.py's first scenario over the
    all-to-all: bootstrap, joins, a replicated write."""
    h = MeshWireHarness()
    try:
        assert h.network.mesh.size == 4
        n1 = await h.add_node()
        await h.wait_for_leader()
        n2 = await h.add_node(join_from=n1)
        n3 = await h.add_node(join_from=n1)
        await h.wait_for_cluster()
        await propose(n1, 1)
        await h.wait_for(lambda: has_obj(n2, 1) and has_obj(n3, 1))
        assert h.network.device_flushes > 0
    finally:
        await h.close()


def test_row_sharded_state_is_refused_by_the_tick():
    """The tick takes a row-sharded state (one cluster's rows over two
    entries): run_until_leader, run_ticks and step each give the
    unsharded run's state (every field) and trace, and the result stays
    sharded; a one-entry mesh is the unsharded state itself."""
    cfg = tstate.SimConfig(**dict(FLEET, n=16))
    plain = tstate.init_state(cfg, device=CPU)
    sh = tpar.shard_rows(tstate.init_state(cfg, device=CPU),
                         tpar.row_mesh(16, cpus(2)))
    calls = (lambda st: trun.run_until_leader(st, cfg, 40, device=CPU),
             lambda st: trun.run_ticks(st, cfg, 6, prop_count=2,
                                       device=CPU),
             lambda st: (trun.step(st, cfg, device=CPU), None))
    for call in calls:
        plain, want = call(plain)
        sh, got = call(sh)
        assert isinstance(sh, tpar.Sharded) and len(sh) == 2
        assert_fields("row-sharded", tstate.state_to_numpy(plain),
                      tpar.gather(sh))
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want
    assert int(trun.committed_entries(sh)) > 0
    one = tpar.shard_rows(tstate.init_state(cfg, device=CPU),
                          tpar.row_mesh(16, cpus(1)))
    st_, trace = trun.run_ticks(one, cfg, 2, device=CPU)
    assert trace.shape == (2, 3)


def test_chip_smoke_wire_phase_on_the_cpu():
    """chip_smoke.py phase 23's wire check on four CPU entries: the
    all-to-all against the one-entry exchange on phase 22's scripted
    flushes."""
    import chip_smoke

    out = chip_smoke._sharded_wire(torch, cpus(4), CPU)
    assert out == {"shards": 4}
