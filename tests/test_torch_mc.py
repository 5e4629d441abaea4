"""The port's exhaustive model checker (swarmkit_tpu_torch/mc/) against the
JAX package's (swarmkit_tpu/mc/), on the CPU.

The same inputs go through both packages and must give the same values:
the action alphabets (n=3 and n=4, with and without term_inflation), the
branch/path codecs and the lowered FaultSchedule leaves; fingerprints,
node relabelings and canonical fingerprints of states from a DST run
(carried across with state_from_numpy); the smoke scope's whole scan (its
summary, level ladder, LTS edges and state count, and the Aldebaran .aut
bytes), a budget-truncated scan, and the commit_no_quorum mutation's
violations.  Repro artifacts cross-load both ways: each package replays
the other's exactly.  All values are integers, so every comparison is
exact.  Each JAX smoke scan runs once for the test session, on one
device as the port's does, shared by the xdist workers through a file
under pytest's temporary root (the `scans` fixture); it runs only the
4096-wide pass.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import importlib
import json
import os
import pathlib
import pickle
import sys

import jax
import numpy as np
import pytest

from swarmkit_tpu import dst as jdst
from swarmkit_tpu import mc as jmc
from swarmkit_tpu.dst import repro as jrepro
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import mc as tmc
from swarmkit_tpu_torch.dst import repro as trepro
from swarmkit_tpu_torch.metrics import catalog as tcatalog
from swarmkit_tpu_torch.mc import metrics as tmetrics
from swarmkit_tpu_torch.raft.sim import state as tstate
from swarmkit_tpu_torch.tools import mc_export as texport
from swarmkit_tpu_torch.tools import mc_sweep as tsweep

from tests.test_torch_step import jax_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import mc_export as jexport  # noqa: E402

CPU = "cpu"
SMOKE = "smoke"
# the smoke scope's per-level (children, unique) ladder (tests/test_mc.py)
SMOKE_LEVELS = ((13, 4), (52, 29), (377, 225), (2925, 1403))
jfp = importlib.import_module("swarmkit_tpu.mc.fingerprint")
tfp = importlib.import_module("swarmkit_tpu_torch.mc.fingerprint")


def _scan_kw(mutation, budget):
    return dict(prop_count=jmc.SCOPES[SMOKE].prop_count, mutation=mutation,
                budget=budget, collect_edges=True, scope=SMOKE)


def _jax_scan(mutation, budget):
    """JAX's scan on one device (shard=False), the counterpart of the
    port's one-card scan, which takes shard= and ignores it.  Sharding is
    a layout: the sharded scan gives the same summary, edges, states and
    violations.  Under xdist load its all-reduce over the 8 virtual CPU
    devices can miss XLA's 40 s rendezvous timeout and abort the worker
    (rendezvous.cc "Termination timeout ... Exiting"); tests/test_mc.py
    covers the sharded path."""
    sc = jmc.SCOPES[SMOKE]
    return jmc.exhaustive_scan(sc.cfg(), sc.alphabet(), sc.horizon,
                               shard=False, **_scan_kw(mutation, budget))


def _shared_jax_scan(shared: pathlib.Path, mutation, budget):
    """JAX's scan for (mutation, budget), run once for the whole test
    session: under xdist the workers share `shared`, and the first to need
    a scan runs it under a file lock and leaves it there for the others.
    One lock serializes all of this file's JAX scans, so at most one runs
    at a time beside tests/test_mc.py's own."""
    out = shared / f"torch_mc_jax_scan_{mutation}_{budget}.pkl"
    with open(shared / "torch_mc_jax_scan.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_suffix(".tmp")
                tmp.write_bytes(pickle.dumps(_jax_scan(mutation, budget)))
                tmp.replace(out)
            return pickle.loads(out.read_bytes())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="session")
def scans(request, tmp_path_factory):
    """scans(mutation=None, budget=None) -> JAX's and the port's
    exhaustive_scan of the smoke scope (edges on), each computed once:
    JAX's once for the session across the xdist workers, the port's once
    a worker."""
    shared = (tmp_path_factory.getbasetemp().parent
              if hasattr(request.config, "workerinput") else None)

    @functools.lru_cache(maxsize=None)
    def get(mutation=None, budget=None):
        j = (_jax_scan(mutation, budget) if shared is None
             else _shared_jax_scan(shared, mutation, budget))
        tsc = tmc.SCOPES[SMOKE]
        t = tmc.exhaustive_scan(tsc.cfg(), tsc.alphabet(), tsc.horizon,
                                device=CPU, **_scan_kw(mutation, budget))
        return j, t

    return get


def _same_scan(j, t):
    drop = ("elapsed_sec", "branches_per_sec")
    js = {k: v for k, v in j.summary().items() if k not in drop}
    ts = {k: v for k, v in t.summary().items() if k not in drop}
    assert ts == js
    assert t.edges == j.edges and t.num_states == j.num_states


# ---------------------------------------------------------------------------
# branch space


@pytest.mark.parametrize("n,inflation", [(3, False), (3, True), (4, False),
                                         (4, True)])
def test_alphabet_equals_jax(n, inflation):
    ja = jmc.build_alphabet(n, term_inflation=inflation)
    ta = tmc.build_alphabet(n, term_inflation=inflation)
    assert ta.names == ja.names and ta.size == ja.size
    assert {(3, False): 13, (3, True): 16, (4, False): 24,
            (4, True): 28}[(n, inflation)] == ta.size
    assert np.array_equal(ta.alive, ja.alive)
    assert np.array_equal(ta.drop, ja.drop)
    assert (ta.inflate is None) == (ja.inflate is None)
    if inflation:
        assert np.array_equal(ta.inflate, ja.inflate)
    alive, drop, inflate = ta.tables(CPU)
    assert np.array_equal(alive.numpy(), ja.alive)
    assert np.array_equal(drop.numpy(), ja.drop)
    assert (inflate is None) == (not inflation)


def test_codecs_and_lowered_schedules_equal_jax():
    rng = np.random.default_rng(3)
    for size, depth in ((13, 8), (16, 8), (24, 5)):
        for branch in rng.integers(0, size ** depth, 20).tolist():
            path = tmc.branch_to_path(branch, size, depth)
            assert path == jmc.branch_to_path(branch, size, depth)
            assert tmc.path_to_branch(path, size) == branch
    with pytest.raises(ValueError):
        tmc.branch_to_path(13 ** 4, 13, 4)
    with pytest.raises(ValueError):
        tmc.path_to_branch([13], 13)
    for inflation in (False, True):
        ja = jmc.build_alphabet(3, term_inflation=inflation)
        ta = tmc.build_alphabet(3, term_inflation=inflation)
        for path in ([], [0, 1, 10, 0], list(range(ta.size))):
            js = jmc.path_to_schedule(ja, path)
            ts = tmc.path_to_schedule(ta, path, device=CPU).to_numpy()
            want = {k: np.asarray(v) for k, v in vars(js).items()
                    if v is not None}
            assert sorted(ts) == sorted(want)
            for k, w in want.items():
                assert np.array_equal(ts[k], w), (path, k)


def test_scopes_equal_jax():
    assert sorted(tmc.SCOPES) == sorted(jmc.SCOPES)
    for name, js in jmc.SCOPES.items():
        ts = tmc.SCOPES[name]
        assert (ts.n, ts.horizon, ts.term_inflation, ts.budget,
                ts.prop_count) == (js.n, js.horizon, js.term_inflation,
                                   js.budget, js.prop_count)
        assert ts.space_size() == js.space_size()
        assert dataclasses.asdict(ts.cfg()) == dataclasses.asdict(js.cfg())


def test_metric_names_are_in_the_catalog():
    for name, labels in tmetrics.METRIC_NAMES.items():
        assert tcatalog.CATALOG[name].labels == labels
    assert {k for k in tcatalog.CATALOG if k.startswith("swarm_mc_")} \
        == set(tmetrics.METRIC_NAMES)


# ---------------------------------------------------------------------------
# fingerprints


@functools.lru_cache(maxsize=None)
def dst_states():
    """A [4, ...] batch of smoke-config states after 24 DST ticks."""
    cfg = jmc.SCOPES[SMOKE].cfg()
    batch, names = jdst.make_batch(cfg, ticks=24, schedules=4, seed=2)
    res = jdst.explore(jstate.init_state(cfg), cfg, batch, profiles=names)
    return res.final_state


def test_fingerprints_equal_jax_on_dst_states():
    jb = dst_states()
    tb = tstate.state_from_numpy(jax_numpy(jb), device=CPU)
    want = np.asarray(jax.vmap(jfp.fingerprint)(jb))
    got = tfp.fingerprint(tb).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert len({tuple(r) for r in got.tolist()}) == 4
    n = jb.vote.shape[-1]
    want_c = np.asarray(jax.vmap(
        lambda s: jfp.canonical_fingerprint(s, n))(jb))
    assert np.array_equal(tfp.canonical_fingerprint(tb, n).numpy(), want_c)
    for b in range(2):
        one = jax.tree_util.tree_map(lambda a: a[b], jb)
        tone = tstate.state_from_numpy(jax_numpy(one), device=CPU)
        assert np.array_equal(tfp.fingerprint(tone).numpy(),
                              np.asarray(jfp.fingerprint(one)))
        for perm in ((1, 2, 0), (2, 1, 0)):
            want_r = jax_numpy(jfp.relabel_state(one, perm))
            got_r = tstate.state_to_numpy(tfp.relabel_state(tone, perm))
            assert sorted(got_r) == sorted(want_r)
            for k, w in want_r.items():
                assert np.array_equal(got_r[k], w), (perm, k)
    # batched relabeling relabels every cluster alike
    rb = tstate.state_to_numpy(tfp.relabel_state(tb, (2, 0, 1)))
    r0 = tstate.state_to_numpy(tfp.relabel_state(
        tstate.state_from_numpy({k: v[0] for k, v in jax_numpy(jb).items()},
                                device=CPU), (2, 0, 1)))
    for k, w in r0.items():
        assert np.array_equal(rb[k][0], w), k


# ---------------------------------------------------------------------------
# the scan


def test_smoke_scan_equals_jax(scans):
    j, t = scans()
    _same_scan(j, t)
    assert tuple((lv["children"], lv["unique"]) for lv in t.levels) \
        == SMOKE_LEVELS
    assert t.exhaustive and not t.violations and t.passes == 4
    assert set(t.timing) == {"device_s", "host_s"}


def test_budget_truncation_equals_jax(scans):
    j, t = scans(budget=16)
    _same_scan(j, t)
    assert t.truncated and not t.exhaustive
    assert all(lv["unique"] <= 16 for lv in t.levels)


def test_commit_no_quorum_caught_on_jaxs_path(scans):
    j, t = scans(mutation="commit_no_quorum")
    _same_scan(j, t)
    assert t.violations and t.stopped_early
    assert t.violations[0]["path"] == j.violations[0]["path"]


def test_aut_bytes_equal_jax(tmp_path, scans):
    j, t = scans()
    names = tmc.SCOPES[SMOKE].alphabet().names
    jp, tp = str(tmp_path / "j.aut"), str(tmp_path / "t.aut")
    jexport.write_aut(jp, j.edges, j.num_states, names)
    texport.export_scope(SMOKE, tp, verbose=False, device=CPU)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    assert texport.validate_aut(tp) == []
    lines = open(tp, encoding="utf-8").read().splitlines()
    bad = str(tmp_path / "bad.aut")
    with open(bad, "w", encoding="utf-8") as f:
        f.write("\n".join([lines[0]] + lines[2:]))
    assert texport.validate_aut(bad)


def test_artifacts_cross_load_both_ways(tmp_path, scans):
    """The port's artifact of the commit_no_quorum violation (shrunk, with
    a flight capture) replays exactly in the JAX package; JAX's (unshrunk,
    no capture) equals the port's key for key and replays exactly here."""
    j, t = scans(mutation="commit_no_quorum")
    v = t.violations[0]
    sc, jsc = tmc.SCOPES[SMOKE], jmc.SCOPES[SMOKE]
    art = tmc.violation_artifact(sc.cfg(), sc.alphabet(), v,
                                 mutation="commit_no_quorum", scope=SMOKE,
                                 device=CPU)
    assert art["profile"] == "mc:smoke" and art["mc"]["actions"]
    path = str(tmp_path / "port.json")
    trepro.save_artifact(path, art)
    assert jrepro.replay_artifact(path, with_trace=False)["matches_recorded"]
    plain = dict(do_shrink=False, flight=False,
                 mutation="commit_no_quorum", scope=SMOKE)
    jart = jmc.violation_artifact(jsc.cfg(), jsc.alphabet(),
                                  j.violations[0], **plain)
    tart = tmc.violation_artifact(sc.cfg(), sc.alphabet(), v, device=CPU,
                                  **plain)
    assert tart == jart
    jpath = str(tmp_path / "jax.json")
    jrepro.save_artifact(jpath, jart)
    assert trepro.replay_artifact(jpath, with_trace=False,
                                  device=CPU)["matches_recorded"]


def test_mc_sweep_cli_smoke(tmp_path, capsys, scans):
    out = str(tmp_path / "summary.json")
    assert tsweep.main(["--smoke", "--json", out, "--device", CPU]) == 0
    assert "PASS" in capsys.readouterr().out
    with open(out, encoding="utf-8") as f:
        summary = json.load(f)
    j, _ = scans()
    drop = ("elapsed_sec", "branches_per_sec")
    assert {k: v for k, v in summary.items() if k not in drop} \
        == {k: v for k, v in j.summary().items() if k not in drop}
