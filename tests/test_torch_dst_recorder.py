"""The flight recorder under the DST sweep's batch axis, against the JAX
package: the pre-step verbs' attack and storage events on a batched
state's [B, N, cap, W] rings (flightrec/codes.py::ring_append's batched
form, through dst/schedule.py::_emit_attack).

The probe: SimConfig(n=5, log_len=64, window=8, apply_batch=16,
max_props=8, keep=4, election_tick=10, seed=0, record_events=True), JAX's
make_batch(ticks=60, schedules=8, seed=0) on ATTACK_PROFILES (PreVote
off) and on STORAGE_PROFILES (fsync_lag_ticks=2), carried across with
FaultSchedule.from_numpy.  The port's explore equals JAX's on viol,
first_tick, bits_by_tick and every final field (ev_buf and ev_pos
included), unsharded and over schedule_mesh(8) of four CPU entries; a
shrink of a violating attack schedule (its [K] replays record too)
equals JAX's shrunk arrays and evals.  JAX's results are computed once a
session and shared through a file under pytest's temporary root.  All
values are integers: exact equality.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import pickle

import numpy as np
import pytest
import torch

from swarmkit_tpu import dst as jdst
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch import parallel as tpar
from swarmkit_tpu_torch.flightrec import codes as fc
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import jax_numpy

CPU = "cpu"
PROBE = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
             election_tick=10, seed=0, record_events=True)
SUITES = {"attack": ("ATTACK_PROFILES", {}),
          "storage": ("STORAGE_PROFILES", {"fsync_lag_ticks": 2})}
T, S = 60, 8
SIGNATURES = {"attack": {fc.ATTACK_REJOIN, fc.ATTACK_EQUIVOCATE,
                         fc.ATTACK_FLOOD, fc.ATTACK_TRANSFER},
              "storage": {fc.RECOVER_TRUNCATE, fc.RECOVER_TORN,
                          fc.FSYNC_STALL, fc.SNAP_CORRUPT}}


def _kw(suite: str) -> dict:
    return dict(PROBE, **SUITES[suite][1])


def _jax_batch(suite: str):
    jcfg = jstate.SimConfig(**_kw(suite))
    return jcfg, jdst.make_batch(jcfg, ticks=T, schedules=S, seed=0,
                                 profiles=getattr(jdst, SUITES[suite][0]))


def _jax_run(key: str) -> dict:
    """JAX's explore of a suite ("attack", "storage"), or its shrink of
    the first violating attack schedule ("shrink")."""
    suite = "attack" if key == "shrink" else key
    jcfg, (jb, names) = _jax_batch(suite)
    res = jdst.explore(jstate.init_state(jcfg), jcfg, jb, profiles=names,
                       shard=False)
    batch = {f.name: np.asarray(getattr(jb, f.name))
             for f in dataclasses.fields(jb) if getattr(jb, f.name) is not None}
    out = {"batch": batch, "names": list(names), "viol": res.viol,
           "first": res.first_tick, "bits": res.bits_by_tick,
           "final": jax_numpy(res.final_state)}
    if key == "shrink":
        s = int(res.violating[0])
        small, evals = jdst.shrink(jcfg, jb.slice(s), int(res.viol[s]), 2)
        out.update(index=s, evals=evals, small={
            f.name: np.asarray(getattr(small, f.name))
            for f in dataclasses.fields(small)
            if getattr(small, f.name) is not None})
    return out


@pytest.fixture(scope="session")
def jax_runs(request, tmp_path_factory):
    """jax_runs(key) -> _jax_run(key), computed once a session (under
    xdist by the first worker that needs it, under a file lock)."""
    shared = (tmp_path_factory.getbasetemp().parent
              if hasattr(request.config, "workerinput") else None)

    @functools.lru_cache(maxsize=None)
    def get(key):
        if shared is None:
            return _jax_run(key)
        out = shared / f"torch_dst_recorder_jax_{key}.pkl"
        with open(shared / "torch_dst_recorder_jax.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not out.exists():
                    tmp = out.with_suffix(".tmp")
                    tmp.write_bytes(pickle.dumps(_jax_run(key)))
                    tmp.replace(out)
                return pickle.loads(out.read_bytes())
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    return get


def _port_explore(suite: str, want: dict, mesh=None):
    tcfg = tstate.SimConfig(**_kw(suite))
    tb = tdst.FaultSchedule.from_numpy(want["batch"], device=CPU)
    return tdst.explore(tstate.init_state(tcfg, device=CPU), tcfg, tb,
                        profiles=want["names"], device=CPU,
                        shard=mesh is not None, mesh=mesh)


def _same_result(tag: str, want: dict, res) -> None:
    assert np.array_equal(res.viol, want["viol"]), tag
    assert np.array_equal(res.first_tick, want["first"]), tag
    assert np.array_equal(res.bits_by_tick, want["bits"]), tag
    got = tstate.state_to_numpy(tpar.gather(res.final_state, CPU))
    assert sorted(got) == sorted(want["final"]), f"{tag}: field sets differ"
    assert "ev_buf" in got and "ev_pos" in got
    for name, w in want["final"].items():
        if not np.array_equal(got[name], w):
            bad = np.argwhere(got[name] != w)[:5].tolist()
            raise AssertionError(f"{tag}: field {name} diverged at {bad}")


def test_batched_ring_append_equals_per_cluster_appends():
    """ring_append on B clusters' [B, N, cap, W] rings equals B calls on
    each cluster's own ring, with [B, N] and per-cluster [B, 1] arguments
    and a [B] tick, tagged rings too."""
    g = torch.Generator().manual_seed(6)
    b, n, cap = 3, 5, 4
    for width in (fc.EVENT_WIDTH, fc.EVENT_WIDTH_TAGGED):
        buf = torch.randint(-9, 9, (b, n, cap, width), generator=g,
                            dtype=torch.int32)
        pos = torch.randint(0, 11, (b, n), generator=g, dtype=torch.int32)
        mask = torch.rand((b, n), generator=g) < 0.6
        tick = torch.tensor([3, 4, 5], dtype=torch.int32)
        a0 = torch.randint(0, 99, (b, n), generator=g, dtype=torch.int32)
        a1 = torch.tensor([[7], [8], [9]], dtype=torch.int32)
        tag = torch.tensor([[1], [2], [3]], dtype=torch.int32)
        want_buf, want_pos = buf.clone(), pos.clone()
        for c in range(b):
            cb, cp = fc.ring_append(want_buf[c], want_pos[c], mask[c],
                                    tick[c], fc.ATTACK_FLOOD, a0[c],
                                    a1[c].expand(n), tag[c].expand(n))
            want_buf[c], want_pos[c] = cb, cp
        got_buf, got_pos = fc.ring_append(buf.clone(), pos.clone(), mask,
                                          tick, fc.ATTACK_FLOOD, a0, a1, tag)
        assert torch.equal(got_buf, want_buf)
        assert torch.equal(got_pos, want_pos)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_recording_explore_equals_jax(suite, jax_runs):
    want = jax_runs(suite)
    res = _port_explore(suite, want)
    _same_result(suite, want, res)
    codes = set(want["final"]["ev_buf"][..., 1].ravel().tolist())
    assert codes & SIGNATURES[suite], f"{suite}: no verb wrote an event"


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_recording_explore_over_four_entries_equals_jax(suite, jax_runs):
    want = jax_runs(suite)
    mesh = tpar.schedule_mesh(S, [torch.device(CPU)] * 4)
    assert mesh.size == 4
    _same_result(f"{suite} over 4 entries", want,
                 _port_explore(suite, want, mesh))


def test_recording_shrink_replays_equal_jax(jax_runs):
    want = jax_runs("shrink")
    s = want["index"]
    tcfg = tstate.SimConfig(**_kw("attack"))
    tb = tdst.FaultSchedule.from_numpy(want["batch"], device=CPU)
    small, evals = tdst.shrink(tcfg, tb.slice(s), int(want["viol"][s]), 2,
                               device=CPU)
    assert evals == want["evals"]
    got = small.to_numpy()
    assert sorted(got) == sorted(want["small"])
    for k, v in want["small"].items():
        assert np.array_equal(got[k], v), k
