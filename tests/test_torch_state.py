"""The PyTorch port's state module against the JAX package's.

SimConfig must be written the same way in both packages, init_state must
build the same fields, and the hash-based PRNGs (timeouts, drop matrices,
latency jitter, payload ids) must agree bit for bit — exact equality
throughout, since everything here is integer (drop_matrix's float32
compare included: both round uint32 -> float32 to nearest).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu.raft.sim import state as jstate
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.raft.sim import state as tstate

from tests.test_torch_step import assert_same, jax_numpy

CPU = "cpu"
SMALL = dict(log_len=1024, window=64, apply_batch=64, max_props=64, keep=32)


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jstate.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tstate.SimConfig)]
    assert tf == jf


PROPS = ("lease_ticks", "tiled", "num_chunks", "band_chunks", "peer_tiled",
         "num_peer_chunks", "active_rows_on", "ack_depth", "mailboxes",
         "storage_on", "event_width", "has_vote_guard")


@pytest.mark.parametrize("kw", [
    {}, dict(n=7, **SMALL, log_chunk=128),
    dict(n=4096, peer_chunk=512, active_rows=32),
    dict(n=16, latency=2, latency_jitter=1, inflight=2, election_tick=14),
    dict(record_events=True, collect_telemetry=True, trace_tags=True),
    dict(fsync_lag_ticks=2, ack_gating=True),
])
def test_simconfig_properties_match(kw):
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    for p in PROPS:
        assert getattr(tc, p) == getattr(jc, p), p


BAD = [
    dict(apply_batch=512, max_props=1024),
    dict(log_len=2048),
    dict(latency=-1),
    dict(inflight=0),
    dict(inflight=2),
    dict(latency=5, election_tick=10),
    dict(read_batch=-1),
    dict(read_batch=4, lease_margin=0),
    dict(read_batch=4, election_tick=1),
    dict(record_events=True, event_ring=4),
    dict(log_chunk=-1),
    dict(log_chunk=100),
    dict(log_len=8192 + 1024, log_chunk=2048),
    dict(log_len=4096, window=1024, log_chunk=1024),
    dict(collect_telemetry=True, telemetry_stride=0),
    dict(collect_telemetry=True, telemetry_window=4),
    dict(collect_telemetry=True, telemetry_prop_ring=8),
    dict(trace_tags=True),
    dict(slo_p99_commit_ticks=-1),
    dict(slo_p99_commit_ticks=5),
    dict(transfer_cooldown_ticks=-1),
    dict(prop_inflight_cap=-1),
    dict(slo_leader_changes=3),
    dict(slo_log_occupancy=-2),
    dict(fsync_lag_ticks=-1),
    dict(fsync_batch=4),
    dict(ack_gating=True),
    dict(fsync_lag_ticks=1, slo_fsync_lag=-1),
    dict(peer_chunk=-8),
    dict(peer_chunk=12, n=48),
    dict(peer_chunk=16, n=40),
    dict(active_rows=-1),
    dict(active_rows=12),
]
GOOD = [{}, dict(n=4096, log_len=8192, window=2048, apply_batch=2048,
                 max_props=2048, keep=500, election_tick=24,
                 static_members=True, collect_stats=True, peer_chunk=0,
                 active_rows=0)]


@pytest.mark.parametrize("kw", BAD + GOOD)
def test_post_init_rejects_the_same_configs(kw):
    def raises(cls):
        try:
            cls(**kw)
        except (AssertionError, ValueError):
            return True
        return False

    assert raises(tstate.SimConfig) == raises(jstate.SimConfig)
    assert raises(tstate.SimConfig) == (kw in BAD)


@pytest.mark.parametrize("n", [5, 7, 64])
@pytest.mark.parametrize("log_chunk", [0, 128])
@pytest.mark.parametrize("collect_stats", [False, True])
def test_init_state_matches(n, log_chunk, collect_stats):
    kw = dict(n=n, **SMALL, log_chunk=log_chunk, collect_stats=collect_stats,
              seed=n + log_chunk)
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    assert_same(f"init {kw}", jstate.init_state(jc),
                tstate.init_state(tc, device=CPU))


@pytest.mark.parametrize("kw", [
    dict(latency=2, latency_jitter=1, inflight=2, election_tick=14),
    dict(record_events=True, collect_telemetry=True, trace_tags=True,
         read_batch=4),
    dict(fsync_lag_ticks=2, ack_gating=True, transfer_cooldown_ticks=3),
    dict(vote_guard=True, telemetry_prop_ring=64, collect_telemetry=True),
])
def test_init_state_matches_other_levers(kw):
    kw = dict(n=8, **SMALL, **kw)
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    assert_same(f"init {kw}", jstate.init_state(jc),
                tstate.init_state(tc, device=CPU))


def test_init_state_voters_matches():
    kw = dict(n=6, **SMALL)
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    assert_same("voters", jstate.init_state(jc, voters=[0, 2, 3]),
                tstate.init_state(tc, voters=[0, 2, 3], device=CPU))
    with pytest.raises(ValueError, match="static_members"):
        tstate.init_state(tstate.SimConfig(**kw, static_members=True),
                          voters=[0, 1], device=CPU)


def _u32_samples(rng, count=1 << 17):
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                    np.uint32)
    return np.concatenate([edge, rng.integers(0, 2**32, count,
                                               dtype=np.uint32)])


def test_hash32_matches():
    x = _u32_samples(np.random.default_rng(1))
    want = np.asarray(jstate.hash32(jnp.asarray(x)))
    got = tstate.hash32(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("seed,election_tick", [(0, 10), (3, 14),
                                                 (2**31 + 7, 24)])
def test_rand_timeout_matches(seed, election_tick):
    rng = np.random.default_rng(seed % 1000)
    node = rng.integers(-2**31, 2**31, 1 << 16, dtype=np.int64) \
        .astype(np.int32)
    term = rng.integers(0, 2**31, 1 << 16, dtype=np.int64).astype(np.int32)
    jc = jstate.SimConfig(seed=seed, election_tick=election_tick)
    tc = tstate.SimConfig(seed=seed, election_tick=election_tick)
    want = np.asarray(jstate.rand_timeout(jc, jnp.asarray(node),
                                          jnp.asarray(term)))
    got = tstate.rand_timeout(tc, torch.from_numpy(node),
                              torch.from_numpy(term)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.05, 0.5, 0.999])
def test_drop_matrix_matches(rate):
    kw = dict(n=256, seed=11)   # 65536 edges per tick
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    for tick in (0, 1, 77, 2**31 - 1):
        want = np.asarray(jstate.drop_matrix(jc, jnp.asarray(tick, jnp.int32),
                                             rate))
        got = tstate.drop_matrix(tc, torch.tensor(tick, dtype=torch.int32),
                                 rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_latency_matrix_matches():
    kw = dict(n=64, latency=2, latency_jitter=3, election_tick=20, seed=9)
    jc, tc = jstate.SimConfig(**kw), tstate.SimConfig(**kw)
    for tick in (0, 5, 123456):
        want = np.asarray(jstate.latency_matrix(jc, jnp.asarray(tick,
                                                                jnp.int32)))
        got = tstate.latency_matrix(tc, torch.tensor(tick, dtype=torch.int32),
                                    device=CPU).numpy()
        np.testing.assert_array_equal(got, want)


def test_payload_ids_match():
    k = np.arange(0, 4096, dtype=np.uint32)
    for tick in (0, 3, 65535, 65536, 2**31 - 1):
        want = np.asarray(jrun._payload_at(jnp.asarray(tick, jnp.int32),
                                           jnp.asarray(k)))
        got = trun._payload_at(torch.tensor(tick, dtype=torch.int32),
                               torch.from_numpy(k.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want)


def test_carry_across_round_trips():
    """A JAX state after an election and some appends, carried into the
    port and back, is field-equal (uint32 fields keep their bits)."""
    from swarmkit_tpu.raft.sim import run_ticks, run_until_leader

    jc = jstate.SimConfig(n=5, **SMALL, log_chunk=128, collect_stats=True,
                          static_members=True)
    js, _ = run_until_leader(jstate.init_state(jc), jc, max_ticks=100)
    js, _ = run_ticks(js, jc, 20, prop_count=40)
    d = jax_numpy(js)
    assert d["log_data"].dtype == np.uint32 and d["log_data"].max() > 0
    ts = tstate.state_from_numpy(d, device=CPU)
    assert ts.log_data.dtype == torch.int32 and ts.active_ttl is None
    assert_same("round trip", js, ts)
    back = tstate.state_to_numpy(ts)
    for name, a in d.items():
        assert back[name].dtype == a.dtype
        np.testing.assert_array_equal(back[name], a)
