"""The port's bench entry (swarmkit_tpu_torch.tools.bench) on the CPU.

A small run (n=64, a few thousand entries, 8-tick chunks, no secondary
configurations) prints bench.py's JSON line with every key, the kernel
counters KernelObs published and the telemetry probe's commit latency
included, and passes its own safety check; without a card and without
--device cpu it raises instead of running on the CPU.  The sharded rung's
flow (shard=True) runs at n=64 on a one-entry mesh and stops over several
entries; measure_multiraft shards its fleet over several.
"""

from __future__ import annotations

import json

import pytest
import torch

from swarmkit_tpu_torch.tools import bench

from tests.test_torch_wire import one_torch_thread  # noqa: F401 (fixture)

KEYS = {"metric", "value", "unit", "vs_baseline", "election_ticks",
        "election_s_incl_compile", "election_s_post_compile",
        "safety_ok", "replicas_near_tip", "peak_bytes",
        "configs_entries_per_s", "card", "device", "kernel_stats",
        "commit_latency_ticks_p50", "commit_latency_ticks_p99",
        "ms_per_tick", "host_syncs_per_tick", "slab_ticks",
        "dense_fallback_ticks", "warm_pass_s"}


def test_cpu_run_prints_the_bench_line(capsys):
    out = bench.main(["--device", "cpu", "--n", "64", "--entries", "4000",
                      "--chunk-ticks", "8", "--no-configs"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert KEYS <= set(line), KEYS - set(line)
    assert "error" not in line
    assert line["safety_ok"] is True
    assert line["replicas_near_tip"] == 64
    assert line["value"] > 0 and line["unit"] == "entries/s"
    assert line["election_ticks"] > 0
    # 8 timed ticks at n=64 > A=16: every steady tick on the slab, one
    # host read-back each (the band probe carries the slab's fit)
    assert line["slab_ticks"] == 8 and line["dense_fallback_ticks"] == 0
    assert line["host_syncs_per_tick"] == 1.0
    assert line["device"] == {"platform": "cpu", "kind": "cpu"}
    assert line["card"] is None and line["peak_bytes"] is None
    assert "absent" not in line
    stats = line["kernel_stats"]
    assert stats["commit_advance"] > 0 and stats["elections_won"] >= 1
    assert 1 <= line["commit_latency_ticks_p50"] \
        <= line["commit_latency_ticks_p99"] <= 256
    assert line["configs_entries_per_s"] == "skipped (--no-configs)"


def test_election_tick_for_matches_bench_py():
    import bench as jax_bench   # the repo's bench.py; imports no JAX at load
    for n in (3, 16, 64, 256, 1024, 4096, 32768):
        assert bench.election_tick_for(n) == jax_bench.election_tick_for(n)
    assert bench.election_tick_for(4096) == 24


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--n", "64", "--entries", "100", "--no-configs"])


def test_measure_runs_the_mailbox_wire_on_the_cpu():
    """measure() with bench.py's mailbox wire (latency 2, jitter 1, four
    pipelined appends) at n=32: a leader, commits, and bench.py's safety
    line (checksum agreement, a quorum of rows near the tip)."""
    m = bench.measure(32, 10000, 7, bench.election_tick_for(32),
                      torch.device("cpu"), chunk=8, latency=2,
                      latency_jitter=1, inflight=4)
    cfg = m["cfg"]
    assert cfg.mailboxes and (cfg.latency, cfg.latency_jitter,
                              cfg.inflight) == (2, 1, 4)
    assert m["committed"] > 0 and m["rate"] > 0
    safety_ok, near_tip = bench._safety(m)
    assert safety_ok and near_tip >= 32 // 2 + 1
    assert int(bench.leader_mask(m["final"]).sum()) == 1
    assert m["counts"]["host_syncs"] == m["timed_ticks"]


def test_readmix_and_fsyncgate_on_the_cpu():
    """The two configurations of this bench's read and durability cells at
    n=64: bench.py's read keys (served reads at least 10x committed
    entries, linearizable, one leader) and the fsync-gate A/B's keys
    (both rates, their ratio, durability at the end)."""
    cpu = torch.device("cpu")
    rm = bench.readmix(64, 4000, cpu, chunk=8)
    keys = rm["keys"]
    assert {"read_metric", "reads_per_second", "read_write_ratio",
            "reads_blocked"} <= set(keys)
    assert "note" not in keys and keys["read_write_ratio"] >= 10
    assert rm["leaders"] == 1 and rm["linearizable"] and rm["rate"] > 0
    fg = bench.fsyncgate(64, 4000, cpu, chunk=8)
    assert set(fg) == {"dense", "gated_k4", "gated_over_dense", "durable",
                       "telemetry"}
    assert rm["telemetry"]["commit_latency_ticks_p50"] is not None
    assert fg["telemetry"]["commit_latency_ticks_p99"] is not None
    assert fg["dense"] > 0 and fg["gated_k4"] > 0 and fg["durable"]
    assert fg["gated_over_dense"] == fg["gated_k4"] / fg["dense"]


def test_measure_multiraft_on_the_cpu():
    """bench.py's measure_multiraft flow at G=8 groups of 3: the fleet
    elects (99% of the groups), commits and serves reads in the timed
    chunks, and a steady grouped tick reads nothing back."""
    m = bench.measure_multiraft(8, 3, 2000, 7, torch.device("cpu"), chunk=8)
    assert m["groups_with_leader"] >= 8 * 99 // 100 and m["groups"] == 8
    assert m["elect_ticks"] % 32 == 0 and m["elect_ticks"] > 0
    assert m["committed"] > 0 and m["rate"] > 0 and m["read_rate"] > 0
    assert m["timed_ticks"] == 104 and m["counts"]["host_syncs"] == 0
    assert m["cfg"].max_props == 32 and m["cfg"].read_batch == 32


def test_multiraft_telemetry_pair_on_the_cpu():
    """The telemetry A/B in turns at G=4: bench.py's keys, the ratio's
    spread over the pairs, and a telemetry fleet whose per-group
    summaries saw commits."""
    from swarmkit_tpu_torch.telemetry import summarize_groups

    ab = bench.multiraft_telemetry_ab(4, 3, 1000, torch.device("cpu"),
                                      pairs=2, chunk=16)
    assert {"dense", "telemetry", "telemetry_over_dense"} <= set(ab)
    assert ab["dense"] > 0 and ab["telemetry"] > 0
    assert ab["telemetry_over_dense_min"] <= ab["telemetry_over_dense"] \
        <= ab["telemetry_over_dense_max"] and ab["pairs"] == 2
    summ = summarize_groups(ab["final_telemetry"], ab["cfg"])
    assert len(summ) == 4 and all(s["commit"]["total"] > 0 for s in summ)
    assert ab["final_bare"].tel_commit_hist is None


def test_sharded_rung_flow_on_a_one_entry_mesh():
    """bench.py's 32768-sharded flow at n=64 with shard=True: every fresh
    state is placed on row_mesh(n) over the local devices, one entry here
    (the whole state on the device, as on one H100), and the run is the
    unsharded run, bit for bit."""
    from swarmkit_tpu_torch.tools.bench import SHARDED_RUNG

    name, n, kw = SHARDED_RUNG
    assert (name, n, kw) == ("32768-sharded", 32768,
                             {"shard": True, "peer_chunk": 1024})
    cpu = torch.device("cpu")
    m = bench.measure(64, 4000, 7, bench.election_tick_for(64), cpu,
                      chunk=8, shard=True, peer_chunk=16)
    plain = bench.measure(64, 4000, 7, bench.election_tick_for(64), cpu,
                          chunk=8, peer_chunk=16)
    assert m["mesh_devices"] == 1 and m["cfg"].peer_chunk == 16
    assert m["committed"] == plain["committed"] > 0
    assert m["election_ticks"] == plain["election_ticks"]
    assert torch.equal(m["final"].commit, plain["final"].commit)
    assert bench._safety(m)[0]


def test_sharded_rung_over_several_devices_stops(monkeypatch):
    """Over several devices (two CPU entries here) the rung's row mesh has
    D > 1 entries and the flow runs the row tick on both: it commits
    exactly what the unsharded flow does, elects in as many ticks, ends
    with the same commit row and counters, and its final state stays
    sharded."""
    from swarmkit_tpu_torch import parallel

    cpu = torch.device("cpu")
    plain = bench.measure(64, 4000, 7, bench.election_tick_for(64), cpu,
                          chunk=8, peer_chunk=16)
    monkeypatch.setattr(parallel, "local_devices",
                        lambda device=None: [cpu] * 2)
    m = bench.measure(64, 4000, 7, bench.election_tick_for(64), cpu,
                      chunk=8, shard=True, peer_chunk=16)
    assert m["mesh_devices"] == 2 and isinstance(m["final"],
                                                 parallel.Sharded)
    assert m["committed"] == plain["committed"] > 0
    assert m["election_ticks"] == plain["election_ticks"]
    assert m["kernel_stats"] == plain["kernel_stats"]
    assert m["counts"] == plain["counts"]
    assert torch.equal(parallel.gather(m["final"]).commit,
                       plain["final"].commit)
    assert bench._safety(m) == bench._safety(plain) and bench._safety(m)[0]


def test_measure_multiraft_shards_its_groups(monkeypatch):
    """With several local devices (four CPU entries here) the fleet's
    groups shard over group_mesh(G), as bench.py's do, and the flow
    commits exactly what the unsharded one does."""
    from swarmkit_tpu_torch import parallel

    cpu = torch.device("cpu")
    plain = bench.measure_multiraft(8, 3, 2000, 7, cpu, chunk=8)
    monkeypatch.setattr(parallel, "local_devices",
                        lambda device=None: [cpu] * 4)
    m = bench.measure_multiraft(8, 3, 2000, 7, cpu, chunk=8)
    assert m["mesh_devices"] == 4 and plain["mesh_devices"] == 1
    assert isinstance(m["final"], parallel.Sharded)
    assert (m["committed"], m["reads"], m["elect_ticks"],
            m["groups_with_leader"]) == (
        plain["committed"], plain["reads"], plain["elect_ticks"],
        plain["groups_with_leader"])
