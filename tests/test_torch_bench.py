"""The port's bench entry (swarmkit_tpu_torch.tools.bench) on the CPU.

A small run (n=64, a few thousand entries, 8-tick chunks, no secondary
configurations) prints bench.py's JSON line with every key, passes its own
safety check, and says what the port does not measure yet; without a card
and without --device cpu it raises instead of running on the CPU.
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
        "configs_entries_per_s", "card", "device", "absent",
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
    assert any("KernelObs" in a for a in line["absent"])
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
    assert set(fg) == {"dense", "gated_k4", "gated_over_dense", "durable"}
    assert fg["dense"] > 0 and fg["gated_k4"] > 0 and fg["durable"]
    assert fg["gated_over_dense"] == fg["gated_k4"] / fg["dense"]
