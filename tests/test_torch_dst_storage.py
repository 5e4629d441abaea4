"""The port's explore against the JAX package's on the storage sweep:
EXTRA_PROFILES (the attack and storage-fault verbs) with fsync every 4
ticks under ack gating, the read path, telemetry and every SLO bound, on
JAX's own make_batch schedules carried across.  viol, first_tick,
bits_by_tick and every final field are compared exactly; a violating
schedule, when the sweep has one, replays to the same bits in both
packages.  Also the port's dst_sweep CLI on the CPU (sweep, mutation
self-test, artifact, replay).
"""

from __future__ import annotations

import numpy as np

from swarmkit_tpu import dst as jdst
from swarmkit_tpu_torch import dst as tdst
from swarmkit_tpu_torch.tools import dst_sweep

from tests.test_torch_dst import (
    CPU, EXTRA, assert_fields, both_explore, configs,
)


def test_storage_sweep_equals_jax():
    jres, tres, jb, tb, names = both_explore(
        tuple(EXTRA.items()), jdst.EXTRA_PROFILES, None)
    assert np.array_equal(tres.viol, jres.viol)
    assert np.array_equal(tres.first_tick, jres.first_tick)
    assert np.array_equal(tres.bits_by_tick, jres.bits_by_tick)
    assert_fields("final", jres.final_state, tres.final_state)
    # the verbs fired and the storage plane moved in every cluster
    assert int(tres.final_state.sync_mark.amax(1).min()) > 0
    assert int(tres.final_state.tel_commit_hist.sum(1).min()) > 0
    for s in tres.violating[:1]:
        jcfg, tcfg = configs(EXTRA)
        s = int(s)
        want = jdst.replay(jcfg, jb.slice(s), 2)
        assert want == (int(jres.viol[s]), int(jres.first_tick[s]))
        assert tdst.replay(tcfg, tb.slice(s), 2, device=CPU) == want


def test_dst_sweep_cli_on_the_cpu(tmp_path, capsys):
    rc = dst_sweep.main(["--device", "cpu", "--schedules", "12", "--ticks",
                         "60", "--no-mutation-demo"])
    assert rc == 0
    out_path = str(tmp_path / "repro.json")
    rc = dst_sweep.main(["--device", "cpu", "--schedules", "12", "--ticks",
                         "100", "--mutate", "commit_no_quorum", "--out",
                         out_path])
    assert rc == 0
    assert dst_sweep.main(["--device", "cpu", "--replay", out_path]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "reproduces exactly" in out
    art = tdst.load_artifact(out_path)
    assert art["flight"]["window"] and art["mutation"] == "commit_no_quorum"
