"""On the card: a cell's flow at a small size, traced, with the readers
reading the unit profiled after the window.  Skips without a card."""

import pytest

from conftest import rehearse


@pytest.mark.cuda
def test_traced_rehearsal_on_the_card(cuda_card):
    from benchmark import cells
    from benchmark import trace as tracing

    res = rehearse("n4096-reads", seconds=1.0, n=256, device="cuda",
                   trace=True)
    assert res["correct"], res["checks"]
    sl = res["profiler"].finish()
    assert sl["kernels"] and sl["wall_s"] > 0
    assert 0 < tracing.busy_s(sl) <= sl["wall_s"] * 1.05
    ctx = tracing.context(res["window"], res["counts"], res["profiler"],
                          "card", None)
    for name in ("launches_per_tick", "tick_device_ms", "device_idle_pct",
                 "read_phase_ms", "host_syncs_per_tick"):
        assert cells.metric_reader(name)(ctx) is not None, name
