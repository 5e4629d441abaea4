"""A port Manager's whole metrics page: the typed registry, the latency
timers as summaries and the store-object gauges.

Over the wire: a port Manager on the gRPC wire (real sockets, the system
clock, ``device="cpu"``) serves ``swarmkit.Metrics/Scrape``; the page
``rpc.scrape_metrics`` reads parses as 0.0.4 text and holds the three
surfaces, and ``metrics_snapshot()`` holds their keys.  Against the JAX
package: a JAX Manager and a port Manager, each on its package's
in-process wire with a FakeClock, run one script (elect, create a
service, scale it); their pages hold the same families, types and series,
and equal values where the script decides them (the object gauges and
raft's term, commit index and leadership).  Last, ``parse_text`` reads the
JAX package's page of one registry as the port renders it and refuses
pages that break the format.
"""

from __future__ import annotations

import asyncio
import math

import grpc
import pytest

from swarmkit_tpu_torch.metrics.exposition import parse_text
from swarmkit_tpu_torch.tools import control_plane as cp
from tests.test_torch_manager import (
    MODES, ManagerHarness, package, service_spec,
)
from tests.torch_port_copies import free_port

# families whose every series the script decides, in both packages
DETERMINISTIC = ("swarm_raft_term", "swarm_raft_commit_index",
                 "swarm_raft_is_leader")


def surfaces(m, fams: dict, exact: bool = True) -> dict:
    """The page's three surfaces, each checked against the manager it
    came from: every timer as a summary (of its count), every collector
    gauge as a plain gauge (of its value); `exact` where the manager has
    not moved since the page was rendered."""
    timers = m.metrics_registry._timers
    gauges = m.metrics.snapshot()
    summaries = {f for f, v in fams.items() if v["type"] == "summary"}
    assert summaries == set(timers), (summaries, set(timers))
    for name, t in timers.items():
        assert {lab for _, lab in fams[name]["samples"]} == {
            (("quantile", q),) for q in ("0.5", "0.9", "0.99")} | {()}
        if exact:
            assert fams[name]["samples"][(f"{name}_count", ())] == t.count
    for name, v in gauges.items():
        assert fams[name]["type"] == "gauge"
        assert set(fams[name]["samples"]) == {(name, ())}
        if exact:
            assert fams[name]["samples"] == {(name, ()): v}, name
    registry = set(fams) - summaries - set(gauges)
    assert registry == set(m.obs.snapshot()), registry ^ set(
        m.obs.snapshot())
    return {"registry": registry, "timers": summaries, "gauges": set(gauges)}


def test_port_manager_scraped_over_grpc(tmp_path):
    from swarmkit_tpu_torch import rpc
    from swarmkit_tpu_torch.manager.manager import Manager
    from swarmkit_tpu_torch.raft.grpc_transport import GrpcNetwork

    P = package("swarmkit_tpu_torch")

    async def go():
        net = GrpcNetwork(seed=1)
        m = Manager("m1", f"127.0.0.1:{free_port()}", net, str(tmp_path),
                    tick_interval=0.05, election_tick=4, device="cpu")
        await m.start()
        try:
            for _ in range(400):
                if m.is_leader() and m._is_leader:
                    break
                await asyncio.sleep(0.05)
            assert m.is_leader()
            await m.control_api.create_service(service_spec(P))
            for _ in range(400):
                if len(m.store.find("task")) == 2:
                    break
                await asyncio.sleep(0.05)
            ch = grpc.aio.insecure_channel(m.addr)
            try:
                text = await rpc.scrape_metrics(ch, timeout=10.0)
            finally:
                await ch.close()
            snap = m.metrics_snapshot()
            assert snap["objects"] == m.metrics.snapshot()
            return m, text, snap
        finally:
            await m.stop()
            await net.close()
            await asyncio.sleep(0.2)

    m, text, snap = asyncio.run(go())
    fams = parse_text(text)
    # the manager ran on (its own clock) between the scrape and its stop
    got = surfaces(m, fams, exact=False)
    assert {"swarm_raft_term", "swarm_raft_is_leader",
            "swarm_store_commits_total"} <= got["registry"]
    assert "swarm_store_write_tx_latency_seconds" in got["timers"]
    assert fams["swarm_service_total"]["samples"] == {
        ("swarm_service_total", ()): 1}
    assert fams["swarm_task_pending"]["samples"][
        ("swarm_task_pending", ())] + fams["swarm_task_new"]["samples"][
        ("swarm_task_new", ())] == 2
    assert sorted(snap) == ["metrics", "objects", "recent_events", "spans",
                            "timers"]
    assert sorted(snap["timers"]) == sorted(got["timers"])


async def _script(P, h) -> list:
    """Elect one manager, create a service, scale it up; after each step
    the page, read back and held to the manager."""
    pages = []

    def page(step):
        fams = parse_text(m.metrics_text())
        pages.append((step, fams, surfaces(m, fams)))

    m = h.new_manager(1)
    await m.start()
    assert await h.wait_leader() is m
    page("elected")
    svc = await m.control_api.create_service(service_spec(P, replicas=3))
    await h.settle(4)
    page("created")
    cur = m.store.get("service", svc.id)
    spec = cur.spec.copy()
    spec.replicated.replicas = 5
    await m.control_api.update_service(svc.id, spec,
                                       version=cur.meta.version.index)
    await h.settle(4)
    assert len(m.store.find("task")) == 5
    page("scaled")
    snap = m.metrics_snapshot()
    assert sorted(snap) == ["metrics", "objects", "recent_events", "spans",
                            "timers"]
    assert snap["objects"] == m.metrics.snapshot()
    return pages


def _run(root: str, kw: dict) -> list:
    P = package(root)

    async def go():
        h = ManagerHarness(P, kw)
        try:
            with cp.counted_ids(P):
                return await _script(P, h)
        finally:
            await h.close()
    return asyncio.run(go())


def _shape(fams: dict) -> dict:
    return {name: (f["type"], f["help"], sorted(f["samples"]))
            for name, f in fams.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_page_equals_jax_family_for_family(mode):
    jkw, tkw = MODES[mode]
    want = _run("swarmkit_tpu", jkw)
    got = _run("swarmkit_tpu_torch", tkw)
    assert [s for s, *_ in got] == [s for s, *_ in want]
    for (step, jf, js), (_, tf, ts) in zip(want, got):
        assert ts == js, step
        assert _shape(tf) == _shape(jf), step
        for name in DETERMINISTIC + tuple(sorted(js["gauges"])):
            assert tf[name]["samples"] == jf[name]["samples"], (step, name)
    # the script moved what it decides
    last = got[-1][1]
    assert last["swarm_raft_is_leader"]["samples"] == {
        ("swarm_raft_is_leader", (("node", "m1"),)): 1.0}
    assert last["swarm_service_total"]["samples"] == {
        ("swarm_service_total", ()): 1}


def test_parse_text_reads_the_jax_page_and_refuses_broken_pages():
    from swarmkit_tpu.metrics import exposition as jexp
    from swarmkit_tpu.metrics.registry import MetricsRegistry
    from swarmkit_tpu.utils.metrics import Registry

    reg, timers = MetricsRegistry(), Registry()
    reg.counter("swarm_demo_total", "Demo.", ("kind",)).labels(
        kind='a"b').inc(3)
    reg.histogram("swarm_demo_seconds", "Demo.", (), (0.1, 1.0)).observe(
        0.5)
    for v in (0.1, 0.2, 0.3):
        timers.timer("swarm_demo_latency_seconds").observe(v)
    text = jexp.render_all(registry=reg, legacy_registry=timers,
                           collector_gauges={"swarm_demo_objects": 7})
    fams = parse_text(text)
    assert fams["swarm_demo_total"]["samples"] == {
        ("swarm_demo_total", (("kind", 'a\\"b'),)): 3.0}
    hist = fams["swarm_demo_seconds"]["samples"]
    assert hist[("swarm_demo_seconds_bucket", (("le", "+Inf"),))] == 1
    assert hist[("swarm_demo_seconds_count", ())] == 1
    summ = fams["swarm_demo_latency_seconds"]
    assert summ["type"] == "summary"
    assert summ["samples"][("swarm_demo_latency_seconds_count", ())] == 3
    assert math.isclose(
        summ["samples"][("swarm_demo_latency_seconds_sum", ())], 0.6)
    assert fams["swarm_demo_objects"]["samples"] == {
        ("swarm_demo_objects", ()): 7}
    for bad in ("x 1\n",
                "# TYPE a counter\nb 1\n",
                '# TYPE a counter\na{x="1" 2\n',
                "# TYPE a counter\na 1\na 2\n",
                "# TYPE a gauge\n# TYPE a gauge\n",
                "# TYPE a histogram\na_sum q\n",
                "# TYPE a summary\na_bucket 1\n",
                "# HELP a only help\n"):
        with pytest.raises(ValueError):
            parse_text(bad)
