"""The port's coalescing proposal pipeline (store/pipeline.py and the
store's coalescing mode) against the JAX package's, through a 3-node raft
quorum of each package.

The cases of tests/test_proposal_pipeline.py: concurrent writers packed
into few raft proposals, FIFO read-modify-write composition, a stale
read's sequence conflict, a ``store.batch()`` block of 500 creates,
``max_entries`` chunking, the failure fan-out when the leader is cut off
(every queued writer fails, the next epoch commits on the new leader) and
drain / ``stop_coalescing``.  Each is written once over a package and run
through both on a FakeClock; after every step the trace holds every
node's raft state, log (with a digest of each entry's data), store, the
actions packed into each committed proposal and the leader's
``swarm_cpl_*`` counters, and the port's trace equals the JAX package's.
"""

from __future__ import annotations

import asyncio
import importlib

import pytest

from tests.test_torch_raft_node import (
    RaftHarness, assert_same_trace, node_view, package,
)


def _cfg(P, i, data=b"x"):
    api = P.api
    return api.Config(id=f"cfg{i}", spec=api.ConfigSpec(
        annotations=api.Annotations(name=f"cfg{i}"), data=data))


CPL = ("swarm_cpl_proposals_total", "swarm_cpl_txns_total",
       "swarm_cpl_batch_entries", "swarm_cpl_queue_depth")


def packed(P, node) -> list[int]:
    """The store actions of each committed normal entry of `node`."""
    r = node._raw.raft
    out = []
    for e in r.log.slice(r.log.first_index(), r.log.committed + 1):
        if int(e.type) == 0 and e.data:
            out.append(len(P.raft_msgs.InternalRaftRequest.decode(
                e.data).actions))
    return out


async def quorum(P, h, config):
    """Three nodes, each with its own metrics registry; the leader's
    store coalescing with `config`."""
    reg = importlib.import_module(f"{P.root}.metrics.registry")
    kw = lambda: dict(obs_registry=reg.MetricsRegistry())  # noqa: E731
    n1 = await h.add_node(**kw())
    await h.wait_for_leader()
    await h.add_node(join_from=n1, **kw())
    await h.add_node(join_from=n1, **kw())
    lead = await h.wait_for_cluster()
    lead.store.set_coalescing(config)
    return lead


def recorder(P, h):
    catalog = importlib.import_module(f"{P.root}.metrics.catalog")

    def views():
        out = {}
        for nid, n in h.nodes.items():
            v = node_view(n)
            v["packed"] = packed(P, n) if n._raw is not None else None
            v["cpl"] = {m: catalog.get(n.obs, m).snapshot() for m in CPL}
            out[nid] = v
        return out
    return views


def pipeline_config(P, **kw):
    return importlib.import_module(
        f"{P.root}.store.pipeline").CoalesceConfig(**kw)


async def case_pack(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P, window=0.0))
    before = len(packed(P, lead))
    await asyncio.gather(*(lead.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i))) for i in range(64)))
    await h.wait_for_cluster()
    assert len(lead.store.find("config")) == 64
    sizes = packed(P, lead)[before:]
    assert sum(sizes) == 64 and len(sizes) < 64
    versions = [lead.store.get("config", f"cfg{i}").meta.version.index
                for i in range(64)]
    assert versions == sorted(versions)
    rec("packed")


async def case_fifo(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P))
    await lead.store.update(lambda tx: tx.create(_cfg(P, 0, data=b"a")))

    def appender(tx):
        c = tx.get("config", "cfg0")
        c.spec.data = c.spec.data + b"y"
        tx.update(c)
    await asyncio.gather(*(lead.store.update(appender) for _ in range(8)))
    assert lead.store.get("config", "cfg0").spec.data == b"a" + b"y" * 8
    await h.wait_for_cluster()
    rec("composed")

    stale = lead.store.get("config", "cfg0")

    async def bump():
        def m(tx):
            c = tx.get("config", "cfg0")
            c.spec.data = b"b"
            tx.update(c)
        await lead.store.update(m)

    async def stale_write():
        def m(tx):
            stale.spec.data = b"lost"
            tx.update(stale)
        await lead.store.update(m)
    res = await asyncio.gather(bump(), stale_write(), return_exceptions=True)
    store_errors = importlib.import_module(f"{P.root}.store")
    assert [type(r).__name__ for r in res] == ["NoneType",
                                               "ErrSequenceConflict"]
    assert isinstance(res[1], store_errors.ErrSequenceConflict)
    assert lead.store.get("config", "cfg0").spec.data == b"b"
    await h.wait_for_cluster()
    rec("stale write refused")


async def case_batch_block(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P))
    batch = lead.store.batch()
    for i in range(500):
        await batch.update(lambda tx, i=i: tx.create(_cfg(P, i)))
    assert await batch.commit() == 500
    await h.wait_for_cluster()
    assert all(len(n.store.find("config")) == 500
               for n in h.nodes.values())
    assert 1 < len(packed(P, lead)) < 500
    rec("batched")


async def case_max_entries(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P, max_entries=8))
    before = len(packed(P, lead))
    await asyncio.gather(*(lead.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i))) for i in range(32)))
    await h.wait_for_cluster()
    sizes = packed(P, lead)[before:]
    assert len(lead.store.find("config")) == 32
    assert sum(sizes) == 32 and max(sizes) <= 8
    rec("chunked")


async def case_failure_fan_out(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P, window=0.0))
    await asyncio.gather(*(lead.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i))) for i in range(4)))
    await h.wait_for_cluster()
    rec("before the cut")
    others = [n for n in h.nodes.values() if n is not lead]
    h.network.partition({lead.addr}, {n.addr for n in others})
    writers = [asyncio.ensure_future(lead.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i)))) for i in range(4, 20)]
    for _ in range(60):
        if all(w.done() for w in writers):
            break
        await h.tick()
    assert all(w.done() for w in writers)
    assert all(w.exception() is not None for w in writers)
    errs = {type(w.exception()).__name__ for w in writers}
    assert len(errs) == 1
    assert len(lead.store.find("config")) == 4
    rec(f"fanned out: {sorted(errs)}")
    h.network.heal()
    new = await h.wait_for_cluster()
    new.store.set_coalescing(pipeline_config(P))
    await asyncio.gather(*(new.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i))) for i in range(4, 20)))
    await h.wait_for_cluster()
    assert all(len(n.store.find("config")) == 20 for n in h.nodes.values())
    rec("next epoch")


async def case_drain(P, h, rec):
    lead = await quorum(P, h, pipeline_config(P))
    await asyncio.gather(*(lead.store.update(
        lambda tx, i=i: tx.create(_cfg(P, i))) for i in range(8)))
    await lead.store.stop_coalescing()
    assert not lead.store.coalescing()
    await lead.store.update(lambda tx: tx.create(_cfg(P, 99)))
    await h.wait_for_cluster()
    assert len(lead.store.find("config")) == 9
    assert packed(P, lead)[-1] == 1
    rec("drained")


CASES = {f.__name__[5:]: f for f in (
    case_pack, case_fifo, case_batch_block, case_max_entries,
    case_failure_fan_out, case_drain)}


def run_case(root: str, case) -> list:
    P = package(root)

    async def go():
        h = RaftHarness(P)
        rec = []
        views = recorder(P, h)
        try:
            await case(P, h, lambda step: rec.append((step, views())))
        finally:
            await h.close()
        return rec
    return asyncio.run(go())


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_equals_jax(name):
    want = run_case("swarmkit_tpu", CASES[name])
    got = run_case("swarmkit_tpu_torch", CASES[name])
    assert_same_trace(want, got)


def test_pipeline_metric_names_equal_jax():
    from swarmkit_tpu.store import pipeline as jp
    from swarmkit_tpu_torch.store import pipeline as tp

    assert tp.METRIC_NAMES == jp.METRIC_NAMES
    assert tp.SAMPLE_LABELS == jp.SAMPLE_LABELS
