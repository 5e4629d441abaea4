"""The port's device-mesh raft wire (swarmkit_tpu_torch/transport/ and
raft/wire.py, raft/transport.py) under the JAX package's raft Node, on the
CPU.

The six raft scenarios of tests/test_device_transport.py run with the
port's DeviceMeshNet(device="cpu") and DeviceMeshTransport bound to the
JAX package's RaftHarness and Node: every message the JAX nodes exchange
is encoded by the port's codec, packed into the port's int32 mailbox,
exchanged by the port's `exchange` and decoded into the port's Message
(MsgType and EntryType are IntEnums in both packages, so they compare
equal).  The seventh JAX scenario, the check that the exchange lowers to
a cross-device all-to-all in XLA's HLO, has no HLO to look at here: on
one entry the port's exchange is the sender<->receiver transpose, which
this file tests (every slot lands at its receiver's view, masked lengths
zeroed); the all-to-all over a row mesh of several entries, built from
D^2 blocks, is tests/test_torch_parallel.py's.

The codec is held to msgpack byte for byte both ways on seeded messages
(entries, snapshots, rejects, context), and imports and round-trips with
msgpack blocked.  All values are integers and bytes, so every comparison
is exact.
"""

from __future__ import annotations

import asyncio
import subprocess
import sys

import numpy as np
import pytest
import torch

from swarmkit_tpu.api import Annotations, Node as ApiNode, NodeSpec
from swarmkit_tpu.raft import messages as jmsg
from swarmkit_tpu.raft import wire as jwire
from swarmkit_tpu.raft.node import ErrLostLeadership
from swarmkit_tpu_torch.raft import messages as tmsg
from swarmkit_tpu_torch.raft import wire as twire
from swarmkit_tpu_torch.transport import DeviceMeshNet, DeviceMeshTransport
from swarmkit_tpu_torch.transport import device_mesh
from tests.conftest import async_test
from tests.node_harness import RaftHarness


class PortWireHarness(RaftHarness):
    """The JAX RaftHarness with the port's device wire and transport."""

    def __init__(self, seed: int = 7) -> None:
        super().__init__(seed=seed)
        self.network = DeviceMeshNet(seed=seed, rows=8, device="cpu")

    def _opts(self, node_id, **kw):
        opts = super()._opts(node_id, **kw)
        opts.transport_factory = DeviceMeshTransport
        return opts

    async def close(self) -> None:
        await super().close()
        self.network.close()


def _obj(i):
    return ApiNode(id=f"id{i}",
                   spec=NodeSpec(annotations=Annotations(name=f"obj{i}")))


async def propose(node, i):
    await node.store.update(lambda tx: tx.create(_obj(i)))


def has_obj(node, i):
    return node.store.get("node", f"id{i}") is not None


@async_test
async def test_three_node_bootstrap_and_replication():
    h = PortWireHarness()
    try:
        n1 = await h.add_node()
        await h.wait_for_leader()
        n2 = await h.add_node(join_from=n1)
        n3 = await h.add_node(join_from=n1)
        await h.wait_for_cluster()
        assert len(n1.cluster.members) == 3
        await propose(n1, 1)
        await h.wait_for(lambda: has_obj(n2, 1) and has_obj(n3, 1))
        # messages really moved through the port's exchange
        assert h.network.device_flushes > 0
        assert h.network.device_messages > 0
    finally:
        await h.close()


@async_test
async def test_leader_down_reelection_and_continued_replication():
    h = PortWireHarness()
    try:
        n1 = await h.add_node()
        await h.wait_for_leader()
        n2 = await h.add_node(join_from=n1)
        n3 = await h.add_node(join_from=n1)
        await h.wait_for_cluster()
        await h.shutdown_node(n1)
        lead = await h.wait_for_leader()
        assert lead in (n2, n3)
        await propose(lead, 5)
        others = [n for n in (n2, n3) if n is not lead]
        await h.wait_for(lambda: all(has_obj(n, 5) for n in others))
    finally:
        await h.close()


@async_test
async def test_five_node_replication_and_quorum():
    """5-node scenario: replication to all; quorum loss blocks commits;
    healing recovers (raft_test.go TestRaftQuorumFailure/Recovery)."""
    h = PortWireHarness()
    try:
        n1 = await h.add_node()
        await h.wait_for_leader()
        rest = [await h.add_node(join_from=n1) for _ in range(4)]
        await h.wait_for_cluster()
        nodes = [n1, *rest]
        await propose(n1, 1)
        await h.wait_for(lambda: all(has_obj(n, 1) for n in nodes))

        # cut the leader + one follower off from the other three
        lead = h.leader()
        others = [n for n in nodes if n is not lead]
        h.network.partition({lead.addr, others[0].addr},
                            {n.addr for n in others[1:]})
        task = asyncio.ensure_future(propose(lead, 2))
        for _ in range(40):
            if task.done():
                break
            await h.tick()
        assert task.done(), "proposal neither committed nor timed out"
        with pytest.raises((TimeoutError, ErrLostLeadership)):
            task.result()

        h.network.heal()
        lead = await h.wait_for_cluster()
        await propose(lead, 3)
        await h.wait_for(lambda: all(has_obj(n, 3) for n in nodes
                                     if n.running))
    finally:
        await h.close()


@async_test
async def test_snapshot_catch_up_through_device_mailbox():
    """Snapshot messages (the largest payloads) survive the mailbox
    word-packing round trip (raft_test.go TestRaftSnapshot)."""
    h = PortWireHarness()
    try:
        n1 = await h.add_node(snapshot_interval=10,
                              log_entries_for_slow_followers=2)
        await h.wait_for_leader()
        for i in range(15):
            await propose(n1, i)
        assert n1.status()["snapshot_index"] > 0
        n2 = await h.add_node(join_from=n1)
        await h.wait_for(lambda: all(has_obj(n2, i) for i in range(15)))
        assert len(n2.cluster.members) == 2
    finally:
        await h.close()


@async_test
async def test_message_drop_still_converges_on_device_wire():
    """20% per-edge loss applied on the device as mailbox masks; raft
    retries mask it."""
    h = PortWireHarness()
    try:
        n1 = await h.add_node()
        await h.wait_for_leader()
        n2 = await h.add_node(join_from=n1)
        n3 = await h.add_node(join_from=n1)
        await h.wait_for_cluster()
        for a in (n1, n2, n3):
            for b in (n1, n2, n3):
                if a is not b:
                    h.network.set_drop(a.addr, b.addr, 0.2)
        lead = h.leader()
        await propose(lead, 1)
        await h.wait_for(lambda: all(has_obj(n, 1) for n in (n1, n2, n3)))
        assert h.network.dropped > 0
    finally:
        await h.close()


@async_test
async def test_member_removal_on_device_wire():
    h = PortWireHarness()
    try:
        n1 = await h.add_node()
        await h.wait_for_leader()
        n2 = await h.add_node(join_from=n1)
        n3 = await h.add_node(join_from=n1)
        await h.wait_for_cluster()
        removed_id = n3.raft_id
        await n1.remove_member(removed_id)
        await h.wait_for(lambda: len(n1.cluster.members) == 2)
        assert n1.cluster.is_id_removed(removed_id)
        await propose(n1, 4)
        await h.wait_for(lambda: has_obj(n2, 4))
    finally:
        await h.close()


# ---------------------------------------------------------------------------
# the exchange: the sender<->receiver transpose, masked lengths zeroed


def test_exchange_is_the_transpose_with_masked_lengths_zeroed():
    rng = np.random.default_rng(5)
    r, k, w = 8, 4, 64
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (r, r, k, w),
                                          dtype=np.int64).astype(np.int32))
    lens = torch.from_numpy(rng.integers(1, 4 * w, (r, r, k)).astype(
        np.int32))
    keep = torch.from_numpy(rng.random((r, r, k)) < 0.6)
    got_w, got_l = device_mesh.exchange(words, lens, keep)
    for s in range(r):
        for d in range(r):
            assert torch.equal(got_w[d, s], words[s, d])
            want = torch.where(keep[s, d], lens[s, d], 0)
            assert torch.equal(got_l[d, s], want)
    assert int((got_l == 0).sum()) == int((~keep).sum())


def _wire_msgs(rng, mod, n):
    """n seeded messages of `mod` (a messages module): every type, with
    entries (both entry types, empty and non-empty data), snapshots
    (voters, data), rejects, hints and context; ids and indexes across
    msgpack's int widths."""
    def num():
        return int(rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                               2**32 - 1, 2**32, 2**40 + 3,
                               int(rng.integers(0, 2**31))]))

    def blob():
        size = int(rng.choice([0, 1, 31, 32, 255, 256, 70000]))
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()

    out = []
    for i in range(n):
        ents = tuple(mod.Entry(index=num(), term=num(),
                               type=mod.EntryType(int(rng.integers(0, 2))),
                               data=blob())
                     for _ in range(int(rng.choice([0, 1, 3, 17]))))
        snap = None
        if rng.random() < 0.3:
            snap = mod.Snapshot(
                meta=mod.SnapshotMeta(
                    index=num(), term=num(),
                    voters=tuple(num() for _ in range(int(rng.integers(
                        0, 9))))),
                data=blob())
        out.append(mod.Message(
            type=mod.MsgType(i % len(mod.MsgType)), to=num(), frm=num(),
            term=num(), log_term=num(), index=num(), entries=ents,
            commit=num(), reject=bool(rng.random() < 0.5),
            reject_hint=num(), snapshot=snap,
            context=(mod.CAMPAIGN_TRANSFER if rng.random() < 0.2
                     else blob())))
    return out


def _fields(m):
    snap = None if m.snapshot is None else (
        m.snapshot.meta.index, m.snapshot.meta.term,
        tuple(m.snapshot.meta.voters), m.snapshot.data)
    return (int(m.type), m.to, m.frm, m.term, m.log_term, m.index,
            tuple((e.index, e.term, int(e.type), e.data)
                  for e in m.entries),
            m.commit, m.reject, m.reject_hint, snap, m.context)


def test_wire_bytes_equal_jax_both_ways():
    """The port's encode_message gives JAX's bytes for 240 seeded messages
    (built as JAX's and as the port's Message), and each package decodes
    the other's bytes to equal fields; the same for conf changes."""
    jm = _wire_msgs(np.random.default_rng(11), jmsg, 240)
    tm = _wire_msgs(np.random.default_rng(11), tmsg, 240)
    assert sum(m.snapshot is not None for m in tm) > 40
    assert sum(bool(m.entries) for m in tm) > 100
    for j, t in zip(jm, tm):
        raw = jwire.encode_message(j)
        assert twire.encode_message(t) == raw
        assert twire.encode_message(j) == raw     # duck-typed both ways
        back = twire.decode_message(raw)
        assert isinstance(back, tmsg.Message)
        assert _fields(back) == _fields(j)
        assert _fields(jwire.decode_message(twire.encode_message(t))) \
            == _fields(t)
    for cid, ty, nid, ctx in ((1, 0, 2, b""), (2**33, 1, 7, b"\x00" * 300),
                              (0, 2, 2**63, b"addr:4242")):
        jc = jmsg.ConfChange(id=cid, type=jmsg.ConfChangeType(ty),
                             node_id=nid, context=ctx)
        tc = tmsg.ConfChange(id=cid, type=tmsg.ConfChangeType(ty),
                             node_id=nid, context=ctx)
        raw = jwire.encode_conf_change(jc)
        assert twire.encode_conf_change(tc) == raw
        assert twire.decode_conf_change(raw) == tc
        assert jwire.decode_conf_change(twire.encode_conf_change(tc)) == jc
    assert twire.WIRE_VERSION == jwire.WIRE_VERSION
    with pytest.raises(ValueError):
        twire.decode_conf_change(b"\x93\x01\x02\x03")
    with pytest.raises(ValueError):
        twire.decode_message(raw + b"\x00")


def test_wire_imports_and_round_trips_without_msgpack():
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['jax'] = None\n"
        "from swarmkit_tpu_torch.raft import messages as m, wire\n"
        "msg = m.Message(type=m.MsgType.APP, to=2, frm=1, term=3, "
        "index=9, entries=(m.Entry(index=10, term=3, data=b'x' * 300),), "
        "snapshot=m.Snapshot(meta=m.SnapshotMeta(index=4, term=2, "
        "voters=(1, 2, 3)), data=b'snap'), context=b'ctx')\n"
        "assert wire.decode_message(wire.encode_message(msg)) == msg\n"
        "assert 'msgpack' not in {k for k, v in sys.modules.items() "
        "if v is not None}\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# a scripted flush: every width bucket, blocked and oversize paths


class _Clock:
    def now(self) -> float:
        return 0.0

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(0)


class _Node:
    """A server and RaftHandlers in one: records what reaches it."""

    def __init__(self) -> None:
        self.got, self.unreachable, self.snaps = [], [], []

    async def process_raft_message(self, m) -> None:
        self.got.append(m)

    def report_unreachable(self, raft_id, failures=1) -> None:
        self.unreachable.append((raft_id, failures))

    def report_snapshot(self, raft_id, ok) -> None:
        self.snaps.append((raft_id, ok))

    def is_id_removed(self, raft_id) -> bool:
        return False


def _scripted(rows=4):
    """A port wire of `rows` nodes, each with its transport and peers."""
    net = DeviceMeshNet(seed=3, rows=rows, device="cpu")
    nodes = [_Node() for _ in range(rows)]
    trs = []
    for i, node in enumerate(nodes):
        net.register(f"n{i}", node)
        trs.append(DeviceMeshTransport(net, node, f"n{i}", _Clock()))
    for tr in trs:
        for j in range(rows):
            tr.add_peer(j + 1, f"n{j}")
    return net, nodes, trs


@async_test
async def test_scripted_flush_through_every_width_bucket():
    """Four flushes, each of one message whose encoding needs one of the
    four width buckets, deliver its bytes intact through the bucket chosen
    by need; the first flush also carries a partitioned edge's message,
    whose slot comes back with length 0 and reports unreachable after the
    exchange.  A message wider than the largest bucket is reported
    unreachable, and narrow and wide messages staged together cross in
    separate exchanges."""
    net, nodes, trs = _scripted()
    seen = []
    orig = net.run_exchange

    def spy(words, lens, keep):
        w, ln = orig(words, lens, keep)
        staged = np.swapaxes(lens, 0, 1) > 0
        seen.append((words.shape, int((staged & (ln == 0)).sum())))
        return w, ln

    net.run_exchange = spy

    def app(i, size):
        return tmsg.Message(type=tmsg.MsgType.APP, to=2, frm=1, term=1,
                            entries=(tmsg.Entry(index=i, term=1,
                                                data=b"e" * size),))

    async def flush():
        for _ in range(3):
            await asyncio.sleep(0)

    sent = [app(i, size) for i, size in enumerate((10, 1000, 20000, 200000))]
    net.partition({"n2"}, {"n3"})
    trs[2].send(tmsg.Message(type=tmsg.MsgType.HEARTBEAT, to=4, frm=3,
                             term=1))
    for m in sent:
        trs[0].send(m)
        await flush()
    assert [shape for shape, _ in seen] == [(4, 4, 4, w) for w in
                                            (64, 1024, 16384, 65536)]
    assert [masked for _, masked in seen] == [1, 0, 0, 0]
    assert [_fields(m) for m in nodes[1].got] == [_fields(m) for m in sent]
    assert nodes[2].unreachable == [(4, 1)] and nodes[3].got == []
    trs[0].send(app(9, 300000))                 # over 65536 words
    await flush()
    assert nodes[0].unreachable == [(2, 1)] and len(seen) == 4
    trs[0].send(sent[0])
    trs[0].send(sent[3])
    await flush()
    assert [shape for shape, _ in seen[4:]] == [(4, 4, 4, 64),
                                                (4, 4, 4, 65536)]
    net.close()
    assert net.device_flushes == 6 and net.device_messages == 7
    assert net.delivered == 6
    # the depth bucket follows the busiest edge
    words, lens, keep = net.pack([(0, 1, k, b"x" * 8) for k in range(5)])
    assert words.shape == (4, 4, 16, 64) and lens[0, 1, 4] == 8
    assert not keep.any()


def test_device_wire_metrics_are_the_jax_specs():
    import dataclasses

    from swarmkit_tpu.metrics import catalog as jcatalog
    from swarmkit_tpu_torch.metrics import catalog as tcatalog
    from swarmkit_tpu_torch.metrics import registry as tregistry

    names = ("swarm_transport_delivery_latency_seconds",
             "swarm_transport_redials_total",
             "swarm_transport_send_failures_total",
             "swarm_transport_mailbox_depth",
             "swarm_transport_device_flushes_total",
             "swarm_transport_device_messages_total",
             "swarm_transport_exchange_seconds")
    for name in names:
        assert dataclasses.astuple(tcatalog.CATALOG[name]) \
            == dataclasses.astuple(jcatalog.CATALOG[name]), name
    reg = tregistry.MetricsRegistry()
    net = DeviceMeshNet(device="cpu", obs=reg)
    assert tcatalog.get(reg, "swarm_transport_mailbox_depth").value == 0


def test_device_wire_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMeshNet()
    with pytest.raises(TypeError):
        DeviceMeshTransport(object(), _Node(), "n0", _Clock())


# ---------------------------------------------------------------------------
# chip_smoke's phase 22 driver, on the CPU


def test_chip_smoke_device_wire_phase_on_the_cpu():
    """The card phase's run with the exchange on the CPU: three of the
    port's raft/core.py nodes elect, commit 256 proposals on every node
    through 5% drops and a partition of the leader, re-elect, heal and end
    with equal logs; the scripted flushes cover every width bucket with
    equal bytes (here CPU against CPU)."""
    import chip_smoke

    out = chip_smoke.phase_device_wire(torch, card="cpu")
    assert out["entries"] >= 256 and out["flushes"] > 0
    assert out["first_leader"] != out["second_leader"]
    assert out["dropped"] > 0
    assert [f["shape"][3] for f in out["flush"]] \
        == list(device_mesh.W_BUCKETS)
    assert all(f["blocked"] > 0 for f in out["flush"])
