"""The port's raft node shell (raft/node.py with rawnode.py, storage.py,
membership.py and wait.py) against the JAX package's.

The cases of tests/test_raft_node.py (bootstrap, replication, a leader
down and re-elected, a follower restarted from its WAL, snapshot catch-up
of a new member, member removal and its blacklist, the quorum precheck,
NotLeaderError and ErrLostLeadership off the leader, leadership transfer,
a proposal that times out and one too large, an encrypted WAL, a forced
new cluster), each written once over a package and run through both on a
FakeClock and the seeded in-process Network.  After every step the trace
records each node's raft id, role, term, vote, commit, applied and
snapshot index, its membership, its log (index, term, type and a digest
of the data of every entry) and every object of its store; the port's
trace must equal the JAX package's step for step, and each run meets the
JAX test's own checks.

Then a state_dir written by one package's nodes bootstraps the other
package's nodes, both ways: the recovered raft ids, logs, hard states and
stores equal the writer's, and the cluster commits again.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import os
import tempfile
import types
from typing import Optional

import pytest

ROOTS = ("swarmkit_tpu", "swarmkit_tpu_torch")
TICK = 1.0


def package(root: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    node = m("raft.node")
    return types.SimpleNamespace(
        root=root, api=m("api"), node=node, Node=node.Node,
        NodeOpts=node.NodeOpts, Network=m("raft.transport").Network,
        FakeClock=m("utils.clock").FakeClock, storage=m("raft.storage"),
        messages=m("raft.messages"), raft_msgs=m("api.raft_msgs"),
        encryption=m("encryption"), wire=m("raft.wire"))


def store_view(store) -> dict:
    """Every object of `store` as its serde dict, by kind and id."""
    out = {}
    for kind in ("node", "service", "task", "network", "cluster", "secret",
                 "config", "resource", "extension"):
        objs = {o.id: o.to_dict() for o in store.find(kind)}
        if objs:
            out[kind] = objs
    return out


def store_view_of(view: dict, skip) -> dict:
    """A node view's store with the fields named in `skip` ((kind,
    "field.subfield")) cleared."""
    out = {}
    for kind, objs in view["store"].items():
        out[kind] = {}
        for oid, d in objs.items():
            d = dict(d)
            for k, path in skip:
                if k == kind:
                    head, last = path.split(".")
                    d[head] = {**d[head], last: None}
            out[kind][oid] = d
    return out


def node_view(n, data: bool = True) -> dict:
    """What one node holds: its raft state, membership, log (with a
    digest of each entry's data unless `data` is False) and store."""
    view = dict(node=n.node_id, raft_id=n.raft_id, running=n.running,
                applied=n._applied, snapshot=n._snapshot_index,
                members=sorted((m.raft_id, m.node_id, m.addr)
                               for m in n.cluster.members.values()),
                removed=sorted(n.cluster.removed),
                store=store_view(n.store))
    if n._raw is not None:
        r = n._raw.raft
        view.update(
            state=str(r.state), term=r.term, vote=r.vote, lead=r.lead,
            commit=r.log.committed, first=r.log.first_index(),
            last=r.log.last_index(),
            log=[(e.index, e.term, int(e.type))
                 + ((hashlib.sha256(e.data).hexdigest(),) if data else ())
                 for e in r.log.entries_from(r.log.first_index())])
    return view


class Trace(list):
    """(step, view of every node) after each step of a case."""

    def __init__(self, views) -> None:
        super().__init__()
        self._views = views

    def __call__(self, step: str) -> None:
        self.append((step, self._views()))


def assert_same_trace(want: list, got: list) -> None:
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, w), (_, g) in zip(want, got):
        if w == g:
            continue
        for node in sorted(set(w) | set(g)):
            a, b = w.get(node), g.get(node)
            if a == b:
                continue
            if a is None or b is None:
                raise AssertionError(f"{step}: {node} in one run only")
            for k in sorted(set(a) | set(b)):
                assert a.get(k) == b.get(k), \
                    f"step {step!r}, {node}, field {k!r}: " \
                    f"JAX {a.get(k)!r} != port {b.get(k)!r}"


class RaftHarness:
    """tests/node_harness.py over a package: real nodes, the in-process
    wire, a FakeClock pumped explicitly."""

    def __init__(self, P, seed: int = 7, state_root: Optional[str] = None
                 ) -> None:
        self.P = P
        self.clock = P.FakeClock()
        self.network = P.Network(seed=seed)
        self.nodes: dict = {}
        self._tmp = None
        if state_root is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="torch-raft-")
            state_root = self._tmp.name
        self.state_root = state_root
        self._n = 0
        self.seed = seed

    def _opts(self, node_id: str, join_addr: str = "",
              force_new_cluster: bool = False, **kw):
        return self.P.NodeOpts(
            node_id=node_id, addr=f"{node_id}.test:4242",
            network=self.network,
            state_dir=os.path.join(self.state_root, node_id),
            clock=self.clock, join_addr=join_addr,
            force_new_cluster=force_new_cluster, tick_interval=TICK,
            election_tick=4, heartbeat_tick=1, seed=self.seed + self._n,
            **kw)

    async def add_node(self, join_from=None, **kw):
        self._n += 1
        node_id = f"node-{self._n}"
        join_addr = join_from.addr if join_from is not None else ""
        node = self.P.Node(self._opts(node_id, join_addr=join_addr, **kw))
        self.nodes[node_id] = node
        await node.start()
        await self.pump()
        return node

    async def restart_node(self, node, force_new_cluster: bool = False,
                           seed: Optional[int] = None, **kw):
        opts = self._opts(node.node_id, force_new_cluster=force_new_cluster,
                          **kw)
        opts.seed = node.opts.seed if seed is None else seed
        new = self.P.Node(opts)
        self.nodes[node.node_id] = new
        await new.start()
        await self.pump()
        return new

    async def shutdown_node(self, node) -> None:
        await node.stop()
        self.network.unregister(node.addr)

    async def pump(self, n: int = 1) -> None:
        for _ in range(max(1, n) * 8):
            await asyncio.sleep(0)

    async def tick(self, ticks: int = 1) -> None:
        for _ in range(ticks):
            await self.clock.advance(TICK)
            await self.pump()

    def leader(self):
        leaders = [n for n in self.nodes.values()
                   if n.running and n.is_leader()]
        return leaders[0] if leaders else None

    async def wait_for_leader(self, max_ticks: int = 100):
        for _ in range(max_ticks):
            lead = self.leader()
            if lead is not None:
                return lead
            await self.tick()
        raise TimeoutError("no leader elected")

    async def wait_for_cluster(self, max_ticks: int = 200):
        for _ in range(max_ticks):
            lead = self.leader()
            if lead is not None:
                members = [n for n in self.nodes.values() if n.running]
                lt = lead._raw.raft.term
                lc = lead._raw.raft.log.committed
                if all(n._raw is not None and n._raw.raft.term == lt
                       and n._raw.raft.log.applied >= lc for n in members):
                    return lead
            await self.tick()
        raise TimeoutError("cluster did not converge")

    async def wait_for(self, pred, max_ticks: int = 200) -> None:
        for _ in range(max_ticks):
            if pred():
                return
            await self.tick()
        raise TimeoutError("condition not met")

    def views(self, **kw) -> dict:
        return {nid: node_view(n, **kw) for nid, n in self.nodes.items()}

    async def close(self) -> None:
        for n in list(self.nodes.values()):
            if n.running:
                await n.stop()
        if self._tmp is not None:
            self._tmp.cleanup()


def obj(P, i):
    api = P.api
    return api.Node(id=f"id{i}", spec=api.NodeSpec(
        annotations=api.Annotations(name=f"obj{i}")))


async def propose(P, node, i) -> None:
    await node.store.update(lambda tx: tx.create(obj(P, i)))


def has_obj(node, i) -> bool:
    return node.store.get("node", f"id{i}") is not None


async def three(h):
    n1 = await h.add_node()
    await h.wait_for_leader()
    n2 = await h.add_node(join_from=n1)
    n3 = await h.add_node(join_from=n1)
    await h.wait_for_cluster()
    return n1, n2, n3


# ---- the cases: each drives a harness, records its steps and asserts the
# JAX test's own checks ---------------------------------------------------

async def case_bootstrap_single(P, h, rec):
    n1 = await h.add_node()
    assert await h.wait_for_leader() is n1
    rec("elected")
    await propose(P, n1, 1)
    assert has_obj(n1, 1) and n1.get_version() >= 2
    rec("proposed")


async def case_replication(P, h, rec):
    n1, n2, n3 = await three(h)
    assert len(n1.cluster.members) == len(n2.cluster.members) == 3
    rec("three members")
    await propose(P, n1, 1)
    await h.wait_for(lambda: has_obj(n2, 1) and has_obj(n3, 1))
    rec("replicated")


async def case_leader_down(P, h, rec):
    n1, n2, n3 = await three(h)
    await h.shutdown_node(n1)
    lead = await h.wait_for_leader()
    assert lead in (n2, n3)
    rec("re-elected")
    await propose(P, lead, 5)
    others = [n for n in (n2, n3) if n is not lead]
    await h.wait_for(lambda: all(has_obj(n, 5) for n in others))
    rec("post-failover write")


async def case_restart_from_wal(P, h, rec):
    n1, n2, n3 = await three(h)
    await propose(P, n1, 1)
    await h.wait_for(lambda: has_obj(n3, 1))
    await h.shutdown_node(n3)
    rec("follower down")
    await propose(P, n1, 2)
    n3b = await h.restart_node(n3)
    await h.wait_for(lambda: has_obj(n3b, 1) and has_obj(n3b, 2))
    assert n3b.raft_id == n3.raft_id
    rec("follower restarted")
    for n in (n1, n2, n3b):
        await h.shutdown_node(n)
    nodes = [await h.restart_node(n) for n in (n1, n2, n3b)]
    lead = await h.wait_for_cluster()
    assert all(has_obj(n, 1) and has_obj(n, 2) for n in nodes)
    rec("cluster restarted")
    await propose(P, lead, 3)
    await h.wait_for(lambda: all(has_obj(n, 3) for n in nodes))
    rec("write after restart")


async def case_snapshot_catch_up(P, h, rec):
    n1 = await h.add_node(snapshot_interval=10,
                          log_entries_for_slow_followers=2)
    await h.wait_for_leader()
    for i in range(15):
        await propose(P, n1, i)
    assert n1.status()["snapshot_index"] > 0
    rec("snapshotted")
    n2 = await h.add_node(join_from=n1)
    await h.wait_for(lambda: all(has_obj(n2, i) for i in range(15)))
    assert len(n2.cluster.members) == 2
    rec("caught up through the snapshot")
    await h.shutdown_node(n2)
    n2b = await h.restart_node(n2)
    await h.wait_for_cluster()
    assert all(has_obj(n2b, i) for i in range(15))
    rec("restarted from its snapshot")


async def case_remove_member(P, h, rec):
    n1, n2, n3 = await three(h)
    removed_id = n3.raft_id
    await n1.remove_member(removed_id)
    await h.wait_for(lambda: len(n1.cluster.members) == 2)
    assert n1.cluster.is_id_removed(removed_id)
    rec("removed")
    await h.tick(3)
    await propose(P, n1, 4)
    await h.wait_for(lambda: has_obj(n2, 4))
    rec("write after removal")


async def case_quorum_precheck(P, h, rec):
    n1, n2, n3 = await three(h)
    await h.shutdown_node(n3)
    lead = await h.wait_for_leader()
    target = n2 if lead is n1 else n1
    with pytest.raises(P.node.ErrCannotRemoveMember):
        await lead.remove_member(target.raft_id)
    rec("refused")
    await lead.remove_member(n3.raft_id)
    await h.wait_for(lambda: len(lead.cluster.members) == 2)
    rec("removed the down member")


async def case_not_leader(P, h, rec):
    n1 = await h.add_node()
    await h.wait_for_leader()
    n2 = await h.add_node(join_from=n1)
    await h.wait_for_cluster()
    follower = n2 if n1.is_leader() else n1
    with pytest.raises(P.node.ErrLostLeadership):
        await propose(P, follower, 1)
    with pytest.raises(P.node.NotLeaderError) as e:
        await follower.join("node-x", "node-x.test:4242")
    assert e.value.leader_addr == h.leader().addr
    rec("refused off the leader")
    # the join is idempotent, and a new address updates the member
    lead = h.leader()
    resp = await lead.join(follower.node_id, follower.addr)
    assert resp.raft_id == follower.raft_id
    resp = await lead.join(follower.node_id, "moved:999")
    await h.wait_for(lambda: lead.cluster.members[
        follower.raft_id].addr == "moved:999")
    assert len(lead.cluster.members) == 2
    rec("re-joined")


async def case_transfer(P, h, rec):
    n1, n2, n3 = await three(h)
    lead = h.leader()
    await lead.transfer_leadership(n2.raft_id if lead is not n2
                                   else n3.raft_id)
    await h.wait_for(lambda: h.leader() is not None
                     and h.leader() is not lead)
    rec("transferred")
    newlead = h.leader()
    await propose(P, newlead, 3)
    await h.wait_for(lambda: all(has_obj(n, 3) for n in (n1, n2, n3)))
    rec("write on the new leader")


async def case_timeouts_and_size(P, h, rec):
    n1, n2, n3 = await three(h)
    action = P.raft_msgs.StoreAction.make(
        P.raft_msgs.StoreActionKind.CREATE, obj(P, 42))
    # a bare ProposeValue applies to the leader's own store
    await n1.propose_value([action])
    assert has_obj(n1, 42)
    await h.wait_for(lambda: has_obj(n2, 42) and has_obj(n3, 42))
    rec("bare propose")
    big = P.raft_msgs.StoreAction.make(
        P.raft_msgs.StoreActionKind.CREATE,
        P.api.Node(id="big", spec=P.api.NodeSpec(
            annotations=P.api.Annotations(name="x" * 4096))))
    n1.opts.max_proposal_bytes = 2048
    with pytest.raises(P.node.ErrProposalTooLarge):
        await n1.propose_value([big])
    n1.opts.max_proposal_bytes = int(1.5 * 1024 * 1024)
    rec("too large")
    # cut off both followers: the proposal cannot commit and fails once
    # its timeout passes on the fake clock (or the leader steps down)
    h.network.partition({n1.addr}, {n2.addr, n3.addr})
    task = asyncio.ensure_future(n1.propose_value(
        [P.raft_msgs.StoreAction.make(P.raft_msgs.StoreActionKind.CREATE,
                                      obj(P, 77))], timeout=2.0))
    for _ in range(40):
        if task.done():
            break
        await h.tick()
    assert task.done()
    with pytest.raises((TimeoutError, P.node.ErrLostLeadership)):
        task.result()
    assert not has_obj(n2, 77) and not has_obj(n3, 77)
    rec(f"timed out: {type(task.exception()).__name__}")
    h.network.heal()
    lead = await h.wait_for_cluster()
    await propose(P, lead, 88)
    await h.wait_for(lambda: all(has_obj(n, 88) for n in (n1, n2, n3)))
    rec("healed")


async def case_force_new_cluster(P, h, rec):
    n1, n2, n3 = await three(h)
    await propose(P, n1, 1)
    await h.wait_for(lambda: has_obj(n2, 1) and has_obj(n3, 1))
    for n in (n1, n2, n3):
        await h.shutdown_node(n)
    n1b = await h.restart_node(n1, force_new_cluster=True)
    await h.wait_for_leader()
    assert len(n1b.cluster.members) == 1 and has_obj(n1b, 1)
    rec("forced")
    await propose(P, n1b, 2)
    n4 = await h.add_node(join_from=n1b)
    await h.wait_for(lambda: has_obj(n4, 1) and has_obj(n4, 2))
    rec("grew again")


KEY = bytes(range(32))


async def case_encrypted_wal(P, h, rec):
    crypt = P.encryption.SecretboxCrypter(KEY)
    n1 = await h.add_node(encrypter=crypt, decrypter=crypt,
                          snapshot_interval=4)
    await h.wait_for_leader()
    for i in range(6):
        await propose(P, n1, i)
    blob = b"".join(open(os.path.join(n1.opts.state_dir, "raft", f),
                         "rb").read()
                    for f in os.listdir(os.path.join(n1.opts.state_dir,
                                                     "raft")))
    assert b"obj1" not in blob
    rec("encrypted")
    await h.shutdown_node(n1)
    n1b = await h.restart_node(n1, encrypter=crypt, decrypter=crypt)
    await h.wait_for_leader()
    assert all(has_obj(n1b, i) for i in range(6))
    rec("restarted")


CASES = {f.__name__[5:]: f for f in (
    case_bootstrap_single, case_replication, case_leader_down,
    case_restart_from_wal, case_snapshot_catch_up, case_remove_member,
    case_quorum_precheck, case_not_leader, case_transfer,
    case_timeouts_and_size, case_force_new_cluster, case_encrypted_wal)}


def run_case(root: str, case) -> list:
    P = package(root)

    async def go():
        h = RaftHarness(P)
        rec = Trace(h.views)
        try:
            await case(P, h, rec)
        finally:
            await h.close()
        return rec
    return asyncio.run(go())


@pytest.mark.parametrize("name", sorted(CASES))
def test_node_shell_equals_jax(name):
    want = run_case("swarmkit_tpu", CASES[name])
    got = run_case("swarmkit_tpu_torch", CASES[name])
    assert_same_trace(want, got)


# ---- a state_dir written by one package bootstraps the other's ----------

async def _write_cluster(P, root: str) -> dict:
    h = RaftHarness(P, state_root=root)
    kw = dict(snapshot_interval=6, log_entries_for_slow_followers=2)
    n1 = await h.add_node(**kw)
    await h.wait_for_leader()
    n2 = await h.add_node(join_from=n1, **kw)
    n3 = await h.add_node(join_from=n1, **kw)
    await h.wait_for_cluster()
    for i in range(9):
        await propose(P, n1, i)
    await h.wait_for(lambda: all(has_obj(n, 8) for n in (n1, n2, n3)))
    await h.tick(2)
    views = h.views()
    for n in (n1, n2, n3):
        await h.shutdown_node(n)
    return views


async def _restart_cluster(P, root: str, nodes: list) -> dict:
    h = RaftHarness(P, state_root=root)
    for i, nid in enumerate(nodes, start=1):
        h._n = i
        node = P.Node(h._opts(nid))
        h.nodes[nid] = node
        await node.start()
        await h.pump()
    booted = h.views()
    lead = await h.wait_for_cluster()
    await propose(P, lead, 99)
    await h.wait_for(lambda: all(has_obj(n, 99) for n in h.nodes.values()))
    for n in list(h.nodes.values()):
        await h.shutdown_node(n)
    return booted


def _disk(P, state_dir: str):
    """What one package's logger reads back from a node's state_dir."""
    lg = P.storage.EncryptedRaftLogger(state_dir)
    boot = lg.bootstrap_from_disk()
    lg.close()
    hs = boot.hard_state
    snap = boot.snapshot
    return ((hs.term, hs.vote, hs.commit) if hs else None,
            [(e.index, e.term, int(e.type), e.data) for e in boot.entries],
            (snap.meta.index, snap.meta.term, tuple(snap.meta.voters),
             snap.data) if snap else None)


@pytest.mark.parametrize("writer,reader", [ROOTS, ROOTS[::-1]])
def test_state_dir_bootstraps_the_other_package(writer, reader, tmp_path):
    written = asyncio.run(_write_cluster(package(writer), str(tmp_path)))
    for nid in written:
        d = str(tmp_path / nid)
        assert _disk(package(reader), d) == _disk(package(writer), d)
    booted = asyncio.run(_restart_cluster(package(reader), str(tmp_path),
                                          sorted(written)))
    # a replayed entry is stamped with the applying node's clock, in either
    # package: the reader's clock restarts at 0
    stamps = [("node", "meta.created_at"), ("node", "meta.updated_at")]
    for nid, w in written.items():
        b = booted[nid]
        assert b["raft_id"] == w["raft_id"]
        assert b["snapshot"] == w["snapshot"] > 0
        assert b["members"] == w["members"]
        assert store_view_of(b, stamps) == store_view_of(w, stamps)
        assert (b["term"], b["vote"]) == (w["term"], w["vote"])
        assert b["commit"] <= w["commit"]
        assert b["log"] == [e for e in w["log"] if e[0] >= b["first"]]
