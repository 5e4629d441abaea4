"""The port's raft wire over real gRPC sockets (raft/grpc_transport.py)
against the JAX package's.

tests/test_grpc_transport.py's cases run on the port
(tests/torch_port_copies.py).  The codec is held byte for byte to the JAX
package's on the messages its cases send.  Then a mixed quorum on
127.0.0.1: one JAX Manager on the JAX package's GrpcNetwork bootstraps,
two port Managers on the port's GrpcNetwork join it; they elect, commit a
service to all three stores, elect a port leader when the JAX one stops,
commit through it, and the JAX manager restarted from its state_dir heals
to the same store.
"""

from __future__ import annotations

import asyncio
import tempfile

import pytest

from swarmkit_tpu import api as japi
from swarmkit_tpu.manager.manager import Manager as JManager
from swarmkit_tpu.raft import grpc_transport as jgt
from swarmkit_tpu.raft.messages import (
    Entry, EntryType, Message, MsgType, Snapshot, SnapshotMeta,
)
from swarmkit_tpu_torch import api as tapi
from swarmkit_tpu_torch.manager.manager import Manager as TManager
from swarmkit_tpu_torch.raft import grpc_transport as tgt
from swarmkit_tpu_torch.raft import messages as tmsg
from tests.torch_port_copies import cases, free_port, on_cpu, port_copy

JAX_CASES = port_copy("test_grpc_transport")


@pytest.mark.parametrize("case", cases(JAX_CASES))
def test_jax_case_on_port(case, monkeypatch):
    on_cpu(monkeypatch)
    getattr(JAX_CASES, case)()


def _messages(m):
    return [
        m.Message(type=m.MsgType.APP, to=2, frm=1, term=7, log_term=6,
                  index=41, entries=(m.Entry(index=42, term=7,
                                             type=m.EntryType.NORMAL,
                                             data=b"payload"),),
                  commit=40, reject=True, reject_hint=39,
                  snapshot=m.Snapshot(meta=m.SnapshotMeta(
                      index=10, term=3, voters=(1, 2, 3)), data=b"snap"),
                  context=b"ctx"),
        m.Message(type=m.MsgType.VOTE, to=3, frm=2, term=2**40, index=2**33),
        m.Message(type=m.MsgType.SNAP, to=2, frm=1, term=1,
                  snapshot=m.Snapshot(meta=m.SnapshotMeta(index=5, term=1),
                                      data=b"z" * 70000)),
    ]


def test_codec_is_the_jax_packages_byte_for_byte():
    import types
    jm = types.SimpleNamespace(Message=Message, MsgType=MsgType, Entry=Entry,
                               EntryType=EntryType, Snapshot=Snapshot,
                               SnapshotMeta=SnapshotMeta)
    for jmsg, tmsg_ in zip(_messages(jm), _messages(tmsg)):
        raw = jgt.encode_message(jmsg)
        assert tgt.encode_message(tmsg_) == raw
        assert tgt.decode_message(raw) == tmsg_
        assert jgt.decode_message(tgt.encode_message(tmsg_)) == jmsg


def _store(m) -> dict:
    """A manager's store by kind and id, without the meta stamps each
    replica takes from its own clock."""
    out = {}
    for kind in ("node", "service", "cluster"):
        objs = {}
        for o in m.store.find(kind):
            d = o.to_dict()
            d["meta"] = {**d["meta"], "created_at": None, "updated_at": None}
            objs[o.id] = d
        out[kind] = objs
    return out


async def _until(pred, what: str, timeout: float = 20.0) -> None:
    for _ in range(int(timeout / 0.05)):
        if pred():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timeout waiting for {what}")


def _spec(api, name):
    return api.ServiceSpec(
        annotations=api.Annotations(name=name),
        task=api.TaskSpec(container=api.ContainerSpec(image="img")),
        replicated=api.ReplicatedService(replicas=0))


def test_mixed_quorum_elects_commits_and_heals():
    async def go():
        tmp = tempfile.TemporaryDirectory(prefix="mixed-grpc-")
        jnet, tnet = jgt.GrpcNetwork(), tgt.GrpcNetwork()
        addrs = [f"127.0.0.1:{free_port()}" for _ in range(3)]
        common = dict(tick_interval=0.05, election_tick=4)

        def jax_manager():
            return JManager(node_id="m0", addr=addrs[0], network=jnet,
                            state_dir=f"{tmp.name}/m0", seed=50, **common)
        mgrs = [jax_manager()]
        try:
            await mgrs[0].start()
            await _until(mgrs[0].is_leader, "the JAX manager leads")
            for i in (1, 2):
                m = TManager(node_id=f"m{i}", addr=addrs[i], network=tnet,
                             state_dir=f"{tmp.name}/m{i}",
                             join_addr=addrs[0], seed=50 + i, device="cpu",
                             **common)
                await m.start()
                mgrs.append(m)
            await _until(lambda: all(len(m.raft.cluster.members) == 3
                                     for m in mgrs), "three members")
            svc = await mgrs[0].control_api.create_service(
                _spec(japi, "from-jax"))
            await _until(lambda: all(m.store.get("service", svc.id)
                                     for m in mgrs), "the JAX write")
            await _until(lambda: _store(mgrs[1]) == _store(mgrs[0])
                         == _store(mgrs[2]), "three equal stores")
            await mgrs[0].stop()
            await _until(lambda: any(m._is_leader for m in mgrs[1:]),
                         "a port leader")
            lead = next(m for m in mgrs[1:] if m._is_leader)
            svc2 = await lead.control_api.create_service(
                _spec(tapi, "from-port"))
            mgrs[0] = jax_manager()
            await mgrs[0].start()
            await _until(lambda: mgrs[0].store.get("service", svc2.id),
                         "the restarted JAX manager catches up")
            await _until(lambda: _store(mgrs[0]) == _store(lead),
                         "the healed store equal to the leader's")
            assert {s.spec.annotations.name
                    for s in mgrs[0].store.find("service")} \
                == {"from-jax", "from-port"}
        finally:
            for m in mgrs:
                try:
                    await m.stop()
                except Exception:
                    pass
            await jnet.close()
            await tnet.close()
            tmp.cleanup()
    asyncio.run(go())
