"""Raft peer transport: async per-peer message fan-out behind the Transport
seam.

Behavioral reference: manager/state/raft/transport/ — ``Transport`` owns one
``peer`` per remote with a non-blocking bounded send queue (4096 deep,
transport/peer.go:61; messages DROPPED when full, peer.go:82-89), reports
unreachable peers and snapshot delivery status back to the raft node through
the ``Raft`` callback interface (transport.go:26), tracks per-peer activity
for ``LongestActive``, and supports live address updates.

This is the seam the device-mesh backend slots behind (SURVEY.md §2.7):
impl #1 here is an in-process asyncio network with per-edge drop/partition
fault injection (replacing gRPC-over-mTLS); impl #3
(swarmkit_tpu_torch.transport.device_mesh) exchanges messages through a
device mailbox.  The PyTorch port's own copy of the JAX package's
raft/transport.py, unchanged in behaviour.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional, Protocol

from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.raft.faults import FaultSurface
from swarmkit_tpu_torch.raft.messages import Message, MsgType

log = logging.getLogger("swarmkit_tpu_torch.raft.transport")

MAX_PEER_QUEUE = 4096  # reference: transport/peer.go:61


class RaftHandlers(Protocol):
    """Callbacks from transport into the raft node
    (reference: transport.Raft transport.go:26)."""

    async def process_raft_message(self, m: Message) -> None: ...
    def report_unreachable(self, raft_id: int, failures: int = 1) -> None: ...
    def report_snapshot(self, raft_id: int, ok: bool) -> None: ...
    def is_id_removed(self, raft_id: int) -> bool: ...
    def update_node(self, raft_id: int, addr: str) -> None: ...
    def node_removed(self) -> None: ...


class Unreachable(Exception):
    pass


class PeerRemoved(Exception):
    """Raised by a server when the caller has been removed from the cluster
    (reference: ErrMemberRemoved grpc error)."""


class Network(FaultSurface):
    """In-process wire: addr -> server object, with fault injection.

    The fault vocabulary (down/drop/partition/delay + crash_restart + heal)
    lives on the shared FaultSurface so the wires expose the identical
    surface; see raft/faults.py.
    """

    wire_name = "inproc"  # transport metric label; subclasses override

    def __init__(self, seed: int = 0) -> None:
        super().__init__(seed=seed)
        self._servers: dict[str, Any] = {}

    # -- topology ----------------------------------------------------------
    def register(self, addr: str, server: Any) -> None:
        self._servers[addr] = server
        self._down.discard(addr)

    def unregister(self, addr: str) -> None:
        self._servers.pop(addr, None)

    # -- reachability ------------------------------------------------------
    def _blocked(self, frm: str, to: str) -> bool:
        return to not in self._servers or self._fault_blocked(frm, to)

    def reachable(self, frm: str, to: str) -> bool:
        return not self._blocked(frm, to)

    def healthy(self, addr: str) -> bool:
        return addr in self._servers and addr not in self._down

    def server(self, frm: str, to: str) -> Any:
        """Dial: returns the server at `to` or raises Unreachable."""
        if self._blocked(frm, to):
            raise Unreachable(f"{to} unreachable from {frm}")
        return self._servers[to]


class _Peer:
    """One remote: bounded queue + drain task
    (reference: transport/peer.go)."""

    def __init__(self, tr: "Transport", raft_id: int, addr: str) -> None:
        self.tr = tr
        self.raft_id = raft_id
        self.addr = addr
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=MAX_PEER_QUEUE)
        self.active_since: float = 0.0
        self.failures = 0   # consecutive delivery failures
        self._task = asyncio.get_running_loop().create_task(self._drain())

    def send(self, m: Message) -> bool:
        try:
            self.queue.put_nowait((self.tr.clock.now(), m))
            return True
        except asyncio.QueueFull:
            return False  # drop, reference peer.go:82-89

    async def _drain(self) -> None:
        while True:
            queued_at, m = await self.queue.get()
            if self.failures:
                self.tr.m_redials.inc()
                await self._redial_backoff()
            await self._deliver(m, queued_at)

    async def _redial_backoff(self) -> None:
        """Bounded exponential backoff + jitter between redials of a failing
        peer (reference: peer.go resolve/redial backoff). Only wires that
        opt in via a ``dial_backoff = (base, cap)`` attribute pay it — the
        in-process Network keeps immediate retry so fake-clock tests keep
        their exact tick schedules."""
        bk = getattr(self.tr.network, "dial_backoff", None)
        if bk is None:
            return
        base, cap = bk
        delay = min(cap, base * (2 ** min(self.failures - 1, 8)))
        rng = getattr(self.tr.network, "_rng", None)
        jitter = rng.random() if rng is not None else 0.5
        await self.tr.clock.sleep(delay * (0.5 + 0.5 * jitter))

    async def _deliver(self, m: Message, queued_at: float = 0.0) -> None:
        net, tr = self.tr.network, self.tr
        try:
            if net.lossy(tr.local_addr, self.addr):
                net.dropped += 1
                return  # silent loss: raft retries; not "unreachable"
            delay = net.delay_for(tr.local_addr, self.addr) \
                if hasattr(net, "delay_for") else 0.0
            if delay > 0:
                await tr.clock.sleep(delay)
            server = net.server(tr.local_addr, self.addr)
            await server.process_raft_message(m)
            net.delivered += 1
            tr.m_delivery.observe(max(0.0, tr.clock.now() - queued_at))
            if self.failures:
                self.failures = 0
                # recovery signal: clears the peer's failure count in status
                tr.handlers.report_unreachable(self.raft_id, 0)
            if self.active_since == 0.0:
                self.active_since = tr.clock.now() or 1e-9
            if m.type == MsgType.SNAP:
                tr.handlers.report_snapshot(self.raft_id, True)
        except PeerRemoved:
            tr.handlers.node_removed()
        except Exception as e:
            # Any delivery/processing failure counts as "peer unreachable"
            # (matching the reference's RPC-error handling, peer.go:261),
            # but log it — a receiver-side crash must not vanish silently.
            if not isinstance(e, Unreachable):
                log.warning("raft message delivery %s -> %s failed: %r",
                            tr.local_addr, self.addr, e)
            self.active_since = 0.0
            self.failures += 1
            tr.m_send_failures.inc()
            if m.type == MsgType.SNAP:
                tr.handlers.report_snapshot(self.raft_id, False)
            tr.handlers.report_unreachable(self.raft_id, self.failures)

    def stop(self) -> None:
        self._task.cancel()


class Transport:
    """reference: transport.Transport transport.go:47."""

    def __init__(self, network: Network, handlers: RaftHandlers,
                 local_addr: str, clock) -> None:
        self.network = network
        self.handlers = handlers
        self.local_addr = local_addr
        self.clock = clock
        self._peers: dict[int, _Peer] = {}
        self.stopped = False
        # share the node's typed registry when the handlers carry one
        self.obs = getattr(handlers, "obs", None) or obs_registry.DEFAULT
        wire = getattr(network, "wire_name", "inproc")
        self.m_delivery = obs_catalog.get(
            self.obs, "swarm_transport_delivery_latency_seconds"
        ).labels(wire=wire)
        self.m_redials = obs_catalog.get(
            self.obs, "swarm_transport_redials_total").labels(wire=wire)
        self.m_send_failures = obs_catalog.get(
            self.obs, "swarm_transport_send_failures_total").labels(wire=wire)

    def add_peer(self, raft_id: int, addr: str) -> None:
        if raft_id in self._peers:
            if self._peers[raft_id].addr == addr:
                return
            self._peers[raft_id].stop()
        self._peers[raft_id] = _Peer(self, raft_id, addr)

    def remove_peer(self, raft_id: int) -> None:
        p = self._peers.pop(raft_id, None)
        if p is not None:
            p.stop()

    def update_peer(self, raft_id: int, addr: str) -> None:
        self.add_peer(raft_id, addr)

    def peer_ids(self) -> list[int]:
        return list(self._peers)

    def send(self, m: Message) -> None:
        """Non-blocking send (reference: Send transport.go:125)."""
        if self.stopped:
            return
        if self.handlers.is_id_removed(m.to):
            return
        p = self._peers.get(m.to)
        if p is None:
            # unknown peer: the reference resolves via LongestActive; we just
            # report unreachable so raft backs off
            self.handlers.report_unreachable(m.to)
            if m.type == MsgType.SNAP:
                self.handlers.report_snapshot(m.to, False)
            return
        if not p.send(m):
            if m.type == MsgType.SNAP:
                self.handlers.report_snapshot(m.to, False)

    def longest_active(self) -> Optional[int]:
        """reference: LongestActive transport.go:299."""
        best = None
        for raft_id, p in self._peers.items():
            if p.active_since <= 0:
                continue
            if best is None or p.active_since < self._peers[best].active_since:
                best = raft_id
        return best

    def active_count(self) -> int:
        return sum(1 for p in self._peers.values() if p.active_since > 0)

    def stop(self) -> None:
        self.stopped = True
        for p in self._peers.values():
            p.stop()
        self._peers = {}
