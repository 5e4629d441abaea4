"""Device-mesh raft transport: message exchange through a device-resident
mailbox (Transport impl #3 from SURVEY.md §2.7; the PyTorch port of the
JAX package's transport/device_mesh.py).

Behavioral reference: manager/state/raft/transport/transport.go:26-45,125 —
the ``Transport`` seam with non-blocking ``Send``, bounded per-peer queues
(drop on full, peer.go:82-89), unreachable/snapshot status reporting, and
per-peer activity tracking. The reference moves messages over per-peer gRPC
streams; this implementation moves them through a device mailbox:

- ``Send`` serializes the message (raft/wire.py) and packs it into a
  bounded per-edge slot of a [senders, receivers, K, W] int32 mailbox (the
  message's bytes as int32 bits).
- Delivery is one exchange over the wire's row mesh (parallel.row_mesh:
  every local card of the wire's device type, or the devices of `mesh=`):
  it takes the mailbox, its lengths and its keep mask, and returns the
  receiver-major views with masked lengths zeroed.  On one entry that is
  the transpose of the first two axes (`exchange`).  On D > 1 entries the
  mailbox lies split by sender rows, one block of rows an entry, and the
  exchange is an all-to-all (`all_to_all`), as the JAX package's jitted
  program over its row mesh lowers to: block (i, j) of entry i's rows
  (the receivers of entry j) is copied to entry j, D^2 copies, and each
  entry transposes the sender blocks it holds.  Drop / partition / crash
  faults are the keep mask, applied on the device.  Each flush reads the
  result back once (once an entry).
- Delivered payloads are decoded back into Message objects and stepped into
  the receiving node, mirroring ProcessRaftMessage (raft.go:1397).

Mailbox shapes are bucketed (K in 4/16/64 slots, W in 64..65536 words) and
chosen per flush by need, narrow and wide messages in separate exchanges;
a message wider than the largest bucket (256 KiB) is undeliverable and
reported unreachable — the analog of the reference's 4 MiB gRPC cap
(peer.go:24).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch import parallel
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.raft.messages import Message, MsgType
from swarmkit_tpu_torch.raft.transport import (
    Network, PeerRemoved, RaftHandlers, Unreachable,
)
from swarmkit_tpu_torch.raft.wire import decode_message, encode_message

log = logging.getLogger("swarmkit_tpu_torch.transport.device_mesh")

K_BUCKETS = (4, 16, 64)          # mailbox depth (messages per edge per flush)
W_BUCKETS = (64, 1024, 16384, 65536)  # int32 words per message slot


def _bucket(buckets, need):
    for b in buckets:
        if need <= b:
            return b
    return None


def _words(raw: bytes) -> int:
    return (len(raw) + 3) // 4


def exchange(words: torch.Tensor, lens: torch.Tensor, keep: torch.Tensor):
    """Deliver: the receiver-major views of a [senders, receivers, K, W]
    mailbox and its [senders, receivers, K] lengths, with the lengths of
    masked slots (keep false) zeroed.  On one device the sender->receiver
    exchange is the transpose of the first two axes."""
    lens = torch.where(keep, lens, torch.zeros_like(lens))
    return words.transpose(0, 1), lens.transpose(0, 1)


def _block(x: torch.Tensor, j: int, rows: int, dev) -> torch.Tensor:
    """Block j of a sender entry's [rows, R, ...] mailbox rows (receivers
    [j * rows, (j + 1) * rows)), copied to receiver entry j's device."""
    return x[:, j * rows:(j + 1) * rows].to(dev)


def all_to_all(words: list, lens: list, keep: list) -> tuple:
    """`exchange` over a row mesh of D entries: entry i holds sender rows
    [i * r, (i + 1) * r) of the mailbox (words [r, R, K, W], lens and keep
    [r, R, K], on its device).  Masked lengths are zeroed on the senders,
    each block (i, j) goes from entry i to entry j, and entry j returns
    its receivers' rows [r, R, K, W] / [r, R, K], receiver-major, on its
    own device: the transpose, one row block an entry."""
    rows = words[0].shape[0]
    lens = [torch.where(k, ln, torch.zeros_like(ln))
            for ln, k in zip(lens, keep)]
    out_w, out_l = [], []
    for j, dest in enumerate(words):
        dev = dest.device
        out_w.append(torch.cat([_block(w, j, rows, dev) for w in words])
                     .transpose(0, 1))
        out_l.append(torch.cat([_block(ln, j, rows, dev) for ln in lens])
                     .transpose(0, 1))
    return out_w, out_l


class DeviceMeshNet(Network):
    """Shared device mailbox wire for a cluster of DeviceMeshTransports.

    Extends the in-process Network (same fault-injection and registration
    API, so test harnesses drive partitions/drops identically); raft
    messages go through the device exchange instead of per-peer queues.
    `device` defaults to the current CUDA card and raises without one;
    pass ``device="cpu"`` to run the exchange on the CPU.  `mesh` is the
    row mesh the mailbox lies on (default: parallel.row_mesh(rows) over
    the local devices of `device`'s type; a 1-D mesh whose size divides
    `rows`, which may name one device more than once).
    """

    wire_name = "device"

    def __init__(self, seed: int = 0, rows: int = 8, device=None,
                 mesh: Optional[parallel.Mesh] = None,
                 obs: Optional[obs_registry.MetricsRegistry] = None) -> None:
        super().__init__(seed=seed)
        self.rows = rows
        self.device = resolve_device(device)
        if mesh is None:
            mesh = parallel.row_mesh(rows,
                                     parallel.local_devices(self.device))
        if mesh.devices.ndim != 1 or rows % mesh.size:
            raise ValueError(f"the wire's mesh must be 1-D and divide its "
                             f"{rows} rows, not {mesh.shape}")
        self.mesh = mesh
        self._row_of: dict[str, int] = {}
        # (frm_row, to_row) -> list of (raw, msg, transport, to_raft_id,
        #                               frm_addr, to_addr, ready_at)
        # ready_at: clock time before which an injected delay holds the
        # message back from the exchange (0.0 = deliver on next flush)
        self._staged: dict[tuple[int, int], list] = {}
        self._event: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._delay_task: Optional[asyncio.Task] = None
        self.device_flushes = 0
        self.device_messages = 0
        # Optional flightrec/clock.py ClockSync: every device exchange is
        # a host<->device boundary, so each flush records one sync point
        # on the (device_flushes, host_ns) axes — this wire has no sim
        # tick, the flush counter is its monotone device-time analog.
        self.clock_sync = None
        self.obs = obs or obs_registry.DEFAULT
        obs_catalog.get(self.obs, "swarm_transport_mailbox_depth") \
            .set_function(lambda: float(
                sum(len(q) for q in self._staged.values())))
        self._m_flushes = obs_catalog.get(
            self.obs, "swarm_transport_device_flushes_total")
        self._m_messages = obs_catalog.get(
            self.obs, "swarm_transport_device_messages_total")
        self._m_exchange = obs_catalog.get(
            self.obs, "swarm_transport_exchange_seconds")

    # -- rows --------------------------------------------------------------
    def row_for(self, addr: str) -> int:
        r = self._row_of.get(addr)
        if r is None:
            if len(self._row_of) >= self.rows:
                # Reclaim rows of addresses that are gone from the wire
                # (membership churn must not exhaust the mailbox).
                for gone in [a for a in self._row_of
                             if a not in self._servers and a != addr]:
                    free = self._row_of.pop(gone)
                    self._row_of[addr] = free
                    return free
                raise RuntimeError(
                    f"device mesh rows exhausted ({self.rows}); "
                    "grow `rows` for larger clusters")
            r = len(self._row_of)
            self._row_of[addr] = r
        return r

    # -- staging (called from DeviceMeshTransport.send) --------------------
    def stage(self, tr: "DeviceMeshTransport", to_raft_id: int, to_addr: str,
              m: Message) -> bool:
        try:
            frm, to = self.row_for(tr.local_addr), self.row_for(to_addr)
        except RuntimeError:
            return False  # no row available: drop; send() reports status
        q = self._staged.setdefault((frm, to), [])
        if len(q) >= K_BUCKETS[-1]:
            return False  # mailbox full: drop (reference peer.go:82-89)
        delay = self.delay_for(tr.local_addr, to_addr)
        ready_at = (tr.clock.now() or 0.0) + delay if delay > 0 else 0.0
        q.append((encode_message(m), m, tr, to_raft_id, tr.local_addr,
                  to_addr, ready_at))
        self._ensure_pump()
        self._event.set()
        return True

    def _ensure_pump(self) -> None:
        if self._task is None or self._task.done():
            self._event = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._pump())

    async def _pump(self) -> None:
        while True:
            await self._event.wait()
            self._event.clear()
            try:
                await self._flush()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("device mailbox flush failed")

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._delay_task is not None:
            self._delay_task.cancel()
            self._delay_task = None

    def crash_restart(self, addr: str) -> None:
        """A process bounce at `addr`: everything staged to or from it in
        the mailbox dies with the old incarnation."""
        for key, q in list(self._staged.items()):
            q[:] = [e for e in q if addr not in (e[4], e[5])]
            if not q:
                del self._staged[key]

    def _arm_delay_wake(self, ready_at: float, clock) -> None:
        """Re-trigger a flush once the earliest held-back message matures.
        Uses the transports' (possibly fake) clock so delayed delivery is
        deterministic under test harness ticks."""
        if self._delay_task is not None and not self._delay_task.done():
            return  # the pending wake's flush re-arms for later messages

        async def wake():
            dt = ready_at - (clock.now() or 0.0)
            if dt > 0:
                await clock.sleep(dt)
            if self._event is not None:
                self._event.set()

        self._delay_task = asyncio.get_running_loop().create_task(wake())

    # -- the device exchange ----------------------------------------------
    def pack(self, entries) -> tuple:
        """The host mailbox of one exchange: entries are (frm, to, k, raw)
        with k the slot on its edge; the buckets are the least that hold
        the deepest edge and the widest message.  Returns (words, lens,
        keep) as numpy arrays, keep all false (the caller sets it)."""
        kb = _bucket(K_BUCKETS, max(k for _, _, k, _ in entries) + 1)
        wb = _bucket(W_BUCKETS, max(_words(raw) for *_, raw in entries))
        rows = self.rows
        words = np.zeros((rows, rows, kb, wb), np.int32)
        lens = np.zeros((rows, rows, kb), np.int32)
        for frm, to, k, raw in entries:
            buf = np.frombuffer(raw + b"\0" * ((-len(raw)) % 4), "<i4")
            words[frm, to, k, :len(buf)] = buf
            lens[frm, to, k] = len(raw)
        return words, lens, np.zeros((rows, rows, kb), bool)

    def run_exchange(self, words: np.ndarray, lens: np.ndarray,
                     keep: np.ndarray) -> tuple:
        """The host mailbox through the exchange on the wire's mesh (split
        by sender rows over its entries when it has several), read back
        once: the receiver-major (words, lens) as numpy arrays."""
        devices = [torch.device(d) for d in self.mesh.device_list()]
        host = (torch.from_numpy(words), torch.from_numpy(lens),
                torch.from_numpy(keep))
        if len(devices) == 1:
            outs = [exchange(*(t.to(devices[0]) for t in host))]
        else:
            r = self.rows // len(devices)
            w, ln, k = ([t[i * r:(i + 1) * r].to(dev)
                         for i, dev in enumerate(devices)] for t in host)
            outs = list(zip(*all_to_all(w, ln, k)))
        back = [[t.to("cpu", non_blocking=t.is_cuda) for t in out]
                for out in outs]
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
        return (np.concatenate([b[0].numpy() for b in back]),
                np.concatenate([b[1].numpy() for b in back]))

    async def _flush(self) -> None:
        staged, self._staged = self._staged, {}
        if not staged:
            return
        oversize = []        # (tr, raft_id, msg): larger than any bucket
        blocked_cb = []      # (tr, raft_id, msg): masked edges -> unreachable
        packed = []          # (frm, to, raw, msg, tr, raft_id, to_addr,
                             #  deliverable)
        deferred = []        # injected delay: not yet mature, re-stage
        for (frm, to), q in staged.items():
            for entry in q:
                raw, m, tr, rid, frm_addr, to_addr, ready_at = entry
                if ready_at > 0 and (tr.clock.now() or 0.0) < ready_at:
                    deferred.append(((frm, to), entry))
                    continue
                if _words(raw) > W_BUCKETS[-1]:
                    oversize.append((tr, rid, m))
                    continue
                # Fault decisions are made here (host owns topology + rng for
                # determinism) but APPLIED on device via the keep mask: every
                # message is packed into the mailbox; masked slots come back
                # with length 0 from the exchange.
                deliverable = True
                if self._blocked(frm_addr, to_addr):
                    deliverable = False
                    blocked_cb.append((tr, rid, m))
                elif self.lossy(frm_addr, to_addr):
                    deliverable = False  # silent loss: raft retries
                    self.dropped += 1
                packed.append((frm, to, raw, m, tr, rid, to_addr,
                               deliverable))

        if deferred:
            for key, entry in deferred:
                self._staged.setdefault(key, []).append(entry)
            earliest = min(e[6] for _, e in deferred)
            self._arm_delay_wake(earliest, deferred[0][1][2].clock)

        for tr, rid, m in oversize:
            tr.peer_failed(rid, m)

        # Narrow and wide messages go through SEPARATE exchanges so the
        # depth bucket of a busy edge never cross-multiplies with the width
        # bucket of a snapshot (8*8*64 slots * 64Ki words would be 1 GiB of
        # zeros for a few KB of payload).
        narrow = [e for e in packed if _words(e[2]) <= W_BUCKETS[1]]
        wide = [e for e in packed if _words(e[2]) > W_BUCKETS[1]]
        for group in (narrow, wide):
            if group:
                await self._flush_group(group)

        # Unreachable reports fire after the exchange (the reference's RPC
        # error path, peer.go:261).
        for tr, rid, m in blocked_cb:
            tr.peer_failed(rid, m)

    async def _flush_group(self, packed) -> None:
        # number the slots per edge within this group
        slot_of: dict[tuple[int, int], int] = {}
        entries = []
        for frm, to, raw, m, tr, rid, to_addr, deliverable in packed:
            k = slot_of.get((frm, to), 0)
            slot_of[(frm, to)] = k + 1
            entries.append((frm, to, k, raw, m, tr, rid, to_addr,
                            deliverable))
        words, lens, keep = self.pack([e[:4] for e in entries])
        for frm, to, k, *_, deliverable in entries:
            keep[frm, to, k] = deliverable
        t0 = time.perf_counter()
        d_words, d_lens = self.run_exchange(words, lens, keep)
        self._m_exchange.observe(time.perf_counter() - t0)
        self.device_flushes += 1
        if self.clock_sync is not None:
            # run_exchange waited for the device, so "now" really is
            # when the device finished flush #device_flushes
            self.clock_sync.add(self.device_flushes)
        self.device_messages += len(entries)
        self._m_flushes.inc()
        self._m_messages.inc(len(entries))

        for frm, to, k, raw, m, tr, rid, to_addr, deliverable in entries:
            nbytes = int(d_lens[to, frm, k])
            if nbytes <= 0:
                continue  # masked out on device
            payload = d_words[to, frm, k].tobytes()[:nbytes]
            await self._deliver(tr, rid, to_addr, payload, m)

    async def _deliver(self, tr: "DeviceMeshTransport", raft_id: int,
                       to_addr: str, payload: bytes, m: Message) -> None:
        server = self._servers.get(to_addr)
        if server is None:
            tr.peer_failed(raft_id, m)
            return
        try:
            msg = decode_message(payload)
            await server.process_raft_message(msg)
            self.delivered += 1
            tr.peer_delivered(raft_id, m)
        except PeerRemoved:
            tr.handlers.node_removed()
        except Exception as e:
            if not isinstance(e, Unreachable):
                log.warning("device-mesh delivery %s -> %s failed: %r",
                            tr.local_addr, to_addr, e)
            tr.peer_failed(raft_id, m)


class DeviceMeshTransport:
    """Transport-seam implementation backed by a DeviceMeshNet.

    Same interface as raft/transport.py's Transport (the seam from
    transport.go:47): non-blocking send, add/remove/update peer, activity
    tracking, unreachable + snapshot status callbacks into RaftHandlers.
    """

    def __init__(self, network: DeviceMeshNet, handlers: RaftHandlers,
                 local_addr: str, clock) -> None:
        if not isinstance(network, DeviceMeshNet):
            raise TypeError("DeviceMeshTransport requires a DeviceMeshNet "
                            "wire")
        self.network = network
        self.handlers = handlers
        self.local_addr = local_addr
        self.clock = clock
        self._peers: dict[int, str] = {}
        self._active_since: dict[int, float] = {}
        self._fail_counts: dict[int, int] = {}   # consecutive failures
        self.stopped = False
        network.row_for(local_addr)

    # -- peer management ---------------------------------------------------
    def add_peer(self, raft_id: int, addr: str) -> None:
        if self._peers.get(raft_id) != addr:
            self._peers[raft_id] = addr
            self._active_since.pop(raft_id, None)

    def remove_peer(self, raft_id: int) -> None:
        self._peers.pop(raft_id, None)
        self._active_since.pop(raft_id, None)

    def update_peer(self, raft_id: int, addr: str) -> None:
        self.add_peer(raft_id, addr)

    def peer_ids(self) -> list[int]:
        return list(self._peers)

    # -- send path ---------------------------------------------------------
    def send(self, m: Message) -> None:
        """Non-blocking send (reference: Send transport.go:125)."""
        if self.stopped:
            return
        if self.handlers.is_id_removed(m.to):
            return
        addr = self._peers.get(m.to)
        if addr is None:
            self.handlers.report_unreachable(m.to)
            if m.type == MsgType.SNAP:
                self.handlers.report_snapshot(m.to, False)
            return
        if not self.network.stage(self, m.to, addr, m):
            if m.type == MsgType.SNAP:
                self.handlers.report_snapshot(m.to, False)

    # -- callbacks from the net after the device exchange ------------------
    def peer_delivered(self, raft_id: int, m: Message) -> None:
        self._fail_counts.pop(raft_id, None)
        if raft_id not in self._active_since:
            self._active_since[raft_id] = self.clock.now() or 1e-9
        if m.type == MsgType.SNAP:
            self.handlers.report_snapshot(raft_id, True)

    def peer_failed(self, raft_id: int, m: Message) -> None:
        self._active_since.pop(raft_id, None)
        failures = self._fail_counts.get(raft_id, 0) + 1
        self._fail_counts[raft_id] = failures
        if m.type == MsgType.SNAP:
            self.handlers.report_snapshot(raft_id, False)
        self.handlers.report_unreachable(raft_id, failures)

    # -- views -------------------------------------------------------------
    def longest_active(self) -> Optional[int]:
        best = None
        for rid, since in self._active_since.items():
            if since <= 0:
                continue
            if best is None or since < self._active_since[best]:
                best = rid
        return best

    def active_count(self) -> int:
        return sum(1 for s in self._active_since.values() if s > 0)

    def stop(self) -> None:
        self.stopped = True
        self._peers = {}
        self._active_since = {}
        self._fail_counts = {}
