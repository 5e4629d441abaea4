"""Coalescing proposal pipeline: many store txns per raft round.

The sequential write path (memory.py ``update``) holds the store write
lock from the txn callback through the raft commit, so end-to-end
throughput is capped at one consensus round-trip per store write
(swarm-bench: ~117 proposals/s at p50 7.5 ms on the 3-manager config).
This module adds the classic batching/pipelining lever (arXiv:1905.10786
§4; Multi-Paxos batching in arXiv:2004.05074): concurrent ``update``
calls — and every callback of an explicit ``store.batch()`` block — are
enqueued as FIFO entries, packed into ONE concatenated-actions
``InternalRaftRequest`` (no wire change: the follower's
``apply_store_actions`` already iterates an action list), and committed
by one fused dense-propose device tick.  Per-caller futures resolve when
the entry commits.

Correctness model:

- **FIFO apply order.** Entries are enqueued under the store write lock
  in callback-execution order and applied by ``_commit`` in exactly that
  order; chunks flush serially.
- **Speculative reads.** While entries are queued or in flight, new txn
  callbacks read THROUGH them (``seed`` overlays the pending events onto
  the txn), so a later txn composes on the earlier one instead of
  resurrecting pre-batch state — the same stale-read hazard the
  sequential path's long-held lock prevents.
- **Provisional versions.** Enqueued objects get a provisional
  ``meta.version`` stamp strictly above the committed version, so a
  writer holding a stale pre-batch copy still fails the
  ``ErrSequenceConflict`` check exactly as it would against a committed
  newer version.  ``_commit`` overwrites the stamp with the real raft
  index; a caller that cached a provisional version across the commit
  sees a spurious (safe) conflict and retries.
- **Never double-apply.** Local application happens ONLY inside the
  proposal's commit callback.  If the proposal errors after the entry
  nonetheless commits (timeout race), the raft node's replay path
  (``_wait.trigger`` returning False) applies it — identical to the
  sequential path's semantics; the caller's retry observes the result
  (e.g. create → ErrExist).
- **Unwinding.** On proposal failure (``ErrLostLeadership`` et al.) ALL
  queued entries fail with the same error — their speculative base is
  gone — the overlay is cleared and the epoch bumped; callers re-propose
  via their existing retry paths.

The port's own copy of the JAX package's store/pipeline.py.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field as dc_field
from typing import TYPE_CHECKING, Optional

from swarmkit_tpu_torch.metrics import catalog as obs_catalog

if TYPE_CHECKING:  # pragma: no cover
    from swarmkit_tpu_torch.store.memory import Event, MemoryStore

log = logging.getLogger("swarmkit_tpu_torch.store.cpl")

# Locked two-way to the catalog by metrics_lint check #12.
METRIC_NAMES: dict[str, tuple[str, ...]] = {
    "swarm_cpl_proposals_total": ("outcome",),
    "swarm_cpl_txns_total": ("outcome",),
    "swarm_cpl_batch_entries": (),
    "swarm_cpl_queue_depth": (),
}
SAMPLE_LABELS: dict[str, str] = {"outcome": "committed"}


@dataclass
class CoalesceConfig:
    """Knobs for the coalescing window.

    ``window`` seconds of gathering after the first enqueue before a
    flush (0 = one event-loop pass, which already packs every
    concurrently-submitted txn); ``max_entries`` txns per proposal;
    ``max_bytes`` approximate payload budget per proposal (same
    ``repr``-size heuristic as the per-txn cap, kept at the raft
    ``max_proposal_bytes`` so a packed request never trips
    ``ErrProposalTooLarge``)."""

    window: float = 0.0
    max_entries: int = 256
    max_bytes: float = 1.5 * 1024 * 1024


@dataclass
class _Entry:
    events: list         # the txn's changelist, FIFO
    size: int            # repr-size of the encoded actions
    future: asyncio.Future = dc_field(repr=False, default=None)


class ProposalPipeline:
    """FIFO coalescer in front of ``MemoryStore.propose_in_flight``."""

    def __init__(self, store: "MemoryStore",
                 config: Optional[CoalesceConfig] = None) -> None:
        self._store = store
        self.config = config or CoalesceConfig()
        self._pending: list[_Entry] = []
        self._inflight: list = []      # events of the chunk being proposed
        self._task: Optional[asyncio.Task] = None
        self.epoch = 0                 # bumped on every fail-all unwind
        obs = store.obs
        self._m_proposals = obs_catalog.get(obs, "swarm_cpl_proposals_total")
        self._m_txns = obs_catalog.get(obs, "swarm_cpl_txns_total")
        self._m_entries = obs_catalog.get(obs, "swarm_cpl_batch_entries")
        self._m_depth = obs_catalog.get(obs, "swarm_cpl_queue_depth")

    # -- txn-side API (called under the store write lock) ---------------
    def seed(self, tx) -> None:
        """Overlay in-flight + queued speculative writes onto a new txn,
        FIFO, so its reads compose on the pipeline's tail state."""
        from swarmkit_tpu_torch.store.memory import _REMOVED

        for ev in self._speculative_events():
            tx._overlay[(ev.kind, ev.object.id)] = (
                _REMOVED if ev.action == "remove" else ev.object)

    def _speculative_events(self):
        yield from self._inflight
        for entry in self._pending:
            yield from entry.events

    def _provisional_base(self) -> int:
        base = self._store._local_version
        for ev in self._speculative_events():
            if ev.action != "remove":
                base = max(base, ev.object.meta.version.index)
        return base

    def submit(self, events: list, size: int) -> asyncio.Future:
        """Enqueue a txn's changelist; returns the commit future.  Must
        be called with no intervening await after the txn callback ran
        (single-threaded asyncio keeps the read snapshot valid)."""
        from swarmkit_tpu_torch.api.types import Version

        stamp = self._provisional_base() + 1
        for ev in events:
            if ev.action != "remove":
                ev.object.meta.version = Version(index=stamp)
        entry = _Entry(events=events, size=size,
                       future=asyncio.get_running_loop().create_future())
        self._pending.append(entry)
        self._m_depth.set(len(self._pending))
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="store-cpl-flusher")
        return entry.future

    # -- flusher --------------------------------------------------------
    async def _run(self) -> None:
        try:
            while self._pending:
                if self.config.window > 0 \
                        and len(self._pending) < self.config.max_entries:
                    await asyncio.sleep(self.config.window)
                else:
                    # one event-loop pass: every already-runnable caller
                    # enqueues before we wake
                    await asyncio.sleep(0)
                while self._pending:
                    await self._flush_chunk()
        except asyncio.CancelledError:  # store shutdown
            self._fail_all(asyncio.CancelledError("pipeline stopped"))
            raise
        except Exception:
            log.exception("proposal pipeline flusher died")
            self._fail_all(RuntimeError("proposal pipeline flusher died"))

    def _take_chunk(self) -> list[_Entry]:
        cfg, chunk, size = self.config, [], 0
        while self._pending and len(chunk) < cfg.max_entries:
            nxt = self._pending[0]
            if chunk and size + nxt.size > cfg.max_bytes:
                break
            chunk.append(self._pending.pop(0))
            size += nxt.size
        return chunk

    async def _flush_chunk(self) -> None:
        from swarmkit_tpu_torch.api.raft_msgs import StoreAction
        from swarmkit_tpu_torch.store.memory import _ACTION_KIND

        chunk = self._take_chunk()
        if not chunk:
            return
        events = [ev for e in chunk for ev in e.events]
        actions = [StoreAction.make(_ACTION_KIND[ev.action], ev.object)
                   for ev in events]
        self._inflight = events
        self._m_depth.set(len(self._pending))
        store = self._store

        def on_commit(index: int) -> None:
            store._commit(events, index)

        try:
            await store.propose_in_flight(actions, on_commit)
        except BaseException as err:
            self._inflight = []
            for e in chunk:
                if not e.future.done():
                    e.future.set_exception(err)
                self._m_txns.labels(outcome="failed").inc()
            self._m_proposals.labels(outcome="failed").inc()
            self._fail_all(err)
            return
        self._inflight = []
        self._m_proposals.labels(outcome="committed").inc()
        self._m_entries.observe(len(chunk))
        for e in chunk:
            if not e.future.done():
                e.future.set_result(None)
            self._m_txns.labels(outcome="committed").inc()

    def _fail_all(self, err: BaseException) -> None:
        """Queued entries composed on a base that just failed — fail them
        all; callers re-propose through their normal retry paths."""
        self.epoch += 1
        pending, self._pending = self._pending, []
        self._inflight = []
        for e in pending:
            if not e.future.done():
                e.future.set_exception(err)
            self._m_txns.labels(outcome="failed").inc()
        self._m_depth.set(0)

    # -- lifecycle ------------------------------------------------------
    async def drain(self) -> None:
        """Wait for everything queued right now to commit or fail."""
        futs = [e.future for e in self._pending]
        if futs:
            await asyncio.gather(*futs, return_exceptions=True)

    async def stop(self) -> None:
        await self.drain()
        task, self._task = self._task, None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
