"""MemoryStore: transactional, watchable, raft-replicated object store.

Reference: manager/state/store/memory.go (979 LoC + per-object tables).
Differences from the reference are deliberate TPU-era simplifications:
- tables are Python dicts + maintained secondary-index dicts instead of
  go-memdb radix trees (single-threaded asyncio ⇒ no lock hierarchy);
- the Proposer seam (manager/state/state.go Proposer; mock at
  manager/state/testutils/mock_proposer.go) is an async protocol so the
  leader's ``update`` awaits the raft commit exactly like the reference
  blocks on the wait channel (raft.go:1826-1857).

The port's own copy of the JAX package's store/memory.py, with its
coalescing mode (``set_coalescing``, store/pipeline.py).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Iterable, Optional

from swarmkit_tpu_torch.api.objects import OBJECT_KINDS, kind_of
from swarmkit_tpu_torch.api.raft_msgs import StoreAction, StoreActionKind, StoreSnapshot
from swarmkit_tpu_torch.api.types import Meta, Version
from swarmkit_tpu_torch.store import by as by_mod
from swarmkit_tpu_torch.store.errors import (
    ErrExist, ErrInvalidFindBy, ErrNameConflict, ErrNotExist,
    ErrSequenceConflict, ErrTxTooLarge,
)
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.utils import metrics
from swarmkit_tpu_torch.watch.queue import Queue

log = logging.getLogger("swarmkit_tpu_torch.store")

# reference: manager/state/store/memory.go:45-48
MAX_CHANGES_PER_TRANSACTION = 200
MAX_TRANSACTION_BYTES = 1.5 * 1024 * 1024


# --------------------------------------------------------------------------
# events

@dataclass
class Event:
    action: str          # "create" | "update" | "remove"
    kind: str            # object kind
    object: Any
    old_object: Any = None

    def matches(self, kind: Optional[str] = None, action: Optional[str] = None
                ) -> bool:
        return ((kind is None or self.kind == kind)
                and (action is None or self.action == action))


@dataclass
class EventCommit:
    version: int = 0


def match(kind: Optional[str] = None, action: Optional[str] = None):
    """Watch matcher factory."""

    def _m(ev) -> bool:
        return isinstance(ev, Event) and ev.matches(kind, action)

    return _m


def match_commit(ev) -> bool:
    return isinstance(ev, EventCommit)


# --------------------------------------------------------------------------
# secondary index extraction (replaces storeobject codegen indexers)

def _name_of(obj) -> str:
    ann = getattr(obj, "annotations", None)
    if ann is not None and ann.name:
        return ann.name
    # nodes are findable by hostname (reference: store/nodes.go hostname index)
    desc = getattr(obj, "description", None)
    if desc is not None and desc.hostname:
        return desc.hostname
    return ""


def _task_indexes(t) -> dict[str, list[str]]:
    idx = {
        "service": [t.service_id] if t.service_id else [],
        "node": [t.node_id] if t.node_id else [],
        "slot": [f"{t.service_id}:{t.slot}"] if t.service_id else [],
        "desired_state": [str(int(t.desired_state))],
        "task_state": [str(int(t.status.state))],
    }
    secrets, configs = [], []
    if t.spec.container is not None:
        secrets = [r.secret_id for r in t.spec.container.secrets]
        configs = [r.config_id for r in t.spec.container.configs]
    idx["secret_ref"] = secrets
    idx["config_ref"] = configs
    return idx


def _node_indexes(n) -> dict[str, list[str]]:
    return {
        "role": [str(int(n.role))],
        "membership": [str(int(n.spec.membership))],
    }


_EXTRA_INDEXES: dict[str, Callable] = {
    "task": _task_indexes,
    "node": _node_indexes,
}

# kinds whose name index is unique (tasks are not named-unique)
_UNIQUE_NAME_KINDS = {"node", "service", "network", "cluster", "secret",
                      "config", "extension", "resource"}


class _Table:
    def __init__(self, kind: str) -> None:
        self.kind = kind
        self.objects: dict[str, Any] = {}
        # index name -> key -> set of ids
        self.indexes: dict[str, dict[str, set[str]]] = {}

    def _index_entries(self, obj) -> dict[str, list[str]]:
        entries = {"name": [_name_of(obj)] if _name_of(obj) else []}
        extra = _EXTRA_INDEXES.get(self.kind)
        if extra:
            entries.update(extra(obj))
        return entries

    def _index_add(self, obj) -> None:
        for idx, keys in self._index_entries(obj).items():
            table = self.indexes.setdefault(idx, {})
            for k in keys:
                table.setdefault(k, set()).add(obj.id)

    def _index_remove(self, obj) -> None:
        for idx, keys in self._index_entries(obj).items():
            table = self.indexes.get(idx, {})
            for k in keys:
                ids = table.get(k)
                if ids:
                    ids.discard(obj.id)
                    if not ids:
                        del table[k]

    def put(self, obj) -> None:
        old = self.objects.get(obj.id)
        if old is not None:
            self._index_remove(old)
        self.objects[obj.id] = obj
        self._index_add(obj)

    def remove(self, id: str) -> None:
        old = self.objects.pop(id, None)
        if old is not None:
            self._index_remove(old)

    def lookup(self, index: str, key: str) -> set[str]:
        return self.indexes.get(index, {}).get(key, set())

    def name_owner(self, name: str) -> Optional[str]:
        ids = self.lookup("name", name)
        return next(iter(ids)) if ids else None


# --------------------------------------------------------------------------
# proposer seam

class Proposer:
    """reference: manager/state/state.go Proposer interface."""

    async def propose_value(self, actions: list[StoreAction],
                            apply_cb: Callable[[int], None]) -> None:
        """Replicate ``actions``; call ``apply_cb(applied_index)`` exactly at
        the point the entry commits locally, then return."""
        raise NotImplementedError

    def get_version(self) -> int:
        raise NotImplementedError

    def changes_between(self, frm: int, to: int) -> list[tuple[int, list[StoreAction]]]:
        raise NotImplementedError


class NopProposer(Proposer):
    """Local-only versioning (reference: mock_proposer.go)."""

    def __init__(self) -> None:
        self._version = 0
        self.proposed: list[list[StoreAction]] = []

    async def propose_value(self, actions, apply_cb) -> None:
        self._version += 1
        self.proposed.append(actions)
        apply_cb(self._version)

    def get_version(self) -> int:
        return self._version

    def changes_between(self, frm, to):
        return []


# --------------------------------------------------------------------------
# transactions

_REMOVED = object()


class ReadTx:
    def __init__(self, store: "MemoryStore") -> None:
        self._store = store

    def get(self, kind: str, id: str):
        obj = self._store._tables[kind].objects.get(id)
        return obj.copy() if obj is not None else None

    def find(self, kind: str, by=by_mod.All()) -> list:
        ids = self._store._resolve(kind, by)
        table = self._store._tables[kind].objects
        return [table[i].copy() for i in sorted(ids) if i in table]


class Tx(ReadTx):
    """Write transaction: buffered overlay + changelist."""

    def __init__(self, store: "MemoryStore") -> None:
        super().__init__(store)
        self._overlay: dict[tuple[str, str], Any] = {}
        self.changelist: list[Event] = []
        self._now = store._now()

    # -- reads see uncommitted writes ----------------------------------
    def get(self, kind: str, id: str):
        ov = self._overlay.get((kind, id))
        if ov is _REMOVED:
            return None
        if ov is not None:
            return ov.copy()
        return super().get(kind, id)

    def find(self, kind: str, by=by_mod.All()) -> list:
        base_ids = set(self._store._resolve(kind, by))
        out = {}
        table = self._store._tables[kind].objects
        for i in base_ids:
            if (kind, i) not in self._overlay and i in table:
                out[i] = table[i].copy()
        for (k, i), obj in self._overlay.items():
            if k != kind or obj is _REMOVED:
                continue
            if _match_object(by, kind, obj):
                out[i] = obj.copy()
        return [out[i] for i in sorted(out)]

    # -- writes ---------------------------------------------------------
    def _lookup_current(self, kind: str, id: str):
        ov = self._overlay.get((kind, id))
        if ov is _REMOVED:
            return None
        if ov is not None:
            return ov
        return self._store._tables[kind].objects.get(id)

    def _check_name(self, kind: str, obj) -> None:
        if kind not in _UNIQUE_NAME_KINDS:
            return
        name = _name_of(obj)
        if not name:
            return
        owner = self._store._tables[kind].name_owner(name)
        if owner is not None and owner != obj.id \
                and self._overlay.get((kind, owner)) is not _REMOVED:
            raise ErrNameConflict(f"name {name!r} is in use by {kind} {owner}")
        for (k, i), other in self._overlay.items():
            if k == kind and i != obj.id and other is not _REMOVED \
                    and _name_of(other) == name:
                raise ErrNameConflict(f"name {name!r} is in use by {kind} {i}")

    def create(self, obj) -> None:
        kind = kind_of(obj)
        if self._lookup_current(kind, obj.id) is not None:
            raise ErrExist(f"{kind} {obj.id} already exists")
        self._check_name(kind, obj)
        obj = obj.copy()
        obj.meta.created_at = obj.meta.updated_at = self._now
        self._overlay[(kind, obj.id)] = obj
        self.changelist.append(Event("create", kind, obj))

    def update(self, obj) -> None:
        kind = kind_of(obj)
        current = self._lookup_current(kind, obj.id)
        if current is None:
            raise ErrNotExist(f"{kind} {obj.id} does not exist")
        # reference memory.go:582-585 sequence conflict check
        if obj.meta.version.index != current.meta.version.index:
            raise ErrSequenceConflict(
                f"{kind} {obj.id}: update at version "
                f"{obj.meta.version.index}, stored {current.meta.version.index}")
        self._check_name(kind, obj)
        obj = obj.copy()
        obj.meta.created_at = current.meta.created_at
        obj.meta.updated_at = self._now
        old = current.copy()
        self._overlay[(kind, obj.id)] = obj
        self.changelist.append(Event("update", kind, obj, old))

    def delete(self, kind: str, id: str) -> None:
        current = self._lookup_current(kind, id)
        if current is None:
            raise ErrNotExist(f"{kind} {id} does not exist")
        self._overlay[(kind, id)] = _REMOVED
        self.changelist.append(Event("remove", kind, current.copy()))


def _match_object(by, kind: str, obj) -> bool:
    """Evaluate a By directly against an object (overlay reads)."""
    if isinstance(by, by_mod.All):
        return True
    if isinstance(by, by_mod.Or):
        return any(_match_object(b, kind, obj) for b in by.bys)
    if isinstance(by, by_mod.ByID):
        return obj.id == by.id
    if isinstance(by, by_mod.ByIDPrefix):
        return obj.id.startswith(by.prefix)
    if isinstance(by, by_mod.ByName):
        return _name_of(obj) == by.name
    if isinstance(by, by_mod.ByNamePrefix):
        return _name_of(obj).startswith(by.prefix)
    if isinstance(by, by_mod.Custom):
        return by.predicate(obj)
    extra = _EXTRA_INDEXES.get(kind)
    entries = extra(obj) if extra else {}
    if isinstance(by, by_mod.ByService):
        return by.service_id in entries.get("service", [])
    if isinstance(by, by_mod.ByNode):
        return by.node_id in entries.get("node", [])
    if isinstance(by, by_mod.BySlot):
        return f"{by.service_id}:{by.slot}" in entries.get("slot", [])
    if isinstance(by, by_mod.ByDesiredState):
        return str(int(by.state)) in entries.get("desired_state", [])
    if isinstance(by, by_mod.ByTaskState):
        return str(int(by.state)) in entries.get("task_state", [])
    if isinstance(by, by_mod.ByRole):
        return str(int(by.role)) in entries.get("role", [])
    if isinstance(by, by_mod.ByMembership):
        return str(int(by.membership)) in entries.get("membership", [])
    if isinstance(by, by_mod.ByReferencedSecret):
        return by.secret_id in entries.get("secret_ref", [])
    if isinstance(by, by_mod.ByReferencedConfig):
        return by.config_id in entries.get("config_ref", [])
    raise ErrInvalidFindBy(f"unsupported By {type(by).__name__} for {kind}")


# --------------------------------------------------------------------------
# the store

class MemoryStore:
    # reference: WedgeTimeout memory.go:79 (30s there). Here it must sit
    # BELOW the default proposal timeout (node.py propose_value timeout=30):
    # the stuck write is popped from _in_flight when its proposal times out,
    # so the watchdog can only observe the stall while the await is pending.
    WEDGE_TIMEOUT = 15.0

    def __init__(self, proposer: Optional[Proposer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics_registry=None, obs=None) -> None:
        self._tables: dict[str, _Table] = {k: _Table(k) for k in OBJECT_KINDS}
        self._proposer = proposer
        self._clock = clock or time.time
        self.queue = Queue()
        self._local_version = 0
        # bumped by restore(): bulk rebuilds publish no per-object events,
        # so incremental consumers (metrics collector) resync when they
        # see the generation move
        self.restore_generation = 0
        self._in_flight: dict[int, float] = {}  # update id -> start time
        self._in_flight_seq = 0
        # Serializes write transactions ACROSS the proposal round-trip
        # (reference: memstore's updateLock is held through proposeValue —
        # the very lock timedMutex/Wedged() watches).  Without it, a txn
        # whose callback read state at version v can commit after a
        # concurrent writer's v+1 and silently resurrect fields its stale
        # full-object copy carried (observed: a dispatcher status write
        # undoing a just-committed node demotion).
        self._write_lock = asyncio.Lock()
        self.metrics = metrics_registry or metrics.REGISTRY
        self.obs = obs or obs_registry.DEFAULT
        self._m_commits = obs_catalog.get(self.obs,
                                          "swarm_store_commits_total")
        # Coalescing proposal pipeline (store/pipeline.py), switched on by
        # set_coalescing(): None = the sequential one-round-trip-per-write
        # path.
        self._pipeline = None

    # -- coalescing mode -------------------------------------------------
    def set_coalescing(self, config) -> None:
        """Enable the batched proposal pipeline (store/pipeline.py).
        ``config`` is a CoalesceConfig (or True for defaults)."""
        from swarmkit_tpu_torch.store.pipeline import CoalesceConfig, ProposalPipeline
        if config is True:
            config = CoalesceConfig()
        self._pipeline = ProposalPipeline(self, config)

    async def stop_coalescing(self) -> None:
        """Drain the pipeline and fall back to the sequential path."""
        pipeline, self._pipeline = self._pipeline, None
        if pipeline is not None:
            await pipeline.stop()

    def coalescing(self) -> bool:
        return self._pipeline is not None and self._proposer is not None

    def _timed(self, name: str):
        return metrics.timed(name, registry=self.metrics)

    async def propose_in_flight(self, actions, cb) -> None:
        """Propose with wedge bookkeeping — ALL write paths (update and
        Batch flushes) must go through here so a stalled proposal marks the
        store wedged (reference: timedMutex covers every store write)."""
        self._in_flight_seq += 1
        fid = self._in_flight_seq
        self._in_flight[fid] = self._now()
        try:
            await self._proposer.propose_value(actions, cb)
        finally:
            self._in_flight.pop(fid, None)

    def _now(self) -> float:
        return self._clock()

    def set_proposer(self, proposer: Optional[Proposer]) -> None:
        self._proposer = proposer

    # -- reads -----------------------------------------------------------
    def read_tx(self) -> ReadTx:
        return ReadTx(self)

    def view(self, cb: Callable[[ReadTx], Any]) -> Any:
        with self._timed(metrics.STORE_READ_TX_LATENCY):
            self._m_commits.labels(kind="read").inc()
            return cb(ReadTx(self))

    def get(self, kind: str, id: str):
        return ReadTx(self).get(kind, id)

    def find(self, kind: str, by=by_mod.All()) -> list:
        return ReadTx(self).find(kind, by)

    def _resolve(self, kind: str, by) -> set[str]:
        t = self._tables[kind]
        if isinstance(by, by_mod.All):
            return set(t.objects.keys())
        if isinstance(by, by_mod.Or):
            out: set[str] = set()
            for b in by.bys:
                out |= self._resolve(kind, b)
            return out
        if isinstance(by, by_mod.ByID):
            return {by.id} if by.id in t.objects else set()
        if isinstance(by, by_mod.ByIDPrefix):
            return {i for i in t.objects if i.startswith(by.prefix)}
        if isinstance(by, by_mod.ByName):
            return set(t.lookup("name", by.name))
        if isinstance(by, by_mod.ByNamePrefix):
            return {i for ids in (v for k, v in t.indexes.get("name", {}).items()
                                  if k.startswith(by.prefix)) for i in ids}
        if isinstance(by, by_mod.ByService):
            return set(t.lookup("service", by.service_id))
        if isinstance(by, by_mod.ByNode):
            return set(t.lookup("node", by.node_id))
        if isinstance(by, by_mod.BySlot):
            return set(t.lookup("slot", f"{by.service_id}:{by.slot}"))
        if isinstance(by, by_mod.ByDesiredState):
            return set(t.lookup("desired_state", str(int(by.state))))
        if isinstance(by, by_mod.ByTaskState):
            return set(t.lookup("task_state", str(int(by.state))))
        if isinstance(by, by_mod.ByRole):
            return set(t.lookup("role", str(int(by.role))))
        if isinstance(by, by_mod.ByMembership):
            return set(t.lookup("membership", str(int(by.membership))))
        if isinstance(by, by_mod.ByReferencedSecret):
            return set(t.lookup("secret_ref", by.secret_id))
        if isinstance(by, by_mod.ByReferencedConfig):
            return set(t.lookup("config_ref", by.config_id))
        if isinstance(by, by_mod.Custom):
            return {i for i, o in t.objects.items() if by.predicate(o)}
        raise ErrInvalidFindBy(f"unsupported By: {type(by).__name__}")

    # -- writes ----------------------------------------------------------
    async def update(self, cb: Callable[[Tx], Any]) -> Any:
        """Run a write transaction; replicate via the proposer (if any) and
        apply + publish on commit (reference memory.go:319-377).  The write
        lock is held from callback through commit so the callback's reads
        stay valid until the txn lands.

        In coalescing mode (``set_coalescing``) the lock covers only the
        synchronous callback + enqueue; the commit is awaited OUTSIDE the
        lock so concurrent writers pack into one raft proposal.  The
        pipeline's speculative overlay (seeded into each new txn) plays
        the lock's stale-read-prevention role across the await."""
        async with self._write_lock:
            tx = Tx(self)
            if self.coalescing():
                self._pipeline.seed(tx)
            result = cb(tx)
            if not tx.changelist:
                return result
            if len(tx.changelist) > MAX_CHANGES_PER_TRANSACTION:
                raise ErrTxTooLarge(
                    f"{len(tx.changelist)} changes > "
                    f"{MAX_CHANGES_PER_TRANSACTION}")
            actions = [StoreAction.make(_ACTION_KIND[ev.action], ev.object)
                       for ev in tx.changelist]
            size = sum(len(repr(a.target)) for a in actions)
            if size > MAX_TRANSACTION_BYTES:
                raise ErrTxTooLarge(f"transaction weighs ~{size} bytes")

            if self.coalescing():
                fut = self._pipeline.submit(tx.changelist, size)
            else:
                with self._timed(metrics.STORE_WRITE_TX_LATENCY):
                    if self._proposer is not None:
                        await self.propose_in_flight(
                            actions,
                            lambda index: self._commit(tx.changelist, index))
                    else:
                        self._local_version += 1
                        self._commit(tx.changelist, self._local_version)
                self._m_commits.labels(kind="write").inc()
                return result

        # coalescing: await the packed commit OUTSIDE the write lock
        with self._timed(metrics.STORE_WRITE_TX_LATENCY):
            await fut
        self._m_commits.labels(kind="write").inc()
        return result

    def wedged(self) -> bool:
        """True when any write has been stuck in flight longer than
        WEDGE_TIMEOUT (reference: timedMutex + Wedged() memory.go:117-144,
        :972 — there it is a mutex held too long; in the asyncio build the
        analogous stall is a proposal that never commits)."""
        if not self._in_flight:
            return False
        now = self._now()
        return any(now - t0 > self.WEDGE_TIMEOUT
                   for t0 in self._in_flight.values())

    def _commit(self, changelist: list[Event], version: int) -> None:
        for ev in changelist:
            ev.object.meta.version = Version(index=version)
            table = self._tables[ev.kind]
            if ev.action == "remove":
                table.remove(ev.object.id)
            else:
                table.put(ev.object.copy())
        self._local_version = max(self._local_version, version)
        for ev in changelist:
            self.queue.publish(ev)
        self.queue.publish(EventCommit(version=version))

    def apply_store_actions(self, actions: list[StoreAction], version: int
                            ) -> None:
        """Follower/replay path (reference memory.go:278 ApplyStoreActions)."""
        changelist = []
        now = self._now()
        for a in actions:
            obj = a.object()
            if a.action == StoreActionKind.CREATE:
                obj.meta.created_at = obj.meta.updated_at = now
                changelist.append(Event("create", a.kind, obj))
            elif a.action == StoreActionKind.UPDATE:
                old = self._tables[a.kind].objects.get(obj.id)
                obj.meta.updated_at = now
                changelist.append(Event("update", a.kind, obj,
                                        old.copy() if old else None))
            elif a.action == StoreActionKind.REMOVE:
                changelist.append(Event("remove", a.kind, obj))
        self._commit(changelist, version)

    def batch(self) -> "Batch":
        return Batch(self)

    # -- watch -----------------------------------------------------------
    def watch(self, *matchers, limit: int = 0):
        return self.queue.watch(*matchers, limit=limit)

    def view_and_watch(self, cb: Callable[[ReadTx], Any], *matchers):
        """Atomic snapshot + subscription (reference memory.go:840).
        Safe because we never await between the view and the watch."""
        watcher = self.queue.watch(*matchers)
        result = cb(ReadTx(self))
        return result, watcher

    # -- snapshot --------------------------------------------------------
    def save(self) -> StoreSnapshot:
        return StoreSnapshot(objects={
            kind: [o.to_dict() for _, o in sorted(t.objects.items())]
            for kind, t in self._tables.items()})

    def restore(self, snap: StoreSnapshot, version: int = 0) -> None:
        self._tables = {k: _Table(k) for k in OBJECT_KINDS}
        for kind, objs in snap.objects.items():
            cls = OBJECT_KINDS[kind]
            for data in objs:
                self._tables[kind].put(cls.from_dict(data))
        self._local_version = max(self._local_version, version)
        self.restore_generation += 1

    @property
    def version(self) -> int:
        if self._proposer is not None:
            return self._proposer.get_version()
        return self._local_version


_ACTION_KIND = {
    "create": StoreActionKind.CREATE,
    "update": StoreActionKind.UPDATE,
    "remove": StoreActionKind.REMOVE,
}


class Batch:
    """Split many small updates into bounded transactions
    (reference memory.go:497 Batch; MaxChangesPerTransaction splitting)."""

    def __init__(self, store: MemoryStore) -> None:
        self._store = store
        self._pending: list[Event] = []
        self.applied = 0
        self._holds_lock = False
        # coalescing mode: commit futures of entries already enqueued on
        # the pipeline (each callback becomes one FIFO entry, packed with
        # every other concurrent writer into one raft proposal)
        self._futures: list[tuple[asyncio.Future, int]] = []

    async def _acquire_segment(self) -> None:
        # The write lock is held from a segment's FIRST callback until that
        # segment flushes (reference: Batch keeps the store's updateLock
        # across each MaxChangesPerTransaction sub-batch), so no foreign
        # commit can invalidate what the callbacks read.
        if not self._holds_lock:
            await self._store._write_lock.acquire()
            self._holds_lock = True

    def _release_segment(self) -> None:
        if self._holds_lock:
            self._holds_lock = False
            self._store._write_lock.release()

    async def update(self, cb: Callable[[Tx], Any]) -> Any:
        if self._store.coalescing():
            return await self._update_coalescing(cb)
        await self._acquire_segment()
        try:
            tx = Tx(self._store)
            # seed overlay with pending (batched txs see each other's writes)
            for ev in self._pending:
                key = (ev.kind, ev.object.id)
                tx._overlay[key] = (_REMOVED if ev.action == "remove"
                                    else ev.object)
            base = len(tx.changelist)
            result = cb(tx)
            self._pending.extend(tx.changelist[base:])
        except BaseException:
            # A failed callback must not leave the store-wide lock held by
            # an abandoned batch (most call sites don't commit() in a
            # finally).  Earlier callbacks' changes are complete txns, so
            # flush them — which also releases the lock — then re-raise
            # the CALLBACK's exception; callers that catch per-callback
            # errors and continue (dispatcher, scheduler) must see the
            # error type they expect, so a flush failure here is logged,
            # never allowed to replace it.
            try:
                while self._pending:
                    await self._flush()
            except Exception:
                log.exception("batch flush failed while unwinding a "
                              "callback error")
                self._pending.clear()
            finally:
                self._release_segment()
            raise
        if len(self._pending) >= MAX_CHANGES_PER_TRANSACTION:
            await self._flush()
        return result

    async def _update_coalescing(self, cb: Callable[[Tx], Any]) -> Any:
        """Coalescing-mode callback: enqueue this callback's changes as
        pipeline entries (visible to every later txn via the speculative
        overlay — no segment lock held across awaits) and remember the
        commit futures for ``commit()``."""
        store = self._store
        async with store._write_lock:
            tx = Tx(store)
            store._pipeline.seed(tx)
            result = cb(tx)
            events = tx.changelist
            # split oversized callbacks at the same per-txn boundary the
            # sequential path uses
            for i in range(0, len(events), MAX_CHANGES_PER_TRANSACTION):
                chunk = events[i:i + MAX_CHANGES_PER_TRANSACTION]
                size = sum(len(repr(StoreAction.make(
                    _ACTION_KIND[ev.action], ev.object).target))
                    for ev in chunk)
                if size > MAX_TRANSACTION_BYTES:
                    raise ErrTxTooLarge(f"transaction weighs ~{size} bytes")
                self._futures.append(
                    (store._pipeline.submit(chunk, size), len(chunk)))
        return result

    async def _flush(self) -> None:
        try:
            if self._pending:
                await self._acquire_segment()  # no-op when already held
                with self._store._timed(metrics.STORE_BATCH_LATENCY):
                    await self._flush_timed()
        except BaseException:
            self._release_segment()
            raise
        # Keep the lock while changes built under it are still queued
        # (one callback can add >1 chunk); release only once drained, or
        # foreign commits could interleave with the stale remainder.
        if not self._pending:
            self._release_segment()

    async def _flush_timed(self) -> None:
        chunk, self._pending = (
            self._pending[:MAX_CHANGES_PER_TRANSACTION],
            self._pending[MAX_CHANGES_PER_TRANSACTION:])
        store = self._store
        actions = [StoreAction.make(_ACTION_KIND[ev.action], ev.object)
                   for ev in chunk]
        if store._proposer is not None:
            await store.propose_in_flight(
                actions, lambda index: store._commit(chunk, index))
        else:
            store._local_version += 1
            store._commit(chunk, store._local_version)
        self.applied += len(chunk)

    async def commit(self) -> int:
        if self._futures:
            # coalescing mode: wait for every enqueued entry; surface the
            # first failure (callers' retry paths handle it) after all
            # settled so no future is left un-awaited
            futures, self._futures = self._futures, []
            results = await asyncio.gather(
                *(f for f, _ in futures), return_exceptions=True)
            first_err = None
            for (_, n), res in zip(futures, results):
                if isinstance(res, BaseException):
                    first_err = first_err or res
                else:
                    self.applied += n
            self._store._m_commits.labels(kind="batch").inc()
            if first_err is not None:
                raise first_err
            return self.applied
        try:
            while self._pending:
                await self._flush()
        finally:
            self._release_segment()
        self._store._m_commits.labels(kind="batch").inc()
        return self.applied
