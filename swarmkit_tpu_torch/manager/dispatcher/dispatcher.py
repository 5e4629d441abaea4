"""The manager↔agent boundary: registration, sessions, heartbeats,
assignment fan-out and batched status write-back.

Reference: manager/dispatcher/dispatcher.go (1948 LoC).  Behaviors kept:
- ``register`` requires the node object to already exist (node records are
  created at CA join / by the control plane), rate-limits re-registrations,
  marks the node READY with its observed address (register :542,
  markNodeReady), and arms a heartbeat-TTL that marks the node DOWN on
  expiry (markNodeNotReady).
- ``session`` streams SessionMessages (node, weighted manager list, network
  bootstrap keys, root CA) and re-sends when any of those change
  (Session :1219).
- ``heartbeat`` resets the TTL and returns the next period, 5 s ± 0.5 s with
  ×3 grace (Heartbeat :1177, constants :31-34).
- ``assignments`` sends one COMPLETE snapshot then INCREMENTAL diffs,
  batched 100 ms after the most recent change or 100 modifications,
  whichever first (Assignments :917, batchingWaitTime/modificationBatchLimit
  :45-48).
- ``update_task_status`` validates ownership, dedups by task id and batch
  writes via the store (UpdateTaskStatus :596, processUpdates :670,
  maxBatchItems :38); state regressions are dropped.
- leader start marks every READY node UNKNOWN until it re-registers
  (markNodesUnknown :410); nodes DOWN for 24 h get their tasks ORPHANED
  (defaultNodeDownPeriod :50-53, moveTasksToOrphaned :1065).

The port's own copy of the JAX package's manager/dispatcher/dispatcher.py.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import AsyncIterator, Callable, Optional

from swarmkit_tpu_torch.api import (
    Node, NodeState, TaskState, TaskStatus, WeightedPeer,
)
from swarmkit_tpu_torch.api.dispatcher_msgs import (
    AssignmentsMessage, AssignmentsType, HeartbeatResponse, SessionMessage,
)
from swarmkit_tpu_torch.manager.dispatcher.assignments import AssignmentSet
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.metrics import trace as obs_trace
from swarmkit_tpu_torch.manager.dispatcher.nodes import (
    ErrNodeNotRegistered, ErrSessionInvalid, NodeStore,
)
from swarmkit_tpu_torch.store.by import ByNode
from swarmkit_tpu_torch.store.memory import MemoryStore, match
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.dispatcher")

# reference: dispatcher.go:36-53
MAX_BATCH_ITEMS = 10000
BATCHING_WAIT_TIME = 0.100
MODIFICATION_BATCH_LIMIT = 100
DEFAULT_NODE_DOWN_PERIOD = 24 * 3600.0


class ErrNodeNotFound(Exception):
    """The node has no record in the cluster store."""


class DispatcherConfigDefaults:
    heartbeat_period = 5.0
    heartbeat_epsilon = 0.5
    grace_period_multiplier = 3
    rate_limit_period = 8.0


class Dispatcher:
    def __init__(self, store: MemoryStore,
                 managers_fn: Optional[Callable[[], list[WeightedPeer]]] = None,
                 clock: Optional[Clock] = None,
                 peers_queue=None,
                 rng: Optional[random.Random] = None,
                 drivers=None,
                 obs: Optional[obs_registry.MetricsRegistry] = None) -> None:
        self.store = store
        self.drivers = drivers
        self.clock = clock or SystemClock()
        self.obs = obs or obs_registry.DEFAULT
        self._m_sessions = obs_catalog.get(
            self.obs, "swarm_dispatcher_sessions_total")
        self._m_heartbeats = obs_catalog.get(
            self.obs, "swarm_dispatcher_heartbeats_total")
        self._m_hb_rtt = obs_catalog.get(
            self.obs, "swarm_dispatcher_heartbeat_rtt_seconds")
        self._m_task_updates = obs_catalog.get(
            self.obs, "swarm_dispatcher_task_updates_total")
        self.managers_fn = managers_fn or (lambda: [])
        # raft membership broadcast (membership.Cluster.broadcast /
        # PeersBroadcast cluster.go:38): wakes session streams so agents
        # learn manager-list changes that write no store object
        self.peers_queue = peers_queue
        self.nodes = NodeStore(self.clock, rng=rng)
        # node_id -> timer task orphaning its tasks after 24 h down
        self._down_nodes: dict[str, asyncio.Task] = {}
        self._task_updates: dict[str, TaskStatus] = {}
        self._updates_ready = asyncio.Event()
        self._running = False
        self._process_task: Optional[asyncio.Task] = None
        self._bg: list[asyncio.Task] = []

    # ------------------------------------------------------------------
    async def start(self, mark_unknown: bool = True) -> None:
        self._running = True
        if mark_unknown:
            await self._mark_nodes_unknown()
        # watch-BEFORE-read so no committed update can fall between the
        # initial config read and the subscription (an update seen by
        # both is harmless: _apply_cluster_config is idempotent); kept on
        # self so stop() can close it even if the task never scheduled
        self._cfg_watcher = self.store.watch(
            match(kind="cluster", action="update"))
        self._apply_cluster_config()
        self._process_task = asyncio.get_running_loop().create_task(
            self._process_updates_loop())
        self._bg.append(asyncio.get_running_loop().create_task(
            self._watch_cluster_config(self._cfg_watcher)))

    def _apply_cluster_config(self) -> None:
        """Adopt DispatcherConfig from the replicated cluster spec
        (reference: dispatcher.go:242-244 initial read)."""
        clusters = self.store.find("cluster")
        if not clusters:
            return
        period = clusters[0].spec.dispatcher.heartbeat_period
        if period > 0 and period != self.nodes.period:
            log.info("dispatcher heartbeat period -> %.2fs", period)
            self.nodes.period = period

    async def _watch_cluster_config(self, watcher) -> None:
        """Re-read DispatcherConfig on cluster updates (reference:
        dispatcher.go:310-315 — heartbeat period changes apply to every
        subsequent heartbeat RPC's returned period)."""
        try:
            async for _ in watcher:
                self._apply_cluster_config()
        except asyncio.CancelledError:
            pass
        finally:
            watcher.close()

    async def stop(self) -> None:
        self._running = False
        self.nodes.delete_all()
        for t in list(self._down_nodes.values()) + self._bg:
            t.cancel()
        self._down_nodes.clear()
        self._bg.clear()
        if getattr(self, "_cfg_watcher", None) is not None:
            self._cfg_watcher.close()
            self._cfg_watcher = None
        if self._process_task is not None:
            self._updates_ready.set()
            self._process_task.cancel()
            try:
                await self._process_task
            except (asyncio.CancelledError, Exception):
                pass
            self._process_task = None

    def _check_running(self) -> None:
        if not self._running:
            raise RuntimeError("dispatcher is stopped")

    # ------------------------------------------------------------------
    async def _mark_nodes_unknown(self) -> None:
        """Reference: markNodesUnknown dispatcher.go:410."""
        nodes = self.store.find("node")
        batch = self.store.batch()
        for n in nodes:
            def cb(tx, nid=n.id):
                node = tx.get("node", nid)
                if node is None:
                    return
                if node.status.state == NodeState.DOWN:
                    self._arm_down_node(nid)
                    return
                node = node.copy()
                node.status.state = NodeState.UNKNOWN
                node.status.message = ("Node moved to \"unknown\" state due to"
                                       " leadership change in cluster")
                tx.update(node)
                self.nodes.add(nid, None, "", self._heartbeat_expired)
            await batch.update(cb)
        await batch.commit()

    def _heartbeat_expired(self, node_id: str) -> None:
        log.info("heartbeat expiration for node %s", node_id)
        t = asyncio.get_running_loop().create_task(
            self._mark_node_not_ready(node_id, NodeState.DOWN,
                                      "heartbeat failure"))
        self._bg.append(t)
        self._bg[:] = [b for b in self._bg if not b.done()]

    async def _mark_node_not_ready(self, node_id: str, state: NodeState,
                                   message: str) -> None:
        """Reference: markNodeNotReady — store write + down-node tracking."""
        self.nodes.delete(node_id)

        def cb(tx):
            node = tx.get("node", node_id)
            if node is None:
                return
            node = node.copy()
            node.status.state = state
            node.status.message = message
            tx.update(node)

        try:
            await self.store.update(cb)
        except Exception:
            log.exception("failed to mark node %s not ready", node_id)
            return
        if state == NodeState.DOWN:
            self._arm_down_node(node_id)

    def _arm_down_node(self, node_id: str) -> None:
        """Orphan the node's tasks after 24 h down (dispatcher.go:50-53)."""
        if node_id in self._down_nodes:
            return

        async def orphan_later():
            try:
                await self.clock.sleep(DEFAULT_NODE_DOWN_PERIOD)
                await self.move_tasks_to_orphaned(node_id)
            except asyncio.CancelledError:
                pass
            finally:
                self._down_nodes.pop(node_id, None)

        self._down_nodes[node_id] = asyncio.get_running_loop().create_task(
            orphan_later())

    async def move_tasks_to_orphaned(self, node_id: str) -> None:
        """Reference: moveTasksToOrphaned dispatcher.go:1065."""
        tasks = self.store.find("task", ByNode(node_id))
        batch = self.store.batch()
        for t in tasks:
            if not (TaskState.ASSIGNED <= t.status.state <= TaskState.RUNNING):
                continue

            def cb(tx, tid=t.id):
                task = tx.get("task", tid)
                if task is None:
                    return
                task = task.copy()
                task.status.state = TaskState.ORPHANED
                tx.update(task)
            await batch.update(cb)
        await batch.commit()

    # ------------------------------------------------------------------
    async def register(self, node_id: str, description=None, addr: str = ""
                       ) -> str:
        """Reference: register dispatcher.go:542. Returns the session ID."""
        self._check_running()
        if self.nodes.check_rate_limit(node_id):
            raise RuntimeError(f"node {node_id} exceeded rate limit")
        node = self.store.get("node", node_id)
        if node is None:
            raise ErrNodeNotFound(node_id)
        await self._mark_node_ready(node_id, description, addr)
        rn = self.nodes.add(node_id, description, addr,
                            self._heartbeat_expired)
        self._m_sessions.inc()
        return rn.session_id

    async def _mark_node_ready(self, node_id: str, description, addr: str
                               ) -> None:
        # cancel any pending orphaning
        t = self._down_nodes.pop(node_id, None)
        if t is not None:
            t.cancel()

        def cb(tx):
            node = tx.get("node", node_id)
            if node is None:
                raise ErrNodeNotFound(node_id)
            node = node.copy()
            node.status.state = NodeState.READY
            node.status.message = ""
            node.status.addr = addr
            if description is not None:
                node.description = description
            tx.update(node)

        await self.store.update(cb)

    # ------------------------------------------------------------------
    async def heartbeat(self, node_id: str, session_id: str
                        ) -> HeartbeatResponse:
        self._check_running()
        with self._m_hb_rtt.time():
            try:
                period = self.nodes.heartbeat(node_id, session_id)
            except Exception:
                self._m_heartbeats.labels(result="invalid").inc()
                raise
        self._m_heartbeats.labels(result="ok").inc()
        return HeartbeatResponse(period=period)

    async def update_task_status(self, node_id: str, session_id: str,
                                 updates: list[tuple[str, TaskStatus]]
                                 ) -> None:
        """Reference: UpdateTaskStatus dispatcher.go:596."""
        self._check_running()
        self.nodes.get_with_session(node_id, session_id)
        # validate the whole batch before enqueuing anything, so a bad
        # entry can't strand earlier valid updates unflushed
        # (reference: validTaskUpdates collected first, dispatcher.go:624)
        valid = []
        for task_id, status in updates:
            t = self.store.get("task", task_id)
            if t is None:
                continue  # task may have been deleted
            if t.node_id != node_id:
                raise PermissionError(
                    "cannot update a task not assigned this node")
            valid.append((task_id, status))
        if valid:
            self._m_task_updates.inc(len(valid))
        for task_id, status in valid:
            self._task_updates[task_id] = status
        if self._task_updates:
            self._updates_ready.set()

    async def _process_updates_loop(self) -> None:
        try:
            while self._running:
                await self._updates_ready.wait()
                self._updates_ready.clear()
                await self._process_updates()
        except asyncio.CancelledError:
            pass

    async def _process_updates(self) -> None:
        """Reference: processUpdates dispatcher.go:670."""
        if not self._task_updates:
            return
        updates, self._task_updates = self._task_updates, {}
        batch = self.store.batch()
        for task_id, status in updates.items():
            def cb(tx, tid=task_id, st=status):
                task = tx.get("task", tid)
                if task is None:
                    return
                if task.status.state > st.state:
                    return  # invalid (backward) transition — drop
                if task.status.to_dict() == st.to_dict():
                    return
                task = task.copy()
                task.status = st.copy()
                tx.update(task)
            try:
                await batch.update(cb)
            except Exception:
                log.exception("dispatcher task update transaction failed")
        await batch.commit()

    # ------------------------------------------------------------------
    def _session_message(self, node_id: str, session_id: str
                         ) -> Optional[SessionMessage]:
        node = self.store.get("node", node_id)
        if node is None:
            return None
        clusters = self.store.find("cluster")
        keys, root_ca = [], b""
        if clusters:
            keys = list(clusters[0].network_bootstrap_keys)
            root_ca = clusters[0].root_ca.ca_cert
        return SessionMessage(session_id=session_id, node=node,
                              managers=self.managers_fn(),
                              network_bootstrap_keys=keys, root_ca=root_ca)

    async def session(self, node_id: str, description=None,
                      session_id: str = "", addr: str = "",
                      parent_span: str = ""
                      ) -> AsyncIterator[SessionMessage]:
        """Reference: Session dispatcher.go:1219.  Registers (unless resuming
        an existing session) and streams SessionMessages until the session is
        superseded or expires.

        `parent_span` carries the caller's span id across the gRPC wire
        (rpc.py packs it) so the trace reparents instead of rooting a
        fresh tree in the serving process.
        """
        self._check_running()
        with obs_trace.DEFAULT.span("dispatcher.session", node=node_id,
                                    parent_id=parent_span or None,
                                    resumed=bool(session_id)) as sp:
            if not session_id:
                session_id = await self.register(node_id, description, addr)
            rn = self.nodes.get_with_session(node_id, session_id)
            sp.set(session=session_id)

        watcher = self.store.watch(match(kind="node"), match(kind="cluster"))
        peers_w = (self.peers_queue.watch()
                   if self.peers_queue is not None else None)
        # persistent waiters: only a consumed future is re-created, so an
        # event completing in a round won by another waiter is never lost
        get_ev = asyncio.ensure_future(watcher.get())
        disc = asyncio.ensure_future(rn.disconnect.wait())
        peers_ev = (asyncio.ensure_future(peers_w.get())
                    if peers_w is not None else None)

        def reap():
            _cancel_quietly(get_ev, disc,
                            *((peers_ev,) if peers_ev is not None else ()))
        try:
            msg = self._session_message(node_id, session_id)
            if msg is not None:
                yield msg
            last = msg
            while self._running and not rn.disconnect.is_set():
                waiters = {get_ev, disc}
                if peers_ev is not None:
                    waiters.add(peers_ev)
                try:
                    done, _ = await asyncio.wait(
                        waiters, return_when=asyncio.FIRST_COMPLETED)
                except BaseException:
                    # generator closed/cancelled mid-wait: reap the waiters
                    reap()
                    raise
                if disc in done:
                    break
                relevant = False
                if get_ev in done:
                    ev = get_ev.result()
                    get_ev = asyncio.ensure_future(watcher.get())
                    if not (ev.kind == "node" and ev.object.id != node_id):
                        relevant = True
                if peers_ev is not None and peers_ev in done:
                    peers_ev = asyncio.ensure_future(peers_w.get())
                    relevant = True
                if not relevant:
                    continue
                msg = self._session_message(node_id, session_id)
                if msg is None:  # node deleted
                    break
                if last is None or msg.to_dict() != last.to_dict():
                    yield msg
                    last = msg
        finally:
            reap()
            watcher.close()
            if peers_w is not None:
                peers_w.close()

    # ------------------------------------------------------------------
    async def assignments(self, node_id: str, session_id: str
                          ) -> AsyncIterator[AssignmentsMessage]:
        """Reference: Assignments dispatcher.go:917."""
        self._check_running()
        rn = self.nodes.get_with_session(node_id, session_id)
        aset = AssignmentSet(node_id, drivers=self.drivers)

        def init(read_tx):
            for t in read_tx.find("task", ByNode(node_id)):
                aset.add_or_update_task(read_tx, t)

        _, watcher = self.store.view_and_watch(init, match(kind="task"))
        try:
            yield aset.message(AssignmentsType.COMPLETE)
            read_tx = self.store.read_tx()
            while self._running and not rn.disconnect.is_set():
                self.nodes.get_with_session(node_id, session_id)
                modifications = 0
                deadline: Optional[float] = None
                while modifications < MODIFICATION_BATCH_LIMIT:
                    timeout = None
                    if deadline is not None:
                        timeout = max(0.0, deadline - self.clock.now())
                    ev = await self._next_event(watcher, rn, timeout)
                    if ev is _DISCONNECTED:
                        return
                    if ev is _TIMEOUT:
                        break
                    t = ev.object
                    if t.node_id != node_id and (
                            ev.old_object is None
                            or ev.old_object.node_id != node_id):
                        continue
                    if ev.action == "remove":
                        changed = aset.remove_task(t)
                    elif t.node_id != node_id:
                        changed = aset.remove_task(ev.old_object)
                    else:
                        changed = aset.add_or_update_task(read_tx, t)
                    if changed:
                        modifications += 1
                        deadline = self.clock.now() + BATCHING_WAIT_TIME
                if modifications > 0:
                    yield aset.message(AssignmentsType.INCREMENTAL)
        finally:
            watcher.close()

    async def _next_event(self, watcher, rn, timeout: Optional[float]):
        """Wait for the next watcher event, a session disconnect, or (when
        ``timeout`` is not None) the batching deadline."""
        get_ev = asyncio.ensure_future(watcher.get())
        disc = asyncio.ensure_future(rn.disconnect.wait())
        waiters = {get_ev: "ev", disc: "disc"}
        if timeout is not None:
            timer = asyncio.ensure_future(self.clock.sleep(timeout))
            waiters[timer] = "timeout"
        try:
            done, pending = await asyncio.wait(
                set(waiters), return_when=asyncio.FIRST_COMPLETED)
        except BaseException:
            _cancel_quietly(*waiters)
            raise
        _cancel_quietly(*pending)
        if get_ev in done:
            _cancel_quietly(*(done - {get_ev}))
            return get_ev.result()
        _cancel_quietly(*(done - {disc}))
        if disc in done:
            return _DISCONNECTED
        return _TIMEOUT


_DISCONNECTED = object()
_TIMEOUT = object()


def _cancel_quietly(*futs) -> None:
    """Cancel pending waiters, swallowing late exceptions (a watcher closed
    during teardown completes its pending get() with WatcherClosed after the
    cancel — retrieve it so asyncio doesn't log 'never retrieved')."""
    for f in futs:
        f.cancel()
        f.add_done_callback(
            lambda fut: fut.exception() if not fut.cancelled() else None)
