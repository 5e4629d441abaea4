"""The raft Node shell: consensus member with storage, transport, membership
and the store Proposer seam.

Behavioral reference: manager/state/raft/raft.go — Node (:104), NewNode
(:212), Run main loop (:540), ProposeValue (:1588) /
processInternalRaftRequest (:1784), processCommitted (:1889), Join/Leave RPCs
(:920/:1132), ProcessRaftMessage (:1397) with vote-health gating
(:1422-1433), saveToStorage (:1738), restoreFromSnapshot (:743), snapshot
triggering (:677-681), leadership broadcast (:683-689), CanRemoveMember
quorum precheck (:1164-1190), and defaults (DefaultNodeConfig :482,
DefaultRaftConfig :497).

Re-expression: goroutines/channels become one asyncio event loop — a tick
task advances the logical clock (injectable Clock seam, the analog of
NodeOptions.ClockSource raft.go:187), and a run task drains Ready batches:
persist (WAL fsync) → send (Transport) → apply (store / conf changes) →
advance.  All public awaitables run on the same loop, so proposal
registration and commit callbacks need no locking.

The port's own copy of the JAX package's raft/node.py.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from swarmkit_tpu_torch.api.raft_msgs import (
    ClusterMember, ClusterSnapshot, InternalRaftRequest, Snapshot as ApiSnapshot,
    StoreAction,
)
from swarmkit_tpu_torch.raft.membership import Cluster, Member, MembershipError
from swarmkit_tpu_torch.raft.messages import (
    NONE, ConfChange, ConfChangeType, Entry, EntryType, HardState, Message,
    MsgType, Snapshot, SnapshotMeta,
)
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.metrics import trace as obs_trace
from swarmkit_tpu_torch.raft.core import (
    CANDIDATE, Config as RaftConfig, LEADER, PRE_CANDIDATE, ProposalDropped,
)
from swarmkit_tpu_torch.raft.rawnode import RawNode, Ready
from swarmkit_tpu_torch.raft.storage import EncryptedRaftLogger
from swarmkit_tpu_torch.raft.transport import Network, PeerRemoved, Transport
from swarmkit_tpu_torch.raft.wait import Wait
from swarmkit_tpu_torch.raft.wire import (
    decode_conf_change, encode_conf_change, packb, unpackb,
)
from swarmkit_tpu_torch.utils import metrics
from swarmkit_tpu_torch.store.memory import MemoryStore, Proposer
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock, wait_for
from swarmkit_tpu_torch.watch.queue import Queue

log = logging.getLogger("swarmkit_tpu_torch.raft")

# reference: DefaultRaftConfig raft.go:497
DEFAULT_SNAPSHOT_INTERVAL = 10000
DEFAULT_LOG_ENTRIES_FOR_SLOW_FOLLOWERS = 500
# reference: DefaultNodeConfig raft.go:482
DEFAULT_ELECTION_TICK = 10
DEFAULT_HEARTBEAT_TICK = 1
DEFAULT_TICK_INTERVAL = 1.0  # seconds (raft.go:218)


class ErrNoRaftMember(Exception):
    pass


class ErrLostLeadership(Exception):
    pass


class ErrMemberRemoved(Exception):
    pass


class ErrProposalTooLarge(Exception):
    pass


class ErrCannotRemoveMember(Exception):
    pass


class NotLeaderError(Exception):
    def __init__(self, leader_addr: str = "") -> None:
        super().__init__(f"not the leader (leader at {leader_addr or '?'})")
        self.leader_addr = leader_addr


@dataclass
class JoinResponse:
    raft_id: int
    members: list[Member]
    removed: list[int] = field(default_factory=list)


@dataclass
class LeadershipState:
    is_leader: bool


@dataclass
class NodeOpts:
    """reference: NodeOptions raft.go:169."""

    node_id: str
    addr: str
    network: Network
    state_dir: str
    clock: Optional[Clock] = None
    join_addr: str = ""
    force_new_cluster: bool = False
    tick_interval: float = DEFAULT_TICK_INTERVAL
    election_tick: int = DEFAULT_ELECTION_TICK
    heartbeat_tick: int = DEFAULT_HEARTBEAT_TICK
    snapshot_interval: int = DEFAULT_SNAPSHOT_INTERVAL
    log_entries_for_slow_followers: int = DEFAULT_LOG_ENTRIES_FOR_SLOW_FOLLOWERS
    encrypter: object = None
    decrypter: object = None
    seed: int = 0
    # proposal size cap; reference MaxTransactionBytes enforced raft.go:1809
    max_proposal_bytes: int = int(1.5 * 1024 * 1024)
    # Transport impl selector (the seam from transport.go:26): receives
    # (network, handlers, local_addr, clock). None = in-process Transport;
    # pass swarmkit_tpu_torch.transport.DeviceMeshTransport (with a DeviceMeshNet
    # network) to exchange raft messages through the device mailbox.
    transport_factory: object = None
    # Per-node metric registry; None = the process-global one. In-process
    # multi-node deployments pass one per node so latency percentiles do
    # not mix across members.
    metrics_registry: object = None
    # Typed observability registry (swarmkit_tpu_torch.metrics.MetricsRegistry);
    # None = the process-global default. Same per-node sharing rule as
    # metrics_registry.
    obs_registry: object = None
    # Trace collector (swarmkit_tpu_torch.metrics.Tracer); None = global default.
    tracer: object = None


class Node(Proposer):
    """A full consensus member (reference: raft.Node raft.go:104)."""

    _WEDGE_RETRY_S = 10.0  # cooldown between wedge-triggered transfers

    def __init__(self, opts: NodeOpts) -> None:
        self.opts = opts
        self.clock = opts.clock or SystemClock()
        self.node_id = opts.node_id
        self.addr = opts.addr
        self.raft_id: int = 0

        self.cluster = Cluster()
        self.storage = EncryptedRaftLogger(
            opts.state_dir, encrypter=opts.encrypter, decrypter=opts.decrypter)
        self.metrics = opts.metrics_registry or metrics.REGISTRY
        self.obs = opts.obs_registry or obs_registry.DEFAULT
        self.store = MemoryStore(proposer=None, clock=self.clock.now,
                                 metrics_registry=self.metrics,
                                 obs=self.obs)
        self.transport: Optional[Transport] = None
        self.leadership = Queue()   # publishes LeadershipState
        # awaited with (node_id, addr) before a NEW member's ADD_NODE is
        # proposed; the manager points this at node-record creation
        self.pre_join_hook = None
        # join budget scales with the tick: a slow wire or production 1 s
        # ticks make the seed's first election take many tick-times, and a
        # joiner must outlast it rather than give up at a wall-clock constant
        self._JOIN_TIMEOUT_S = max(30.0, 600 * opts.tick_interval)

        self._raw: Optional[RawNode] = None
        self._wait = Wait()
        self._wake = asyncio.Event()
        self._stopped = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._rng = random.Random(opts.seed or None)
        self._reqid = itertools.count(1)
        self._run_error: Optional[BaseException] = None
        self._applied = 0
        self._snapshot_index = 0
        self._was_leader = False
        self._removed = False
        self._ticks_until_campaign = 0
        self._wedge_transfer_at = float("-inf")
        # per-peer {"count": consecutive failures, "last_failure": clock ts}
        self._peer_failures: dict[int, dict] = {}
        self.running = False

        self.tracer = opts.tracer or obs_trace.DEFAULT
        self._last_role: Optional[str] = None
        nid = self.node_id
        self._m_elections_started = obs_catalog.get(
            self.obs, "swarm_raft_elections_started_total").labels(node=nid)
        self._m_elections_won = obs_catalog.get(
            self.obs, "swarm_raft_elections_won_total").labels(node=nid)
        self._m_leader_changes = obs_catalog.get(
            self.obs, "swarm_raft_leader_changes_total").labels(node=nid)
        self._m_proposal_latency = obs_catalog.get(
            self.obs, "swarm_raft_proposal_latency_seconds").labels(node=nid)
        self._m_proposals = obs_catalog.get(
            self.obs, "swarm_raft_proposals_total")
        self._m_peer_sends = obs_catalog.get(
            self.obs, "swarm_raft_peer_sends_total")
        self._m_peer_send_failures = obs_catalog.get(
            self.obs, "swarm_raft_peer_send_failures_total")
        obs_catalog.get(self.obs, "swarm_raft_term").labels(
            node=nid).set_function(
            lambda: self._raw.raft.term if self._raw is not None else 0)
        obs_catalog.get(self.obs, "swarm_raft_commit_index").labels(
            node=nid).set_function(
            lambda: self._raw.raft.log.committed
            if self._raw is not None else 0)
        obs_catalog.get(self.obs, "swarm_raft_applied_index").labels(
            node=nid).set_function(lambda: self._applied)
        obs_catalog.get(self.obs, "swarm_raft_is_leader").labels(
            node=nid).set_function(lambda: 1.0 if self.is_leader() else 0.0)

    # ------------------------------------------------------------------
    # lifecycle

    async def start(self) -> None:
        """JoinAndStart + Run (reference: raft.go:375, manager.go:568-588)."""
        opts = self.opts
        self.opts.network.register(self.addr, self)
        cfg_kwargs = dict(
            election_tick=opts.election_tick,
            heartbeat_tick=opts.heartbeat_tick,
            check_quorum=True,
            seed=opts.seed,
        )
        if self.storage.has_existing_state():
            self._load_from_disk(cfg_kwargs)
        elif opts.join_addr:
            await self._join_existing(cfg_kwargs)
        else:
            self._bootstrap_new_cluster(cfg_kwargs)

        factory = opts.transport_factory or Transport
        self.transport = factory(opts.network, self, self.addr, self.clock)
        for m in self.cluster.members.values():
            if m.raft_id != self.raft_id:
                self.transport.add_peer(m.raft_id, m.addr)
        for m in getattr(self, "_seed_peers", []):
            if m.raft_id != self.raft_id:
                self.transport.add_peer(m.raft_id, m.addr)

        self.store.set_proposer(self)
        self.running = True
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._tick_loop()),
                       loop.create_task(self._run())]
        # kick the run loop: replayed committed entries / bootstrap conf
        # change apply without waiting for the first tick
        self._wake.set()
        self._maybe_campaign_bootstrap()

    def _make_raw(self, cfg_kwargs, log=None, hard_state=None, voters=None
                  ) -> RawNode:
        cfg = RaftConfig(id=self.raft_id, **cfg_kwargs)
        return RawNode(cfg, log=log, hard_state=hard_state, voters=voters)

    def _bootstrap_new_cluster(self, cfg_kwargs) -> None:
        """etcd StartNode analog: seed the log with the initial add-self conf
        change at index 1, pre-committed, then campaign once applied."""
        self.raft_id = self._new_raft_id()
        self.storage.bootstrap_new()
        self._raw = self._make_raw(cfg_kwargs)
        cc = ConfChange(id=0, type=ConfChangeType.ADD_NODE,
                        node_id=self.raft_id,
                        context=self._member_context())
        ent = Entry(index=1, term=1, type=EntryType.CONF_CHANGE,
                    data=encode_conf_change(cc))
        r = self._raw.raft
        r.term = 1
        r.log.append([ent])
        r.log.commit_to(1)

    def _member_context(self, node_id: str = "", addr: str = "") -> bytes:
        return packb((node_id or self.node_id, addr or self.addr))

    async def _join_existing(self, cfg_kwargs) -> None:
        """Dial the join address and ask the leader for membership
        (reference: joinCluster raft.go:454)."""
        net = self.opts.network
        target = self.opts.join_addr
        resp: Optional[JoinResponse] = None
        # Keep dialing through transient failures — the seed manager may
        # still be electing itself or mid-restart (reference: joinCluster
        # retries via the connection broker until the context deadline).
        deadline = self.clock.now() + self._JOIN_TIMEOUT_S
        backoff = 0.2
        redirects = 0
        last_err: Optional[Exception] = None
        while resp is None and self.clock.now() < deadline:
            try:
                server = net.server(self.addr, target)
                resp = await server.join(self.node_id, self.addr)
            except NotLeaderError as e:
                last_err = e
                # Follow a few redirects eagerly, then assume an election
                # is bouncing leadership between peers and back off — an
                # unthrottled redirect ping-pong would spin the event loop
                # (and under a fake clock never advance the deadline).
                if e.leader_addr and redirects < 5:
                    redirects += 1
                    target = e.leader_addr
                    continue
                redirects = 0
                target = e.leader_addr or self.opts.join_addr
                await self.clock.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
            except Exception as e:
                # includes dial errors from net.server() itself: the seed
                # manager may be mid-restart with its listener unregistered
                last_err = e
                redirects = 0
                target = self.opts.join_addr
                await self.clock.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
        if resp is None:
            raise RuntimeError(
                f"could not reach the raft leader to join: {last_err}")
        self.raft_id = resp.raft_id
        self.storage.bootstrap_new()
        self._raw = self._make_raw(cfg_kwargs)
        # Transport peers only — membership state arrives via the replicated
        # log / snapshot (conf-change replay), not the join response.
        self._seed_peers = resp.members

    def _load_from_disk(self, cfg_kwargs) -> None:
        """reference: loadAndStart raft/storage.go:63 (+ ForceNewCluster
        storage.go:117-156)."""
        from swarmkit_tpu_torch.raft.log import RaftLog

        boot = self.storage.bootstrap_from_disk()
        voters: tuple = ()
        if boot.snapshot is not None:
            self._apply_snapshot_payload(boot.snapshot, to_raft=False)
            log = RaftLog(snapshot=boot.snapshot)
            log.pending_snapshot = None  # already applied above
            voters = boot.snapshot.meta.voters
            self._snapshot_index = boot.snapshot.meta.index
            self._applied = boot.snapshot.meta.index
        else:
            log = RaftLog()
        if self.raft_id == 0:
            # recover own id: it's in the snapshot membership or the WAL conf
            # changes; scan both.
            for m in self.cluster.members.values():
                if m.node_id == self.node_id:
                    self.raft_id = m.raft_id
            if self.raft_id == 0:
                for e in boot.entries:
                    if e.type == EntryType.CONF_CHANGE:
                        cc = decode_conf_change(e.data)
                        nid, _ = self._decode_member_context(cc.context)
                        if cc.type == ConfChangeType.ADD_NODE \
                                and nid == self.node_id:
                            self.raft_id = cc.node_id
        if self.raft_id == 0:
            raise ErrNoRaftMember("cannot recover raft id from disk state")

        if self.opts.force_new_cluster:
            # Discard other members: keep the store/log data but rewrite
            # membership to exactly this node.
            self.cluster.clear()
            self.cluster.add_member(Member(
                raft_id=self.raft_id, node_id=self.node_id, addr=self.addr))
            voters = (self.raft_id,)
            # strip pending conf changes from the replayed tail
            boot.entries = [
                e if e.type != EntryType.CONF_CHANGE else
                Entry(index=e.index, term=e.term, type=EntryType.NORMAL,
                      data=b"")
                for e in boot.entries]

        if boot.entries:
            log.append(boot.entries)
            log.stabilized(boot.entries[-1].index)
        hs = boot.hard_state
        if hs is not None:
            # clamp against a torn WAL tail
            hs = HardState(term=hs.term, vote=hs.vote,
                           commit=min(hs.commit, log.last_index()))
        self._raw = self._make_raw(cfg_kwargs, log=log, hard_state=hs,
                                   voters=voters)
        if self.opts.force_new_cluster and boot.snapshot is None \
                and self.raft_id not in self._raw.raft.prs:
            self._raw.raft.add_node(self.raft_id)
        if boot.snapshot is not None:
            self._raw.raft.stored_snapshot = boot.snapshot

    @staticmethod
    def _decode_member_context(ctx: bytes) -> tuple[str, str]:
        try:
            nid, addr = unpackb(ctx)
            return nid, addr
        except Exception:
            return "", ""

    def _new_raft_id(self) -> int:
        while True:
            rid = self._rng.getrandbits(63) | 1
            if rid not in self.cluster.members \
                    and rid not in self.cluster.removed:
                return rid

    def _next_req_id(self) -> int:
        """Node-unique proposal/conf-change id: high bits from our raft id,
        low bits a local counter (reference: idutil generator seeded from the
        member id, raft.go:284)."""
        return ((self.raft_id & 0xFFFFFFFF) << 32) \
            | (next(self._reqid) & 0xFFFFFFFF)

    async def stop(self, unregister: bool = True) -> None:
        """reference: Stop/Shutdown raft.go:1239."""
        if self._stopped.is_set():
            return
        self.running = False
        self._wait.cancel_all()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        if self.transport is not None:
            self.transport.stop()
        self.storage.close()
        if unregister:
            self.opts.network.unregister(self.addr)
        self._stopped.set()

    # ------------------------------------------------------------------
    # main loops (reference: Run raft.go:540)

    async def _tick_loop(self) -> None:
        ticker = self.clock.ticker(self.opts.tick_interval)
        async for _ in ticker:
            if not self.running:
                return
            self._raw.tick()
            self._wake.set()

    async def _run(self) -> None:
        while self.running:
            await self._wake.wait()
            self._wake.clear()
            try:
                while self._raw.has_ready():
                    rd = self._raw.ready()
                    await self._process_ready(rd)
                    if not self.running:
                        return
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                # A Ready-processing failure (e.g. WAL write error) is fatal
                # for this member: surface it, fail pending proposals, and
                # step out of the cluster rather than wedging silently.
                log.exception("raft node %s: fatal error processing Ready",
                              self.node_id)
                self._run_error = e
                self.running = False
                self._wait.cancel_all()
                return

    async def _process_ready(self, rd: Ready) -> None:
        # 0. wedge watchdog (reference: raft.go:589-606 — a leader whose
        #    store is wedged hands leadership away rather than stalling the
        #    cluster behind a stuck writer). Retries with a cooldown: a
        #    transfer whose random target is down must not latch the
        #    watchdog off while the wedge persists.
        if self.is_leader() and self.store.wedged():
            now = self.clock.now()
            if now - self._wedge_transfer_at > self._WEDGE_RETRY_S:
                self._wedge_transfer_at = now
                if len(self.cluster.members) <= 1:
                    # nowhere to transfer to; surface the stall without a
                    # traceback storm
                    log.error("raft node %s: store wedged >%ss but this is "
                              "the only manager — no transfer possible",
                              self.node_id, self.store.WEDGE_TIMEOUT)
                else:
                    log.error("raft node %s: store wedged >%ss as leader; "
                              "transferring leadership", self.node_id,
                              self.store.WEDGE_TIMEOUT)
                    try:
                        await self.transfer_leadership()
                    except Exception:
                        log.exception(
                            "wedge-triggered leadership transfer failed")

        # 1. persist hard state + entries (WAL fsync) BEFORE sending
        #    (reference: saveToStorage raft.go:1738, called at raft.go:585)
        self.storage.save(rd.hard_state, rd.entries)

        # 2. apply + persist an incoming snapshot (raft.go:618-626)
        if rd.snapshot is not None:
            self._apply_snapshot_payload(rd.snapshot, to_raft=True)
            self.storage.save_snapshot(rd.snapshot, retained_entries=(),
                                       hard_state=rd.hard_state)
            self._snapshot_index = rd.snapshot.meta.index
            self._applied = max(self._applied, rd.snapshot.meta.index)
            self.storage.gc(self._snapshot_index)

        # 3. fan out messages (raft.go:608-613; async, never blocks)
        for m in rd.messages:
            self._m_peer_sends.labels(node=self.node_id,
                                      peer=str(m.to)).inc()
            self.transport.send(m)

        # 4. leadership flips (raft.go:638-664)
        if rd.soft_state is not None:
            role = rd.soft_state.state
            if role != self._last_role:
                campaigning = (CANDIDATE, PRE_CANDIDATE)
                # a pre-vote that graduates to a real vote is ONE campaign
                if role in campaigning \
                        and self._last_role not in campaigning:
                    self._m_elections_started.inc()
                elif role == LEADER:
                    self._m_elections_won.inc()
                self._last_role = role
            is_leader = role == LEADER
            if self._was_leader and not is_leader:
                self._wait.cancel_all()
            if is_leader != self._was_leader:
                self._was_leader = is_leader
                self._m_leader_changes.inc()
                self.leadership.publish(LeadershipState(is_leader=is_leader))

        # 5. apply committed entries (raft.go:667 → processCommitted :1889)
        for e in rd.committed_entries:
            await self._process_committed(e)

        # 6. snapshot trigger (raft.go:677-681)
        if self._applied - self._snapshot_index >= self.opts.snapshot_interval:
            self._do_snapshot()

        applied_conf_change = any(e.type == EntryType.CONF_CHANGE
                                  for e in rd.committed_entries)
        self._raw.advance(rd)
        # The bootstrap/join campaign must be re-attempted AFTER advance:
        # during entry processing the conf change still sits in
        # log.unapplied_entries(), and step(HUP) refuses to campaign over a
        # pending conf change — a check done mid-apply silently no-ops and
        # the node waits out a full election timeout instead.
        if applied_conf_change:
            self._maybe_campaign_bootstrap()
        if self._raw.has_ready():
            self._wake.set()

    async def _process_committed(self, e: Entry) -> None:
        if e.type == EntryType.CONF_CHANGE:
            self._process_conf_change(e)
        elif e.data:
            self._process_entry(e)
        self._applied = max(self._applied, e.index)

    def _process_entry(self, e: Entry) -> None:
        """reference: processEntry raft.go:1906-1913."""
        r = InternalRaftRequest.decode(e.data)
        if not self._wait.trigger(r.id, e.index):
            # not our proposal (or we lost the wait): follower/replay path
            self.store.apply_store_actions(r.actions, e.index)

    def _process_conf_change(self, e: Entry) -> None:
        """reference: processConfChange raft.go:1939 +
        applyAddNode/applyUpdateNode/applyRemoveNode :1953-2024."""
        cc: ConfChange = decode_conf_change(e.data)
        err: Optional[Exception] = None
        try:
            self.cluster.validate_configuration_change(cc)
        except MembershipError as exc:
            err = exc
        if err is None:
            self._raw.apply_conf_change(cc)
            node_id, addr = self._decode_member_context(cc.context)
            if cc.type == ConfChangeType.ADD_NODE:
                self.cluster.add_member(Member(
                    raft_id=cc.node_id, node_id=node_id, addr=addr))
                if cc.node_id != self.raft_id and self.transport is not None:
                    self.transport.add_peer(cc.node_id, addr)
            elif cc.type == ConfChangeType.UPDATE_NODE:
                self.cluster.update_member(cc.node_id, addr)
                if cc.node_id != self.raft_id and self.transport is not None:
                    self.transport.update_peer(cc.node_id, addr)
            elif cc.type == ConfChangeType.REMOVE_NODE:
                if cc.node_id == self.raft_id:
                    # we were removed (raft.go:2005): stop everything
                    self._removed = True
                    self.running = False
                    self.cluster.remove_member(cc.node_id)
                else:
                    self.cluster.remove_member(cc.node_id)
                    if self.transport is not None:
                        self.transport.remove_peer(cc.node_id)
        else:
            self._raw.raft.pending_conf = False
        self._wait.trigger(cc.id, err if err is not None else e.index)
        self._maybe_campaign_bootstrap()

    def _maybe_campaign_bootstrap(self) -> None:
        """Single-member cluster: no one to elect us, so self-elect
        immediately (reference: campaignWhenAble raft.go:383-401)."""
        r = self._raw.raft
        if (len(self.cluster.members) == 1
                and self.raft_id in self.cluster.members
                and r.state != LEADER and r.promotable()):
            self._raw.campaign()
            self._wake.set()

    # ------------------------------------------------------------------
    # snapshots

    def _snapshot_payload(self) -> bytes:
        snap = ApiSnapshot(
            version=self._applied,
            membership=ClusterSnapshot(
                members=[ClusterMember(raft_id=m.raft_id, node_id=m.node_id,
                                       addr=m.addr)
                         for m in self.cluster.members.values()],
                removed=sorted(self.cluster.removed)),
            store=self.store.save())
        return snap.encode()

    def snapshot_now(self) -> None:
        """Force an immediate snapshot (reference: the DEK-rotation path
        triggers one so the log history re-encrypts under the new key and
        old generations become garbage; manager/deks.go MaybeUpdateKEK ->
        TriggerSnapshot)."""
        if self.running and self._raw is not None:
            self._do_snapshot()

    def _do_snapshot(self) -> None:
        """reference: triggerSnapshot raft.go:677 → storage.go:186 (timed
        per storage.go:20-29 snapshot latency)."""
        with metrics.timed(metrics.RAFT_SNAPSHOT_LATENCY,
                           registry=self.metrics):
            self._do_snapshot_timed()

    def _do_snapshot_timed(self) -> None:
        r = self._raw.raft
        index = self._applied
        snap = Snapshot(
            meta=SnapshotMeta(index=index, term=r.log.zero_term(index),
                              voters=r.voter_ids()),
            data=self._snapshot_payload())
        retained = r.log.entries_from(index + 1) if index < r.log.last_index() \
            else []
        self.storage.save_snapshot(snap, retained_entries=retained,
                                   hard_state=r.hard_state())
        r.stored_snapshot = snap
        self._snapshot_index = index
        # keep a tail of entries for slow followers
        # (reference: raftConfig.LogEntriesForSlowFollowers raft.go:500)
        compact_to = index - self.opts.log_entries_for_slow_followers
        if compact_to > r.log.first_index() - 1:
            r.log.compact(compact_to)
        self.storage.gc(index)

    def _apply_snapshot_payload(self, snap: Snapshot, to_raft: bool) -> None:
        """reference: restoreFromSnapshot raft.go:743."""
        if not snap.data:
            return
        payload = ApiSnapshot.decode(snap.data)
        self.store.restore(payload.store, version=payload.version)
        old_members = set(self.cluster.members)
        self.cluster.clear()
        for rid in payload.membership.removed:
            self.cluster.removed.add(rid)
        for m in payload.membership.members:
            self.cluster.add_member(Member(raft_id=m.raft_id,
                                           node_id=m.node_id, addr=m.addr))
            if self.transport is not None and m.raft_id != self.raft_id:
                self.transport.add_peer(m.raft_id, m.addr)
        if self.transport is not None:
            for rid in old_members - set(self.cluster.members):
                if rid != self.raft_id:
                    self.transport.remove_peer(rid)
        if to_raft and self._raw is not None:
            self._raw.raft.stored_snapshot = snap
        self._applied = max(self._applied, snap.meta.index)

    # ------------------------------------------------------------------
    # Proposer seam (reference: ProposeValue raft.go:1588,
    # processInternalRaftRequest :1784)

    async def propose_value(self, actions: list[StoreAction],
                            apply_cb=None, timeout: float = 30.0) -> int:
        if not self.running or self._raw is None:
            raise ErrLostLeadership("node is not running")
        if not self.is_leader():
            raise ErrLostLeadership("this node is not the leader")
        if apply_cb is None:
            # a bare ProposeValue must still apply to OUR store when the
            # entry commits (the follower path won't run: wait.trigger
            # returns True for our own proposals)
            def apply_cb(index, _actions=actions):
                self.store.apply_store_actions(_actions, index)
        r = InternalRaftRequest(id=self._next_req_id(), actions=actions)
        data = r.encode()
        if len(data) > self.opts.max_proposal_bytes:
            raise ErrProposalTooLarge(
                f"proposal is {len(data)} bytes > "
                f"{self.opts.max_proposal_bytes}")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_commit(value):
            if fut.done():
                return
            if isinstance(value, Exception):
                fut.set_exception(value)
                return
            if apply_cb is not None:
                apply_cb(value)
            fut.set_result(value)

        def on_cancel():
            if not fut.done():
                fut.set_exception(ErrLostLeadership("leadership lost"))

        self._wait.register(r.id, on_commit, on_cancel)
        try:
            self._raw.propose(data)
        except ProposalDropped:
            self._wait.trigger(r.id, ErrLostLeadership("proposal dropped"))
        self._wake.set()
        # reference: proposeLatencyTimer wraps exactly this wait
        # (raft.go:69-71, observed at :1589)
        with self.tracer.span("raft.propose", node=self.node_id,
                              req_id=r.id, actions=len(actions)) as sp:
            t0 = time.perf_counter()
            try:
                with metrics.timed(metrics.RAFT_PROPOSE_LATENCY,
                                   registry=self.metrics):
                    index = await self._await_with_timeout(fut, timeout, r.id)
            except BaseException:
                self._m_proposals.labels(node=self.node_id,
                                         result="error").inc()
                raise
            finally:
                self._m_proposal_latency.observe(time.perf_counter() - t0)
            sp.set(index=index)
            self._m_proposals.labels(node=self.node_id, result="ok").inc()
            return index

    async def _await_with_timeout(self, fut: asyncio.Future, timeout: float,
                                  wait_id: Optional[int] = None):
        sleeper = asyncio.get_running_loop().create_task(
            self.clock.sleep(timeout))
        try:
            done, _ = await asyncio.wait(
                {fut, sleeper}, return_when=asyncio.FIRST_COMPLETED)
            if fut in done:
                return fut.result()
            if fut.done():  # resolved in the same loop step as the sleeper
                return fut.result()
            if wait_id is not None:
                self._wait.forget(wait_id)
            raise TimeoutError("proposal timed out")
        finally:
            sleeper.cancel()
            if not fut.done():
                fut.cancel()

    def get_version(self) -> int:
        return self._applied

    def changes_between(self, frm: int, to: int):
        """reference: ChangesBetween raft.go (store WatchFrom catch-up)."""
        out = []
        log = self._raw.raft.log
        for e in log.slice(frm + 1, to + 1):
            if e.type == EntryType.NORMAL and e.data:
                r = InternalRaftRequest.decode(e.data)
                out.append((e.index, r.actions))
        return out

    # ------------------------------------------------------------------
    # membership RPCs (server side; reference: Join raft.go:920,
    # Leave :1132)

    async def join(self, node_id: str, addr: str) -> JoinResponse:
        if not self.running:
            raise ErrNoRaftMember("node not running")
        if not self.is_leader():
            raise NotLeaderError(self.leader_addr())
        # re-join of a known node at a (possibly new) address
        for m in self.cluster.members.values():
            if m.node_id == node_id:
                if m.addr != addr:
                    await self._configure(ConfChange(
                        type=ConfChangeType.UPDATE_NODE, node_id=m.raft_id,
                        context=self._member_context(node_id, addr)))
                return JoinResponse(raft_id=m.raft_id,
                                    members=self._member_list(),
                                    removed=sorted(self.cluster.removed))
        if not self.opts.network.healthy(addr):
            raise RuntimeError(f"joiner at {addr} failed health check "
                               "(reference: raft.go:986)")
        # Create the joiner's node record BEFORE the member exists (set by
        # the manager; reference parity: ca/server.go IssueNodeCertificate
        # creates the record before the manager ever joins raft).  Without
        # this ordering the role manager can observe a member with no
        # record and reap it as an orphan mid-join.
        if self.pre_join_hook is not None:
            await self.pre_join_hook(node_id, addr)
        raft_id = self._new_raft_id()
        await self._configure(ConfChange(
            type=ConfChangeType.ADD_NODE, node_id=raft_id,
            context=self._member_context(node_id, addr)))
        return JoinResponse(raft_id=raft_id, members=self._member_list(),
                            removed=sorted(self.cluster.removed))

    async def leave(self, raft_id: int) -> None:
        if not self.is_leader():
            raise NotLeaderError(self.leader_addr())
        await self.remove_member(raft_id)

    async def remove_member(self, raft_id: int) -> None:
        """reference: RemoveMember raft.go:1206 + CanRemoveMember :1164."""
        if not self.can_remove_member(raft_id):
            raise ErrCannotRemoveMember(
                "removing this member would break quorum among reachable "
                "members")
        await self._configure(ConfChange(
            type=ConfChangeType.REMOVE_NODE, node_id=raft_id))

    def can_remove_member(self, raft_id: int) -> bool:
        """Quorum precheck among remaining reachable members
        (reference: raft.go:1164-1190)."""
        remaining = [m for rid, m in self.cluster.members.items()
                     if rid != raft_id]
        if not remaining:
            return False
        reachable = 0
        for m in remaining:
            if m.raft_id == self.raft_id \
                    or self.opts.network.reachable(self.addr, m.addr):
                reachable += 1
        return reachable >= len(remaining) // 2 + 1

    async def _configure(self, cc: ConfChange, timeout: float = 30.0) -> None:
        """Propose a conf change and wait for it to apply
        (reference: configure raft.go:1848)."""
        cc = ConfChange(id=self._next_req_id(), type=cc.type,
                        node_id=cc.node_id, context=cc.context)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_commit(value):
            if fut.done():
                return
            if isinstance(value, Exception):
                fut.set_exception(value)
            else:
                fut.set_result(value)

        def on_cancel():
            if not fut.done():
                fut.set_exception(ErrLostLeadership("leadership lost"))

        self._wait.register(cc.id, on_commit, on_cancel)
        try:
            self._raw.propose_conf_change(cc)
        except ProposalDropped:
            self._wait.trigger(
                cc.id, ErrLostLeadership("conf change proposal dropped"))
        self._wake.set()
        await self._await_with_timeout(fut, timeout, cc.id)

    def _member_list(self) -> list[Member]:
        return [Member(raft_id=m.raft_id, node_id=m.node_id, addr=m.addr)
                for m in self.cluster.members.values()]

    # ------------------------------------------------------------------
    # transport server side (registered on the Network at self.addr)

    async def process_raft_message(self, m: Message) -> None:
        """reference: ProcessRaftMessage raft.go:1397."""
        if not self.running or self._raw is None:
            raise ErrNoRaftMember("node not running")
        if m.frm != NONE and self.cluster.is_id_removed(m.frm):
            raise PeerRemoved("sender was removed from the cluster")
        # vote-health gating (swarmkit addition, raft.go:1422-1433): reject
        # votes from members we cannot reach, so flapping nodes don't
        # destabilize a healthy leader.
        if m.type in (MsgType.VOTE, MsgType.PRE_VOTE):
            sender = self.cluster.get_member(m.frm)
            if sender is not None and not self.opts.network.reachable(
                    self.addr, sender.addr):
                return
        self._raw.step(m)
        self._wake.set()

    # Raft callback interface for the Transport
    # (reference: transport.Raft transport.go:26)
    def report_unreachable(self, raft_id: int, failures: int = 1) -> None:
        """`failures` is the transport's consecutive-failure count for the
        peer (drives its redial backoff); tracked here so operators see
        which peers are flapping via status().  A count of 0 signals
        recovery — the first successful delivery after a failure streak."""
        if failures <= 0:
            self._peer_failures.pop(raft_id, None)
            return
        self._peer_failures[raft_id] = {"count": failures,
                                        "last_failure": self.clock.now()}
        self._m_peer_send_failures.labels(node=self.node_id,
                                          peer=str(raft_id)).inc()
        if self._raw is not None and self.running:
            self._raw.report_unreachable(raft_id)
            self._wake.set()

    def report_snapshot(self, raft_id: int, ok: bool) -> None:
        if self._raw is not None and self.running:
            self._raw.report_snapshot(raft_id, ok)
            self._wake.set()

    def is_id_removed(self, raft_id: int) -> bool:
        return self.cluster.is_id_removed(raft_id)

    def update_node(self, raft_id: int, addr: str) -> None:
        pass  # address updates flow through conf changes in this build

    def node_removed(self) -> None:
        """A peer told us we were removed (reference: raft.go:1454)."""
        self._removed = True
        self.running = False

    # ------------------------------------------------------------------
    # views / helpers

    def is_leader(self) -> bool:
        return (self._raw is not None
                and self._raw.raft.state == LEADER)

    def leader_id(self) -> int:
        return self._raw.raft.lead if self._raw is not None else NONE

    def leader_addr(self) -> str:
        m = self.cluster.get_member(self.leader_id())
        return m.addr if m is not None else ""

    def is_member(self) -> bool:
        return self._raw is not None and self._raw.raft.promotable()

    @property
    def removed(self) -> bool:
        return self._removed

    def status(self) -> dict:
        st = self._raw.status() if self._raw is not None else {}
        st["members"] = {rid: m.addr for rid, m in self.cluster.members.items()}
        st["removed"] = sorted(self.cluster.removed)
        st["applied_index"] = self._applied
        st["snapshot_index"] = self._snapshot_index
        st["peer_failures"] = {rid: dict(info) for rid, info in
                               self._peer_failures.items()
                               if info["count"] > 0}
        return st

    def subscribe_leadership(self):
        """reference: SubscribeLeadership raft.go:2035."""
        return self.leadership.watch()

    async def transfer_leadership(self, to: int = NONE) -> None:
        """reference: TransferLeadership raft.go:1222 — the target is the
        most caught-up reachable member (transferee.Match maximal), so the
        TIMEOUT_NOW shortcut fires and the transfer cannot stall behind a
        lagging or partitioned follower."""
        if to == NONE:
            candidates = [rid for rid in self.cluster.members
                          if rid != self.raft_id]
            if not candidates:
                raise ErrCannotRemoveMember("no transfer target")
            prs = self._raw.raft.prs if self._raw is not None else {}
            to = max(candidates, key=lambda rid: (
                (pr := prs.get(rid)) is not None and pr.recent_active,
                pr.match if pr is not None else -1,
                self._rng.random()))
        self._raw.transfer_leadership(to)
        self._wake.set()

    async def wait_for_leader(self, timeout: float = 10.0) -> int:
        await wait_for(lambda: self.leader_id() != NONE, clock=self.clock,
                       timeout=timeout)
        return self.leader_id()

    async def propose_and_wait_applied(self, actions, timeout: float = 30.0
                                       ) -> int:
        return await self.propose_value(actions, timeout=timeout)
