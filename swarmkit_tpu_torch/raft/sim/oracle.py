"""Differential-test oracle: the host golden raft core (swarmkit_tpu_torch.raft
.core, a semantically-exact re-expression of vendored etcd/raft — see
etcd/raft's raft.go:679-1060 as SwarmKit vendors it) driven
through a scheduler that reproduces the device kernel's tick-synchronous
phase order exactly, so kernel state and oracle state can be compared
per-tick, field by field.

The kernel (swarmkit_tpu_torch.raft.sim.kernel.step) advances all N
managers one tick as: A) timers/campaign, B) vote request+response
exchange, C) append/snapshot fan-out + responses, D) leader
quorum-commit, E) apply batch, F) ring compaction — with requests and
responses completing within one tick unless masked by the drop matrix.
This module replays those phases against real `core.Raft` nodes.

INTENTIONAL DIVERGENCES between the kernel and stock etcd/raft semantics,
all masked here (this is the single list the differential gate maintains;
each knob names the kernel simplification it mirrors). Vote rejections
(candidate steps down on a rejection quorum) and CheckQuorum (leader lease
on vote requests + periodic step-down of partitioned leaders) are now
IMPLEMENTED by the kernel and replayed faithfully here — they are no longer
divergences.

 D1' CLOSED for the mailbox wire (round 4): a real heartbeat class now
    exists (hb_*/hbr_* boxes — MsgHeartbeat on the heartbeat_tick cadence
    with commit CAPTURED at send as min(match, commit), responses feeding
    CheckQuorum liveness), appends are EVENT-GATED (replicate edges send
    only content; probe edges one at a time; idle edges carry heartbeats),
    and a rejection re-sends the backtracked probe within the same tick
    (etcd stepLeader APP_RESP -> send_append).  Replayed here by
    _tick_mailbox's hbq/hbrq queues and the post-backtrack enqueue.
    Two deliberate residues, both argued strictly-fresher-than-etcd AND
    test-backed (round 5): tests/test_oracle_residues.py constructs each
    scenario and asserts trajectory convergence (same leader/term/commit,
    bounded extra delay) against an UNMASKED etcd-faithful core replay:
    (a) commit-advance-triggered EMPTY append broadcasts are subsumed —
    content appends read commit at DELIVERY (fresher than etcd's capture
    at send) and caught-up edges learn commit from next tick's heartbeat;
    (b) the heartbeat-response match<last append trigger is unnecessary
    because the wire drops at SEND only (nothing in flight can be lost;
    freed slots already guarantee probe retries).  The SYNCHRONOUS wire
    keeps appends-every-tick by definition — at heartbeat_tick=1 that IS
    etcd's heartbeat cadence with content folded in; the scheduler calls
    _bcast_append each tick there and never fires BEAT.
 D2' PreVote and leader transfer ARE implemented (cfg.pre_vote;
    kernel.transfer_leadership + the TIMEOUT_NOW wire) and replayed here.
    One wire simplification remains: a PreVote rejection stamped with a
    receiver term ABOVE the candidacy's own term is dropped in the wire
    instead of deposing the pre-candidate (it catches up via appends);
    equal-term rejections count toward the rejection quorum exactly as
    etcd's poll does. Mask: _prevote_exchange_sync/_tick_mailbox enqueue
    only countable rejections.  Test-backed (round 5):
    test_oracle_residues.py::test_d2_* shows the dropped-rejection
    pre-candidate and etcd's deposed follower converge to the identical
    (leader, term, commit) trajectory once a real election lands.
 D3' windowed flow control IS implemented on the mailbox wire
    (cfg.inflight = vendor MaxInflightMsgs): up to K appends pipeline per
    edge with optimistic next advance in StateReplicate, becomeReplicate's
    exact next=match+1 on the probe->replicate flip, and becomeProbe +
    pipeline flush on rejection — replayed here via per-edge queues and
    core's own Progress states.  The synchronous wire still re-sends the
    window from next_ every tick (its whole point is one-tick rounds).
    Mask: SyncRaft._send_append is a side-effect-free windowed send, and
    _tick_mailbox mirrors the kernel's send gating and aggregate-ack
    integration (all due acks per edge per tick: max match, then one
    min-hint rejection fallback).
 D4' CLOSED (round 4): kernel election timers now follow etcd's
    become_follower/_reset scope exactly — zeroed AND re-randomized (at
    the deterministic per-(node, term) value) on every term catch-up from
    vote requests or leader messages, zeroed on a rejection-quorum
    step-down, plus the original campaign/grant/leader-contact/CheckQuorum
    resets.  The scheduler's elapsed/timeout arrays replay the same rules
    (core CheckQuorum decisions still driven externally with
    Config(check_quorum=False) so core's internal lease stays off — a
    bookkeeping choice, not a semantic divergence).
 D5' CLOSED (round 4): propose()/propose_conf() take the alive mask
    (clients cannot reach a crashed claimant) and kernel phases E/F freeze
    apply + compaction on crashed rows; _phase_propose*/_phase_def consult
    `up` identically.

 D6 STORAGE: the oracle models a PERFECT DISK.  It has no sync_mark
    register, no fsync cadence, and no storage-fault verbs — core.Raft
    persists everything the moment it is written, exactly stock etcd
    with an ideal WAL.  The kernel's durability boundary
    (cfg.fsync_lag_ticks / ack_gating, the lost_tail/torn_write/
    snap_corrupt/disk_stall FaultSchedule leaves) is therefore mirrored
    on the KERNEL side only: dst.repro.oracle_trace stops a compared
    range before the first storage verb fires (replay_artifact's
    `until` bound), so the differential gate still certifies the clean
    prefix while the DURABILITY/RECOVERY_MONOTONIC invariant bits own
    the faulted suffix.  Ack-gating with a clean disk is transparent by
    construction (acks merely lag; no decision changes), which the
    storage-off bit-identity tests in tests/test_durability.py pin.

MEMBERSHIP REPLAY (log-driven conf changes): _phase_propose_conf mirrors
kernel propose_conf (one CONF entry per leader, degraded to an empty
normal entry while one is pending); the apply loop in _phase_def clamps
each batch at the first conf entry (kernel's one-flip-per-tick rule) and
calls core add_node/remove_node at the apply point, with remove_node's
quorum-lowering commit re-check deferred to the next Phase D
(recheck=False) and commit advancement HELD during the propose phases
(SyncRaft._maybe_commit) — both keep commit evaluation at the kernel's
once-per-tick Phase D position without changing any decision.  Vote
request/append send loops follow each sender's CURRENT prs view, and
responses from peers outside the config are dropped exactly as core's
stepLeader does.  The per-tick comparison includes the full [N, N]
member-view matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from swarmkit_tpu_torch.raft import core
from swarmkit_tpu_torch.raft.log import CompactedError, RaftLog, UnavailableError
from swarmkit_tpu_torch.raft.messages import (
    Entry, EntryType, Message, MsgType, Snapshot, SnapshotMeta,
)
from swarmkit_tpu_torch.raft.sim.state import (
    CONF_REMOVE, CONF_TARGET_MASK, SimConfig, conf_payload,
)

M32 = 0xFFFFFFFF


def hash32_py(x: int) -> int:
    """Python mirror of state.hash32 (splitmix32-style uint32 mix)."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x


def rand_timeout_py(cfg: SimConfig, node: int, term: int) -> int:
    """Python mirror of state.rand_timeout."""
    h = hash32_py(((node * 0x9E3779B1) & M32)
                  ^ ((term * 0x85EBCA77) & M32)
                  ^ (cfg.seed & M32))
    return cfg.election_tick + (h % cfg.election_tick)


def entry_chk_py(idx: int, data: int) -> int:
    """Python mirror of kernel._entry_chk."""
    return hash32_py(((idx * 0x01000193) & M32) ^ (data & M32))


def _data_u32(e: Entry) -> int:
    return int.from_bytes(e.data, "big") if e.data else 0


class SyncRaft(core.Raft):
    """core.Raft with the kernel's send discipline (divergences D1/D3):
    windowed side-effect-free appends, and a suppress flag that swallows
    sends triggered while responses are being stepped."""

    def __init__(self, cfg: core.Config, window: int, voters=None):
        super().__init__(cfg, voters=voters)
        self.window = window
        self.suppress = False
        self.hold_commit = False
        self.cluster = None   # backref set by OracleCluster (ring clamp)

    def _maybe_commit(self) -> bool:
        """Commit advancement is HELD during the propose phases: the kernel
        evaluates commit once per tick in Phase D (after sends), so a
        propose-time advance — possible when a quorum-lowering removal
        applied last tick left commit lagging — would leak a newer commit
        index into this tick's appends.  Held advances land in _phase_def
        (same decision, kernel timing)."""
        if self.hold_commit:
            return False
        return super()._maybe_commit()

    def _ring_limit(self, to: int, prev: int) -> int:
        """Receiver ring headroom (kernel's snap_idx + L - prev clamp):
        a window past it would wrap the fixed-width device ring over
        unapplied entries."""
        if self.cluster is None:
            return self.window
        rcv = self.cluster.nodes[to - 1]
        cap = rcv.log.offset + self.cluster.cfg.log_len - prev
        return max(0, min(self.window, cap))

    def _send_append(self, to: int) -> None:
        if self.suppress:
            return
        pr = self.prs[to]
        prev = pr.next - 1
        try:
            prev_term = self.log.term(prev)
            ents = self.log.slice(pr.next, self.log.last_index() + 1,
                                  self._ring_limit(to, prev))
        except (CompactedError, UnavailableError):
            meta = SnapshotMeta(index=self.log.offset,
                                term=self.log.offset_term,
                                voters=self.voter_ids())
            self._send(Message(type=MsgType.SNAP, to=to,
                               snapshot=Snapshot(meta=meta)))
            return
        self._send(Message(type=MsgType.APP, to=to, index=prev,
                           log_term=prev_term, entries=tuple(ents),
                           commit=self.log.committed))

    def _bcast_append(self) -> None:
        if self.suppress:
            return
        super()._bcast_append()

    def take_msgs(self) -> list[Message]:
        out, self.msgs = self.msgs, []
        return out


ROLE_INT = {core.FOLLOWER: 0, core.CANDIDATE: 1, core.PRE_CANDIDATE: 1,
            core.LEADER: 2}


@dataclass
class OracleView:
    """Per-tick comparable state, kernel conventions (0-based ids, -1=none)."""

    term: np.ndarray
    vote: np.ndarray
    role: np.ndarray
    lead: np.ndarray
    last: np.ndarray
    commit: np.ndarray
    applied: np.ndarray
    apply_chk: np.ndarray
    member: np.ndarray   # [N, N] per-node applied-config views

    FIELDS = ("term", "vote", "role", "lead", "last", "commit", "applied",
              "apply_chk", "member")


class OracleCluster:
    """N core.Raft nodes stepped with the kernel's phase schedule."""

    def __init__(self, cfg: SimConfig, voters=None):
        self.cfg = cfg
        n = cfg.n
        peers = tuple(range(1, n + 1))  # core ids are 1-based (NONE=0)
        # bootstrap configuration (kernel init_state(voters=...)): every
        # node knows the same initial member set; non-members stay passive
        boot = peers if voters is None else tuple(
            v + 1 for v in sorted(voters))
        self.nodes = [
            SyncRaft(core.Config(id=i + 1, peers=peers,
                                 election_tick=cfg.election_tick,
                                 heartbeat_tick=cfg.heartbeat_tick,
                                 max_size_per_msg=cfg.window,
                                 max_inflight_msgs=1 << 30,
                                 check_quorum=False,
                                 pre_vote=cfg.pre_vote,
                                 seed=cfg.seed),
                     window=cfg.window, voters=boot)
            for i in range(n)
        ]
        for nd in self.nodes:
            nd.cluster = self
        self.elapsed = [0] * n
        # lease clock: ticks since last current-term leader contact (the
        # kernel's `contact`; see core.contact_elapsed for the rationale)
        self.contact = [0] * n
        self.hb_elapsed = [0] * n
        self.timeout = [rand_timeout_py(cfg, i, 0) for i in range(n)]
        self.applied = [0] * n
        self.apply_chk = [0] * n
        # CheckQuorum bookkeeping (mirrors kernel recent_active [N, N])
        self.recent_active: list[set[int]] = [set() for _ in range(n)]
        # Canonical applied-log content (safety cross-check): idx ->
        # (term, data); chk_at[idx] = cumulative checksum through idx.
        self.canon: dict[int, tuple[int, int]] = {}
        self.chk_at: dict[int, int] = {0: 0}
        # Mailbox wire replay (kernel [N, N] in-flight slots; see
        # kernel.py "Device-mailbox wire").  Keyed (sender, receiver) for
        # request classes and (leader, responder) for response classes;
        # values carry (deliver_tick, captured header...).
        self.now = 0
        # leader transfer mirrors (kernel transferee/tx_cand/tn_* wires)
        self.tx_term: dict[int, int] = {}   # i -> term of tx-born candidacy
        self.tnq: dict[int, tuple[int, int, int]] = {}  # tgt -> (at, tm, frm)
        # vreq: (deliver_at, sender_term, is_pre) per edge
        self.vreq: dict[tuple[int, int], tuple[int, int, bool]] = {}
        # (deliver_at, candidacy_term, grant, is_pre)
        self.vresp: dict[tuple[int, int], tuple[int, int, bool, bool]] = {}
        # appq: per-edge pipelined list of (deliver_at, prev, term)
        self.appq: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
        self.snpq: dict[tuple[int, int], tuple[int, int]] = {}
        # arespq: per-edge list of (deliver_at, term, resp) — capacity is
        # unbounded here; the kernel's ack_depth guarantees the same set
        self.arespq: dict[tuple[int, int], list[tuple[int, int, Message]]] = {}
        # heartbeat wire (kernel hb_*/hbr_* boxes): (deliver_at, term,
        # captured commit) per i->j edge; responses (deliver_at, term)
        # keyed [leader, responder]
        self.hbq: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
        self.hbrq: dict[tuple[int, int], list[tuple[int, int]]] = {}

    def _lat(self, i: int, j: int, tick: int) -> int:
        """Python mirror of state.latency_matrix for one edge."""
        cfg = self.cfg
        if cfg.latency_jitter == 0:
            return cfg.latency
        h = hash32_py(((i * 0x9E3779B1) & M32)
                      ^ ((j * 0x01000193) & M32)
                      ^ ((tick * 0xC2B2AE35) & M32)
                      ^ ((cfg.seed ^ 0x7A77) & M32))
        return cfg.latency + (h % (cfg.latency_jitter + 1))

    # -- canonical applied-log bookkeeping --------------------------------
    def _canon_note(self, idx: int, term: int, data: int) -> None:
        prev = self.canon.get(idx)
        if prev is not None and prev != (term, data):
            raise AssertionError(
                f"state-machine divergence at index {idx}: "
                f"{prev} vs {(term, data)}")
        self.canon[idx] = (term, data)
        if idx - 1 in self.chk_at and idx not in self.chk_at:
            self.chk_at[idx] = (self.chk_at[idx - 1]
                                + entry_chk_py(idx, data)) & M32

    # -- shared phases -----------------------------------------------------
    def _phase_propose(self, up, payloads, prop_count: int) -> None:
        """Phase 0: propose (run_ticks calls propose() before step()).
        Clients cannot reach a crashed claimant, so `up` masks leaders the
        same way kernel propose(alive=...) does."""
        cfg = self.cfg
        if not prop_count:
            return
        ents = tuple(
            Entry(type=EntryType.NORMAL,
                  # bit 31 is reserved for conf entries; kernel propose()
                  # masks it off, so the oracle must store the same value
                  data=(int(payloads[k]) & 0x7FFFFFFF).to_bytes(4, "big"))
            for k in range(prop_count))
        for i, nd in enumerate(self.nodes):
            if not up[i] or nd.state != core.LEADER:
                continue
            room = (nd.log.last_index() + cfg.max_props
                    - nd.log.offset) <= cfg.log_len
            if not room:
                continue
            nd.suppress = nd.hold_commit = True
            try:
                nd.step(Message(type=MsgType.PROP, frm=nd.id, entries=ents))
            except core.ProposalDropped:
                pass
            nd.suppress = nd.hold_commit = False
            nd.take_msgs()

    def _phase_propose_conf(self, up, conf) -> None:
        """Phase 0b: one membership-change proposal (kernel propose_conf).
        conf = (target_row, remove).  Core's stepLeader degrades the entry
        to an empty normal one while an earlier conf change is pending —
        the one-in-flight rule."""
        if conf is None:
            return
        cfg = self.cfg
        tgt, rm = conf
        if not (0 <= int(tgt) < cfg.n):
            # kernel propose_conf degrades an out-of-range target to an
            # empty normal entry (same as the pending-conf case)
            ent = Entry(type=EntryType.NORMAL, data=b"")
        else:
            ent = Entry(type=EntryType.CONF_CHANGE,
                        data=conf_payload(int(tgt),
                                          bool(rm)).to_bytes(4, "big"))
        for i, nd in enumerate(self.nodes):
            if not up[i] or nd.state != core.LEADER:
                continue
            room = (nd.log.last_index() + cfg.max_props
                    - nd.log.offset) <= cfg.log_len
            if not room:
                continue
            nd.suppress = nd.hold_commit = True
            try:
                nd.step(Message(type=MsgType.PROP, frm=nd.id,
                                entries=(ent,)))
            except core.ProposalDropped:
                pass
            nd.suppress = nd.hold_commit = False
            nd.take_msgs()

    def _phase_a(self, up) -> None:
        """Phase A: timers + CheckQuorum + campaign."""
        cfg, n, nodes = self.cfg, self.cfg.n, self.nodes
        for i in range(n):
            if up[i]:
                self.elapsed[i] += 1
                self.contact[i] += 1
                if nodes[i].state == core.LEADER:
                    self.hb_elapsed[i] += 1
        for i, nd in enumerate(nodes):
            # CheckQuorum: every election_tick ticks a standing leader must
            # have heard from a quorum since its last round (kernel Phase A)
            if up[i] and nd.state == core.LEADER \
                    and self.elapsed[i] >= cfg.election_tick:
                if cfg.check_quorum:
                    members = {p - 1 for p in nd.prs}
                    heard = (self.recent_active[i] | {i}) & members
                    if len(heard) < nd.quorum():
                        nd.become_follower(nd.term, core.NONE)
                    else:
                        # transfer not completed within an election
                        # timeout: abort (kernel Phase A; vendor
                        # tickHeartbeat); a quorum-confirmed leader
                        # re-arms its own lease
                        nd._abort_leader_transfer()
                        self.contact[i] = 0
                    self.recent_active[i] = set()
                else:
                    # defense off (kernel gates only the step-down and
                    # lease re-arm; the periodic transfer abort and the
                    # timer reset run either way)
                    nd._abort_leader_transfer()
                self.elapsed[i] = 0
        # TIMEOUT_NOW deliveries land between CheckQuorum and the timeout
        # campaigns (kernel Phase A order)
        self._transfer_deliver(up)
        for i, nd in enumerate(nodes):
            if not up[i]:
                continue
            # tickElection: only promotable nodes fire (the timer resets
            # either way once it expires); core's HUP step then refuses to
            # campaign over a committed-but-unapplied conf entry
            if nd.state != core.LEADER and nd.promotable() \
                    and self.elapsed[i] >= self.timeout[i]:
                self.elapsed[i] = 0
                nd.step(Message(type=MsgType.HUP, frm=nd.id))
                nd.take_msgs()  # Phase B re-emits vote requests uniformly
                if nd.state != core.PRE_CANDIDATE:
                    # vendor becomePreCandidate never re-randomizes the
                    # timeout (only a REAL campaign's reset does); the
                    # kernel matches, so the oracle must too or the two
                    # sides fire later campaigns on different ticks
                    self.timeout[i] = rand_timeout_py(cfg, i, nd.term)

    def _phase_def(self, up) -> None:
        """Phases D (leader commit), E (apply + checksums), F (compaction)."""
        cfg, nodes = self.cfg, self.nodes
        for i, nd in enumerate(nodes):
            if up[i] and nd.state == core.LEADER:
                nd.suppress = True
                nd._maybe_commit()
                nd.suppress = False
                nd.take_msgs()
        for i, nd in enumerate(nodes):
            if not up[i]:
                continue   # crashed rows freeze (apply AND compaction)
            if nd.log.applied > self.applied[i]:  # snapshot restore jumped
                self.applied[i] = nd.log.applied
                base = self.chk_at.get(self.applied[i])
                if base is None:
                    raise AssertionError(
                        f"restore to unapplied index {self.applied[i]}")
                self.apply_chk[i] = base
            new_applied = min(nd.log.committed,
                              self.applied[i] + cfg.apply_batch)
            # at most ONE membership flip lands per node per tick: the
            # batch clamps at the first conf entry (kernel Phase E clamp)
            for idx in range(self.applied[i] + 1, new_applied + 1):
                e = nd.log.entries[idx - nd.log.offset - 1]
                if e.type == EntryType.CONF_CHANGE:
                    new_applied = idx
                    break
            for idx in range(self.applied[i] + 1, new_applied + 1):
                e = nd.log.entries[idx - nd.log.offset - 1]
                d = _data_u32(e)
                self._canon_note(idx, e.term, d)
                self.apply_chk[i] = (self.apply_chk[i]
                                     + entry_chk_py(idx, d)) & M32
                if e.type == EntryType.CONF_CHANGE:
                    # kernel Phase E clips the decoded target into range
                    tgt = min(d & CONF_TARGET_MASK, self.cfg.n - 1) + 1
                    if d & CONF_REMOVE:
                        # quorum-lowering commit re-check waits for the
                        # next Phase D (the oracle evaluates commit once
                        # per tick, same decision one tick later)
                        nd.remove_node(tgt, recheck=False)
                    else:
                        newly = tgt not in nd.prs
                        nd.add_node(tgt)
                        if newly:
                            # kernel: a fresh joiner starts recent_active
                            # (core add_node pr.recent_active analog)
                            self.recent_active[i].add(tgt - 1)
            self.applied[i] = new_applied
            nd.log.applied_to(new_applied)
        for i, nd in enumerate(nodes):
            if not up[i]:
                continue
            last, off = nd.log.last_index(), nd.log.offset
            pressure = (last - off) > (cfg.log_len - 2 * cfg.max_props - 1)
            new_snap = max(off, self.applied[i] - cfg.keep)
            if pressure and new_snap > off:
                nd.log.compact(new_snap)

    def transfer(self, leader: int, target: int) -> None:
        """Mirror of kernel.transfer_leadership: record the target on the
        leader's core node and reset its election timer (vendor stepLeader
        MsgTransferLeader; a repeat for the same in-flight target is a
        no-op)."""
        nd = self.nodes[leader]
        if nd.state != core.LEADER or target == leader:
            return
        if (target + 1) not in nd.prs:
            return   # kernel gate: member[leader, target] (core would
            # reject inside stepLeader, but AFTER the timer reset)
        if nd.lead_transferee == target + 1:
            return
        self.elapsed[leader] = 0
        nd.step(Message(type=MsgType.TRANSFER_LEADER, frm=target + 1,
                        to=nd.id))
        nd.take_msgs()   # TIMEOUT_NOW/append bursts ride the kernel's wire

    def _is_tx(self, i: int) -> bool:
        nd = self.nodes[i]
        return (nd.state == core.CANDIDATE
                and self.tx_term.get(i) == nd.term)

    def _transfer_fire(self, up, drop) -> None:
        """Kernel's per-tick TIMEOUT_NOW send rule: a transferring leader
        whose target is fully caught up fires once into the target's
        single wire slot (vendor stepLeader MsgAppResp transferee
        branch)."""
        cfg, n, nodes = self.cfg, self.cfg.n, self.nodes
        now = self.now
        for i in range(n):   # lowest leader index wins a contested slot
            nd = nodes[i]
            if not up[i] or nd.state != core.LEADER \
                    or nd.lead_transferee == core.NONE:
                continue
            t = nd.lead_transferee - 1
            if t == i or not (0 <= t < n) or t in self.tnq \
                    or nd.lead_transferee not in nd.prs:
                continue
            if nd.prs[nd.lead_transferee].match != nd.log.last_index():
                continue
            if drop[i][t]:
                continue
            lat = self._lat(i, t, now) if cfg.mailboxes else 0
            self.tnq[t] = (now + 1 + lat, nd.term, i)

    def _transfer_deliver(self, up) -> None:
        """TIMEOUT_NOW deliveries (kernel Phase A): the target runs a
        forced REAL campaign whose requests bypass the leader lease."""
        cfg, nodes = self.cfg, self.nodes
        now = self.now
        for t in sorted(k for k, v in self.tnq.items() if v[0] <= now + 1):
            _, tm, frm = self.tnq.pop(t)
            nd = nodes[t]
            if not up[t] or nd.state == core.LEADER or tm < nd.term:
                continue
            if tm == nd.term and nd.state != core.FOLLOWER:
                continue  # candidates ignore equal-term TIMEOUT_NOW
            nd.step(Message(type=MsgType.TIMEOUT_NOW, frm=frm + 1,
                            to=nd.id, term=tm))
            nd.take_msgs()
            if nd.state == core.CANDIDATE:
                self.elapsed[t] = 0
                self.timeout[t] = rand_timeout_py(cfg, t, nd.term)
                self.tx_term[t] = nd.term
            elif nd.state == core.LEADER:   # quorum-of-1 forced cascade
                self.elapsed[t] = 0
                self.contact[t] = 0
                self.hb_elapsed[t] = 0
                self.timeout[t] = rand_timeout_py(cfg, t, nd.term)
                self.recent_active[t] = set()

    def _prevote_exchange_sync(self, up, drop, leased) -> None:
        """PreVote round on the synchronous wire, processed BEFORE real
        votes (the kernel's defined delivery order).  Grants mutate no
        receiver state; rejections count only when stamped with the
        candidacy's own term (kernel D2' drop rule for higher-term
        rejects); pre-quorum transitions to a real candidacy with the
        kernel's elapsed/timeout resets."""
        cfg, n, nodes = self.cfg, self.cfg.n, self.nodes
        if not cfg.pre_vote:
            return
        pv_requests: list[tuple[int, int, Message]] = []
        for i in range(n):
            nd = nodes[i]
            if not up[i] or nd.state != core.PRE_CANDIDATE:
                continue
            for j in range(n):
                if j == i or not up[j] or drop[i][j] or leased[j] \
                        or (j + 1) not in nd.prs:
                    continue
                pv_requests.append((i, j, Message(
                    type=MsgType.PRE_VOTE, to=j + 1, frm=nd.id,
                    term=nd.term + 1, index=nd.log.last_index(),
                    log_term=nd.log.last_term())))
        pv_requests.sort(key=lambda r: (-r[2].term, r[0]))
        pv_grants: list[tuple[int, int, Message]] = []
        pv_rejects: list[tuple[int, int, Message]] = []
        for i, j, msg in pv_requests:
            nodes[j].step(msg)
            for resp in nodes[j].take_msgs():
                if resp.type != MsgType.PRE_VOTE_RESP:
                    continue
                if not resp.reject:
                    pv_grants.append((j, i, resp))
                elif resp.term == msg.term - 1:
                    pv_rejects.append((j, i, resp))
        for j, i, resp in pv_grants:
            if drop[j][i]:
                continue
            nd = nodes[i]
            if nd.state != core.PRE_CANDIDATE:
                continue
            nd.step(resp)
            nd.take_msgs()   # real-campaign bursts go via normal sends
            if nd.state in (core.CANDIDATE, core.LEADER):
                # pre-win: kernel bumps term, resets elapsed and
                # re-randomizes the timeout at the new term
                self.elapsed[i] = 0
                self.timeout[i] = rand_timeout_py(cfg, i, nd.term)
                if nd.state == core.LEADER:  # quorum-of-1 cascade
                    self.recent_active[i] = set()
        for j, i, resp in pv_rejects:
            if drop[j][i] or nodes[i].state != core.PRE_CANDIDATE:
                continue
            nodes[i].step(resp)
            nodes[i].take_msgs()
            if nodes[i].state == core.FOLLOWER:   # rejection-quorum lose
                self.elapsed[i] = 0

    # -- one kernel-schedule tick -----------------------------------------
    def tick(self, alive, drop, payloads=(), prop_count: int = 0,
             conf=None) -> None:
        if self.cfg.mailboxes:
            self._tick_mailbox(alive, drop, payloads, prop_count, conf)
        else:
            self._tick_sync(alive, drop, payloads, prop_count, conf)

    def _tick_sync(self, alive, drop, payloads=(), prop_count: int = 0,
                   conf=None) -> None:
        cfg, n = self.cfg, self.cfg.n
        nodes = self.nodes
        up = [bool(alive[i]) for i in range(n)]

        self._phase_propose(up, payloads, prop_count)
        self._phase_propose_conf(up, conf)
        self._phase_a(up)

        # Phase B: vote exchange. Candidates re-request every tick (the
        # kernel's req matrix); delivery order (term desc, candidate asc)
        # reproduces the kernel's max-term catch-up + lowest-index grant.
        # Lease flags snapshot BEFORE any vote is delivered (kernel computes
        # `leased` once from post-Phase-A state).
        leased = [cfg.check_quorum and nodes[j].lead != core.NONE
                  and self.contact[j] < cfg.election_tick
                  for j in range(n)]
        # capture candidacies BEFORE any exchange (kernel send sets are
        # fixed from post-Phase-A state: a pre-winner sends real requests
        # only from the NEXT tick)
        real_cands = [i for i in range(n)
                      if up[i] and nodes[i].state == core.CANDIDATE]
        self._prevote_exchange_sync(up, drop, leased)
        requests: list[tuple[int, int, Message]] = []  # (cand, to, msg)
        for i in real_cands:
            nd = nodes[i]
            if nd.state != core.CANDIDATE:
                continue
            for j in range(n):
                if j == i or not up[j] or drop[i][j] \
                        or (j + 1) not in nd.prs \
                        or (leased[j] and not self._is_tx(i)):
                    continue
                requests.append((i, j, Message(
                    type=MsgType.VOTE, to=j + 1, frm=nd.id, term=nd.term,
                    index=nd.log.last_index(),
                    log_term=nd.log.last_term())))
        requests.sort(key=lambda r: (-r[2].term, r[0]))
        grants: list[tuple[int, int, Message]] = []  # (voter, cand, resp)
        rejects: list[tuple[int, int, Message]] = []
        for i, j, msg in requests:
            if msg.term > nodes[j].term:   # become_follower _reset (D4')
                self.elapsed[j] = 0
                self.timeout[j] = rand_timeout_py(self.cfg, j, msg.term)
            nodes[j].step(msg)
            for resp in nodes[j].take_msgs():
                if resp.type == MsgType.VOTE_RESP and not resp.reject:
                    self.elapsed[j] = 0
                    grants.append((j, i, resp))
                elif resp.type == MsgType.VOTE_RESP and resp.reject \
                        and resp.term == msg.term:
                    # processed at the candidate's term: a real rejection
                    # (kernel counts only current-term refusals)
                    rejects.append((j, i, resp))
        new_leader_msgs: list[Message] = []
        for j, i, resp in grants:
            if drop[j][i]:
                continue
            was_leader = nodes[i].state == core.LEADER
            nodes[i].step(resp)
            msgs = nodes[i].take_msgs()
            if not was_leader and nodes[i].state == core.LEADER:
                self.elapsed[i] = 0
                self.contact[i] = 0
                self.hb_elapsed[i] = 0
                self.recent_active[i] = set()
                new_leader_msgs.extend(msgs)  # win-cascade appends (Phase C)
        # rejections step in AFTER all grants (kernel: win evaluated before
        # the rejection quorum); only still-candidates care
        for j, i, resp in rejects:
            if drop[j][i] or nodes[i].state != core.CANDIDATE:
                continue
            nodes[i].step(resp)
            nodes[i].take_msgs()
            if nodes[i].state == core.FOLLOWER:   # rejection-quorum lose
                self.elapsed[i] = 0

        # Phase C: append/snapshot fan-out from every standing leader.
        out: list[Message] = list(new_leader_msgs)
        already_sent = {m.frm for m in new_leader_msgs}
        for i, nd in enumerate(nodes):
            if up[i] and nd.state == core.LEADER and nd.id not in already_sent:
                nd._bcast_append()
                out.extend(nd.take_msgs())
        by_rcpt: dict[int, list[Message]] = {}
        for m in out:
            if m.type not in (MsgType.APP, MsgType.SNAP):
                continue
            i, j = m.frm - 1, m.to - 1
            if not up[j] or drop[i][j]:
                continue
            by_rcpt.setdefault(j, []).append(m)
        responses: list[tuple[int, int, Message]] = []
        for j, msgs in by_rcpt.items():
            msgs.sort(key=lambda m: (-m.term, m.frm))
            for m in msgs:
                if m.term > nodes[j].term:   # become_follower _reset (D4')
                    self.elapsed[j] = 0
                    self.timeout[j] = rand_timeout_py(self.cfg, j, m.term)
                nodes[j].step(m)
                for resp in nodes[j].take_msgs():
                    if resp.type == MsgType.APP_RESP:
                        responses.append((j, m.frm - 1, resp))
                if m.term == nodes[j].term:
                    self.elapsed[j] = 0
                    self.contact[j] = 0
        for j, i, resp in responses:
            if drop[j][i] or not up[i]:
                continue
            if nodes[i].state == core.LEADER:
                self.recent_active[i].add(j)  # kernel: any resp arrival
            nodes[i].suppress = True
            nodes[i].step(resp)
            nodes[i].suppress = False
            nodes[i].take_msgs()

        # Phases D/E/F (commit, apply, compaction) — shared with the
        # mailbox tick.
        self._transfer_fire(up, drop)
        self._phase_def(up)
        self.now += 1

    def _tick_mailbox(self, alive, drop, payloads=(), prop_count: int = 0,
                      conf=None) -> None:
        """Replay of the kernel's mailbox wire (kernel.py Phase B/C under
        cfg.mailboxes): sends fill empty per-edge slots capturing (term,
        prev); deliveries at deliver-tick construct messages from the
        sender's CURRENT core state, dropped when the sender's term/role
        changed since send; responses ride the reverse edge with the same
        latency schedule."""
        cfg, n = self.cfg, self.cfg.n
        nodes = self.nodes
        up = [bool(alive[i]) for i in range(n)]
        now = self.now

        self._phase_propose(up, payloads, prop_count)
        self._phase_propose_conf(up, conf)
        self._phase_a(up)

        # ---- Phase B: vote wire ----
        # sends: any candidacy (pre or real) refills edges carrying no
        # message from the SAME candidacy (term, pre)
        for i, nd in enumerate(nodes):
            if not up[i] or nd.state not in (core.CANDIDATE,
                                             core.PRE_CANDIDATE):
                continue
            is_pre = nd.state == core.PRE_CANDIDATE
            for j in range(n):
                if j == i or drop[i][j] or (j + 1) not in nd.prs:
                    continue
                slot = self.vreq.get((i, j))
                if slot is None or slot[1] != nd.term or slot[2] != is_pre:
                    self.vreq[(i, j)] = (now + self._lat(i, j, now),
                                         nd.term, is_pre)
        # request deliveries (lease snapshot BEFORE any vote is stepped);
        # prevote requests process before real ones (kernel phase order)
        leased = [cfg.check_quorum and nodes[j].lead != core.NONE
                  and self.contact[j] < cfg.election_tick
                  for j in range(n)]
        due = sorted(k for k, v in self.vreq.items() if v[0] <= now)
        pv_requests: list[tuple[int, int, Message]] = []
        requests: list[tuple[int, int, Message]] = []
        for (i, j) in due:
            _, tm, is_pre = self.vreq.pop((i, j))
            nd = nodes[i]
            # stale guard: sender crashed state is frozen, so an in-flight
            # request from a crashed candidate still delivers (kernel: the
            # validity mask reads the frozen role/term/pre row)
            want = core.PRE_CANDIDATE if is_pre else core.CANDIDATE
            if nd.state != want or nd.term != tm:
                continue
            if not up[j] or (leased[j] and not self._is_tx(i)):
                continue
            if is_pre:
                pv_requests.append((i, j, Message(
                    type=MsgType.PRE_VOTE, to=j + 1, frm=nd.id,
                    term=nd.term + 1, index=nd.log.last_index(),
                    log_term=nd.log.last_term())))
            else:
                requests.append((i, j, Message(
                    type=MsgType.VOTE, to=j + 1, frm=nd.id, term=nd.term,
                    index=nd.log.last_index(),
                    log_term=nd.log.last_term())))
        # prevote exchange: requests, then due prevote responses, then the
        # pre-win transition — all BEFORE any real vote is stepped
        pv_requests.sort(key=lambda r: (-r[2].term, r[0]))
        for i, j, msg in pv_requests:
            nodes[j].step(msg)
            for resp in nodes[j].take_msgs():
                if resp.type != MsgType.PRE_VOTE_RESP or drop[j][i]:
                    continue
                if not resp.reject:
                    self.vresp[(i, j)] = (now + self._lat(j, i, now),
                                          msg.term - 1, True, True)
                elif resp.term == msg.term - 1:
                    # countable only at the candidacy's own term (kernel
                    # D2' higher-term reject drop rule)
                    self.vresp[(i, j)] = (now + self._lat(j, i, now),
                                          msg.term - 1, False, True)
        pv_due = sorted(k for k, v in self.vresp.items()
                        if v[0] <= now and v[3])
        pv_arrivals = [(i, j, *self.vresp.pop((i, j))[1:])
                       for (i, j) in pv_due]
        for want_grant in (True, False):
            for (i, j, tm, grant, _pre) in pv_arrivals:
                if grant is not want_grant:
                    continue
                nd = nodes[i]
                if not up[i] or nd.state != core.PRE_CANDIDATE \
                        or nd.term != tm:
                    continue
                nd.step(Message(
                    type=MsgType.PRE_VOTE_RESP, to=nd.id, frm=j + 1,
                    term=tm + 1 if grant else tm, reject=not grant))
                nd.take_msgs()
                if nd.state in (core.CANDIDATE, core.LEADER):
                    self.elapsed[i] = 0
                    self.timeout[i] = rand_timeout_py(cfg, i, nd.term)
                    if nd.state == core.LEADER:  # quorum-of-1 cascade
                        self.contact[i] = 0
                        self.hb_elapsed[i] = 0
                        self.recent_active[i] = set()
                elif nd.state == core.FOLLOWER:  # rejection-quorum lose
                    self.elapsed[i] = 0
        # real vote exchange
        requests.sort(key=lambda r: (-r[2].term, r[0]))
        for i, j, msg in requests:
            if msg.term > nodes[j].term:   # become_follower _reset (D4')
                self.elapsed[j] = 0
                self.timeout[j] = rand_timeout_py(self.cfg, j, msg.term)
            nodes[j].step(msg)
            for resp in nodes[j].take_msgs():
                if resp.type != MsgType.VOTE_RESP:
                    continue
                if not resp.reject:
                    self.elapsed[j] = 0
                    if not drop[j][i]:
                        self.vresp[(i, j)] = (
                            now + self._lat(j, i, now), msg.term, True,
                            False)
                elif resp.term == msg.term:
                    # processed at the candidate's term: a real rejection
                    if not drop[j][i]:
                        self.vresp[(i, j)] = (
                            now + self._lat(j, i, now), msg.term, False,
                            False)
        # response deliveries: all due grants integrate before rejections
        # (kernel evaluates win before the rejection quorum)
        vdue = sorted(k for k, v in self.vresp.items()
                      if v[0] <= now and not v[3])
        arrivals = [(i, j, *self.vresp.pop((i, j))[1:]) for (i, j) in vdue]
        for want_grant in (True, False):
            for (i, j, tm, grant, _pre) in arrivals:
                if grant is not want_grant:
                    continue
                nd = nodes[i]
                if not up[i] or nd.state != core.CANDIDATE or nd.term != tm:
                    continue
                nd.step(Message(type=MsgType.VOTE_RESP, to=nd.id, frm=j + 1,
                                term=tm, reject=not grant))
                nd.take_msgs()  # win-cascade appends go via the mailbox wire
                if nd.state == core.LEADER:  # the guard above filtered
                    self.elapsed[i] = 0      # out already-leaders
                    self.contact[i] = 0
                    self.hb_elapsed[i] = 0
                    self.recent_active[i] = set()
                elif nd.state == core.FOLLOWER:  # rejection-quorum lose
                    self.elapsed[i] = 0

        # ---- Phase C: append/snapshot wire ----
        # sends: up to cfg.inflight appends pipeline per edge, one NEW one
        # per tick, with pr.next advanced optimistically by the entries
        # known at send (kernel n_send; etcd Replicate-state pipelining).
        # Entries from a stale candidacy never deliver on either side, so
        # they are pruned eagerly here.
        K = cfg.inflight
        for i, nd in enumerate(nodes):
            if not up[i] or nd.state != core.LEADER:
                continue
            for j in range(n):
                if j == i or drop[i][j] or (j + 1) not in nd.prs:
                    continue
                q = [e for e in self.appq.get((i, j), [])
                     if e[2] == nd.term]
                self.appq[(i, j)] = q
                s = self.snpq.get((i, j))
                if s is not None and s[1] == nd.term:
                    continue   # snapshot in flight blocks the edge
                pr = nd.prs[j + 1]
                prev = pr.next - 1
                last = nd.log.last_index()
                has_new = pr.next <= last
                probing = pr.state == core.PROBE
                if prev >= nd.log.offset:
                    # StateProbe: one append at a time, no optimism;
                    # StateReplicate: pipeline while a slot is free
                    if probing:
                        if q:
                            continue
                    elif len(q) >= K or not has_new:
                        continue
                    q.append((now + self._lat(i, j, now), prev, nd.term))
                    if has_new and not probing:  # optimisticUpdate
                        pr.next = prev + min(cfg.window, last - prev) + 1
                else:
                    self.snpq[(i, j)] = (now + self._lat(i, j, now), nd.term)
        # -- heartbeat sends (kernel hb wire; etcd bcastHeartbeat): commit
        # captured at send as min(pr.match, committed)
        for i, nd in enumerate(nodes):
            if not up[i] or nd.state != core.LEADER \
                    or self.hb_elapsed[i] < cfg.heartbeat_tick:
                continue
            self.hb_elapsed[i] = 0
            for j in range(n):
                if j == i or drop[i][j] or (j + 1) not in nd.prs:
                    continue
                self.hbq.setdefault((i, j), []).append(
                    (now + self._lat(i, j, now), nd.term,
                     min(nd.prs[j + 1].match, nd.log.committed)))
        # -- heartbeat deliveries: BEFORE append deliveries (the kernel
        # computes append validity after heartbeat effects), all due per
        # tick, stale (sender left the captured term/role) dropped,
        # stepped per receiver in term-desc order like appends
        hb_out: list[tuple[int, int, int, int]] = []
        for (i, j) in sorted(self.hbq):
            q = self.hbq[(i, j)]
            due = [e for e in q if e[0] <= now]
            if not due:
                continue
            self.hbq[(i, j)] = [e for e in q if e[0] > now]
            nd = nodes[i]
            for (_, tm, cm) in due:
                if nd.state != core.LEADER or nd.term != tm or not up[j]:
                    continue
                hb_out.append((i, j, tm, cm))
        by_hb: dict[int, list[tuple[int, int, int]]] = {}
        for i, j, tm, cm in hb_out:
            by_hb.setdefault(j, []).append((i, tm, cm))
        for j, msgs in sorted(by_hb.items()):
            msgs.sort(key=lambda x: (-x[1], x[0]))
            responded: set[int] = set()
            for i, tm, cm in msgs:
                m = Message(type=MsgType.HEARTBEAT, to=j + 1, frm=i + 1,
                            term=tm, commit=cm)
                if m.term > nodes[j].term:   # become_follower _reset (D4')
                    self.elapsed[j] = 0
                    self.timeout[j] = rand_timeout_py(self.cfg, j, m.term)
                nodes[j].step(m)
                for resp in nodes[j].take_msgs():
                    if resp.type == MsgType.HEARTBEAT_RESP \
                            and not drop[j][i] and i not in responded:
                        # one response per edge per tick (liveness only)
                        responded.add(i)
                        self.hbrq.setdefault((i, j), []).append(
                            (now + self._lat(j, i, now), nodes[j].term))
                if m.term == nodes[j].term:
                    self.elapsed[j] = 0
                    self.contact[j] = 0
        # deliveries: the wire drains AT MOST ONE append per edge per tick
        # — the smallest-prev deliverable one; construct messages from the
        # sender's CURRENT state
        out: list[tuple[int, int, Message]] = []
        for (i, j) in sorted(self.appq):
            q = self.appq[(i, j)]
            nd = nodes[i]
            due = [e for e in q if e[0] <= now]
            if not due:
                continue
            # stale/undeliverable due entries clear without delivering
            deliverable = []
            for e in due:
                if nd.state != core.LEADER or nd.term != e[2] \
                        or not up[j] or e[1] < nd.log.offset:
                    continue   # cleared
                deliverable.append(e)
            if deliverable:
                sel = min(deliverable, key=lambda e: e[1])
                deliverable.remove(sel)
                _, prev, tm = sel
                prev_term = nd.log.term(prev)
                ents = nd.log.slice(prev + 1, nd.log.last_index() + 1,
                                    nd._ring_limit(j + 1, prev))
                out.append((i, j, Message(
                    type=MsgType.APP, to=j + 1, frm=nd.id, term=nd.term,
                    index=prev, log_term=prev_term, entries=tuple(ents),
                    commit=nd.log.committed)))
            self.appq[(i, j)] = [e for e in q if e[0] > now] + deliverable
        for (i, j) in sorted(k for k, v in self.snpq.items() if v[0] <= now):
            _, tm = self.snpq.pop((i, j))
            nd = nodes[i]
            if nd.state != core.LEADER or nd.term != tm or not up[j]:
                continue
            meta = SnapshotMeta(index=nd.log.offset, term=nd.log.offset_term,
                                voters=nd.voter_ids())
            out.append((i, j, Message(
                type=MsgType.SNAP, to=j + 1, frm=nd.id, term=nd.term,
                snapshot=Snapshot(meta=meta))))
        by_rcpt: dict[int, list[tuple[int, Message]]] = {}
        for i, j, m in out:
            by_rcpt.setdefault(j, []).append((i, m))
        for j, msgs in sorted(by_rcpt.items()):
            msgs.sort(key=lambda im: (-im[1].term, im[1].frm))
            for i, m in msgs:
                if m.term > nodes[j].term:   # become_follower _reset (D4')
                    self.elapsed[j] = 0
                    self.timeout[j] = rand_timeout_py(self.cfg, j, m.term)
                nodes[j].step(m)
                for resp in nodes[j].take_msgs():
                    if resp.type == MsgType.APP_RESP and not drop[j][i]:
                        rq = self.arespq.setdefault((i, j), [])
                        rq.append((now + self._lat(j, i, now), m.term, resp))
                if m.term == nodes[j].term:
                    self.elapsed[j] = 0
                    self.contact[j] = 0
        # response deliveries: ALL due acks integrate, oks first (core's
        # match/next merges are monotone), then ONE aggregate rejection
        # fallback with the min hint (the kernel's conservative order)
        for (i, j) in sorted(self.arespq):
            rq = self.arespq[(i, j)]
            due = [e for e in rq if e[0] <= now]
            if not due:
                continue
            self.arespq[(i, j)] = [e for e in rq if e[0] > now]
            nd = nodes[i]
            oks = []
            rej_hints = []
            for _, tm, resp in due:
                if not up[i] or nd.state != core.LEADER or nd.term != tm:
                    continue
                self.recent_active[i].add(j)  # kernel: any resp arrival
                if resp.reject:
                    rej_hints.append(resp.reject_hint)
                else:
                    oks.append(resp)
            for resp in oks:
                nd.suppress = True
                nd.step(resp)
                nd.suppress = False
                nd.take_msgs()
            if rej_hints and nd.state == core.LEADER \
                    and (j + 1) in nd.prs:
                # kernel reject rule + becomeProbe (flush pipelined
                # same-term appends past the conflict).  Responses from a
                # peer the config no longer contains are dropped on BOTH
                # sides (core stepLeader: prs.get(m.frm) is None -> return;
                # kernel: ok_mat/rej_mat &= member before integration —
                # the rejection path is receiver-visible, so the mask is
                # required for exactness).
                pr = nd.prs[j + 1]
                pr.next = max(1, min(pr.next - 1, min(rej_hints) + 1))
                pr.state = core.PROBE
                pr.inflights = []
                pr.paused = False
                self.appq[(i, j)] = [e for e in self.appq.get((i, j), [])
                                     if e[2] != nd.term]
                # etcd re-sends immediately after maybeDecrTo (stepLeader
                # APP_RESP reject -> send_append): enqueue the backtracked
                # probe this tick (ring-reachable case only; the snapshot
                # variant waits for the next send round on both sides)
                s_ = self.snpq.get((i, j))
                prev = pr.next - 1
                if not drop[i][j] \
                        and not (s_ is not None and s_[1] == nd.term) \
                        and prev >= nd.log.offset:
                    self.appq[(i, j)].append(
                        (now + self._lat(i, j, now), prev, nd.term))

        # heartbeat responses: liveness bookkeeping only (kernel val_hbr;
        # the etcd match<last resend trigger is unnecessary under
        # send-time-drop wire semantics)
        for (i, j) in sorted(self.hbrq):
            q = self.hbrq[(i, j)]
            due = [e for e in q if e[0] <= now]
            if not due:
                continue
            self.hbrq[(i, j)] = [e for e in q if e[0] > now]
            nd = nodes[i]
            for (_, tm) in due:
                if up[i] and nd.state == core.LEADER and nd.term == tm:
                    self.recent_active[i].add(j)

        self._transfer_fire(up, drop)
        self._phase_def(up)
        self.now += 1

    # -- comparable view ---------------------------------------------------
    def view(self) -> OracleView:
        n = self.cfg.n
        nodes = self.nodes

        def arr(f, dtype=np.int32):
            return np.array([f(nodes[i], i) for i in range(n)], dtype=dtype)

        return OracleView(
            term=arr(lambda nd, i: nd.term),
            vote=arr(lambda nd, i: nd.vote - 1),     # core NONE=0 -> -1
            role=arr(lambda nd, i: ROLE_INT[nd.state]),
            lead=arr(lambda nd, i: nd.lead - 1),
            last=arr(lambda nd, i: nd.log.last_index()),
            commit=arr(lambda nd, i: nd.log.committed),
            applied=arr(lambda nd, i: self.applied[i]),
            apply_chk=arr(lambda nd, i: self.apply_chk[i], np.uint32),
            member=np.array([[(j + 1) in nodes[i].prs for j in range(n)]
                             for i in range(n)], dtype=bool),
        )
