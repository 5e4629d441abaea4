"""The raft tick kernel (PyTorch port).

One `step` call advances all N simulated managers by one tick with
branchless masked tensor ops, following the JAX package's raft/sim/kernel.py
phase for phase so every SimState field matches it bit for bit:

- Phase A: timers, CheckQuorum step-down, TIMEOUT_NOW delivery, campaigns;
- Phase B: the vote exchange (term catch-up, grants, rejections, win/lose);
- Phase C: append/snapshot fan-out, the receiver's conflict scan and the
  ring write — banded over the live chunks of the log when cfg.tiled, with
  the masked write-back of each chunk done by the hand-written CUDA kernel
  (parallel/cuda_ops.append_band_copy) on the card;
- progress integration, leader-transfer completion, Phase D commit bisect;
- Phase E apply + checksum, Phase F ring-pressure compaction.

This slice implements the configuration of the bench's headline: the
tick-synchronous wire, static membership, dense peer reductions and dense
progress, with or without the tiled log and the fused propose.
`check_slice` raises NotImplementedError for every other lever.

The ring buffers are written IN PLACE: `step` and `propose_dense` consume
the `log_term`/`log_data` tensors of the state they are given (the
returned state holds the same storage).  Callers that keep an old state
clone its rings first.  Every ring read of a tick happens before that
tick's ring write, which is what the JAX package's functional update gives
for free.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.raft.sim.state import (
    CANDIDATE, FOLLOWER, LEADER, NONE, SimConfig, SimState, check_device,
    rand_timeout,
)

I32 = torch.int32
BIG = 2 ** 31 - 1            # int32 max: the "no index" sentinel of min folds
PAYLOAD_MASK = 0x7FFF_FFFF   # bit 31 of a payload is reserved for conf tags


def check_slice(cfg: SimConfig) -> None:
    """Raise NotImplementedError for a config lever this port does not yet
    implement, naming it (rather than silently ignoring it)."""
    levers = (
        (not cfg.static_members, "dynamic membership (static_members=False)"),
        (cfg.mailboxes, "the mailbox wire (latency/latency_jitter/"
                        "force_mailboxes)"),
        (cfg.pre_vote, "PreVote (pre_vote=True)"),
        (cfg.peer_tiled, "banded peer reductions (0 < peer_chunk < n); "
                         "set peer_chunk=0"),
        (cfg.active_rows_on, "role-sparse progress (0 < active_rows < n); "
                             "set active_rows=0"),
        (cfg.read_batch > 0, "the read path (read_batch > 0)"),
        (cfg.record_events, "the flight recorder (record_events=True)"),
        (cfg.collect_telemetry, "telemetry (collect_telemetry=True)"),
        (cfg.trace_tags, "trace tags (trace_tags=True)"),
        (cfg.storage_on, "the storage model (fsync_lag_ticks > 0)"),
        (cfg.vote_guard, "the vote guard (vote_guard=True)"),
        (cfg.transfer_cooldown_ticks > 0,
         "transfer cooldown (transfer_cooldown_ticks > 0)"),
    )
    for on, what in levers:
        if on:
            raise NotImplementedError(
                f"the PyTorch port does not implement {what} yet")


# ---- index helpers ---------------------------------------------------------

def _slot(cfg: SimConfig, idx: torch.Tensor) -> torch.Tensor:
    """Ring slot (int64, for indexing) of 1-based log index (idx<=0 -> 0)."""
    return torch.remainder(torch.clamp(idx, min=1) - 1,
                           cfg.log_len).to(torch.int64)


def _idx_at_slots(cfg: SimConfig, last: torch.Tensor) -> torch.Tensor:
    """[N, L] log index stored at each ring slot, anchored at `last` [N]:
    the unique idx in (last - L, last] with (idx-1) % L == slot (floor
    modulo, as in the JAX package)."""
    s = torch.arange(cfg.log_len, dtype=I32, device=last.device)[None, :]
    a = last[:, None]
    return a - torch.remainder(a - (s + 1), cfg.log_len)


def _idx_at_band(cfg: SimConfig, anchor: torch.Tensor,
                 off: int) -> torch.Tensor:
    """[N, log_chunk] analog of _idx_at_slots for the chunk at slot `off`."""
    s = (off + torch.arange(cfg.log_chunk, dtype=I32,
                            device=anchor.device))[None, :]
    a = anchor[:, None]
    return a - torch.remainder(a - (s + 1), cfg.log_len)


def _term_own(cfg, log_term, snap_idx, snap_term, last, idx):
    """Per-row own-log term lookup for [N] idx (one element per row)."""
    ring = log_term.gather(1, _slot(cfg, idx)[:, None])[:, 0]
    in_ring = (idx > snap_idx) & (idx <= last)
    return torch.where(idx == snap_idx, snap_term,
                       torch.where(in_ring, ring, 0))


def _entry_chk(idx: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Order-independent checksum contribution of one entry, unsigned form
    (data is uint32 bits)."""
    return u32.hash32(u32.mul(u32.unsigned(idx), 0x01000193)
                      ^ u32.unsigned(data))


def _band_origin(cfg: SimConfig, lo: int, hi: int) -> tuple[int, int]:
    """Unwrapped chunk coordinates (c0u, nchunks) of the live band (lo, hi]
    of 1-based log indexes; nchunks <= 0 on an empty band (floor division,
    as in the JAX package)."""
    c0u = lo // cfg.log_chunk
    return c0u, (hi - 1) // cfg.log_chunk - c0u + 1


def _band_offsets(cfg: SimConfig, c0u: int) -> list[int]:
    """Slot offsets of the cfg.band_chunks ring chunks a banded pass visits
    (pairwise distinct: band_chunks < num_chunks)."""
    return [((c0u + k) % cfg.num_chunks) * cfg.log_chunk
            for k in range(cfg.band_chunks)]


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 index of the first True along `dim`, 0 where there is none —
    the JAX argmax-over-bool rule (ties resolve to the lowest index)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    ar = torch.arange(n, dtype=I32, device=mask.device).view(shape)
    first = torch.where(mask, ar, n).amin(dim)
    return torch.where(first == n, 0, first)


def _put(dst: torch.Tensor, mask: torch.Tensor, val) -> None:
    """dst = where(mask, val, dst), written into dst's storage."""
    dst.copy_(torch.where(mask, val, dst))


def _count(mask: torch.Tensor, dim: int) -> torch.Tensor:
    return mask.sum(dim, dtype=I32)


def _leader_ok(state: SimState, cfg: SimConfig,
               alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows that accept proposals: leaders in their own applied config, with
    ring room and no transfer in flight (and alive, when given)."""
    is_leader = (state.role == LEADER) & torch.diagonal(state.member)
    room = (state.last + cfg.max_props - state.snap_idx) <= cfg.log_len
    ok = is_leader & room & (state.transferee == NONE)
    if cfg.prop_inflight_cap > 0:
        ok = ok & ((state.last - state.commit) < cfg.prop_inflight_cap)
    if alive is not None:
        ok = ok & alive
    return ok


# ---- the tick --------------------------------------------------------------

def step(state: SimState, cfg: SimConfig,
         alive: Optional[torch.Tensor] = None,
         drop: Optional[torch.Tensor] = None,
         prop_count=None,
         payload_fn: Optional[Callable] = None,
         device=None) -> SimState:
    """Advance every simulated manager by one tick.

    alive: [N] bool — False rows are crashed (frozen, no send/receive).
    drop:  [N, N] bool — drop[i, j] drops all i->j traffic this tick.
    prop_count/payload_fn: the fused dense propose — bit-identical to
    ``step(propose_dense(state, cfg, payload_fn, prop_count, alive), ...)``
    with the proposal ring stores folded into Phase C's ring write.
    payload_fn(tick, k) maps the tick and the int64 batch positions k to
    uint32 payload bits (run._payload_at).

    Runs on `device` (the CUDA card unless the caller names another) and
    consumes the state's ring buffers (see the module docstring).  On a
    tiled config the choice between the banded and the full ring write
    reads one small tensor back to the host: one device->host sync per
    tick, where the JAX package branches on the device with lax.cond.
    """
    check_slice(cfg)
    dev = check_device(state, device)
    n, L, W = cfg.n, cfg.log_len, cfg.window
    node_l = torch.arange(n, device=dev)
    node = node_l.to(I32)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if drop is None:
        drop = torch.zeros((n, n), dtype=torch.bool, device=dev)
    drop_t = drop.T

    term, vote, role, lead = state.term, state.vote, state.role, state.lead
    elapsed, hb_elapsed = state.elapsed, state.hb_elapsed
    timeout = state.timeout
    last, commit, applied = state.last, state.commit, state.applied
    snap_idx, snap_term = state.snap_idx, state.snap_term
    snap_chk, apply_chk = state.snap_chk, state.apply_chk
    log_term, log_data = state.log_term, state.log_data
    match, next_, granted = state.match, state.next_, state.granted
    rejected, recent_active = state.rejected, state.recent_active
    pre = state.pre
    pending_conf = state.pending_conf
    now = state.tick

    # Fused dense propose: cursor effects now, ring stores in Phase C's
    # ring write.  Rows are judged on the pre-tick state.
    fused_prop = payload_fn is not None
    if fused_prop:
        prop_ok = _leader_ok(state, cfg, alive)
        prop_cnt = int(prop_count)
        prop_last0 = last
        prop_anchor = prop_last0 + prop_cnt
        last = last + torch.where(prop_ok, prop_cnt, 0).to(I32)

    # static membership: every view is all rows, quorum is a constant
    self_mem = torch.ones((n,), dtype=torch.bool, device=dev)
    quorum = n // 2 + 1

    # ---- Phase A: timers ----------------------------------------------
    is_leader = (role == LEADER) & alive
    elapsed = torch.where(alive, elapsed + 1, elapsed)
    contact = torch.where(alive, state.contact + 1, state.contact)
    hb_elapsed = torch.where(is_leader, hb_elapsed + 1, hb_elapsed)

    # last/last_term are read before anything appends this tick; a
    # proposing row's new last entry carries its own pre-tick term
    last_term = _term_own(cfg, log_term, snap_idx, snap_term, last, last)
    if fused_prop and prop_cnt > 0:
        last_term = torch.where(prop_ok, state.term, last_term)

    if fused_prop:
        match = torch.where(prop_ok[:, None] & eye, last[:, None], match)

    # CheckQuorum: every election_tick a leader confirms it heard from a
    # quorum since the last round, else steps down
    check_due = is_leader & (elapsed >= cfg.election_tick)
    if cfg.check_quorum:
        n_heard = _count(recent_active | eye, 1)
        cq_fail = check_due & (n_heard < quorum)
        role = torch.where(cq_fail, FOLLOWER, role)
        lead = torch.where(cq_fail, NONE, lead)
        contact = torch.where(check_due & ~cq_fail, 0, contact)
        recent_active = torch.where(check_due[:, None], False, recent_active)
    elapsed = torch.where(check_due, 0, elapsed)
    is_leader = (role == LEADER) & alive
    # a transfer not completed within an election timeout is aborted
    transferee = torch.where(check_due, NONE, state.transferee)
    transferee = torch.where(role != LEADER, NONE, transferee)

    # TIMEOUT_NOW delivery: the transfer target campaigns immediately
    tx_cand = state.tx_cand
    tn_at, tn_term, tn_from = state.tn_at, state.tn_term, state.tn_from
    tn_due = (tn_at > 0) & (now + 1 >= tn_at)
    tn_ok = tn_due & alive & self_mem & (role != LEADER) \
        & (tn_term >= term) & ((role == FOLLOWER) | (tn_term > term))
    term = torch.where(tn_ok & (tn_term > term), tn_term, term)
    tn_at = torch.where(tn_due, 0, tn_at)

    # election timeouts -> campaigns (hup_conf is all-False under static
    # membership, kept for parity with the reference's gate)
    want_campaign = (alive & self_mem & (role != LEADER)
                     & (elapsed >= timeout)) & ~tn_ok
    elapsed = torch.where(want_campaign, 0, elapsed)
    campaign = want_campaign & ~state.hup_conf
    term = term + campaign.to(I32)
    vote = torch.where(campaign, node, vote)
    role = torch.where(campaign, CANDIDATE, role)
    lead = torch.where(campaign, NONE, lead)
    timeout = torch.where(campaign, rand_timeout(cfg, node, term), timeout)
    granted = torch.where(campaign[:, None], eye, granted)
    rejected = torch.where(campaign[:, None], False, rejected)
    tx_cand = tx_cand & ~campaign
    # forced (transfer) campaign
    term = term + tn_ok.to(I32)
    vote = torch.where(tn_ok, node, vote)
    role = torch.where(tn_ok, CANDIDATE, role)
    pre = pre & ~tn_ok
    lead = torch.where(tn_ok, NONE, lead)
    elapsed = torch.where(tn_ok, 0, elapsed)
    timeout = torch.where(tn_ok, rand_timeout(cfg, node, term), timeout)
    granted = torch.where(tn_ok[:, None], eye, granted)
    rejected = torch.where(tn_ok[:, None], False, rejected)
    tx_cand = torch.where(tn_ok, True, tx_cand)

    # ---- Phase B: vote exchange -----------------------------------------
    is_cand = (role == CANDIDATE) & alive
    if cfg.check_quorum:
        # leader lease: a receiver in contact with a live leader ignores
        # vote requests (unless the candidacy is a forced transfer)
        leased = (lead != NONE) & (contact < cfg.election_tick)
    else:
        leased = torch.zeros((n,), dtype=torch.bool, device=dev)
    req = is_cand[:, None] & alive[None, :] & ~eye & ~drop \
        & (~leased[None, :] | tx_cand[:, None]) & ~pre[:, None]
    lt_i, lt_j = last_term[:, None], last_term[None, :]
    log_ok = (lt_i > lt_j) | ((lt_i == lt_j) & (last[:, None] >= last[None, :]))

    # receiver-side term catch-up
    req_term = torch.where(req, term[:, None], -1)
    mt = req_term.amax(0)
    newer = mt > term
    term = torch.where(newer, mt, term)
    role = torch.where(newer, FOLLOWER, role)
    vote = torch.where(newer, NONE, vote)
    lead = torch.where(newer, NONE, lead)
    elapsed = torch.where(newer, 0, elapsed)
    timeout = torch.where(newer, rand_timeout(cfg, node, term), timeout)
    is_cand = (role == CANDIDATE) & alive

    can_vote = (vote[None, :] == NONE) | (vote[None, :] == node[:, None])
    cur = req & (req_term == term[None, :])   # requests at the rx term
    grantable = cur & can_vote & log_ok
    any_grant = grantable.any(0)
    chosen_cand = torch.where(any_grant, _first_true(grantable, 0), 0)
    grant_mat = grantable & (node[:, None] == chosen_cand[None, :])
    vote = torch.where(any_grant, chosen_cand, vote)
    elapsed = torch.where(any_grant, 0, elapsed)
    real_cand = is_cand & ~pre
    resp_arrive = grant_mat & ~drop_t
    granted = granted | (resp_arrive & real_cand[:, None])
    reject_arrive = cur & ~grant_mat & ~drop_t
    rejected = rejected | (reject_arrive & real_cand[:, None])
    polled = ((resp_arrive | reject_arrive) & real_cand[:, None]).any(1)

    fresh_real = tn_ok | campaign
    votes = _count(granted, 1)
    win = is_cand & ~pre & (votes >= quorum) & (fresh_real | polled)
    n_rej = _count(rejected & ~granted, 1)
    lose = is_cand & ~win & (n_rej >= quorum) & (fresh_real | polled)
    role = torch.where(lose, FOLLOWER, role)
    lead = torch.where(lose, NONE, lead)
    elapsed = torch.where(lose, 0, elapsed)
    pre = pre & ~lose
    # becomeLeader: reset progress, append a no-op entry at the new term
    role = torch.where(win, LEADER, role)
    lead = torch.where(win, node, lead)
    hb_elapsed = torch.where(win, 0, hb_elapsed)
    elapsed = torch.where(win, 0, elapsed)
    contact = torch.where(win, 0, contact)
    pending_conf = torch.where(win, state.tail_conf, pending_conf)
    next_ = torch.where(win[:, None], (last + 1)[:, None], next_)
    match = torch.where(win[:, None], 0, match)
    recent_active = torch.where(win[:, None], eye, recent_active)
    noop_term = term   # the winner's candidacy term, captured here
    last = last + win.to(I32)
    is_leader = (role == LEADER) & alive
    match = torch.where(win[:, None] & eye, last[:, None], match)

    # ---- Phase C: append / snapshot fan-out ------------------------------
    prev_mat = next_ - 1
    can_ring = prev_mat >= snap_idx[:, None]
    send_base = is_leader[:, None] & alive[None, :] & ~eye & ~drop
    send_app = send_base & can_ring
    send_snap = send_base & ~can_ring
    msg_term = torch.where(send_app | send_snap, term[:, None], -1)
    mt2 = msg_term.amax(0)
    newer2 = mt2 > term
    term = torch.where(newer2, mt2, term)
    role = torch.where(newer2, FOLLOWER, role)
    vote = torch.where(newer2, NONE, vote)
    lead = torch.where(newer2, NONE, lead)
    elapsed = torch.where(newer2, 0, elapsed)
    timeout = torch.where(newer2, rand_timeout(cfg, node, term), timeout)

    # each receiver picks its current-term leader, judged by the send-time
    # sender term (lowest row on ties)
    eligible = (send_app | send_snap) & (msg_term == term[None, :])
    has_lmsg = eligible.any(0)
    src = _first_true(eligible, 0)           # 0 where has_lmsg is False
    src_l = src.to(torch.int64)
    role = torch.where(has_lmsg & (role == CANDIDATE), FOLLOWER, role)
    lead = torch.where(has_lmsg, src, lead)
    elapsed = torch.where(has_lmsg, 0, elapsed)
    contact = torch.where(has_lmsg, 0, contact)
    is_leader = (role == LEADER) & alive
    got_app = has_lmsg & send_app[src_l, node_l]
    got_snap = has_lmsg & send_snap[src_l, node_l]
    p = prev_mat[src_l, node_l]

    if not cfg.tiled:
        # untiled noop store, before the append reads (as in the reference:
        # a just-elected leader replicates its no-op the same tick);
        # non-winners rewrite their own slot unchanged
        noop_slot = _slot(cfg, torch.where(win, last, last + 1))
        log_term[node_l, noop_slot] = torch.where(
            win, noop_term, log_term[node_l, noop_slot])
        log_data[node_l, noop_slot] = torch.where(
            win, 0, log_data[node_l, noop_slot])

    # -- append receive.  Every ring read below precedes the ring write.
    last_src, snap_src = last[src_l], snap_idx[src_l]
    p_ring_term = log_term[src_l, _slot(cfg, p)]
    p_term_sent = torch.where(
        p == snap_src, snap_term[src_l],
        torch.where((p > snap_src) & (p <= last_src), p_ring_term, 0))
    # window clamp for ring safety (never wrap over unapplied entries)
    ring_cap = snap_idx + L - p
    n_avail = torch.clamp(torch.minimum(last_src - p, ring_cap), 0, W)
    hi = p + n_avail                                             # lastnewi

    commit0 = commit
    q_p = torch.minimum(p, last)
    local_p_term = _term_own(cfg, log_term, snap_idx, snap_term, last, q_p)
    if fused_prop:
        # a stale co-leader's prev can reach this row's pending proposals
        local_p_term = torch.where(prop_ok & (q_p > prop_last0), state.term,
                                   local_p_term)
    if cfg.tiled:
        # likewise a fresh winner's pending noop entry (idx == last)
        local_p_term = torch.where(win & (q_p == last), noop_term,
                                   local_p_term)
    prev_ok = (p <= last) & (p >= snap_idx) & (local_p_term == p_term_sent)
    stale = p < commit0
    accept = got_app & prev_ok & ~stale

    # snapshot-receive decision (the wipe rides the ring write)
    snap_pt = torch.minimum(snap_src, last)
    have_term = _term_own(cfg, log_term, snap_idx, snap_term, last, snap_pt)
    if fused_prop:
        have_term = torch.where(prop_ok & (snap_pt > prop_last0), state.term,
                                have_term)
    if cfg.tiled:
        have_term = torch.where(win & (snap_pt == last), noop_term, have_term)
    already = (snap_src <= last) & (have_term == snap_term[src_l])
    advance = got_snap & (snap_src > commit)
    do_restore = advance & ~already

    def payloads(k):
        return payload_fn(now, torch.clamp(k, min=0).to(torch.int64)) \
            & PAYLOAD_MASK

    def prop_write(lt, ld, new_idx):
        """The fused propose's stores into a chunk or full view (in place):
        new_idx is the slot->index map anchored one batch ahead."""
        k_of = new_idx - prop_last0[:, None] - 1
        valid = prop_ok[:, None] & (k_of >= 0) & (k_of < prop_cnt)
        _put(lt, valid, state.term[:, None])
        _put(ld, valid, payloads(k_of))

    if cfg.tiled:
        # Window extraction: every entry value the append can copy lives in
        # the sender's (p, p + window]; gather it before the ring write and
        # patch entries still pending in this tick's write (fused
        # proposals, a fresh winner's noop) analytically.
        widx = p[:, None] + 1 + torch.arange(W, dtype=I32, device=dev)[None]
        wslot = _slot(cfg, widx)
        wsrc_t = log_term[src_l[:, None], wslot]
        wsrc_d = log_data[src_l[:, None], wslot]
        wown_t = log_term.gather(1, wslot)
        if fused_prop:
            k_src = widx - prop_last0[src_l][:, None] - 1
            pend_s = prop_ok[src_l][:, None] & (k_src >= 0) \
                & (k_src < prop_cnt)
            wsrc_t = torch.where(pend_s, state.term[src_l][:, None], wsrc_t)
            wsrc_d = torch.where(pend_s, payloads(k_src), wsrc_d)
            k_own = widx - prop_last0[:, None] - 1
            pend_o = prop_ok[:, None] & (k_own >= 0) & (k_own < prop_cnt)
            wown_t = torch.where(pend_o, state.term[:, None], wown_t)
        noop_s = win[src_l][:, None] & (widx == last_src[:, None])
        wsrc_t = torch.where(noop_s, noop_term[src_l][:, None], wsrc_t)
        wsrc_d = torch.where(noop_s, 0, wsrc_d)
        wown_t = torch.where(win[:, None] & (widx == last[:, None]),
                             noop_term[:, None], wown_t)
        # find_conflict on the window axis
        w_in = got_app[:, None] & (widx <= hi[:, None])
        w_exists = (widx <= last[:, None]) & (widx > snap_idx[:, None])
        w_mism = w_in & (~w_exists | (wown_t != wsrc_t))
        any_mism = w_mism.any(1)
        ci_idx = torch.where(w_mism, widx, BIG).amin(1)

        def write_at(lead_idx, off):
            """Masked append write-back of the chunk at `off` whose sender
            index map is lead_idx; values come from the window buffers."""
            in_win = got_app[:, None] & (lead_idx > p[:, None]) \
                & (lead_idx <= hi[:, None])
            write = in_win & accept[:, None] & (lead_idx >= ci_idx[:, None])
            wk = torch.clamp(lead_idx - p[:, None] - 1, 0, W - 1) \
                .to(torch.int64)
            cuda_ops.append_band_copy(log_term, log_data, off,
                                      wsrc_t.gather(1, wk),
                                      wsrc_d.gather(1, wk), write)

        # The band of this tick's writes, read back to pick the branch
        # (the one host sync of the tick).  Election ticks (pending noop)
        # and restore ticks (full-width wipe) take the full pass.
        probe = [torch.where(got_app, p, BIG).amin(),
                 torch.where(got_app, hi, 0).amax(),
                 do_restore.any(), win.any()]
        if fused_prop:
            probe += [torch.where(prop_ok, prop_last0, BIG).amin(),
                      torch.where(prop_ok, prop_anchor, 0).amax()]
        host = torch.stack([x.to(torch.int64) for x in probe]).tolist()
        c0u, nch = _band_origin(cfg, host[0], host[1])
        fits = nch <= cfg.band_chunks and not host[2] and not host[3]
        if fused_prop:
            c0p, nch_p = _band_origin(cfg, host[4], host[5])
            fits = fits and nch_p <= cfg.band_chunks
        C = cfg.log_chunk
        if fits:
            if fused_prop:
                for off in _band_offsets(cfg, c0p):
                    prop_write(log_term[:, off:off + C],
                               log_data[:, off:off + C],
                               _idx_at_band(cfg, prop_anchor, off))
            for off in _band_offsets(cfg, c0u):
                write_at(_idx_at_band(cfg, last_src, off), off)
        else:
            # full-pass fallback: the same mutations over the whole ring
            if fused_prop:
                prop_write(log_term, log_data,
                           _idx_at_slots(cfg, prop_anchor))
            noop_m = win[:, None] & (_idx_at_slots(cfg, last)
                                     == last[:, None])
            _put(log_term, noop_m, noop_term[:, None])
            log_data.masked_fill_(noop_m, 0)
            write_at(_idx_at_slots(cfg, last_src), 0)
            log_term.masked_fill_(do_restore[:, None], 0)
            log_data.masked_fill_(do_restore[:, None], 0)
    else:
        if fused_prop:
            prop_write(log_term, log_data, _idx_at_slots(cfg, prop_anchor))
        # find_conflict over the whole row, against the sender's row
        lead_term_row = log_term[src_l]
        lead_data_row = log_data[src_l]
        lead_idx = _idx_at_slots(cfg, last_src)
        in_win = got_app[:, None] & (lead_idx > p[:, None]) \
            & (lead_idx <= hi[:, None])
        exists = (lead_idx <= last[:, None]) & (lead_idx > snap_idx[:, None])
        mism = in_win & (~exists | (log_term != lead_term_row))
        any_mism = mism.any(1)
        ci_idx = torch.where(mism, lead_idx, BIG).amin(1)
        write = in_win & accept[:, None] & (lead_idx >= ci_idx[:, None])
        cuda_ops.append_band_copy(log_term, log_data, 0, lead_term_row,
                                  lead_data_row, write)
        log_term.masked_fill_(do_restore[:, None], 0)
        log_data.masked_fill_(do_restore[:, None], 0)

    lastnewi = hi
    last = torch.where(accept, torch.where(any_mism, lastnewi,
                                           torch.maximum(last, lastnewi)),
                       last)
    commit = torch.where(accept, torch.maximum(
        commit, torch.minimum(commit0[src_l], lastnewi)), commit)

    # snapshot receive: cursor/meta effects (the ring wipe happened above)
    commit = torch.where(advance & already, snap_src, commit)
    last = torch.where(do_restore, snap_src, last)
    commit = torch.where(do_restore, snap_src, commit)
    applied = torch.where(do_restore, snap_src, applied)
    apply_chk = torch.where(do_restore, snap_chk[src_l], apply_chk)
    snap_term = torch.where(do_restore, snap_term[src_l], snap_term)
    snap_chk = torch.where(do_restore, snap_chk[src_l], snap_chk)
    snap_idx = torch.where(do_restore, snap_src, snap_idx)

    # responses back to senders (j -> i), may be dropped
    resp_match = torch.where(stale & got_app, commit0,
                             torch.where(got_snap, commit, lastnewi))
    resp_ok = accept | got_snap | (stale & got_app)
    resp_reject = got_app & ~prev_ok & ~stale
    reject_hint = last

    # ---- progress integration ---------------------------------------------
    arrive_back = ~drop_t & (node[:, None] == src[None, :]) \
        & is_leader[:, None] & has_lmsg[None, :]
    ok_mat = arrive_back & resp_ok[None, :]
    rej_mat = arrive_back & resp_reject[None, :]
    recent_active = recent_active | ok_mat | rej_mat
    match = torch.where(ok_mat, torch.maximum(match, resp_match[None, :]),
                        match)
    next_ = torch.where(ok_mat, torch.maximum(next_, (resp_match + 1)[None]),
                        next_)
    # probe decrement (coarse): jump next back to the hint
    next_ = torch.where(rej_mat, torch.clamp(
        torch.minimum(next_ - 1, (reject_hint + 1)[None, :]), min=1), next_)

    # leader transfer completion: fire TIMEOUT_NOW once the target caught up
    tgt = torch.clamp(transferee, 0, n - 1).to(torch.int64)
    has_tx = is_leader & (transferee != NONE) & (tgt != node_l)
    caught = has_tx & (match.gather(1, tgt[:, None])[:, 0] == last)
    want_tn = caught & (tn_at[tgt] == 0) \
        & ~drop.gather(1, tgt[:, None])[:, 0]
    send_tn = want_tn[:, None] & (tgt[:, None] == node_l[None, :])
    any_tn = send_tn.any(0)
    tn_src = _first_true(send_tn, 0)     # lowest leader wins
    tn_at = torch.where(any_tn, now + 1, tn_at)
    tn_term = torch.where(any_tn, term[tn_src.to(torch.int64)], tn_term)
    tn_from = torch.where(any_tn, tn_src, tn_from)

    # ---- Phase D: leader commit (quorum on the match row) ----------------
    # the largest X in (commit, last] acked by a quorum, by a fixed-depth
    # bisection instead of a sort of the match plane
    match = torch.where(is_leader[:, None] & eye, last[:, None], match)
    lo, hi_b = commit, last
    for _ in range(max(1, L.bit_length() + 1)):
        mid = (lo + hi_b + 1) >> 1
        cnt = _count(match >= mid[:, None], 1)
        ok = (cnt >= quorum) & (hi_b >= mid) & (mid > lo)
        lo = torch.where(ok, mid, lo)
        hi_b = torch.where(ok, hi_b, mid - 1)
    mci = lo
    mci_term = _term_own(cfg, log_term, snap_idx, snap_term, last, mci)
    can_commit = is_leader & (mci > commit) & (mci_term == term)
    commit = torch.where(can_commit, mci, commit)

    # ---- Phase E: apply + checksum ---------------------------------------
    base_applied = torch.minimum(commit, applied + cfg.apply_batch)
    new_applied = torch.where(alive, base_applied, applied)  # crashed: frozen
    if cfg.tiled:
        # per-row gather window: (applied, new_applied] is at most
        # apply_batch wide by construction
        aidx = applied[:, None] + 1 \
            + torch.arange(cfg.apply_batch, dtype=I32, device=dev)[None]
        avals = log_data.gather(1, _slot(cfg, aidx))
        chk = torch.where(aidx <= new_applied[:, None],
                          _entry_chk(aidx, avals), 0)
    else:
        own_idx = _idx_at_slots(cfg, last)
        app_mask = (own_idx > applied[:, None]) \
            & (own_idx <= new_applied[:, None])
        chk = torch.where(app_mask, _entry_chk(own_idx, log_data), 0)
    apply_chk = u32.to_bits(u32.unsigned(apply_chk) + u32.wrap_sum(chk, 1))
    applied = new_applied

    # ---- Phase F: compaction (ring-pressure driven) ----------------------
    pressure = (last - snap_idx) > (L - 2 * cfg.max_props - 1)
    new_snap = torch.maximum(snap_idx, applied - cfg.keep)
    do_compact = pressure & (new_snap > snap_idx) & alive
    nst = _term_own(cfg, log_term, snap_idx, snap_term, last, new_snap)
    if cfg.tiled:
        # (new_snap, applied] is at most `keep` wide by construction
        fidx = new_snap[:, None] + 1 \
            + torch.arange(max(cfg.keep, 1), dtype=I32, device=dev)[None]
        fvals = log_data.gather(1, _slot(cfg, fidx))
        ahead = torch.where(fidx <= applied[:, None],
                            _entry_chk(fidx, fvals), 0)
    else:
        own_idx = _idx_at_slots(cfg, last)
        ahead = torch.where((own_idx > new_snap[:, None])
                            & (own_idx <= applied[:, None]),
                            _entry_chk(own_idx, log_data), 0)
    nsc = u32.to_bits(u32.unsigned(apply_chk) - u32.wrap_sum(ahead, 1))
    snap_term = torch.where(do_compact, nst, snap_term)
    snap_chk = torch.where(do_compact, nsc, snap_chk)
    snap_idx = torch.where(do_compact, new_snap, snap_idx)

    # invariants: pre/tx_cand mark live candidacies only; transferee only
    # means anything on a standing leader
    pre = pre & (role == CANDIDATE)
    tx_cand = tx_cand & (role == CANDIDATE) & ~pre
    transferee = torch.where(role == LEADER, transferee, NONE)

    stats = state.stats
    if cfg.collect_stats and stats is not None:
        inc = torch.stack([
            (campaign | tn_ok).sum(), win.sum(),
            (commit - state.commit).to(torch.int64).sum(),
            (applied - state.applied).to(torch.int64).sum()])
        stats = u32.to_bits(stats.to(torch.int64) + inc)  # int32 wraparound

    return dataclasses.replace(
        state,
        term=term, vote=vote, role=role, lead=lead,
        elapsed=elapsed, contact=contact, hb_elapsed=hb_elapsed,
        timeout=timeout, last=last, commit=commit, applied=applied,
        snap_idx=snap_idx, snap_term=snap_term, snap_chk=snap_chk,
        apply_chk=apply_chk, log_term=log_term, log_data=log_data,
        match=match, next_=next_, granted=granted, rejected=rejected,
        recent_active=recent_active, pre=pre, transferee=transferee,
        tx_cand=tx_cand, tn_at=tn_at, tn_term=tn_term, tn_from=tn_from,
        pending_conf=pending_conf, tick=state.tick + 1, stats=stats)


def propose_dense(state: SimState, cfg: SimConfig,
                  payload_fn: Callable, count, alive=None,
                  device=None) -> SimState:
    """Append `count` device-generated entries payload_fn(tick, k) (k =
    0..count-1) to every row accepting proposals, as masked stores via the
    slot->index map (banded over the live chunks when cfg.tiled).  Writes
    the state's rings in place."""
    check_slice(cfg)
    check_device(state, device)
    count = int(count)
    ok = _leader_ok(state, cfg, alive)
    anchor = state.last + count

    def write(lt, ld, new_idx):
        k_of = new_idx - state.last[:, None] - 1
        valid = ok[:, None] & (k_of >= 0) & (k_of < count)
        pl = payload_fn(state.tick, torch.clamp(k_of, min=0).to(torch.int64))
        _put(lt, valid, state.term[:, None])
        _put(ld, valid, pl & PAYLOAD_MASK)

    lt, ld = state.log_term, state.log_data
    if cfg.tiled:
        lo_p, hi_p = torch.stack([
            torch.where(ok, state.last, BIG).amin(),
            torch.where(ok, anchor, 0).amax()]).tolist()
        c0p, nch_p = _band_origin(cfg, lo_p, hi_p)
        if nch_p <= cfg.band_chunks:
            C = cfg.log_chunk
            for off in _band_offsets(cfg, c0p):
                write(lt[:, off:off + C], ld[:, off:off + C],
                      _idx_at_band(cfg, anchor, off))
        else:
            write(lt, ld, _idx_at_slots(cfg, anchor))
    else:
        write(lt, ld, _idx_at_slots(cfg, anchor))
    new_last = state.last + torch.where(ok, count, 0).to(I32)
    eye = torch.eye(cfg.n, dtype=torch.bool, device=lt.device)
    match = torch.where(ok[:, None] & eye, new_last[:, None], state.match)
    return dataclasses.replace(state, last=new_last, match=match)


def transfer_leadership(state: SimState, cfg: SimConfig, leader: int,
                        target: int) -> SimState:
    """Host-side transfer request: records `target` on the leader's row and
    resets its election timer; the tick fires TIMEOUT_NOW once the target's
    log caught up.  A repeat request for the same in-flight target is a
    no-op; a different target replaces the previous transfer."""
    leader, target = int(leader), int(target)
    is_l = (state.role[leader] == LEADER) & (target != leader) \
        & state.member[leader, target]
    if cfg.transfer_cooldown_ticks > 0 and state.tx_cool is not None:
        is_l = is_l & (state.tx_cool[leader] == 0)
    changed = is_l & (state.transferee[leader] != target)
    row = torch.arange(cfg.n, device=state.term.device) == leader
    return dataclasses.replace(
        state,
        transferee=torch.where(row & changed, target, state.transferee),
        elapsed=torch.where(row & changed, 0, state.elapsed))
