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

Two wires share the delivery path, as in the JAX package: the
tick-synchronous wire (cfg.latency == 0) and the device-mailbox wire
(cfg.mailboxes), whose per-edge in-flight slots hold vote requests and
responses, a K-deep append pipeline (cfg.inflight), snapshot slots,
heartbeats with their responses and append acks, each delivered after its
edge's latency plus hash jitter.  PreVote (cfg.pre_vote) and log-driven
membership (static_members=False: CONF entries flip each row's view of
`member` at its own apply point; every quorum counts over the deciding
row's view) are implemented too, with the host `propose` / `propose_conf`
APIs.  So are the read path (phases R0-R2: batched ReadIndex, tick-clock
leases and follower reads, raft/read/), the vote guard, transfer cooldown
and the storage model (the fsync round, durable-watermark ack gating, the
leader's self-ack cap, the mailbox wire's durable-frontier ack).  Every one
of these is Python-gated exactly as in JAX, so the bench headline (sync
wire, static members, every lever off) runs the same ops as before.  So
are the three device observability planes at the end of the tick, in
JAX's order: trace tags (cfg.trace_tags: a host tag per propose batch and
read batch, carried to the commit and serve events), the flight recorder
(cfg.record_events: coded events appended to a per-row ring) and
telemetry (cfg.collect_telemetry: latency histograms and a strided series
ring); flightrec/codes.py and telemetry/series.py own their layouts.

As in the JAX package, the per-peer progress work runs in two segments,
`_progress_a` (Phase A's matrix tail, Phase B, Phase C's send/deliver half)
and `_progress_b` (ack folds, progress integration, transfer completion,
the Phase D bisect), each instantiated on a `_Rows`: all n rows (the dense
code, op for op) or, under role-sparse progress, an [A, N] slab of the
active rows, with the dense rows as the fallback when more rows are active
than the slab holds.  JAX picks the branch on the device with lax.cond;
here the choice is a host `if`, and the slab's fit is read back in the same
device->host read as the tiled ring write's band probe, so a steady tick
still syncs once (see `step`).

The ring buffers are written IN PLACE: `step` and `propose_dense` consume
the `log_term`/`log_data` tensors of the state they are given (the
returned state holds the same storage), and a tick on the slab merges its
rows back into the given state's progress matrices (match, next_, granted,
rejected, recent_active) in place too; so are the planes' rings (the
event ring and the propose-batch stamps, which `propose` writes too).
Callers that keep an old state clone it first.  Every ring read of a tick
happens before that tick's ring write, which is what the JAX package's
functional update gives for free.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from swarmkit_tpu_torch.flightrec import codes as fc
from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.raft import read as rd
from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.raft.sim.batch import NOBATCH, Bx
from swarmkit_tpu_torch.raft.sim.state import (
    CANDIDATE, CONF_REMOVE, CONF_TARGET_MASK, FOLLOWER, LEADER, NONE,
    SimConfig, SimState, batch_size, check_device, conf_payload,
    latency_at, rand_timeout,
)
from swarmkit_tpu_torch.telemetry import series as ts

I32 = torch.int32
BIG = 2 ** 31 - 1            # int32 max: the "no index" sentinel of min folds
PAYLOAD_MASK = 0x7FFF_FFFF   # bit 31 of a payload is reserved for conf tags
SNAP_POISON = 0xBAD5_EED5 - 2 ** 32   # int32 bits XORed into a corrupt image

# Host-side counts of the tick's control flow (reset_counts() zeroes them):
# device->host read-backs made by `step` and `propose_dense`, and, under
# role-sparse progress, the ticks whose progress segments ran on the slab
# and those that fell back to the dense rows.
COUNTS: dict[str, int] = {"host_syncs": 0, "slab_ticks": 0,
                          "dense_fallback_ticks": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# Profiler ranges over the tick's phases, named as the JAX package's
# named_scope seams (tools/profile_tick.py turns them on to split device
# time by phase).  Off, they cost no launch and no range.
PHASE_RANGES = False


class _Phases:
    """Closes the open phase range and opens the next (`name` None closes
    the last); a no-op unless PHASE_RANGES."""

    def __init__(self):
        self.cur = None

    def __call__(self, name: Optional[str] = None) -> None:
        if not PHASE_RANGES:
            return
        if self.cur is not None:
            self.cur.__exit__(None, None, None)
            self.cur = None
        if name is not None:
            self.cur = torch.profiler.record_function(name)
            self.cur.__enter__()


# [K] int32 event codes of the recorder's emit lists, per device: built once
# (a host->device copy), so a recording tick makes none
_CODES: dict = {}


def _codes_on(dev, codes: tuple) -> torch.Tensor:
    key = (str(dev), codes)
    if key not in _CODES:
        _CODES[key] = torch.tensor(codes, dtype=I32).to(dev)
    return _CODES[key]


def _read_back(xs: list) -> list:
    """Scalar tensors to host ints in one device->host read (one sync)."""
    COUNTS["host_syncs"] += 1
    return torch.stack([x.to(torch.int64) for x in xs]).tolist()


def read_many(xs: list) -> list:
    """Integer or bool tensors of one device to host int64 arrays of their
    own shapes, in one device->host read (the host planes' scrapes and
    the oracle replay's views; not a step sync)."""
    flat = torch.cat([x.reshape(-1).to(torch.int64) for x in xs]) \
        .cpu().numpy()
    sizes = np.cumsum([x.numel() for x in xs])[:-1]
    return [a.reshape(x.shape) for a, x in zip(np.split(flat, sizes), xs)]


# ---- index helpers ---------------------------------------------------------


def _refuse_batched(cfg: SimConfig, what: str) -> None:
    """Raise for a lever or plane the batched tick does not run yet, naming
    its ROADMAP item: never a silent fallback."""
    item = "ROADMAP Queue 1 #1"
    refused = [
        (cfg.tiled, f"cfg.tiled (the banded log: append_band_copy over "
                    f"[B*N, L] rows with a batch-wide band, {item})"),
        (cfg.peer_tiled, f"cfg.peer_tiled (banded peer counts under a "
                         f"batch axis, {item})"),
        (cfg.active_rows_on, f"cfg.active_rows_on (the role-sparse slab "
                             f"with [B, A] row ids, {item})"),
        (cfg.record_events, f"cfg.record_events (the flight recorder under "
                            f"a batch axis, {item}; capture_flight re-runs "
                            f"one schedule unbatched)"),
        (cfg.trace_tags, f"cfg.trace_tags (trace tags under a batch axis, "
                         f"{item})")]
    for on, name in refused:
        if on:
            raise ValueError(f"{what} on a batched state does not run "
                             f"{name}; use an unbatched state")


def _stamp_batch(state: SimState, cfg: SimConfig, ok: torch.Tensor,
                 first: torch.Tensor, count, tag, bx: Bx = NOBATCH) -> None:
    """The telemetry record of one propose batch at the state's tick, in
    place: its first index, its count and the tick (NONE/0 on rows that
    took no batch), and the batch's trace tag under cfg.trace_tags (0 when
    `tag` is None).  `count` is an int, or a per-cluster tensor shaped
    against [N]."""
    col = torch.remainder(state.tick, state.tel_prop_idx.shape[-1])
    ts.col_set(state.tel_prop_idx, col, torch.where(ok, first, NONE))
    ts.col_set(state.tel_prop_cnt, col, torch.where(ok, count, 0))
    ts.col_set(state.tel_prop_tick, col,
               torch.where(ok, bx.t(state.tick, 1), NONE))
    if cfg.trace_tags and state.tel_prop_tag is not None:
        ts.col_set(state.tel_prop_tag, col,
                   torch.where(ok, 0 if tag is None else int(tag), 0))


def _slot(cfg: SimConfig, idx: torch.Tensor) -> torch.Tensor:
    """Ring slot (int64, for indexing) of 1-based log index (idx<=0 -> 0)."""
    return torch.remainder(torch.clamp(idx, min=1) - 1,
                           cfg.log_len).to(torch.int64)


def _idx_at_slots(cfg: SimConfig, last: torch.Tensor,
                  bx: Bx = NOBATCH) -> torch.Tensor:
    """[N, L] log index stored at each ring slot, anchored at `last` [N]:
    the unique idx in (last - L, last] with (idx-1) % L == slot (floor
    modulo, as in the JAX package)."""
    s = torch.arange(cfg.log_len, dtype=I32, device=last.device)[None, :]
    a = bx.col(last)
    return a - torch.remainder(a - (s + 1), cfg.log_len)


def _idx_at_band(cfg: SimConfig, anchor: torch.Tensor,
                 off: int) -> torch.Tensor:
    """[N, log_chunk] analog of _idx_at_slots for the chunk at slot `off`."""
    s = (off + torch.arange(cfg.log_chunk, dtype=I32,
                            device=anchor.device))[None, :]
    a = anchor[:, None]
    return a - torch.remainder(a - (s + 1), cfg.log_len)


def _term_own(cfg, log_term, snap_idx, snap_term, last, idx,
              bx: Bx = NOBATCH):
    """Per-row own-log term lookup for [N] idx (one element per row)."""
    ring = bx.pick(log_term, _slot(cfg, idx))
    in_ring = (idx > snap_idx) & (idx <= last)
    return torch.where(idx == snap_idx, snap_term,
                       torch.where(in_ring, ring, 0))


def _is_conf(data: torch.Tensor) -> torch.Tensor:
    """Conf-change entries carry CONF_TAG, bit 31: a negative int32."""
    return data < 0


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


def _pcount(cfg: SimConfig, band: Callable, banded: bool,
            mem: Optional[torch.Tensor] = None, dim: int = 1) -> torch.Tensor:
    """Per-row int32 count of the peers j where `band(j0, w)`, the [R, w]
    predicate over columns [j0, j0 + w), is true; with `mem` (the [R, N]
    membership views of the deciding rows) only peers in the row's view
    count, the view folded into each band.

    One pass over all n columns; or, when `banded`, one [R, peer_chunk]
    column band at a time with the band counts summed, so no temporary is
    wider than peer_chunk (the JAX package's _pcount, whose fori_loop over
    bands is a Python loop over column views here).  Integer sums commute:
    both forms give the same bits.  `dim` is the peer axis: 2 under a
    batch axis, where only the one-pass form runs (its band (0, n) slices
    nothing off the row axis that `[:, j0:j0 + w]` then names)."""
    if mem is not None:
        pred = band

        def band(j0, w):
            return pred(j0, w) & mem[:, j0:j0 + w]
    if not banded:
        return _count(band(0, cfg.n), dim)
    pc = cfg.peer_chunk
    total = _count(band(0, pc), 1)
    for j0 in range(pc, cfg.n, pc):
        total = total + _count(band(j0, pc), 1)
    return total


class _Rows:
    """The rows one progress segment runs on (the JAX package's _slabify).

    Dense (`idx` None): all n rows, and every helper is the identity, so a
    segment instantiated on it is the dense code op for op; its peer counts
    go band by band under cfg.peer_tiled.  Sparse: `idx`, the [A] int64 ids
    of the slab's rows (active rows first, ascending); row-indexed operands
    are gathered into [A, N] slabs, and the slab's peer counts take one pass
    (an [A, N] temporary is no wider than peer_chunk rows of n columns)."""

    def __init__(self, cfg: SimConfig, node: torch.Tensor, eye: torch.Tensor,
                 drop: torch.Tensor, drop_t: torch.Tensor,
                 member: torch.Tensor, now: torch.Tensor,
                 idx: Optional[torch.Tensor] = None, bx: Bx = NOBATCH):
        self.cfg, self.n, self.node, self.now = cfg, cfg.n, node, now
        self.bx = bx
        self.dense = idx is None
        self.banded = cfg.peer_tiled and self.dense
        self.idx = idx
        self._lat = None
        if self.dense:
            self.ids, self.eye, self.drop, self.drop_t = node, eye, drop, drop_t
        else:
            self.ids = idx.to(I32)
            self.eye = self.ids[:, None] == node[None, :]
            # drop_t[idx] is drop[:, idx].T, gathered as contiguous rows
            self.drop, self.drop_t = drop[idx], drop_t[idx]
        self.set_member(member)

    def set_member(self, member: torch.Tensor) -> None:
        """The segment's rows of the membership views (None under static
        membership, where every view is all rows and folds away)."""
        self.member_r = None if self.cfg.static_members else self.g(member)

    def mview(self, x: torch.Tensor) -> torch.Tensor:
        """Mask a segment matrix by the deciding rows' views."""
        return x if self.member_r is None else x & self.member_r

    def count(self, band: Callable) -> torch.Tensor:
        """_pcount over the segment's rows, in their views."""
        return _pcount(self.cfg, band, self.banded, self.member_r,
                       self.bx.d(1))

    def lat(self) -> tuple:
        """(lat, lat_T): the latency of this tick's sends from and to the
        segment's rows, [R, N] (latency_matrix and its transpose, rebuilt
        for the slab's rows); computed once per segment instance."""
        if self._lat is None:
            cfg, now, node = self.cfg, self.now, self.node
            if self.dense:
                bx = self.bx
                lat = latency_at(cfg, bx.t(now, 2), node[:, None],
                                 node[None, :])
                if bx.on:
                    lat = lat.expand(bx.B, self.n, self.n)
                self._lat = (lat, bx.T(lat))
            else:
                self._lat = (latency_at(cfg, now, self.ids[:, None],
                                        node[None, :]),
                             latency_at(cfg, now, node[None, :],
                                        self.ids[:, None]))
        return self._lat

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """The segment's rows of a row-indexed [N], [N, N] or [N, N, K]
        operand."""
        return x if self.dense else x[self.idx]

    def merge(self, full: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """A segment's matrix output as the full [N, N(, K)] tensor: the
        slab's rows are written into `full` in place (the dense output
        already is the full tensor)."""
        return rows if self.dense else full.index_copy_(0, self.idx, rows)

    def sfull(self, vals: torch.Tensor, fill) -> torch.Tensor:
        """A per-row [R] result at [N]: `fill` lands on the rows outside the
        slab, whose consumers are role-gated off."""
        if self.dense:
            return vals
        base = torch.full((self.n,), fill, dtype=vals.dtype,
                          device=vals.device)
        return base.index_copy_(0, self.idx, vals)

    def row_of(self, sel: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """Row id of the segment position `sel` (a _first_true over the row
        axis), 0 where `gate` is False, as the dense first-true gives."""
        if self.dense:
            return sel
        return torch.where(gate, self.ids[sel.to(torch.int64)], 0)

    def eye_cols(self, j0: int, w: int) -> torch.Tensor:
        """Columns [j0, j0 + w) of the segment's rows of the identity."""
        if w == self.n:
            return self.eye
        cols = torch.arange(j0, j0 + w, dtype=I32, device=self.ids.device)
        return self.ids[:, None] == cols[None, :]


def _leader_ok(state: SimState, cfg: SimConfig,
               alive: Optional[torch.Tensor] = None,
               bx: Bx = NOBATCH) -> torch.Tensor:
    """Rows that accept proposals: leaders in their own applied config, with
    ring room and no transfer in flight (and alive, when given)."""
    is_leader = (state.role == LEADER) & bx.diag(state.member)
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
         prop_tag=None,
         device=None) -> SimState:
    """Advance every simulated manager by one tick.

    alive: [N] bool — False rows are crashed (frozen, no send/receive).
    drop:  [N, N] bool — drop[i, j] drops all i->j traffic this tick.
    A state whose fields carry a leading batch axis ([B, N], [B, N, N],
    ..., tick [B]) advances B independent clusters, as the JAX package's
    jax.vmap(step) does, with alive [B, N] and drop [B, N, N]; every value
    reduction stays inside its cluster.  The batched tick runs the untiled
    dense configurations (either wire, PreVote, both membership modes,
    the fused propose, reads, vote guard, cooldown, storage, telemetry)
    and refuses the tiled log, banded peers, the progress slab, the flight
    recorder and trace tags with a ValueError; it reads nothing back.
    prop_count/payload_fn: the fused dense propose — bit-identical to
    ``step(propose_dense(state, cfg, payload_fn, prop_count, alive), ...)``
    with the proposal ring stores folded into Phase C's ring write.
    prop_count is an int, or a device tensor that is never read back: 0-d,
    or [B] on a batched state, one count per cluster (the multi-raft
    plane's per-group counts).
    payload_fn(tick, k) maps the tick and the int64 batch positions k to
    uint32 payload bits (run._payload_at).
    prop_tag: an int host trace tag of the fused propose batch
    (cfg.trace_tags; metrics/trace.py span_trace_tag), carried to the
    COMMIT_ADVANCE event that commits it.  Ignored with trace tags off.

    Runs on `device` (the CUDA card unless the caller names another) and
    consumes the state's ring buffers and, on a slab tick, its progress
    matrices (see the module docstring).

    Host syncs: where the JAX package branches on the device with lax.cond,
    the port reads a few scalars back and branches on the host.  A tiled
    config reads the band of this tick's ring writes (one sync).  Under
    role-sparse progress the first segment runs on the slab speculatively
    (it writes nothing in place), and whether the active rows fit the slab
    rides the same read-back; only on a tick where they do not (an election
    storm) is the segment recomputed on the dense rows and the band read
    again.  An untiled sparse config reads the fit alone before the
    segment.  Under dynamic membership a tiled config also picks the
    end-of-tick conf-gate scan's band from that same read (a superset of
    the band JAX computes at the end of the tick; see the probe), so the
    mailbox wire, PreVote and membership add no sync.  COUNTS records the
    syncs and the branch taken.
    """
    dev = check_device(state, device)
    phase = _Phases()
    n, L, W = cfg.n, cfg.log_len, cfg.window
    bx = Bx(batch_size(state))
    if bx.on:
        _refuse_batched(cfg, "step")
    lead_shape = (bx.B,) if bx.on else ()
    node_l = torch.arange(n, device=dev)
    node = node_l.to(I32)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    if alive is None:
        alive = torch.ones(lead_shape + (n,), dtype=torch.bool, device=dev)
    drop_given = drop is not None
    if drop is None:
        drop = torch.zeros(lead_shape + (n, n), dtype=torch.bool, device=dev)
    drop_t = bx.T(drop)

    term, vote, role, lead = state.term, state.vote, state.role, state.lead
    elapsed, hb_elapsed = state.elapsed, state.hb_elapsed
    timeout = state.timeout
    last, commit, applied = state.last, state.commit, state.applied
    snap_idx, snap_term = state.snap_idx, state.snap_term
    snap_chk, apply_chk = state.snap_chk, state.apply_chk
    log_term, log_data = state.log_term, state.log_data
    pre = state.pre
    pending_conf = state.pending_conf
    now = state.tick
    # the tick against [N], [N, N] and [N, N, K] operands (all `now` when
    # unbatched)
    now1, now2, now3 = bx.t(now, 1), bx.t(now, 2), bx.t(now, 3)

    # Fused dense propose: cursor effects now, ring stores in Phase C's
    # ring write, the match-diagonal bump in the first progress segment.
    # Rows are judged on the pre-tick state.
    fused_prop = payload_fn is not None
    if fused_prop:
        prop_ok = _leader_ok(state, cfg, alive, bx)
        if isinstance(prop_count, torch.Tensor):
            # a device count, 0-d or per cluster [B]: never read back
            pc = prop_count.to(I32)
            if bx.on:
                pc = pc.reshape(-1).expand(bx.B)
            prop_cnt, prop_cnt2 = bx.t(pc, 1), bx.t(pc, 2)
        else:
            prop_cnt = prop_cnt2 = int(prop_count)
        prop_last0 = last
        prop_anchor = prop_last0 + prop_cnt
        last = last + torch.where(prop_ok, prop_cnt, 0).to(I32)

    # Per-row membership views: every quorum counts over the deciding row's
    # applied configuration.  Under static membership every view is all
    # rows and the quorum a constant, and every view mask folds away.
    static_m = cfg.static_members
    mail = cfg.mailboxes
    member = state.member
    if static_m:
        self_mem = torch.ones((n,), dtype=torch.bool, device=dev)
        quorum = n // 2 + 1
    else:
        self_mem = bx.diag(member)
        quorum = member.sum(bx.d(1), dtype=I32) // 2 + 1         # [N]

    # ---- Phase R0: read-batch submit -------------------------------------
    # idle rows take a fresh batch whose goal is the pre-tick max(commit)
    reads_on = cfg.read_batch > 0
    if reads_on:
        phase("phase_R0_submit")
        read_regs = rd.submit(cfg, rd.regs_from_state(state), alive, commit,
                              bx=bx)

    # ---- Phase A: timers ----------------------------------------------
    phase("phase_A_timers")
    is_leader = (role == LEADER) & alive
    elapsed = torch.where(alive, elapsed + 1, elapsed)
    contact = torch.where(alive, state.contact + 1, state.contact)
    hb_elapsed = torch.where(is_leader, hb_elapsed + 1, hb_elapsed)
    # transfer cooldown: count down here; it re-arms after the second
    # progress segment on the row whose TIMEOUT_NOW fired
    tx_cool = None
    if cfg.transfer_cooldown_ticks > 0 and state.tx_cool is not None:
        tx_cool = torch.clamp(state.tx_cool - 1, min=0)

    # ---- storage model: the fsync round -----------------------------------
    # The durable watermark chases the pre-tick last (state.last, before
    # the fused propose's bump above), on cadence ticks only, at most
    # fsync_batch entries a round (0 = unlimited), frozen on crashed rows
    # and stalled disks.  Vote records are write-through instead (a
    # stalled disk refuses grants in Phase B).
    storage_on = cfg.storage_on and state.sync_mark is not None
    gated = storage_on and cfg.ack_gating
    if storage_on:
        phase("phase_A_fsync")
        fs_due = torch.remainder(now1, cfg.fsync_lag_ticks) \
            == cfg.fsync_lag_ticks - 1
        sync_inc = torch.clamp(state.last - state.sync_mark, min=0)
        if cfg.fsync_batch > 0:
            sync_inc = torch.clamp(sync_inc, max=cfg.fsync_batch)
        fsync_did = alive & ~state.fsync_stall & fs_due
        sync_mark = state.sync_mark + torch.where(fsync_did, sync_inc, 0)

    phase("phases_ABC_progress")
    # last/last_term are read before anything appends this tick (above the
    # progress segments, which read no ring); a proposing row's new last
    # entry carries its own pre-tick term
    last_term = _term_own(cfg, log_term, snap_idx, snap_term, last, last, bx)
    if fused_prop and isinstance(prop_cnt, torch.Tensor):
        last_term = torch.where(prop_ok & (prop_cnt > 0), state.term,
                                last_term)
    elif fused_prop and prop_cnt > 0:
        last_term = torch.where(prop_ok, state.term, last_term)

    # ---- role-sparse progress: the active-row set ------------------------
    # A superset of the rows that can mutate their progress row this tick,
    # taken before any of its role changes: leaders and candidates, rows
    # whose election timer is due, TIMEOUT_NOW targets, and rows still in
    # their active_ttl drain window.  The stable sort of an integer key
    # puts the active rows first in ascending order, so slab tie-breaks
    # (lowest row wins) match the dense ones.
    sparse_on = cfg.active_rows_on
    dense_rows = _Rows(cfg, node, eye, drop, drop_t, member, now, bx=bx)
    if sparse_on:
        sp_act = (role != FOLLOWER) | (state.active_ttl > 0) \
            | (alive & self_mem & (elapsed >= timeout)) | (state.tn_at > 0)
        # a host decision (refused under a batch axis, as is the slab)
        sp_fits = sp_act.sum(dtype=I32) <= cfg.active_rows
        sp_rows = torch.argsort((~sp_act).to(I32),
                                stable=True)[:cfg.active_rows]
        slab_rows = _Rows(cfg, node, eye, drop, drop_t, member, now,
                          sp_rows)

    def _progress_a(sl: _Rows, term=term, vote=vote, role=role, lead=lead,
                    elapsed=elapsed, contact=contact, timeout=timeout,
                    pre=pre, last=last, commit=commit, is_leader=is_leader,
                    hb_elapsed=hb_elapsed, pending_conf=pending_conf):
        """Progress segment 1: Phase A's matrix tail (CheckQuorum count,
        campaign tally resets), Phase B and Phase C's send/deliver half, on
        the rows `sl`.  [N] vector logic runs at full width either way;
        only row-indexed matrices go through `sl`.  Sender-axis reductions
        are exact on the slab because every sender row is active and
        padding rows reduce at the identity under the same role masks.
        Returns [N] vectors and the segment's matrices and mailbox slots
        (slabs on a slab); writes nothing in place."""
        g, eye_r = sl.g, sl.eye
        out = {}
        match, next_ = g(state.match), g(state.next_)
        granted, rejected = g(state.granted), g(state.rejected)
        recent_active = g(state.recent_active)
        if fused_prop:
            match = torch.where(bx.col(g(prop_ok)) & eye_r,
                                bx.col(g(last)), match)
        vguard = cfg.has_vote_guard
        if vguard:
            # the persisted-vote guard: a durable (term, candidate) record
            # written beside every vote assignment, which a wipe of `vote`
            # does not reach (redundant, so bit-identical, on stock runs)
            vg_vote, vg_term = state.vg_vote, state.vg_term

        # CheckQuorum: every election_tick a leader confirms it heard from
        # a quorum since the last round, else steps down
        check_due = is_leader & (elapsed >= cfg.election_tick)
        if cfg.check_quorum:
            n_heard = sl.sfull(sl.count(
                lambda j0, w: recent_active[:, j0:j0 + w]
                | sl.eye_cols(j0, w)), 0)
            cq_fail = check_due & (n_heard < quorum)
            role = torch.where(cq_fail, FOLLOWER, role)
            lead = torch.where(cq_fail, NONE, lead)
            contact = torch.where(check_due & ~cq_fail, 0, contact)
            recent_active = torch.where(bx.col(g(check_due)), False,
                                        recent_active)
        elapsed = torch.where(check_due, 0, elapsed)
        is_leader = (role == LEADER) & alive
        # a transfer not completed within an election timeout is aborted
        transferee = torch.where(check_due, NONE, state.transferee)
        transferee = torch.where(role != LEADER, NONE, transferee)

        # TIMEOUT_NOW delivery: the transfer target campaigns immediately
        tx_cand = state.tx_cand
        tn_at, tn_term, tn_from = state.tn_at, state.tn_term, state.tn_from
        tn_due = (tn_at > 0) & (now1 + 1 >= tn_at)
        tn_ok = tn_due & alive & self_mem & (role != LEADER) \
            & (tn_term >= term) & ((role == FOLLOWER) | (tn_term > term))
        term = torch.where(tn_ok & (tn_term > term), tn_term, term)
        tn_at = torch.where(tn_due, 0, tn_at)

        # election timeouts -> campaigns; the HUP step refuses to campaign
        # while a conf entry sits committed but unapplied (hup_conf, the
        # previous tick's end scan; all-False under static membership)
        want_campaign = (alive & self_mem & (role != LEADER)
                         & (elapsed >= timeout)) & ~tn_ok
        elapsed = torch.where(want_campaign, 0, elapsed)
        campaign = want_campaign & ~state.hup_conf
        if cfg.pre_vote:
            # becomePreCandidate: a non-binding poll, no term bump, no vote
            # change, the known leader kept; only the tallies reset
            pre = torch.where(campaign, True, pre)
            role = torch.where(campaign, CANDIDATE, role)
        else:
            term = term + campaign.to(I32)
            vote = torch.where(campaign, node, vote)
            if vguard:
                vg_vote = torch.where(campaign, node, vg_vote)
                vg_term = torch.where(campaign, term, vg_term)
            role = torch.where(campaign, CANDIDATE, role)
            lead = torch.where(campaign, NONE, lead)
            timeout = torch.where(campaign, rand_timeout(cfg, node, term),
                                  timeout)
        granted = torch.where(bx.col(g(campaign)), eye_r, granted)
        rejected = torch.where(bx.col(g(campaign)), False, rejected)
        tx_cand = tx_cand & ~campaign
        # forced (transfer) campaign
        term = term + tn_ok.to(I32)
        vote = torch.where(tn_ok, node, vote)
        if vguard:
            vg_vote = torch.where(tn_ok, node, vg_vote)
            vg_term = torch.where(tn_ok, term, vg_term)
        role = torch.where(tn_ok, CANDIDATE, role)
        pre = pre & ~tn_ok
        lead = torch.where(tn_ok, NONE, lead)
        elapsed = torch.where(tn_ok, 0, elapsed)
        timeout = torch.where(tn_ok, rand_timeout(cfg, node, term), timeout)
        granted = torch.where(bx.col(g(tn_ok)), eye_r, granted)
        rejected = torch.where(bx.col(g(tn_ok)), False, rejected)
        tx_cand = torch.where(tn_ok, True, tx_cand)

        # ---- Phase B: vote exchange -------------------------------------
        is_cand = (role == CANDIDATE) & alive
        if cfg.check_quorum:
            # leader lease: a receiver in contact with a live leader
            # ignores vote requests (unless the candidacy is a forced
            # transfer)
            leased = (lead != NONE) & (contact < cfg.election_tick)
        else:
            leased = torch.zeros(lead_shape + (n,), dtype=torch.bool,
                                 device=dev)
        if mail:
            # Device-mailbox wire: one in-flight message per class per
            # directed edge; *_at stores the deliver tick + 1 (0 = empty).
            # Drops act at send, the receiver's guards at delivery.
            lat, lat_T = sl.lat()
            vreq_at, vreq_term = g(state.vreq_at), g(state.vreq_term)
            vreq_pre = g(state.vreq_pre)
            vresp_at, vresp_term = g(state.vresp_at), g(state.vresp_term)
            vresp_grant, vresp_pre = g(state.vresp_grant), g(state.vresp_pre)
            term_r, pre_r = bx.col(g(term)), bx.col(g(pre))
            # candidates (re-)request on every edge with no message of the
            # same candidacy (term, pre) in flight, to peers in their view
            free = (vreq_at == 0) | (vreq_term != term_r) \
                | (vreq_pre != pre_r)
            send_vr = sl.mview(bx.col(g(is_cand)) & ~eye_r & ~sl.drop
                               & free)
            vreq_at = torch.where(send_vr, now2 + 1 + lat, vreq_at)
            vreq_term = torch.where(send_vr, term_r, vreq_term)
            vreq_pre = torch.where(send_vr, pre_r, vreq_pre)
            # deliveries: a request whose sender left the captured
            # candidacy vanishes
            due_vr = (vreq_at > 0) & (now2 + 1 >= vreq_at)
            deliv = due_vr & (bx.col(g(role)) == CANDIDATE) \
                & (term_r == vreq_term) & (pre_r == vreq_pre) \
                & bx.row(alive) & (~bx.row(leased) | bx.col(g(tx_cand)))
            req = deliv & ~pre_r
            preq = deliv & pre_r
            vreq_at = torch.where(due_vr, 0, vreq_at)
        else:
            base_req = sl.mview(
                bx.col(g(is_cand)) & bx.row(alive) & ~eye_r & ~sl.drop
                & (~bx.row(leased) | bx.col(g(tx_cand))))
            req = base_req & ~bx.col(g(pre))
            if cfg.pre_vote:
                preq = base_req & bx.col(g(pre))
        lt_i, lt_j = bx.col(g(last_term)), bx.row(last_term)
        log_ok = (lt_i > lt_j) \
            | ((lt_i == lt_j) & (bx.col(g(last)) >= bx.row(last)))

        if cfg.pre_vote:
            # PreVote exchange, before the real votes, against the
            # receiver's pre-catch-up state; a grant changes nothing on the
            # receiver
            term_r = bx.col(g(term))
            pv_term = torch.where(preq, term_r + 1, -1)          # msg term
            pv_cur = preq & (pv_term >= bx.row(term))
            pv_can = (bx.row(vote) == NONE) | (pv_term > bx.row(term)) \
                | (bx.row(vote) == sl.ids[:, None])
            pv_grant = pv_cur & pv_can & log_ok
            # a rejection counts only at the candidacy's own term
            pv_reject = pv_cur & ~pv_grant & (bx.row(term) == term_r)
            pre_cand = is_cand & pre
            if mail:
                send_pv = (pv_grant | pv_reject) & ~sl.drop_t
                vresp_at = torch.where(send_pv, now2 + 1 + lat_T, vresp_at)
                vresp_term = torch.where(send_pv, term_r, vresp_term)
                vresp_pre = torch.where(send_pv, True, vresp_pre)
                vresp_grant = torch.where(send_pv, pv_grant, vresp_grant)
                due_pv = (vresp_at > 0) & (now2 + 1 >= vresp_at) & vresp_pre
                rv_pv = due_pv & bx.col(g(pre_cand)) \
                    & (term_r == vresp_term)
                granted = granted | (rv_pv & vresp_grant)
                rejected = rejected | (rv_pv & ~vresp_grant)
                vresp_at = torch.where(due_pv, 0, vresp_at)
                pv_polled = sl.sfull(rv_pv.any(bx.d(1)), False)
            else:
                pv_arrive = ~sl.drop_t & bx.col(g(pre_cand))
                granted = granted | (pv_grant & pv_arrive)
                rejected = rejected | (pv_reject & pv_arrive)
                pv_polled = sl.sfull(((pv_grant | pv_reject) & pv_arrive)
                                     .any(bx.d(1)), False)
            # pre-quorum -> the real campaign, on poll events only
            votes_pv = sl.sfull(sl.count(
                lambda j0, w: granted[:, j0:j0 + w]), 0)
            pre_win = pre_cand & (votes_pv >= quorum) \
                & (campaign | pv_polled)
            term = term + pre_win.to(I32)
            vote = torch.where(pre_win, node, vote)
            if vguard:
                vg_vote = torch.where(pre_win, node, vg_vote)
                vg_term = torch.where(pre_win, term, vg_term)
            pre = torch.where(pre_win, False, pre)
            lead = torch.where(pre_win, NONE, lead)
            elapsed = torch.where(pre_win, 0, elapsed)
            timeout = torch.where(pre_win, rand_timeout(cfg, node, term),
                                  timeout)
            granted = torch.where(bx.col(g(pre_win)), eye_r, granted)
            rejected = torch.where(bx.col(g(pre_win)), False, rejected)

        # receiver-side term catch-up
        req_term = torch.where(req, bx.col(g(term)), -1)
        mt = req_term.amax(bx.d(0))
        newer = mt > term
        term = torch.where(newer, mt, term)
        role = torch.where(newer, FOLLOWER, role)
        vote = torch.where(newer, NONE, vote)
        lead = torch.where(newer, NONE, lead)
        elapsed = torch.where(newer, 0, elapsed)
        timeout = torch.where(newer, rand_timeout(cfg, node, term), timeout)
        is_cand = (role == CANDIDATE) & alive

        can_vote = (bx.row(vote) == NONE) | (bx.row(vote) == sl.ids[:, None])
        if vguard:
            # a row that already voted this term re-grants only the same
            # candidate, whatever `vote` says
            can_vote = can_vote & ((bx.row(vg_term) < bx.row(term))
                                   | (bx.row(vg_vote) == sl.ids[:, None]))
        if gated:
            # a stalled disk cannot persist the vote record before replying,
            # so it refuses the grant (PreVote polls above stay un-gated)
            can_vote = can_vote & ~bx.row(state.fsync_stall)
        cur = req & (req_term == bx.row(term))   # requests at the rx term
        grantable = cur & can_vote & log_ok
        any_grant = grantable.any(bx.d(0))
        chosen_cand = sl.row_of(_first_true(grantable, bx.d(0)), any_grant)
        grant_mat = grantable & (sl.ids[:, None] == bx.row(chosen_cand))
        vote = torch.where(any_grant, chosen_cand, vote)
        if vguard:
            vg_vote = torch.where(any_grant, chosen_cand, vg_vote)
            vg_term = torch.where(any_grant, term, vg_term)
        elapsed = torch.where(any_grant, 0, elapsed)
        if mail:
            # responses ride the reverse edge; one already in flight there
            # is superseded
            send_vresp = cur & ~sl.drop_t
            vresp_at = torch.where(send_vresp, now2 + 1 + lat_T, vresp_at)
            vresp_term = torch.where(send_vresp, bx.row(term), vresp_term)
            vresp_pre = torch.where(send_vresp, False, vresp_pre)
            vresp_grant = torch.where(send_vresp, grant_mat, vresp_grant)
            due_vs = (vresp_at > 0) & (now2 + 1 >= vresp_at)
            rvalid = due_vs & bx.col(g(is_cand)) \
                & (bx.col(g(term)) == vresp_term) \
                & (bx.col(g(pre)) == vresp_pre)
            granted = granted | (rvalid & vresp_grant)
            rejected = rejected | (rvalid & ~vresp_grant)
            vresp_at = torch.where(due_vs, 0, vresp_at)
            polled = sl.sfull((rvalid & ~vresp_pre).any(bx.d(1)), False)
            out.update(vreq_at=vreq_at, vreq_term=vreq_term,
                       vreq_pre=vreq_pre, vresp_at=vresp_at,
                       vresp_term=vresp_term, vresp_grant=vresp_grant,
                       vresp_pre=vresp_pre)
        else:
            real_cand = is_cand & ~pre
            resp_arrive = grant_mat & ~sl.drop_t
            granted = granted | (resp_arrive & bx.col(g(real_cand)))
            reject_arrive = cur & ~grant_mat & ~sl.drop_t
            rejected = rejected | (reject_arrive & bx.col(g(real_cand)))
            polled = sl.sfull(((resp_arrive | reject_arrive)
                               & bx.col(g(real_cand))).any(bx.d(1)), False)

        # win/lose count only peers in the candidate's own view, and only
        # on poll events (candidacy start or a response arrival)
        if cfg.pre_vote:
            fresh_real = tn_ok | pre_win
            polled = polled | pv_polled
        else:
            fresh_real = tn_ok | campaign
        votes = sl.sfull(sl.count(lambda j0, w: granted[:, j0:j0 + w]), 0)
        win = is_cand & ~pre & (votes >= quorum) & (fresh_real | polled)
        n_rej = sl.sfull(sl.count(
            lambda j0, w: rejected[:, j0:j0 + w]
            & ~granted[:, j0:j0 + w]), 0)
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
        next_ = torch.where(bx.col(g(win)), bx.col(g(last) + 1), next_)
        match = torch.where(bx.col(g(win)), 0, match)
        recent_active = torch.where(bx.col(g(win)), eye_r, recent_active)
        if mail:
            # becomeLeader resets every Progress to StateProbe
            probing = torch.where(bx.col(g(win)), True, g(state.probing))
        noop_term = term   # the winner's candidacy term, captured here
        last = last + win.to(I32)
        is_leader = (role == LEADER) & alive
        match = torch.where(bx.col(g(win)) & eye_r, bx.col(g(last)), match)

        # ---- Phase C: append / snapshot fan-out ----------------------------
        if mail:
            K, kh_idx = cfg.inflight, torch.arange(
                cfg.ack_depth, dtype=I32, device=dev)[None, None]
            k_idx = torch.arange(K, dtype=I32, device=dev)[None, None]
            app_at, app_prev = g(state.app_at), g(state.app_prev)
            app_term_box = g(state.app_term)
            snp_at, snp_term_box = g(state.snp_at), g(state.snp_term)
            term_e = bx.col(g(term))           # sender term per edge
            term_k = bx.slot(term_e)           # per slot
            # sends: up to K appends pipeline per edge, one new message a
            # tick; replicate edges send only when there is content, probe
            # edges one (possibly empty) append at a time, and next_
            # advances optimistically in replicate state
            free_k = (app_at == 0) | (app_term_box != term_k)    # [R, N, K]
            any_free = free_k.any(bx.d(2))
            slot_sel = _first_true(free_k, bx.d(2))
            onehot = bx.slot(slot_sel) == k_idx
            inflight_same = ((app_at != 0)
                             & (app_term_box == term_k)).any(bx.d(2))
            snp_free = (snp_at == 0) | (snp_term_box != term_e)
            prev_send = next_ - 1
            can_ring_send = prev_send >= bx.col(g(snap_idx))
            has_new = next_ <= bx.col(g(last))
            send_base = sl.mview(bx.col(g(is_leader)) & ~eye_r & ~sl.drop) \
                & snp_free
            may = torch.where(probing, ~inflight_same, has_new)
            s_app = send_base & can_ring_send & any_free & may
            s_snp = send_base & ~can_ring_send
            put = bx.slot(s_app) & onehot
            app_at = torch.where(put, bx.slot(now2 + 1 + lat), app_at)
            app_prev = torch.where(put, bx.slot(prev_send), app_prev)
            app_term_box = torch.where(put, term_k, app_term_box)
            n_send = torch.clamp(bx.col(g(last)) - prev_send, 0, W)
            next_ = torch.where(s_app & has_new & ~probing, next_ + n_send,
                                next_)
            snp_at = torch.where(s_snp, now2 + 1 + lat, snp_at)
            snp_term_box = torch.where(s_snp, term_e, snp_term_box)

            # heartbeats every heartbeat_tick, carrying the commit captured
            # at send as min(match, commit)
            hb_at_box, hb_term_box = g(state.hb_at), g(state.hb_term)
            hb_commit_box = g(state.hb_commit)
            hbr_at_box, hbr_term_box = g(state.hbr_at), g(state.hbr_term)
            hb_due_send = is_leader & (hb_elapsed >= cfg.heartbeat_tick)
            hb_elapsed = torch.where(hb_due_send, 0, hb_elapsed)
            send_hb = sl.mview(bx.col(g(hb_due_send)) & ~eye_r & ~sl.drop)
            hb_slot = _first_true(hb_at_box == 0, bx.d(2))
            put_hb = bx.slot(send_hb) & (bx.slot(hb_slot) == kh_idx)
            hb_at_box = torch.where(put_hb, bx.slot(now2 + 1 + lat),
                                    hb_at_box)
            hb_term_box = torch.where(put_hb, term_k, hb_term_box)
            hb_commit_box = torch.where(
                put_hb, bx.slot(torch.minimum(match, bx.col(g(commit)))),
                hb_commit_box)

            # heartbeat deliveries, before the appends' (a higher-term one
            # demotes first); every due heartbeat integrates, stale ones
            # (sender no longer the leader of the captured term) vanish
            due_hb = (hb_at_box > 0) & (now3 + 1 >= hb_at_box)
            valid_hb = due_hb & (bx.col_k(g(role)) == LEADER) \
                & (hb_term_box == term_k) & bx.row_k(alive)
            hb_at_box = torch.where(due_hb, 0, hb_at_box)
            mt_hb = torch.where(valid_hb, hb_term_box,
                                -1).amax(dim=bx.d((0, 2)))
            newer_hb = mt_hb > term
            term = torch.where(newer_hb, mt_hb, term)
            role = torch.where(newer_hb, FOLLOWER, role)
            vote = torch.where(newer_hb, NONE, vote)
            lead = torch.where(newer_hb, NONE, lead)
            elapsed = torch.where(newer_hb, 0, elapsed)
            timeout = torch.where(newer_hb, rand_timeout(cfg, node, term),
                                  timeout)
            cur_hb = valid_hb & (hb_term_box == bx.row_k(term))
            cur_hb_e = cur_hb.any(bx.d(2))
            got_hb = cur_hb_e.any(bx.d(0))
            src_hb = sl.row_of(_first_true(cur_hb_e, bx.d(0)), got_hb)
            role = torch.where(got_hb & (role == CANDIDATE), FOLLOWER, role)
            lead = torch.where(got_hb, src_hb, lead)
            elapsed = torch.where(got_hb, 0, elapsed)
            contact = torch.where(got_hb, 0, contact)
            # commit_to(min(m.commit, last)) per message, as a max
            hbc = torch.where(cur_hb, hb_commit_box,
                              -1).amax(dim=bx.d((0, 2)))
            commit = torch.where(
                got_hb, torch.maximum(commit, torch.minimum(hbc, last)),
                commit)
            # one response per edge per tick
            send_hbr = cur_hb_e & ~sl.drop_t
            hbr_slot = _first_true(hbr_at_box == 0, bx.d(2))
            put_hbr = bx.slot(send_hbr) & (bx.slot(hbr_slot) == kh_idx)
            hbr_at_box = torch.where(put_hbr, bx.slot(now2 + 1 + lat_T),
                                     hbr_at_box)
            hbr_term_box = torch.where(put_hbr, bx.row_k(term),
                                       hbr_term_box)
            term_k = bx.col_k(g(term))   # heartbeats may have caught
            term_e = bx.col(g(term))     # senders up

            # append deliveries: at most one per edge per tick, the
            # deliverable one with the smallest prev; the sender must still
            # be the same-term leader, and a prev compacted since send is
            # undeliverable
            due_k = (app_at > 0) & (now3 + 1 >= app_at)
            valid_k = due_k & (bx.col_k(g(role)) == LEADER) \
                & (app_term_box == term_k) & bx.row_k(alive) \
                & (app_prev >= bx.col_k(g(snap_idx)))
            key = torch.where(valid_k, app_prev, BIG)
            sel_prev = key.amin(bx.d(2))
            sel_slot = _first_true(key == bx.slot(sel_prev), bx.d(2))
            send_app = valid_k.any(bx.d(2))
            taken = bx.slot(send_app) & (bx.slot(sel_slot) == k_idx)
            # clear the delivered slot and every due-but-invalid one
            app_at = torch.where(taken | (due_k & ~valid_k), 0, app_at)
            due_s = (snp_at > 0) & (now2 + 1 >= snp_at)
            send_snap = due_s & (bx.col(g(role)) == LEADER) \
                & (term_e == snp_term_box) & bx.row(alive)
            prev_mat = sel_prev
            snp_at = torch.where(due_s, 0, snp_at)
            out.update(probing=probing, app_at=app_at, app_prev=app_prev,
                       app_term=app_term_box, snp_at=snp_at,
                       snp_term=snp_term_box, hb_at=hb_at_box,
                       hb_term=hb_term_box, hb_commit=hb_commit_box,
                       hbr_at=hbr_at_box, hbr_term=hbr_term_box)
        else:
            prev_mat = next_ - 1
            can_ring = prev_mat >= bx.col(g(snap_idx))
            send_base = sl.mview(bx.col(g(is_leader)) & bx.row(alive)
                                 & ~eye_r & ~sl.drop)
            send_app = send_base & can_ring
            send_snap = send_base & ~can_ring
        msg_term = torch.where(send_app | send_snap, bx.col(g(term)), -1)
        mt2 = msg_term.amax(bx.d(0))
        newer2 = mt2 > term
        term = torch.where(newer2, mt2, term)
        role = torch.where(newer2, FOLLOWER, role)
        vote = torch.where(newer2, NONE, vote)
        lead = torch.where(newer2, NONE, lead)
        elapsed = torch.where(newer2, 0, elapsed)
        timeout = torch.where(newer2, rand_timeout(cfg, node, term), timeout)

        # each receiver picks its current-term leader, judged by the
        # send-time sender term (lowest row on ties).  src_sel is the
        # segment position (it indexes the [R, N] send matrices), src the
        # row id.
        eligible = (send_app | send_snap) & (msg_term == bx.row(term))
        has_lmsg = eligible.any(bx.d(0))
        src_sel = _first_true(eligible, bx.d(0))
        src = sl.row_of(src_sel, has_lmsg)       # 0 where has_lmsg is False
        role = torch.where(has_lmsg & (role == CANDIDATE), FOLLOWER, role)
        lead = torch.where(has_lmsg, src, lead)
        elapsed = torch.where(has_lmsg, 0, elapsed)
        contact = torch.where(has_lmsg, 0, contact)
        is_leader = (role == LEADER) & alive
        sel_l = src_sel.to(torch.int64)
        if vguard:
            out.update(vg_vote=vg_vote, vg_term=vg_term)
        return dict(
            out,
            term=term, vote=vote, role=role, lead=lead, elapsed=elapsed,
            contact=contact, hb_elapsed=hb_elapsed, timeout=timeout,
            pre=pre, last=last, commit=commit, pending_conf=pending_conf,
            campaign=campaign, tn_ok=tn_ok, transferee=transferee,
            tn_at=tn_at, tn_term=tn_term, tn_from=tn_from, tx_cand=tx_cand,
            win=win, noop_term=noop_term, is_leader=is_leader,
            has_lmsg=has_lmsg, src=src,
            got_app=has_lmsg & bx.at(send_app, sel_l, node_l),
            got_snap=has_lmsg & bx.at(send_snap, sel_l, node_l),
            p=bx.at(prev_mat, sel_l, node_l),
            match=match, next_=next_, granted=granted, rejected=rejected,
            recent_active=recent_active)

    def payloads(k):
        return payload_fn(now2, torch.clamp(k, min=0).to(torch.int64)) \
            & PAYLOAD_MASK

    # Segment 1 and the append receive up to the ring write's band probe.
    # On a tiled config this loop only reads the rings (the noop store
    # rides the ring write), so a speculative slab pass that does not fit
    # is dropped and redone on the dense rows.  An untiled config, whose
    # noop store is made here, knows its rows before the loop and makes
    # one pass.
    if not sparse_on:
        tries = [dense_rows]
    elif cfg.tiled:
        tries = [slab_rows, dense_rows]
    else:
        # no band probe to share: read the fit alone, before the segment
        tries = [slab_rows if _read_back([sp_fits])[0] else dense_rows]
    for sl in tries:
        oa = _progress_a(sl)
        term, vote, role = oa["term"], oa["vote"], oa["role"]
        lead, elapsed, contact = oa["lead"], oa["elapsed"], oa["contact"]
        hb_elapsed, timeout, pre = oa["hb_elapsed"], oa["timeout"], oa["pre"]
        last, commit, pending_conf = (oa["last"], oa["commit"],
                                      oa["pending_conf"])
        campaign, tn_ok, transferee = (oa["campaign"], oa["tn_ok"],
                                       oa["transferee"])
        tn_at, tn_term, tn_from = oa["tn_at"], oa["tn_term"], oa["tn_from"]
        tx_cand, win, noop_term = oa["tx_cand"], oa["win"], oa["noop_term"]
        is_leader, has_lmsg, src = (oa["is_leader"], oa["has_lmsg"],
                                    oa["src"])
        got_app, got_snap, p = oa["got_app"], oa["got_snap"], oa["p"]
        src_l = src.to(torch.int64)
        vg_fields = dict(vg_vote=oa["vg_vote"], vg_term=oa["vg_term"]) \
            if cfg.has_vote_guard else {}

        if not cfg.tiled:
            # untiled noop store, before the append reads (as in the
            # reference: a just-elected leader replicates its no-op the same
            # tick); non-winners rewrite their own slot unchanged
            noop_slot = _slot(cfg, torch.where(win, last, last + 1))
            bx.put_at(log_term, node_l, noop_slot, torch.where(
                win, noop_term, bx.at(log_term, node_l, noop_slot)))
            bx.put_at(log_data, node_l, noop_slot, torch.where(
                win, 0, bx.at(log_data, node_l, noop_slot)))

        # -- append receive.  Every ring read below precedes the ring write.
        last_src, snap_src = bx.take(last, src_l), bx.take(snap_idx, src_l)
        p_ring_term = bx.at(log_term, src_l, _slot(cfg, p))
        p_term_sent = torch.where(
            p == snap_src, bx.take(snap_term, src_l),
            torch.where((p > snap_src) & (p <= last_src), p_ring_term, 0))
        # window clamp for ring safety (never wrap over unapplied entries)
        ring_cap = snap_idx + L - p
        n_avail = torch.clamp(torch.minimum(last_src - p, ring_cap), 0, W)
        hi = p + n_avail                                         # lastnewi

        commit0 = commit
        q_p = torch.minimum(p, last)
        local_p_term = _term_own(cfg, log_term, snap_idx, snap_term, last,
                                 q_p, bx)
        if fused_prop:
            # a stale co-leader's prev can reach this row's pending
            # proposals
            local_p_term = torch.where(prop_ok & (q_p > prop_last0),
                                       state.term, local_p_term)
        if cfg.tiled:
            # likewise a fresh winner's pending noop entry (idx == last)
            local_p_term = torch.where(win & (q_p == last), noop_term,
                                       local_p_term)
        prev_ok = (p <= last) & (p >= snap_idx) \
            & (local_p_term == p_term_sent)
        stale = p < commit0
        accept = got_app & prev_ok & ~stale

        # snapshot-receive decision (the wipe rides the ring write)
        snap_pt = torch.minimum(snap_src, last)
        have_term = _term_own(cfg, log_term, snap_idx, snap_term, last,
                              snap_pt, bx)
        if fused_prop:
            have_term = torch.where(prop_ok & (snap_pt > prop_last0),
                                    state.term, have_term)
        if cfg.tiled:
            have_term = torch.where(win & (snap_pt == last), noop_term,
                                    have_term)
        already = (snap_src <= last) \
            & (have_term == bx.take(snap_term, src_l))
        advance = got_snap & (snap_src > commit)
        do_restore = advance & ~already
        snap_refuse = None
        if gated:
            # a corrupt image (snap_bad) is refused before install: no
            # restore and no ack progress, so the sender re-sends it.
            # The refusal feeds the band probe below, like every restore.
            snap_refuse = do_restore & state.snap_bad
            do_restore = do_restore & ~state.snap_bad

        if not cfg.tiled:
            break
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
        any_mism = w_mism.any(bx.d(1))
        ci_idx = torch.where(w_mism, widx, BIG).amin(bx.d(1))

        # The band of this tick's writes, read back to pick the ring write
        # (with the slab's fit, on a speculative slab pass).  Election
        # ticks (pending noop) and restore ticks (full-width wipe) take
        # the full pass.  Whole-tensor reductions that are host decisions,
        # so the tiled log is refused under a batch axis.
        probe = [torch.where(got_app, p, BIG).amin(),
                 torch.where(got_app, hi, 0).amax(),
                 do_restore.any(), win.any()]
        if fused_prop:
            probe += [torch.where(prop_ok, prop_last0, BIG).amin(),
                      torch.where(prop_ok, prop_anchor, 0).amax()]
        if not static_m:
            # The end-of-tick conf-gate scans' band, bounded from here: a
            # row's end-of-tick (applied, last] lies inside (pre-tick
            # applied, gate_hi] (applied only grows; last ends at most at
            # the append's or the restore's end).  Any band covering every
            # such row gives the full scan's bits, so a fit of this
            # superset picks the banded scan exactly.
            gate_hi = torch.maximum(last, torch.maximum(
                torch.where(got_app, hi, 0),
                torch.where(do_restore, snap_src, 0)))
            gate_work = gate_hi > applied
            gate_at = len(probe)
            probe += [torch.where(gate_work, applied, BIG).amin(),
                      torch.where(gate_work, gate_hi, 0).amax()]
        if not sl.dense:
            probe.append(sp_fits)
        host = _read_back(probe)
        if sl.dense or host[-1]:
            break
    phase("phase_C_ring_write")
    if sparse_on:
        COUNTS["dense_fallback_ticks" if sl.dense else "slab_ticks"] += 1
    match = sl.merge(state.match, oa["match"])
    next_ = sl.merge(state.next_, oa["next_"])
    granted = sl.merge(state.granted, oa["granted"])
    rejected = sl.merge(state.rejected, oa["rejected"])
    recent_active = sl.merge(state.recent_active, oa["recent_active"])
    if mail:
        boxes = {f: sl.merge(getattr(state, f), oa[f]) for f in (
            "probing", "vreq_at", "vreq_term", "vreq_pre", "vresp_at",
            "vresp_term", "vresp_grant", "vresp_pre", "app_at", "app_prev",
            "app_term", "snp_at", "snp_term", "hb_at", "hb_term",
            "hb_commit", "hbr_at", "hbr_term")}

    def prop_write(lt, ld, new_idx):
        """The fused propose's stores into a chunk or full view (in place):
        new_idx is the slot->index map anchored one batch ahead."""
        k_of = new_idx - bx.col(prop_last0) - 1
        valid = bx.col(prop_ok) & (k_of >= 0) & (k_of < prop_cnt2)
        _put(lt, valid, bx.col(state.term))
        _put(ld, valid, payloads(k_of))

    if cfg.tiled:
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
            prop_write(log_term, log_data,
                       _idx_at_slots(cfg, prop_anchor, bx))
        # find_conflict over the whole row, against the sender's row
        lead_term_row = bx.take(log_term, src_l)
        lead_data_row = bx.take(log_data, src_l)
        lead_idx = _idx_at_slots(cfg, last_src, bx)
        in_win = bx.col(got_app) & (lead_idx > bx.col(p)) \
            & (lead_idx <= bx.col(hi))
        exists = (lead_idx <= bx.col(last)) & (lead_idx > bx.col(snap_idx))
        mism = in_win & (~exists | (log_term != lead_term_row))
        any_mism = mism.any(bx.d(1))
        ci_idx = torch.where(mism, lead_idx, BIG).amin(bx.d(1))
        write = in_win & bx.col(accept) & (lead_idx >= bx.col(ci_idx))
        # one launch over every ring row: [N, L], or [B*N, L] batched
        cuda_ops.append_band_copy(bx.rows(log_term), bx.rows(log_data), 0,
                                  bx.rows(lead_term_row),
                                  bx.rows(lead_data_row), bx.rows(write))
        log_term.masked_fill_(bx.col(do_restore), 0)
        log_data.masked_fill_(bx.col(do_restore), 0)

    lastnewi = hi
    last = torch.where(accept, torch.where(any_mism, lastnewi,
                                           torch.maximum(last, lastnewi)),
                       last)
    commit = torch.where(accept, torch.maximum(
        commit, torch.minimum(bx.take(commit0, src_l), lastnewi)), commit)

    # snapshot receive: cursor/meta effects (the ring wipe happened above)
    commit = torch.where(advance & already, snap_src, commit)
    last = torch.where(do_restore, snap_src, last)
    commit = torch.where(do_restore, snap_src, commit)
    applied = torch.where(do_restore, snap_src, applied)
    apply_chk = torch.where(do_restore, bx.take(snap_chk, src_l), apply_chk)
    snap_term = torch.where(do_restore, bx.take(snap_term, src_l), snap_term)
    snap_chk = torch.where(do_restore, bx.take(snap_chk, src_l), snap_chk)
    snap_idx = torch.where(do_restore, snap_src, snap_idx)
    if storage_on:
        if not gated:
            # without gating a corrupt image installs unverified: a
            # poisoned checksum chain
            poison = do_restore & state.snap_bad
            apply_chk = torch.where(poison, apply_chk ^ SNAP_POISON,
                                    apply_chk)
            snap_chk = torch.where(poison, snap_chk ^ SNAP_POISON, snap_chk)
        # an installed snapshot is durable at install
        sync_mark = torch.where(do_restore,
                                torch.maximum(sync_mark, snap_idx), sync_mark)
    if not static_m:
        # the snapshot carries the sender's configuration; the second
        # segment counts in the views as they stand after it
        member = torch.where(bx.col(do_restore), bx.take(member, src_l),
                             member)
        sl.set_member(member)

    # responses back to senders (j -> i), may be dropped
    resp_match = torch.where(stale & got_app, commit0,
                             torch.where(got_snap, commit, lastnewi))
    self_ack_cap = last
    if gated:
        # ack gating (fsync before the append response): a follower acks
        # only what its durable watermark covers, re-acks its durable
        # frontier after each fsync round (mailbox wire), and a leader
        # counts itself in the commit quorum only up to its own watermark
        resp_match = torch.minimum(resp_match, sync_mark)
        dur_match = torch.minimum(last, sync_mark)
        fsync_ack = fsync_did & (lead != NONE) & (role == FOLLOWER)
        self_ack_cap = dur_match
    resp_ok = accept | got_snap | (stale & got_app)
    resp_reject = got_app & ~prev_ok & ~stale
    reject_hint = last

    def _progress_b(sl: _Rows, match=match, next_=next_,
                    recent_active=recent_active, tn_at=tn_at,
                    tn_term=tn_term, tn_from=tn_from):
        """Progress segment 2: ack folds, progress integration, transfer
        completion and the Phase D bisect, on the rows `sl` (the branch
        segment 1 took).  Returns the segment's matrices and mailbox slots
        (slabs on a slab), [N] vectors, `mci` (the bisect's result; a row
        outside the slab reports its own commit, a no-advance) and
        `got_resp` (rows that received a response, for active_ttl)."""
        g, eye_r = sl.g, sl.eye
        match, next_, recent_active = g(match), g(next_), g(recent_active)
        out = {}
        if mail:
            lat, lat_T = sl.lat()
            probing = g(boxes["probing"])
            app_at, app_prev = g(boxes["app_at"]), g(boxes["app_prev"])
            app_term_box = g(boxes["app_term"])
            snp_at, snp_term_box = g(boxes["snp_at"]), g(boxes["snp_term"])
            hbr_at_box, hbr_term_box = g(boxes["hbr_at"]), g(boxes["hbr_term"])
            aresp_at, aresp_term = g(state.aresp_at), g(state.aresp_term)
            aresp_match, aresp_ok = g(state.aresp_match), g(state.aresp_ok)
            kr_idx = torch.arange(cfg.ack_depth, dtype=I32,
                                  device=dev)[None, None]
            term_r, term_k = bx.col(g(term)), bx.col_k(g(term))
            # ack enqueue into the first free of ack_depth slots (one
            # always is: acks arrive once per tick per edge and live at
            # most latency + jitter ticks)
            send_ar = (sl.ids[:, None] == bx.row(src)) & bx.row(has_lmsg) \
                & ~sl.drop_t
            wslot = _first_true(aresp_at == 0, bx.d(2))
            put_r = bx.slot(send_ar) & (bx.slot(wslot) == kr_idx)
            aresp_at = torch.where(put_r, bx.slot(now2 + 1 + lat_T),
                                   aresp_at)
            aresp_term = torch.where(put_r, bx.row_k(term), aresp_term)
            aresp_ok = torch.where(put_r, bx.row_k(resp_ok), aresp_ok)
            aresp_match = torch.where(
                put_r, bx.row_k(torch.where(resp_reject, reject_hint,
                                            resp_match)), aresp_match)
            if gated:
                # the unsolicited durable-frontier ack: every fsync round a
                # follower re-acks min(last, sync_mark) to its known leader,
                # best effort (skipped while the edge's slots are all busy)
                fa_tgt = torch.clamp(lead, 0, n - 1)
                send_fa = (sl.ids[:, None] == bx.row(fa_tgt)) \
                    & bx.row(fsync_ack) & ~sl.drop_t & ~eye_r
                free_f = aresp_at == 0
                fa_slot = _first_true(free_f, bx.d(2))
                put_f = bx.slot(send_fa) \
                    & (bx.slot(fa_slot) == kr_idx) \
                    & bx.slot(free_f.any(bx.d(2)))
                aresp_at = torch.where(put_f, bx.slot(now2 + 1 + lat_T),
                                       aresp_at)
                aresp_term = torch.where(put_f, bx.row_k(term),
                                         aresp_term)
                aresp_ok = torch.where(put_f, True, aresp_ok)
                aresp_match = torch.where(put_f, bx.row_k(dur_match),
                                          aresp_match)
            # deliveries: every due ack integrates, aggregated (ok: max
            # match; reject: min hint, applied after the ok advance)
            due_r = (aresp_at > 0) & (now3 + 1 >= aresp_at)
            val_r = due_r & bx.col_k(g(is_leader)) \
                & (term_k == aresp_term)
            ok_k = val_r & aresp_ok
            rej_k = val_r & ~aresp_ok
            ok_mat, rej_mat = ok_k.any(bx.d(2)), rej_k.any(bx.d(2))
            resp_match_del = torch.where(ok_k, aresp_match,
                                         -1).amax(bx.d(2))
            reject_hint_del = torch.where(rej_k, aresp_match,
                                          BIG).amin(bx.d(2))
            aresp_at = torch.where(due_r, 0, aresp_at)
        else:
            arrive_back = ~sl.drop_t & (sl.ids[:, None] == bx.row(src)) \
                & bx.col(g(is_leader)) & bx.row(has_lmsg)
            ok_mat = arrive_back & bx.row(resp_ok)
            rej_mat = arrive_back & bx.row(resp_reject)
        got_resp = (ok_mat | rej_mat).any(bx.d(1)) if sparse_on else None
        # any response marks the peer recently active; progress follows
        # only peers in the leader's view
        recent_active = recent_active | ok_mat | rej_mat
        ok_mat, rej_mat = sl.mview(ok_mat), sl.mview(rej_mat)
        if mail:
            # a match advance on a probing edge enters replicate with
            # next = match + 1 exactly
            to_repl = ok_mat & (resp_match_del > match) & probing
            match = torch.where(ok_mat, torch.maximum(match, resp_match_del),
                                match)
            next_ = torch.where(
                to_repl, resp_match_del + 1,
                torch.where(ok_mat, torch.maximum(next_, resp_match_del + 1),
                            next_))
            probing = probing & ~to_repl
            next_ = torch.where(rej_mat, torch.clamp(
                torch.minimum(next_ - 1, reject_hint_del + 1), min=1), next_)
            # becomeProbe on rejection; the edge's same-term pipelined
            # appends are flushed and the backtracked probe goes out now
            probing = probing | rej_mat
            app_at = torch.where(
                bx.slot(rej_mat) & (app_term_box == term_k), 0, app_at)
            snp_busy = (snp_at != 0) & (snp_term_box == term_r)
            prev_rs = next_ - 1
            rs = sl.mview(rej_mat & bx.col(g(is_leader)) & ~eye_r
                          & ~sl.drop & ~snp_busy
                          & (prev_rs >= bx.col(g(snap_idx))))
            free_rs = (app_at == 0) | (app_term_box != term_k)
            rslot = _first_true(free_rs, bx.d(2))
            put_rs = bx.slot(rs) & (bx.slot(rslot) == torch.arange(
                cfg.inflight, dtype=I32, device=dev)[None, None])
            app_at = torch.where(put_rs, bx.slot(now2 + 1 + lat), app_at)
            app_prev = torch.where(put_rs, bx.slot(prev_rs), app_prev)
            app_term_box = torch.where(put_rs, term_k, app_term_box)
            # heartbeat responses: liveness only
            due_hbr = (hbr_at_box > 0) & (now3 + 1 >= hbr_at_box)
            val_hbr = (due_hbr & bx.col_k(g(is_leader))
                       & (term_k == hbr_term_box)).any(bx.d(2))
            recent_active = recent_active | val_hbr
            hbr_at_box = torch.where(due_hbr, 0, hbr_at_box)
            if sparse_on:
                got_resp = got_resp | val_hbr.any(bx.d(1))
            out.update(probing=probing, app_at=app_at, app_prev=app_prev,
                       app_term=app_term_box, aresp_at=aresp_at,
                       aresp_term=aresp_term, aresp_match=aresp_match,
                       aresp_ok=aresp_ok, hbr_at=hbr_at_box)
        else:
            match = torch.where(ok_mat,
                                torch.maximum(match, bx.row(resp_match)),
                                match)
            next_ = torch.where(ok_mat,
                                torch.maximum(next_, bx.row(resp_match + 1)),
                                next_)
            # probe decrement (coarse): jump next back to the hint
            next_ = torch.where(rej_mat, torch.clamp(
                torch.minimum(next_ - 1, bx.row(reject_hint + 1)), min=1),
                next_)
        if sparse_on:
            got_resp = sl.sfull(got_resp, False)

        # leader transfer completion: fire TIMEOUT_NOW once the target
        # caught up (a target outside the leader's view never fires)
        tgt = torch.clamp(transferee, 0, n - 1).to(torch.int64)
        has_tx = is_leader & (transferee != NONE) & (tgt != node_l)
        if not static_m:
            has_tx = has_tx & bx.pick(member, tgt)
        tgt_r = g(tgt)
        caught = g(has_tx) \
            & (bx.pick(match, tgt_r) == g(last))
        want_tn = caught & (bx.take(tn_at, tgt_r) == 0) \
            & ~bx.pick(sl.drop, tgt_r)
        send_tn = bx.col(want_tn) & (bx.col(tgt_r) == node_l[None, :])
        any_tn = send_tn.any(bx.d(0))
        tn_sel = _first_true(send_tn, bx.d(0))
        tn_src = sl.row_of(tn_sel, any_tn)       # lowest leader
        if mail:
            tn_lat = bx.pick(lat, tgt_r)
            tn_at = torch.where(any_tn, now1 + 1 + bx.take(tn_lat, tn_sel.to(
                torch.int64)), tn_at)
        else:
            tn_at = torch.where(any_tn, now1 + 1, tn_at)
        tn_term = torch.where(any_tn, bx.take(term, tn_src.to(torch.int64)),
                              tn_term)
        tn_from = torch.where(any_tn, tn_src, tn_from)
        if cfg.transfer_cooldown_ticks > 0:
            # the rows that fired a TIMEOUT_NOW re-arm their cooldown
            out["tn_fired"] = sl.sfull(want_tn, False)

        # ---- Phase D: leader commit (quorum on the match row) ------------
        # the largest X in (commit, last] acked by a quorum of the row's
        # view, by a fixed-depth bisection instead of a sort of the match
        # plane; a leader acks itself up to self_ack_cap
        match = torch.where(bx.col(g(is_leader)) & eye_r,
                            bx.col(g(self_ack_cap)), match)
        q_row = quorum if static_m else g(quorum)
        lo, hi_b = g(commit), g(last)
        for _ in range(max(1, L.bit_length() + 1)):
            mid = (lo + hi_b + 1) >> 1
            cnt = sl.count(lambda j0, w: match[:, j0:j0 + w] >= bx.col(mid))
            ok = (cnt >= q_row) & (hi_b >= mid) & (mid > lo)
            lo = torch.where(ok, mid, lo)
            hi_b = torch.where(ok, hi_b, mid - 1)
        mci = lo if sl.dense else commit.index_copy(0, sl.idx, lo)
        if reads_on:
            # Phase R1's ack count: this tick's ack collective (and the
            # heartbeat responses on the mailbox wire) confirms leadership
            # for ReadIndex, so a read round costs no extra messages
            rd_ack = ok_mat | rej_mat
            if mail:
                rd_ack = rd_ack | sl.mview(val_hbr)
            out["rd_nack"] = sl.sfull(sl.count(
                lambda j0, w: rd_ack[:, j0:j0 + w] | sl.eye_cols(j0, w)), 0)
        return dict(out, match=match, next_=next_,
                    recent_active=recent_active, tn_at=tn_at,
                    tn_term=tn_term, tn_from=tn_from, mci=mci,
                    got_resp=got_resp)

    phase("phase_D_progress")
    ob = _progress_b(sl)
    match = sl.merge(match, ob["match"])
    next_ = sl.merge(next_, ob["next_"])
    recent_active = sl.merge(recent_active, ob["recent_active"])
    tn_at, tn_term, tn_from = ob["tn_at"], ob["tn_term"], ob["tn_from"]
    mci = ob["mci"]
    if tx_cool is not None:
        tx_cool = torch.where(ob["tn_fired"], cfg.transfer_cooldown_ticks,
                              tx_cool)
    if mail:
        for f in ("probing", "app_at", "app_prev", "app_term", "hbr_at"):
            boxes[f] = sl.merge(boxes[f], ob[f])
        for f in ("aresp_at", "aresp_term", "aresp_match", "aresp_ok"):
            boxes[f] = sl.merge(getattr(state, f), ob[f])
    # commit fold, outside the segments (mci_term is a ring read)
    phase("phase_D_commit_fold")
    mci_term = _term_own(cfg, log_term, snap_idx, snap_term, last, mci, bx)
    can_commit = is_leader & (mci > commit) & (mci_term == term)
    commit = torch.where(can_commit, mci, commit)

    # ---- Phase R1: lease renewal + ReadIndex stamping ----------------------
    # A quorum of member acks renews the lease and, with the own-term
    # commit guard (a fresh leader's commit may lag until its noop
    # commits), lets the pending batch take the just-folded commit.  The
    # guard reads the ring after this tick's write, as JAX's log does here.
    if reads_on:
        phase("phase_R1_stamp")
        rd_q_ok = (role == LEADER) & alive & (ob["rd_nack"] >= quorum)
        rd_cterm_ok = (commit > 0) & (_term_own(
            cfg, log_term, snap_idx, snap_term, last, commit, bx) == term)
        read_regs, _ = rd.stamp(
            cfg, read_regs, alive=alive, role=role, lead=lead, term=term,
            commit=commit, commit_term_ok=rd_cterm_ok, q_ok=rd_q_ok,
            transferee=transferee, now=now1, drop=drop, bx=bx)

    # ---- Phase E: apply + checksum ---------------------------------------
    # Conf entries activate here, at each row's own apply point; the batch
    # stops AT the first conf entry, so at most one membership flip lands
    # per row per tick.  (Static membership has no conf entries: propose
    # masks the tag bit and propose_conf refuses.)
    phase("phase_E_apply")
    base_applied = torch.minimum(commit, applied + cfg.apply_batch)
    new_applied = torch.where(alive, base_applied, applied)  # crashed: frozen
    if cfg.tiled:
        # per-row gather window: (applied, new_applied] is at most
        # apply_batch wide by construction
        aidx = applied[:, None] + 1 \
            + torch.arange(cfg.apply_batch, dtype=I32, device=dev)[None]
        avals = log_data.gather(1, _slot(cfg, aidx))
        in_win = aidx <= new_applied[:, None]
        if not static_m:
            first_conf = torch.where(in_win & _is_conf(avals), aidx,
                                     BIG).amin(bx.d(1))
            in_win = in_win & (aidx <= first_conf[:, None])
        chk = torch.where(in_win, _entry_chk(aidx, avals), 0)
    else:
        own_idx = _idx_at_slots(cfg, last, bx)
        app_mask = (own_idx > bx.col(applied)) \
            & (own_idx <= bx.col(new_applied))
        if not static_m:
            first_conf = torch.where(app_mask & _is_conf(log_data), own_idx,
                                     BIG).amin(bx.d(1))
            app_mask = app_mask & (own_idx <= bx.col(first_conf))
        chk = torch.where(app_mask, _entry_chk(own_idx, log_data), 0)
    apply_chk = u32.to_bits(u32.unsigned(apply_chk)
                            + u32.wrap_sum(chk, bx.d(1)))
    if not static_m:
        has_conf = first_conf < BIG
        new_applied = torch.minimum(new_applied, first_conf)
    applied = new_applied

    if not static_m:
        # decode and apply the (single) conf entry at new_applied
        cslot = _slot(cfg, torch.where(has_conf, first_conf, 1))
        cdata = bx.pick(log_data, cslot)
        ctgt = torch.clamp(cdata & CONF_TARGET_MASK, 0, n - 1)
        c_rm = (cdata & CONF_REMOVE) != 0
        tgt_onehot = node[None, :] == bx.col(ctgt)
        was_member = bx.pick(member, ctgt.to(torch.int64))
        newly_added = has_conf & ~c_rm & ~was_member
        member = torch.where(bx.col(has_conf) & tgt_onehot, ~bx.col(c_rm),
                             member)
        # add_node starts a fresh Progress (next = last + 1, match 0,
        # recently active, probing) on every row; a re-add of a member
        # keeps its progress
        reset_pr = bx.col(newly_added) & tgt_onehot
        match = torch.where(reset_pr, 0, match)
        next_ = torch.where(reset_pr, bx.col(last + 1), next_)
        recent_active = torch.where(reset_pr, True, recent_active)
        if mail:
            boxes["probing"] = torch.where(reset_pr, True, boxes["probing"])
        # remove_node aborts a transfer to the removed peer; both clear the
        # leader's propose gate
        transferee = torch.where(has_conf & c_rm & (transferee == ctgt),
                                 NONE, transferee)
        pending_conf = pending_conf & ~has_conf

    # ---- Phase R2: serve or refuse read batches ----------------------------
    if reads_on:
        phase("phase_R2_settle")
        read_regs, rd_served, rd_srv_cnt, rd_blocked, rd_blk_cnt, \
            rd_expired = rd.settle(
                cfg, read_regs, alive=alive, applied=applied, role=role,
                was_leader=state.role == LEADER, now=now1,
                prev_lease_until=state.lease_until)

    # ---- Phase F: compaction (ring-pressure driven) ----------------------
    phase("phase_F_compact")
    pressure = (last - snap_idx) > (L - 2 * cfg.max_props - 1)
    new_snap = torch.maximum(snap_idx, applied - cfg.keep)
    do_compact = pressure & (new_snap > snap_idx) & alive
    nst = _term_own(cfg, log_term, snap_idx, snap_term, last, new_snap, bx)
    if cfg.tiled:
        # (new_snap, applied] is at most `keep` wide by construction
        fidx = new_snap[:, None] + 1 \
            + torch.arange(max(cfg.keep, 1), dtype=I32, device=dev)[None]
        fvals = log_data.gather(1, _slot(cfg, fidx))
        ahead = torch.where(fidx <= applied[:, None],
                            _entry_chk(fidx, fvals), 0)
    else:
        own_idx = _idx_at_slots(cfg, last, bx)
        ahead = torch.where((own_idx > bx.col(new_snap))
                            & (own_idx <= bx.col(applied)),
                            _entry_chk(own_idx, log_data), 0)
    nsc = u32.to_bits(u32.unsigned(apply_chk)
                      - u32.wrap_sum(ahead, bx.d(1)))
    snap_term = torch.where(do_compact, nst, snap_term)
    snap_chk = torch.where(do_compact, nsc, snap_chk)
    snap_idx = torch.where(do_compact, new_snap, snap_idx)
    if storage_on:
        # a compacted-to snapshot is durable by construction, which keeps
        # sync_mark >= snap_idx
        sync_mark = torch.maximum(sync_mark, snap_idx)

    # invariants: pre/tx_cand mark live candidacies only; transferee only
    # means anything on a standing leader
    phase("tick_end")
    pre = pre & (role == CANDIDATE)
    tx_cand = tx_cand & (role == CANDIDATE) & ~pre
    transferee = torch.where(role == LEADER, transferee, NONE)

    # active-row TTL: leaders and candidates pin their row hot; a row that
    # stepped down, or is still receiving responses, keeps its slab seat
    # for a round trip of the wire (2 * (latency + jitter) + 2 ticks).
    # From end-of-tick values only, so both branches give the same ttl.
    active_ttl = state.active_ttl
    if sparse_on:
        ttl_w = 2 * (cfg.latency + cfg.latency_jitter) + 2
        keep_hot = (role == CANDIDATE) | (role == LEADER) | ob["got_resp"]
        active_ttl = torch.where(keep_hot, ttl_w,
                                 torch.clamp(state.active_ttl - 1, min=0))

    # End-of-tick conf-gate scans for the next tick's Phase A/B: a conf
    # entry committed but unapplied (hup_conf), or uncommitted (tail_conf).
    if static_m:
        hup_conf, tail_conf = state.hup_conf, state.tail_conf  # all-False
    else:
        def gates(ld, own_idx):
            icr = _is_conf(ld)
            hup = ((own_idx > bx.col(applied)) & (own_idx <= bx.col(commit))
                   & icr).any(bx.d(1))
            tail = ((own_idx > bx.col(commit)) & (own_idx <= bx.col(last))
                    & icr).any(bx.d(1))
            return hup, tail

        gate_band = None
        if cfg.tiled:
            # the band read back with the ring write's probe (see there)
            c0g, nch_g = _band_origin(cfg, host[gate_at], host[gate_at + 1])
            if nch_g <= cfg.band_chunks:
                gate_band = _band_offsets(cfg, c0g)
        if gate_band is None:
            hup_conf, tail_conf = gates(log_data,
                                        _idx_at_slots(cfg, last, bx))
        else:
            C = cfg.log_chunk
            hup_conf = tail_conf = None
            for off in gate_band:
                h, t = gates(log_data[:, off:off + C],
                             _idx_at_band(cfg, last, off))
                hup_conf = h if hup_conf is None else hup_conf | h
                tail_conf = t if tail_conf is None else tail_conf | t

    stats = state.stats
    if cfg.collect_stats and stats is not None:
        # value reductions: each cluster's own event counts
        inc = bx.stack([
            bx.csum(campaign | tn_ok), bx.csum(win),
            bx.csum((commit - state.commit).to(torch.int64)),
            bx.csum((applied - state.applied).to(torch.int64))])
        stats = u32.to_bits(stats.to(torch.int64) + inc)  # int32 wraparound

    # ---- the device observability planes, in the JAX package's order ------
    # Each is Python-gated like the levers above, so a planes-off tick runs
    # the same ops as before.  They read this tick's [N] masks and values
    # and write their own side buffers (in place where they are rings);
    # none reads a device value back.
    planes = {}
    tel_on = cfg.collect_telemetry and state.tel_commit_hist is not None
    if tel_on or cfg.record_events:
        phase("obs_planes")
    if tel_on and fused_prop:
        # the fused propose's batch record (and tag): one column per tick
        _stamp_batch(state, cfg, prop_ok, prop_last0 + 1, prop_cnt, prop_tag,
                     bx)

    # Trace tags: the commit tag is the tag of the freshest live tagged
    # batch whose index range meets this tick's commit advance (the
    # telemetry commit fold's window); the read tag is the [N] register,
    # cleared on the kernel's own closed-loop refill.
    commit_tag = read_tag_now = None
    if cfg.trace_tags and state.tel_prop_tag is not None:
        ttag, tidx = state.tel_prop_tag, state.tel_prop_idx
        tcnt, ttick = state.tel_prop_cnt, state.tel_prop_tick
        t_ring = ttag.shape[1]
        tlo = torch.maximum(tidx, state.commit[:, None] + 1)
        thi = torch.minimum(tidx + tcnt - 1, commit[:, None])
        tsel = can_commit[:, None] & (tidx != NONE) & (ttick >= 0) \
            & (now - ttick < t_ring) & (thi >= tlo) & (ttag != 0)
        tbest = torch.where(tsel, ttick, -1).argmax(1)
        commit_tag = torch.where(tsel.any(bx.d(1)),
                                 ttag.gather(1, tbest[:, None])[:, 0], 0)
        # the step-down wipe, as the batch ring's below: a regained
        # leadership must not link another leader's entries to a tag
        planes["tel_prop_tag"] = torch.where(is_leader[:, None], ttag, 0)
        if reads_on and state.read_tag is not None:
            read_tag_now = torch.where(alive & (state.read_pend == 0), 0,
                                       state.read_tag)
            planes["read_tag"] = read_tag_now

    # Flight recorder: coded events from this tick's masks, appended to each
    # row's ring in code order (one scatter, the sequential appends' bits).
    if cfg.record_events and state.ev_buf is not None:
        # fault edges against the previous tick's inputs carried in ev_*;
        # the drop degree is out- plus in-degree, band by band under peer
        # tiling (no temporary wider than a band), zero without a matrix
        if not drop_given:
            drop_deg = torch.zeros((n,), dtype=I32, device=dev)
        elif cfg.peer_tiled:
            drop_deg = _pcount(cfg, lambda j0, w: drop[:, j0:j0 + w], True)
            for i0 in range(0, n, cfg.peer_chunk):
                drop_deg = drop_deg + _count(drop[i0:i0 + cfg.peer_chunk], 0)
        else:
            drop_deg = _count(drop, 1) + _count(drop, 0)
        ev = [(state.ev_alive & ~alive, fc.FAULT_EDGE, fc.EDGE_DOWN, 0),
              (~state.ev_alive & alive, fc.FAULT_EDGE, fc.EDGE_UP, 0),
              (drop_deg != state.ev_drop, fc.FAULT_EDGE, fc.EDGE_DROP,
               drop_deg),
              # protocol events, end-of-tick values against the pre-tick
              (term != state.term, fc.TERM_BUMP, term, state.term),
              (win, fc.ELECTION_WON, term, last),
              (resp_reject, fc.APPEND_REJECT, src, reject_hint),
              (do_restore, fc.SNAPSHOT_RESTORE, src, snap_idx),
              (commit > state.commit, fc.COMMIT_ADVANCE, commit,
               commit - state.commit, commit_tag)]
        if storage_on:
            ev.append((sync_mark > state.sync_mark, fc.FSYNC_ADVANCE,
                       sync_mark, sync_mark - state.sync_mark))
            if snap_refuse is not None:
                ev.append((snap_refuse, fc.RECOVER_REJECT_SNAP, src,
                           snap_idx))
        if cfg.tiled:
            # the full-pass ring write (decided on the host) is one
            # cluster-wide event, recorded on row 0
            ev.append(((node == 0) & (not fits), fc.FALLBACK_TICK, nch,
                       cfg.band_chunks))
        if reads_on:
            ev += [(rd_served, fc.READ_SERVED, applied, rd_srv_cnt,
                    read_tag_now),
                   (rd_blocked, fc.READ_BLOCKED, rd_blk_cnt,
                    torch.where(rd_expired, fc.BLOCK_LEASE,
                                fc.BLOCK_DEPOSED)),
                   (rd_expired, fc.LEASE_EXPIRED, read_regs.lease_until,
                    rd_blk_cnt)]
        ev_buf, ev_pos = fc.ring_append_many(
            state.ev_buf, state.ev_pos, now,
            [(e[0], e[2], e[3], e[4] if len(e) > 4 else None) for e in ev],
            _codes_on(dev, tuple(e[1] for e in ev)))
        planes.update(ev_buf=ev_buf, ev_pos=ev_pos, ev_alive=alive,
                      ev_drop=drop_deg)

    # Telemetry: election and propose->commit latency histograms (the
    # commit one at the proposing leader, each batch record folding the
    # slice of its range that this tick's commit advance covers, weighted
    # by its width), read submit->settle, and the series ring.
    if tel_on:
        # (the histogram folds and the series sums are value reductions:
        # per cluster under a batch axis)
        edges = ts.bucket_edges(dev)
        bidx, bcnt = state.tel_prop_idx, state.tel_prop_cnt
        btick, ring = state.tel_prop_tick, state.tel_prop_idx.shape[-1]
        estart = torch.where(campaign | tn_ok, now1, state.tel_elect_start)
        elect_hist = ts.hist_fold(state.tel_elect_hist, win & (estart >= 0),
                                  now1 - estart, edges=edges)
        estart = torch.where(win, NONE, estart)
        c_lo = torch.maximum(bidx, bx.col(state.commit) + 1)
        c_hi = torch.minimum(bidx + bcnt - 1, bx.col(commit))
        cw = torch.clamp(c_hi - c_lo + 1, min=0)
        cfold = bx.col(can_commit) & (bidx != NONE) & (btick >= 0) \
            & (now2 - btick < ring) & (cw > 0)
        commit_hist = ts.hist_fold(state.tel_commit_hist, cfold,
                                   now2 - btick, weight=cw, edges=edges)
        # the step-down wipe (is_leader: the settled post-A/B role)
        bidx = torch.where(bx.col(is_leader), bidx, NONE)
        rsub, read_hist = state.tel_read_submit, state.tel_read_hist
        if reads_on:
            # the submit stamp mirrors R0's refill on the pre-tick registers
            rsub = torch.where(alive & (state.read_pend == 0), now1, rsub)
            read_hist = ts.hist_fold(read_hist, (rd_served | rd_blocked)
                                     & (rsub >= 0), now1 - rsub, edges=edges)
            blocked_now = bx.csum(torch.where(rd_blocked, rd_blk_cnt, 0),
                                  dtype=I32)
        else:
            blocked_now = torch.zeros(lead_shape, dtype=I32, device=dev)
        vals = bx.stack([bx.csum(commit - state.commit, dtype=I32),
                         bx.csum(win, dtype=I32),
                         bx.csum(last - snap_idx, dtype=I32), blocked_now])
        planes.update(
            tel_prop_idx=bidx, tel_elect_start=estart, tel_read_submit=rsub,
            tel_commit_hist=commit_hist, tel_elect_hist=elect_hist,
            tel_read_hist=read_hist,
            tel_series=ts.ring_write(state.tel_series, cfg.telemetry_stride,
                                     now, vals))
    phase()

    extra = dict(vg_fields, **planes)
    if tx_cool is not None:
        extra["tx_cool"] = tx_cool
    if storage_on:
        # the durable commit record folds min(commit, sync_mark), the
        # oracle's ack frontier folds commit; the one-tick fault flags clear
        extra.update(
            sync_mark=sync_mark,
            dur_commit=torch.maximum(state.dur_commit,
                                     torch.minimum(commit, sync_mark)),
            ack_frontier=torch.maximum(state.ack_frontier, commit),
            fsync_stall=torch.zeros_like(state.fsync_stall),
            snap_bad=torch.zeros_like(state.snap_bad))
    if reads_on:
        extra.update(rd.read_fields(read_regs))
    if mail:
        extra.update(boxes)
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
        member=member, pending_conf=pending_conf, hup_conf=hup_conf,
        tail_conf=tail_conf, tick=state.tick + 1, stats=stats,
        active_ttl=active_ttl, **extra)


def propose_dense(state: SimState, cfg: SimConfig,
                  payload_fn: Callable, count, alive=None, tag=None,
                  device=None) -> SimState:
    """Append `count` device-generated entries payload_fn(tick, k) (k =
    0..count-1) to every row accepting proposals, as masked stores via the
    slot->index map (banded over the live chunks when cfg.tiled).  `tag`
    is the batch's int trace tag (cfg.trace_tags).  Writes the state's
    rings (and, with telemetry on, the batch stamp) in place.

    `count` is an int, or a device tensor (the dst append_flood verb's
    gate): 0-d, or per cluster [B] on a batched state (see `step`), whose
    `alive` is [B, N] and whose payload_fn gets the tick shaped [B, 1, 1].
    A device count is not read back."""
    check_device(state, device)
    bx = Bx(batch_size(state))
    if bx.on:
        _refuse_batched(cfg, "propose_dense")
    if isinstance(count, torch.Tensor):
        count = count.to(I32)
        if bx.on:
            count = count.reshape(-1).expand(bx.B)
        cnt1, cnt2 = bx.t(count, 1), bx.t(count, 2)
    else:
        count = int(count)
        cnt1 = cnt2 = count
    ok = _leader_ok(state, cfg, alive, bx)
    anchor = state.last + cnt1

    def write(lt, ld, new_idx):
        k_of = new_idx - bx.col(state.last) - 1
        valid = bx.col(ok) & (k_of >= 0) & (k_of < cnt2)
        pl = payload_fn(bx.t(state.tick, 2),
                        torch.clamp(k_of, min=0).to(torch.int64))
        _put(lt, valid, bx.col(state.term))
        _put(ld, valid, pl & PAYLOAD_MASK)

    lt, ld = state.log_term, state.log_data
    if cfg.tiled:
        lo_p, hi_p = _read_back([torch.where(ok, state.last, BIG).amin(),
                                 torch.where(ok, anchor, 0).amax()])
        c0p, nch_p = _band_origin(cfg, lo_p, hi_p)
        if nch_p <= cfg.band_chunks:
            C = cfg.log_chunk
            for off in _band_offsets(cfg, c0p):
                write(lt[:, off:off + C], ld[:, off:off + C],
                      _idx_at_band(cfg, anchor, off))
        else:
            write(lt, ld, _idx_at_slots(cfg, anchor))
    else:
        write(lt, ld, _idx_at_slots(cfg, anchor, bx))
    if cfg.collect_telemetry and state.tel_prop_idx is not None:
        _stamp_batch(state, cfg, ok, state.last + 1, cnt1, tag, bx)
    new_last = state.last + torch.where(ok, cnt1, 0).to(I32)
    eye = torch.eye(cfg.n, dtype=torch.bool, device=lt.device)
    match = torch.where(bx.col(ok) & eye, bx.col(new_last), state.match)
    return dataclasses.replace(state, last=new_last, match=match)


def _one_cluster(state: SimState, what: str) -> None:
    """Host APIs take one cluster's state: refuse a batched one."""
    if batch_size(state) is not None:
        raise ValueError(
            f"{what} takes one cluster's state; this one has a leading "
            f"batch axis of {batch_size(state)} (drive a batch through "
            f"step, propose, propose_dense, run.submit_reads or the dst "
            f"verbs)")


def propose(state: SimState, cfg: SimConfig, payloads, count, alive=None,
            tag=None, device=None) -> SimState:
    """Append up to `count` host payload entries (payloads: [max_props]
    uint32 values, array-like; bit 31 is reserved for conf entries and
    masked off) to every row accepting proposals.  `tag` is the batch's
    int trace tag (cfg.trace_tags).  Writes the state's rings (and, with
    telemetry on, the batch stamp) in place.

    On a batched state each cluster takes its own batch, as the JAX
    package's jax.vmap(propose) gives it: payloads [B, max_props] and
    counts [B] (array-likes, or device tensors, which are not read back),
    with `alive` [B, N]."""
    dev = check_device(state, device)
    bx = Bx(batch_size(state))
    if bx.on:
        _refuse_batched(cfg, "propose")
    if bx.on or isinstance(count, torch.Tensor):
        count = torch.as_tensor(count).to(device=dev, dtype=I32)
        if bx.on:
            count = count.reshape(-1).expand(bx.B)
        cnt1, cnt2 = bx.t(count, 1), bx.t(count, 2)
    else:
        count = cnt1 = cnt2 = int(count)
    pl = payloads if isinstance(payloads, torch.Tensor) else \
        torch.from_numpy(np.asarray(payloads, dtype=np.int64))
    pl = pl.to(device=dev, dtype=torch.int64).reshape(
        (bx.B, -1) if bx.on else (-1,))
    pl = bx.row(u32.to_bits(pl & PAYLOAD_MASK))            # [.., 1, P]
    ok = _leader_ok(state, cfg, alive, bx)
    k = torch.arange(cfg.max_props, dtype=I32, device=dev)
    valid = (k < cnt2) & bx.col(ok)                          # [.., N, P]
    ix = bx.ring_ix(_slot(cfg, bx.col(state.last) + 1 + k))
    lt, ld = state.log_term, state.log_data
    lt[ix] = torch.where(valid, bx.col(state.term), lt[ix])
    ld[ix] = torch.where(valid, pl, ld[ix])
    if cfg.collect_telemetry and state.tel_prop_idx is not None:
        _stamp_batch(state, cfg, ok, state.last + 1, cnt1, tag, bx)
    new_last = state.last + torch.where(ok, cnt1, 0).to(I32)
    eye = torch.eye(cfg.n, dtype=torch.bool, device=dev)
    match = torch.where(bx.col(ok) & eye, bx.col(new_last), state.match)
    return dataclasses.replace(state, last=new_last, match=match)


def propose_conf(state: SimState, cfg: SimConfig, target, remove,
                 alive=None, device=None) -> SimState:
    """Propose ONE membership change (add or remove `target`) to every row
    accepting proposals, as a CONF entry that activates at each row's apply
    point.  While an earlier conf change is in flight on that leader
    (pending_conf), or for a target outside [0, n), the entry degrades to
    an empty normal entry.  Writes the state's rings in place; raises on a
    static_members config."""
    _one_cluster(state, "propose_conf")
    if cfg.static_members:
        raise ValueError("propose_conf on a static_members config: "
                         "membership changes need static_members=False")
    dev = check_device(state, device)
    n, target, remove = cfg.n, int(target), bool(remove)
    ok = _leader_ok(state, cfg, alive)
    appended_conf = ok & ~state.pending_conf & (0 <= target < n)
    bits = u32.to_bits(torch.tensor(conf_payload(target, remove)
                                    if 0 <= target < n else 0))
    payload = torch.where(appended_conf, bits.to(dev), 0)
    rows = torch.arange(n, device=dev)
    slot = _slot(cfg, state.last + 1)
    lt, ld = state.log_term, state.log_data
    lt[rows, slot] = torch.where(ok, state.term, lt[rows, slot])
    ld[rows, slot] = torch.where(ok, payload, ld[rows, slot])
    new_last = state.last + ok.to(I32)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    match = torch.where(ok[:, None] & eye, new_last[:, None], state.match)
    return dataclasses.replace(
        state, last=new_last, match=match,
        pending_conf=state.pending_conf | appended_conf,
        tail_conf=state.tail_conf | appended_conf)


def transfer_leadership(state: SimState, cfg: SimConfig, leader: int,
                        target: int) -> SimState:
    """Host-side transfer request: records `target` on the leader's row and
    resets its election timer; the tick fires TIMEOUT_NOW once the target's
    log caught up.  A repeat request for the same in-flight target is a
    no-op; a different target replaces the previous transfer."""
    _one_cluster(state, "transfer_leadership")
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
