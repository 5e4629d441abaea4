"""Event vocabulary and the on-device ring append (PyTorch port).

Events are fixed-width int32 rows ``(tick, code, arg0, arg1)`` (plus a
trace-tag lane when cfg.trace_tags) written into ``SimState.ev_buf``
([N, event_ring, W]) with a per-row cumulative cursor ``ev_pos``: event k
of a row lands in slot ``k % event_ring``, so old events are overwritten
and the host derives the dropped count from the cursor.  The codes, their
arguments and the ring layout are the JAX package's flightrec/codes.py;
this module owns them in the port, and the kernel imports
:func:`ring_append_many`.  The appends write the ring IN PLACE, like the
kernel's log rings.
"""

from __future__ import annotations

import torch

EVENT_WIDTH = 4         # (tick, code, arg0, arg1)
EVENT_WIDTH_TAGGED = 5  # (tick, code, arg0, arg1, tag) — cfg.trace_tags

# Codes.  args per code:
#   ELECTION_WON     arg0=new term            arg1=last log index
#   TERM_BUMP        arg0=new term            arg1=old term
#   COMMIT_ADVANCE   arg0=new commit index    arg1=advance delta
#   SNAPSHOT_RESTORE arg0=sending leader row  arg1=new snap_idx
#   FALLBACK_TICK    arg0=chunks needed       arg1=band cap (row 0 only:
#                    the tiled full-pass fallback is a cluster-wide event)
#   FAULT_EDGE       arg0=EDGE_* transition   arg1=drop degree (EDGE_DROP)
#   APPEND_REJECT    arg0=rejected leader row arg1=rejector's last index
#   READ_SERVED      arg0=applied idx served  arg1=batch size (reads)
#   READ_BLOCKED     arg0=reads refused       arg1=BLOCK_* reason
#   LEASE_EXPIRED    arg0=lease expiry tick   arg1=reads bounced with it
# Attack signatures (written by the adversary verbs of a fault schedule):
#   ATTACK_REJOIN    arg0=row's term          arg1=row's timeout
#   ATTACK_EQUIVOCATE arg0=wiped vote         arg1=row's term
#   ATTACK_FLOOD     arg0=extra proposals     arg1=leader uncommitted tail
#   ATTACK_TRANSFER  arg0=requested target    arg1=cooldown remaining
# Storage signatures (FSYNC_ADVANCE and RECOVER_REJECT_SNAP come from the
# kernel, the rest from the storage-fault verbs):
#   FSYNC_ADVANCE    arg0=new sync_mark       arg1=entries synced
#   RECOVER_TRUNCATE arg0=new last (lost_tail) arg1=entries truncated
#   RECOVER_REJECT_SNAP arg0=sending row      arg1=kept snap_idx
#   RECOVER_TORN     arg0=new last (torn)     arg1=old sync_mark
#   FSYNC_STALL      arg0=unsynced suffix     arg1=row's sync_mark
#   SNAP_CORRUPT     arg0=row's snap_idx      arg1=row's commit
ELECTION_WON = 1
TERM_BUMP = 2
COMMIT_ADVANCE = 3
SNAPSHOT_RESTORE = 4
FALLBACK_TICK = 5
FAULT_EDGE = 6
APPEND_REJECT = 7
READ_SERVED = 8
READ_BLOCKED = 9
LEASE_EXPIRED = 10
ATTACK_REJOIN = 11
ATTACK_EQUIVOCATE = 12
ATTACK_FLOOD = 13
ATTACK_TRANSFER = 14
FSYNC_ADVANCE = 15
RECOVER_TRUNCATE = 16
RECOVER_REJECT_SNAP = 17
RECOVER_TORN = 18
FSYNC_STALL = 19
SNAP_CORRUPT = 20

CODE_NAMES = {
    ELECTION_WON: "ELECTION_WON",
    TERM_BUMP: "TERM_BUMP",
    COMMIT_ADVANCE: "COMMIT_ADVANCE",
    SNAPSHOT_RESTORE: "SNAPSHOT_RESTORE",
    FALLBACK_TICK: "FALLBACK_TICK",
    FAULT_EDGE: "FAULT_EDGE",
    APPEND_REJECT: "APPEND_REJECT",
    READ_SERVED: "READ_SERVED",
    READ_BLOCKED: "READ_BLOCKED",
    LEASE_EXPIRED: "LEASE_EXPIRED",
    ATTACK_REJOIN: "ATTACK_REJOIN",
    ATTACK_EQUIVOCATE: "ATTACK_EQUIVOCATE",
    ATTACK_FLOOD: "ATTACK_FLOOD",
    ATTACK_TRANSFER: "ATTACK_TRANSFER",
    FSYNC_ADVANCE: "FSYNC_ADVANCE",
    RECOVER_TRUNCATE: "RECOVER_TRUNCATE",
    RECOVER_REJECT_SNAP: "RECOVER_REJECT_SNAP",
    RECOVER_TORN: "RECOVER_TORN",
    FSYNC_STALL: "FSYNC_STALL",
    SNAP_CORRUPT: "SNAP_CORRUPT",
}

# Codes whose 5th lane carries a host trace tag on a tagged ring: the
# commit and serve instants a host propose or read span waits on.  Every
# other code writes 0 there.
TAGGED_CODES = frozenset({COMMIT_ADVANCE, READ_SERVED})

# FAULT_EDGE arg0 values: row went down / came back / its drop degree (in
# plus out dropped edges) changed.
EDGE_DOWN = 0
EDGE_UP = 1
EDGE_DROP = 2

# READ_BLOCKED arg1 values: the row lost leadership with unstamped reads
# pending, or its lease expired without renewal.
BLOCK_DEPOSED = 0
BLOCK_LEASE = 1

I32 = torch.int32


def _lane(x, n: int, device) -> torch.Tensor:
    """An [N] int32 lane from an [N] tensor, a 0-d tensor or an int."""
    if isinstance(x, torch.Tensor):
        return x.to(I32).expand(n)
    return torch.full((n,), int(x), dtype=I32, device=device)


def ring_append(ev_buf: torch.Tensor, ev_pos: torch.Tensor,
                mask: torch.Tensor, tick, code: int, arg0, arg1, tag=None):
    """Append one event per row where `mask` [N] is True, in place.

    ev_buf [N, cap, W] (W = EVENT_WIDTH, or EVENT_WIDTH_TAGGED with the
    trace-tag lane), ev_pos [N] cumulative cursor, tick a 0-d tensor,
    arg0/arg1/tag [N] or scalar int32 (tag 0 when None; ignored on an
    untagged ring).  Rows where mask is False keep their slot and cursor.
    Returns (ev_buf, new ev_pos).

    B clusters' rings, ev_buf [B, N, cap, W] with ev_pos [B, N], mask
    [B, N] and the tick [B], append as one ring of B*N rows; each argument
    or tag broadcasts against [B, N] (a per-cluster value as [B, 1]).

    The dst verbs (dst/schedule.py) write their ATTACK_*/RECOVER_* events
    through it, one cluster's state or a batched one; the tick appends
    through ring_append_many, which the tests hold to it."""
    if ev_buf.dim() == 4:
        b, n = ev_buf.shape[:2]

        def flat(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.dtype != torch.bool:
                x = x.to(I32)
            return x.expand(b, n).reshape(-1)

        tick_rows = torch.as_tensor(tick, device=ev_buf.device).to(I32) \
            .reshape(-1, 1).expand(b, n).reshape(-1)
        _, pos = ring_append(
            ev_buf.view((b * n,) + ev_buf.shape[2:]), ev_pos.reshape(-1),
            flat(mask), tick_rows, code, flat(arg0), flat(arg1), flat(tag))
        return ev_buf, pos.view(b, n)
    n, cap, width = ev_buf.shape
    dev = ev_buf.device
    node = torch.arange(n, device=dev)
    slot = torch.remainder(ev_pos, cap).to(torch.int64)
    lanes = [_lane(tick, n, dev), _lane(code, n, dev), _lane(arg0, n, dev),
             _lane(arg1, n, dev)]
    if width == EVENT_WIDTH_TAGGED:
        lanes.append(_lane(0 if tag is None else tag, n, dev))
    row = torch.stack(lanes, dim=-1)
    cur = ev_buf[node, slot]
    ev_buf[node, slot] = torch.where(mask[:, None], row, cur)
    return ev_buf, ev_pos + mask.to(I32)


def ring_append_many(ev_buf: torch.Tensor, ev_pos: torch.Tensor, tick,
                     events: list, codes: torch.Tensor):
    """Append a tick's events in one scatter, in place: the same bits as
    calling ring_append once per event in list order.

    events: (mask, arg0, arg1, tag) per event, masks [N] bool, args [N]
    or 0-d int32, tag None or [N]; codes: their [K] int32 codes on the
    ring's device.  On each row the masked events take consecutive slots
    from the cursor; where a row appends more than `cap` events in one
    tick, only the last `cap` of them are written, as the sequential
    appends leave it.

    B clusters' rings, ev_buf [B, N, cap, W] with ev_pos [B, N] and the
    tick [B], append as one ring of B*N rows: masks are [B, N], and each
    argument or tag broadcasts against [B, N] (a per-cluster value as
    [B, 1])."""
    if ev_buf.dim() == 4:
        b, n = ev_buf.shape[:2]

        def flat(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.dtype != torch.bool:
                x = x.to(I32)
            return x.expand(b, n).reshape(-1)

        tick_rows = torch.as_tensor(tick, device=ev_buf.device).to(I32) \
            .reshape(-1, 1).expand(b, n).reshape(-1)
        _, pos = ring_append_many(
            ev_buf.view((b * n,) + ev_buf.shape[2:]), ev_pos.reshape(-1),
            tick_rows, [tuple(flat(x) for x in e) for e in events], codes)
        return ev_buf, pos.view(b, n)
    n, cap, width = ev_buf.shape
    dev = ev_buf.device
    k = len(events)
    consts: dict = {}

    def lane(x):
        # one [N] fill per distinct int argument of the tick
        if isinstance(x, torch.Tensor):
            return _lane(x, n, dev)
        if x not in consts:
            consts[x] = _lane(x, n, dev)
        return consts[x]

    m = torch.stack([e[0] for e in events], dim=1)                 # [N, K]
    lanes = [_lane(tick, n, dev)[:, None].expand(n, k),
             codes.to(I32)[None, :].expand(n, k),
             torch.stack([lane(e[1]) for e in events], dim=1),
             torch.stack([lane(e[2]) for e in events], dim=1)]
    if width == EVENT_WIDTH_TAGGED:
        lanes.append(torch.stack([lane(0 if e[3] is None else e[3])
                                  for e in events], dim=1))
    rows = torch.stack(lanes, dim=-1)                              # [N, K, W]
    mi = m.to(I32)
    before = mi.cumsum(1, dtype=I32) - mi          # masked events before k
    after = mi.sum(1, dtype=I32)[:, None] - before - mi
    keep = m & (after < cap)
    slot = torch.remainder(ev_pos[:, None] + before, cap).to(torch.int64)
    node = torch.arange(n, device=dev)[:, None].expand(n, k)
    # the kept events' slots are distinct on each row; every other entry
    # adds 0 where it points, so the accumulate is exact in any order
    cur = ev_buf[node, slot]
    delta = torch.where(keep[:, :, None], rows - cur, 0)
    ev_buf.index_put_((node, slot), delta, accumulate=True)
    return ev_buf, ev_pos + mi.sum(1, dtype=I32)
