"""Tensor state for the batched raft simulation (PyTorch port).

N simulated managers are rows of tensors: per-node scalars are [N], the
leader's per-peer progress view is [N, N], and each node's log is a
fixed-width ring buffer [N, L] with a compaction watermark (snap_idx).
Field names, shapes, defaults and the optional-field gating follow the JAX
package's raft/sim/state.py one for one, so a state carries across with
`state_from_numpy` / `state_to_numpy`.

uint32 fields (log_data, snap_chk, apply_chk) are int32 tensors holding the
same bits (see u32.py).  Node indices are 0-based; `NONE` is -1.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
# The plane sizes have single owners (the flight ring's row widths, the
# telemetry bucket count, series rows and default propose-batch ring);
# the names stay importable from here.
from swarmkit_tpu_torch.flightrec.codes import (  # noqa: F401
    EVENT_WIDTH, EVENT_WIDTH_TAGGED,
)
from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.telemetry.series import (  # noqa: F401
    NUM_BUCKETS, NUM_SERIES, PROP_RING,
)

# Roles
FOLLOWER = 0
CANDIDATE = 1
LEADER = 2

NONE = -1

# Conf-change payload tags: bit 31 = conf entry, bit 30 = remove (else
# add), low 16 bits = target row.
CONF_TAG = 0x8000_0000
CONF_REMOVE = 0x4000_0000
CONF_TARGET_MASK = 0xFFFF

I32 = torch.int32

# SimState fields that hold uint32 values as int32 bit patterns.
U32_FIELDS = frozenset({"log_data", "snap_chk", "apply_chk"})


def conf_payload(target: int, remove: bool) -> int:
    """uint32 payload encoding one ConfChange (add/remove of `target`)."""
    return CONF_TAG | (CONF_REMOVE if remove else 0) | (target & CONF_TARGET_MASK)


def check_device(state: "SimState", device=None) -> torch.device:
    """Resolve `device` and require the state to live there."""
    dev = resolve_device(device)
    if state.term.device.type != dev.type:
        raise ValueError(f"state lives on {state.term.device}, but the call "
                         f"runs on {dev}; move it with state_from_numpy")
    return dev


@dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters: the JAX package's SimConfig field for
    field, with the same defaults, properties and validation, so a config
    is written the same way in both packages.
    """

    n: int = 64                 # simulated managers
    log_len: int = 8192         # ring-buffer slots per manager (L)
    window: int = 1024          # max entries per append message (W)
    apply_batch: int = 2048     # entries applied per node per tick
    max_props: int = 1024       # proposal batch width
    election_tick: int = 10
    heartbeat_tick: int = 1
    keep: int = 500             # entries kept behind `applied` at compaction
    seed: int = 0
    # per-edge message latency (0/0 = the tick-synchronous wire)
    latency: int = 0
    latency_jitter: int = 0
    inflight: int = 1           # append pipelining depth (mailbox wire)
    force_mailboxes: bool = False
    collect_stats: bool = False  # cumulative [4] event counters
    pre_vote: bool = False
    static_members: bool = False
    record_events: bool = False  # flight recorder
    event_ring: int = 128
    log_chunk: int = 1024       # tiled log axis chunk width (0 = full pass)
    peer_chunk: int = 1024      # banded peer reductions (0 = dense)
    active_rows: int = 16       # role-sparse progress slab (0 = dense)
    read_batch: int = 0         # linearizable read path
    read_leases: bool = True
    lease_margin: int = 1
    collect_telemetry: bool = False
    telemetry_window: int = 64
    telemetry_stride: int = 8
    telemetry_prop_ring: int = 0
    trace_tags: bool = False
    slo_p99_commit_ticks: int = 0
    check_quorum: bool = True
    vote_guard: bool = False
    transfer_cooldown_ticks: int = 0
    prop_inflight_cap: int = 0
    slo_leader_changes: int = 0
    slo_log_occupancy: int = 0
    fsync_lag_ticks: int = 0    # storage model master knob
    fsync_batch: int = 0
    ack_gating: bool = False
    slo_fsync_lag: int = 0

    @property
    def lease_ticks(self) -> int:
        return self.election_tick - self.lease_margin \
            - (self.latency + self.latency_jitter)

    @property
    def tiled(self) -> bool:
        """True when the kernel runs the banded (chunked) log passes."""
        return 0 < self.log_chunk < self.log_len

    @property
    def num_chunks(self) -> int:
        return self.log_len // self.log_chunk

    @property
    def band_chunks(self) -> int:
        """Cap on chunks one banded pass visits: the widest per-tick cursor
        advance plus two boundary chunks.  A wider band falls back to the
        full pass."""
        widest = max(self.window, self.apply_batch, self.max_props,
                     self.keep)
        return widest // self.log_chunk + 2

    @property
    def peer_tiled(self) -> bool:
        return 0 < self.peer_chunk < self.n

    @property
    def num_peer_chunks(self) -> int:
        return self.n // self.peer_chunk

    @property
    def active_rows_on(self) -> bool:
        return 0 < self.active_rows < self.n

    @property
    def ack_depth(self) -> int:
        return self.latency + self.latency_jitter + 1

    @property
    def mailboxes(self) -> bool:
        return self.latency > 0 or self.latency_jitter > 0 \
            or self.force_mailboxes

    @property
    def storage_on(self) -> bool:
        return self.fsync_lag_ticks > 0

    @property
    def event_width(self) -> int:
        return EVENT_WIDTH_TAGGED if self.trace_tags else EVENT_WIDTH

    @property
    def has_vote_guard(self) -> bool:
        return self.vote_guard or self.storage_on

    def __post_init__(self):
        if self.apply_batch < self.max_props:
            raise ValueError(f"apply_batch={self.apply_batch} must be >= "
                             f"max_props={self.max_props}")
        if self.log_len <= self.keep + 2 * self.max_props + self.window:
            raise ValueError(
                f"log_len={self.log_len} must exceed keep + 2*max_props + "
                f"window = {self.keep + 2 * self.max_props + self.window}")
        if self.latency < 0 or self.latency_jitter < 0:
            raise ValueError("latency and latency_jitter must be >= 0")
        if self.inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {self.inflight}")
        if self.inflight != 1 and not self.mailboxes:
            raise ValueError("append pipelining requires the mailbox wire")
        if self.mailboxes \
                and 2 * (self.latency + self.latency_jitter) \
                >= self.election_tick:
            raise ValueError("a full round trip must fit inside the "
                             "election timeout")
        if self.read_batch < 0:
            raise ValueError(f"read_batch must be >= 0, got {self.read_batch}")
        if self.read_batch and self.read_leases:
            if self.lease_margin < 1:
                raise ValueError(
                    f"lease_margin={self.lease_margin} must be >= 1: the "
                    f"margin is the clock-skew guard keeping lease expiry "
                    f"strictly before the earliest rival election")
            if self.lease_ticks <= 0:
                raise ValueError(
                    f"lease_ticks={self.lease_ticks} must be > 0 — raise "
                    f"election_tick or set read_leases=False")
        if self.record_events and self.event_ring < 8:
            raise ValueError(
                f"event_ring={self.event_ring} is too small to hold one "
                f"tick's worth of events; use >= 8 slots per row")
        if self.log_chunk < 0:
            raise ValueError(f"log_chunk must be >= 0, got {self.log_chunk}")
        if self.tiled:
            if self.log_chunk % 128 != 0:
                raise ValueError(
                    f"log_chunk={self.log_chunk} must be a multiple of 128; "
                    f"set log_chunk=0 to disable tiling")
            if self.log_len % self.log_chunk != 0:
                raise ValueError(
                    f"log_chunk={self.log_chunk} must divide "
                    f"log_len={self.log_len}; set log_chunk=0 to disable "
                    f"tiling")
            if self.band_chunks >= self.num_chunks:
                raise ValueError(
                    f"band_chunks={self.band_chunks} must stay below "
                    f"num_chunks={self.num_chunks} or the banded pass "
                    f"covers the whole ring — raise log_len, raise "
                    f"log_chunk, or set log_chunk=0 to disable tiling")
        if self.collect_telemetry:
            if self.telemetry_stride < 1:
                raise ValueError(
                    f"telemetry_stride={self.telemetry_stride} must be >= 1")
            if self.telemetry_window < 8:
                raise ValueError(
                    f"telemetry_window={self.telemetry_window} is too "
                    f"small; use >= 8 columns")
            if self.telemetry_prop_ring < 0 or \
                    0 < self.telemetry_prop_ring < 16:
                raise ValueError(
                    f"telemetry_prop_ring={self.telemetry_prop_ring} "
                    f"must be 0 (default depth) or >= 16")
        if self.trace_tags and not (self.record_events
                                    and self.collect_telemetry):
            raise ValueError(
                "trace_tags needs both donor planes: set "
                "record_events=True and collect_telemetry=True")
        for knob in ("slo_p99_commit_ticks", "transfer_cooldown_ticks",
                     "prop_inflight_cap", "slo_leader_changes",
                     "slo_log_occupancy", "fsync_lag_ticks", "fsync_batch",
                     "slo_fsync_lag", "peer_chunk", "active_rows"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob} must be >= 0, got {getattr(self, knob)}")
        for knob in ("slo_p99_commit_ticks", "slo_leader_changes"):
            if getattr(self, knob) > 0 and not self.collect_telemetry:
                raise ValueError(f"{knob} needs the telemetry histograms; "
                                 f"set collect_telemetry=True")
        if not self.storage_on:
            for knob in ("fsync_batch", "ack_gating", "slo_fsync_lag"):
                if getattr(self, knob):
                    raise ValueError(
                        f"{knob} requires the storage model; set "
                        f"fsync_lag_ticks >= 1 (1 = fsync every tick)")
        if self.peer_tiled:
            if self.peer_chunk % 8 != 0:
                raise ValueError(
                    f"peer_chunk={self.peer_chunk} must be a multiple of 8; "
                    f"set peer_chunk=0 to disable peer tiling")
            if self.n % self.peer_chunk != 0:
                raise ValueError(
                    f"peer_chunk={self.peer_chunk} must divide n={self.n}; "
                    f"set peer_chunk=0 to disable peer tiling")
        if self.active_rows_on and self.active_rows % 8 != 0:
            raise ValueError(
                f"active_rows={self.active_rows} must be a multiple of 8; "
                f"set active_rows=0 to disable the sparse progress lowering")


@dataclass
class SimState:
    # per-node scalars [N]
    term: torch.Tensor
    vote: torch.Tensor         # voted-for node index, NONE if none
    role: torch.Tensor         # FOLLOWER / CANDIDATE / LEADER
    lead: torch.Tensor         # known leader index, NONE if unknown
    elapsed: torch.Tensor      # election timer
    contact: torch.Tensor      # ticks since last current-term leader contact
    hb_elapsed: torch.Tensor   # leader heartbeat timer
    timeout: torch.Tensor      # randomized election timeout in ticks
    last: torch.Tensor         # last log index
    commit: torch.Tensor
    applied: torch.Tensor
    snap_idx: torch.Tensor     # compaction watermark (log holds (snap_idx, last])
    snap_term: torch.Tensor
    snap_chk: torch.Tensor     # checksum at snap_idx (uint32 bits)
    apply_chk: torch.Tensor    # checksum at applied (uint32 bits)
    # log ring buffers [N, L]; slot of index i (1-based) = (i-1) % L
    log_term: torch.Tensor
    log_data: torch.Tensor     # payload ids (uint32 bits)
    # leader-view progress [N, N]: row i = node i's view as (potential) leader
    match: torch.Tensor
    next_: torch.Tensor
    granted: torch.Tensor      # bool: j voted for i this term
    rejected: torch.Tensor     # bool: j refused i this term
    pre: torch.Tensor          # bool [N]: candidacy is a PreVote poll
    transferee: torch.Tensor   # [N]: pending transfer target while leading
    tx_cand: torch.Tensor      # bool [N]: candidacy forced by TIMEOUT_NOW
    tn_at: torch.Tensor        # [N]: TIMEOUT_NOW wire, deliver tick+1
    tn_term: torch.Tensor
    tn_from: torch.Tensor
    recent_active: torch.Tensor  # bool [N, N]: heard since last CheckQuorum
    member: torch.Tensor       # bool [N, N]: row i's applied configuration
    pending_conf: torch.Tensor
    hup_conf: torch.Tensor
    tail_conf: torch.Tensor
    tick: torch.Tensor         # scalar tick counter
    stats: Optional[torch.Tensor] = None   # [4] (cfg.collect_stats)
    active_ttl: Optional[torch.Tensor] = None
    vg_vote: Optional[torch.Tensor] = None
    vg_term: Optional[torch.Tensor] = None
    tx_cool: Optional[torch.Tensor] = None
    sync_mark: Optional[torch.Tensor] = None
    dur_commit: Optional[torch.Tensor] = None
    ack_frontier: Optional[torch.Tensor] = None
    fsync_stall: Optional[torch.Tensor] = None
    snap_bad: Optional[torch.Tensor] = None
    ev_buf: Optional[torch.Tensor] = None
    ev_pos: Optional[torch.Tensor] = None
    ev_alive: Optional[torch.Tensor] = None
    ev_drop: Optional[torch.Tensor] = None
    read_pend: Optional[torch.Tensor] = None
    read_goal: Optional[torch.Tensor] = None
    read_idx: Optional[torch.Tensor] = None
    lease_until: Optional[torch.Tensor] = None
    read_srv: Optional[torch.Tensor] = None
    read_block: Optional[torch.Tensor] = None
    read_srv_idx: Optional[torch.Tensor] = None
    read_srv_goal: Optional[torch.Tensor] = None
    tel_prop_idx: Optional[torch.Tensor] = None
    tel_prop_cnt: Optional[torch.Tensor] = None
    tel_prop_tick: Optional[torch.Tensor] = None
    tel_prop_tag: Optional[torch.Tensor] = None
    read_tag: Optional[torch.Tensor] = None
    tel_elect_start: Optional[torch.Tensor] = None
    tel_read_submit: Optional[torch.Tensor] = None
    tel_commit_hist: Optional[torch.Tensor] = None
    tel_elect_hist: Optional[torch.Tensor] = None
    tel_read_hist: Optional[torch.Tensor] = None
    tel_series: Optional[torch.Tensor] = None
    # in-flight mailboxes (cfg.mailboxes)
    vreq_at: Optional[torch.Tensor] = None
    vreq_term: Optional[torch.Tensor] = None
    vreq_pre: Optional[torch.Tensor] = None
    vresp_at: Optional[torch.Tensor] = None
    vresp_term: Optional[torch.Tensor] = None
    vresp_grant: Optional[torch.Tensor] = None
    vresp_pre: Optional[torch.Tensor] = None
    app_at: Optional[torch.Tensor] = None
    app_prev: Optional[torch.Tensor] = None
    app_term: Optional[torch.Tensor] = None
    snp_at: Optional[torch.Tensor] = None
    snp_term: Optional[torch.Tensor] = None
    probing: Optional[torch.Tensor] = None
    aresp_at: Optional[torch.Tensor] = None
    aresp_term: Optional[torch.Tensor] = None
    aresp_match: Optional[torch.Tensor] = None
    aresp_ok: Optional[torch.Tensor] = None
    hb_at: Optional[torch.Tensor] = None
    hb_term: Optional[torch.Tensor] = None
    hb_commit: Optional[torch.Tensor] = None
    hbr_at: Optional[torch.Tensor] = None
    hbr_term: Optional[torch.Tensor] = None


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(SimState))


def init_state(cfg: SimConfig, voters: Optional[Sequence[int]] = None,
               device=None) -> SimState:
    """Fresh cluster state on `device` (the CUDA card unless the caller
    names another).  `voters` is the bootstrap configuration (row indexes);
    default: all N rows."""
    dev = resolve_device(device)
    n, L = cfg.n, cfg.log_len
    b = torch.bool

    def z(*s):
        return torch.zeros(s, dtype=I32, device=dev)

    def full(s, v, dtype=I32):
        return torch.full(s, v, dtype=dtype, device=dev)

    if cfg.static_members and voters is not None:
        raise ValueError("static_members requires the full bootstrap config "
                         "(voters=None); partial configs need conf changes")
    member_row = torch.ones((n,), dtype=b, device=dev)
    if voters is not None:
        member_row = torch.zeros((n,), dtype=b, device=dev)
        member_row[torch.as_tensor(list(voters), dtype=torch.int64,
                                   device=dev)] = True
    fields = {}
    if cfg.mailboxes:
        d, k = cfg.ack_depth, cfg.inflight
        fields.update(
            vreq_at=z(n, n), vreq_term=z(n, n), vreq_pre=full((n, n), 0, b),
            vresp_pre=full((n, n), 0, b), vresp_at=z(n, n),
            vresp_term=z(n, n), vresp_grant=full((n, n), 0, b),
            app_at=z(n, n, k), app_prev=z(n, n, k), app_term=z(n, n, k),
            snp_at=z(n, n), snp_term=z(n, n), probing=full((n, n), 1, b),
            aresp_at=z(n, n, d), aresp_term=z(n, n, d),
            aresp_match=z(n, n, d), aresp_ok=full((n, n, d), 0, b),
            hb_at=z(n, n, d), hb_term=z(n, n, d), hb_commit=z(n, n, d),
            hbr_at=z(n, n, d), hbr_term=z(n, n, d))
    if cfg.collect_stats:
        fields["stats"] = z(4)
    if cfg.active_rows_on:
        fields["active_ttl"] = z(n)
    if cfg.has_vote_guard:
        fields.update(vg_vote=full((n,), NONE), vg_term=full((n,), NONE))
    if cfg.transfer_cooldown_ticks > 0:
        fields["tx_cool"] = z(n)
    if cfg.storage_on:
        fields.update(sync_mark=z(n), dur_commit=z(n), ack_frontier=z(n),
                      fsync_stall=full((n,), 0, b),
                      snap_bad=full((n,), 0, b))
    if cfg.record_events:
        fields.update(ev_buf=z(n, cfg.event_ring, cfg.event_width),
                      ev_pos=z(n), ev_alive=full((n,), 1, b), ev_drop=z(n))
    if cfg.read_batch > 0:
        fields.update(read_pend=z(n), read_goal=z(n),
                      read_idx=full((n,), NONE), lease_until=z(n),
                      read_srv=z(n), read_block=z(n), read_srv_idx=z(n),
                      read_srv_goal=z(n))
    ring = cfg.telemetry_prop_ring or PROP_RING
    if cfg.collect_telemetry:
        fields.update(
            tel_prop_idx=full((n, ring), NONE), tel_prop_cnt=z(n, ring),
            tel_prop_tick=full((n, ring), NONE),
            tel_elect_start=full((n,), NONE),
            tel_read_submit=full((n,), NONE),
            tel_commit_hist=z(NUM_BUCKETS), tel_elect_hist=z(NUM_BUCKETS),
            tel_read_hist=z(NUM_BUCKETS),
            tel_series=z(NUM_SERIES, cfg.telemetry_window))
    if cfg.trace_tags:
        fields["tel_prop_tag"] = z(n, ring)
        if cfg.read_batch > 0:
            fields["read_tag"] = z(n)
    return SimState(
        term=z(n), vote=full((n,), NONE), role=z(n), lead=full((n,), NONE),
        elapsed=z(n), contact=z(n), hb_elapsed=z(n),
        timeout=_initial_timeouts(cfg, dev),
        last=z(n), commit=z(n), applied=z(n),
        snap_idx=z(n), snap_term=z(n), snap_chk=z(n), apply_chk=z(n),
        log_term=z(n, L), log_data=z(n, L),
        match=z(n, n), next_=full((n, n), 1), granted=full((n, n), 0, b),
        rejected=full((n, n), 0, b), pre=full((n,), 0, b),
        transferee=full((n,), NONE), tx_cand=full((n,), 0, b),
        tn_at=z(n), tn_term=z(n), tn_from=z(n),
        recent_active=full((n, n), 0, b),
        member=member_row.expand(n, n).contiguous(),
        pending_conf=full((n,), 0, b), hup_conf=full((n,), 0, b),
        tail_conf=full((n,), 0, b),
        tick=torch.zeros((), dtype=I32, device=dev),
        **fields)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style integer mix of x's low 32 bits, as uint32 bits —
    the deterministic PRNG behind election timeouts and drop matrices."""
    return u32.to_bits(u32.hash32(u32.unsigned(x)))


def rand_timeout(cfg: SimConfig, node: torch.Tensor,
                 term: torch.Tensor) -> torch.Tensor:
    """Randomized election timeout in [election_tick, 2*election_tick),
    deterministic per (node, term, seed)."""
    h = u32.hash32(u32.mul(u32.unsigned(node), 0x9E3779B1)
                   ^ u32.mul(u32.unsigned(term), 0x85EBCA77)
                   ^ (cfg.seed & u32.MASK))
    return (cfg.election_tick + h % cfg.election_tick).to(I32)


def _initial_timeouts(cfg: SimConfig, device) -> torch.Tensor:
    node = torch.arange(cfg.n, dtype=I32, device=device)
    return rand_timeout(cfg, node, torch.zeros_like(node))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I32, device=like.device)


def latency_at(cfg: SimConfig, tick, i: torch.Tensor,
               j: torch.Tensor) -> torch.Tensor:
    """Per-edge latency for broadcastable sender/receiver index tensors;
    latency_matrix(cfg, t)[i, j] == latency_at(cfg, t, i, j)."""
    shape = torch.broadcast_shapes(i.shape, j.shape)
    base = torch.full(shape, cfg.latency, dtype=I32, device=i.device)
    if cfg.latency_jitter == 0:
        return base
    h = u32.hash32(u32.mul(u32.unsigned(i), 0x9E3779B1)
                   ^ u32.mul(u32.unsigned(j), 0x01000193)
                   ^ u32.mul(u32.unsigned(_scalar(tick, i)), 0xC2B2AE35)
                   ^ ((cfg.seed ^ 0x7A77) & u32.MASK))
    return base + (h % (cfg.latency_jitter + 1)).to(I32)


def latency_matrix(cfg: SimConfig, tick, device=None) -> torch.Tensor:
    """[N, N] per-message latency in ticks for messages sent this tick."""
    i = torch.arange(cfg.n, dtype=I32, device=resolve_device(device))
    return latency_at(cfg, tick, i[:, None], i[None, :])


def drop_matrix(cfg: SimConfig, tick, rate: float,
                device=None) -> torch.Tensor:
    """Per-edge Bernoulli message-drop mask for this tick: drop[i, j] = True
    drops messages i -> j.  The float32 compare matches the JAX package's
    bit for bit (uint32 -> float32 rounds to nearest, /2**32 is exact)."""
    dev = tick.device if isinstance(tick, torch.Tensor) \
        else resolve_device(device)
    i = u32.unsigned(torch.arange(cfg.n, dtype=I32, device=dev))
    t = u32.unsigned(torch.as_tensor(tick, dtype=I32, device=dev))
    h = u32.hash32(u32.mul(i[:, None], 0x01000193)
                   ^ u32.mul(i[None, :], 0x9E3779B1)
                   ^ u32.mul(t, 0x85EBCA77)
                   ^ ((cfg.seed ^ 0xD1FF) & u32.MASK))
    f32 = torch.float32
    return (h.to(f32) / torch.tensor(2.0 ** 32, dtype=f32, device=dev)) \
        < torch.tensor(rate, dtype=f32, device=dev)


def state_from_numpy(d: dict, device=None) -> SimState:
    """SimState from numpy arrays keyed by field name (absent or None =
    field off).  uint32 arrays enter as their int32 bit patterns."""
    dev = resolve_device(device)
    out = {}
    for name in FIELD_NAMES:
        a = d.get(name)
        if a is None:
            continue
        # a C-ordered copy (np.ascontiguousarray would turn a 0-d tick
        # into shape [1], and the caller's array may be read-only)
        a = np.array(a, order="C", copy=True)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(a).to(dev)
    return SimState(**out)


def state_to_numpy(state: SimState) -> dict:
    """Copy every present field to numpy; the uint32 fields come back as
    uint32 views of their bits."""
    out = {}
    for name in FIELD_NAMES:
        t = getattr(state, name)
        if t is None:
            continue
        a = t.detach().cpu().numpy().copy()
        out[name] = a.view(np.uint32) if name in U32_FIELDS else a
    return out
