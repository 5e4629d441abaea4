"""Simulation loops for the bench flow (PyTorch port).

The JAX package compiles these as `lax.scan` / `lax.while_loop` programs;
here they are host loops over `kernel.step`, one tick per iteration.
`run_until_leader` reads `has_leader` back every tick; `run_ticks` and
`run_schedule` only sync where `step` does (its branch choices).

A state with a leading batch axis (B clusters, kernel.step) runs through
`run_schedule` with [B, T, ...] schedules; `leader_mask`, `has_leader`,
`committed_entries` and the trace rows are then per cluster (value
reductions inside each cluster, as JAX's vmap gives them).

`KernelObs` is the host side of the kernel's counters (stats, reads,
durability): `timed` around a run-loop call and `publish` after one, which
reads the device counters back (that is its job, and no run loop calls it
inside a run).  `sync_point` records a tick <-> wall-clock sample for the
trace export.
"""

from __future__ import annotations

import dataclasses

import torch

from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.metrics import scrape as obs_scrape
from swarmkit_tpu_torch.raft.sim.kernel import _first_true, step
from swarmkit_tpu_torch.raft.sim.state import (
    LEADER, NONE, SimConfig, SimState, batch_size, check_device, drop_matrix,
)

I32 = torch.int32
U32_MASK = 0xFFFF_FFFF


def _batched(state: SimState) -> bool:
    return batch_size(state) is not None


def leader_mask(state: SimState) -> torch.Tensor:
    if _batched(state):
        return (state.role == LEADER) \
            & torch.diagonal(state.member, dim1=-2, dim2=-1)
    return (state.role == LEADER) & torch.diagonal(state.member)


def has_leader(state: SimState) -> torch.Tensor:
    """Some row leads ([B] per cluster on a batched state)."""
    if _batched(state):
        return leader_mask(state).any(-1)
    return leader_mask(state).any()


def _payload_at(tick, k: torch.Tensor) -> torch.Tensor:
    """Deterministic payload id for proposal k of `tick`, as uint32 bits:
    tick * 2**16 + k + 1 (mod 2**32), so the applied checksum detects loss
    or reorder.  k is an integer tensor of any shape."""
    t = u32.unsigned(torch.as_tensor(tick, dtype=I32, device=k.device))
    return u32.to_bits(t * (1 << 16) + u32.unsigned(k) + 1)


def _trace_row(st: SimState) -> torch.Tensor:
    """[n_leaders, max_commit, max_term]: value reductions, per cluster
    ([B, 3]) on a batched state."""
    if _batched(st):
        return torch.stack([leader_mask(st).sum(-1, dtype=I32),
                            st.commit.amax(-1), st.term.amax(-1)], dim=-1)
    return torch.stack([leader_mask(st).sum(dtype=I32), st.commit.amax(),
                        st.term.amax()])


def _tick(st: SimState, cfg: SimConfig, alive, drop, prop_count: int, dev,
          prop_tag=None):
    """One step, proposing `prop_count` entries through the fused propose
    when it is nonzero."""
    if prop_count:
        return step(st, cfg, alive=alive, drop=drop, prop_count=prop_count,
                    payload_fn=_payload_at, prop_tag=prop_tag, device=dev)
    return step(st, cfg, alive=alive, drop=drop, device=dev)


def _stack_trace(trace: list, dev) -> torch.Tensor:
    if not trace:
        return torch.zeros((0, 3), dtype=I32, device=dev)
    return torch.stack(trace)


def run_ticks(state: SimState, cfg: SimConfig, n_ticks: int,
              prop_count: int = 0, drop_rate: float = 0.0,
              crash_every: int = 0, down_for: int = 5, prop_tag=None,
              device=None):
    """Advance n_ticks.  Per tick: optionally propose `prop_count` entries
    to the current leader(s) (the fused propose), optionally drop traffic
    per edge at `drop_rate`, and optionally crash the sitting leader every
    `crash_every` ticks for `down_for` ticks.  `prop_tag` is the int trace
    tag of every proposed batch of the run (cfg.trace_tags; a caller's
    span around the call, metrics/trace.py span_trace_tag).

    Returns (final_state, trace) where trace is [n_ticks, 3] int32 rows
    [n_leaders, max_commit, max_term].  Consumes the state (see step).
    """
    dev = check_device(state, device)
    n = cfg.n
    rows = torch.arange(n, dtype=I32, device=dev)
    downed = torch.tensor(-1, dtype=I32, device=dev)
    down_left = torch.tensor(0, dtype=I32, device=dev)
    st, trace = state, []
    for _ in range(n_ticks):
        tick = st.tick
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        if crash_every:
            lm = leader_mask(st)
            crash = (tick % crash_every == 0) & (tick > 0) & lm.any()
            downed = torch.where(crash, _first_true(lm, 0), downed)
            down_left = torch.where(crash, down_for,
                                    torch.clamp(down_left - 1, min=0))
            alive = alive & ~((rows == downed) & (down_left > 0))
        drop = drop_matrix(cfg, tick, drop_rate) if drop_rate else None
        st = _tick(st, cfg, alive, drop, prop_count, dev, prop_tag)
        trace.append(_trace_row(st))
    return st, _stack_trace(trace, dev)


def run_schedule(state: SimState, cfg: SimConfig, drop: torch.Tensor,
                 alive: torch.Tensor, prop_count: int = 0, device=None):
    """Advance len(drop) ticks under a fault schedule given as tensors: drop
    is [T, N, N] per-tick edge drops, alive is [T, N] row liveness (the
    schedule shape the JAX package's DST layer generates; run_ticks instead
    derives its faults from scalar knobs).  Optionally proposes
    `prop_count` entries per tick through the fused propose.  A batched
    state takes [B, T, N, N] and [B, T, N] schedules, one per cluster.

    Returns (final_state, trace) with run_ticks' trace rows ([B, T, 3] on
    a batched state).  Consumes the state (see step).
    """
    dev = check_device(state, device)
    st, trace = state, []
    if _batched(state):
        for t in range(drop.shape[1]):
            st = _tick(st, cfg, alive[:, t], drop[:, t], prop_count, dev)
            trace.append(_trace_row(st))
        if not trace:
            return st, torch.zeros((drop.shape[0], 0, 3), dtype=I32,
                                   device=dev)
        return st, torch.stack(trace, dim=1)
    for drop_t, alive_t in zip(drop, alive):
        st = _tick(st, cfg, alive_t, drop_t, prop_count, dev)
        trace.append(_trace_row(st))
    return st, _stack_trace(trace, dev)


def run_until_leader(state: SimState, cfg: SimConfig, max_ticks: int = 1000,
                     device=None):
    """Tick until some node is leader (or max_ticks pass).  Returns
    (state, ticks_taken).  Consumes the state (see step)."""
    dev = check_device(state, device)
    st, t = state, 0
    while t < max_ticks and not bool(has_leader(st)):
        st = step(st, cfg, device=dev)
        t += 1
    return st, t


def submit_reads(state: SimState, cfg: SimConfig, count: int, rows=None,
                 tag=None, device=None) -> SimState:
    """Enqueue a linearizable read batch of `count` ops on the selected rows
    (all rows when `rows` is None); the next `step` stamps and serves it.
    Like the kernel's own refill, only rows whose previous batch drained
    take one, and each records max(commit) as its linearizability goal.
    Needs cfg.read_batch > 0 (the read registers).  `tag` is the batch's
    int trace tag (cfg.trace_tags; metrics/trace.py span_trace_tag): the
    READ_SERVED event that settles it carries the tag.

    On a batched state `count` is one count per cluster ([B] array-like,
    or a device tensor, which is not read back) and each cluster's goal is
    its own max(commit), as the JAX package's jax.vmap(submit_reads)
    gives them; `rows` then selects the same rows in every cluster."""
    dev = check_device(state, device)
    if state.read_pend is None:
        raise ValueError("read path is off (SimConfig.read_batch == 0); "
                         "no read registers to submit into")
    batched = _batched(state)
    if batched and cfg.trace_tags:
        raise ValueError("submit_reads on a batched state does not run "
                         "cfg.trace_tags (trace tags under a batch axis, "
                         "ROADMAP Queue 1 #1); use an unbatched state")
    sel = torch.ones((cfg.n,), dtype=torch.bool, device=dev)
    if rows is not None:
        sel = torch.zeros_like(sel)
        sel[torch.as_tensor(rows, dtype=torch.int64, device=dev)] = True
    open_ = sel & (state.read_pend == 0)
    # the goal: each cluster's acked-write frontier (a value reduction)
    if batched:
        count = torch.as_tensor(count).to(device=dev, dtype=I32) \
            .reshape(-1, 1)
        goal = state.commit.amax(-1, keepdim=True)
    else:
        count, goal = int(count), state.commit.amax()
    tag_fields = {}
    if cfg.trace_tags and state.read_tag is not None:
        tag_fields["read_tag"] = torch.where(
            open_, 0 if tag is None else int(tag), state.read_tag)
    return dataclasses.replace(
        state,
        read_pend=torch.where(open_, count, state.read_pend),
        read_goal=torch.where(open_, goal, state.read_goal),
        read_idx=torch.where(open_, NONE, state.read_idx), **tag_fields)


class KernelObs:
    """Host-side observability for the device kernel (the JAX package's
    KernelObs; metrics/catalog.py's swarm_kernel_* families).

    - ``timed(call)``: wall-time histogram around a run-loop call
      (``swarm_kernel_tick_seconds{call=...}``); end the call with a
      synchronize inside the block, or it times the enqueue.
    - ``publish(state)``: fold the on-device cumulative counters (stats,
      the read tallies, the durable-commit sum) into the kernel counter
      families by their delta since the registry's previous scrape
      (metrics/scrape.py), so publishing the same state twice adds
      nothing, and set the fsync-lag gauge.  It reads the counters back
      from the device: call it between runs, never inside one.

    The device counters are int32 bit patterns that wrap mod 2**32, as in
    the JAX package (at the headline, the commit advance summed over 4096
    rows wraps about every 512 ticks).  publish reads them unsigned and
    hands the delta seam the state's tick with each reading: a reading
    below the last one at a later tick is a wrap, and adds the advance mod
    2**32; one at an earlier tick is a new run.  So publish a run at least
    once per wrap, and each run into a registry of its own.
    """

    _STAT_NAMES = ("swarm_kernel_elections_started_total",
                   "swarm_kernel_elections_won_total",
                   "swarm_kernel_commit_advance_total",
                   "swarm_kernel_apply_advance_total")
    _READ_NAMES = ("swarm_kernel_reads_served_total",
                   "swarm_kernel_reads_blocked_total")
    _DUR_NAME = "swarm_kernel_durable_commit_advance_total"
    _LAG_NAME = "swarm_kernel_fsync_lag"

    def __init__(self, obs=None, clock_sync=None) -> None:
        self.obs = obs or obs_registry.DEFAULT
        # an optional flightrec/clock.py ClockSync: each publish already
        # reads the device back, so it doubles as a tick <-> wall sample
        self.clock_sync = clock_sync
        self._m_tick = obs_catalog.get(self.obs, "swarm_kernel_tick_seconds")
        self._m_stats = [obs_catalog.get(self.obs, n)
                         for n in self._STAT_NAMES]
        self._m_reads = [obs_catalog.get(self.obs, n)
                         for n in self._READ_NAMES]
        self._m_dur = obs_catalog.get(self.obs, self._DUR_NAME)
        self._m_lag = obs_catalog.get(self.obs, self._LAG_NAME)
        self._deltas = obs_scrape.deltas_for(self.obs)

    def timed(self, call: str):
        return self._m_tick.labels(call=call).time()

    def _advance(self, names, fams, cur, tick: int) -> None:
        for name, fam, c in zip(names, fams, cur):
            d = self._deltas.advance((name,), c, tick)
            if d:
                fam.inc(d)

    def publish(self, state: SimState) -> dict:
        """Returns the cumulative counters as a dict (empty when the state
        carries none), each the device's value mod 2**32.  A grouped
        state's [G, 4] stats fold over groups."""
        if self.clock_sync is not None:
            tick = sync_point(self.clock_sync, state)
        else:
            tick = int(state.tick.amax())
        out: dict[str, int] = {}
        if state.stats is not None:
            arr = state.stats.cpu().numpy()
            cur = [int(v) & U32_MASK for v in (arr.sum(axis=0)
                                               if arr.ndim > 1 else arr)]
            self._advance(self._STAT_NAMES, self._m_stats, cur, tick)
            out.update(zip(("elections_started", "elections_won",
                            "commit_advance", "apply_advance"), cur))
        if state.read_srv is not None:
            cur_r = [int(reads_served(state)) & U32_MASK,
                     int(reads_blocked(state)) & U32_MASK]
            self._advance(self._READ_NAMES, self._m_reads, cur_r, tick)
            out.update(zip(("reads_served", "reads_blocked"), cur_r))
        if state.sync_mark is not None:
            # the durable-commit sum is cumulative like the stats (each
            # row's dur_commit is monotone); the fsync lag is a width now
            cur_d = int(state.dur_commit.sum(dtype=I32)) & U32_MASK
            self._advance((self._DUR_NAME,), (self._m_dur,), (cur_d,), tick)
            lag = int((state.last - state.sync_mark).amax())
            self._m_lag.set(lag)
            out.update(durable_commit=cur_d, fsync_lag=lag)
        return out


def sync_point(clock, state: SimState) -> int:
    """Record one (tick, host_ns) sample on `clock` (flightrec/clock.py
    ClockSync) and return the observed tick.  Reading state.tick back
    waits for the device to reach it, so the host clock read after it
    bounds the tick from above; a grouped state's [G] ticks advance in
    lockstep and the max is taken."""
    tick = int(state.tick.amax())
    clock.add(tick)
    return tick


def reads_served(state: SimState) -> torch.Tensor:
    """Total read ops served across rows (0 when the read path is off)."""
    if state.read_srv is None:
        return torch.zeros((), dtype=I32, device=state.term.device)
    return state.read_srv.sum(dtype=I32)


def reads_blocked(state: SimState) -> torch.Tensor:
    """Total read ops refused (deposal or lease expiry) across rows."""
    if state.read_block is None:
        return torch.zeros((), dtype=I32, device=state.term.device)
    return state.read_block.sum(dtype=I32)


def committed_entries(state: SimState) -> torch.Tensor:
    """Total entries committed through consensus (max commit across rows;
    a value reduction, [B] per cluster on a batched state)."""
    if _batched(state):
        return state.commit.amax(-1)
    return state.commit.amax()


def quorum_applied_checksum(state: SimState):
    """(applied, checksum) pairs — equal applied must imply equal checksum
    (state-machine safety).  Row-wise, so [B, N] each on a batched state:
    compare within a cluster."""
    return state.applied, state.apply_chk
