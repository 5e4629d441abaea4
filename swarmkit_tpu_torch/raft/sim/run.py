"""Simulation loops for the bench flow (PyTorch port).

The JAX package compiles these as `lax.scan` / `lax.while_loop` programs;
here they are host loops over `kernel.step`, one tick per iteration.
`run_until_leader` reads `has_leader` back every tick; `run_ticks` only
syncs where `step` does (the tiled ring write's branch choice).
"""

from __future__ import annotations

import torch

from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.raft.sim.kernel import _first_true, step
from swarmkit_tpu_torch.raft.sim.state import (
    LEADER, SimConfig, SimState, check_device, drop_matrix,
)

I32 = torch.int32


def leader_mask(state: SimState) -> torch.Tensor:
    return (state.role == LEADER) & torch.diagonal(state.member)


def has_leader(state: SimState) -> torch.Tensor:
    return leader_mask(state).any()


def _payload_at(tick, k: torch.Tensor) -> torch.Tensor:
    """Deterministic payload id for proposal k of `tick`, as uint32 bits:
    tick * 2**16 + k + 1 (mod 2**32), so the applied checksum detects loss
    or reorder.  k is an integer tensor of any shape."""
    t = u32.unsigned(torch.as_tensor(tick, dtype=I32, device=k.device))
    return u32.to_bits(t * (1 << 16) + u32.unsigned(k) + 1)


def _trace_row(st: SimState) -> torch.Tensor:
    return torch.stack([leader_mask(st).sum(dtype=I32), st.commit.amax(),
                        st.term.amax()])


def run_ticks(state: SimState, cfg: SimConfig, n_ticks: int,
              prop_count: int = 0, drop_rate: float = 0.0,
              crash_every: int = 0, down_for: int = 5, device=None):
    """Advance n_ticks.  Per tick: optionally propose `prop_count` entries
    to the current leader(s) (the fused propose), optionally drop traffic
    per edge at `drop_rate`, and optionally crash the sitting leader every
    `crash_every` ticks for `down_for` ticks.

    Returns (final_state, trace) where trace is [n_ticks, 3] int32 rows
    [n_leaders, max_commit, max_term].  Consumes the state's rings.
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
        if prop_count:
            st = step(st, cfg, alive=alive, drop=drop, prop_count=prop_count,
                      payload_fn=_payload_at, device=dev)
        else:
            st = step(st, cfg, alive=alive, drop=drop, device=dev)
        trace.append(_trace_row(st))
    if not trace:
        return st, torch.zeros((0, 3), dtype=I32, device=dev)
    return st, torch.stack(trace)


def run_until_leader(state: SimState, cfg: SimConfig, max_ticks: int = 1000,
                     device=None):
    """Tick until some node is leader (or max_ticks pass).  Returns
    (state, ticks_taken).  Consumes the state's rings."""
    dev = check_device(state, device)
    st, t = state, 0
    while t < max_ticks and not bool(has_leader(st)):
        st = step(st, cfg, device=dev)
        t += 1
    return st, t


def committed_entries(state: SimState) -> torch.Tensor:
    """Total entries committed through consensus (max commit across rows)."""
    return state.commit.amax()


def quorum_applied_checksum(state: SimState):
    """(applied, checksum) pairs — equal applied must imply equal checksum
    (state-machine safety)."""
    return state.applied, state.apply_chk
