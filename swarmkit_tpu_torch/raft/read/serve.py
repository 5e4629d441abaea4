"""Read-batch lifecycle (PyTorch port): submit -> stamp -> serve or refuse.

The per-row read registers are [N] int32 tensors; they never touch the
[N, L] log rings.  One batch on row i:

1. ``submit`` (kernel phase R0): an idle live row takes a fresh batch of
   ``cfg.read_batch`` client reads; its goal is ``max(commit)`` over the
   rows at submit, the frontier of writes already acknowledged (oracle
   bookkeeping: no serving decision reads it).
2. ``stamp`` (R1, after the commit fold): a leader that confirmed its
   leadership (valid lease, or a quorum of acks this tick) and committed
   an entry of its own term stamps the batch with its commit index; a
   follower forwards to its known leader and takes that row's commit under
   the leader's gates when both directions of the edge are clean.
3. ``settle`` (R2, after the apply phase): a stamped batch is served once
   ``applied >= read_index``; an unstamped one is refused when its row was
   deposed or its lease expired unrenewed.

Every served batch has ``srv_idx >= srv_goal`` (the LINEARIZABLE_READ
reduction).

Under the tick's batch axis (``bx`` on, raft/sim/batch.py: B clusters,
every register [B, N], the tick [B, 1]) each phase stays inside its
cluster: the submit goal is each cluster's own ``max(commit)`` and the
follower forward reads its own cluster's leader row.  On a row shard
(``bx.rx``) the registers are the shard's [N/D] rows: the goal is the
maximum over every shard, and the forward reads the leader's row from
the shard that holds it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swarmkit_tpu_torch.raft.read import lease
from swarmkit_tpu_torch.raft.sim.batch import NOBATCH, Bx
from swarmkit_tpu_torch.raft.sim.state import LEADER, NONE, SimConfig

I32 = torch.int32


class ReadRegs(NamedTuple):
    """The read registers of SimState (all [N] int32)."""
    pend: torch.Tensor         # reads queued on this row (0 = idle)
    goal: torch.Tensor         # max(commit) anywhere at submit
    idx: torch.Tensor          # ReadIndex stamp (NONE = not yet stamped)
    lease_until: torch.Tensor  # absolute expiry tick of the row's lease
    srv: torch.Tensor          # cumulative reads served
    block: torch.Tensor        # cumulative reads refused
    srv_idx: torch.Tensor      # applied index of the last served batch
    srv_goal: torch.Tensor     # submit goal of the last served batch


def regs_from_state(state) -> ReadRegs:
    return ReadRegs(pend=state.read_pend, goal=state.read_goal,
                    idx=state.read_idx, lease_until=state.lease_until,
                    srv=state.read_srv, block=state.read_block,
                    srv_idx=state.read_srv_idx,
                    srv_goal=state.read_srv_goal)


def read_fields(regs: ReadRegs) -> dict:
    """SimState fields for dataclasses.replace at the end of the tick."""
    return dict(read_pend=regs.pend, read_goal=regs.goal,
                read_idx=regs.idx, lease_until=regs.lease_until,
                read_srv=regs.srv, read_block=regs.block,
                read_srv_idx=regs.srv_idx, read_srv_goal=regs.srv_goal)


def submit(cfg: SimConfig, regs: ReadRegs, alive: torch.Tensor,
           commit: torch.Tensor, bx: Bx = NOBATCH) -> ReadRegs:
    """R0: refill idle live rows with a fresh batch, capturing the
    acked-write frontier as its goal."""
    refill = alive & (regs.pend == 0)
    # the goal is a value reduction: the cluster's own acked-write frontier
    frontier = commit.amax(-1, keepdim=True) if bx.on else commit.amax()
    if bx.rx is not None:
        frontier = bx.rx.allreduce(frontier, "max")
    return regs._replace(
        pend=torch.where(refill, cfg.read_batch, regs.pend),
        goal=torch.where(refill, frontier, regs.goal),
        idx=torch.where(refill, NONE, regs.idx))


def stamp(cfg: SimConfig, regs: ReadRegs, *, alive: torch.Tensor,
          role: torch.Tensor, lead: torch.Tensor, term: torch.Tensor,
          commit: torch.Tensor, commit_term_ok: torch.Tensor,
          q_ok: torch.Tensor, transferee: torch.Tensor, now: torch.Tensor,
          drop: torch.Tensor,
          bx: Bx = NOBATCH, drop_t=None) -> tuple[ReadRegs, torch.Tensor]:
    """R1: renew leases, then stamp pending batches.  Returns (regs,
    confirm), confirm[i] = row i vouched for its leadership this tick.
    A row shard passes `drop_t`, its rows of the transposed drop matrix."""
    n = regs.pend.shape[-1] if bx.rx is None else bx.rx.n
    is_leader = (role == LEADER) & alive
    lease_until = lease.renew(cfg, regs.lease_until, role, q_ok, transferee,
                              now)
    lease_ok = lease.valid(cfg, lease_until, is_leader, transferee, now)
    confirm = is_leader & commit_term_ok & (lease_ok | q_ok)
    unstamped = (regs.pend > 0) & (regs.idx == NONE)
    idx = torch.where(unstamped & confirm, commit, regs.idx)

    # follower read: forward to the known leader (clipped, so a NONE lead
    # reads row 0 and is gated off by has_lead), stamp with that row's
    # commit under its gates, when both directions of the edge are clean
    li = torch.clamp(lead, 0, n - 1).to(torch.int64)
    if bx.rx is None:
        node = torch.arange(n, device=lead.device)
        rt_clean = ~bx.at(drop, node, li) & ~bx.at(drop, li, node)
    else:
        node = bx.rx.node()
        rt_clean = ~drop.gather(1, li[:, None])[:, 0] \
            & ~drop_t.gather(1, li[:, None])[:, 0]
    has_lead = (lead != NONE) & (lead != node)
    # the leader row's registers, read inside each cluster
    stamp_f = unstamped & alive & ~is_leader & has_lead \
        & (term == bx.gtake(term, li)) & bx.gtake(confirm, li) & rt_clean
    idx = torch.where(stamp_f, bx.gtake(commit, li), idx)
    return regs._replace(idx=idx, lease_until=lease_until), confirm


def settle(cfg: SimConfig, regs: ReadRegs, *, alive: torch.Tensor,
           applied: torch.Tensor, role: torch.Tensor,
           was_leader: torch.Tensor, now: torch.Tensor,
           prev_lease_until: torch.Tensor):
    """R2: serve stamped batches whose applied index caught the stamp;
    refuse unstamped batches whose serving basis is gone.  Returns (regs,
    served, srv_cnt, blocked, blk_cnt, expired)."""
    is_leader = (role == LEADER) & alive
    served = alive & (regs.pend > 0) & (regs.idx != NONE) \
        & (applied >= regs.idx)
    srv_cnt = torch.where(served, regs.pend, 0)
    regs = regs._replace(
        srv=regs.srv + srv_cnt,
        srv_idx=torch.where(served, applied, regs.srv_idx),
        srv_goal=torch.where(served, regs.goal, regs.srv_goal),
        pend=torch.where(served, 0, regs.pend),
        idx=torch.where(served, NONE, regs.idx))

    # a stamped batch is already linearizable and only waits for apply;
    # only unstamped batches are refused
    unstamped = (regs.pend > 0) & (regs.idx == NONE)
    deposed = was_leader & (role != LEADER)
    if cfg.read_leases:
        # the expiry edge: valid through tick now - 1, invalid now, and
        # not renewed this tick
        expired = is_leader & (prev_lease_until == now) \
            & (now >= regs.lease_until)
    else:
        expired = torch.zeros_like(deposed)
    blocked = unstamped & (deposed | expired)
    blk_cnt = torch.where(blocked, regs.pend, 0)
    regs = regs._replace(block=regs.block + blk_cnt,
                         pend=torch.where(blocked, 0, regs.pend))
    return regs, served, srv_cnt, blocked, blk_cnt, expired
