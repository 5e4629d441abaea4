"""Tick-clock leader leases (PyTorch port).

The lease register is one [N] int32 tensor: ``lease_until[i]`` is the
absolute tick at which row i's lease expires (0 = no lease).  A quorum of
member acks reaching a leader in one tick grants or extends it; a pending
read batch consults it for a ReadIndex stamp.

Why ``lease_ticks = election_tick - lease_margin - (latency + jitter)`` is
safe, in tick units: an ack delivered at tick d was generated by a follower
that heard the leader at some s >= d - (latency + jitter), which reset its
leader-contact timer, so it refuses votes until d + election_tick -
(latency + jitter).  Any rival quorum intersects the acking one, so no
rival is elected before then; the lease expires lease_margin ticks
earlier.  A leadership transfer voids the lease (TIMEOUT_NOW campaigns
bypass the voters' contact lease), and a row that is not leader holds none.

Both functions are elementwise, so they run as they are under the tick's
batch axis: [B, N] registers with the tick shaped [B, 1].
"""

from __future__ import annotations

import torch

from swarmkit_tpu_torch.raft.sim.state import LEADER, NONE, SimConfig


def lease_span(cfg: SimConfig) -> int:
    """Lease duration in ticks (a config constant)."""
    return cfg.election_tick - cfg.lease_margin \
        - (cfg.latency + cfg.latency_jitter)


def renew(cfg: SimConfig, lease_until: torch.Tensor, role: torch.Tensor,
          q_ok: torch.Tensor, transferee: torch.Tensor,
          now: torch.Tensor) -> torch.Tensor:
    """New lease register: extended on quorum-ack ticks, not during a
    leadership transfer, cleared on every non-leader row."""
    grant = q_ok & (transferee == NONE)
    lease_until = torch.where(grant, now + lease_span(cfg), lease_until)
    return torch.where(role == LEADER, lease_until, 0)


def valid(cfg: SimConfig, lease_until: torch.Tensor, is_leader: torch.Tensor,
          transferee: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """bool [N]: rows whose lease authorizes stamping reads this tick; all
    False when leases are off (``read_leases=False``: every batch waits for
    a quorum-ack tick, classic ReadIndex)."""
    if not cfg.read_leases:
        return torch.zeros_like(is_leader)
    return is_leader & (transferee == NONE) & (now < lease_until)
