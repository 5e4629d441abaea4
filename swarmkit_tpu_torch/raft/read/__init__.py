"""Linearizable read path (PyTorch port): batched ReadIndex, tick-clock
leader leases, and follower reads served at the applied index.

A pending read batch is stamped with a leader's commit index once that
leader has confirmed it still leads: by a quorum of member acks this tick
(the append/heartbeat ack collective the tick already runs, so a ReadIndex
round costs no extra messages) or by a valid lease.  Followers forward
their batch to their known leader and serve once ``applied`` reaches the
stamp.  The kernel's phases R0-R2 call this package; it never imports the
kernel, and everything is gated on ``cfg.read_batch > 0`` in Python.
"""

from swarmkit_tpu_torch.raft.read.lease import lease_span, renew, valid
from swarmkit_tpu_torch.raft.read.serve import (
    ReadRegs, read_fields, regs_from_state, settle, stamp, submit,
)

__all__ = [
    "ReadRegs", "lease_span", "read_fields", "regs_from_state", "renew",
    "settle", "stamp", "submit", "valid",
]
