"""Raft consensus (PyTorch port).

- messages/log/core/rawnode: the host-side golden state machine
  (reference: vendor/github.com/coreos/etcd/raft), used by the node shell
  and as the differential-test oracle.
- sim/: the batched tick where N simulated managers are rows of torch
  tensors.
"""

from swarmkit_tpu_torch.raft.core import Config, ProposalDropped, Raft
from swarmkit_tpu_torch.raft.log import RaftLog
from swarmkit_tpu_torch.raft.messages import (
    ConfChange, ConfChangeType, Entry, EntryType, HardState, Message, MsgType,
    Snapshot, SnapshotMeta, SoftState,
)
from swarmkit_tpu_torch.raft.rawnode import RawNode, Ready

# NOTE: the full consensus member lives in swarmkit_tpu_torch.raft.node
# (Node, NodeOpts), the transport seam in .transport (Network, Transport),
# persistence in .storage (EncryptedRaftLogger) — imported lazily by
# callers to keep this package import light for the sim tick.

__all__ = [
    "Config", "ProposalDropped", "Raft", "RaftLog", "ConfChange",
    "ConfChangeType", "Entry", "EntryType", "HardState", "Message", "MsgType",
    "Snapshot", "SnapshotMeta", "SoftState", "RawNode", "Ready",
]
