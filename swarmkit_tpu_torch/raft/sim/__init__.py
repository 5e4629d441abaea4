"""Batched raft simulation on torch tensors: N managers as rows."""

from swarmkit_tpu_torch.raft.sim.kernel import (
    propose_dense, step, transfer_leadership,
)
from swarmkit_tpu_torch.raft.sim.run import (
    committed_entries, has_leader, leader_mask, quorum_applied_checksum,
    run_ticks, run_until_leader,
)
from swarmkit_tpu_torch.raft.sim.state import (
    CANDIDATE, FOLLOWER, LEADER, NONE, SimConfig, SimState, drop_matrix,
    init_state, rand_timeout, state_from_numpy, state_to_numpy,
)

__all__ = [
    "propose_dense", "step", "transfer_leadership",
    "committed_entries", "has_leader", "leader_mask",
    "quorum_applied_checksum", "run_ticks", "run_until_leader",
    "CANDIDATE", "FOLLOWER", "LEADER", "NONE", "SimConfig", "SimState",
    "drop_matrix", "init_state", "rand_timeout", "state_from_numpy",
    "state_to_numpy",
]
