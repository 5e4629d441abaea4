"""Batched raft simulation on torch tensors: N managers as rows."""

from swarmkit_tpu_torch.raft.sim.kernel import (
    propose, propose_conf, propose_dense, step, transfer_leadership,
)
from swarmkit_tpu_torch.raft.sim.run import (
    KernelObs, committed_entries, has_leader, leader_mask,
    quorum_applied_checksum, reads_blocked, reads_served, run_schedule,
    run_ticks, run_until_leader, submit_reads, sync_point,
)
from swarmkit_tpu_torch.raft.sim.state import (
    CANDIDATE, FOLLOWER, LEADER, NONE, SimConfig, SimState, conf_payload,
    drop_matrix, init_state, rand_timeout, state_from_numpy, state_to_numpy,
)

__all__ = [
    "propose", "propose_conf", "propose_dense", "step",
    "transfer_leadership",
    "KernelObs", "committed_entries", "has_leader", "leader_mask",
    "quorum_applied_checksum", "reads_blocked", "reads_served",
    "run_schedule", "run_ticks", "run_until_leader", "submit_reads",
    "sync_point",
    "CANDIDATE", "FOLLOWER", "LEADER", "NONE", "SimConfig", "SimState",
    "conf_payload", "drop_matrix", "init_state", "rand_timeout",
    "state_from_numpy", "state_to_numpy",
]
