"""Multi-raft serving plane (PyTorch port): G independent raft groups as
one program.

The batch axis of the tick as a first-class serving mode: a [G, N, ...]
grouped `SimState` advanced by the batch-native `kernel.step`, a
host-side key->group `Router`, and `swarm_multiraft_*` observability.
See group.py for the G=1 bit-identity contract and group placement over
a device mesh (a fleet split by `parallel.shard_rows(gstate,
parallel.group_mesh(G), axis=parallel.GROUP_AXIS, leading=G)`), and
dst.py for adversary drivability.
"""

from swarmkit_tpu_torch.multiraft.dst import run_groups_under_schedule
from swarmkit_tpu_torch.multiraft.group import (
    aggregate_committed, aggregate_reads_blocked, aggregate_reads_served,
    group_commits, group_leader_mask, group_leaders, groups_of,
    groups_with_leader, init_groups, propose_groups, run_group_ticks,
    slice_group, step_groups, submit_reads_groups,
)
from swarmkit_tpu_torch.multiraft.heat import SPILL_WEIGHT, HeatTracker
from swarmkit_tpu_torch.multiraft.obs import METRIC_NAMES, MultiRaftObs
from swarmkit_tpu_torch.multiraft.router import Router, group_of_key

__all__ = [
    "METRIC_NAMES", "MultiRaftObs", "Router",
    "HeatTracker", "SPILL_WEIGHT",
    "aggregate_committed", "aggregate_reads_blocked",
    "aggregate_reads_served", "group_commits", "group_leader_mask",
    "group_leaders", "group_of_key", "groups_of", "groups_with_leader", "init_groups",
    "propose_groups", "run_group_ticks", "run_groups_under_schedule",
    "slice_group", "step_groups", "submit_reads_groups",
]
