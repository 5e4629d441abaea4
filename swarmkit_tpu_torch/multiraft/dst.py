"""DST adversary drive for the multi-raft group axis (PyTorch port of the
JAX package's multiraft/dst.py).

`dst.explore` copies ONE init state over the schedule axis; the serving
plane instead owns a LIVE [G, N, ...] grouped state and wants to drive it
under a per-group `FaultSchedule` batch: group g gets schedule slice g,
exactly the mapping `FaultSchedule.slice` defines.  This module reuses
explore's tick (`_tick_one` on a batched state: adversary verbs ->
effective_faults -> step -> invariant checkers), so every attack profile
and every invariant bit works unchanged per group, and the host gets the
same [G] violation bitmasks the DST pipeline already consumes.

Fault isolation: each group reads only its own schedule slice and its own
state, so faults injected into group g cannot perturb any other group.
"""

from __future__ import annotations

from swarmkit_tpu_torch.dst.explore import _first_tick, _run_batch
from swarmkit_tpu_torch.dst.schedule import FaultSchedule
from swarmkit_tpu_torch.raft.sim.state import (
    SimConfig, SimState, check_device,
)


def run_groups_under_schedule(gstate: SimState, cfg: SimConfig,
                              schedule: FaultSchedule,
                              prop_count: int = 0, device=None):
    """Advance the grouped state `schedule.ticks` ticks, group g under
    schedule slice g, checking invariants per group every tick.

    `schedule` is a [G, T, ...] batch (dst/schedule.py make_batch, or a
    hand-built FaultSchedule whose leading axis matches the group count)
    on the state's device.  Returns (final, viol [G] int32 bitmasks (the
    uint32 bits), first [G] first-violating tick or -1), all on the
    device: the per-tick bits stay there and `first` is computed there, so
    the loop reads nothing back.  Consumes the state (see `kernel.step`).
    """
    dev = check_device(gstate, device)
    final, viol, bits_by_tick = _run_batch(gstate, cfg, schedule,
                                           prop_count, None, dev)
    return final, viol, _first_tick(bits_by_tick)
