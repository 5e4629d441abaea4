"""The scheduler's group placement as one device launch.

The host path (scheduler.py ``_schedule_group``) re-runs the filter
Pipeline and rebuilds the spread DecisionTree once PER TASK — O(T · N)
Python with an O(N log N) sort inside.  This module expresses the same
group fan-out as encoded feasibility columns and one greedy pass on the
card: the hand-written kernel behind ``parallel.cuda_ops.place_greedy``
(csrc/sched_place.cu), the port of the JAX package's jitted
``lax.fori_loop`` (its manager/scheduler/kernel.py ``_build_place``).

**Bit-identity contract.**  Every task in a group shares one spec
(``_common_spec_key``), so per-(group, node) the filters split into

- *static* checks — Ready, Plugin, Constraint, Platform, plus the
  initial HostPort occupancy and the zero-reservation sign checks of
  Resource — evaluated ONCE on the host using the real filter classes
  (no re-implementation to drift), and
- *dynamic* checks — Resource cpu/mem/discrete-generic depletion,
  MaxReplicas, and same-group HostPort self-conflicts — which under an
  identical-spec group reduce to an integer per-node CAPACITY
  ``cap[n]`` = how many tasks of this spec the node can take.  The only
  device-side state is ``a[n]``, tasks assigned so far; feasibility at
  every step is ``static[n] & (a[n] < cap[n])``, exactly complementing
  the filters' ``>`` comparisons (host capacities are computed with
  exact Python integers and clamped before they become int32, so no
  64-bit device arithmetic is needed).

Selection replicates ``find_best_nodes(1, ...)``: a stable-sorted
lexicographic minimum over (taint, count_for_service,
active_task_count, insertion index), nested inside a (branch load,
branch first-seen index) minimum when one spread preference level is
present — the DecisionTree's stable branch ranking and its dict
insertion order tie-break, re-derived per task from the CURRENT
feasible set just as the host rebuilds the tree per task.

``encode_group`` returns None — host Pipeline fallback — for the cases
the encoding does not cover: named generic resources (claim side
effects) and >1 spread preference levels.  The host Pipeline stays the
oracle; tests/test_torch_scheduler.py pins the decisions equal to the
host path's and to the JAX package's.  Unlike the JAX program, nothing
here is padded to powers of two (nothing recompiles), but the caps are
clamped as the padded program clamps them, so the choices are its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.manager.scheduler.filters import (
    ConstraintFilter, HostPortFilter, Pipeline, PlatformFilter, PluginFilter,
    ReadyFilter,
)
from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo, task_reserved
from swarmkit_tpu_torch.manager.scheduler.nodeset import spread_keys
from swarmkit_tpu_torch.parallel import cuda_ops

# Locked two-way to the catalog by tests/test_torch_scheduler.py.
METRIC_NAMES: dict[str, tuple[str, ...]] = {
    "swarm_sched_kernel_groups_total": ("path",),
    "swarm_sched_kernel_tasks_total": (),
    "swarm_sched_kernel_seconds": (),
}

_STATIC_FILTERS = (ReadyFilter, PluginFilter, ConstraintFilter,
                   PlatformFilter)


def _pow2(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


@dataclass
class GroupEncoding:
    """Host-encoded columns for one task group (all lists length N, the
    scheduler's node insertion order)."""

    node_list: list          # NodeInfo, insertion order
    static_ok: list          # bool
    cap: list                # int, 0..T+1
    count0: list             # count_for_service at group start
    active0: list            # active_task_count at group start
    taint: list              # bool
    branch: list             # spread branch id (all 0 when no spread)
    n_branches: int          # 0 = no spread level
    has_service: bool
    gen: dict                # discrete generic reservation (for decode)


def encode_group(sample, prefs: list[str], node_list: list[NodeInfo],
                 fkey: tuple, now: float) -> Optional[GroupEncoding]:
    """Encode one group's scheduling state; None → host fallback."""
    t_cap = 1 << 30  # "unbounded" sentinel before clamping

    cpus, mem, gen = task_reserved(sample)
    res_active = bool(cpus or mem or gen)
    if gen and any(k in info.available_named
                   for info in node_list for k in gen):
        return None   # named generic resources: claim side effects
    spreads = [p for p in prefs
               if (p.split("=", 1)[0].strip().lower() if "=" in p
                   else "spread") == "spread"]
    if len(spreads) > 1:
        return None   # multi-level spread tree

    statics = Pipeline(filters=_STATIC_FILTERS)
    statics.set_task(sample)
    hostport = HostPortFilter()
    hostport_active = hostport.set_task(sample)

    p = sample.spec.placement
    max_replicas = p.max_replicas if p is not None else 0
    service_id = sample.service_id

    static_ok, cap, count0, active0, taintv = [], [], [], [], []
    branch, branch_ids = [], {}
    for info in node_list:
        ok = statics.process(info)
        c = t_cap
        if res_active:
            # exact complements of ResourceFilter.check under repeated
            # identical reservations, computed with Python bigints:
            # after a assignments, available = initial - a*need, and
            # "need > available" fails ⇔ a >= floor(initial/need)
            for need, avail in ((cpus, info.available_cpus),
                                (mem, info.available_memory)):
                if need > 0:
                    c = min(c, avail // need if avail >= 0 else 0)
                elif avail < 0:
                    ok = False     # "0 > avail" fails the host check
            for k, v in gen.items():
                avail = info.available_generic.get(k, 0)
                if v > 0:
                    c = min(c, avail // v if avail >= 0 else 0)
                elif avail < 0:
                    ok = False
        if max_replicas > 0 and service_id:
            # serviceless tasks never bump count_for_service, so the host
            # check stays 0 < max forever — no capacity bound
            c = min(c, max_replicas - info.count_for_service(service_id))
        if hostport_active:
            if not hostport.check(info):
                ok = False
            # same-group tasks publish the same host ports: one per node
            c = min(c, 1)
        static_ok.append(bool(ok))
        cap.append(max(0, min(c, t_cap)))
        count0.append(info.count_for_service(service_id))
        active0.append(info.active_task_count())
        # idempotent: the host comparator calls taint() repeatedly with
        # the same `now`; one call returns the same value and leaves
        # recent_failures in the same pruned state
        taintv.append(bool(info.taint(fkey, now)))
        if spreads:
            key = spread_keys(spreads, info)[0]
            branch.append(branch_ids.setdefault(key, len(branch_ids)))
        else:
            branch.append(0)
    return GroupEncoding(node_list=node_list, static_ok=static_ok, cap=cap,
                         count0=count0, active0=active0, taint=taintv,
                         branch=branch, n_branches=len(branch_ids),
                         has_service=bool(service_id), gen=gen)


def group_columns(enc: GroupEncoding, n_tasks: int,
                  device=None) -> torch.Tensor:
    """The [6, N] int32 column block (cuda_ops.PLACE_COLUMNS) of an
    encoding, on `device`.  The caps are clamped as the JAX program clamps
    them for its padded task count, min(2^20, t_pad) + 1, while they are
    still Python integers: a node with 2^40 bytes of memory and a 1-byte
    reservation has a capacity that int32 cannot hold."""
    t_clamp = min(1 << 20, _pow2(n_tasks)) + 1
    cols = np.array([enc.static_ok,
                     [min(v, t_clamp) for v in enc.cap],
                     enc.count0, enc.active0, enc.taint, enc.branch],
                    dtype=np.int64).reshape(len(cuda_ops.PLACE_COLUMNS),
                                            len(enc.node_list))
    return torch.from_numpy(cols.astype(np.int32)).to(resolve_device(device))


def place_group(enc: GroupEncoding, n_tasks: int,
                device=None) -> list[int]:
    """Place the group on `device` (the card unless the caller asks for
    the CPU); returns per-task node indices (-1 = no fit), FIFO over the
    group."""
    cols = group_columns(enc, n_tasks, device)
    return cuda_ops.place_greedy(cols, enc.n_branches, enc.has_service,
                                 n_tasks).tolist()
