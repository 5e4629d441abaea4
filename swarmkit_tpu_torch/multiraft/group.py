"""[G, N, ...] multi-group serving plane over the single-group tick
(PyTorch port of the JAX package's multiraft/group.py).

Production stores shard the keyspace over many small raft groups rather
than one giant quorum (CockroachDB/TiKV ranges).  The grouped state holds
G independent groups on a leading [G] axis of every SimState field, the
batch axis the tick already runs natively (raft/sim/batch.py): where the
JAX package vmaps `kernel.step`, the port hands the grouped state to
`kernel.step` itself, which advances every group in one pass of launches
and keeps every value reduction inside its group.  The batched tick runs
every lever and plane of the single-group one.

Bit-identity contract: `step_groups` is Python-gated on the group count.
At G == 1 it runs the plain single-group `step` on the squeezed state
(views of the grouped fields), so the program, not only its values, is
the single-group tick's.

Grouped telemetry rides the same gates: with ``cfg.collect_telemetry``
on, `init_state` carries the telemetry fields, `init_groups` copies them
to [G, ...] like every other field, and the batched tick folds each
group's histograms and series rings on its own.  `slice_group` extracts
one group's plain SimState for the single-group summarize/publish path.

Every entry point runs on the state's device: the CUDA card unless the
caller names another.  `run_group_ticks` is a host loop, as run.py's
drivers are: it reads nothing back.

Group placement: ``parallel.shard_rows(gstate, parallel.group_mesh(G),
axis=GROUP_AXIS, leading=G)`` splits a built fleet over the mesh's
devices (a `parallel.Sharded` fleet when the mesh has several entries;
group identity is kept, since only `init_groups` derives anything from
the group index).  `step_groups`, `run_group_ticks` and the aggregates
take such a fleet: they step every shard (each tick issued on every shard
before the next) and add the shards' aggregates up as int32 sums, as the
JAX package's jnp.sum over a sharded [G] axis does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swarmkit_tpu_torch.parallel import Sharded
from swarmkit_tpu_torch.raft.sim.kernel import _first_true, propose, step
from swarmkit_tpu_torch.raft.sim.run import (
    _payload_at, leader_mask, submit_reads,
)
from swarmkit_tpu_torch.raft.sim.state import (
    FIELD_NAMES, SimConfig, SimState, broadcast_state, check_device,
    init_state, rand_timeout,
)

I32 = torch.int32


def groups_of(gstate: SimState) -> int:
    """Group count G of a grouped state (leading-axis length), summed over
    the shards of a sharded fleet."""
    return sum(int(s.tick.shape[0]) for s in _shards(gstate))


def _shards(gstate) -> list:
    """The per-device fleets of a sharded fleet, or [gstate]."""
    return gstate.shards if isinstance(gstate, Sharded) else [gstate]


def _check_shards(gstate: Sharded, device) -> None:
    dev = torch.device(device) if device is not None else None
    for s in gstate.shards:
        if dev is not None and s.term.device.type != dev.type:
            raise ValueError(f"a shard lives on {s.term.device}, but the "
                             f"call runs on {dev}")


def _combine(gstate, fn, cat: bool) -> torch.Tensor:
    """fn of each shard, concatenated along the group axis (`cat`) or
    summed as int32, on the first shard's device; fn(gstate) unsharded."""
    if not isinstance(gstate, Sharded):
        return fn(gstate)
    parts = [fn(s) for s in gstate.shards]
    dev = parts[0].device
    parts = [p.to(dev) for p in parts]
    if cat:
        return torch.cat(parts)
    return torch.stack(parts).sum(0, dtype=I32)


def _split_groups(x, sizes: list) -> list:
    """A per-group input ([G, ...] array-like or tensor) cut into the
    shards' group blocks; a scalar or None is every shard's."""
    if x is None or not (isinstance(x, torch.Tensor) or np.ndim(x)):
        return [x] * len(sizes)
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        return [x] * len(sizes)
    bounds = np.cumsum([0] + sizes)
    return [x[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _map(state: SimState, fn) -> SimState:
    return SimState(**{name: fn(getattr(state, name))
                       for name in FIELD_NAMES
                       if getattr(state, name) is not None})


def slice_group(gstate: SimState, g: int) -> SimState:
    """One group's plain (ungrouped) SimState: every field indexed at g,
    as views of the grouped fields (a tick on it writes the group's rings
    in place).  The seam between the [G, ...] plane and the single-group
    host tooling (`telemetry.obs.summarize_state`, `KernelObs.publish`).
    On a sharded fleet, g indexes the whole fleet."""
    for s in _shards(gstate):
        if g < s.tick.shape[0]:
            return _map(s, lambda a: a[g])
        g -= int(s.tick.shape[0])
    raise IndexError("group index out of range")


def init_groups(cfg: SimConfig, groups: int, stagger: bool = True,
                device=None) -> SimState:
    """Stack `groups` fresh independent clusters on a new leading [G] axis,
    on `device` (the CUDA card unless the caller names another).

    Group 0 is bit-identical to ``init_state(cfg)``: the G=1 serving plane
    IS the single-group deployment.  With `stagger` (default), groups
    g > 0 re-randomize their initial election timeouts with g folded into
    ``rand_timeout``'s term argument (still inside [T, 2T), deterministic
    per (node, g, seed)), so a fresh fleet does not campaign in lock-step.
    """
    gstate = broadcast_state(init_state(cfg, device=device), groups)
    if stagger and groups > 1:
        dev = gstate.term.device
        node = torch.arange(cfg.n, dtype=I32, device=dev)
        gid = torch.arange(groups, dtype=I32, device=dev)
        gstate = dataclasses.replace(
            gstate, timeout=rand_timeout(cfg, node[None, :], gid[:, None]))
    return gstate


def _one_count(prop_count):
    """A [G] (or scalar) fused-propose count at G == 1, without a read."""
    if isinstance(prop_count, torch.Tensor):
        return prop_count.reshape(-1)[0]
    if np.ndim(prop_count):
        return int(np.asarray(prop_count).reshape(-1)[0])
    return int(prop_count)


def _group_count(prop_count, dev):
    """A fused-propose count for G > 1: an int stays an int (the same
    count for every group); an array-like becomes a device tensor."""
    if isinstance(prop_count, torch.Tensor):
        return prop_count
    if np.ndim(prop_count):
        return torch.as_tensor(np.asarray(prop_count), dtype=I32).to(dev)
    return int(prop_count)


def step_groups(gstate: SimState, cfg: SimConfig, alive=None, drop=None,
                prop_count=None, payload_fn=None, device=None) -> SimState:
    """Advance every group one tick.

    alive: [G, N] bool, drop: [G, N, N] bool: per-group fault inputs
    (None = fault-free everywhere).  prop_count is the fused-propose batch
    size: a scalar applies to all groups, a [G] array or device tensor
    gives each group its own count (the router's flush path); pair it with
    `payload_fn` exactly as in the single-group drivers.

    G == 1 runs the plain single-group `step` (module docstring: the
    bit-identity gate).  A sharded fleet steps shard by shard, its
    per-group inputs cut to each shard's groups.  Consumes the state (see
    `kernel.step`).
    """
    if isinstance(gstate, Sharded):
        _check_shards(gstate, device)
        sizes = [int(s.tick.shape[0]) for s in gstate.shards]
        per = zip(gstate.shards, _split_groups(alive, sizes),
                  _split_groups(drop, sizes),
                  _split_groups(prop_count, sizes))
        return Sharded(gstate.mesh, gstate.axis, gstate.specs, [
            step_groups(s, cfg, alive=a, drop=d, prop_count=pc,
                        payload_fn=payload_fn, device=s.term.device)
            for s, a, d, pc in per])
    dev = check_device(gstate, device)
    if groups_of(gstate) == 1:
        pc = None if prop_count is None else _one_count(prop_count)
        out = step(slice_group(gstate, 0), cfg,
                   alive=None if alive is None else alive[0],
                   drop=None if drop is None else drop[0],
                   prop_count=pc, payload_fn=payload_fn, device=dev)
        return _map(out, lambda a: a[None])
    pc = None if prop_count is None else _group_count(prop_count, dev)
    return step(gstate, cfg, alive=alive, drop=drop, prop_count=pc,
                payload_fn=payload_fn, device=dev)


def propose_groups(gstate: SimState, cfg: SimConfig, payloads, counts,
                   device=None) -> SimState:
    """Host `propose` per group: payloads [G, max_props] uint32, counts
    [G].  Appends each group's batch to whatever row currently claims that
    group's leadership (the single-group API's acceptance rules).  Writes
    the grouped rings in place."""
    return propose(gstate, cfg, payloads, counts, device=device)


def submit_reads_groups(gstate: SimState, cfg: SimConfig, counts,
                        device=None) -> SimState:
    """`submit_reads` per group: counts [G] linearizable read ops offered
    to every row of each group (cfg.read_batch > 0)."""
    return submit_reads(gstate, cfg, counts, device=device)


def run_group_ticks(gstate: SimState, cfg: SimConfig, n_ticks: int,
                    prop_count: int = 0, device=None):
    """Advance all groups `n_ticks`, a host loop of `step_groups`.

    Per tick: optionally fused-propose `prop_count` entries to each
    group's leader (deterministic `_payload_at` payloads, as in
    run_ticks).  Linearizable reads need no driver: with cfg.read_batch >
    0 every group's tick refills its own closed loop (Phase R0).

    Returns (final, trace): trace is a [n_ticks, 2] int32 device tensor of
    per-tick rows [groups_with_leader, aggregate_commit], stacked on the
    device, so the loop reads nothing back; read it once after the run.
    A sharded fleet runs each tick on every shard before the next, and its
    trace is the shards' rows summed (int32), on the first shard's device.
    Consumes the state (see `kernel.step`).
    """
    if isinstance(gstate, Sharded):
        _check_shards(gstate, device)
    else:
        check_device(gstate, device)
    shards, rows = list(_shards(gstate)), []
    for _ in range(n_ticks):
        for i, s in enumerate(shards):
            if prop_count:
                shards[i] = step_groups(s, cfg, prop_count=prop_count,
                                        payload_fn=_payload_at,
                                        device=s.term.device)
            else:
                shards[i] = step_groups(s, cfg, device=s.term.device)
        rows.append([torch.stack([groups_with_leader(s),
                                  aggregate_committed(s)])
                     for s in shards])
    dev = shards[0].term.device
    if not rows:
        trace = torch.zeros((0, 2), dtype=I32, device=dev)
    else:
        trace = torch.stack([
            torch.stack([r.to(dev) for r in per_shard]).sum(0, dtype=I32)
            if len(per_shard) > 1 else per_shard[0] for per_shard in rows])
    if isinstance(gstate, Sharded):
        return Sharded(gstate.mesh, gstate.axis, gstate.specs, shards), trace
    return shards[0], trace


# --- aggregate observables (the serving plane's headline quantities) -----
# Every sum is int32, as the JAX package's jnp.sum of int32 is (torch's sum
# of an integer tensor would widen to int64).

def group_leader_mask(gstate: SimState) -> torch.Tensor:
    """[G, N] bool: rows currently acting as their group's leader."""
    return _combine(gstate, leader_mask, cat=True)


def group_leaders(gstate: SimState) -> torch.Tensor:
    """[G] int32: leader row per group (the lowest if several), -1 while a
    group has none."""
    lm = group_leader_mask(gstate)
    return torch.where(lm.any(-1), _first_true(lm, 1), -1)


def groups_with_leader(gstate: SimState) -> torch.Tensor:
    """Scalar int32: number of groups that currently have an acting
    leader."""
    return _combine(gstate, lambda s: leader_mask(s).any(-1).sum(dtype=I32),
                    cat=False)


def aggregate_committed(gstate: SimState) -> torch.Tensor:
    """Total entries committed through consensus, summed over groups (per
    group: max commit across rows, as `committed_entries`)."""
    return _combine(gstate, lambda s: s.commit.amax(-1).sum(dtype=I32),
                    cat=False)


def group_commits(gstate: SimState) -> torch.Tensor:
    """[G] int32: each group's commit (max across its rows)."""
    return _combine(gstate, lambda s: s.commit.amax(-1), cat=True)


def aggregate_reads_served(gstate: SimState) -> torch.Tensor:
    """Total linearizable read ops served across all groups and rows (0
    when the read path is off)."""
    def served(s):
        if s.read_srv is None:
            return torch.zeros((), dtype=I32, device=s.term.device)
        return s.read_srv.sum(dtype=I32)
    return _combine(gstate, served, cat=False)


def aggregate_reads_blocked(gstate: SimState) -> torch.Tensor:
    """Total read ops refused (deposal / lease expiry) across groups."""
    def blocked(s):
        if s.read_block is None:
            return torch.zeros((), dtype=I32, device=s.term.device)
        return s.read_block.sum(dtype=I32)
    return _combine(gstate, blocked, cat=False)
