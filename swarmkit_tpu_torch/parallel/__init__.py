"""Device meshes and placement for the port's batch axes (PyTorch port of
the JAX package's parallel/__init__.py), beside the hand-written kernels
of cuda_ops.py.

The JAX package's meshes are single-process SPMD: one controller holds
every device, and `shard_rows` device_puts a pytree with its leading axis
split over a 1-D (or hosts x chips) mesh.  The port keeps that shape with
no process group: a `Mesh` is an array of torch devices, and sharding a
tree over D > 1 entries gives a `Sharded` tree, D per-shard trees of the
same type, one on each entry, that the batch paths (dst.explore's
schedules, mc.exhaustive_scan's lanes, multiraft's groups, the device
wire's mailbox rows) step shard by shard.  Those axes hold independent
clusters, so no value crosses shards inside a tick and per-shard runs
reproduce the unsharded bits.  A mesh may name one device more than once
(each entry one shard), the counterpart of XLA's virtual host devices:
that is how the CPU, or one card, runs the sharded code.

Default devices are every local CUDA card; the CPU is used only when the
caller names it.  Torch devices carry no `process_index`, so
`host_row_mesh` takes its single-process branch unless the caller passes
objects that carry one.

One cluster's row axis is not sharded across devices: the tick reads
across rows (the [N] vectors, the mailbox transpose, the banded counts'
column bands), so `run_ticks` / `step` given a row-`Sharded` state raise
NotImplementedError (ROADMAP Queue 1: the multi-device row tick).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

MANAGER_AXIS = "managers"
SCHEDULE_AXIS = "schedules"
GROUP_AXIS = "groups"
DCN_AXIS = "hosts"    # outer: crosses the data-center network
ICI_AXIS = "chips"    # inner: rides the on-pod interconnect
HOST_ROW_AXES = (DCN_AXIS, ICI_AXIS)

ROW_TICK_TODO = ("the tick of one cluster over a row mesh of several "
                 "devices is not ported (ROADMAP Queue 1: the multi-device "
                 "row tick); use a one-device mesh")


class Mesh:
    """Devices laid out on named axes, as jax.sharding.Mesh: `devices` is
    an object ndarray of devices (torch.device, or any object), one axis
    per name in `axis_names`; `shape` maps each name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        arr = _device_array(devices)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """The entries in mesh order (row-major, hosts outermost)."""
        return list(self.devices.ravel())


def _device_array(devices) -> np.ndarray:
    """An object ndarray of `devices` (nested lists allowed) that never
    looks inside a device."""
    if isinstance(devices, np.ndarray) and devices.dtype == object:
        return devices.copy()
    shape, flat = [], []

    def walk(x, depth):
        if isinstance(x, (list, tuple, np.ndarray)):
            if len(shape) <= depth:
                shape.append(len(x))
            elif shape[depth] != len(x):
                raise ValueError("ragged device list")
            for y in x:
                walk(y, depth + 1)
        else:
            flat.append(x)

    walk(devices, 0)
    arr = np.empty((len(flat),), dtype=object)
    for i, dev in enumerate(flat):
        arr[i] = dev
    return arr.reshape(shape)


def local_devices(device=None) -> list:
    """The local devices a mesh defaults to: every CUDA card for a CUDA
    `device` (or None), the CPU once for a CPU `device`.  Without a card
    and without a device it raises: the port never drops to the CPU on
    its own."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices "
                           "(e.g. [torch.device('cpu')] * 8) to build a "
                           "mesh on the CPU")
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices) -> list:
    if devices is None:
        return local_devices()
    return [torch.device(d) if isinstance(d, str) else d for d in devices]


def shard_count(rows: int, devices) -> int:
    """The largest d <= len(devices) with rows % d == 0 (1 at worst): the
    entries a mesh over `rows` uses, and tpu://pmatmul's shard count."""
    d = len(devices)
    while d > 1 and rows % d != 0:
        d -= 1
    return max(d, 1)


def row_mesh(rows: int, devices: Optional[Sequence] = None,
             axis: str = MANAGER_AXIS) -> Mesh:
    """1-D mesh over the largest device prefix that divides `rows`."""
    devices = _devices(devices)
    return Mesh(devices[:shard_count(rows, devices)], (axis,))


def schedule_mesh(schedules: int,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the DST schedule axis (dst/explore.py) and the model
    checker's lanes (mc/frontier.py)."""
    return row_mesh(schedules, devices, axis=SCHEDULE_AXIS)


def group_mesh(groups: int, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the multiraft group axis (multiraft/)."""
    return row_mesh(groups, devices, axis=GROUP_AXIS)


def host_row_mesh(rows: int, hosts: int = 2,
                  devices: Optional[Sequence] = None) -> Mesh:
    """2-D hosts x chips mesh, hosts outermost, as the JAX package's:
    among shapes with hosts <= the request and hosts*chips dividing
    `rows`, the one using the most devices wins (ties keep more hosts).
    Devices that carry a `process_index` and span several processes give
    the physical layout (the chips axis never crosses a host); otherwise
    the partition is simulated over a device prefix."""
    devices = _devices(devices)
    groups: dict[int, list] = {}
    for dev in devices:
        groups.setdefault(getattr(dev, "process_index", 0), []).append(dev)
    if len(groups) > 1:
        order = sorted(groups, key=lambda p: (-len(groups[p]), p))
        h, c = pick_host_shape(rows, min(hosts, len(order)),
                               [len(groups[p]) for p in order])
        arr = [groups[p][:c] for p in order[:h]]
    else:
        h, c = pick_host_shape(rows, min(hosts, len(devices)),
                               None, total=len(devices))
        arr = [devices[i * c:(i + 1) * c] for i in range(h)]
    return Mesh(arr, HOST_ROW_AXES)


def pick_host_shape(rows: int, max_hosts: int,
                    group_sizes: Optional[list] = None,
                    total: int = 0) -> tuple:
    """(hosts, chips) maximizing devices used, s.t. hosts*chips | rows.

    With `group_sizes` (real multi-host, pre-sorted LARGEST-first by the
    caller), a shape of h hosts uses the h largest hosts and chips is
    bounded by the smallest of those, keeping the mesh rectangular
    without crossing host boundaries; without it, any (h, c) with
    h*c <= total works.  Ties prefer more hosts (h scans downward,
    strict improvement wins).
    """
    best_h, best_c = 1, 1
    for h in range(max(1, max_hosts), 0, -1):
        c = min(g for g in group_sizes[:h]) if group_sizes else total // h
        while c > 1 and rows % (h * c):
            c -= 1
        if rows % (h * c) == 0 and h * c > best_h * best_c:
            best_h, best_c = h, c
    return best_h, best_c


def row_spec(ndim: int, axis=MANAGER_AXIS) -> tuple:
    """The PartitionSpec of a leaf sharded on its leading axis: (axis,
    None, ...), or () for a scalar.  `axis` may be one mesh axis name or a
    tuple of names (HOST_ROW_AXES: hosts-major over both)."""
    if ndim == 0:
        return ()
    return (axis,) + (None,) * (ndim - 1)


def _axis_size(mesh: Mesh, axis) -> int:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[a]
    return size


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def state_shardings(mesh: Mesh, tree, axis=MANAGER_AXIS, leading=None):
    """Per-leaf spec tree: the leading axis on the mesh axis (or axes).

    Leaves whose leading dimension the mesh does not divide are
    replicated (spec ()): row-axis state always divides (the mesh is built
    from a divisor of n), so such a leaf is per-cluster bookkeeping like
    the [4] stats vector.  `leading` pins the rule to one axis length:
    only leaves whose dim 0 equals it are sharded (divisibility still
    required), everything else replicates: a grouped tree's group-shared
    leaves must not be split on the group axis."""
    size = _axis_size(mesh, axis)

    def spec(leaf):
        nd = _ndim(leaf)
        if leading is not None and (not nd or leaf.shape[0] != leading):
            return ()
        if nd and leaf.shape[0] % size == 0:
            return row_spec(nd, axis)
        return ()
    return tree_map(spec, tree)


@dataclasses.dataclass
class Sharded:
    """A tree split over the entries of `mesh` on `axis`: `shards[i]` is a
    tree of the original's type on `mesh.device_list()[i]`, and `specs`
    the original's spec tree (a leaf with spec () was copied to every
    shard, the others hold their slice of dim 0)."""

    mesh: Mesh
    axis: object
    specs: object
    shards: list

    @property
    def devices(self) -> list:
        return self.mesh.device_list()

    def __len__(self) -> int:
        return len(self.shards)


def _is_leaf(x) -> bool:
    return not (x is None or isinstance(x, (list, tuple, dict))
                or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`):
    dataclasses (SimState, FaultSchedule), tuples, named tuples, lists
    and dicts are nodes, None is an empty node, anything else a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if not _is_leaf(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, *rest)


def _place(leaf, dev, copy: bool):
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.to(dev, copy=copy)
    return leaf


def shard_rows(tree, mesh: Mesh, axis=MANAGER_AXIS, leading=None):
    """Place a tree on `mesh` with its leading axis split on `axis`.

    On a mesh of one device it returns the tree on that device (no copy
    where it already lies there): one device's sharding is a placement.
    On D > 1 entries it returns a `Sharded` tree of D per-shard copies,
    each leaf split on dim 0 by its spec (state_shardings) and the
    replicated ones copied to every shard; no shard shares storage with
    the input or with another shard (the tick writes rings in place)."""
    devices = mesh.device_list()
    if len(devices) == 1:
        return tree_map(lambda leaf: _place(leaf, devices[0], False), tree)
    specs = state_shardings(mesh, tree, axis, leading)
    d = len(devices)

    def piece(i):
        def cut(leaf, spec):
            if spec and isinstance(leaf, (torch.Tensor, np.ndarray)):
                step = leaf.shape[0] // d
                leaf = leaf[i * step:(i + 1) * step]
            return _place(leaf, devices[i], True)
        return tree_map(cut, tree, specs)

    return Sharded(mesh, axis, specs, [piece(i) for i in range(d)])


def gather(tree, device=None):
    """A `Sharded` tree concatenated back into one tree on `device`
    (default: the mesh's first entry); any other tree is returned as it
    is."""
    if not isinstance(tree, Sharded):
        return tree
    dev = device if device is not None else tree.devices[0]

    def join(first, spec, *rest):
        if spec and isinstance(first, torch.Tensor):
            return torch.cat([x.to(dev) for x in (first, *rest)])
        return _place(first, dev, False)

    return tree_map(join, tree.shards[0], tree.specs, *tree.shards[1:])


def psum(scalars: list, devices: list) -> list:
    """The sum of one scalar per shard, back on every shard's device (the
    JAX package's ``lax.psum`` over a batch axis): gathered onto the first
    device, summed, and broadcast."""
    total = torch.stack([s.to(devices[0]) for s in scalars]).sum()
    return [total.to(dev) for dev in devices]


def split_lanes(lanes: int, width: int, shards: int) -> list:
    """The [start, stop) lane ranges of `shards` equal blocks of a
    `width`-wide pass clipped to its `lanes` real lanes, as the JAX
    package lays a padded pass over a mesh; blocks past the real lanes
    are empty."""
    per = width // shards
    return [(min(i * per, lanes), min((i + 1) * per, lanes))
            for i in range(shards)]
