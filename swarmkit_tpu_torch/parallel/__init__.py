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

One cluster's rows shard too (`shard_rows(state, row_mesh(n, devices))`,
the JAX package's GSPMD row sharding): the tick's entry points given a
row-`Sharded` state run the tick on every shard in lock step
(`over_rows`), each shard on its own entry holding its rows of every
row-indexed field with every column.  Between phases the values that
cross rows move by explicit collectives of `Rx`, the shard's row
exchange: an all-gather of an [N/D] piece, a reduce-scatter of a partial
reduction over the row axis, the all-to-all transpose of an [N/D, N]
block matrix, a gather of other shards' rows or ring elements, a sum
over shards, and one mesh-wide read of the host's branch inputs.  The
shards run as threads that take turns (one runs Python at a time), so
every shard meets every collective in the same order.  `EXCHANGE`
counts the cross-entry copies and their bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

MANAGER_AXIS = "managers"
SCHEDULE_AXIS = "schedules"
GROUP_AXIS = "groups"
DCN_AXIS = "hosts"    # outer: crosses the data-center network
ICI_AXIS = "chips"    # inner: rides the on-pod interconnect
HOST_ROW_AXES = (DCN_AXIS, ICI_AXIS)

# SimState leaves that are the cluster's own, not a row's: state_shardings
# splits a leaf whose dim 0 the mesh divides (stats [4], tel_series [4, W],
# the [10] histograms), which under GSPMD is only a layout; the row tick
# reassembles them on entry and cuts them back on exit (over_rows).
CLUSTER_FIELDS = frozenset({"tick", "stats", "tel_series", "tel_commit_hist",
                            "tel_elect_hist", "tel_read_hist"})


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


# ---- the multi-device row tick ----------------------------------------------

# Cross-entry copies made by the row tick's collectives (and its entry's
# reassembly of the cluster's own leaves), their bytes, and the
# collectives served; reset_exchange() zeroes them.  A copy between two
# entries that name the same device counts: the entries are the mesh's.
EXCHANGE: dict[str, int] = {"copies": 0, "bytes": 0, "collectives": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0


def _send(x: torch.Tensor, src: int, dst: int, devices: list):
    """x moved from entry `src` to entry `dst`: a counted copy when the
    entries differ (a fresh tensor even on a shared device, so no two
    shards share storage), x itself when they are the same."""
    if src == dst:
        return x
    EXCHANGE["copies"] += 1
    EXCHANGE["bytes"] += x.numel() * x.element_size()
    return x.to(devices[dst], copy=True)


_REDUCE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
           "or": torch.logical_or, "and": torch.logical_and}

_LOCAL = threading.local()


def current_rx() -> Optional["Rx"]:
    """The row exchange of the shard this thread runs, None outside a
    row-sharded call (and always on a one-entry mesh)."""
    return getattr(_LOCAL, "rx", None)


def row_sharded(tree) -> bool:
    """A `Sharded` tree split on a row axis (row_mesh, host_row_mesh):
    one cluster's rows over several entries."""
    return isinstance(tree, Sharded) \
        and tree.axis not in (SCHEDULE_AXIS, GROUP_AXIS)


class Rx:
    """One shard's part in a row-sharded call: rows [r0, r1) of the
    cluster's n (nr = n / d of them) on entry `i` of d, and the
    collectives it meets the other shards at.  Every shard calls the same
    collectives in the same order; each returns this shard's result."""

    def __init__(self, fiber, i: int, d: int, n: int, device) -> None:
        self._fiber = fiber
        self.i, self.d, self.n = i, d, n
        self.nr = n // d
        self.r0 = i * self.nr
        self.r1 = self.r0 + self.nr
        self.device = device
        self.lead = i == 0

    def _meet(self, kind: str, *args):
        return self._fiber.meet(kind, args)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """[nr, ...] pieces -> the [n, ...] whole on every shard."""
        return self._meet("allgather", x)

    def allreduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """op ("sum", "max", "min", "or", "and") of every shard's x."""
        return self._meet("allreduce", x, op)

    def reduce_scatter(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """A partial [n, ...] (a reduction over this shard's rows, per
        column) reduced by op over the shards: this shard's rows."""
        return self._meet("reduce_scatter", x, op)

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's rows of the transpose of the [n, n, ...] matrix
        whose rows the shards hold (the all-to-all of D^2 blocks)."""
        return self._meet("transpose", x)

    def take(self, x: torch.Tensor, ids: torch.Tensor,
             cols: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x[ids] (rows of a row-indexed tensor by global row id) or
        x[ids, cols] (elements, ids and cols broadcastable), wherever the
        rows live: each request goes to every shard, and the shard owning
        a row answers it."""
        return self._meet("take", x, ids, cols)

    def take_window(self, xs: tuple, ids: torch.Tensor,
                    start: torch.Tensor, width: int) -> list:
        """For each x of xs (row-indexed [n, L] rings, this shard's rows),
        the `width` ring slots of row ids[i] from slot start[i] on (mod L),
        [nr, width]: each shard answers the rows it holds, computing the
        slots from the [nr] starts it is sent."""
        return self._meet("take_window", tuple(xs), ids, start, width)

    def read(self, xs: list, ops: list) -> list:
        """Scalar tensors combined over the shards by ops ("min", "max",
        "or", "and"), read to the host in one device->host read for the
        whole mesh; every shard gets the same ints."""
        return self._meet("read", xs, ops)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's rows of a full-width host input (a fault
        schedule's [N] or [N, N] slice), copied to its entry (no two
        shards share storage)."""
        return x.narrow(dim, self.r0, self.nr).to(self.device, copy=True)

    def on(self, x):
        """A device tensor argument (a count, a tag) on this shard's
        entry; anything else as it is."""
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def node(self, dtype=torch.int64) -> torch.Tensor:
        """The global ids of this shard's rows."""
        return torch.arange(self.r0, self.r1, dtype=dtype,
                            device=self.device)

    def eye(self) -> torch.Tensor:
        """This shard's rows of the [n, n] identity."""
        return self.node()[:, None] == torch.arange(
            self.n, device=self.device)[None, :]


class _Aborted(BaseException):
    """Unwinds a shard waiting at a collective when another shard failed."""


class _Fiber:
    """One shard's thread, kept for later row-sharded calls (a thread's
    first device calls are slow).  The calling thread hands it a job
    (`start`) and resumes it (`advance`); it runs until it meets a
    collective (`meet`) or the job returns.  One thread runs at a time,
    so the shards take turns as coroutines would."""

    def __init__(self) -> None:
        # two locks handed over between the threads, each held while its
        # side waits (a Lock may be released by another thread)
        self.go, self.back = threading.Lock(), threading.Lock()
        self.go.acquire()
        self.back.acquire()
        self.thread = threading.Thread(target=self._main, daemon=True)
        self.thread.start()

    def start(self, fn: Callable, i: int, d: int, n: int, device) -> None:
        self.rx = Rx(self, i, d, n, device)
        self.fn = fn
        self.req = self.reply = self.result = self.error = None
        self.done = self.abort = False
        self.grad = torch.is_grad_enabled()
        self.inference = torch.is_inference_mode_enabled()

    def _main(self) -> None:
        while True:
            self.go.acquire()
            _LOCAL.rx = self.rx
            try:
                if self.rx.device.type == "cuda" \
                        and self.rx.device.index is not None:
                    torch.cuda.set_device(self.rx.device)
                with torch.inference_mode(self.inference), \
                        torch.set_grad_enabled(self.grad):
                    self.result = self.fn(self.rx)
            except BaseException as e:   # noqa: BLE001 (to the caller)
                self.error = e
            finally:
                _LOCAL.rx = None
                self.done = True
                self.back.release()

    def advance(self) -> None:
        self.go.release()
        self.back.acquire()

    def meet(self, kind: str, args: tuple):
        self.req = (kind, args)
        self.back.release()
        self.go.acquire()
        if self.abort:
            raise _Aborted()
        out, self.reply, self.req = self.reply, None, None
        return out


_FIBERS: list = []
_FIBERS_LOCK = threading.Lock()


# All-gathers and reductions go through entry 0 (the pieces in, one cat or
# reduce there, the result out): 2 (D - 1) copies and one op where a direct
# exchange makes D (D - 1) copies and D ops, which on one card are launches.

def _serve_allgather(devices, n, reqs):
    whole = torch.cat([_send(r[0], s, 0, devices)
                       for s, r in enumerate(reqs)])
    return [whole] + [_send(whole, 0, dst, devices)
                      for dst in range(1, len(reqs))]


def _serve_allreduce(devices, n, reqs):
    op = reqs[0][1]
    total = functools.reduce(_REDUCE[op], [
        _send(r[0], s, 0, devices) for s, r in enumerate(reqs)])
    return [total] + [_send(total, 0, dst, devices)
                      for dst in range(1, len(reqs))]


def _serve_reduce_scatter(devices, n, reqs):
    d = len(reqs)
    nr = n // d
    total = functools.reduce(_REDUCE[reqs[0][1]], [
        _send(r[0], s, 0, devices) for s, r in enumerate(reqs)])
    return [_send(total[dst * nr:(dst + 1) * nr], 0, dst, devices)
            for dst in range(d)]


def _serve_transpose(devices, n, reqs):
    d = len(reqs)
    nr = n // d
    return [torch.cat([_send(r[0][:, dst * nr:(dst + 1) * nr], s, dst,
                             devices) for s, r in enumerate(reqs)])
            .transpose(0, 1).contiguous() for dst in range(d)]


def _serve_take(devices, n, reqs):
    d = len(reqs)
    nr = n // d
    out = []
    for a, (_, ids, cols) in enumerate(reqs):
        ids64 = ids.to(torch.int64)
        res = None
        for b, (x, _, _) in enumerate(reqs):
            loc = _send(ids64, a, b, devices) - b * nr
            li = loc.clamp(0, nr - 1)
            vals = x[li] if cols is None \
                else x[li, _send(cols, a, b, devices)]
            vals = _send(vals, b, a, devices)
            own = ids64 - b * nr
            own = (own >= 0) & (own < nr)
            own = own.view(own.shape + (1,) * (vals.dim() - own.dim()))
            res = torch.where(own, vals, torch.zeros_like(vals)
                              if res is None else res)
        out.append(res)
    return out


def _serve_take_window(devices, n, reqs):
    d = len(reqs)
    nr = n // d
    width = reqs[0][3]
    out = []
    for a, (_, ids, start, _) in enumerate(reqs):
        ids64 = ids.to(torch.int64)
        res = None
        for b, (xs, _, _, _) in enumerate(reqs):
            li = (_send(ids64, a, b, devices) - b * nr).clamp(0, nr - 1)
            ring = xs[0].shape[1]
            cols = torch.remainder(
                _send(start, a, b, devices).to(torch.int64)[:, None]
                + torch.arange(width, device=xs[0].device)[None, :], ring)
            vals = [_send(x[li[:, None], cols], b, a, devices) for x in xs]
            own = ids64 - b * nr
            own = ((own >= 0) & (own < nr))[:, None]
            res = [torch.where(own, v, torch.zeros_like(v)) for v in vals] \
                if res is None else [torch.where(own, v, r)
                                     for v, r in zip(vals, res)]
        out.append(res)
    return out


def _serve_read(devices, n, reqs):
    ops = reqs[0][1]
    mats = torch.stack([
        _send(torch.stack([x.to(torch.int64) for x in r[0]]), s, 0, devices)
        for s, r in enumerate(reqs)])
    hi = torch.tensor([op in ("max", "or") for op in ops],
                      device=mats.device)
    vals = torch.where(hi, mats.amax(0), mats.amin(0)).tolist()
    return [list(vals) for _ in reqs]


_SERVE = {"allgather": _serve_allgather, "allreduce": _serve_allreduce,
          "reduce_scatter": _serve_reduce_scatter,
          "transpose": _serve_transpose, "take": _serve_take,
          "take_window": _serve_take_window,
          "read": _serve_read}


def _run_shards(devices: list, n: int, fns: list) -> list:
    """fns[i](rx) on every shard in lock step, serving their collectives;
    the per-shard results.  A shard's failure unwinds the others and is
    raised here."""
    d = len(devices)
    with _FIBERS_LOCK:
        while len(_FIBERS) < d:
            _FIBERS.append(_Fiber())
        fibers = _FIBERS[:d]
        for i, f in enumerate(fibers):
            f.start(fns[i], i, d, n, devices[i])
        try:
            while True:
                for f in fibers:
                    f.advance()
                for f in fibers:
                    if f.error is not None \
                            and not isinstance(f.error, _Aborted):
                        raise f.error
                if all(f.done for f in fibers):
                    return [f.result for f in fibers]
                kinds = [None if f.done else f.req[0] for f in fibers]
                if len(set(kinds)) != 1:
                    raise RuntimeError(f"row shards diverged at a "
                                       f"collective: {kinds}")
                EXCHANGE["collectives"] += 1
                replies = _SERVE[kinds[0]](devices, n,
                                           [f.req[1] for f in fibers])
                for f, r in zip(fibers, replies):
                    f.reply = r
        finally:
            # a shard still waiting at a collective unwinds; then every
            # fiber waits for its next job
            for f in fibers:
                if not f.done:
                    f.abort = True
                    f.advance()


def _cluster_leaf(name: str, leaf, n: int, sharded: bool, d: int) -> bool:
    if name in CLUSTER_FIELDS:
        return True
    if not isinstance(leaf, torch.Tensor):
        return False
    return leaf.dim() == 0 or leaf.shape[0] * (d if sharded else 1) != n


def _fields(tree) -> list:
    return [f.name for f in dataclasses.fields(tree) if f.init]


def over_rows(state: Sharded, n: int, fn: Callable) -> list:
    """fn(shard_state, rx) on every shard of a row-Sharded dataclass tree
    (a SimState) in lock step, each in its own thread with current_rx()
    set; returns the per-shard results.  fn sees the cluster's own leaves
    (CLUSTER_FIELDS and any leaf whose dim 0 is not n) whole: a leaf that
    state_shardings split is reassembled on every entry first."""
    devices, d = state.devices, len(state)
    whole: list = [{} for _ in range(d)]
    for name in _fields(state.shards[0]):
        spec = getattr(state.specs, name)
        pieces = [getattr(s, name) for s in state.shards]
        if spec and _cluster_leaf(name, pieces[0], n, True, d):
            for dst in range(d):
                whole[dst][name] = torch.cat([
                    _send(p, s, dst, devices) for s, p in enumerate(pieces)])
    shards = [dataclasses.replace(s, **w) if w else s
              for s, w in zip(state.shards, whole)]
    return _run_shards(devices, n, [
        functools.partial(lambda st, rx: fn(st, rx), st) for st in shards])


def rows_result(state: Sharded, n: int, shards: list) -> Sharded:
    """Per-shard result states as a Sharded of `state`'s layout: each
    cluster leaf that the layout splits is cut back to the shard's piece,
    so `gather` returns the unsharded bits."""
    d = len(shards)
    out = []
    for i, st in enumerate(shards):
        cut = {}
        for name in _fields(st):
            leaf = getattr(st, name)
            # (a row leaf comes back as the shard's piece, a cluster leaf
            # whole: the test of over_rows on pieces tells them apart)
            if getattr(state.specs, name, ()) and isinstance(
                    leaf, torch.Tensor) and _cluster_leaf(name, leaf, n,
                                                          True, d):
                step = leaf.shape[0] // d
                cut[name] = leaf[i * step:(i + 1) * step]
        out.append(dataclasses.replace(st, **cut) if cut else st)
    return Sharded(state.mesh, state.axis, state.specs, out)


def run_rows(state: Sharded, n: int, fn: Callable):
    """over_rows with the results put back: a state becomes a Sharded of
    `state`'s layout, and a (state, extra...) tuple keeps shard 0's extras
    (values every shard computed the same, such as a trace)."""
    res = over_rows(state, n, fn)
    first = res[0]
    if isinstance(first, tuple):
        return (rows_result(state, n, [r[0] for r in res]),) + first[1:]
    if dataclasses.is_dataclass(first):
        return rows_result(state, n, res)
    return first


def only(tree, names):
    """A dataclass tree (or a Sharded one) with only the fields `names`,
    the others None: what a host read of a few fields gathers."""
    def keep(t):
        return dataclasses.replace(t, **{f: None for f in _fields(t)
                                         if f not in names})
    if isinstance(tree, Sharded):
        return Sharded(tree.mesh, tree.axis, keep(tree.specs),
                       [keep(s) for s in tree.shards])
    return keep(tree)
