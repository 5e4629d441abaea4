"""The port's scheduler group placement against the JAX package's.

Every scenario of tests/test_scheduler_kernel.py runs on worlds built
from one description by each package's API classes, and the decisions
must be equal four ways: the JAX host Pipeline, the JAX kernel (jitted on
the CPU), the port's host Pipeline and the port's kernel path
(device="cpu": the wrapper's plain loop).  encode_group is compared field
by field, and place_group on synthetic columns.  All values are
integers, so every comparison is exact.
"""

from __future__ import annotations

import itertools
import random
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from swarmkit_tpu import api as japi
from swarmkit_tpu.api.objects import NodeStatus as JNodeStatus
from swarmkit_tpu.manager.scheduler import kernel as jkernel
from swarmkit_tpu.manager.scheduler import nodeinfo as jnodeinfo
from swarmkit_tpu.manager.scheduler.scheduler import Scheduler as JScheduler
from swarmkit_tpu.metrics import catalog as jcatalog
from swarmkit_tpu.metrics.registry import MetricsRegistry as JRegistry
from swarmkit_tpu.store import MemoryStore

from swarmkit_tpu_torch import api as tapi
from swarmkit_tpu_torch.manager import constraint as tconstraint
from swarmkit_tpu_torch.manager.scheduler import kernel as tkernel
from swarmkit_tpu_torch.manager.scheduler import nodeinfo as tnodeinfo
from swarmkit_tpu_torch.manager.scheduler import Scheduler as TScheduler
from swarmkit_tpu_torch.metrics import catalog as tcatalog
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry as TRegistry
from swarmkit_tpu_torch.parallel import cuda_ops
from swarmkit_tpu_torch.tools import sched_world

GIG = 1 << 30

JAX = types.SimpleNamespace(
    name="jax", api=types.SimpleNamespace(**vars(japi),
                                          NodeStatus=JNodeStatus),
    nodeinfo=jnodeinfo, kernel=jkernel, catalog=jcatalog,
    sched=lambda use_kernel: JScheduler(MemoryStore(), obs=JRegistry(),
                                        use_kernel=use_kernel))
PORT = types.SimpleNamespace(
    name="port", api=tapi, nodeinfo=tnodeinfo, kernel=tkernel,
    catalog=tcatalog,
    sched=lambda use_kernel: TScheduler(obs=TRegistry(),
                                        use_kernel=use_kernel, device="cpu"))
# (package, use_kernel): the four ways a group is placed
WAYS = [(JAX, False), (JAX, True), (PORT, False), (PORT, True)]


# ---- worlds from one description, as tests/test_scheduler_kernel.py ----

def _node(pkg, i, cpus, mem, zone, ready=True, generic=None, named=None):
    a = pkg.api
    return a.Node(
        id=f"n{i:02d}",
        spec=a.NodeSpec(annotations=a.Annotations(name=f"n{i:02d}",
                                                  labels={"zone": zone}),
                        availability=a.NodeAvailability.ACTIVE),
        description=a.NodeDescription(
            hostname=f"h{i}",
            platform=a.Platform(architecture="x86_64", os="linux"),
            resources=a.NodeResources(nano_cpus=cpus, memory_bytes=mem,
                                      generic=dict(generic or {}),
                                      generic_named=dict(named or {}))),
        status=a.NodeStatus(state=a.NodeState.READY if ready
                            else a.NodeState.DOWN),
    )


def _task(pkg, i, service="svc", cpus=0, mem=0, constraints=None,
          prefs=None, max_replicas=0, generic=None):
    a = pkg.api
    spec = a.TaskSpec()
    if cpus or mem or generic:
        spec.resources = a.ResourceRequirements(
            reservations=a.Resources(nano_cpus=cpus, memory_bytes=mem,
                                     generic=dict(generic or {})))
    if constraints or prefs or max_replicas:
        spec.placement = a.Placement(constraints=constraints or [],
                                     preferences=prefs or [],
                                     max_replicas=max_replicas)
    return a.Task(id=f"t{i:03d}", service_id=service, slot=i, spec=spec,
                  status=a.TaskStatus(state=a.TaskState.PENDING),
                  desired_state=int(a.TaskState.RUNNING))


def _running(pkg, i, node_id, service):
    t = _task(pkg, 1000 + i, service=service)
    t.node_id = node_id
    t.status.state = pkg.api.TaskState.RUNNING
    return t


def _random_world(rng, failures: int = 4):
    """tests/test_scheduler_kernel.py's randomized scenario as a
    description; returns build(pkg, sched) -> tasks, which makes an
    independent copy in either package's classes."""
    n_nodes = rng.randint(1, 12)
    zones = ["a", "b", "c"]
    nodes = []
    for i in range(n_nodes):
        nodes.append(dict(
            i=i,
            cpus=rng.choice([1, 2, 4, 8]) * 1_000_000_000,
            mem=rng.choice([1, 2, 4, 8]) * GIG,
            zone=rng.choice(zones),
            ready=rng.random() > 0.15,
            n_existing=rng.randint(0, 3),
        ))
    service = rng.choice(["svc", "svc", "svc", ""])
    t_kw = dict(
        service=service,
        cpus=rng.choice([0, 0, 500_000_000, 1_500_000_000, 3_000_000_000]),
        mem=rng.choice([0, 0, GIG // 2, 2 * GIG]),
        constraints=rng.choice(
            [None, None, ["node.labels.zone==a"],
             ["node.labels.zone!=b"]]),
        prefs=rng.choice([None, None, ["spread=node.labels.zone"]]),
        max_replicas=rng.choice([0, 0, 0, 1, 2]),
    )
    n_tasks = rng.randint(1, 16)
    taint_nodes = [nd["i"] for nd in nodes if rng.random() < 0.2]

    def build(pkg, sched) -> list:
        tasks = [_task(pkg, i, **t_kw) for i in range(n_tasks)]
        fkey = pkg.nodeinfo.NodeInfo.failure_key(tasks[0])
        now = sched.clock.now()
        for nd in nodes:
            existing = {}
            for j in range(nd["n_existing"]):
                et = _running(pkg, nd["i"] * 10 + j, f"n{nd['i']:02d}",
                              ["svc", "other"][j % 2])
                existing[et.id] = et
            info = pkg.nodeinfo.NodeInfo(
                _node(pkg, nd["i"], nd["cpus"], nd["mem"], nd["zone"],
                      nd["ready"]), existing)
            if nd["i"] in taint_nodes:
                for _ in range(failures):
                    info.recent_failures.setdefault(fkey, []).append(now)
            sched.node_set.add_or_update(info)
        return tasks

    return build


def _decide(sched, tasks) -> list[tuple[str, str]]:
    return [(t.id, node_id) for t, node_id, _ in
            sched._schedule_group(tasks)]


def _kernel_groups(pkg, sched, path: str) -> int:
    return int(pkg.catalog.get(sched.obs, "swarm_sched_kernel_groups_total")
               .labels(path=path).value)


def _four_ways(build) -> tuple[list, int]:
    """The decisions of each way (all equal) and how many of the two
    kernel ways ran the kernel."""
    out, kernel_runs = [], 0
    for pkg, use_kernel in WAYS:
        sched = pkg.sched(use_kernel)
        out.append(_decide(sched, build(pkg, sched)))
        if use_kernel:
            kernel_runs += _kernel_groups(pkg, sched, "kernel")
    for (pkg, uk), d in zip(WAYS, out):
        assert d == out[0], f"{pkg.name} kernel={uk}: {d} != {out[0]}"
    return out[0], kernel_runs


def test_randomized_differential_four_ways():
    rng = random.Random(1234)
    kernel_used = 0
    for trial in range(60):
        _, runs = _four_ways(_random_world(rng))
        assert runs in (0, 2), f"trial {trial}: one package fell back"
        kernel_used += runs // 2
    # the suite must actually exercise the kernel path, not fall back
    # everywhere
    assert kernel_used >= 30, f"kernel path ran only {kernel_used}/60 trials"


def test_randomized_differential_with_real_taints():
    """As above with FAILURE_LIMIT failures on the tainted nodes, so the
    taint column is not all false (the JAX scenario records 4)."""
    rng = random.Random(99)
    tainted = 0
    for _ in range(20):
        build = _random_world(rng, failures=tnodeinfo.FAILURE_LIMIT)
        _four_ways(build)
        sched = PORT.sched(True)
        tasks = build(PORT, sched)
        enc = tkernel.encode_group(
            tasks[0], list(tasks[0].spec.placement.preferences)
            if tasks[0].spec.placement else [],
            list(sched.node_set.nodes.values()),
            tnodeinfo.NodeInfo.failure_key(tasks[0]), sched.clock.now())
        tainted += enc is not None and any(enc.taint)
    assert tainted >= 5


def _world_of(pkg, sched, specs):
    for i, (cpus, mem, zone) in enumerate(specs):
        sched.node_set.add_or_update(pkg.nodeinfo.NodeInfo(
            _node(pkg, i, cpus, mem, zone), {}))


def test_resource_exhaustion_four_ways():
    """More tasks than fleet capacity: the same prefix places, the same
    tail stays unplaced, on every path."""
    def build(pkg, sched):
        _world_of(pkg, sched, [(2_000_000_000, 2 * GIG, "a")] * 3)
        return [_task(pkg, i, cpus=1_000_000_000, mem=GIG)
                for i in range(10)]

    d, runs = _four_ways(build)
    assert len(d) == 6 and runs == 2  # 2 per node fit


def test_spread_tie_break_four_ways():
    def build(pkg, sched):
        _world_of(pkg, sched, [(4_000_000_000, 4 * GIG, z)
                               for z in ["a", "a", "b", "b", "c"]])
        return [_task(pkg, i, prefs=["spread=node.labels.zone"])
                for i in range(11)]

    d, runs = _four_ways(build)
    assert len(d) == 11 and runs == 2


def test_falls_back_on_named_generic_and_multispread():
    """Uncovered encodings return None in both packages and the host path
    decides, with the fallback counter bumped."""
    for pkg in (JAX, PORT):
        node = _node(pkg, 0, 4_000_000_000, 4 * GIG, "a",
                     named={"gpu": ["gpu0", "gpu1"]})
        info = pkg.nodeinfo.NodeInfo(node, {})
        t = _task(pkg, 0, generic={"gpu": 1})
        assert pkg.kernel.encode_group(
            t, [], [info], pkg.nodeinfo.NodeInfo.failure_key(t), 0.0) is None
        t2 = _task(pkg, 1)
        assert pkg.kernel.encode_group(
            t2, ["spread=node.labels.zone", "spread=node.labels.rack"],
            [pkg.nodeinfo.NodeInfo(_node(pkg, 1, 4_000_000_000, 4 * GIG,
                                         "a"), {})],
            pkg.nodeinfo.NodeInfo.failure_key(t2), 0.0) is None
        sched = pkg.sched(True)
        sched.node_set.add_or_update(info)
        assert _decide(sched, [t]) == [("t000", "n00")]
        assert _kernel_groups(pkg, sched, "host") == 1
        assert _kernel_groups(pkg, sched, "kernel") == 0


def test_empty_node_set():
    for pkg in (JAX, PORT):
        assert _decide(pkg.sched(True), [_task(pkg, 0)]) == []


# ---- encode_group field for field -------------------------------------

_FIELDS = ("static_ok", "cap", "count0", "active0", "taint", "branch",
           "n_branches", "has_service", "gen")


def _encode(pkg, build):
    sched = pkg.sched(True)
    tasks = build(pkg, sched)
    sample = tasks[0]
    p = sample.spec.placement
    prefs = list(p.preferences) if p is not None else []
    return pkg.kernel.encode_group(
        sample, prefs, list(sched.node_set.nodes.values()),
        pkg.nodeinfo.NodeInfo.failure_key(sample), sched.clock.now())


def test_encode_group_field_for_field():
    rng = random.Random(7)
    seen_spread = 0
    for _ in range(40):
        build = _random_world(rng, failures=tnodeinfo.FAILURE_LIMIT)
        j, t = _encode(JAX, build), _encode(PORT, build)
        assert (j is None) == (t is None)
        for f in _FIELDS:
            assert getattr(j, f) == getattr(t, f), f
        assert [i.id for i in j.node_list] == [i.id for i in t.node_list]
        seen_spread += j.n_branches > 0
    assert seen_spread >= 5


def test_encode_group_clamps_a_capacity_above_int32():
    """A node with 2^40 bytes of memory and a 1-byte reservation has a
    Python-int capacity int32 cannot hold; it is clamped as the JAX
    program clamps it, and both place the same."""
    def build(pkg, sched):
        _world_of(pkg, sched, [(0, 1 << 40, "a"), (0, 1 << 20, "b")])
        return [_task(pkg, i, mem=1) for i in range(40)]

    encs = [_encode(pkg, build) for pkg in (JAX, PORT)]
    assert encs[0].cap == encs[1].cap == [1 << 30, 1 << 20]
    cols = tkernel.group_columns(encs[1], 40, device="cpu")
    assert int(cols[1, 0]) == int(cols[1, 1]) == 64 + 1   # t_pad 64
    assert jkernel.place_group(encs[0], 40) == \
        tkernel.place_group(encs[1], 40, device="cpu")
    _four_ways(build)


# ---- place_group on synthetic columns ---------------------------------

def _synthetic(seed, n, spread=False, nb=None, cap_hi=6, has_service=True,
               ok_p=0.8, big_caps=False):
    rng = np.random.default_rng(seed)
    if spread:
        ids: dict = {}
        raw = rng.integers(0, nb or n, n)
        branch = [ids.setdefault(int(b), len(ids)) for b in raw]
        n_branches = len(ids)
    else:
        branch, n_branches = [0] * n, 0
    cap = [int(c) for c in rng.integers(0, cap_hi, n)]
    if big_caps:
        cap = [c << 31 if k % 2 else c for k, c in enumerate(cap)]
    return dict(node_list=[None] * n,
                static_ok=[bool(x) for x in rng.random(n) < ok_p],
                cap=cap, count0=[int(x) for x in rng.integers(0, 4, n)],
                active0=[int(x) for x in rng.integers(0, 6, n)],
                taint=[bool(x) for x in rng.random(n) < 0.2],
                branch=branch, n_branches=n_branches,
                has_service=has_service, gen={})


PLACE_CASES = {
    "spread=node.id": (dict(n=37, spread=True, nb=37 * 1000), 90),
    "spread, few branches": (dict(n=29, spread=True, nb=3), 70),
    "caps above 2^30": (dict(n=20, big_caps=True, cap_hi=3), 300),
    "has_service=False": (dict(n=23, has_service=False), 50),
    "has_service=False, spread": (dict(n=23, has_service=False,
                                       spread=True, nb=4), 50),
    "all nodes infeasible": (dict(n=12, ok_p=0.0), 9),
    "tasks above capacity": (dict(n=13, cap_hi=3), 100),
    "N=1": (dict(n=1, ok_p=1.0), 11),
    "N=1, spread": (dict(n=1, ok_p=1.0, spread=True, nb=1), 11),
    "N and T not powers of two": (dict(n=45, cap_hi=4), 77),
    "T=1": (dict(n=9), 1),
}


@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_place_group_matches_jax(case):
    kw, n_tasks = PLACE_CASES[case]
    for seed in range(3):
        enc = _synthetic(seed, **kw)
        want = jkernel.place_group(jkernel.GroupEncoding(**enc), n_tasks)
        got = tkernel.place_group(tkernel.GroupEncoding(**enc), n_tasks,
                                  device="cpu")
        assert got == want, (case, seed)
        if case == "all nodes infeasible":
            assert got == [-1] * n_tasks
        if case == "tasks above capacity":
            assert got[-1] == -1


def test_place_greedy_checks_its_arguments():
    cols = torch.zeros((6, 4), dtype=torch.int32)
    for bad in (cols.long(), cols[:5], cols.t().contiguous(),
                torch.zeros((6, 8), dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError):
            cuda_ops.place_greedy(bad, 0, True, 3)
    with pytest.raises(ValueError, match="n_branches"):
        cuda_ops.place_greedy(cols, -1, True, 3)
    # more branches than nodes is no error (the JAX program takes it)
    assert cuda_ops.place_greedy(cols, 5, True, 3).tolist() == [-1] * 3
    spread = cols.clone()
    spread[5] = torch.tensor([0, 1, 2, 7], dtype=torch.int32)
    with pytest.raises(ValueError, match="branch ids"):
        cuda_ops.place_greedy(spread, 3, True, 3)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_ops.place_greedy(cols.to("meta"), 0, True, 3)
    assert cuda_ops.place_greedy(cols[:, :0].contiguous(), 0, True,
                                 3).tolist() == [-1] * 3


def test_place_greedy_on_the_cpu_launches_nothing():
    """The plain loop is no launch; every kernel of sched_place.cu has a
    count, and place_greedy's is one of them."""
    assert cuda_ops.PLACE_VARIANT in cuda_ops.PLACE_VARIANTS
    assert {f"sched_place_{v}" for v in cuda_ops.PLACE_VARIANTS} <= \
        set(cuda_ops.LAUNCHES)
    before = dict(cuda_ops.LAUNCHES)
    cols = tkernel.group_columns(
        tkernel.GroupEncoding(**_synthetic(0, n=9)), 5, device="cpu")
    cuda_ops.place_greedy(cols, 0, True, 5)
    assert cuda_ops.LAUNCHES == before


def test_place_group_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = tkernel.GroupEncoding(**_synthetic(0, n=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkernel.place_group(enc, 3)
    # the kernel path is the port's default: no card and no device asked
    # for is an error, never a quiet run on the CPU
    sched = TScheduler(obs=TRegistry())
    tasks = [_task(PORT, i) for i in range(2)]
    _world_of(PORT, sched, [(1, GIG, "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sched._schedule_group(tasks)


# ---- a numpy model of csrc/sched_place.cu's tree kernel ---------------

_BIG = 1 << 30


def _i32(x: int) -> int:
    """x wrapped to int32, as the kernel's two's complement sums."""
    return (x + 2**31) % 2**32 - 2**31


def _inner_size(s: int, k: int) -> int:
    """sched_place.cu's inner_size: the slots of a k-ary tree over s
    leaves, level by level above them, at least one level."""
    total = 0
    while s > 0:
        s = -(-s // k)
        total += s
        if s == 1:
            break
    return total


class _Tree:
    """One tournament tree as the kernel stores it: leaves read through
    `leaf(j)`, the inner slots level by level in `inner`, the root last.
    Keys are tuples, so min() is the kernel's field-by-field order."""

    def __init__(self, leaf, n_leaves: int, k: int):
        self.leaf, self.s, self.k = leaf, n_leaves, k
        self.inner: list = [None] * _inner_size(n_leaves, k)

    def _reduce(self, lvl: int, lo: int, hi: int):
        return min(self.leaf(j) if lvl < 0 else self.inner[lvl + j]
                   for j in range(lo, hi))

    def build(self) -> None:
        lvl, out, sz = -1, 0, self.s
        while True:
            up = -(-sz // self.k)
            for j in range(up):
                self.inner[out + j] = self._reduce(
                    lvl, j * self.k, min(j * self.k + self.k, sz))
            lvl, out, sz = out, out + up, up
            if sz <= 1:
                return

    def update(self, i: int) -> None:
        """Leaf i changed: recompute its path to the root."""
        lvl, out, sz = -1, 0, self.s
        while True:
            j = i // self.k
            self.inner[out + j] = self._reduce(
                lvl, j * self.k, min(j * self.k + self.k, sz))
            lvl, i, sz = out, j, -(-sz // self.k)
            out += sz
            if sz <= 1:
                return


def _packs(cols, nb: int, has_service: bool, n_tasks: int) -> bool:
    """The tree kernel's set-up proof that every key fits its two words
    for the whole launch (positions below 2^pbits)."""
    count0, active0 = np.asarray(cols)[2:4].astype(np.int64)
    n = count0.size
    pbits = (n - 1).bit_length()
    count_max = int(count0.max(initial=0)) + n_tasks * int(bool(has_service))
    return bool(n > 0 and count0.min() >= 0 and active0.min() >= 0
                and count_max < 2**30
                and active0.max() + n_tasks < 2**(32 - pbits)
                and (nb == 0 or n * count_max < 2**31))


def _tree_place(cols, nb: int, has_service: bool, n_tasks: int,
                k: int, pack: bool = True) -> list[int]:
    """The tree kernel's algorithm on the host, structure for structure:
    the stable grouping by branch, one k-ary tree a branch over its
    positions (key (taint, count, active, position), taint 2 when
    infeasible), the tree over the branches (key (none, load, first)),
    the forward-only first pointer and the incremental int32 load.  Where
    the kernel's set-up proves that the fields fit, keys are its two
    words ((taint << 30 | count, active << pbits | position) and
    (none << 31 | load, first)), compared as pairs; elsewhere, and with
    pack=False, field by field.  It also checks that the trees fit the
    kernel's slots (2 N and 2 nb)."""
    ok, cap, count0, active0, taint, branch = (
        [int(v) for v in row] for row in np.asarray(cols))
    n, nbe, hs = len(ok), max(nb, 1), int(bool(has_service))
    brid = branch if nb else [0] * n
    inside = [0 <= b < nbe for b in brid]
    size = [0] * nbe
    for i in range(n):
        if inside[i]:
            size[brid[i]] += 1
    bstart = list(itertools.accumulate(size, initial=0))
    cursor, nidx = bstart[:-1], [0] * bstart[-1]
    for i in range(n):
        if inside[i]:
            nidx[cursor[brid[i]]] = i
            cursor[brid[i]] += 1
    rem = [cap[i] if ok[i] else 0 for i in nidx]
    kt = [(1 if taint[i] else 0) if r > 0 else 2 for i, r in zip(nidx, rem)]
    kc = [count0[i] for i in nidx]
    ka = [active0[i] for i in nidx]
    bload, bptr = [0] * nbe, bstart[1:]
    for b in range(nbe):
        for p in range(bstart[b], bstart[b + 1]):
            if kt[p] != 2:
                bload[b] = _i32(bload[b] + kc[p])
                bptr[b] = min(bptr[b], p)
    pbits = (n - 1).bit_length()
    packed = pack and _packs(cols, nb, hs, n_tasks)

    def node_key(t, c, a, p):
        return ((t << 30 | c, a << pbits | p) if packed else (t, c, a, p))

    def root_of(key):   # the kernel's unpacking
        if not packed:
            return key
        hi, lo = key
        return hi >> 30, hi & (2**30 - 1), lo >> pbits, lo & (2**pbits - 1)

    def node_leaf(start):
        return lambda j: node_key(kt[start + j], kc[start + j],
                                  ka[start + j], start + j)

    def bfirst(b):
        return nidx[bptr[b]] if bptr[b] < bstart[b + 1] else _BIG

    def branch_leaf(b):
        none, first = int(bfirst(b) >= _BIG), bfirst(b)
        return (none << 31 | bload[b], first) if packed \
            else (none, bload[b], first)

    trees = [_Tree(node_leaf(bstart[b]), size[b], k) for b in range(nbe)]
    for tree in trees:
        if tree.s:
            tree.build()
    branches = _Tree(branch_leaf, nbe, k)
    branches.build()
    assert sum(len(tr.inner) for tr in trees) <= 2 * n
    assert len(branches.inner) <= 2 * nbe
    choices = []
    for _ in range(n_tasks if n else 0):
        b = 0
        if nb:
            first = branches.inner[-1][-1]
            if first >= _BIG:
                break
            b = brid[first]
        tree = trees[b]
        t, _, _, p = root_of(tree.inner[-1])
        if t > 1:
            break
        choices.append(nidx[p])
        before, left = kc[p], rem[p] == 1
        rem[p] -= 1
        kc[p] = _i32(before + hs)
        ka[p] = _i32(ka[p] + 1)
        if left:
            kt[p] = 2
        tree.update(p - bstart[b])
        if not nb:
            continue
        if left and p == bptr[b]:
            q = p + 1
            while q < bstart[b + 1] and kt[q] == 2:
                q += 1
            bptr[b] = q
        bload[b] = _i32(bload[b] - before if left else bload[b] + hs)
        branches.update(b)
    return choices + [-1] * (n_tasks - len(choices))


def test_tree_slots_fit_the_kernel_layout():
    """inner_size(s) <= 2 s - 1 at both arities, so one branch a node and
    one branch of every node both fit the kernel's 2 N slots."""
    for k in (2, 32):
        assert _inner_size(0, k) == 0 and _inner_size(1, k) == 1
        assert all(_inner_size(s, k) <= 2 * s - 1 for s in range(1, 5000))
    assert _inner_size(1000, 32) == 33 and _inner_size(1000, 2) == 1001


def _references(cols: torch.Tensor, nb: int, hs: bool,
                n_tasks: int) -> tuple[list, list]:
    """The plain loop's and JAX's place_group's choices for a column
    block.  A node whose branch id lies outside [0, nb) is never placed:
    both see it as statically infeasible in branch 0, which is the same
    placement."""
    cols = cols.clone()
    if nb:
        out = (cols[5] < 0) | (cols[5] >= nb)
        cols[0][out] = 0
        cols[5][out] = 0
    ok, cap, count0, active0, taint, branch = (
        [int(v) for v in row] for row in cols)
    enc = jkernel.GroupEncoding(
        node_list=[None] * len(ok), static_ok=[bool(v) for v in ok],
        cap=cap, count0=count0, active0=active0,
        taint=[bool(v) for v in taint], branch=branch, n_branches=nb,
        has_service=hs, gen={})
    return (cuda_ops.place_greedy_plain(cols, nb, hs, n_tasks).tolist(),
            jkernel.place_group(enc, n_tasks))


# the tree kernel's variants as (arity, keys in two words where they
# fit); arity 2 walks the same level layout many levels deep on these
# small inputs, where arity 32 has one or two levels
_MODELS = {"tree": (32, True), "tree_fields": (32, False),
           "deep levels": (2, True)}


@pytest.mark.parametrize("variant", sorted(_MODELS))
@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_tree_model_matches_plain_and_jax(case, variant):
    kw, n_tasks = PLACE_CASES[case]
    for seed in range(3):
        enc = tkernel.GroupEncoding(**_synthetic(seed, **kw))
        cols = tkernel.group_columns(enc, n_tasks, device="cpu")
        got = _tree_place(cols, enc.n_branches, enc.has_service, n_tasks,
                          *_MODELS[variant])
        plain, jax_ = _references(cols, enc.n_branches, enc.has_service,
                                  n_tasks)
        assert got == plain == jax_, (case, seed)


def test_tree_model_packs_only_where_the_fields_fit():
    """At the edge of the two-word proof: counts reaching 2^30 - 1 pack,
    one more does not, and both place as the plain loop does."""
    n, n_tasks = 6, 12
    for count0, packs in ((2**30 - 1 - n_tasks, True),
                          (2**30 - n_tasks, False)):
        cols = torch.tensor([[1] * n, [2] * n, [count0, 0, 5, count0, 1, 0],
                             [0, 1, 0, 1, 0, 1], [0] * n, [0] * n],
                            dtype=torch.int32)
        plain = cuda_ops.place_greedy_plain(cols, 0, True, n_tasks).tolist()
        assert _packs(cols, 0, True, n_tasks) is packs
        assert not _packs(cols, 1, True, n_tasks)   # n * count > 2^31
        for pack in (True, False):
            assert _tree_place(cols, 0, True, n_tasks, 32, pack) == plain


# column sets that stress the tree kernel, drawn by hypothesis; every set
# places 48 tasks (JAX's padded program compiles once a shape)
_DRAWN_TASKS = 48
_DRAWN = ("ties", "first leaves", "has_service=False", "nb=N", "N=1",
          "ids out of range")


@st.composite
def _drawn_columns(draw, mode: str):
    n = 1 if mode == "N=1" else draw(st.integers(1, 24))

    def col(lo, hi):
        return draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n))

    if mode == "ties":   # few values a field, often one for every node
        same = draw(st.booleans())
        field = (lambda: [draw(st.integers(0, 1))] * n) if same \
            else (lambda: col(0, 1))
        ok, count0, active0, taint = [1] * n, field(), field(), field()
        cap = [draw(st.integers(1, 3))] * n if same else col(0, 3)
    else:   # caps of one make nodes, a branch's first among them, leave
        ok, count0, active0, taint = col(0, 1), col(0, 3), col(0, 5), \
            col(0, 1)
        cap = col(0, 1) if mode == "first leaves" else col(0, 4)
    if mode == "nb=N":
        nb, branch = n, draw(st.permutations(list(range(n))))
    elif draw(st.booleans()) or mode == "ids out of range":
        nb = draw(st.integers(1, 4))
        branch = col(0, nb - 1)
        if mode == "ids out of range":
            bad = draw(st.lists(st.integers(0, n - 1), min_size=1,
                                max_size=n))
            for i in bad:
                branch[i] = draw(st.sampled_from([-1, nb, nb + 2]))
    else:
        nb, branch = 0, [0] * n
    hs = mode != "has_service=False" and draw(st.booleans())
    cols = torch.tensor([ok, cap, count0, active0, taint, list(branch)],
                        dtype=torch.int32)
    return cols, nb, hs


@pytest.mark.parametrize("variant", sorted(_MODELS))
@pytest.mark.parametrize("mode", _DRAWN)
def test_tree_model_on_drawn_columns(mode, variant):
    """The model equals the plain loop and JAX's place_group on drawn
    columns: ties at every field, a branch's first node leaving, no
    service, one branch a node, one node, branch ids out of range."""
    @settings(max_examples=20, deadline=None, derandomize=True,
              database=None, suppress_health_check=list(HealthCheck))
    @given(_drawn_columns(mode))
    def check(drawn):
        cols, nb, hs = drawn
        got = _tree_place(cols, nb, hs, _DRAWN_TASKS, *_MODELS[variant])
        plain, jax_ = _references(cols, nb, hs, _DRAWN_TASKS)
        assert got == plain == jax_

    check()


# ---- the Docker-scale world at a reduced size -------------------------

@pytest.mark.parametrize("group", sorted(sched_world.GROUPS))
def test_docker_world_reduced_matches_jax(group):
    """sched_world's generator at 60 nodes: the port's kernel path equals
    the JAX kernel on every task and the port's host Pipeline on the
    first 48."""
    desc = sched_world.describe_world(seed=3, nodes=60)
    replicas = {"A": 1500, "B": 1200, "C": 150}[group]
    jax_api = JAX.api
    decisions = {}
    for pkg, use_kernel, n in ((JAX, True, replicas),
                               (PORT, True, replicas), (PORT, False, 48)):
        sched = pkg.sched(use_kernel)
        tasks = sched_world.group_tasks(
            group, n, api=jax_api if pkg is JAX else tapi)
        sched_world.fill(sched, desc, tasks[0],
                         api=jax_api if pkg is JAX else tapi,
                         nodeinfo=pkg.nodeinfo)
        decisions[pkg.name, use_kernel] = _decide(sched, tasks)
        if use_kernel:
            assert _kernel_groups(pkg, sched, "kernel") == 1
    kern = decisions["port", True]
    assert kern == decisions["jax", True]
    host = decisions["port", False]
    assert host == [d for d in kern if int(d[0][2:]) < 48]
    if group == "A":   # capacity binds: the tail stays unplaced
        assert len(kern) < replicas


def test_docker_world_taints_and_downs_nodes():
    desc = sched_world.describe_world(seed=0)
    assert len(desc["zone"]) == 1000
    tasks = sched_world.group_tasks("A", 2)
    nodes = sched_world.build_nodes(desc, tasks[0], 0.0)
    fkey = tnodeinfo.NodeInfo.failure_key(tasks[0])
    tainted = sum(i.taint(fkey, 0.0) for i in nodes)
    down = sum(i.node.status.state != tapi.NodeState.READY for i in nodes)
    assert tainted == int(desc["tainted"].sum()) > 0
    assert down == int(desc["down"].sum()) > 0
    assert {i.node.spec.annotations.labels["zone"] for i in nodes} == \
        set(sched_world.ZONES)
    assert all(0 <= i.active_task_count() <= 3 for i in nodes)


# ---- the scheduler's entry point, objects and metrics -----------------

def test_schedule_groups_by_spec_and_counts_decisions():
    sched = PORT.sched(True)
    _world_of(PORT, sched, [(2_000_000_000, 2 * GIG, "a")] * 2)
    big = [_task(PORT, i, cpus=1_000_000_000) for i in range(6)]
    small = [_task(PORT, 10 + i, service="other") for i in range(3)]
    out = sched.schedule(big[:3] + small + big[3:])
    assert [t.id for t, _, _ in out] == \
        ["t000", "t001", "t002", "t003", "t010", "t011", "t012"]
    assert set(sched.unassigned) == {"t004", "t005"}
    dec = tcatalog.get(sched.obs, "swarm_scheduler_decisions_total")
    assert dec.labels(result="assigned").value == 7
    assert dec.labels(result="unassigned").value == 2
    assert tcatalog.get(sched.obs, "swarm_scheduler_pending_tasks") \
        .value == 2
    assert _kernel_groups(PORT, sched, "kernel") == 2
    assert tcatalog.get(sched.obs, "swarm_sched_kernel_tasks_total") \
        .value == 7


def test_metric_names_match_catalog():
    for name, labels in tkernel.METRIC_NAMES.items():
        assert tcatalog.CATALOG[name].labels == labels, name
    assert tkernel.METRIC_NAMES == jkernel.METRIC_NAMES
    for name in ("swarm_scheduler_latency_seconds",
                 "swarm_scheduler_decisions_total",
                 "swarm_scheduler_pending_tasks", *tkernel.METRIC_NAMES):
        assert name in tcatalog.CATALOG, name


def test_task_copy_is_deep_like_jax():
    for pkg in (JAX, PORT):
        t = _task(pkg, 1, cpus=5, prefs=["spread=node.labels.zone"])
        t.assigned_generic = {"gpu": ["0"]}
        c = t.copy()
        assert c == t and c is not t
        c.spec.placement.preferences.append("x")
        c.assigned_generic["gpu"].append("1")
        c.status.state = pkg.api.TaskState.ASSIGNED
        assert t.spec.placement.preferences == ["spread=node.labels.zone"]
        assert t.assigned_generic == {"gpu": ["0"]}
        assert t.status.state == pkg.api.TaskState.PENDING
    assert _task(PORT, 1).spec.encode() == _task(PORT, 2).spec.encode()


@pytest.mark.parametrize("expr,node_kw,want", [
    ("node.labels.zone==a", {}, True),
    ("node.labels.zone!=a", {}, False),
    ("node.hostname==h*", {}, True),
    ("node.platform.os==linux", {}, True),
    ("node.role==manager", {}, False),
    ("node.id!=n00", {}, False),
    ("engine.labels.x==y", {}, False),
    ("bogus.key!=1", {}, True),
])
def test_constraints_match_like_jax(expr, node_kw, want):
    from swarmkit_tpu.manager import constraint as jconstraint

    for pkg, mod in ((JAX, jconstraint), (PORT, tconstraint)):
        node = _node(pkg, 0, 1, GIG, "a", **node_kw)
        assert mod.node_matches(mod.parse([expr]), node) is want, \
            (pkg.name, expr)
    with pytest.raises(tconstraint.InvalidConstraint):
        tconstraint.parse(["node.labels.zone"])
