"""A scheduler world at Docker's published swarm scale, made from a seed.

Docker's own scale test ("Scale Testing Docker Swarm to 30,000
Containers", docker.com blog, 2015) ran 1,000 nodes and 30,000
containers.  `describe_world` draws such a cluster with numpy: nodes in
three zones (`node.labels.zone` a / b / c), each of {2, 4, 8, 16} CPUs
and {4, 8, 16, 32} GiB, 5% of them down, 2% tainted for the group's
service (FAILURE_LIMIT recent failures of its spec), each already
running 0-3 tasks that reserve 0.25 CPU and 512 MiB, about half of them
of the group's own service.  `build_nodes` turns the description into
NodeInfo mirrors of one API's classes (the port's unless the caller
passes another's), so the chip run, the card tests and the CPU tests
place groups on the same world.

`GROUPS` holds the three task groups that chip_smoke.py phase 17
places, each on a fresh copy of the world:

- A: 30,000 replicas reserving 0.25 CPU / 512 MiB each, spread over the
  zones; the fleet holds about 16,000 of them, so the tail stays unplaced;
- B: 30,000 replicas on `node.labels.zone!=c`, at most 40 a node, no
  reservations;
- C: 4,096 replicas spread by `node.id`, one spread branch a node.
"""

from __future__ import annotations

import types

import numpy as np

from swarmkit_tpu_torch import api as port_api
from swarmkit_tpu_torch.manager.scheduler import nodeinfo as port_nodeinfo

NANO = 1_000_000_000
GIB = 1 << 30
SERVICE = "web"
ZONES = ("a", "b", "c")
CPUS = (2, 4, 8, 16)
MEM_GIB = (4, 8, 16, 32)
# what each task already running reserves
RUNNING_CPUS, RUNNING_MEM = NANO // 4, 512 << 20

GROUPS = {
    "A": dict(replicas=30_000, cpus=NANO // 4, mem=512 << 20,
              prefs=["spread=node.labels.zone"]),
    "B": dict(replicas=30_000, constraints=["node.labels.zone!=c"],
              max_replicas=40),
    "C": dict(replicas=4_096, prefs=["spread=node.id"]),
}


def describe_world(seed: int = 0, nodes: int = 1000) -> dict:
    """The world's numbers, as numpy arrays of length `nodes`."""
    rng = np.random.default_rng(seed)
    n_running = rng.integers(0, 4, nodes)
    return {
        "zone": rng.integers(0, len(ZONES), nodes),
        "cpus": rng.choice(CPUS, nodes),
        "mem_gib": rng.choice(MEM_GIB, nodes),
        "down": rng.random(nodes) < 0.05,
        "tainted": rng.random(nodes) < 0.02,
        "running": n_running,
        # how many of each node's running tasks belong to SERVICE
        "running_own": rng.binomial(n_running, 0.5),
    }


def group_tasks(name: str, replicas: int | None = None,
                api: types.ModuleType = port_api) -> list:
    """The PENDING tasks of group `name` (all of its replicas, or the
    first `replicas`), with one spec."""
    g = GROUPS[name]
    spec_kw = {}
    if g.get("cpus") or g.get("mem"):
        spec_kw["resources"] = api.ResourceRequirements(
            reservations=api.Resources(nano_cpus=g.get("cpus", 0),
                                       memory_bytes=g.get("mem", 0)))
    spec_kw["placement"] = api.Placement(
        constraints=list(g.get("constraints", [])),
        preferences=list(g.get("prefs", [])),
        max_replicas=g.get("max_replicas", 0))
    n = g["replicas"] if replicas is None else replicas
    return [api.Task(id=f"{name}-{i:05d}", service_id=SERVICE, slot=i,
                     spec=api.TaskSpec(
                         container=api.ContainerSpec(image="nginx:alpine"),
                         **spec_kw),
                     status=api.TaskStatus(state=api.TaskState.PENDING),
                     desired_state=int(api.TaskState.RUNNING))
            for i in range(n)]


def _running(api, node_id: str, i: int, j: int, own: bool):
    return api.Task(
        id=f"run-{i:04d}-{j}", service_id=SERVICE if own else "other",
        node_id=node_id, slot=j,
        spec=api.TaskSpec(resources=api.ResourceRequirements(
            reservations=api.Resources(nano_cpus=RUNNING_CPUS,
                                       memory_bytes=RUNNING_MEM))),
        status=api.TaskStatus(state=api.TaskState.RUNNING),
        desired_state=int(api.TaskState.RUNNING))


def build_nodes(desc: dict, sample, now: float,
                api: types.ModuleType = port_api,
                nodeinfo: types.ModuleType = port_nodeinfo) -> list:
    """NodeInfo mirrors of the described nodes, in node order, built from
    `api`'s classes and `nodeinfo`'s NodeInfo.  The tainted nodes hold
    FAILURE_LIMIT failures of `sample`'s spec at `now`."""
    fkey = nodeinfo.NodeInfo.failure_key(sample)
    out = []
    for i in range(len(desc["zone"])):
        node_id = f"node-{i:04d}"
        node = api.Node(
            id=node_id,
            spec=api.NodeSpec(annotations=api.Annotations(
                name=node_id, labels={"zone": ZONES[desc["zone"][i]]}),
                availability=api.NodeAvailability.ACTIVE),
            description=api.NodeDescription(
                hostname=f"host-{i:04d}",
                platform=api.Platform(architecture="x86_64", os="linux"),
                resources=api.NodeResources(
                    nano_cpus=int(desc["cpus"][i]) * NANO,
                    memory_bytes=int(desc["mem_gib"][i]) * GIB)),
            status=api.NodeStatus(state=api.NodeState.DOWN
                                  if desc["down"][i]
                                  else api.NodeState.READY))
        own = int(desc["running_own"][i])
        running = [_running(api, node_id, i, j, j < own)
                   for j in range(int(desc["running"][i]))]
        info = nodeinfo.NodeInfo(node, {t.id: t for t in running})
        if desc["tainted"][i]:
            info.recent_failures[fkey] = [now] * nodeinfo.FAILURE_LIMIT
        out.append(info)
    return out


def fill(sched, desc: dict, sample, api: types.ModuleType = port_api,
         nodeinfo: types.ModuleType = port_nodeinfo) -> None:
    """Put the described nodes into `sched.node_set`, in node order, with
    their taints dated at `sched.clock.now()`."""
    for info in build_nodes(desc, sample, sched.clock.now(), api, nodeinfo):
        sched.node_set.add_or_update(info)
