"""swarm-bench: time-to-N-running-tasks for the full control plane.

Reference: cmd/swarm-bench — creates a replicated service of N tasks that
"phone home" and measures time until all N connect (Benchmark.Run
benchmark.go:38, Collector percentiles).  Here the phone-home is the task
status write-back through the real dispatcher/agent loop; the measurement
is time from CreateService until N tasks report RUNNING, with per-task
latency percentiles.

The port's own copy of the JAX package's cmd/swarm_bench.py: the same
flags, defaults and JSON keys, plus ``--device``, where the leader's
scheduler places (its ``sched_place`` kernel) and, with ``--transport
device``, where the device wire's mailbox lives.  It defaults to the CUDA
card and raises without one; ``--device cpu`` runs both on the CPU (the
scheduler's plain loop).  The flow is split over ``Quorum`` (start the
managers, ``appends``, ``startup``, ``stop``) so that a caller can look at
the replicated stores between the steps; ``bench`` runs them as the JAX
package's one function does.

    python -m swarmkit_tpu_torch.cmd.swarm_bench [--managers 3]
        [--transport device] [--proposals 1000 [--batch 64]] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time

from swarmkit_tpu_torch.agent import Agent, AgentConfig
from swarmkit_tpu_torch.agent.testutils import TestExecutor
from swarmkit_tpu_torch.api import (
    Annotations, Config as ApiConfig, ConfigSpec, ContainerSpec,
    MembershipState, NodeSpec, ReplicatedService, ServiceSpec, TaskSpec,
    TaskState,
)
from swarmkit_tpu_torch.api.objects import Node as ApiNode, NodeStatus
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.manager.manager import Manager
from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.raft.transport import Network
from swarmkit_tpu_torch.store.memory import match

LEADER_WAIT_S = 30.0   # seconds Quorum.start waits for its first leader


def _pct(lat: list, p: float) -> float:
    return lat[min(len(lat) - 1, int(p * len(lat)))]


class Quorum:
    """`managers` Managers on one wire: the in-process one, or the device
    mailbox (``transport="device"``) on `device`.  The first bootstraps
    and leads; the rest join it."""

    def __init__(self, managers: int = 1, transport: str = "inproc",
                 tick_interval: float = 0.05, election_tick: int = 4,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.n = managers
        self.transport = transport
        self.tick_interval = tick_interval
        self.election_tick = election_tick
        self.transport_factory = None
        if transport == "device":
            # manager-quorum consensus over the device-mesh mailbox wire
            # (SURVEY §7), its mailbox on `device`
            from swarmkit_tpu_torch.transport import (
                DeviceMeshNet, DeviceMeshTransport,
            )
            self.net = DeviceMeshNet(seed=1, rows=max(8, managers),
                                     device=self.device)
            self.transport_factory = DeviceMeshTransport
        else:
            self.net = Network(seed=1)
        self.tmp = tempfile.TemporaryDirectory(prefix="swarm-bench-")
        self.mgrs: list[Manager] = []
        self.agents: list[Agent] = []

    def new_manager(self, i: int, join_addr: str = "") -> Manager:
        """Manager `i` over its state_dir (an existing one restarts)."""
        return Manager(node_id=f"m{i}", addr=f"m{i}:4242", network=self.net,
                       state_dir=f"{self.tmp.name}/m{i}",
                       join_addr=join_addr,
                       tick_interval=self.tick_interval,
                       election_tick=self.election_tick, seed=i,
                       transport_factory=self.transport_factory,
                       device=self.device)

    async def start(self) -> None:
        """Start the managers; the first must lead within LEADER_WAIT_S
        seconds before the others join it, else TimeoutError."""
        for i in range(self.n):
            m = self.new_manager(i, self.mgrs[0].addr if self.mgrs else "")
            await m.start()
            self.mgrs.append(m)
            if i == 0:
                deadline = time.monotonic() + LEADER_WAIT_S
                while not m.is_leader():
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"manager {m.node_id} did not become leader "
                            f"within {LEADER_WAIT_S} s")
                    await asyncio.sleep(0.02)

    def leader(self) -> Manager:
        for m in self.mgrs:
            if m._running and m.is_leader():
                return m
        return self.mgrs[0]

    async def appends(self, proposals: int, batch: int = 1,
                      coalesce_window: float = 0.0) -> dict:
        """BASELINE.json config 2: N-manager quorum ProposeValue appends
        through the leader's replicated store — per-proposal commit
        latency through the real raft path (reference swarm-bench's
        role for control-plane throughput).  batch > 1 switches the
        store to the coalescing proposal pipeline (store/pipeline.py)
        and keeps k appends in flight concurrently, so many txns pack
        into one raft round ("k appends/round" in PERF.md)."""
        lead = self.mgrs[0]
        if batch > 1:
            from swarmkit_tpu_torch.store.pipeline import CoalesceConfig
            lead.store.set_coalescing(CoalesceConfig(
                window=coalesce_window, max_entries=max(batch, 2)))

        lat: list[float] = []

        async def one(i: int) -> None:
            p0 = time.perf_counter()
            await lead.store.update(lambda tx: tx.create(ApiConfig(
                id=f"bench-cfg-{i}",
                spec=ConfigSpec(annotations=Annotations(name=f"p{i}"),
                                data=b"x"))))
            lat.append(time.perf_counter() - p0)

        t0 = time.perf_counter()
        if batch > 1:
            for base in range(0, proposals, batch):
                await asyncio.gather(*(
                    one(i) for i in range(base,
                                          min(base + batch, proposals))))
        else:
            for i in range(proposals):
                await one(i)
        total = time.perf_counter() - t0
        lat.sort()

        packed = committed = 0.0
        if batch > 1:
            packed = obs_catalog.get(lead.obs, "swarm_cpl_proposals_total") \
                .labels(outcome="committed").value
            committed = obs_catalog.get(lead.obs, "swarm_cpl_txns_total") \
                .labels(outcome="committed").value
        return {
            "managers": self.n, "transport": self.transport,
            "proposals": proposals, "batch": batch,
            "entries_per_proposal": round(committed / packed, 2)
            if packed else 1.0,
            "coalesce_window_ms": round(coalesce_window * 1e3, 3),
            "proposals_per_s": round(proposals / total, 1),
            "propose_p50_ms": round(_pct(lat, 0.5) * 1e3, 3),
            "propose_p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
        }

    def connect(self):
        """The dispatcher an agent talks to: the leader's."""
        return self.leader().dispatcher

    async def add_agent(self, node_id: str, executor) -> Agent:
        """A node record for `node_id` and an agent on it running
        `executor`, connected to the leader's dispatcher."""
        await self.leader().store.update(lambda tx: tx.create(ApiNode(
            id=node_id, spec=NodeSpec(annotations=Annotations(name=node_id),
                                      membership=MembershipState.ACCEPTED),
            status=NodeStatus())))
        a = Agent(AgentConfig(node_id=node_id, executor=executor,
                              connect=self.connect))
        await a.start()
        self.agents.append(a)
        return a

    async def startup(self, replicas: int, workers: int) -> dict:
        """The task-startup flow: `workers` agents on TestExecutors, then
        the time from create_service until all `replicas` report
        RUNNING, with per-task latency percentiles."""
        lead = self.leader()
        agents = [await self.add_agent(f"w{i}", TestExecutor(
            hostname=f"w{i}")) for i in range(workers)]
        for a in agents:
            await a.ready()

        # measure: create service -> all replicas RUNNING.  Subscribe
        # BEFORE creating so instantly-running tasks can't slip past the
        # watcher.
        latencies: dict[str, float] = {}
        watcher = lead.store.watch(match(kind="task", action="update"))
        start = time.perf_counter()
        svc = await lead.control_api.create_service(ServiceSpec(
            annotations=Annotations(name="bench"),
            task=TaskSpec(container=ContainerSpec(image="img")),
            replicated=ReplicatedService(replicas=replicas)))
        running = set()
        async for ev in watcher:
            t = ev.object
            if t.service_id == svc.id \
                    and t.status.state == TaskState.RUNNING \
                    and t.id not in running:
                running.add(t.id)
                latencies[t.id] = time.perf_counter() - start
                if len(running) >= replicas:
                    break
        watcher.close()
        total = time.perf_counter() - start
        lat = sorted(latencies.values())
        return {
            "replicas": replicas, "workers": workers,
            "transport": self.transport,
            "time_to_all_running_s": round(total, 4),
            "tasks_per_s": round(replicas / total, 2),
            "p50_s": round(_pct(lat, 0.50), 4),
            "p90_s": round(_pct(lat, 0.90), 4),
            "p99_s": round(_pct(lat, 0.99), 4),
        }

    async def stop(self) -> None:
        for a in self.agents:
            await a.stop()
        for m in self.mgrs:
            await m.stop()
        close = getattr(self.net, "close", None)
        if close is not None:
            close()
        self.tmp.cleanup()


async def bench(replicas: int, workers: int, managers: int = 1,
                transport: str = "inproc", tick_interval: float = 0.05,
                election_tick: int = 4, proposals: int = 0,
                batch: int = 1, coalesce_window: float = 0.0,
                device=None) -> dict:
    q = Quorum(managers, transport, tick_interval, election_tick, device)
    await q.start()
    try:
        if proposals > 0:
            return await q.appends(proposals, batch, coalesce_window)
        return await q.startup(replicas, workers)
    finally:
        await q.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swarm-bench")
    p.add_argument("--replicas", type=int, default=100)
    p.add_argument("--workers", type=int, default=10)
    p.add_argument("--managers", type=int, default=1)
    p.add_argument("--transport", choices=["inproc", "device"],
                   default="inproc",
                   help="raft wire: in-process queues or the device-mesh "
                        "mailbox backend")
    p.add_argument("--tick-interval", type=float, default=0.05,
                   help="raft tick seconds (raise it when the device wire's "
                        "flushes are slow)")
    p.add_argument("--election-tick", type=int, default=4)
    p.add_argument("--proposals", type=int, default=0,
                   help="measure N sequential ProposeValue appends through "
                        "the manager quorum instead of the task-startup "
                        "flow (BASELINE config 2)")
    p.add_argument("--batch", type=int, default=1,
                   help="keep k proposals in flight and coalesce them into "
                        "packed raft rounds via the store's proposal "
                        "pipeline (1 = the sequential baseline path)")
    p.add_argument("--coalesce-window", type=float, default=0.0,
                   help="pipeline gathering window in seconds (0 = one "
                        "event-loop pass)")
    p.add_argument("--device", default=None,
                   help="where the scheduler's kernel and the device wire "
                        "run (default: the CUDA card; cpu for the CPU)")
    args = p.parse_args(argv)
    result = asyncio.run(bench(args.replicas, args.workers, args.managers,
                               transport=args.transport,
                               tick_interval=args.tick_interval,
                               election_tick=args.election_tick,
                               proposals=args.proposals,
                               batch=args.batch,
                               coalesce_window=args.coalesce_window,
                               device=args.device))
    json.dump(result, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
