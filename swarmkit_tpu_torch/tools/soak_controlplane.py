"""Control-plane churn soak + gRPC agent-session load harness, on the port.

Two modes share this tool:

* **Churn soak** (default): the in-process cluster
  (tools/integration_harness.py's TestCluster) under continuous leader
  kills, drains, scaling and rolling updates for a wall-clock budget.
  Every cycle asserts the cluster converges back to the desired state,
  and the soak fails loudly on any wedge, crash, or leaked task.

* **Load harness** (``--agents N``): thousands of simulated agent
  sessions over the REAL gRPC wire — each agent registers through the
  dispatcher Session stream, heartbeats on its own timer (client-timed
  RTT), and a hot subset consumes Assignments streams and writes task
  statuses back, while a workload loop scales a service up and down to
  keep assignments flowing and a churn loop re-registers cold agents
  (node churn).  Managers run with the coalescing proposal pipeline
  (store/pipeline.py) and the scheduler kernel (``sched_place``), so the
  harness is the end-to-end stage for the control plane: it reports
  assignments/s, proposals-per-batch, and heartbeat-RTT p99 both
  client-side and through the server histogram ladder, and publishes
  three ``swarm_bench_*`` gauges in the leader's registry.

The traffic is the JAX package's tools/soak_controlplane.py's.  Every
manager's scheduler kernel runs on the CUDA card and raises without one,
unless --device cpu (its plain version) or --no-kernel (the host
Pipeline); the soak's device wire exchanges on that device too.  Unless
--no-kernel, the load harness prints its sched_place launches (0 on the
CPU, whose plain loop launches nothing) on stderr after the JSON line.

    python -m swarmkit_tpu_torch.tools.soak_controlplane [--minutes 20] \
        [--transport inproc|device] [--device cpu]
    python -m swarmkit_tpu_torch.tools.soak_controlplane --minutes 2 \
        --agents 5000 [--active 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Optional

# the churn soak's four cycle kinds, by cycle number modulo 4
CYCLE_KINDS = ("leader_kill", "drain", "scale", "reimage")


async def soak(minutes: float, transport: str, device=None,
               stats: Optional[dict] = None) -> int:
    """The churn soak for `minutes` of wall clock on the `transport` wire
    (inproc, or device: DeviceMeshNet(seed=9, rows=8) whose exchange runs
    on `device`); every manager's scheduler kernel runs on `device` (the
    CUDA card unless the caller names another).  Returns 0, or raises on a
    wedge, a crash or a leaked task.  `stats`, when given, receives the
    cycles run by kind (`cycles`) and the largest task-record count the
    leader's store held after a cycle (`max_tasks`)."""
    from swarmkit_tpu_torch.api import NodeAvailability
    from swarmkit_tpu_torch.manager.controlapi import FailedPrecondition
    from swarmkit_tpu_torch.raft.node import ErrLostLeadership
    from swarmkit_tpu_torch.tools.integration_harness import TestCluster

    if transport == "device":
        from swarmkit_tpu_torch.transport import (
            DeviceMeshNet, DeviceMeshTransport)
        c = TestCluster(network=DeviceMeshNet(seed=9, rows=8, device=device),
                        transport_factory=DeviceMeshTransport, device=device)
    else:
        c = TestCluster(seed=9, device=device)
    st = {} if stats is None else stats
    st.update(cycles={k: 0 for k in CYCLE_KINDS}, max_tasks=0)
    deadline = time.time() + minutes * 60
    cycles = 0
    try:
        await c.add_manager("m1")
        await c.add_manager("m2")
        await c.add_manager("m3")
        await c.add_agent("a1")
        await c.add_agent("a2")
        await c.poll_cluster_ready(managers=3, workers=2)
        svc = await c.create_service("soak", replicas=4)

        async def wait_running(want: int, timeout: float = 60.0,
                               pred=None, why: str = "") -> None:
            """Converge to `want` RUNNING tasks (the harness's notion of
            running), all additionally satisfying `pred` — the drain and
            rolling-update phases pass a predicate so the OLD task set
            cannot satisfy the wait before the orchestrator reacts."""
            await c.wait_leader()
            t0 = time.time()
            while time.time() - t0 < timeout:
                ts = [t for t in c.running_tasks(svc.id)
                      if pred is None or pred(t)]
                if len(ts) == want:
                    return
                await asyncio.sleep(0.1)
                await c.wait_leader()
            raise AssertionError(
                f"cycle {cycles}: never reached {want} running {why}")

        async def retry_update(fetch, update, mutate, what: str) -> None:
            """Read-modify-write with conflict retry: dispatcher
            heartbeat/status write-backs bump object versions
            concurrently, so out-of-sequence is an expected race the
            operator (here: the soak) retries — reference semantics.
            `fetch(lead)` returns the current object; `update(lead,
            spec, version)` awaits the write."""
            for _ in range(50):
                lead = await c.wait_leader()
                cur = fetch(lead)
                spec = cur.spec.copy()
                mutate(spec)
                try:
                    await update(lead, spec, cur.meta.version.index)
                    return
                except FailedPrecondition:
                    await asyncio.sleep(0.05)
                except ErrLostLeadership:
                    # a concurrent leader kill (phase 0 of an adjacent
                    # cycle, or CheckQuorum) raced the write: a real
                    # client re-resolves the leader and retries — so
                    # does the soak
                    await asyncio.sleep(0.1)
            raise AssertionError(
                f"cycle {cycles}: {what} update never won the race")

        async def update_node_retry(node_id: str, mutate) -> None:
            await retry_update(
                lambda lead: lead.store.get("node", node_id),
                lambda lead, spec, ver: lead.control_api.update_node(
                    node_id, spec, version=ver),
                mutate, f"node {node_id}")

        async def update_service_retry(mutate) -> None:
            await retry_update(
                lambda lead: lead.control_api.get_service(svc.id),
                lambda lead, spec, ver: lead.control_api.update_service(
                    svc.id, spec, version=ver),
                mutate, "service")

        await wait_running(4)
        while time.time() < deadline:
            cycles += 1
            phase = cycles % 4
            if phase == 0:
                # kill + restart the leader
                victim = (await c.wait_leader()).node_id
                await c.stop_node(victim)
                await c.wait_leader(timeout=60)
                await wait_running(4)
                await c.restart_node(victim)
                await c.wait_leader(timeout=60)
            elif phase == 1:
                # drain one agent, wait for re-placement, reactivate
                def _drain(spec):
                    spec.availability = NodeAvailability.DRAIN

                def _activate(spec):
                    spec.availability = NodeAvailability.ACTIVE

                await update_node_retry("a1", _drain)
                await wait_running(4, pred=lambda t: t.node_id != "a1",
                                   why="off the drained node")
                await update_node_retry("a1", _activate)
            elif phase == 2:
                # scale up then back down
                def _scale7(spec):
                    spec.replicated.replicas = 7

                def _scale4(spec):
                    spec.replicated.replicas = 4

                await update_service_retry(_scale7)
                await wait_running(7)
                await update_service_retry(_scale4)
                await wait_running(4)
            else:
                # rolling update to a fresh image
                img = f"img-{cycles}"

                def _reimage(spec):
                    spec.task.container.image = img

                await update_service_retry(_reimage)
                await wait_running(
                    4, pred=lambda t: t.spec.container.image == img,
                    why=f"on updated image {img}")
            st["cycles"][CYCLE_KINDS[phase]] += 1
            lead = await c.wait_leader()
            n_tasks = len(lead.store.find("task"))
            st["max_tasks"] = max(st["max_tasks"], n_tasks)
            if cycles % 5 == 0:
                print(f"[{time.strftime('%H:%M:%S')}] cycle {cycles} ok "
                      f"({n_tasks} task records)", flush=True)
                # leak guard: the reaper must keep history bounded
                assert n_tasks < 4 * 10 + 40, \
                    f"task records leaking: {n_tasks}"
        print(f"SOAK OK: {cycles} cycles on {transport} transport")
        return 0
    finally:
        await c.stop_all()


# ---------------------------------------------------------------------------
# gRPC agent-session load harness (--agents N)

def _pct(sorted_vals: list, p: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(p * len(sorted_vals)))]


def _hist_quantile(fam, q: float) -> float:
    """Interpolated quantile from a label-less catalog histogram child —
    the histogram ladder's read-out (upper-edge interpolation, +Inf bucket
    reported as the top finite edge)."""
    child = fam._default()
    if child.count == 0:
        return 0.0
    target = q * child.count
    seen = 0
    lo = 0.0
    for i, n in enumerate(child.counts):
        if n == 0:
            continue
        hi = (child.buckets[i] if i < len(child.buckets)
              else child.buckets[-1])
        if seen + n >= target:
            frac = (target - seen) / n
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += n
        lo = hi
    return lo


class _LoadStats:
    def __init__(self) -> None:
        self.heartbeats = 0
        self.hb_errors = 0
        self.rtt: list[float] = []
        self.assignments = 0
        self.statuses = 0
        self.churns = 0
        self.registrations = 0


class _SimAgent:
    """One simulated agent: register via the Session stream, heartbeat on
    a timer (client-timed RTT), optionally consume Assignments and write
    statuses back.  The session STREAM is closed after the first message
    — the registration sticks and heartbeats keep the TTL alive — so N
    agents cost N heartbeat timers, not N live node-event watchers."""

    def __init__(self, idx: int, node_id: str, desc, stats: _LoadStats,
                 dial, hb_interval: float, active: bool) -> None:
        self.idx = idx
        self.node_id = node_id
        self.desc = desc
        self.stats = stats
        self.dial = dial          # dial(idx) -> RemoteDispatcher (leader)
        self.hb = hb_interval
        self.active = active
        self.disp = None
        self.session_id = ""
        self.alive = False
        self.reported: dict[str, str] = {}

    async def register(self) -> None:
        from swarmkit_tpu_torch.rpc import NotLeader

        delay = 0.1
        for _ in range(12):
            disp = self.dial(self.idx)
            gen = disp.session(self.node_id, self.desc, "", addr="")
            try:
                msg = await gen.__anext__()
                self.session_id = msg.session_id
                self.disp = disp
                self.alive = True
                self.stats.registrations += 1
                return
            except (NotLeader, Exception):
                await asyncio.sleep(delay)
                delay = min(2.0, delay * 2)
            finally:
                await gen.aclose()
        raise RuntimeError(f"{self.node_id}: registration never succeeded")

    async def heartbeat_loop(self, stop: asyncio.Event) -> None:
        import random as _random
        rng = _random.Random(self.idx)
        await asyncio.sleep(rng.uniform(0, self.hb))  # desynchronize
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                await self.disp.heartbeat(self.node_id, self.session_id)
                self.stats.rtt.append(time.perf_counter() - t0)
                self.stats.heartbeats += 1
                self.alive = True
            except Exception:
                self.stats.hb_errors += 1
                self.alive = False
                try:
                    await self.register()
                except Exception:
                    pass
            try:
                await asyncio.wait_for(
                    stop.wait(), self.hb * rng.uniform(0.8, 1.2))
            except asyncio.TimeoutError:
                pass

    async def assignments_loop(self, stop: asyncio.Event) -> None:
        from swarmkit_tpu_torch.api import TaskState, TaskStatus
        from swarmkit_tpu_torch.api.dispatcher_msgs import AssignmentAction

        while not stop.is_set():
            try:
                async for am in self.disp.assignments(self.node_id,
                                                      self.session_id):
                    updates = []
                    for ch in am.changes:
                        t = ch.assignment.task
                        if t is None:
                            continue
                        if ch.action == AssignmentAction.REMOVE:
                            self.reported.pop(t.id, None)
                            continue
                        if t.desired_state >= TaskState.SHUTDOWN:
                            if self.reported.get(t.id) != "down":
                                self.reported[t.id] = "down"
                                updates.append((t.id, TaskStatus(
                                    state=TaskState.SHUTDOWN,
                                    message="sim-agent")))
                        elif t.id not in self.reported:
                            self.reported[t.id] = "up"
                            self.stats.assignments += 1
                            updates.append((t.id, TaskStatus(
                                state=TaskState.RUNNING,
                                message="sim-agent")))
                    if updates:
                        await self.disp.update_task_status(
                            self.node_id, self.session_id, updates)
                        self.stats.statuses += len(updates)
                    if stop.is_set():
                        return
            except Exception:
                if stop.is_set():
                    return
                await asyncio.sleep(0.5)


async def load(minutes: float, agents: int, managers: int = 3,
               active: int = 0, heartbeat: float = 5.0,
               replicas: int = 0, update_every: float = 10.0,
               churn_per_s: int = 8, coalesce_window: float = 0.002,
               report_every: float = 15.0, use_kernel: bool = True,
               sustain_floor: float = 0.0, device=None) -> dict:
    """Drive `agents` simulated sessions over real sockets for `minutes`.
    Returns the summary dict (also printed as JSON by the CLI).  With
    `use_kernel` each manager's scheduler places a group through
    ``sched_place`` on `device` (the CUDA card unless the caller names
    another; "cpu" runs its plain version); without it, through the host
    ``Pipeline``."""
    import socket
    import tempfile

    import grpc

    from swarmkit_tpu_torch.api import (
        Annotations, ContainerSpec, MembershipState, NodeDescription,
        NodeResources, NodeSpec, Placement, Platform, ReplicatedService,
        ServiceSpec, TaskSpec, TaskState,
    )
    from swarmkit_tpu_torch.api.objects import Node as ApiNode, NodeStatus
    from swarmkit_tpu_torch.manager.controlapi import FailedPrecondition
    from swarmkit_tpu_torch.manager.manager import Manager
    from swarmkit_tpu_torch.metrics import catalog as obs_catalog
    from swarmkit_tpu_torch.raft.grpc_transport import GrpcNetwork
    from swarmkit_tpu_torch.raft.node import ErrLostLeadership
    from swarmkit_tpu_torch.rpc import ClusterService, RemoteDispatcher
    from swarmkit_tpu_torch.store.pipeline import CoalesceConfig

    active = min(agents, active or max(32, min(256, agents // 4)))
    # the reference harness's ceiling: its one-transaction reconciles
    # refuse more than 200 changes; the port batches its writes, but the
    # traffic stays the same
    replicas = replicas or min(2 * active, 192)
    # everything — 3 managers, the raft wire, and every simulated agent —
    # shares ONE Python event loop, so the aggregate heartbeat rate is
    # the scaling ceiling: stretch the interval to keep it near 400/s
    # (5k agents -> 12.5s, 10k -> 25s; an explicit larger value wins)
    heartbeat = max(heartbeat, agents / 400.0)

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    net = GrpcNetwork()
    tmp = tempfile.TemporaryDirectory(prefix="swarm-load-")
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(managers)]
    mgrs: list[Manager] = []
    stats = _LoadStats()
    stop = asyncio.Event()
    channels: dict[str, list] = {}
    pool = max(2, min(32, agents // 256))
    sims: list[_SimAgent] = []
    bg: list[asyncio.Task] = []
    try:
        for i, addr in enumerate(addrs):
            # a registration/heartbeat burst can stall the shared loop for
            # seconds; a 10s election timeout rides it out instead of
            # cascading into elections + wedge-triggered transfers
            m = Manager(node_id=f"m{i}", addr=addr, network=net,
                        state_dir=f"{tmp.name}/m{i}",
                        join_addr=addrs[0] if i else "",
                        tick_interval=0.25, election_tick=40, seed=70 + i,
                        sched_use_kernel=use_kernel, device=device)
            m.store.set_coalescing(CoalesceConfig(window=coalesce_window))

            class _Ref:
                security = None

                def __init__(self, mgr):
                    self._mgr = mgr

                def _running_manager(self):
                    return self._mgr

            net.add_service(addr, ClusterService(
                lambda ref=_Ref(m): ref).handlers())
            await m.start()
            mgrs.append(m)
            if i == 0:
                while not m.is_leader():
                    await asyncio.sleep(0.02)

        def leader() -> Manager:
            for m in mgrs:
                if m.is_leader():
                    return m
            return mgrs[0]

        def dial(idx: int) -> RemoteDispatcher:
            addr = leader().addr
            chans = channels.setdefault(addr, [])
            while len(chans) < pool:
                chans.append(grpc.aio.insecure_channel(addr, options=[
                    ("grpc.max_send_message_length", 64 << 20),
                    ("grpc.max_receive_message_length", 64 << 20)]))
            return RemoteDispatcher(chans[idx % pool])

        # -- node records (the hot `active` subset is labeled for
        #    placement; everything else sustains sessions + heartbeats) --
        lead = leader()
        t_setup = time.perf_counter()

        # the dispatcher TTL is 3x ITS period (the cluster spec), not the
        # client's timer — align them or a slow ramp expires early
        # registrations before their first heartbeat
        if heartbeat > 5.0:
            def _set_period(tx):
                cl = tx.find("cluster")[0]
                cl.spec.dispatcher.heartbeat_period = heartbeat
                tx.update(cl)
            await lead.store.update(_set_period)

        async def mknode(i: int) -> None:
            pool_lbl = "hot" if i < active else "cold"
            for _ in range(10):
                try:
                    await leader().store.update(lambda tx: tx.create(ApiNode(
                        id=f"ld{i}",
                        spec=NodeSpec(
                            annotations=Annotations(name=f"ld{i}",
                                                    labels={"pool": pool_lbl}),
                            membership=MembershipState.ACCEPTED),
                        status=NodeStatus())))
                    return
                except Exception:
                    await asyncio.sleep(0.2)

        for base in range(0, agents, 512):
            await asyncio.gather(*(mknode(i)
                                   for i in range(base,
                                                  min(base + 512, agents))))
        setup_nodes_s = time.perf_counter() - t_setup

        for i in range(agents):
            desc = NodeDescription(
                hostname=f"ld{i}",
                platform=Platform(architecture="x86_64", os="linux"),
                resources=NodeResources(nano_cpus=4_000_000_000,
                                        memory_bytes=8 << 30))
            sims.append(_SimAgent(i, f"ld{i}", desc, stats, dial,
                                  heartbeat, active=i < active))

        # hot agents first (their nodes must be READY before the service
        # lands), then ramp the cold fleet in waves
        t_ramp = time.perf_counter()
        for base in range(0, active, 128):
            wave = sims[base:base + 128]
            await asyncio.gather(*(s.register() for s in wave))
            # heartbeats start per-wave so early registrations never
            # outlive the TTL while later waves are still ramping
            for s in wave:
                bg.append(asyncio.create_task(s.heartbeat_loop(stop)))
        streams = [asyncio.create_task(s.assignments_loop(stop))
                   for s in sims[:active]]
        bg += streams

        svc = await lead.control_api.create_service(ServiceSpec(
            annotations=Annotations(name="load"),
            task=TaskSpec(container=ContainerSpec(image="img-0"),
                          placement=Placement(
                              constraints=["node.labels.pool==hot"])),
            replicated=ReplicatedService(replicas=replicas)))

        for base in range(active, agents, 256):
            wave = sims[base:base + 256]
            await asyncio.gather(*(s.register() for s in wave))
            for s in wave:
                bg.append(asyncio.create_task(s.heartbeat_loop(stop)))
            await asyncio.sleep(0)
        ramp_s = time.perf_counter() - t_ramp

        # -- workload: scale between replicas and replicas//2 to keep
        #    assignments (and SHUTDOWN acks) flowing ----------------------
        async def scale_to(n: int) -> None:
            for _ in range(50):
                ld = leader()
                try:
                    cur = ld.control_api.get_service(svc.id)
                    spec = cur.spec.copy()
                    spec.replicated.replicas = n
                    await ld.control_api.update_service(
                        svc.id, spec, version=cur.meta.version.index)
                    return
                except (FailedPrecondition, ErrLostLeadership, Exception):
                    await asyncio.sleep(0.1)

        async def workload() -> None:
            hi, lo = replicas, max(1, replicas // 2)
            cur = hi
            while not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), update_every)
                    return
                except asyncio.TimeoutError:
                    pass
                cur = lo if cur == hi else hi
                await scale_to(cur)

        async def churn() -> None:
            # round-robin re-registration across the cold fleet; the
            # cycle length keeps any node under the dispatcher's
            # 3-per-8s rate limit
            cold = sims[active:] or sims
            i = 0
            k = max(1, min(churn_per_s, len(cold) // 16 or 1))
            while not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), 1.0)
                    return
                except asyncio.TimeoutError:
                    pass
                batch = [cold[(i + j) % len(cold)] for j in range(k)]
                i += k
                for s in batch:
                    try:
                        await s.register()
                        stats.churns += 1
                    except Exception:
                        pass

        async def reporter() -> None:
            last_hb = last_as = 0
            while not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), report_every)
                    return
                except asyncio.TimeoutError:
                    pass
                ld = leader()
                packed = obs_catalog.get(
                    ld.obs, "swarm_cpl_proposals_total").labels(
                    outcome="committed").value
                txns = obs_catalog.get(
                    ld.obs, "swarm_cpl_txns_total").labels(
                    outcome="committed").value
                rtt = sorted(stats.rtt[-20000:])
                print(f"[{time.strftime('%H:%M:%S')}] "
                      f"hb/s={(stats.heartbeats - last_hb) / report_every:.0f} "
                      f"rtt_p99={_pct(rtt, 0.99) * 1e3:.1f}ms "
                      f"assign/s={(stats.assignments - last_as) / report_every:.1f} "
                      f"entries/proposal="
                      f"{txns / packed if packed else 1.0:.1f} "
                      f"alive={sum(s.alive for s in sims)}/{agents} "
                      f"churns={stats.churns}", flush=True)
                last_hb, last_as = stats.heartbeats, stats.assignments

        bg += [asyncio.create_task(workload()),
               asyncio.create_task(churn()),
               asyncio.create_task(reporter())]

        t0 = time.perf_counter()
        await asyncio.sleep(minutes * 60)
        elapsed = time.perf_counter() - t0
        sustained = sum(s.alive for s in sims)
        stop.set()
        # a hot agent's Assignments stream sees `stop` only when its next
        # message comes, which at 10,000 agents can take minutes: end the
        # streams with the window (the JAX tool waits for that message and
        # counts what it carries)
        for task in streams:
            task.cancel()
        await asyncio.gather(*bg, return_exceptions=True)
        bg.clear()

        lead = leader()
        rtt = sorted(stats.rtt)
        packed = obs_catalog.get(lead.obs, "swarm_cpl_proposals_total") \
            .labels(outcome="committed").value
        txns = obs_catalog.get(lead.obs, "swarm_cpl_txns_total") \
            .labels(outcome="committed").value
        server_p99 = _hist_quantile(obs_catalog.get(
            lead.obs, "swarm_dispatcher_heartbeat_rtt_seconds"), 0.99)
        kernel_groups = obs_catalog.get(
            lead.obs, "swarm_sched_kernel_groups_total") \
            .labels(path="kernel").value
        result = {
            "agents": agents, "active": active, "managers": managers,
            "minutes": round(elapsed / 60, 2),
            "replicas": replicas,
            "setup_nodes_s": round(setup_nodes_s, 2),
            "ramp_s": round(ramp_s, 2),
            "heartbeats": stats.heartbeats,
            "heartbeats_per_s": round(stats.heartbeats / elapsed, 1),
            "hb_errors": stats.hb_errors,
            "rtt_p50_ms": round(_pct(rtt, 0.5) * 1e3, 2),
            "rtt_p99_ms": round(_pct(rtt, 0.99) * 1e3, 2),
            "server_rtt_p99_ms": round(server_p99 * 1e3, 2),
            "assignments": stats.assignments,
            "assignments_per_s": round(stats.assignments / elapsed, 2),
            "status_writes": stats.statuses,
            "entries_per_proposal": round(txns / packed, 2)
            if packed else 1.0,
            "kernel_groups": int(kernel_groups),
            "churns": stats.churns,
            "agents_sustained": sustained,
        }
        # publish the headline series through the telemetry registry so
        # bench_gate / scrapers see the same numbers the CLI prints
        cfg = f"grpc-{agents}"
        obs_catalog.get(lead.obs, "swarm_bench_assignments_per_second") \
            .labels(config=cfg).set(result["assignments_per_s"])
        obs_catalog.get(lead.obs, "swarm_bench_agents_sustained") \
            .labels(config=cfg).set(sustained)
        obs_catalog.get(lead.obs, "swarm_bench_heartbeat_rtt_p99_seconds") \
            .labels(config=cfg).set(_pct(rtt, 0.99))
        if sustain_floor and sustained < sustain_floor * agents:
            result["error"] = (f"only {sustained}/{agents} agents alive at "
                               f"deadline (floor {sustain_floor})")
        return result
    finally:
        stop.set()
        for t in bg:
            t.cancel()
        if bg:
            await asyncio.gather(*bg, return_exceptions=True)
        for chans in channels.values():
            for ch in chans:
                await ch.close()
        for m in mgrs:
            try:
                await m.stop()
            except Exception:
                pass
        await net.close()
        # let grpc.aio's poller thread drain its completion queue before
        # asyncio.run() closes the loop (as fault_sweep's grpc wire does)
        await asyncio.sleep(0.2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--transport", choices=["inproc", "device"],
                    default="inproc")
    ap.add_argument("--agents", type=int, default=0,
                    help="run the gRPC load harness with N simulated "
                         "agent sessions instead of the churn soak")
    ap.add_argument("--active", type=int, default=0,
                    help="hot subset consuming assignments streams "
                         "(default: agents/4 clamped to [32, 256])")
    ap.add_argument("--managers", type=int, default=3)
    ap.add_argument("--heartbeat", type=float, default=5.0,
                    help="agent heartbeat interval seconds")
    ap.add_argument("--replicas", type=int, default=0,
                    help="service scale ceiling (default 2x active)")
    ap.add_argument("--update-every", type=float, default=10.0,
                    help="seconds between service scale flips")
    ap.add_argument("--churn", type=int, default=8,
                    help="cold-agent re-registrations per second")
    ap.add_argument("--coalesce-window", type=float, default=0.002)
    ap.add_argument("--report-every", type=float, default=15.0)
    ap.add_argument("--no-kernel", action="store_true",
                    help="schedule on the host Pipeline instead of the "
                         "sched_place kernel")
    ap.add_argument("--sustain-floor", type=float, default=0.0,
                    help="fail unless this fraction of agents is alive "
                         "at the deadline (e.g. 0.99)")
    ap.add_argument("--device", default=None,
                    help="where the scheduler kernel runs (default: the "
                         "CUDA card; 'cpu' for its plain version)")
    args = ap.parse_args(argv)
    if args.agents > 0:
        result = asyncio.run(load(
            args.minutes, args.agents, managers=args.managers,
            active=args.active, heartbeat=args.heartbeat,
            replicas=args.replicas, update_every=args.update_every,
            churn_per_s=args.churn, coalesce_window=args.coalesce_window,
            report_every=args.report_every, use_kernel=not args.no_kernel,
            sustain_floor=args.sustain_floor, device=args.device))
        json.dump(result, sys.stdout)
        sys.stdout.write("\n")
        sys.stdout.flush()
        if not args.no_kernel:
            from swarmkit_tpu_torch.parallel import cuda_ops
            print(f"sched_place launches: {cuda_ops.LAUNCHES['sched_place']}",
                  file=sys.stderr, flush=True)
        return 1 if "error" in result else 0
    return asyncio.run(soak(args.minutes, args.transport, device=args.device))


if __name__ == "__main__":
    raise SystemExit(main())
