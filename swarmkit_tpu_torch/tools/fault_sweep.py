"""Fault-injection sweep on the port: every fault primitive on every raft
wire, and the same vocabulary on the DST tick.

For each (wire, fault plan, seed) triple the host-wire sweep boots a
3-node cluster of the raft ``Node`` (raft/node.py) over its store and
drives one full robustness schedule

    converge -> commit "pre" -> inject fault -> (tolerated) commit under
    fault -> heal (+ process restart for the crash plan) -> converge ->
    commit "post" -> leader transfer -> member removal -> commit "final"

and then runs the cross-member oracle: every surviving member's store must
hold exactly the same object set, including all committed markers.  A
divergence or a liveness stall after ``heal()`` is a failure.

Wires (the three Transport implementations behind one Network seam):
  inproc   in-process asyncio Network, fake clock
  devmesh  DeviceMeshNet mailbox exchange (transport/device_mesh.py) on
           the sweep's device, fake clock
  grpc     GrpcNetwork over real sockets, system clock, active health
           probing

Plans (raft.faults.FaultPlan): down, drop, partition, delay, crash; the
crash plan also stops the victim and restarts it from its state dir after
``heal()``.  With ``--flight-dir`` every failing scenario dumps a flight
record (the tracer's finished spans and the failure's provenance).

Three device runs, each on the port's tick:

- ``--peer-chunk`` / ``--active-rows`` (the lowering precheck, run before
  the host-wire sweep): each selected fault plan is lowered to a device
  fault schedule (``raft.faults.plan_to_schedule``) and run through the
  DST tick in the requested peer-axis lowering (``SimConfig.peer_chunk``,
  banded quorum reductions) with a dense cross-check: the violation
  bitmasks, first-violation ticks and per-tick bit traces must match bit
  for bit.  ``--peer-chunk 0`` pins the dense path only.
  ``--active-rows`` does the same for the role-sparse progress lowering
  (``SimConfig.active_rows``): a nonzero A runs the [A, N] slab with a
  dense-progress cross-check, 0 pins the dense path.
- ``--attacks`` (instead of the host-wire sweep): the Byzantine-ish
  adversary scenarios (``ATTACK_SCENARIOS``).  For each attack a
  seed-pinned DST sweep must catch the named invariant bit with the
  defense off, shrink the first counterexample to a replay-exact
  artifact, hold the differential oracle in lockstep, and come back clean
  with the defense on.
- ``--storage`` (instead of the host-wire sweep): the storage-fault
  scenarios (``STORAGE_SCENARIOS``): disk truncation, torn writes,
  corrupt snapshots and fsync stalls against the tick's durability model
  (``SimConfig.fsync_lag_ticks`` / ``ack_gating``).  Trip scenarios
  follow the attack pipeline; containment scenarios must stay
  violation-free while the recovery signature code proves the fault
  actually bit.

The attack and storage verbs force device state, so each host wire gets
an explicit skip row in those runs.

    python -m swarmkit_tpu_torch.tools.fault_sweep              # 15 rows
    python -m swarmkit_tpu_torch.tools.fault_sweep --wires grpc \
        --plans crash,partition
    python -m swarmkit_tpu_torch.tools.fault_sweep --peer-chunk 8
    python -m swarmkit_tpu_torch.tools.fault_sweep --active-rows 8
    python -m swarmkit_tpu_torch.tools.fault_sweep --attacks all
    python -m swarmkit_tpu_torch.tools.fault_sweep --storage all \
        --device cpu

It runs on the CUDA card and raises without one, unless --device cpu (the
inproc and grpc wires use no device; the devmesh wire's exchange and the
device runs do).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch import dst
from swarmkit_tpu_torch.api import Annotations, Node as ApiNode, NodeSpec
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.metrics.registry import MetricsRegistry
from swarmkit_tpu_torch.raft.faults import FaultPlan
from swarmkit_tpu_torch.raft.node import Node, NodeOpts
from swarmkit_tpu_torch.raft.sim.state import SimConfig, init_state
from swarmkit_tpu_torch.raft.transport import Network
from swarmkit_tpu_torch.tools import _cli_common
from swarmkit_tpu_torch.utils.clock import FakeClock, SystemClock

WIRES = ("inproc", "devmesh", "grpc")
PLANS = ("down", "drop", "partition", "delay", "crash")
DEFAULT_SEEDS = (2009343,)

# Byzantine-ish adversary scenarios (--attacks): each row pins the
# defense-off / defense-on SimConfig deltas, the invariant bit that
# witnesses the attack, and the schedule shape validated end-to-end by
# the DST pipeline (catch -> shrink -> artifact -> replay -> oracle).
# These run on the DEVICE wire only — the verbs are FaultSchedule leaves
# that force kernel state arrays (vote registers, election timers,
# transfer requests) between ticks, and the three host wires expose no
# equivalent state-injection seam on a live Node — so the sweep emits an
# explicit per-wire skip row for inproc/devmesh/grpc instead of
# silently narrowing coverage.
ATTACK_SCENARIOS = {
    "disruptive_rejoin": dict(
        off=dict(pre_vote=False, check_quorum=False,
                 collect_telemetry=True, slo_leader_changes=2),
        on=dict(pre_vote=True, check_quorum=True,
                collect_telemetry=True, slo_leader_changes=2),
        ticks=120, prop_count=2, bit="slo_leader_churn",
        defense="PreVote + CheckQuorum"),
    "vote_equivocation": dict(
        # check_quorum off on BOTH sides: the lease refuses the rival's
        # re-requests for the unrelated reason of fresh leader contact,
        # which would mask the vote-guard hole under test
        off=dict(check_quorum=False),
        on=dict(check_quorum=False, vote_guard=True),
        ticks=40, prop_count=2, bit="election_safety",
        defense="persisted-vote guard"),
    "append_flood": dict(
        off=dict(slo_log_occupancy=24),
        on=dict(slo_log_occupancy=24, prop_inflight_cap=8),
        ticks=120, prop_count=0, bit="slo_log_occupancy",
        defense="per-row inflight cap"),
    "transfer_abuse": dict(
        off=dict(collect_telemetry=True, slo_leader_changes=8),
        on=dict(collect_telemetry=True, slo_leader_changes=8,
                transfer_cooldown_ticks=60),
        ticks=120, prop_count=2, bit="slo_leader_churn",
        defense="transfer cooldown"),
}

ATTACK_WIRE_SKIP = (
    "attack verbs force kernel state arrays between ticks; host Node "
    "wires have no state-injection seam (device-only by design)")

# Storage-fault scenarios (--storage): the durability boundary of the
# explicit per-row storage model (SimConfig.fsync_lag_ticks arms the
# sync_mark watermark, SimConfig.ack_gating pins acks/votes/commit to
# it).  Two shapes:
#   mode="trip":    defense-off must CATCH the named invariant bit, the
#                   first counterexample shrinks to a replay-exact
#                   artifact, defense-on is clean on the SAME schedules
#                   (the attack-sweep pipeline).
#   mode="contain": the fault must be ABSORBED — the gated config stays
#                   violation-free while the recovery signature code
#                   (STORAGE_SIGNATURE_CODES) proves the verb actually
#                   fired and was repaired, not silently skipped.
# `oracle` picks the differential-oracle bound for trip artifacts:
#   "violation" — the bit is a SAFETY bit and the verb tick IS the
#                 violation tick, so replay_artifact's SAFETY_BITS
#                 truncation already compares exactly the clean prefix;
#   "verb"      — kernel-side divergence precedes the trip (poisoned
#                 install, stall-refused votes), so the sweep bounds its
#                 own oracle_trace at the first storage-verb tick (the
#                 host oracle models a perfect disk; see dst/repro.py).
STORAGE_SCENARIOS = {
    "lost_tail": dict(
        off=dict(fsync_lag_ticks=6),
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=120, prop_count=2, bit="durability", mode="trip",
        oracle="violation", defense="durable-watermark ack gating"),
    "torn_write": dict(
        off=None,
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=120, prop_count=2, bit=None, mode="contain",
        defense="checksummed-scan truncation + quorum re-replication"),
    "snap_corrupt": dict(
        off=dict(fsync_lag_ticks=6),
        on=dict(fsync_lag_ticks=6, ack_gating=True),
        ticks=140, prop_count=2, bit="checksum_agreement", mode="trip",
        oracle="verb", defense="pre-install snapshot checksum verify"),
    "disk_stall": dict(
        off=dict(fsync_lag_ticks=2, slo_fsync_lag=8),
        on=dict(fsync_lag_ticks=2, slo_fsync_lag=8, ack_gating=True,
                prop_inflight_cap=8),
        ticks=120, prop_count=2, bit="slo_fsync_lag", mode="trip",
        oracle="verb",
        defense="ack gating + per-row inflight cap backpressure"),
}

STORAGE_WIRE_SKIP = (
    "storage verbs rewrite kernel log/watermark registers between ticks; "
    "the host wires' real on-disk WAL is covered by the raft/storage.py "
    "truncation-parity tests instead")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------
# per-wire cluster harnesses


class _Cluster:
    """3-node raft cluster driven tick-by-tick (fake clock wires)."""

    wire = "inproc"
    TICK = 1.0
    delay_s = 2.0          # injected edge latency (spans >1 raft tick)
    MAX_STEPS = 300

    def __init__(self, seed: int, device=None) -> None:
        self.seed = seed
        self.device = device
        self.clock = self._make_clock()
        # one typed registry per cluster: scenario assertions read counters
        # that only this cluster's nodes/transports could have moved
        self.obs = MetricsRegistry()
        self.network = self._make_network(seed)
        self.nodes: dict[str, Node] = {}
        self.tmp = tempfile.TemporaryDirectory(
            prefix=f"fault-sweep-{self.wire}-")
        self._n = 0

    def counter_sum(self, name: str) -> float:
        """Total of a counter family across all of its label sets."""
        fam = self.obs.get(name)
        if fam is None:
            return 0.0
        snap = fam.snapshot()
        return (sum(snap.values()) if isinstance(snap, dict)
                else float(snap))

    # wire-specific bits --------------------------------------------------
    def _make_clock(self):
        return FakeClock()

    def _make_network(self, seed: int):
        return Network(seed=seed)

    def _addr(self, node_id: str) -> str:
        return f"{node_id}.sweep:4242"

    def _decorate_opts(self, opts: NodeOpts) -> NodeOpts:
        return opts

    async def settle(self) -> None:
        """One scheduling step: a raft tick plus delivery pumping."""
        await self.clock.advance(self.TICK)
        for _ in range(8):
            await asyncio.sleep(0)

    # cluster lifecycle ---------------------------------------------------
    def _opts(self, node_id: str, addr: str, join_addr: str = "") -> NodeOpts:
        self._n += 1
        return self._decorate_opts(NodeOpts(
            node_id=node_id,
            addr=addr,
            network=self.network,
            state_dir=os.path.join(self.tmp.name, node_id),
            clock=self.clock,
            join_addr=join_addr,
            tick_interval=self.TICK,
            election_tick=4,
            heartbeat_tick=1,
            seed=self.seed + self._n,
            obs_registry=self.obs,
        ))

    async def add_node(self, join_from: Optional[Node] = None) -> Node:
        node_id = f"node-{len(self.nodes) + 1}"
        addr = self._addr(node_id)
        join_addr = join_from.addr if join_from is not None else ""
        node = Node(self._opts(node_id, addr, join_addr=join_addr))
        self.nodes[node_id] = node
        await node.start()
        await asyncio.sleep(0)
        return node

    async def stop_node(self, node: Node) -> None:
        await node.stop()
        self.network.unregister(node.addr)

    async def restart_node(self, node: Node) -> Node:
        """Fresh Node object over the same state dir and address."""
        opts = self._opts(node.node_id, node.addr)
        opts.seed = node.opts.seed
        new = Node(opts)
        self.nodes[node.node_id] = new
        await new.start()
        await asyncio.sleep(0)
        return new

    # waiting -------------------------------------------------------------
    def leader(self) -> Optional[Node]:
        leaders = [n for n in self.nodes.values()
                   if n.running and n.is_leader()]
        return leaders[0] if leaders else None

    async def wait_for(self, pred, what: str, max_steps: int = 0) -> None:
        for _ in range(max_steps or self.MAX_STEPS):
            if pred():
                return
            await self.settle()
        raise TimeoutError(f"[{self.wire}] timed out waiting for {what}")

    async def wait_for_cluster(self) -> Node:
        """One leader; every running member on its term and applied up to
        its commit."""
        def converged() -> bool:
            lead = self.leader()
            if lead is None:
                return False
            members = [n for n in self.nodes.values() if n.running]
            lt = lead._raw.raft.term
            lc = lead._raw.raft.log.committed
            return all(n._raw is not None
                       and n._raw.raft.term == lt
                       and n._raw.raft.log.applied >= lc
                       for n in members)
        await self.wait_for(converged, "cluster convergence")
        return self.leader()

    async def close(self) -> None:
        for n in list(self.nodes.values()):
            if n.running:
                try:
                    await n.stop()
                except Exception:
                    pass
        closer = getattr(self.network, "close", None)
        if closer is not None:
            r = closer()
            if asyncio.iscoroutine(r):
                await r
        self.tmp.cleanup()


class _DeviceMeshCluster(_Cluster):
    """The mailbox wire: DeviceMeshNet(rows=8), its exchange on the
    sweep's device (the CUDA card unless the caller names another)."""

    wire = "devmesh"

    def _make_network(self, seed: int):
        from swarmkit_tpu_torch.transport import DeviceMeshNet

        return DeviceMeshNet(seed=seed, rows=8, obs=self.obs,
                             device=self.device)

    def _decorate_opts(self, opts: NodeOpts) -> NodeOpts:
        from swarmkit_tpu_torch.transport import DeviceMeshTransport

        opts.transport_factory = DeviceMeshTransport
        return opts


class _GrpcCluster(_Cluster):
    wire = "grpc"
    TICK = 0.05            # real seconds per settle step
    delay_s = 0.2
    MAX_STEPS = 600        # 30s wall-clock ceiling per wait

    def _make_clock(self):
        return SystemClock()

    def _make_network(self, seed: int):
        from swarmkit_tpu_torch.raft.grpc_transport import GrpcNetwork

        return GrpcNetwork(seed=seed, probe_interval=0.1, probe_timeout=0.5,
                           failure_threshold=2, grace_period=0.2,
                           redial_backoff=0.05, redial_backoff_max=0.4,
                           obs=self.obs)

    def _addr(self, node_id: str) -> str:
        return f"127.0.0.1:{_free_port()}"

    async def settle(self) -> None:
        await asyncio.sleep(self.TICK)

    async def close(self) -> None:
        await super().close()
        # let grpc.aio's poller thread drain its completion queue before
        # asyncio.run() closes the loop, or it logs spurious
        # "Event loop is closed" callbacks during teardown
        await asyncio.sleep(0.2)


_CLUSTERS = {
    "inproc": _Cluster,
    "devmesh": _DeviceMeshCluster,
    "grpc": _GrpcCluster,
}


# --------------------------------------------------------------------------
# schedule pieces


def _marker(i: int, tag: str) -> ApiNode:
    return ApiNode(id=f"mark-{tag}",
                   spec=NodeSpec(annotations=Annotations(name=tag)))


async def _commit(node: Node, tag: str) -> None:
    await node.store.update(lambda tx: tx.create(_marker(0, tag)))


def _has(node: Node, tag: str) -> bool:
    return node.store.get("node", f"mark-{tag}") is not None


async def _commit_while_stepping(h: _Cluster, lead: Node, tag: str,
                                 max_steps: int = 120) -> bool:
    """Propose from the leader while the harness keeps ticking (lost
    messages are only retried on heartbeats, which need clock advancement
    on the fake-clock wires).  Under an injected fault the commit MAY time
    out — the sweep only demands liveness after heal()."""
    task = asyncio.ensure_future(_commit(lead, tag))
    for _ in range(max_steps):
        if task.done():
            break
        await h.settle()
    if not task.done():
        task.cancel()
    try:
        await task
        return True
    except Exception:
        return False


def _build_plan(name: str, h: _Cluster, lead: Node, victim: Node
                ) -> FaultPlan:
    others = [n.addr for n in h.nodes.values()
              if n.running and n.addr != victim.addr]
    if name == "down":
        return FaultPlan.down(victim.addr)
    if name == "drop":
        return FaultPlan.drop(lead.addr, victim.addr, p=0.6)
    if name == "partition":
        return FaultPlan.split([victim.addr], others)
    if name == "delay":
        return FaultPlan.delay(lead.addr, victim.addr, h.delay_s)
    if name == "crash":
        return FaultPlan.crash(victim.addr)
    raise ValueError(f"unknown fault plan {name!r}")


# --------------------------------------------------------------------------
# one scenario


async def _run_scenario(wire: str, plan_name: str, seed: int,
                        device=None, stats: Optional[dict] = None) -> dict:
    h = _CLUSTERS[wire](seed, device)
    tag = f"{wire}-{plan_name}-{seed}"
    notes: list[str] = []
    try:
        n1 = await h.add_node()
        await h.wait_for(lambda: h.leader() is not None, "first leader")
        await h.add_node(join_from=n1)
        await h.add_node(join_from=n1)
        lead = await h.wait_for_cluster()

        await _commit_while_stepping(h, lead, f"pre-{tag}")
        await h.wait_for(
            lambda: all(_has(n, f"pre-{tag}")
                        for n in h.nodes.values() if n.running),
            "pre-marker replication")

        # -- inject -------------------------------------------------------
        lead = h.leader()
        victim = next(n for n in sorted(h.nodes.values(),
                                        key=lambda n: n.node_id)
                      if n.running and n.raft_id != lead.raft_id)
        # counter baselines: the fault window must be VISIBLE in the typed
        # registry, not just survivable (see metrics assertion post-heal)
        campaigns_before = h.counter_sum("swarm_raft_elections_started_total")
        flips_before = h.counter_sum(
            "swarm_transport_probe_transitions_total")
        plan = _build_plan(plan_name, h, lead, victim)
        plan.inject(h.network)
        if plan_name == "crash":
            # the crash plan is a real process death, not just wire state
            await h.stop_node(victim)

        committed = await _commit_while_stepping(h, lead, f"mid-{tag}")
        notes.append(f"commit under fault: "
                     f"{'ok' if committed else 'timed out (tolerated)'}")

        # -- metrics oracle: the fault must be VISIBLE, not just survived --
        # Hold the partition open until the isolated victim's election
        # timeout fires (the majority commits fast, so the mid-commit alone
        # may not span a timeout) and, on the probing wire, until the
        # health prober flips the victim's state down.
        if plan_name == "partition":
            await h.wait_for(
                lambda: h.counter_sum("swarm_raft_elections_started_total")
                > campaigns_before,
                "partition to register in the campaign counter")
            notes.append(
                f"campaigns {campaigns_before:.0f} -> "
                f"{h.counter_sum('swarm_raft_elections_started_total'):.0f}")
            if wire == "grpc":
                await h.wait_for(
                    lambda: h.counter_sum(
                        "swarm_transport_probe_transitions_total")
                    > flips_before,
                    "partition to flip a prober state")
                notes.append(
                    f"probe flips {flips_before:.0f} -> "
                    f"{h.counter_sum('swarm_transport_probe_transitions_total'):.0f}")

        # -- heal + liveness ----------------------------------------------
        plan.heal(h.network)
        if plan_name == "crash":
            victim = await h.restart_node(victim)
        lead = await h.wait_for_cluster()

        await _commit_while_stepping(h, lead, f"post-{tag}")
        await h.wait_for(
            lambda: all(_has(n, f"post-{tag}")
                        for n in h.nodes.values() if n.running),
            "post-heal replication (liveness)")

        # -- leader transfer ----------------------------------------------
        old_rid = lead.raft_id
        await lead.transfer_leadership()
        await h.wait_for(
            lambda: h.leader() is not None
            and h.leader().raft_id != old_rid,
            "leadership transfer")
        lead = await h.wait_for_cluster()
        notes.append(f"leader moved {old_rid:x} -> {lead.raft_id:x}")

        # -- member removal: drop the non-victim follower so the final
        # commit can only succeed with the recovered victim's ack ---------
        candidates = [rid for rid, m in lead.cluster.members.items()
                      if rid != lead.raft_id and m.addr != victim.addr]
        if not candidates:   # the victim became leader: remove any follower
            candidates = [rid for rid in lead.cluster.members
                          if rid != lead.raft_id]
        removed_rid = candidates[0]
        removed_addr = lead.cluster.members[removed_rid].addr
        removal = asyncio.ensure_future(lead.remove_member(removed_rid))
        await h.wait_for(lambda: removal.done(), "member removal")
        removal.result()
        gone = next(n for n in h.nodes.values() if n.addr == removed_addr)
        await h.stop_node(gone)
        notes.append(f"removed member {removed_rid:x} ({removed_addr})")

        lead = await h.wait_for_cluster()
        await _commit_while_stepping(h, lead, f"final-{tag}")
        await h.wait_for(
            lambda: all(_has(n, f"final-{tag}")
                        for n in h.nodes.values() if n.running),
            "final replication after removal")

        # -- differential oracle: surviving stores must agree -------------
        survivors = [n for n in h.nodes.values() if n.running]
        contents = {n.node_id: sorted(o.id for o in n.store.find("node"))
                    for n in survivors}
        baseline = next(iter(contents.values()))
        diverged = {nid: ids for nid, ids in contents.items()
                    if ids != baseline}
        if diverged:
            raise AssertionError(
                f"store divergence across members: {contents}")
        for phase in ("pre", "post", "final"):
            if f"mark-{phase}-{tag}" not in baseline:
                raise AssertionError(f"{phase} marker missing: {baseline}")
        return {"wire": wire, "plan": plan_name, "seed": seed, "ok": True,
                "notes": "; ".join(notes)}
    except Exception as e:
        return {"wire": wire, "plan": plan_name, "seed": seed, "ok": False,
                "notes": "; ".join(notes), "error": f"{type(e).__name__}: {e}"}
    finally:
        if stats is not None:
            stats.update(
                flushes=h.counter_sum("swarm_transport_device_flushes_total"),
                messages=h.counter_sum(
                    "swarm_transport_device_messages_total"))
        await h.close()


# --------------------------------------------------------------------------
# device-side precheck: the same fault vocabulary in a chosen peer lowering


def _device_plan(name: str, addrs: list[str]) -> FaultPlan:
    """The host sweep's plan shapes rebuilt over synthetic tick rows."""
    lead, victim = addrs[0], addrs[1]
    if name == "down":
        return FaultPlan.down(victim)
    if name == "drop":
        return FaultPlan.drop(lead, victim, p=0.6)
    if name == "partition":
        return FaultPlan.split([victim], [a for a in addrs if a != victim])
    if name == "delay":
        return FaultPlan.delay(lead, victim, 2.0)
    if name == "crash":
        return FaultPlan.crash(victim)
    raise ValueError(f"unknown fault plan {name!r}")


def _precheck_cfg(n: int, seed: int, peer_chunk: int,
                  active_rows=None) -> SimConfig:
    """The precheck's cluster in a peer and progress lowering."""
    return SimConfig(n=n, log_len=64, window=8, apply_batch=16,
                     max_props=8, keep=4, election_tick=10, seed=seed,
                     log_chunk=0, peer_chunk=peer_chunk,
                     **_cli_common.active_rows_kw(active_rows))


def _precheck_schedule(cfg: SimConfig, plan_name: str, ticks: int,
                       seed: int, dev) -> dst.FaultSchedule:
    """Plan `plan_name` lowered over cfg.n synthetic rows, as the
    one-schedule batch explore takes: a [1, T, ...] FaultSchedule."""
    addrs = [f"row-{i}.sweep:4242" for i in range(cfg.n)]
    rows = {a: i for i, a in enumerate(addrs)}
    sched = dst.from_fault_plan(
        cfg, _device_plan(plan_name, addrs), rows, ticks=ticks,
        inject_at=10, heal_at=40, seed=seed, device=dev)
    return dst.FaultSchedule(
        **{k: v[None] for k, v in sched.leaves().items()})


def _precheck_run(cfg: SimConfig, batched: dst.FaultSchedule, dev):
    return dst.explore(init_state(cfg, device=dev), cfg, batched,
                       device=dev)


def _same_masks(a, b) -> bool:
    """Two explore results with equal violation bitmasks, first-violation
    ticks and per-tick bit traces."""
    return (np.array_equal(a.viol, b.viol)
            and np.array_equal(a.first_tick, b.first_tick)
            and np.array_equal(a.bits_by_tick, b.bits_by_tick))


def run_device_precheck(plans=PLANS, seeds=DEFAULT_SEEDS, peer_chunk: int = 8,
                        n: int = 16, ticks: int = 60,
                        verbose: bool = True, active_rows=None,
                        device=None, stats: Optional[dict] = None
                        ) -> list[dict]:
    """Lower every (plan, seed) to a device fault schedule and run it
    through the DST tick with ``SimConfig.peer_chunk=peer_chunk`` and
    ``SimConfig.active_rows=active_rows`` (None = default), on `device`
    (the CUDA card unless the caller names another).

    When the chunk selects the banded lowering the run is cross-checked
    against the dense tick: violation bitmasks, first-violation ticks,
    and per-tick bit traces must match exactly (the hierarchical quorum
    reductions are integer sums, so any drift is a bug, not noise).
    ``peer_chunk=0`` runs the dense lowering alone.  Likewise, when
    ``active_rows`` selects the role-sparse progress slabs the run is
    cross-checked against the dense elementwise progress tick
    (``active_rows=0``) under the same peer lowering.  `stats`, when
    given, receives under (plan, seed) the requested lowering's explore
    result (its ``viol``, ``first_tick`` and ``bits_by_tick``).
    """
    dev = resolve_device(device)
    results = []
    for plan_name in plans:
        for seed in seeds:
            t0 = time.monotonic()
            cfg = _precheck_cfg(n, seed, peer_chunk, active_rows)
            sched = _precheck_schedule(cfg, plan_name, ticks, seed, dev)
            res = _precheck_run(cfg, sched, dev)
            if stats is not None:
                stats[(plan_name, seed)] = res
            ok, err = True, ""
            notes = (f"viol=0x{int(res.viol[0]):x} "
                     f"lowering={'banded' if cfg.peer_tiled else 'dense'}"
                     + ("+sparse" if cfg.active_rows_on else ""))
            if cfg.peer_tiled:
                ref = _precheck_run(
                    _precheck_cfg(n, seed, 0, active_rows), sched, dev)
                if not _same_masks(res, ref):
                    ok = False
                    err = (f"banded/dense divergence: viol "
                           f"{res.viol.tolist()} vs {ref.viol.tolist()}")
                else:
                    notes += " == dense-peer"
            if ok and cfg.active_rows_on:
                ref = _precheck_run(
                    _precheck_cfg(n, seed, peer_chunk, 0), sched, dev)
                if not _same_masks(res, ref):
                    ok = False
                    err = (f"sparse/dense progress divergence: viol "
                           f"{res.viol.tolist()} vs {ref.viol.tolist()}")
                else:
                    notes += " == dense-progress"
            wire = f"device(pc={peer_chunk}" + (
                f",ar={active_rows})" if active_rows is not None else ")")
            results.append({"wire": wire,
                            "plan": plan_name, "seed": seed, "ok": ok,
                            "notes": notes, "error": err,
                            "secs": round(time.monotonic() - t0, 2)})
            if verbose:
                r = results[-1]
                state = "ok  " if ok else "FAIL"
                line = (f"{state} {r['wire']:8s} {plan_name:10s} "
                        f"seed={seed} ({r['secs']}s)  {notes}")
                if not ok:
                    line += f"  {err}"
                print(line, flush=True)
    return results


# --------------------------------------------------------------------------
# the trip pipeline the attack and storage scenarios share


def _catch_and_shrink(off: SimConfig, on: SimConfig, sc: dict, name: str,
                      seed: int, schedules: int, bit: int, dev, st: dict):
    """Defense off must catch `bit`, defense on must be clean on the SAME
    schedules; the first counterexample is shrunk and replayed.  Returns
    (its index, the shrunk schedule, the replayed viol and first tick);
    `st` receives the caught count, the schedules, the fault events
    before and after the shrink and its evals."""
    batch, names = dst.make_batch(off, ticks=sc["ticks"],
                                  schedules=schedules, seed=seed,
                                  profiles=(name,), device=dev)
    r_off = dst.explore(init_state(off, device=dev), off, batch,
                        profiles=names, prop_count=sc["prop_count"],
                        device=dev)
    caught = [int(s) for s in r_off.violating if int(r_off.viol[s]) & bit]
    if not caught:
        raise AssertionError(f"defense-off sweep never tripped {sc['bit']}")
    r_on = dst.explore(init_state(on, device=dev), on, batch,
                       profiles=names, prop_count=sc["prop_count"],
                       device=dev)
    if int((r_on.viol != 0).sum()):
        raise AssertionError(
            f"defense-on ({sc['defense']}) not clean: "
            f"{[hex(int(v)) for v in r_on.viol]}")
    s = caught[0]
    one = batch.slice(s)
    before = dst.fault_count(one)
    small, evals = dst.shrink(off, one, bit, sc["prop_count"], device=dev)
    v2, f2 = dst.replay(off, small, sc["prop_count"], device=dev)
    st.update(caught=len(caught), schedules=schedules, faults_before=before,
              faults_after=dst.fault_count(small), shrink_evals=evals)
    return s, small, v2, f2


def _trip_notes(st: dict, sc: dict, tail: str, path: str) -> str:
    return (f"caught {st['caught']}/{st['schedules']} ({sc['bit']}), "
            f"shrunk {st['faults_before']}->{st['faults_after']} "
            f"fault-events in {st['shrink_evals']} replays, replay exact, "
            f"{tail}, defense-on ({sc['defense']}) clean [{path}]")


def _report(results: list, name: str, seed: int, ok: bool,
            notes: str, err: str, t0: float, wires, skip: str,
            verbose: bool, st: dict) -> None:
    results.append({"wire": "device", "plan": name, "seed": seed,
                    "ok": ok, "notes": notes, "error": err,
                    "secs": round(time.monotonic() - t0, 2)})
    st["secs"] = time.monotonic() - t0
    if verbose:
        r = results[-1]
        state = "ok  " if ok else "FAIL"
        line = (f"{state} {'device':8s} {name:18s} seed={seed} "
                f"({r['secs']}s)  {notes}")
        if not ok:
            line += f"  {err}"
        print(line, flush=True)
    for wire in wires:
        results.append({"wire": wire, "plan": name, "seed": seed,
                        "ok": True, "skipped": skip,
                        "notes": f"SKIP: {skip}", "secs": 0.0})
        if verbose:
            print(f"skip {wire:8s} {name:18s} seed={seed} ({skip})",
                  flush=True)


def _out_path(out_dir: Optional[str], name: str) -> str:
    return _cli_common.artifact_path(
        None if out_dir is None else out_dir.rstrip(os.sep) + os.sep, name)


# --------------------------------------------------------------------------
# adversary attack scenarios (device wire): full counterexample pipeline


def run_attack_sweep(attacks=None, seed: int = 7, schedules: int = 8,
                     n: int = 5, out_dir: Optional[str] = None,
                     wires=WIRES, verbose: bool = True, device=None,
                     stats: Optional[dict] = None) -> list[dict]:
    """Seed-pinned end-to-end run of each ATTACK_SCENARIOS row, on
    `device` (the CUDA card unless the caller names another).

    For every attack: the defense-off sweep must CATCH it (the named
    invariant bit trips), the first counterexample is shrunk and dumped
    as a replayable artifact (replay must reproduce bits + first tick
    exactly, the differential oracle must stay in lockstep over the
    clean prefix), and the defense-on sweep over the SAME schedules must
    come back violation-free.  Host wires get explicit skip rows — see
    ATTACK_WIRE_SKIP.  `stats`, when given, receives per attack the
    caught count, the fault events before and after the shrink, its
    evals, the oracle's diverged_at, the artifact path and the seconds."""
    dev = resolve_device(device)
    attacks = list(attacks or ATTACK_SCENARIOS)
    base = SimConfig(n=n, log_len=64, window=8, apply_batch=16, max_props=8,
                     keep=4, election_tick=10, seed=seed)
    bit_of = {name: bit for bit, name in dst.BIT_NAMES.items()}
    results = []
    for attack in attacks:
        sc = ATTACK_SCENARIOS[attack]
        t0 = time.monotonic()
        off = dataclasses.replace(base, **sc["off"])
        on = dataclasses.replace(base, **sc["on"])
        bit = bit_of[sc["bit"]]
        st = {} if stats is None else stats.setdefault(attack, {})
        ok, err, notes = True, "", ""
        try:
            s, small, v2, f2 = _catch_and_shrink(
                off, on, sc, attack, seed, schedules, bit, dev, st)
            art = dst.to_artifact(off, small, seed=seed, profile=attack,
                                  index=s, prop_count=sc["prop_count"],
                                  mutation=None, viol=v2, first_tick=f2)
            path = _out_path(out_dir, f"dst_attack_{attack}.json")
            dst.save_artifact(path, art)
            verdict = dst.replay_artifact(path, device=dev)
            if not verdict["matches_recorded"]:
                raise AssertionError("artifact replay did not reproduce "
                                     "the recorded violation")
            tr = verdict["oracle"]
            st.update(diverged_at=tr["diverged_at"], artifact=path)
            if tr["diverged_at"] != -1:
                raise AssertionError(f"differential oracle diverged at "
                                     f"tick {tr['diverged_at']}")
            notes = _trip_notes(st, sc, "oracle lockstep", path)
        except AssertionError as e:
            ok, err = False, str(e)
        _report(results, attack, seed, ok, notes, err, t0, wires,
                ATTACK_WIRE_SKIP, verbose, st)
    return results


# --------------------------------------------------------------------------
# storage-fault scenarios (device wire): the durability boundary


def run_storage_sweep(faults=None, seed: int = 7, schedules: int = 8,
                      n: int = 5, out_dir: Optional[str] = None,
                      wires=WIRES, verbose: bool = True, device=None,
                      stats: Optional[dict] = None) -> list[dict]:
    """Seed-pinned end-to-end run of each STORAGE_SCENARIOS row (see the
    table above for the trip/contain split and the oracle bounds), on
    `device` (the CUDA card unless the caller names another).  `stats` as
    run_attack_sweep's (a contain row: its violations and recovery
    events)."""
    dev = resolve_device(device)
    faults = list(faults or STORAGE_SCENARIOS)
    base = SimConfig(n=n, log_len=64, window=8, apply_batch=16, max_props=8,
                     keep=4, election_tick=10, seed=seed)
    bit_of = {name: bit for bit, name in dst.BIT_NAMES.items()}
    results = []
    for fault in faults:
        sc = STORAGE_SCENARIOS[fault]
        t0 = time.monotonic()
        on = dataclasses.replace(base, **sc["on"])
        st = {} if stats is None else stats.setdefault(fault, {})
        ok, err, notes = True, "", ""
        try:
            if sc["mode"] == "contain":
                batch, names = dst.make_batch(on, ticks=sc["ticks"],
                                              schedules=schedules, seed=seed,
                                              profiles=(fault,), device=dev)
                r_on = dst.explore(init_state(on, device=dev), on, batch,
                                   profiles=names,
                                   prop_count=sc["prop_count"], device=dev)
                if int((r_on.viol != 0).sum()):
                    raise AssertionError(
                        f"gated config not clean under {fault}: "
                        f"{[hex(int(v)) for v in r_on.viol]}")
                code = dst.STORAGE_SIGNATURE_CODES[fault]
                fl = dst.capture_flight(on, batch.slice(0),
                                        sc["prop_count"], window=400,
                                        device=dev)
                hits = sum(code in e.describe()
                           for e in fl["record"].window(400))
                st.update(schedules=schedules, violations=0,
                          recovery_events=hits)
                if not hits:
                    raise AssertionError(
                        f"{code} never fired — the {fault} verb was "
                        f"absorbed without any recovery evidence")
                notes = (f"contained: 0/{schedules} violations with "
                         f"{sc['defense']}, {hits} {code} recovery "
                         f"event(s) on schedule 0")
            else:
                off = dataclasses.replace(base, **sc["off"])
                bit = bit_of[sc["bit"]]
                s, small, v2, f2 = _catch_and_shrink(
                    off, on, sc, fault, seed, schedules, bit, dev, st)
                art = dst.to_artifact(off, small, seed=seed, profile=fault,
                                      index=s, prop_count=sc["prop_count"],
                                      mutation=None, viol=v2, first_tick=f2)
                path = _out_path(out_dir, f"dst_storage_{fault}.json")
                dst.save_artifact(path, art)
                want_trace = sc["oracle"] == "violation"
                verdict = dst.replay_artifact(path, with_trace=want_trace,
                                              device=dev)
                if not verdict["matches_recorded"]:
                    raise AssertionError("artifact replay did not reproduce "
                                         "the recorded violation")
                if want_trace:
                    div = verdict["oracle"]["diverged_at"]
                else:
                    # the first tick the verb fires, reduced on the device
                    # (one read); the oracle is compared before it
                    leaf = getattr(small, dst.STORAGE_LEAVES[fault])
                    ticks = torch.arange(leaf.shape[0], device=leaf.device)
                    first_verb = int(torch.where(leaf.any(dim=1), ticks,
                                                 leaf.shape[0]).min())
                    div = dst.oracle_trace(
                        off, small, sc["prop_count"], until=first_verb,
                        device=dev)["diverged_at"]
                st.update(diverged_at=div, artifact=path)
                if div != -1:
                    raise AssertionError(f"differential oracle diverged at "
                                         f"tick {div}")
                notes = _trip_notes(
                    st, sc, f"oracle lockstep ({sc['oracle']}-bounded)", path)
        except AssertionError as e:
            ok, err = False, str(e)
        _report(results, fault, seed, ok, notes, err, t0, wires,
                STORAGE_WIRE_SKIP, verbose, st)
    return results


# --------------------------------------------------------------------------
# running the host-wire sweep


def _dump_flight(res: dict, flight_dir: str) -> Optional[str]:
    """Write a host-side flight record for one failed scenario: the
    tracer's finished spans (raft.propose, dispatcher.session, probe
    spans...) captured at the moment of failure, trigger-tagged so the
    Manager scrape's recent-events section picks it up too."""
    try:
        from swarmkit_tpu_torch.flightrec import record as flight_record
        from swarmkit_tpu_torch.metrics import trace as obs_trace

        rec = flight_record.FlightRecord(
            events=[], dropped=[], n=0, trigger="scenario_failure",
            meta={k: res.get(k) for k in
                  ("wire", "plan", "seed", "error", "notes")},
            spans=[s.to_dict() for s in obs_trace.DEFAULT.finished()])
        flight_record._RECENT.append(rec)
        os.makedirs(flight_dir, exist_ok=True)
        path = os.path.join(
            flight_dir,
            f"fault_{res['wire']}_{res['plan']}_{res['seed']}.json")
        flight_record.save_record(rec, path)
        return path
    except Exception as e:  # a dump failure must not mask the scenario's
        print(f"  (flight dump failed: {type(e).__name__}: {e})", flush=True)
        return None


def run_sweep(wires=WIRES, plans=PLANS, seeds=DEFAULT_SEEDS,
              verbose: bool = True, flight_dir: Optional[str] = None,
              device=None, stats: Optional[dict] = None) -> list[dict]:
    """Run each (wire, plan, seed) scenario on a fresh event loop and
    return one result dict per scenario (importable from tests).  With
    `flight_dir`, every failing scenario dumps a flight record there.
    The devmesh wire's exchange runs on `device` (the CUDA card unless
    the caller names another), resolved before the first scenario: a
    missing card raises rather than fail the rows.  `stats`, when given,
    receives under (wire, plan, seed) the scenario's device-wire flushes
    and messages (swarm_transport_device_{flushes,messages}_total; 0 on
    the host wires)."""
    dev = resolve_device(device) if "devmesh" in wires else None
    results = []
    for wire in wires:
        for plan in plans:
            for seed in seeds:
                t0 = time.monotonic()
                st = {} if stats is None else stats.setdefault(
                    (wire, plan, seed), {})
                res = asyncio.run(_run_scenario(wire, plan, seed, dev, st))
                res["secs"] = round(time.monotonic() - t0, 2)
                if not res["ok"] and flight_dir:
                    res["flight"] = _dump_flight(res, flight_dir)
                results.append(res)
                if verbose:
                    state = "ok  " if res["ok"] else "FAIL"
                    line = (f"{state} {wire:8s} {plan:10s} seed={seed} "
                            f"({res['secs']}s)")
                    if not res["ok"]:
                        line += f"  {res.get('error', '')}"
                        if res.get("flight"):
                            line += f"  [flight: {res['flight']}]"
                    print(line, flush=True)
    return results


# --------------------------------------------------------------------------
# the command line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--wires", default=",".join(WIRES),
                    help=f"comma list from {WIRES} (skip rows in "
                    f"--attacks / --storage)")
    ap.add_argument("--plans", default=",".join(PLANS),
                    help=f"comma list from {PLANS}")
    ap.add_argument("--seeds", default=",".join(map(str, DEFAULT_SEEDS)),
                    help="comma list of seeds")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="dump a flight record (host spans + failure "
                    "provenance) here for every failing host-wire "
                    "scenario, and write the attack and storage repro "
                    "artifacts here (default: the system temp dir)")
    ap.add_argument("--peer-chunk", type=int, default=None, metavar="PC",
                    help="also run every plan through the DST tick in "
                         "this peer-axis lowering (SimConfig.peer_chunk; "
                         "0 = dense, else banded + dense cross-check)")
    ap.add_argument("--attacks", default=None, metavar="LIST",
                    help=f"run ONLY the seed-pinned adversary attack "
                    f"scenarios ('all' or a comma list from "
                    f"{tuple(ATTACK_SCENARIOS)}): device-wire "
                    f"counterexample pipeline + explicit per-host-wire "
                    f"skip rows (the verbs have no host seam)")
    ap.add_argument("--storage", default=None, metavar="LIST",
                    help=f"run ONLY the seed-pinned storage-fault "
                    f"scenarios ('all' or a comma list from "
                    f"{tuple(STORAGE_SCENARIOS)}): device-wire durability "
                    f"pipeline (catch -> shrink -> replay-exact -> "
                    f"gating-on clean) + explicit per-host-wire skip rows")
    _cli_common.add_active_rows_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                    "run on the CPU)")
    args = ap.parse_args(argv)

    wires = [w for w in args.wires.split(",") if w]
    plans = [p for p in args.plans.split(",") if p]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for w in wires:
        if w not in WIRES:
            ap.error(f"unknown wire {w!r}")
    for p in plans:
        if p not in PLANS:
            ap.error(f"unknown plan {p!r}")
    attacks = faults = None
    if args.attacks:
        attacks = (list(ATTACK_SCENARIOS) if args.attacks == "all"
                   else [a for a in args.attacks.split(",") if a])
        for a in attacks:
            if a not in ATTACK_SCENARIOS:
                ap.error(f"unknown attack {a!r}; "
                         f"known: {tuple(ATTACK_SCENARIOS)}")
    if args.storage:
        faults = (list(STORAGE_SCENARIOS) if args.storage == "all"
                  else [f for f in args.storage.split(",") if f])
        for f in faults:
            if f not in STORAGE_SCENARIOS:
                ap.error(f"unknown storage fault {f!r}; "
                         f"known: {tuple(STORAGE_SCENARIOS)}")
    dev = resolve_device(args.device)

    if attacks:
        results = run_attack_sweep(attacks, seed=seeds[0], wires=wires,
                                   out_dir=args.flight_dir, device=dev)
        failed = [r for r in results if not r["ok"]]
        ran = [r for r in results if "skipped" not in r]
        print(f"\n{len(ran) - len(failed)}/{len(ran)} attack scenarios "
              f"passed ({len(results) - len(ran)} host-wire skips)")
        return 1 if failed else 0

    if faults:
        results = run_storage_sweep(faults, seed=seeds[0], wires=wires,
                                    out_dir=args.flight_dir, device=dev)
        failed = [r for r in results if not r["ok"]]
        ran = [r for r in results if "skipped" not in r]
        print(f"\n{len(ran) - len(failed)}/{len(ran)} storage scenarios "
              f"passed ({len(results) - len(ran)} host-wire skips)")
        return 1 if failed else 0

    results = []
    if args.peer_chunk is not None or args.active_rows is not None:
        results += run_device_precheck(
            plans, seeds,
            peer_chunk=args.peer_chunk if args.peer_chunk is not None else 8,
            active_rows=args.active_rows, device=dev)
    results += run_sweep(wires, plans, seeds, flight_dir=args.flight_dir,
                         device=dev)
    failed = [r for r in results if not r["ok"]]
    print(f"\n{len(results) - len(failed)}/{len(results)} scenarios passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
