"""The metrics the port publishes: one spec per name (kind, help text,
label schema and, for histograms, bucket edges).

Components never declare a family by hand: they call :func:`get`, which
instantiates it in the target registry from its spec.  Each spec is the
JAX package's for the same name, field for field, so the port's scrape
page reads like the JAX package's.  The port holds the families its
modules publish: the kernel counters and tick timer (raft/sim/run.py
KernelObs), the telemetry plane (telemetry/obs.py), the flight recorder
(flightrec/record.py), the trace export (flightrec/clock.py, export.py),
the DST sweep (dst/explore.py, dst/repro.py), the multi-raft serving
plane (multiraft/obs.py), the SLO engine (slo/engine.py), the
scheduler with its group-placement kernel (manager/scheduler/), the
dispatcher (manager/dispatcher/), the store (store/memory.py) and the
raft transports (raft/transport.py, transport/device_mesh.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .registry import DEFAULT_BUCKETS, MetricsRegistry


@dataclass(frozen=True)
class MetricSpec:
    kind: str                       # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple = ()
    buckets: Optional[tuple] = None


# Bucket ladders: RPC-ish latencies use the prometheus defaults; device
# ticks span 0.1 ms (tiny CPU shapes) to tens of seconds (first calls).
_TICK_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# Simulated-tick ladder for the on-device telemetry histograms.  Literal
# floats rather than an import of telemetry/series.py (that module's
# publisher imports this catalog); a test pins them to
# series.LATENCY_BUCKET_EDGES.
_TEL_TICK_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

CATALOG: dict[str, MetricSpec] = {
    # ---- raft node (raft/node.py) -----------------------------------------
    "swarm_raft_elections_started_total": MetricSpec(
        "counter", "Campaigns this node started (entered candidate or "
        "pre-candidate state).", ("node",)),
    "swarm_raft_elections_won_total": MetricSpec(
        "counter", "Elections this node won (became leader).", ("node",)),
    "swarm_raft_leader_changes_total": MetricSpec(
        "counter", "Observed leadership changes, from any role.", ("node",)),
    "swarm_raft_term": MetricSpec(
        "gauge", "Current raft term.", ("node",)),
    "swarm_raft_commit_index": MetricSpec(
        "gauge", "Highest committed log index.", ("node",)),
    "swarm_raft_applied_index": MetricSpec(
        "gauge", "Highest applied log index.", ("node",)),
    "swarm_raft_is_leader": MetricSpec(
        "gauge", "1 while this node is the raft leader, else 0.", ("node",)),
    "swarm_raft_proposal_latency_seconds": MetricSpec(
        "histogram", "ProposeValue wall time: submit to quorum commit "
        "(the reference's proposeLatencyTimer span).", ("node",)),
    "swarm_raft_proposals_total": MetricSpec(
        "counter", "Proposals submitted, by outcome.", ("node", "result")),
    "swarm_raft_peer_sends_total": MetricSpec(
        "counter", "Raft messages handed to the transport, per peer.",
        ("node", "peer")),
    "swarm_raft_peer_send_failures_total": MetricSpec(
        "counter", "Per-peer delivery failures reported back to the node "
        "(feeds Node.status()['peer_failures']).", ("node", "peer")),
    # ---- transports (raft/transport.py, transport/device_mesh.py) --------
    "swarm_transport_delivery_latency_seconds": MetricSpec(
        "histogram", "Queue-to-delivered wall time per raft message on the "
        "sending side.", ("wire",)),
    "swarm_transport_redials_total": MetricSpec(
        "counter", "Backoff redial sleeps taken by per-peer drain loops "
        "after delivery failures.", ("wire",)),
    "swarm_transport_send_failures_total": MetricSpec(
        "counter", "Message delivery failures across all peers.", ("wire",)),
    "swarm_transport_mailbox_depth": MetricSpec(
        "gauge", "Device-mesh messages staged and awaiting the next "
        "all-to-all flush.", ()),
    "swarm_transport_device_flushes_total": MetricSpec(
        "counter", "Device-mesh all-to-all exchange invocations.", ()),
    "swarm_transport_device_messages_total": MetricSpec(
        "counter", "Raft messages moved through device-mesh exchanges.", ()),
    "swarm_transport_exchange_seconds": MetricSpec(
        "histogram", "Wall time of one device-mesh exchange flush "
        "(host-side, around the jitted all-to-all).", (),
        _TICK_BUCKETS),

    # ---- device tick kernel (raft/sim/kernel.py, run.py KernelObs) -------
    "swarm_kernel_tick_seconds": MetricSpec(
        "histogram", "Host-side wall time around jitted kernel calls, by "
        "driver (step / run_ticks chunk / run_until_leader).", ("call",),
        _TICK_BUCKETS),
    "swarm_kernel_phase_ms": MetricSpec(
        "gauge", "Isolated per-phase A-F cost in ms from the micro-kernel "
        "model (tools/perf_model.py), keyed by PERF.md's phase table.",
        ("phase",)),
    "swarm_kernel_bytes_touched": MetricSpec(
        "gauge", "Analytic per-tick kernel bytes read+written by phase and "
        "kernel variant: the C/E/F log-buffer hot phases (tools/"
        "perf_model.py --tiled; variant tiled / full), the read path "
        "(--reads; variant lease / readindex), the peer-axis quorum "
        "reductions phase=votes|commit (--peer-tiled; variant banded / "
        "dense), and the elementwise per-peer progress writes "
        "phase=progress (--active-rows; variant sparse / dense).",
        ("phase", "variant")),
    "swarm_kernel_elections_started_total": MetricSpec(
        "counter", "On-device cumulative campaigns across all rows "
        "(SimState.stats[0]).", ()),
    "swarm_kernel_elections_won_total": MetricSpec(
        "counter", "On-device cumulative election wins across all rows "
        "(SimState.stats[1]).", ()),
    "swarm_kernel_commit_advance_total": MetricSpec(
        "counter", "On-device cumulative commit-index advance summed over "
        "rows (SimState.stats[2]).", ()),
    "swarm_kernel_apply_advance_total": MetricSpec(
        "counter", "On-device cumulative applied-index advance summed over "
        "rows (SimState.stats[3]).", ()),
    "swarm_kernel_reads_served_total": MetricSpec(
        "counter", "On-device cumulative linearizable read ops served "
        "summed over rows (SimState.read_srv, cfg.read_batch > 0).", ()),
    "swarm_kernel_reads_blocked_total": MetricSpec(
        "counter", "On-device cumulative read ops refused (leadership lost "
        "or lease expired with the batch unstamped) summed over rows "
        "(SimState.read_block).", ()),
    "swarm_kernel_fsync_lag": MetricSpec(
        "gauge", "Widest unsynced log suffix max(last - sync_mark) across "
        "rows at last publish (cfg.fsync_lag_ticks >= 1; the quantity "
        "SLO_FSYNC_LAG budgets under disk_stall).", ()),
    "swarm_kernel_durable_commit_advance_total": MetricSpec(
        "counter", "On-device cumulative durable-commit advance summed "
        "over rows (SimState.dur_commit, the register RECOVERY_MONOTONIC "
        "pins; trails swarm_kernel_commit_advance_total by the fsync "
        "policy's lag).", ()),

    # ---- flight recorder (flightrec/) ------------------------------------
    "swarm_flightrec_events_total": MetricSpec(
        "counter", "Device flight-ring events decoded by capture(), by "
        "event code name (flightrec/codes.py).", ("code",)),
    "swarm_flightrec_dropped_total": MetricSpec(
        "counter", "Events overwritten in a row's ring before decoding "
        "(cursor ran past SimConfig.event_ring).", ()),
    "swarm_flightrec_captures_total": MetricSpec(
        "counter", "Flight-record captures, by trigger (manual / "
        "dst_violation / scenario_failure).", ("trigger",)),

    # ---- causal trace fusion (flightrec/clock.py, export.py) -------------
    "swarm_trace_clock_sync_points_total": MetricSpec(
        "counter", "Tick<->wall-clock sync points folded into captures "
        "(ClockSync.publish); each is one host observation of the device "
        "tick counter.", ()),
    "swarm_trace_clock_tick_us": MetricSpec(
        "gauge", "Fitted wall-clock microseconds per simulated tick "
        "(ClockFit slope, Theil-Sen over the sync points).", ()),
    "swarm_trace_clock_residual_us": MetricSpec(
        "gauge", "Worst |fit - sample| residual of the tick<->wall-clock "
        "fit in microseconds; large values mean the tick rate drifted "
        "within the capture window.", ()),
    "swarm_trace_flow_events_total": MetricSpec(
        "counter", "Chrome-trace flow events (ph s/t/f) emitted by the "
        "Perfetto export, linking host spans to tagged device instants "
        "(cfg.trace_tags).", ()),
    "swarm_trace_flow_orphans_total": MetricSpec(
        "counter", "Trace tags seen on only one side of the export: "
        "host_only (ring wrap ate the device instant) or device_only "
        "(span deque evicted the host span).", ("side",)),

    # ---- on-device telemetry plane (telemetry/) --------------------------
    "swarm_telemetry_commit_latency_ticks": MetricSpec(
        "histogram", "Propose-to-commit latency in simulated ticks, "
        "measured at the proposing leader for self-appended entries "
        "(SimState.tel_commit_hist, cfg.collect_telemetry).", (),
        _TEL_TICK_BUCKETS),
    "swarm_telemetry_election_ticks": MetricSpec(
        "histogram", "Election duration in simulated ticks, campaign "
        "start to leadership (SimState.tel_elect_hist).", (),
        _TEL_TICK_BUCKETS),
    "swarm_telemetry_read_latency_ticks": MetricSpec(
        "histogram", "Linearizable read-batch submit-to-settle latency "
        "in simulated ticks, served and blocked outcomes both counted "
        "(SimState.tel_read_hist, cfg.read_batch > 0).", (),
        _TEL_TICK_BUCKETS),
    "swarm_telemetry_series_value": MetricSpec(
        "gauge", "Latest sample of an on-device time-series ring row "
        "(SimState.tel_series), by series name "
        "(telemetry/series.py SERIES_NAMES).", ("series",)),

    # ---- deterministic simulation testing (dst/) -------------------------
    "swarm_dst_schedules_total": MetricSpec(
        "counter", "Fault schedules fully explored, by result "
        "(clean / violation).", ("result",)),
    "swarm_dst_violations_total": MetricSpec(
        "counter", "Schedules that tripped a raft safety invariant, by "
        "invariant (dst/invariants.py bit names).", ("invariant",)),
    "swarm_dst_schedules_per_second": MetricSpec(
        "gauge", "Throughput of the last vmapped explore() call, by "
        "config (n<rows>x<ticks>t).", ("config",)),
    "swarm_dst_shrink_rounds_total": MetricSpec(
        "counter", "Counterexample-shrinker replay evaluations, by verdict "
        "on the candidate fault clearing (removed / required).", ("result",)),
    "swarm_dst_attack_ticks_total": MetricSpec(
        "counter", "Adversary verb gate firings lowered into explored "
        "schedules, by attack profile (dst/schedule.py ATTACK_PROFILES).",
        ("attack",)),

    # ---- exhaustive model checker (mc/) ----------------------------------
    # Names and label sets are mc/metrics.py's METRIC_NAMES.
    "swarm_mc_branches_total": MetricSpec(
        "counter", "Model-checker (state, action) expansions, by result "
        "(clean / violation).", ("result",)),
    "swarm_mc_states_total": MetricSpec(
        "counter", "Reached states, by dedup verdict (unique = entered "
        "the frontier, duplicate = merged into an existing fingerprint).",
        ("kind",)),
    "swarm_mc_violations_total": MetricSpec(
        "counter", "Invariants tripped by at least one enumerated branch, "
        "by invariant (dst/invariants.py bit names).", ("invariant",)),
    "swarm_mc_branches_per_second": MetricSpec(
        "gauge", "Expansion throughput of the last exhaustive_scan, by "
        "scope preset.", ("scope",)),
    "swarm_mc_frontier_peak_states": MetricSpec(
        "gauge", "Largest per-level unique frontier of the last "
        "exhaustive_scan, by scope preset.", ("scope",)),
    "swarm_mc_truncations_total": MetricSpec(
        "counter", "Fresh states dropped by the --budget frontier cap "
        "(scan no longer exhaustive), by scope preset.", ("scope",)),

    # ---- multi-raft serving plane (multiraft/) ---------------------------
    # Names and label sets are multiraft/obs.py's METRIC_NAMES.
    "swarm_multiraft_groups": MetricSpec(
        "gauge", "Raft groups in the serving plane (leading G axis of "
        "the grouped state).", ()),
    "swarm_multiraft_groups_with_leader": MetricSpec(
        "gauge", "Groups with an acting leader at last publish.", ()),
    "swarm_multiraft_router_keys_total": MetricSpec(
        "counter", "Keys handled by the key->group router, by outcome "
        "(routed = accepted into a per-group batch queue, spilled = "
        "deferred past one flush by the group's max_props capacity).",
        ("outcome",)),
    "swarm_multiraft_leader_changes_total": MetricSpec(
        "counter", "Per-group leader changes summed over groups: "
        "publishes where a group's acting leader row differs from the "
        "previous publish.", ()),
    "swarm_multiraft_committed_entries_total": MetricSpec(
        "counter", "Entries committed through consensus summed over "
        "groups (per group: max commit across rows).", ()),
    "swarm_multiraft_reads_served_total": MetricSpec(
        "counter", "Linearizable read ops served summed over groups and "
        "rows (cfg.read_batch > 0).", ()),
    "swarm_multiraft_group_commit_latency_ticks": MetricSpec(
        "gauge", "Per-group propose-to-commit latency in simulated ticks "
        "(bucket upper edge of the group's on-device telemetry "
        "histogram), by group index and quantile (p50 / p99).  Published "
        "only while the plane holds at most GROUP_LABEL_CAP groups.",
        ("group", "quantile")),
    "swarm_multiraft_group_leader_changes_total": MetricSpec(
        "counter", "Leader changes per group: publishes where this "
        "group's acting leader row differs from the previous publish "
        "(the churn-rate input for the SLO engine).", ("group",)),
    "swarm_multiraft_group_heat": MetricSpec(
        "gauge", "EWMA hot-group heat score, by group index: router "
        "spills (weighted SPILL_WEIGHT x) fused with per-group commit "
        "rate (multiraft/heat.py).  All groups up to GROUP_LABEL_CAP, "
        "top HEAT_TOP_K hottest beyond.", ("group",)),

    # ---- SLO burn-rate engine (slo/) -------------------------------------
    # Names and label sets are slo/engine.py's METRIC_NAMES.
    "swarm_slo_state": MetricSpec(
        "gauge", "Alert state of one SLO for one group: 0 = ok, 1 = "
        "warn, 2 = page (slo/engine.py state machine with hysteresis).",
        ("slo", "group")),
    "swarm_slo_burn_rate": MetricSpec(
        "gauge", "Burn rate of one SLO's error budget over the fast / "
        "slow evaluation window (1.0 = burning exactly the budget).",
        ("slo", "group", "window")),
    "swarm_slo_transitions_total": MetricSpec(
        "counter", "SLO state-machine transitions, by SLO, group, and "
        "the state ENTERED (warn escalations, page escalations, "
        "recoveries to ok).", ("slo", "group", "state")),

    # ---- scheduler (manager/scheduler/scheduler.py) ----------------------
    "swarm_scheduler_latency_seconds": MetricSpec(
        "histogram", "One scheduler tick: snapshot, score, and commit of "
        "all pending assignments.", ()),
    "swarm_scheduler_decisions_total": MetricSpec(
        "counter", "Task placement decisions, by outcome "
        "(assigned / preassigned / unassigned).", ("result",)),
    "swarm_scheduler_pending_tasks": MetricSpec(
        "gauge", "Tasks currently awaiting placement.", ()),

    # ---- dispatcher / store (manager/dispatcher/, store/memory.py) -------
    "swarm_dispatcher_sessions_total": MetricSpec(
        "counter", "Agent sessions opened against this dispatcher.", ()),
    "swarm_dispatcher_heartbeats_total": MetricSpec(
        "counter", "Heartbeats processed, by result (ok / invalid).",
        ("result",)),
    "swarm_dispatcher_heartbeat_rtt_seconds": MetricSpec(
        "histogram", "Server-side heartbeat handling time (store round "
        "trip included).", ()),
    "swarm_dispatcher_task_updates_total": MetricSpec(
        "counter", "Task status updates accepted from agents.", ()),
    "swarm_store_commits_total": MetricSpec(
        "counter", "Store transactions committed, by kind "
        "(read / write / batch).", ("kind",)),

    # ---- coalescing proposal pipeline (store/pipeline.py) ----------------
    "swarm_cpl_proposals_total": MetricSpec(
        "counter", "Packed raft proposals flushed by the coalescing "
        "pipeline, by outcome (committed / failed).", ("outcome",)),
    "swarm_cpl_txns_total": MetricSpec(
        "counter", "Store transactions routed through the coalescing "
        "pipeline, by outcome (committed / failed).", ("outcome",)),
    "swarm_cpl_batch_entries": MetricSpec(
        "histogram", "Transactions packed per raft proposal (the "
        "amortization factor of the batched pipeline).", (),
        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)),
    "swarm_cpl_queue_depth": MetricSpec(
        "gauge", "Transactions queued behind the in-flight packed "
        "proposal.", ()),

    # ---- group-placement kernel (manager/scheduler/kernel.py) ------------
    # Names and label sets are pinned to kernel.METRIC_NAMES by a test.
    "swarm_sched_kernel_groups_total": MetricSpec(
        "counter", "Task groups scheduled, by path (kernel = jitted "
        "[tasks, nodes] kernel, host = host Pipeline fallback).",
        ("path",)),
    "swarm_sched_kernel_tasks_total": MetricSpec(
        "counter", "Tasks placed through the jitted kernel path.", ()),
    "swarm_sched_kernel_seconds": MetricSpec(
        "histogram", "Wall time of one kernel group-placement call "
        "(encode + device + decode).", (), buckets=_TICK_BUCKETS),
}


def get(registry: MetricsRegistry, name: str):
    """Instantiate (or fetch) `name` in `registry` from its catalog spec."""
    spec = CATALOG.get(name)
    if spec is None:
        raise KeyError(f"metric {name!r} is not in the port's catalog; add "
                       f"a MetricSpec to swarmkit_tpu_torch/metrics/"
                       f"catalog.py")
    if spec.kind == "counter":
        return registry.counter(name, spec.help, spec.labels)
    if spec.kind == "gauge":
        return registry.gauge(name, spec.help, spec.labels)
    if spec.kind == "histogram":
        return registry.histogram(name, spec.help, spec.labels,
                                  buckets=spec.buckets or DEFAULT_BUCKETS)
    raise ValueError(f"unknown metric kind {spec.kind!r} for {name!r}")
