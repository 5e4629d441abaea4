"""Chrome-trace / Perfetto JSON export.

One timeline merges two clocks: device events are instants on a
tick-as-microsecond axis (pid "sim", one tid track per simulated
manager), host tracer spans are complete ("X") events on a wall-clock
axis normalized to start at 0 (pid "host", one tid track per subsystem —
the first dotted segment of the span name).  Telemetry time-series rows
(FlightRecord.counters, from the on-device ring) render as Perfetto
counter tracks ("C" phase, one track per series) on the sim tick axis,
so a post-mortem shows commit rate / leader churn / occupancy curves
next to the event instants.

Two optional layers fuse the clock domains into one causal picture:

- ``clock`` (a flightrec/clock.py ClockSync / ClockFit / their dict
  forms) remaps the device tracks from the synthetic tick axis onto the
  host wall-clock axis, so a COMMIT_ADVANCE instant lands *inside* the
  host span that was waiting on it.
- trace tags (``cfg.trace_tags``): host spans carrying a ``trace_tag``
  attr (metrics/trace.py ``span_trace_tag``) and device events carrying
  the matching tag lane are joined by Chrome flow events (``ph`` s/t/f,
  shared ``id``), drawing propose -> commit -> settle arrows across the
  process boundary.  A tag seen on only one side (ring wrap ate the
  instant, span deque evicted the span) degrades to an orphan
  annotation + counter — never a crash.

Both load in chrome://tracing and ui.perfetto.dev;
:func:`validate_chrome_trace` is the dependency-free schema check the
tests run on the output.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

SIM_PID = 1
HOST_PID = 2

# Chrome trace "ph" phases used here: i = instant, X = complete span,
# M = metadata (process/thread names), s/t/f = flow start/step/finish.
_REQUIRED_EVENT_KEYS = {"ph", "pid", "tid", "name"}
_FLOW_PHASES = ("s", "t", "f")


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> list[dict]:
    out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": tname or str(tid)}}]
    return out


def _publish_flow_metrics(n_flow: int, n_orphan_host: int,
                          n_orphan_device: int) -> None:
    # Best-effort, mirroring record.capture(): metrics must never cost
    # the export (tests call to_chrome_trace with no registry set up).
    try:
        from swarmkit_tpu_torch.metrics import catalog
        from swarmkit_tpu_torch.metrics import registry as obs_registry
        obs = obs_registry.DEFAULT
        if n_flow:
            catalog.get(obs, "swarm_trace_flow_events_total").inc(n_flow)
        m = catalog.get(obs, "swarm_trace_flow_orphans_total")
        if n_orphan_host:
            m.labels(side="host_only").inc(n_orphan_host)
        if n_orphan_device:
            m.labels(side="device_only").inc(n_orphan_device)
    except Exception:
        pass


def to_chrome_trace(events: Iterable = (), spans: Iterable[dict] = (),
                    tick_us: float = 1.0,
                    counters: Iterable[dict] = (),
                    clock=None) -> dict:
    """Build the trace dict.  `events` are FlightEvents (or dicts from a
    saved record); `spans` are Span.to_dict() rows; `counters` are
    FlightRecord.counters rows ({"name", "tick", "value"}).  `tick_us`
    maps one sim tick onto the µs timeline when no usable `clock` is
    given (ticks are unitless; 1 µs/tick keeps the two clock domains
    visually comparable, not aligned).  With a `clock` carrying at least
    one sync point, device ticks are remapped onto the host wall-clock
    axis instead, and host spans + device tracks share one normalized
    t0."""
    from swarmkit_tpu_torch.flightrec.clock import fit_from
    from swarmkit_tpu_torch.flightrec.codes import CODE_NAMES

    fit = fit_from(clock)
    span_rows = [s for s in spans if s.get("duration") is not None]
    event_rows = [e if isinstance(e, dict) else e.to_dict() for e in events]

    # One normalized origin for both clock domains.  Without a fit the
    # domains stay independent (device on the synthetic tick axis), so
    # t0 only ranges over span starts, as before.
    counters = list(counters)
    origins = [s["start"] for s in span_rows]
    if fit is not None:
        ticks = [int(d["tick"]) for d in event_rows] \
            + [int(c["tick"]) for c in counters]
        if ticks:
            origins.append(fit.host_ns_at(min(ticks)) / 1e9)
    t0_s = min(origins, default=0.0)

    def tick_ts(tick) -> float:
        """Device tick -> trace µs (wall-clock when fitted)."""
        if fit is None:
            return float(tick) * tick_us
        return fit.host_ns_at(tick) / 1e3 - t0_s * 1e6

    # Effective tick width in trace µs, for thin tagged slices below.
    eff_tick_us = tick_us if fit is None else fit.slope_ns_per_tick / 1e3

    trace_events: list[dict] = _meta(SIM_PID, "sim (device flight ring)")
    sim_tids = set()
    host_tags: dict[int, list[dict]] = {}
    device_tags: dict[int, list[dict]] = {}
    for d in event_rows:
        node = int(d["node"])
        sim_tids.add(node)
        ev = {
            "ph": "i", "s": "t",  # thread-scoped instant
            "pid": SIM_PID, "tid": node,
            "ts": tick_ts(d["tick"]),
            "name": d.get("name", f"CODE_{d['code']}"),
            "args": {"arg0": int(d["arg0"]), "arg1": int(d["arg1"]),
                     "seq": int(d.get("seq", 0))},
        }
        tag = int(d.get("tag", 0) or 0)
        if tag:
            ev["args"]["trace_tag"] = tag
            device_tags.setdefault(tag, []).append(ev)
        trace_events.append(ev)
    for node in sorted(sim_tids):
        trace_events += _meta(SIM_PID, "", tid=node, tname=f"manager {node}")

    host_tids: dict[str, int] = {}
    for s in span_rows:
        subsystem = s["name"].split(".", 1)[0]
        tid = host_tids.setdefault(subsystem, len(host_tids))
        args = {k: v for k, v in (s.get("attrs") or {}).items()}
        args["span_id"] = s.get("span_id")
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        ev = {
            "ph": "X", "pid": HOST_PID, "tid": tid,
            "ts": (s["start"] - t0_s) * 1e6,
            "dur": max(s["duration"] * 1e6, 0.001),
            "name": s["name"], "args": args,
        }
        try:
            tag = int(args.get("trace_tag", 0) or 0)
        except (TypeError, ValueError):
            tag = 0
        if tag:
            host_tags.setdefault(tag, []).append(ev)
        trace_events.append(ev)
    if span_rows:
        trace_events = _meta(HOST_PID, "host (tracer spans)") + trace_events
        for subsystem, tid in sorted(host_tids.items(), key=lambda kv: kv[1]):
            trace_events += _meta(HOST_PID, "", tid=tid, tname=subsystem)

    # Flow arrows: for every tag seen on BOTH sides, start at the first
    # host span, step through the device instants (each also gets a thin
    # X slice so the arrow has a slice to bind to — flows attach to
    # enclosing slices, and "i" instants are not slices), finish at the
    # last host span (or the last device instant when the settle span is
    # missing from the ring).  One-sided tags degrade to annotations.
    n_flow = n_orphan_host = n_orphan_device = 0
    for tag in sorted(set(host_tags) | set(device_tags)):
        hs = sorted(host_tags.get(tag, ()), key=lambda e: e["ts"])
        ds = sorted(device_tags.get(tag, ()), key=lambda e: e["ts"])
        if not ds:
            n_orphan_host += 1
            for ev in hs:
                ev["args"]["flow_orphan"] = "no_device_event"
            continue
        for ev in ds:  # thin slice under each tagged instant (bind point)
            trace_events.append({
                "ph": "X", "pid": SIM_PID, "tid": ev["tid"],
                "ts": ev["ts"], "dur": max(eff_tick_us * 0.5, 0.001),
                "name": ev["name"], "args": dict(ev["args"]),
            })
        if not hs:
            n_orphan_device += 1
            for ev in ds:
                ev["args"]["flow_orphan"] = "no_host_span"
            continue
        flow = {"cat": "trace_tag", "name": "causal", "id": tag}
        chain = []
        first = hs[0]
        chain.append({"ph": "s", "pid": first["pid"], "tid": first["tid"],
                      "ts": first["ts"] + first["dur"] * 0.5, **flow})
        for ev in ds:
            chain.append({"ph": "t", "pid": ev["pid"], "tid": ev["tid"],
                          "ts": ev["ts"], "bp": "e", **flow})
        for ev in hs[1:]:
            chain.append({"ph": "t", "pid": ev["pid"], "tid": ev["tid"],
                          "ts": ev["ts"] + ev["dur"] * 0.5, "bp": "e",
                          **flow})
        chain[-1]["ph"] = "f"
        trace_events += chain
        n_flow += len(chain)
    _publish_flow_metrics(n_flow, n_orphan_host, n_orphan_device)

    # Counter tracks: Perfetto draws one area chart per (pid, name) "C"
    # series; tid 0 keeps them pinned under the sim process header.  Rows
    # are emitted in (name, tick) order so each track's timestamps are
    # monotonic (the validator enforces this).
    for c in sorted(counters, key=lambda c: (str(c["name"]), c["tick"])):
        trace_events.append({
            "ph": "C", "pid": SIM_PID, "tid": 0,
            "ts": tick_ts(c["tick"]),
            "name": f"telemetry.{c['name']}",
            "args": {"value": float(c["value"])},
        })

    out = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if fit is not None:
        out["metadata"] = {"clock_fit": fit.to_dict()}
    return out


def validate_chrome_trace(trace: dict) -> list[str]:
    """Schema problems (empty = valid).  Checks the JSON-object format:
    a traceEvents array whose members carry ph/pid/tid/name, numeric
    ts (+dur for X phases), and JSON-serializable args.  Counter ("C")
    events additionally need numeric ts, an args object of numeric
    values, non-decreasing timestamps per (pid, name) track, and one
    track (pid, tid) per counter name — a name split across tids renders
    as two half-empty charts in Perfetto.  Flow events (s/t/f) need a
    numeric ts and an id, and every flow id must both start ("s") and
    terminate ("f") — a dangling flow renders as an arrow into nowhere."""
    problems: list[str] = []
    if not isinstance(trace, dict):
        return ["trace must be a JSON object"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be an array"]
    counter_last_ts: dict[tuple, float] = {}
    counter_tid: dict[tuple, object] = {}
    flow_phases: dict[object, set] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event #{i} is not an object")
            continue
        missing = _REQUIRED_EVENT_KEYS - e.keys()
        if missing:
            problems.append(f"event #{i} missing keys {sorted(missing)}")
            continue
        if e["ph"] not in ("i", "X", "M", "B", "E", "C") + _FLOW_PHASES:
            problems.append(f"event #{i} has unknown phase {e['ph']!r}")
        if e["ph"] in ("i", "X", "C") + _FLOW_PHASES and not isinstance(
                e.get("ts"), (int, float)):
            problems.append(f"event #{i} ({e['ph']}) lacks numeric ts")
        if e["ph"] == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event #{i} (X) lacks numeric dur")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"event #{i} args is not an object")
        if e["ph"] in _FLOW_PHASES:
            if "id" not in e:
                problems.append(f"event #{i} ({e['ph']}) flow lacks an id")
            else:
                flow_phases.setdefault(e["id"], set()).add(e["ph"])
        if e["ph"] == "C" and isinstance(e.get("args"), dict) \
                and isinstance(e.get("ts"), (int, float)):
            bad = [k for k, v in e["args"].items()
                   if not isinstance(v, (int, float)) or isinstance(v, bool)]
            if bad:
                problems.append(f"event #{i} (C) has non-numeric counter "
                                f"values {sorted(bad)}")
            track = (e["pid"], e["name"])
            prev = counter_last_ts.get(track)
            if prev is not None and e["ts"] < prev:
                problems.append(
                    f"event #{i} (C) timestamp {e['ts']} goes backwards on "
                    f"counter track {e['name']!r} (prev {prev})")
            counter_last_ts[track] = e["ts"]
            seen_tid = counter_tid.setdefault(track, e["tid"])
            if seen_tid != e["tid"]:
                problems.append(
                    f"event #{i} (C) counter {e['name']!r} spans tids "
                    f"{seen_tid!r} and {e['tid']!r}; one track per series")
    for fid, phases in sorted(flow_phases.items(), key=lambda kv: str(kv[0])):
        for need in ("s", "f"):
            if need not in phases:
                problems.append(f"flow id {fid!r} never emits "
                                f"{'start' if need == 's' else 'finish'} "
                                f"({need!r}); arrows would dangle")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        problems.append(f"trace is not JSON-serializable: {exc}")
    return problems


def export_record(rec, path: str, tick_us: float = 1.0) -> dict:
    """FlightRecord -> chrome trace JSON file; returns the trace dict.
    A record carrying clock sync points (FlightRecord.clock) exports on
    the fused wall-clock axis automatically."""
    trace = to_chrome_trace(rec.events, rec.spans, tick_us=tick_us,
                            counters=getattr(rec, "counters", ()),
                            clock=getattr(rec, "clock", None))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, indent=1)
    return trace
