"""Flight records: decoded events + provenance, savable and diffable.

`capture()` is the one funnel from a recorded SimState (and optionally
the host tracer) to a :class:`FlightRecord`; it also publishes the
``swarm_flightrec_*`` counters so every capture shows up on the scrape
page.  Records serialize as plain JSON (version-tagged, like the DST
repro artifacts), in the JAX package's format and version, so either
package's load_record (and the JAX package's tools/flight_view.py) reads
the other's records.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from swarmkit_tpu_torch.flightrec.decoder import FlightEvent, decode_rings

RECORD_VERSION = 1

# Newest captures, kept process-global so the Manager scrape page's
# recent-events section (metrics/exposition.py) can show what the last
# post-mortems saw without threading a registry through every tool.
_RECENT: deque = deque(maxlen=4)


def recent_capture_events(limit: int = 16) -> list[dict]:
    """JSON-able rows for the scrape page: the tail events of the newest
    captures, each tagged with its trigger.  A capture with no device
    events (e.g. a host-span-only scenario-failure dump) still shows as
    one summary row — a post-mortem must never be invisible."""
    out: list[dict] = []
    for rec in list(_RECENT):
        if not rec.events:
            meta = json.dumps(rec.meta, sort_keys=True) if rec.meta else ""
            out.append({"source": "flightrec", "trigger": rec.trigger,
                        "describe": f"flightrec[{rec.trigger}] "
                                    f"{len(rec.spans)} host span(s) {meta}"})
            continue
        for e in rec.window(limit):
            d = e.to_dict()
            d["source"] = "flightrec"
            d["trigger"] = rec.trigger
            d["describe"] = f"flightrec[{rec.trigger}] {e.describe()}"
            out.append(d)
    return out[-limit:] if limit else out


@dataclass
class FlightRecord:
    events: list[FlightEvent]
    dropped: list[int]                  # per-row overwritten-event counts
    n: int
    trigger: str = "manual"             # manual / dst_violation / scenario
    meta: dict = field(default_factory=dict)
    spans: list[dict] = field(default_factory=list)  # host tracer spans
    # telemetry counter samples: {"name", "tick", "value"} rows decoded
    # from the time-series ring (telemetry.decode_series), rendered as
    # Perfetto counter tracks by flightrec/export.py
    counters: list = field(default_factory=list)
    # tick<->wall-clock sync points (flightrec/clock.py ClockSync.to_dict
    # payload); lets the export remap device tracks onto the host span
    # timeline instead of the synthetic tick-as-µs axis
    clock: Optional[dict] = None

    def window(self, last: int = 40) -> list[FlightEvent]:
        """The most recent `last` events — the post-mortem view."""
        return self.events[-last:]

    def to_dict(self) -> dict:
        d = {"version": RECORD_VERSION, "n": self.n,
             "trigger": self.trigger, "meta": self.meta,
             "dropped": list(self.dropped),
             "events": [e.to_dict() for e in self.events],
             "spans": self.spans,
             "counters": self.counters}
        if self.clock is not None:
            d["clock"] = self.clock
        return d


def capture(state, *, trigger: str = "manual", meta: Optional[dict] = None,
            tracer=None, obs=None, cfg=None, clock=None) -> FlightRecord:
    """Decode `state`'s rings into a FlightRecord and publish metrics.

    Pass `cfg` (the SimConfig the state was built with) to also decode a
    telemetry-enabled state's time-series ring into counter rows, so the
    Perfetto export shows latency/throughput series next to the event
    instants.  Pass `clock` (a flightrec/clock.py ClockSync fed at the
    run loop's host<->device boundaries) to bake the tick<->wall-clock sync
    points into the record; its metrics publish alongside the capture
    counters."""
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.metrics import registry as obs_registry

    if state.ev_buf is None or state.ev_pos is None:
        raise ValueError("state carries no event ring "
                         "(SimConfig.record_events was off)")
    events, dropped = decode_rings(state.ev_buf, state.ev_pos)
    dropped = [int(d) for d in dropped]
    spans = ([s.to_dict() for s in tracer.finished()]
             if tracer is not None else [])
    counters: list = []
    if cfg is not None and getattr(state, "tel_series", None) is not None:
        from swarmkit_tpu_torch.telemetry import decode_series
        for name, points in sorted(decode_series(state, cfg).items()):
            counters += [{"name": name, "tick": t, "value": v}
                         for t, v in points]
    clock_dict = None
    if clock is not None:
        clock_dict = clock if isinstance(clock, dict) else clock.to_dict()
    rec = FlightRecord(events=events, dropped=dropped, n=len(dropped),
                       trigger=trigger, meta=dict(meta or {}), spans=spans,
                       counters=counters, clock=clock_dict)
    _RECENT.append(rec)

    obs = obs or obs_registry.DEFAULT
    if clock is not None and not isinstance(clock, dict):
        try:
            clock.publish(obs)
        except Exception:
            pass  # metrics must never cost the capture
    try:
        m_ev = catalog.get(obs, "swarm_flightrec_events_total")
        by_code: dict[str, int] = {}
        for e in events:
            by_code[e.name] = by_code.get(e.name, 0) + 1
        for name, count in sorted(by_code.items()):
            m_ev.labels(code=name).inc(count)
        total_drop = int(sum(rec.dropped))
        if total_drop:
            catalog.get(obs, "swarm_flightrec_dropped_total").inc(total_drop)
        catalog.get(obs, "swarm_flightrec_captures_total").labels(
            trigger=trigger).inc()
    except Exception:
        pass  # metrics must never cost the capture
    return rec


def save_record(rec: FlightRecord, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rec.to_dict(), f, indent=1, sort_keys=True)


def load_record(path: str) -> FlightRecord:
    with open(path, encoding="utf-8") as f:
        d = json.load(f)
    if d.get("version") != RECORD_VERSION:
        raise ValueError(f"unsupported flight-record version "
                         f"{d.get('version')!r} in {path}")
    events = [FlightEvent(tick=e["tick"], node=e["node"], code=e["code"],
                          arg0=e["arg0"], arg1=e["arg1"], seq=e["seq"],
                          tag=e.get("tag", 0))
              for e in d["events"]]
    return FlightRecord(events=events, dropped=list(d["dropped"]),
                        n=int(d["n"]), trigger=d.get("trigger", "manual"),
                        meta=d.get("meta", {}), spans=d.get("spans", []),
                        counters=d.get("counters", []),
                        clock=d.get("clock"))


def summarize(rec: FlightRecord, last: int = 20) -> str:
    """Human summary: per-code counts, drops, and the tail window."""
    by_code: dict[str, int] = {}
    for e in rec.events:
        by_code[e.name] = by_code.get(e.name, 0) + 1
    ticks = [e.tick for e in rec.events]
    lines = [f"flight record: {len(rec.events)} events across "
             f"{rec.n} nodes, trigger={rec.trigger}"]
    if ticks:
        lines.append(f"tick range: {min(ticks)}..{max(ticks)}")
    for name, count in sorted(by_code.items()):
        lines.append(f"  {name:<16} {count}")
    total_drop = sum(rec.dropped)
    if total_drop:
        worst = max(range(len(rec.dropped)), key=lambda i: rec.dropped[i])
        lines.append(f"  dropped (ring overwrote) {total_drop} events; "
                     f"worst row n{worst} lost {rec.dropped[worst]}")
    if rec.meta:
        lines.append("meta: " + json.dumps(rec.meta, sort_keys=True))
    if rec.events:
        lines.append(f"last {min(last, len(rec.events))} events:")
        lines += ["  " + e.describe() for e in rec.window(last)]
    if rec.spans:
        lines.append(f"host spans: {len(rec.spans)}")
    if rec.counters:
        series = sorted({c["name"] for c in rec.counters})
        lines.append(f"telemetry counters: {len(rec.counters)} samples "
                     f"across {len(series)} series ({', '.join(series)})")
    return "\n".join(lines)


def diff_records(a: FlightRecord, b: FlightRecord) -> str:
    """Where do two records diverge?  Compares the (tick, node, name,
    args) event streams and reports the first difference plus per-code
    count deltas — the tool for 'this seed passed, that seed failed'."""
    ka = [(e.tick, e.node, e.name, e.arg0, e.arg1) for e in a.events]
    kb = [(e.tick, e.node, e.name, e.arg0, e.arg1) for e in b.events]
    lines = [f"A: {len(ka)} events   B: {len(kb)} events"]
    counts: dict[str, list[int]] = {}
    for e in a.events:
        counts.setdefault(e.name, [0, 0])[0] += 1
    for e in b.events:
        counts.setdefault(e.name, [0, 0])[1] += 1
    for name in sorted(counts):
        ca, cb = counts[name]
        if ca != cb:
            lines.append(f"  {name:<16} A={ca} B={cb} (delta {cb - ca:+d})")
    first = next((i for i, (x, y) in enumerate(zip(ka, kb)) if x != y),
                 None)
    if first is None and len(ka) == len(kb):
        lines.append("streams are identical")
    else:
        i = first if first is not None else min(len(ka), len(kb))
        lines.append(f"first divergence at event #{i}:")
        lines.append("  A: " + (a.events[i].describe() if i < len(ka)
                                else "<end of record>"))
        lines.append("  B: " + (b.events[i].describe() if i < len(kb)
                                else "<end of record>"))
    return "\n".join(lines)
