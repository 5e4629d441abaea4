"""Prometheus text exposition of the port's metrics, with a recent-events
section.

:func:`render_all` renders the typed registry
(:mod:`swarmkit_tpu_torch.metrics.registry`: counters, gauges and
histograms declared through the catalog); :func:`snapshot_all` is its
JSON-able equivalent.  When a tracer is passed, the page ends with a
recent-events comment section (finished spans and the newest flight
recorder captures): comments are format-legal, so scrapers ignore the
section while a human reading the page sees the last few interesting
things that happened.  The JAX package's exposition, without the surfaces
the port does not have (legacy latency timers, store-object gauges).
"""

from __future__ import annotations

from typing import Optional

from .registry import MetricsRegistry, escape_help

RECENT_EVENT_LIMIT = 16


def recent_events(tracer=None, limit: int = RECENT_EVENT_LIMIT
                  ) -> list[dict]:
    """The scrape page's recent-events feed: the newest finished tracer
    spans merged with the newest flight-recorder capture summaries (both
    JSON-able dicts, newest last)."""
    out: list[dict] = []
    if tracer is not None:
        for s in tracer.finished()[-limit:]:
            d = s.to_dict()
            d["source"] = "span"
            out.append(d)
    try:
        from swarmkit_tpu_torch.flightrec import record as flight_record
        out += flight_record.recent_capture_events(limit)
    except Exception:
        pass  # a flightrec problem must never break the scrape page
    return out[-limit:] if limit else out


def render_recent_events(tracer=None, limit: int = RECENT_EVENT_LIMIT
                         ) -> str:
    """Comment-only section ('# recent-event ...' lines): legal in the
    0.0.4 text format, invisible to scrapers, useful to humans."""
    events = recent_events(tracer, limit)
    if not events:
        return ""
    lines = ["# recent-events (newest last; spans + flightrec captures)"]
    for e in events:
        if e.get("source") == "span":
            dur = e.get("duration")
            dur_s = f"{dur * 1000:.3f}ms" if dur is not None else "open"
            desc = f"span {e['name']} {dur_s} attrs={e.get('attrs', {})}"
        else:
            desc = e.get("describe", str(e))
        lines.append("# recent-event " + escape_help(str(desc)))
    return "\n".join(lines) + "\n"


def render_all(registry: Optional[MetricsRegistry] = None,
               tracer=None) -> str:
    parts = []
    if registry is not None:
        parts.append(registry.render())
    if tracer is not None:
        parts.append(render_recent_events(tracer))
    return "".join(p for p in parts if p)


def snapshot_all(registry: Optional[MetricsRegistry] = None,
                 tracer=None) -> dict:
    out: dict = {}
    if registry is not None:
        out["metrics"] = registry.snapshot()
    if tracer is not None:
        out["spans"] = tracer.snapshot()
        out["recent_events"] = recent_events(tracer)
    return out
