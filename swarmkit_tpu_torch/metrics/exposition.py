"""Merged Prometheus text exposition across the port's three metric
surfaces.

A manager scrape shows one coherent page built from:

1. the typed registry (:mod:`swarmkit_tpu_torch.metrics.registry`) —
   counters, gauges, histograms declared through the catalog;
2. the latency timers (:mod:`swarmkit_tpu_torch.utils.metrics`) — rendered
   as Prometheus *summaries* (quantile series from the reservoir, plus
   exact ``_sum``/``_count``), keeping their reference-compatible names;
3. the store-object gauges (``manager.metrics.Collector.snapshot()``) —
   rendered as plain gauges.

:func:`render_all` is what ``Manager.metrics_text()`` and the gRPC
``swarmkit.Metrics/Scrape`` service serve; :func:`snapshot_all` is the
JSON-able equivalent, and :func:`parse_text` reads a page back (a scrape
client's check that the page holds the 0.0.4 format).  When a tracer is
passed, the page ends with a recent-events comment section (finished
spans and the newest flight recorder captures): comments are
format-legal, so scrapers ignore the section while a human reading the
page sees the last few interesting things that happened.  The page is
the JAX package's, family for family.
"""

from __future__ import annotations

import re
from typing import Optional

from .registry import MetricsRegistry, escape_help, format_value

_QUANTILES = ((50, "0.5"), (90, "0.9"), (99, "0.99"))

RECENT_EVENT_LIMIT = 16


def render_timers(legacy_registry) -> str:
    """Render a utils.metrics.Registry's timers as summary families."""
    lines: list[str] = []
    snap = getattr(legacy_registry, "_timers", {})
    for name in sorted(snap):
        t = snap[name]
        lines.append(f"# HELP {name} Latency timer "
                     f"(reservoir quantiles over recent observations).")
        lines.append(f"# TYPE {name} summary")
        for p, q in _QUANTILES:
            lines.append(f'{name}{{quantile="{q}"}} '
                         f"{format_value(t.percentile(p))}")
        lines.append(f"{name}_sum {format_value(t.sum)}")
        lines.append(f"{name}_count {t.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_plain_gauges(gauges: dict, help_prefix: str = "Cluster object "
                        "gauge maintained by the store-event collector."
                        ) -> str:
    lines: list[str] = []
    for name in sorted(gauges):
        lines.append(f"# HELP {name} {escape_help(help_prefix)}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {format_value(gauges[name])}")
    return "\n".join(lines) + ("\n" if lines else "")


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
               legacy_registry=None,
               collector_gauges: Optional[dict] = None,
               tracer=None) -> str:
    parts = []
    if registry is not None:
        parts.append(registry.render())
    if legacy_registry is not None:
        parts.append(render_timers(legacy_registry))
    if collector_gauges:
        parts.append(render_plain_gauges(collector_gauges))
    if tracer is not None:
        parts.append(render_recent_events(tracer))
    return "".join(p for p in parts if p)


def snapshot_all(registry: Optional[MetricsRegistry] = None,
                 legacy_registry=None,
                 collector_gauges: Optional[dict] = None,
                 tracer=None) -> dict:
    out: dict = {}
    if registry is not None:
        out["metrics"] = registry.snapshot()
    if legacy_registry is not None:
        out["timers"] = legacy_registry.snapshot()
    if collector_gauges is not None:
        out["objects"] = dict(collector_gauges)
    if tracer is not None:
        out["spans"] = tracer.snapshot()
        out["recent_events"] = recent_events(tracer)
    return out


_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|\Z)')
_SUFFIXES = {"counter": (), "gauge": (), "untyped": (),
             "histogram": ("_bucket", "_sum", "_count"),
             "summary": ("_sum", "_count")}


def _parse_labels(block: str, line: str) -> tuple:
    out, pos = [], 0
    while pos < len(block):
        m = _LABEL.match(block, pos)
        if m is None:
            raise ValueError(f"bad label set: {line!r}")
        out.append((m.group(1), m.group(2)))
        pos = m.end()
    if len({k for k, _ in out}) != len(out):
        raise ValueError(f"a label repeated: {line!r}")
    return tuple(out)


def parse_text(text: str) -> dict[str, dict]:
    """Read a Prometheus 0.0.4 text page back: ``{family: {"type", "help",
    "samples": {(series name, ((label, value), ...)): value}}}``.  Raises
    ValueError where the page breaks the format: a sample outside the
    family its last TYPE line opened or under a name that family cannot
    have, a family declared twice, a series repeated, a bad label set or
    value.  Other comment lines (the recent-events section) are skipped."""
    fams: dict[str, dict] = {}
    cur: Optional[str] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if not _NAME.match(name):
                    raise ValueError(f"bad family name: {line!r}")
                fam = fams.setdefault(name, {"type": None, "help": None,
                                             "samples": {}})
                key = parts[1].lower()
                if fam[key] is not None or fam["samples"]:
                    raise ValueError(f"family {name} declared twice")
                rest = parts[3] if len(parts) > 3 else ""
                if key == "type" and rest not in _SUFFIXES:
                    raise ValueError(f"unknown type: {line!r}")
                fam[key] = rest
                cur = name
            continue
        head, _, value = line.rpartition(" ")
        labels: tuple = ()
        if "{" in head:
            if not head.endswith("}"):
                raise ValueError(f"bad sample: {line!r}")
            name, _, block = head[:-1].partition("{")
            labels = _parse_labels(block, line)
        else:
            name = head
        try:
            val = float(value)
        except ValueError:
            raise ValueError(f"bad value: {line!r}") from None
        fam = fams.get(cur) if cur is not None else None
        if fam is None or fam["type"] is None or name not in [
                cur + s for s in ("",) + _SUFFIXES[fam["type"]]]:
            raise ValueError(f"sample outside its family: {line!r}")
        if (name, labels) in fam["samples"]:
            raise ValueError(f"series repeated: {line!r}")
        fam["samples"][(name, labels)] = val
    for name, fam in fams.items():
        if fam["type"] is None:
            raise ValueError(f"family {name} has no TYPE line")
    return fams
