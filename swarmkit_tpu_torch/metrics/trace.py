"""Lightweight structured trace/event layer.

Spans are cheap structured events — not a distributed tracer.  A span has a
hex id, an optional parent, a name, attributes, and wall-clock bounds; the
current span propagates through ``contextvars`` so async call chains (raft
proposal -> transport send, dispatcher session -> heartbeat) pick up their
parent automatically, and span ids can be carried across process hops as
plain strings in message payloads.

Finished spans land in a bounded ring per :class:`Tracer`; tests and
``Manager.metrics_snapshot()`` read them back with :meth:`Tracer.finished`.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

_SPAN_COUNTER = itertools.count(1)
_CURRENT_SPAN: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("swarmkit_current_span", default=None)

MAX_FINISHED_SPANS = 512


def _new_span_id() -> str:
    # Counter-based, not random: ids only need uniqueness within a process
    # lifetime, and determinism keeps seed-pinned test output stable.
    return f"{next(_SPAN_COUNTER):012x}"


@dataclass
class Span:
    name: str
    span_id: str
    parent_id: Optional[str]
    start: float
    end: Optional[float] = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration": self.duration,
            "attrs": dict(self.attrs),
        }


def current_span() -> Optional[Span]:
    return _CURRENT_SPAN.get()


def current_span_id() -> Optional[str]:
    s = _CURRENT_SPAN.get()
    return s.span_id if s is not None else None


class Tracer:
    """Collects finished spans into a bounded ring."""

    def __init__(self, maxlen: int = MAX_FINISHED_SPANS) -> None:
        self._finished: deque[Span] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def start(self, name: str, parent_id: Optional[str] = None,
              **attrs) -> Span:
        """Start a span.  Parent resolution order: explicit ``parent_id``
        (e.g. one carried in from a remote message), else the contextvar."""
        if parent_id is None:
            parent_id = current_span_id()
        return Span(name=name, span_id=_new_span_id(), parent_id=parent_id,
                    start=time.time(), attrs=dict(attrs))

    def finish(self, span: Span) -> Span:
        if span.end is None:
            span.end = time.time()
        with self._lock:
            self._finished.append(span)
        return span

    def span(self, name: str, parent_id: Optional[str] = None, **attrs
             ) -> "_SpanCtx":
        """Context manager: start a span, make it current for the duration
        of the block, finish it on exit (recording exceptions)."""
        return _SpanCtx(self, name, parent_id, attrs)

    def finished(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def snapshot(self) -> list[dict]:
        return [s.to_dict() for s in self.finished()]

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_parent_id", "_attrs", "_span",
                 "_token")

    def __init__(self, tracer: Tracer, name: str, parent_id: Optional[str],
                 attrs: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._parent_id = parent_id
        self._attrs = attrs

    def __enter__(self) -> Span:
        self._span = self._tracer.start(self._name, self._parent_id,
                                        **self._attrs)
        self._token = _CURRENT_SPAN.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        _CURRENT_SPAN.reset(self._token)
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.finish(self._span)


def span_trace_tag(span) -> int:
    """Device-register form of a span id: a nonzero positive int32.

    The trace-tag rings (SimConfig.trace_tags) carry one i32 lane, so the
    12-hex span id is folded to 31 bits with the sign bit cleared (the
    kernel treats 0 as "untagged") and floored at 1.  Accepts a Span or a
    bare span-id string (the cross-process form).  The export layer
    (flightrec/export.py) applies the same fold to host span ids when
    matching flow events, so collisions only blur which of two
    simultaneous in-flight batches an arrow points at — never safety.
    """
    sid = span.span_id if isinstance(span, Span) else span
    return max(int(sid, 16) & 0x7FFFFFFF, 1)


# Process-global tracer, mirroring registry.DEFAULT.
DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return DEFAULT


def iter_ancestry(spans: list[Span], leaf: Span) -> Iterator[Span]:
    """Walk parent links through a finished-span list (test helper)."""
    by_id = {s.span_id: s for s in spans}
    cur: Optional[Span] = leaf
    while cur is not None:
        yield cur
        cur = by_id.get(cur.parent_id) if cur.parent_id else None
