"""Dependency-free metrics registry: Counter / Gauge / Histogram with
labels and Prometheus text exposition.

Reference: the prometheus client the Go codebase hangs its collectors on
(manager/metrics/collector.go, manager/state/raft/raft.go:69-71).  The
port's copy of the JAX package's registry, unchanged: its typed families
render through :func:`swarmkit_tpu_torch.metrics.exposition.render_all`.

Every metric family has mandatory help text (enforced — the lint in
tools/metrics_lint.py walks registries and the catalog), and label
cardinality is bounded per family so an instrumentation bug (e.g. a
session id used as a label) fails loudly instead of leaking memory.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default histogram bucket upper bounds (seconds): the prometheus client
# defaults, which bracket everything from sub-ms store commits to multi-
# second XLA compiles.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Per-family bound on distinct label-value sets.  Generous for real usage
# (peers in a quorum, transport wires, kernel phases) but small enough that
# an unbounded label (task ids, timestamps) trips it within one test run.
MAX_LABEL_SETS = 256

# Label-value every over-cap series collapses into (non-strict registries).
OVERFLOW_LABEL_VALUE = "~overflow~"


class MetricError(Exception):
    """Registration or usage error (duplicate/conflicting family, bad
    name, missing help text)."""


class LabelCardinalityError(MetricError):
    """A family exceeded MAX_LABEL_SETS distinct label-value sets."""


def escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def escape_help(v: str) -> str:
    """HELP-line escaping per the 0.0.4 text format: backslash and
    newline only (quotes stay literal in HELP, unlike label values)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    if v != v:                      # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_suffix(label_names: Sequence[str], label_values: Sequence[str]
                   ) -> str:
    if not label_names:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in zip(label_names, label_values))
    return "{" + inner + "}"


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters only go up")
        self._value += amount


class GaugeChild(_Child):
    __slots__ = ("_value", "_fn")

    def __init__(self) -> None:
        super().__init__()
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._fn = None
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._fn = None
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Lazily computed gauge: `fn` is called at collection time.  A
        raising callback reads as the last set value — scrapes must never
        take a component down."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                self._value = float(self._fn())
            except Exception:
                pass
        return self._value


class HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        self.buckets = buckets          # sorted upper bounds, no +Inf
        self.counts = [0] * (len(buckets) + 1)   # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def observe_bucket(self, index: int, count: int = 1,
                       value: Optional[float] = None) -> None:
        """Bulk-merge `count` pre-bucketed observations into bucket
        `index` (len(buckets) = overflow).  For publishers whose source
        is already a bucketed device histogram (telemetry plane): the
        per-observation values are gone, so `sum` is approximated by the
        bucket's upper edge unless the caller supplies a better `value`
        per observation."""
        if not 0 <= index < len(self.counts):
            raise MetricError(
                f"bucket index {index} out of range 0..{len(self.counts) - 1}")
        if count < 0:
            raise MetricError("histogram bucket counts only go up")
        self.counts[index] += count
        self.count += count
        if value is None:
            value = self.buckets[min(index, len(self.buckets) - 1)]
        self.sum += count * float(value)

    def cumulative(self) -> list[int]:
        out, running = [], 0
        for c in self.counts:
            running += c
            out.append(running)
        return out

    def time(self) -> "_HistogramTimer":
        """Context manager: observe the wall-clock duration of a block."""
        return _HistogramTimer(self)


class MetricFamily:
    """One named metric with a fixed label schema and N children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = (),
                 max_label_sets: int = MAX_LABEL_SETS,
                 strict: bool = False) -> None:
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name {name!r}")
        if not help or not help.strip():
            raise MetricError(f"metric {name!r} needs non-empty help text")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise MetricError(f"invalid label name {ln!r} on {name!r}")
        self.name = name
        self.help = help.strip()
        self.label_names = tuple(label_names)
        self.max_label_sets = max_label_sets
        self.strict = strict
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"schema is {sorted(self.label_names)}")
        key = tuple(str(labels[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= self.max_label_sets:
                        if self.strict:
                            raise LabelCardinalityError(
                                f"{self.name}: more than "
                                f"{self.max_label_sets} label sets — "
                                f"unbounded label value?")
                        # Non-strict (production default): a cardinality
                        # bug degrades the data, never the instrumented
                        # component — excess series collapse into one
                        # reserved overflow series.
                        key = (OVERFLOW_LABEL_VALUE,) * len(self.label_names)
                        child = self._children.get(key)
                        if child is None:
                            child = self._children[key] = self._new_child()
                        return child
                    child = self._children[key] = self._new_child()
        return child

    def _default(self):
        """The label-less series (only valid when the schema is empty)."""
        if self.label_names:
            raise MetricError(f"{self.name} has labels "
                              f"{self.label_names}; use .labels()")
        return self.labels()

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    # -- exposition --------------------------------------------------------
    def header(self) -> list[str]:
        return [f"# HELP {self.name} {escape_help(self.help)}",
                f"# TYPE {self.name} {self.kind}"]

    def sample_lines(self) -> list[str]:
        out = []
        for key in sorted(self._children):
            child = self._children[key]
            out.append(f"{self.name}{_labels_suffix(self.label_names, key)} "
                       f"{format_value(child.value)}")
        return out

    def render(self) -> list[str]:
        return self.header() + self.sample_lines()

    def snapshot(self):
        if not self.label_names:
            c = self._children.get(())
            return c.value if c is not None else 0.0
        return {",".join(f"{k}={v}" for k, v in zip(self.label_names, key)):
                child.value for key, child in sorted(self._children.items())}


class Counter(MetricFamily):
    kind = "counter"

    def _new_child(self) -> CounterChild:
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(MetricFamily):
    kind = "gauge"

    def _new_child(self) -> GaugeChild:
        return GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 max_label_sets: int = MAX_LABEL_SETS,
                 strict: bool = False) -> None:
        super().__init__(name, help, label_names,
                         max_label_sets=max_label_sets, strict=strict)
        b = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not b:
            raise MetricError(f"{name}: histogram needs at least one bucket")
        if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise MetricError(f"{name}: bucket edges must strictly increase")
        self.buckets = b

    def _new_child(self) -> HistogramChild:
        return HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def observe_bucket(self, index: int, count: int = 1,
                       value: Optional[float] = None) -> None:
        self._default().observe_bucket(index, count, value)

    def time(self):
        """Context manager: observe the wall-clock duration of a block on
        the label-less series."""
        return _HistogramTimer(self._default())

    def sample_lines(self) -> list[str]:
        out = []
        for key in sorted(self._children):
            child = self._children[key]
            cum = child.cumulative()
            for edge, c in zip(self.buckets, cum):
                lk = _labels_suffix(self.label_names + ("le",),
                                    key + (format_value(edge),))
                out.append(f"{self.name}_bucket{lk} {c}")
            lk = _labels_suffix(self.label_names + ("le",), key + ("+Inf",))
            out.append(f"{self.name}_bucket{lk} {cum[-1]}")
            ls = _labels_suffix(self.label_names, key)
            out.append(f"{self.name}_sum{ls} {format_value(child.sum)}")
            out.append(f"{self.name}_count{ls} {child.count}")
        return out

    def snapshot(self):
        def one(child):
            return {"count": child.count, "sum": round(child.sum, 6)}
        if not self.label_names:
            c = self._children.get(())
            return one(c) if c is not None else {"count": 0, "sum": 0.0}
        return {",".join(f"{k}={v}" for k, v in zip(self.label_names, key)):
                one(child) for key, child in sorted(self._children.items())}


class _HistogramTimer:
    __slots__ = ("_child", "_start")

    def __init__(self, child: HistogramChild) -> None:
        self._child = child
        self._start = 0.0

    def __enter__(self) -> "_HistogramTimer":
        import time
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import time
        self._child.observe(time.perf_counter() - self._start)


class MetricsRegistry:
    """Process- or component-scoped collection of metric families.

    ``counter/gauge/histogram`` are get-or-create: re-registering the same
    (name, kind, labels) schema returns the existing family so independent
    components can share series; a conflicting schema raises MetricError.
    """

    def __init__(self, strict: bool = False) -> None:
        # strict: label-cardinality overflow raises instead of collapsing
        # into the overflow series (tests and the lint opt in).
        self.strict = strict
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str,
                       label_names: Sequence[str], **kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (type(fam) is not cls
                        or fam.label_names != tuple(label_names)):
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, requested "
                        f"{cls.kind}{tuple(label_names)}")
                return fam
            fam = cls(name, help, label_names, strict=self.strict, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not Histogram \
                        or fam.label_names != tuple(labels):
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}")
                return fam
            fam = Histogram(name, help, labels, buckets=buckets,
                            strict=self.strict)
            self._families[name] = fam
            return fam

    # -- views -------------------------------------------------------------
    def families(self) -> Iterable[MetricFamily]:
        return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[MetricFamily]:
        return self._families.get(name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able {name: value | {labelset: value}} view (the
        BENCH_*.json-compatible dump)."""
        return {fam.name: fam.snapshot() for fam in self.families()}

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


# The process-global default: kernel/bench/tool metrics land here; per-node
# components take a registry argument and fall back to this.
DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT
