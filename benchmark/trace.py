"""The traced run: two units of traffic after the window, and what the
per-layer readers read.

The traced run's window runs as any other, unprofiled.  Once it has
closed, ``Profiler.run`` drives two more units of the same mix (the
mix's ``trace_ticks`` proposing ticks, or a crash cycle with its
outage): the first timed by CUDA events alone (the twin), the second
under ``torch.profiler`` with CUDA events around it, the tick's phase
ranges on (``kernel.PHASE_RANGES``: profiler ranges that add no launch)
and each call of a hand kernel recorded with its masks (the slice).  So
no reading of the window runs in the profiler's wake.  The arithmetic is
that of the repo's ``swarmkit_tpu_torch/tools/profile_tick.py``, copied
here so that a change to the program cannot change the yardstick: device
time by kernel from the profiler, phase device time from the ranges, and
the busy share over the CUDA-event wall of an unprofiled unit (the
twin's: the profiler stretches the host's gaps).

``context`` hands each reader (``metrics/<name>.py``) one dict:

- ``window``: the window's readings (seconds, ticks, committed,
  offered, reads, blocked, failovers, tick_ms);
- ``counts``: the program's counters over the window
  (``kernel.COUNTS``: host_syncs, slab_ticks, dense_fallback_ticks);
- ``failovers``: [(seconds, ticks)] of each crash in the window;
- ``slice``: ``ticks``, ``wall_s`` (CUDA events), ``kernels`` and
  ``device_ops`` (memcpy and memset) as [(name, start_us, end_us,
  device)], ``host`` (host operations, [(name, start_us, end_us)]),
  ``phases`` {range name: device µs}, ``calls`` {hand kernel wrapper:
  [argument list]} (a mask as ("mask", elements, set elements), another
  tensor as (shape, dtype)), ``twin_ticks`` and ``twin_wall_s``; or
  None in a run without a trace;
- ``card``: the card's name; ``peaks``: its entry of ``peaks.json`` or
  None.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch

# the profiler ranges the tick opens (profile_tick.py's PHASE_PREFIXES):
# they also appear on the device's timeline, and are no kernels
PHASE_PREFIXES = ("phase_", "phases_", "tick_end", "obs_planes")
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def _device_total_us(evt) -> float:
    """Device time of the kernels launched inside a profiler range, in µs
    (the attribute was renamed from *_cuda_* to *_device_* across torch
    releases)."""
    v = getattr(evt, "device_time_total", None)
    return float(v if v is not None else evt.cuda_time_total)


class CallRecorder:
    """Wraps each hand kernel's wrapper in `ops` (those named in its
    LAUNCHES) and keeps every call's arguments: bool tensors (masks) by
    reference until `summary`, other tensors as (shape, dtype)."""

    def __init__(self, ops):
        self.ops, self.calls, self.saved = ops, {}, {}
        for name in ops.LAUNCHES:
            fn = getattr(ops, name, None)
            if callable(fn):
                self.saved[name] = fn
                setattr(ops, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            self.calls.setdefault(name, []).append([
                a if isinstance(a, torch.Tensor) and a.dtype == torch.bool
                else (tuple(a.shape), a.dtype)
                if isinstance(a, torch.Tensor) else a for a in args])
            return fn(*args, **kw)
        return wrapper

    def restore(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def summary(self) -> dict:
        """The calls with each mask as ("mask", elements, set elements),
        counted once the slice has closed (the counts launch reductions)."""
        return {name: [[("mask", a.numel(), int(a.sum()))
                        if isinstance(a, torch.Tensor) else a for a in args]
                       for args in calls]
                for name, calls in self.calls.items()}


class Profiler:
    """Times one unit of the mix with CUDA events alone (`twin`), then
    profiles the next (`slice`), both after the window (`run`); `finish`
    reads the profile."""

    def __init__(self, driver, kernel, ops):
        self.driver, self.kernel, self.ops = driver, kernel, ops
        self.twin_ticks = self.twin_wall_s = None
        self.data = None
        self._raw = None

    def run(self) -> None:
        self.driver.unit(profile=self.twin)
        self.driver.unit(profile=self.slice)

    def _events(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        return start, end

    @contextmanager
    def twin(self):
        start, end = self._events()
        tick0 = self.driver.tick
        start.record()
        yield
        end.record()
        self.driver.sync()
        self.twin_ticks = self.driver.tick - tick0
        self.twin_wall_s = start.elapsed_time(end) / 1e3

    @contextmanager
    def slice(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        start, end = self._events()
        rec = CallRecorder(self.ops)
        tick0 = self.driver.tick
        self.kernel.PHASE_RANGES = True
        try:
            with torch.profiler.profile(activities=acts) as prof:
                start.record()
                yield
                end.record()
                self.driver.sync()
        finally:
            self.kernel.PHASE_RANGES = False
            rec.restore()
        self._raw = (prof, self.driver.tick - tick0,
                     start.elapsed_time(end) / 1e3, rec.summary())

    def finish(self) -> dict | None:
        if self._raw is not None and self.data is None:
            self.data = _read_profile(*self._raw)
            self.data.update(twin_ticks=self.twin_ticks,
                             twin_wall_s=self.twin_wall_s)
            self._raw = None
        return self.data


def _read_profile(prof, ticks: int, wall_s: float, calls: dict) -> dict:
    kernels, copies, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(PHASE_PREFIXES) \
                    or getattr(e, "is_user_annotation", False):
                continue
            (copies if e.name.startswith(COPY_PREFIXES) else kernels) \
                .append((e.name, float(tr.start), float(tr.end),
                         int(e.device_index)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    phases = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.key.startswith(PHASE_PREFIXES):
            phases[e.key] = _device_total_us(e)
    return {"ticks": ticks, "wall_s": wall_s, "kernels": kernels,
            "device_ops": copies, "host": host, "phases": phases,
            "calls": calls}


def busy_intervals(sl: dict, device=None) -> list:
    """The union of the slice's device intervals (kernels, copies) on
    `device` (every device's, merged, where None), as sorted disjoint
    (start_us, end_us)."""
    spans = sorted((s, e) for _, s, e, d in sl["kernels"] + sl["device_ops"]
                   if device is None or d == device)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(sl: dict) -> float:
    """Seconds in which some operation ran, averaged over the devices
    the slice ran on."""
    devices = {d for *_, d in sl["kernels"] + sl["device_ops"]}
    if not devices:
        return 0.0
    return sum(e - s for d in devices
               for s, e in busy_intervals(sl, d)) / 1e6 / len(devices)


def breakdown(sl: dict, top: int = 10) -> dict:
    """Device time by phase range and by kernel (at most `top` entries),
    and the longest idle gaps named by the innermost host operation
    running at their middle."""
    phases = sorted(sl["phases"].items(), key=lambda kv: -kv[1])
    by_kernel: dict = {}
    for name, s, e, _ in sl["kernels"]:
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
    kern = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    n_ph = min(len(phases), top // 2 + top % 2)
    ops = [[k, v / 1e6] for k, v in phases[:n_ph]] \
        + [[k[:120], v / 1e6] for k, v in kern[:top - n_ph]]
    spans = busy_intervals(sl)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(spans, spans[1:])), reverse=True)[:top]
    host = sl["host"]
    idle = []
    for width, mid in gaps:
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner else "(none)"
        idle.append([name[:120], width / 1e6])
    return {"device_ops": ops, "idle_gaps": idle}


def context(window: dict, counts: dict, profiler, card: str,
            peaks: dict | None) -> dict:
    return {"window": window, "counts": counts,
            "failovers": window["failovers"],
            "slice": profiler.finish() if profiler is not None else None,
            "card": card, "peaks": peaks}
