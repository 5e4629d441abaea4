"""swarm_top on the port: a live console for manager metric snapshots.

    python -m swarmkit_tpu_torch.tools.swarm_top --demo [--n 16]
        [--interval 1.0] [--device cuda]
    python -m swarmkit_tpu_torch.tools.swarm_top --from snapA.json snapB.json
    python -m swarmkit_tpu_torch.tools.swarm_top --demo --once

The port's counterpart of the repo's tools/swarm_top.py, frame for frame:
a `top`-style view over metric snapshot dicts (a registry's `snapshot()`
as "metrics", plus optional objects, spans, recent events and the
fleet-health keys).  Dependency-free: curses when the terminal has it,
plain ANSI redraw otherwise, and ``--once`` prints a single frame and
exits.

Three data sources:

- ``--from FILE...`` — offline: each file is one manager's snapshot
  JSON (or one ``{manager name: snapshot}`` dict); re-read every poll,
  so pointing it at files a cluster rewrites gives a live view with no
  coupling to this process.
- ``--demo`` — in-process: a small quorum on the port's tick with
  KernelObs publishing into a private registry, plus a multi-raft fleet
  driven through the Router / FleetSource / SloEngine loop so the
  fleet-health panels light up, on the CUDA card (it raises without one
  unless --device cpu is given).
- importable — ``render_frame(snapshots)`` is pure: tests and other
  tools feed snapshot dicts straight in.

A snapshot may carry ``hottest`` (group indices from
``MultiRaftObs.hottest_groups``), ``slo_active`` (the SLO engine's
non-ok states) and ``alerts`` (recent burn-rate transition records);
render_frame shows them as a per-manager alerts block under the metric
rows.  Counter RATES (per second, with a sparkline over the last ~40
polls) come from deltas between polls, computed host-side in
``TopState``; the snapshots themselves stay cumulative.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SPARK = "▁▂▃▄▅▆▇█"
HISTORY = 40
# Families worth screen space, in display order; everything else is
# reachable via --filter.  (Prefixes are assembled, not literals, so
# metrics_lint's catalog cross-reference skips them.)
DEFAULT_FILTER = tuple("swarm_%s_" % s for s in (
    "kernel", "raft", "trace", "flightrec", "telemetry", "store",
    "transport", "multiraft", "slo"))


def sparkline(values, width: int = 16) -> str:
    """Unicode mini-graph of the last `width` values, scaled to max."""
    vals = [max(float(v), 0.0) for v in values][-width:]
    if not vals:
        return ""
    top = max(vals) or 1.0
    return "".join(SPARK[min(int(v / top * (len(SPARK) - 1) + 0.5),
                             len(SPARK) - 1)] for v in vals)


def _flatten(metrics: dict) -> dict:
    """snapshot_all()['metrics'] -> {series name: scalar}.  Labeled
    families become ``name{labels}`` rows; histogram children keep
    their count/sum pair as two rows."""
    out: dict[str, float] = {}

    def put(name, v):
        if isinstance(v, dict):
            if set(v) == {"count", "sum"}:   # histogram child
                out[f"{name}:count"] = float(v["count"])
                out[f"{name}:sum"] = float(v["sum"])
            else:                            # labeled family
                for labels, lv in v.items():
                    put(f"{name}{{{labels}}}", lv)
        else:
            out[name] = float(v)

    for name, v in (metrics or {}).items():
        put(name, v)
    return out


class TopState:
    """Poll-to-poll accumulator: keeps per-manager counter history so
    render_frame can show rates and sparklines.  Feed it one
    ``{manager: snapshot}`` dict per poll via observe()."""

    def __init__(self) -> None:
        self._prev: dict[str, tuple[float, dict]] = {}
        self.rates: dict[str, dict[str, list[float]]] = {}

    def observe(self, snapshots: dict, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for mgr, snap in snapshots.items():
            flat = _flatten(snap.get("metrics"))
            prev = self._prev.get(mgr)
            if prev is not None:
                t0, flat0 = prev
                dt = max(now - t0, 1e-9)
                hist = self.rates.setdefault(mgr, {})
                for name, v in flat.items():
                    d = v - flat0.get(name, 0.0)
                    if d < 0:       # reset/restart: drop the sample
                        continue
                    hist.setdefault(name, []).append(d / dt)
                    del hist[name][:-HISTORY]
            self._prev[mgr] = (now, flat)


def _matches(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def render_frame(snapshots: dict, state: TopState | None = None,
                 patterns=DEFAULT_FILTER, width: int = 100) -> str:
    """One full console frame (plain text, no escapes) for a
    ``{manager name: metrics_snapshot() dict}`` mapping."""
    lines = [f"swarm_top — {len(snapshots)} manager(s) — "
             + time.strftime("%H:%M:%S")]
    for mgr in sorted(snapshots):
        snap = snapshots[mgr] or {}
        flat = _flatten(snap.get("metrics"))
        leader = flat.get("swarm_raft_is_leader", 0.0) or any(
            v for k, v in flat.items()
            if k.startswith("swarm_raft_is_leader{"))
        spans = snap.get("spans") or []
        objects = snap.get("objects") or {}
        lines.append("")
        lines.append(f"== {mgr} "
                     + ("[LEADER] " if leader else "")
                     + f"spans={len(spans)} "
                     + " ".join(f"{k}={int(v)}"
                                for k, v in sorted(objects.items())[:4]))
        rows = [(k, v) for k, v in sorted(flat.items())
                if _matches(k, patterns)]
        hist = (state.rates.get(mgr, {}) if state else {})
        for name, v in rows:
            rate = hist.get(name, [])
            graph = sparkline(rate) if any(rate) else ""
            rate_s = f"{rate[-1]:10.1f}/s" if rate else " " * 12
            val_s = f"{v:14,.0f}" if v == int(v) else f"{v:14,.3f}"
            lines.append(f"  {name[:58]:<58}{val_s} {rate_s} {graph}")
        hottest = snap.get("hottest")
        if hottest:
            lines.append("  hottest groups: "
                         + " ".join(f"g{g}" for g in hottest))
        active = snap.get("slo_active")
        if active is not None:
            if active:
                lines.append(f"  SLO ALERTS ({len(active)} active):")
                for a in active[:8]:
                    lines.append(f"  !! {a['state'].upper():<5} "
                                 f"{a['slo']} group={a['group']}")
            else:
                lines.append("  SLO ALERTS: none — all objectives ok")
        for rec in (snap.get("alerts") or [])[-3:]:
            lines.append(
                f"  ⚠ scrape {rec['scrape']}: {rec['slo']} "
                f"g{rec['group']} {rec['from']}->{rec['to']} "
                f"(burn fast {rec['fast_burn']}x / slow "
                f"{rec['slow_burn']}x)")
        for ev in (snap.get("recent_events") or [])[-3:]:
            desc = ev.get("describe") or ev.get("name") or "?"
            lines.append(f"  • {str(desc)[: width - 4]}")
    return "\n".join(lines)


# ---------------------------------------------------------------- sources

def source_files(paths):
    """Poll function over snapshot JSON files (re-read each call)."""

    def poll() -> dict:
        out = {}
        for p in paths:
            try:
                with open(p, encoding="utf-8") as f:
                    d = json.load(f)
            except (OSError, ValueError) as e:
                out[p] = {"metrics": {},
                          "recent_events": [{"describe": f"unreadable: {e}"}]}
                continue
            # either one snapshot, or a {name: snapshot} bundle
            if "metrics" in d or "spans" in d:
                out[p] = d
            else:
                out.update(d)
        return out

    return poll


def source_demo(n: int = 16, burst: int = 8, groups: int = 4,
                device=None):
    """Poll function over an in-process quorum on the port's tick PLUS a
    small multi-raft fleet, on `device` (the card unless the caller asks
    for the CPU): each call advances a tick burst on both, publishes
    KernelObs / MultiRaftObs counters into private registries, and runs
    the fleet through FleetSource -> SloEngine so the alerts + heat
    panels render.  The fleet is deliberately offered ~4x its per-tick
    proposal capacity, so the router spills, one hot group heats up, and
    the spill_ratio SLO pages within a few polls — the demo shows the
    health plane FIRING, not just idle."""
    from swarmkit_tpu_torch import multiraft
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.metrics import registry as obs_registry
    from swarmkit_tpu_torch.multiraft.obs import MultiRaftObs
    from swarmkit_tpu_torch.raft.sim import (
        SimConfig, init_state, run_ticks, run_until_leader,
    )
    from swarmkit_tpu_torch.raft.sim.run import KernelObs
    from swarmkit_tpu_torch.slo import FleetSource, SloEngine

    dev = resolve_device(device)
    cfg = SimConfig(n=n, log_len=256, window=16, apply_batch=32,
                    max_props=16, keep=8, election_tick=10, seed=7,
                    collect_stats=True, read_batch=4)
    reg = obs_registry.MetricsRegistry()
    obs = KernelObs(obs=reg)
    fleet_cfg = SimConfig(n=5, log_len=128, window=16, apply_batch=16,
                          max_props=8, keep=8, election_tick=10, seed=7,
                          collect_stats=True, collect_telemetry=True)
    fleet_reg = obs_registry.MetricsRegistry()
    fleet_obs = MultiRaftObs(registry=fleet_reg)
    router = multiraft.Router(fleet_cfg, groups, obs=fleet_obs, device=dev)
    source = FleetSource(fleet_cfg)
    engine = SloEngine(registry=fleet_reg)
    box = {"st": None, "gs": None, "key": 0}

    def poll() -> dict:
        if box["st"] is None:
            st = init_state(cfg, device=dev)
            st, _ = run_until_leader(st, cfg, max_ticks=512, device=dev)
            box["st"] = st
            gs = multiraft.init_groups(fleet_cfg, groups, device=dev)
            gs, _ = multiraft.run_group_ticks(gs, fleet_cfg, 60, device=dev)
            box["gs"] = gs
        st, _ = run_ticks(box["st"], cfg, n_ticks=burst,
                          prop_count=cfg.max_props, device=dev)
        box["st"] = st
        obs.publish(st)
        # overload the fleet: ~4x per-tick capacity, one flush per poll
        for _ in range(4 * fleet_cfg.max_props * groups):
            router.offer(f"key/{box['key']}", box["key"] & 0xFFFF)
            box["key"] += 1
        gs = router.flush(box["gs"])
        gs, _ = multiraft.run_group_ticks(gs, fleet_cfg, burst, device=dev)
        box["gs"] = gs
        fleet_obs.publish(gs, router=router)
        engine.observe(source.scrape(gs, router=router))
        return {
            "sim-quorum": {
                "metrics": reg.snapshot(),
                "objects": {"managers": n,
                            "tick": int(st.tick.max())},
                "spans": [], "recent_events": []},
            "sim-fleet": {
                "metrics": fleet_reg.snapshot(),
                "objects": {"groups": groups,
                            "tick": int(gs.tick.max())},
                "spans": [], "recent_events": [],
                "hottest": fleet_obs.hottest_groups(4),
                "slo_active": engine.active(),
                "alerts": list(engine.alerts)[-5:]},
        }

    return poll


# ------------------------------------------------------------------ loops

def _loop_plain(poll, state: TopState, patterns, interval: float) -> None:
    try:
        while True:
            snaps = poll()
            state.observe(snaps)
            frame = render_frame(snaps, state, patterns)
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        pass


def _loop_curses(poll, state: TopState, patterns, interval: float) -> None:
    import curses

    def run(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            snaps = poll()
            state.observe(snaps)
            frame = render_frame(snaps, state, patterns)
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for y, line in enumerate(frame.splitlines()[: maxy - 1]):
                try:
                    scr.addstr(y, 0, line[: maxx - 1])
                except curses.error:
                    pass
            scr.refresh()
            if scr.getch() in (ord("q"), 27):
                return
            time.sleep(interval)

    curses.wrapper(run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from", dest="files", nargs="+", metavar="FILE",
                     help="snapshot JSON file(s), re-read every poll")
    src.add_argument("--demo", action="store_true",
                     help="drive an in-process batched-sim quorum")
    ap.add_argument("--n", type=int, default=16,
                    help="demo quorum size (default 16)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--filter", nargs="+", default=list(DEFAULT_FILTER),
                    metavar="SUBSTR",
                    help="series-name substrings to display")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen control)")
    ap.add_argument("--plain", action="store_true",
                    help="ANSI redraw loop even when curses would work")
    ap.add_argument("--device", default=None,
                    help="--demo's device; default: the CUDA card (raises "
                         "without one)")
    args = ap.parse_args(argv)

    poll = source_demo(args.n, device=args.device) if args.demo \
        else source_files(args.files)
    state = TopState()
    patterns = tuple(args.filter)

    if args.once:
        snaps = poll()
        state.observe(snaps)
        if args.demo:        # a second poll so rates/sparklines exist
            snaps = poll()
            state.observe(snaps)
        print(render_frame(snaps, state, patterns), flush=True)
        return 0

    use_curses = not args.plain and sys.stdout.isatty()
    if use_curses:
        try:
            _loop_curses(poll, state, patterns, args.interval)
            return 0
        except Exception:
            pass  # no terminal/curses: fall through to plain
    _loop_plain(poll, state, patterns, args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
