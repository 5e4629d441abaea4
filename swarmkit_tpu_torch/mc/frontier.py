"""The batched frontier search: exhaustive BFS over the fault-branch space
(PyTorch port of the JAX package's mc/frontier.py).

One level of the search expands every frontier state under every alphabet
action in wide device passes — the SAME `_tick_one` the DST explorer runs
(kernel step + fused propose + mutation hook + the invariant bitmask), on
a [W, N, ...] batch of (frontier state, action) lanes through the
batch-native tick, with the fingerprint fold in the pass, so the host
only ever reads [W] bitmasks and [W, 2] fingerprints, never the states.
Children deduplicate by exact fingerprint: the kernel is pure in (state,
action) and `tick` is part of the state, so equal fingerprints mean equal
futures and per-level dedup preserves the full reachable set (states of
different depths can never collide — their tick words differ).

The host dedup is the JAX package's (np.unique / searchsorted / union1d
on uint64 keys), so the frontier order, paths, LTS ids, edges and
violation lists are JAX's.  So are the pass widths (`pass_small`,
`pass_large`) and with them `passes` and `max_branches_per_pass`; where
JAX pads a chunk to the width it compiled, the port launches only the
chunk's real lanes.

A violating child is never expanded further; its action path is lowered
back to a `FaultSchedule` (space.path_to_schedule) and handed to the
standard dst/repro pipeline — replay, shrink, flight-recorder capture,
seed-pinned JSON artifact (the JAX package's format) — so a model-checker
counterexample is the same one-command regression a DST counterexample is.

`budget` caps the per-level frontier: once a level holds that many unique
states, further fresh children are DROPPED and counted — the summary then
says ``exhaustive: false`` with per-level truncation counts, never
silently narrowing a claim.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from swarmkit_tpu_torch import parallel
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.dst.explore import _tick_one
from swarmkit_tpu_torch.dst.invariants import (
    ALL_BITS, BIT_NAMES, bits_to_names, check_state,
)
from swarmkit_tpu_torch.dst.schedule import FaultSchedule
from swarmkit_tpu_torch.mc import metrics as mc_metrics
from swarmkit_tpu_torch.mc.fingerprint import (
    canonical_fingerprint, fingerprint,
)
from swarmkit_tpu_torch.mc.space import (
    Alphabet, path_to_branch, path_to_schedule,
)
from swarmkit_tpu_torch.raft.sim.state import (
    FIELD_NAMES, SimConfig, SimState, broadcast_state, init_state,
)


def _take(states: SimState, idx: torch.Tensor) -> SimState:
    """The lanes `idx` of a batched state (new storage: the tick writes
    its rings in place)."""
    return SimState(**{name: getattr(states, name).index_select(0, idx)
                       for name in FIELD_NAMES
                       if getattr(states, name) is not None})


def _cat(blocks: list) -> SimState:
    return SimState(**{name: torch.cat([getattr(b, name) for b in blocks])
                       for name in FIELD_NAMES
                       if getattr(blocks[0], name) is not None})


def _expand(states: SimState, aids: torch.Tensor, tables, cfg: SimConfig,
            prop_count: int, mutation: Optional[str], symmetry: bool,
            device):
    """One device pass: step every (state, action) lane one tick.

    Returns (child states, violation bits [W], fingerprints [W, 2])."""
    alive_tab, drop_tab, inflate_tab = tables
    lanes = aids.shape[0]
    never = torch.zeros((lanes,), dtype=torch.bool, device=aids.device)
    sched_t = FaultSchedule(
        drop=drop_tab[aids], alive=alive_tab[aids], target_leader=never,
        crash_campaign=never,
        term_inflate=None if inflate_tab is None else inflate_tab[aids])
    new, bits = _tick_one(states, cfg, sched_t, prop_count, mutation,
                          device)
    fp = canonical_fingerprint(new, cfg.n) if symmetry \
        else fingerprint(new)
    return new, bits, fp


@dataclass
class ScanResult:
    """Everything `exhaustive_scan` learned, JSON-able via `summary()`."""

    scope: str
    n: int
    horizon: int
    alphabet_size: int
    action_names: tuple
    prop_count: int
    mutation: Optional[str]
    symmetry: bool
    budget: Optional[int]
    schedule_space: int          # A^horizon (python int — can be huge)
    branches_explored: int = 0   # real (state, action) expansions
    passes: int = 0              # device passes (batched ticks)
    max_branches_per_pass: int = 0
    states_discovered: int = 1   # unique reachable states incl. the root
    frontier_peak: int = 1
    duplicates: int = 0          # children merged into an existing state
    truncated: bool = False      # any level hit the budget cap
    stopped_early: bool = False  # stop_on_violation fired
    levels: list = field(default_factory=list)
    violations: list = field(default_factory=list)
    elapsed: float = 0.0
    branches_per_sec: float = 0.0
    edges: Optional[list] = None  # (src_id, action_idx, dst_id)
    num_states: int = 0           # LTS node count (edge mode only)
    # host-clock seconds: "device" from each pass's gather to its read-back
    # (the tick, the fingerprint, the wait for them), "host" in the dedup
    # (not part of summary(), whose keys are the JAX package's)
    timing: dict = field(default_factory=dict)

    @property
    def exhaustive(self) -> bool:
        """True iff every branch in the A^H space was covered (up to
        state merging): no budget truncation, no early stop."""
        return not self.truncated and not self.stopped_early

    def summary(self) -> dict:
        return {
            "scope": self.scope, "n": self.n, "horizon": self.horizon,
            "alphabet": list(self.action_names),
            "alphabet_size": self.alphabet_size,
            "prop_count": self.prop_count, "mutation": self.mutation,
            "symmetry": self.symmetry, "budget": self.budget,
            "schedule_space": self.schedule_space,
            "branches_explored": self.branches_explored,
            "passes": self.passes,
            "max_branches_per_pass": self.max_branches_per_pass,
            "states_discovered": self.states_discovered,
            "frontier_peak": self.frontier_peak,
            "duplicates": self.duplicates,
            "exhaustive": self.exhaustive,
            "truncated": self.truncated,
            "stopped_early": self.stopped_early,
            "levels": self.levels,
            "violations": [
                {k: v for k, v in viol.items() if k != "path"}
                | {"path": [int(a) for a in viol["path"]]}
                for viol in self.violations],
            "elapsed_sec": round(self.elapsed, 3),
            "branches_per_sec": round(self.branches_per_sec, 1),
        }


def _fp64(fp2: np.ndarray) -> np.ndarray:
    """[W, 2] (hi, lo) uint32 values -> [W] uint64 host keys."""
    return (fp2[:, 0].astype(np.uint64) << np.uint64(32)) \
        | fp2[:, 1].astype(np.uint64)


def exhaustive_scan(cfg: SimConfig, alphabet: Alphabet, horizon: int, *,
                    prop_count: int = 1, mutation: Optional[str] = None,
                    budget: Optional[int] = None,
                    pass_small: int = 4096, pass_large: int = 1 << 20,
                    collect_edges: bool = False, symmetry: bool = False,
                    stop_on_violation: bool = True,
                    max_violations: int = 8, shard: bool = True,
                    mesh=None, scope: str = "custom", obs=None, log=None,
                    device=None) -> ScanResult:
    """BFS the reachable states of (cfg, alphabet) to `horizon` ticks, on
    `device` (the CUDA card unless the caller names another).

    A level of C children runs in `pass_small`-wide device passes when
    C <= pass_small, else in `pass_large`-wide ones — size `pass_large`
    so the big levels put >= 1M real branches in one pass.  Violating
    children are recorded (capped at `max_violations`) and pruned; with
    `stop_on_violation` the scan finishes the current level and stops.
    `collect_edges` additionally numbers every reached state and records
    (src, action, dst) transitions — the LTS the
    ``swarmkit_tpu_torch.tools.mc_export`` Aldebaran writer emits; meant
    for smoke-sized scopes (the edge list is host memory and python-loop
    time).  With `shard` a pass's W lanes split over the devices of
    `mesh` (default: every local card; the CPU once) in blocks of W / D
    when D divides W, as the JAX package's schedule_mesh(W) does; the
    bits and fingerprints come back in lane order before the host dedup,
    so the ladder, edges and violations do not depend on D.
    """
    from swarmkit_tpu_torch.metrics import catalog
    from swarmkit_tpu_torch.metrics import registry as obs_registry

    dev = resolve_device(device)
    A = alphabet.size
    devices = [dev]
    if shard:
        devices = [torch.device(d) for d in (
            mesh.device_list() if mesh is not None
            else parallel.local_devices(dev))]
        if any(d.type != dev.type for d in devices):
            raise ValueError(f"mesh devices {devices} are not {dev.type}")
    tables = {d: alphabet.tables(d) for d in {dev, *devices}}
    t0 = time.monotonic()
    dev_s = host_s = 0.0

    result = ScanResult(
        scope=scope, n=cfg.n, horizon=horizon, alphabet_size=A,
        action_names=alphabet.names, prop_count=prop_count,
        mutation=mutation, symmetry=symmetry, budget=budget,
        schedule_space=A ** horizon)

    root = init_state(cfg, device=dev)
    frontier = broadcast_state(root, 1)
    root_bits = int(check_state(frontier, cfg)[0])
    if root_bits:
        result.violations.append({
            "level": 0, "path": [], "branch": 0, "bits": root_bits,
            "invariants": bits_to_names(root_bits)})
        result.stopped_early = True

    paths = np.zeros((1, 0), np.int16)
    fp_to_id: dict = {}
    ids = None
    if collect_edges:
        result.edges = []
        root_fp = int(_fp64(fingerprint(root).cpu().numpy()[None, :])[0])
        fp_to_id[root_fp] = 0
        ids = np.zeros((1,), np.int64)

    for level in range(1, horizon + 1):
        if result.stopped_early:
            break
        F = paths.shape[0]
        C = F * A
        W = pass_small if C <= pass_small else pass_large
        last_level = level == horizon

        seen = np.empty((0,), np.uint64)   # this level's unique keys
        blocks, block_paths, block_ids = [], [], []
        lvl_unique = lvl_dups = lvl_viol = lvl_trunc = 0

        for g0 in range(0, C, W):
            real = min(W, C - g0)
            g = np.arange(g0, g0 + real, dtype=np.int64)
            pidx = g // A
            aid = g % A

            ts = time.monotonic()
            # the pass's lanes over the mesh in blocks of W / D (the JAX
            # package's padded layout, clipped to the real lanes), or one
            # block on dev; every block's tick is issued before any read
            spans, sdevs = [(0, real)], [dev]
            if len(devices) > 1 and W % len(devices) == 0:
                spans = parallel.split_lanes(real, W, len(devices))
                sdevs = devices
            news, outs = [], []
            for (a, b), sdev in zip(spans, sdevs):
                if a == b:
                    continue
                chunk = _take(frontier, torch.from_numpy(pidx[a:b]).to(dev))
                if sdev != dev:
                    chunk = parallel.tree_map(lambda t: t.to(sdev), chunk)
                new, bits, fps = _expand(
                    chunk, torch.from_numpy(aid[a:b]).to(sdev),
                    tables[sdev], cfg, prop_count, mutation, symmetry, sdev)
                del chunk
                news.append((a, new))
                outs.append(torch.cat([bits.to(torch.int64)[:, None], fps],
                                      dim=1))
            host = np.concatenate([o.cpu().numpy() for o in outs])
            del outs
            th = time.monotonic()
            dev_s += th - ts
            result.passes += 1
            result.branches_explored += real
            result.max_branches_per_pass = max(
                result.max_branches_per_pass, real)

            bits_h = host[:, 0].astype(np.uint32)
            keys = _fp64(host[:, 1:])

            viol_pos = np.nonzero(bits_h)[0]
            lvl_viol += int(viol_pos.size)
            for k in viol_pos[:max(0, max_violations
                                   - len(result.violations))]:
                path = [int(a) for a in paths[pidx[k]]] + [int(aid[k])]
                result.violations.append({
                    "level": level, "path": path,
                    "branch": path_to_branch(path, A),
                    "bits": int(bits_h[k]),
                    "invariants": bits_to_names(int(bits_h[k]))})

            clean_pos = np.nonzero(bits_h == 0)[0]
            vals = keys[clean_pos]
            uniq_vals, uniq_first = np.unique(vals, return_index=True)
            if seen.size:
                pos = np.searchsorted(seen, uniq_vals)
                known = (pos < seen.size) \
                    & (seen[np.minimum(pos, seen.size - 1)] == uniq_vals)
            else:
                known = np.zeros(uniq_vals.shape, bool)
            fresh_pos = clean_pos[uniq_first[~known]]
            order = np.argsort(fresh_pos)
            fresh_pos = fresh_pos[order]
            lvl_dups += int(clean_pos.size - fresh_pos.size)

            if budget is not None and lvl_unique + fresh_pos.size > budget:
                room = max(0, budget - lvl_unique)
                lvl_trunc += int(fresh_pos.size - room)
                fresh_pos = fresh_pos[:room]
                result.truncated = True
            lvl_unique += int(fresh_pos.size)
            seen = np.union1d(seen, keys[fresh_pos])

            if collect_edges:
                # python loop: edge mode is for smoke-sized scopes
                child_ids = np.empty((real,), np.int64)
                for k in range(real):
                    key_k = int(keys[k])
                    cid = fp_to_id.get(key_k)
                    if cid is None:
                        cid = len(fp_to_id)
                        fp_to_id[key_k] = cid
                    child_ids[k] = cid
                    result.edges.append(
                        (int(ids[pidx[k]]), int(aid[k]), cid))
                block_ids.append(child_ids[fresh_pos])

            if fresh_pos.size and not last_level:
                for a, new in news:
                    sel = fresh_pos[(fresh_pos >= a)
                                    & (fresh_pos < a + new.tick.shape[0])]
                    if sel.size:
                        kept = _take(new, torch.from_numpy(sel - a)
                                     .to(new.tick.device))
                        blocks.append(parallel.tree_map(
                            lambda t: t.to(dev), kept))
                block_paths.append(np.concatenate(
                    [paths[pidx[fresh_pos]],
                     aid[fresh_pos, None].astype(np.int16)], axis=1))
            del news
            host_s += time.monotonic() - th

        result.states_discovered += lvl_unique
        result.frontier_peak = max(result.frontier_peak, lvl_unique)
        result.levels.append({
            "level": level, "frontier": F, "children": C,
            "unique": lvl_unique, "duplicates": lvl_dups,
            "violations": lvl_viol, "truncated": lvl_trunc})
        if log is not None:
            log(f"mc[{scope}] level {level}/{horizon}: children={C:,} "
                f"unique={lvl_unique:,} violations={lvl_viol} "
                + (f"TRUNCATED {lvl_trunc:,} (budget {budget:,})"
                   if lvl_trunc else ""))

        if lvl_viol and stop_on_violation:
            result.stopped_early = True
        if last_level or result.stopped_early or not blocks:
            break
        frontier = blocks[0] if len(blocks) == 1 else _cat(blocks)
        del blocks
        paths = np.concatenate(block_paths, axis=0)
        if collect_edges:
            ids = np.concatenate(block_ids, axis=0)

    result.elapsed = time.monotonic() - t0
    result.branches_per_sec = result.branches_explored / result.elapsed \
        if result.elapsed > 0 else float("inf")
    result.timing = {"device_s": dev_s, "host_s": host_s}
    if collect_edges:
        result.num_states = len(fp_to_id)

    obs = obs or obs_registry.DEFAULT
    viol_children = sum(lv["violations"] for lv in result.levels)
    m = catalog.get(obs, mc_metrics.METRIC_BRANCHES)
    if result.branches_explored - viol_children:
        m.labels(result="clean").inc(result.branches_explored
                                     - viol_children)
    if viol_children:
        m.labels(result="violation").inc(viol_children)
    m = catalog.get(obs, mc_metrics.METRIC_STATES)
    m.labels(kind="unique").inc(result.states_discovered)
    result.duplicates = sum(lv["duplicates"] for lv in result.levels)
    if result.duplicates:
        m.labels(kind="duplicate").inc(result.duplicates)
    m = catalog.get(obs, mc_metrics.METRIC_VIOLATIONS)
    seen_bits = 0
    for viol in result.violations:
        seen_bits |= viol["bits"]
    for bit in ALL_BITS:
        if seen_bits & bit:
            m.labels(invariant=BIT_NAMES[bit]).inc()
    catalog.get(obs, mc_metrics.METRIC_BRANCH_RATE).labels(
        scope=scope).set(result.branches_per_sec)
    catalog.get(obs, mc_metrics.METRIC_FRONTIER_PEAK).labels(
        scope=scope).set(result.frontier_peak)
    trunc = sum(lv["truncated"] for lv in result.levels)
    if trunc:
        catalog.get(obs, mc_metrics.METRIC_TRUNCATIONS).labels(
            scope=scope).inc(trunc)
    return result


def violation_artifact(cfg: SimConfig, alphabet: Alphabet, violation: dict,
                       *, prop_count: int = 1,
                       mutation: Optional[str] = None,
                       scope: str = "custom", do_shrink: bool = True,
                       flight: bool = True, obs=None, device=None) -> dict:
    """Lower one scan violation to a standard seed-pinned repro artifact,
    on `device` (the CUDA card unless the caller names another).

    The branch path becomes a FaultSchedule, replays through the same tick
    program (bits and first tick must land exactly where the scan found
    them), shrinks greedily, and is captured with the flight recorder —
    the identical pipeline DST counterexamples ride, so
    ``swarmkit_tpu_torch.tools.dst_sweep --replay`` re-runs model-checker
    repros too, and the artifact loads in the JAX package's tools as
    theirs load here.
    """
    from swarmkit_tpu_torch.dst import repro

    dev = resolve_device(device)
    sched = path_to_schedule(alphabet, violation["path"], device=dev)
    bits, first = repro.replay(cfg, sched, prop_count, mutation, device=dev)
    evals = 0
    if do_shrink and bits:
        sched, evals = repro.shrink(cfg, sched, bits, prop_count,
                                    mutation, obs=obs, device=dev)
        bits, first = repro.replay(cfg, sched, prop_count, mutation,
                                   device=dev)
    fl = None
    if flight:
        fl = repro.capture_flight(cfg, sched, prop_count, mutation,
                                  first_tick=first,
                                  trigger="mc_violation", obs=obs,
                                  device=dev)
    art = repro.to_artifact(
        cfg, sched, seed=0, profile=f"mc:{scope}",
        index=violation["branch"], prop_count=prop_count,
        mutation=mutation, viol=bits, first_tick=first, flight=fl)
    art["mc"] = {
        "scope": scope, "level": violation["level"],
        "path": [int(a) for a in violation["path"]],
        "actions": [alphabet.names[a] for a in violation["path"]],
        "scan_bits": violation["bits"],
        "shrink_evals": evals,
    }
    return art
