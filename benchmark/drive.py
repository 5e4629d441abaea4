"""The one traffic generator: drives a cell's mix through the port's run
loops and records the schedule for the reference.

A mix (``traffic/<name>.json``) is read by ``Driver`` alone:

- ``proposals_per_tick``: entries offered every tick through the fused
  propose of ``run_ticks`` (a closed loop: the next tick's batch follows
  this tick's);
- ``chunk_ticks``: ticks per ``run_ticks`` call, each call ended by a
  synchronize (the flow of the repo's ``tools/bench.py::measure``);
- ``warm_ticks``: proposing ticks after the election, in set-up;
- ``trace_ticks``: the ticks the traced run profiles as one call;
- ``sim``: `SimConfig` fields the mix sets (``read_batch``: linearizable
  reads each idle row takes a tick, which the tick refills itself);
- ``run_ticks``: keyword arguments handed unchanged to every
  ``run_ticks`` call (``{"drop_rate": 0.05}``: per-edge message drops);
- ``row_shards`` (default 1): the state split by rows over this many
  devices (``parallel.row_mesh`` over the run's cards, the row tick);
  1 keeps it whole on the one device;
- ``judge``: what the reference expects of the mix (reference.judge's
  keyword arguments: ``commit_lag_entries``, ``behind_batches``,
  ``one_round_elections``);
- ``crash_every`` (0: none) and ``max_down_ticks``: every ``crash_every``
  ticks the sitting leader is crashed and held down until another row
  wins an election (at most ``max_down_ticks``), one tick a call, each
  followed by a read of its trace row, so the recovery is timed to the
  tick.  A set-up with crashes warms up one whole crash cycle.

The proposing calls expect the leader to stand: a mix whose faults can
unseat it outside a crash cycle needs the crash cycle's accounting.

Set-up follows ``tools/bench.py::measure`` (elect in ``run_until_leader``
chunks of 256 ticks, then warm), without its second election and with a
window of fixed seconds in place of its fixed entry count.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

from swarmkit_tpu_torch import parallel
from swarmkit_tpu_torch.raft import sim

from benchmark.reference import Record

ELECT_CHUNK, MAX_ELECT_TICKS = 256, 2000


def sim_config(cell, seed: int):
    """The cell's SimConfig: the configuration's fields, the mix's, and
    the run's seed."""
    fields = dict(cell.config["sim"])
    fields.update(cell.traffic.get("sim", {}))
    fields["seed"] = int(seed)
    return sim.SimConfig(**fields)


def mix_devices(traffic: dict, dev) -> list:
    """The devices the mix's state lies on: ``row_shards`` cards from
    `dev` on (the CPU named that many times in a rehearsal)."""
    d = int(traffic.get("row_shards", 1))
    if dev.type == "cpu":
        return [dev] * d
    return [torch.device(dev.type, (dev.index or 0) + i)
            for i in range(d)]


def rows_field(st, name: str, device=None) -> torch.Tensor:
    """One per-row field of the state, whole (a row-sharded state's
    shards concatenated in row order) on `device` (default: where its
    first row lies)."""
    if parallel.row_sharded(st):
        dev = device if device is not None else st.devices[0]
        return torch.cat([getattr(s, name).to(dev) for s in st.shards])
    t = getattr(st, name)
    return t if device is None else t.to(device)


class Driver:
    """One cluster under one mix.  `run` is the module whose `run_ticks`
    and `run_until_leader` are driven (the port's raft.sim; the tests
    hand a broken one in)."""

    def __init__(self, cfg, traffic: dict, dev, run=sim):
        self.cfg, self.dev, self.run = cfg, dev, run
        self.devices = mix_devices(traffic, dev)
        self.props = int(traffic["proposals_per_tick"])
        self.chunk = int(traffic["chunk_ticks"])
        self.warm = int(traffic.get("warm_ticks", self.chunk))
        self.trace_ticks = int(traffic.get("trace_ticks", 16))
        self.crash_every = int(traffic.get("crash_every", 0))
        self.max_down = int(traffic.get("max_down_ticks", 0))
        self.run_kw = dict(traffic.get("run_ticks", {}))
        self.record = Record(cfg.n, cfg.log_len, cfg.read_batch)
        self.st = None
        self.tick = 0              # the program's tick counter, on the host
        self.offered = 0
        self.failovers = []        # (seconds, ticks) of each crash
        self.tick_ms = []          # host ms a tick of each steady call

    # -- reads of the cluster (each one synchronizes) --------------------
    def sync(self) -> None:
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def committed(self) -> int:
        return int(self.run.committed_entries(self.st))

    def reads(self) -> tuple[int, int]:
        return (int(self.run.reads_served(self.st)),
                int(self.run.reads_blocked(self.st)))

    def leader_term(self) -> int:
        lm = self.run.leader_mask(self.st)
        return int(rows_field(self.st, "term", lm.device)[lm].max())

    # -- set-up ------------------------------------------------------------
    def elect(self) -> None:
        self.st = sim.init_state(self.cfg, device=self.devices[0])
        if len(self.devices) > 1:
            self.st = parallel.shard_rows(
                self.st, parallel.row_mesh(self.cfg.n, self.devices))
        while self.tick < MAX_ELECT_TICKS:
            self.st, t = self.run.run_until_leader(
                self.st, self.cfg, max_ticks=ELECT_CHUNK,
                device=self.dev)
            self.tick += t
            if bool(self.run.has_leader(self.st)):
                break
        if not bool(self.run.has_leader(self.st)):
            raise RuntimeError(f"no leader within {MAX_ELECT_TICKS} ticks")
        self.record.elect(self.tick - 1, self.leader_term())

    def warm_up(self) -> None:
        """Every path the window takes, once: proposing ticks and, with
        crashes, a whole crash cycle."""
        self.steady(self.warm)
        if self.crash_every:
            self.cycle(window=False)
        self.sync()

    # -- units of work -------------------------------------------------------
    def steady(self, n_ticks: int) -> None:
        """Proposing ticks in run_ticks calls of at most chunk_ticks, each
        ended by a synchronize."""
        while n_ticks > 0:
            k = min(n_ticks, self.chunk)
            t0 = time.perf_counter()
            self.st, _ = self.run.run_ticks(self.st, self.cfg, k,
                                            prop_count=self.props,
                                            device=self.dev,
                                            **self.run_kw)
            self.sync()
            self.tick_ms.append(1e3 * (time.perf_counter() - t0) / k)
            self.record.props(self.tick, k, self.props)
            self.tick += k
            self.offered += k * self.props
            n_ticks -= k

    def cycle(self, window: bool = True, profile=nullcontext) -> None:
        """One crash cycle: crash the sitting leader and hold it down a
        tick at a time until another row has won and the cluster's commit
        passes its pre-crash value; then propose through the rest of the
        crash_every ticks.  `profile` is the context around the outage;
        `window` counts the crash among the window's failovers."""
        c_pre = self.committed()
        first, held, won, k = self.tick, None, False, 0
        kw = dict(self.run_kw, down_for=1)
        with profile():
            t0 = time.perf_counter()
            while True:
                hold = not won and k < self.max_down
                self.st, tr = self.run.run_ticks(
                    self.st, self.cfg, 1, prop_count=self.props,
                    crash_every=1 if hold else 0, device=self.dev,
                    **kw)
                n_lead, commit, _ = tr[0].tolist()
                self.record.props(self.tick, 1, self.props)
                if hold:
                    held = self.tick
                    # the held leader still counts as one: two means a
                    # new one won this tick
                    if n_lead >= 2:
                        won, won_at = True, self.tick
                self.tick += 1
                self.offered += self.props
                k += 1
                if commit > c_pre or k >= 2 * self.max_down:
                    break
            dt = time.perf_counter() - t0
        self.record.down(first, held)
        if won:
            self.record.elect(won_at, self.leader_term())
        if window:
            self.failovers.append((dt, k))
        self.steady(max(self.crash_every - k, 0))

    def unit(self, profile=nullcontext) -> None:
        """One unit of the traced run under `profile`: trace_ticks
        proposing ticks, or a crash cycle with its outage profiled."""
        if self.crash_every:
            self.cycle(window=False, profile=profile)
        else:
            with profile():
                self.steady(self.trace_ticks)

    # -- the measured window -------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Units of work until `seconds` have passed: chunk_ticks
        proposing ticks, or a crash cycle.  Returns the window's
        readings."""
        c0 = self.committed()
        r0, b0 = self.reads() if self.cfg.read_batch else (0, 0)
        tick0, offered0 = self.tick, self.offered
        n_calls0, n_fo0 = len(self.tick_ms), len(self.failovers)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if self.crash_every:
                self.cycle()
            else:
                self.steady(self.chunk)
        self.sync()
        dt = time.perf_counter() - t0
        c1 = self.committed()
        r1, b1 = self.reads() if self.cfg.read_batch else (0, 0)
        return {"seconds": dt, "tick0": tick0, "ticks": self.tick - tick0,
                "committed": c1 - c0, "offered": self.offered - offered0,
                "reads": (r1 - r0) & 0xFFFF_FFFF,
                "blocked": (b1 - b0) & 0xFFFF_FFFF,
                "failovers": self.failovers[n_fo0:],
                "tick_ms": self.tick_ms[n_calls0:]}
