"""Host-side key -> group router for the multi-raft serving plane
(PyTorch port of the JAX package's multiraft/router.py).

Clients address KEYS; the serving plane holds G raft groups.  The router
maps each key to its owning group by stable hashing (blake2b keyed by the
router seed: deterministic across processes and Python hash
randomization, unlike ``hash()``), buckets offered writes/reads into
per-group batches, and feeds one tick's worth of batches through the
grouped tick (`propose_groups` + `submit_reads_groups` + `step_groups`)
per `flush`.

A group's per-tick proposal capacity is ``cfg.max_props``; keys offered
beyond that SPILL: they stay queued for the next flush rather than being
dropped, and the spill is surfaced through
``swarm_multiraft_router_keys_total{outcome="spilled"}`` so a hot group
shows up on the scrape page instead of as silent tail latency.
"""

from __future__ import annotations

import hashlib

import numpy as np

from swarmkit_tpu_torch.multiraft.group import (
    propose_groups, step_groups, submit_reads_groups,
)
from swarmkit_tpu_torch.raft.sim.state import SimConfig, SimState


def group_of_key(key, groups: int, seed: int = 0) -> int:
    """Owning group of `key` (str / bytes / int): stable across processes,
    uniform over [0, groups)."""
    if isinstance(key, int):
        key = key.to_bytes(8, "little", signed=True)
    elif isinstance(key, str):
        key = key.encode("utf-8")
    h = hashlib.blake2b(key, digest_size=8,
                        key=seed.to_bytes(8, "little", signed=True))
    return int.from_bytes(h.digest(), "little") % groups


class Router:
    """Per-group write/read batching front end.

    >>> r = Router(cfg, groups=64)
    >>> r.offer(b"user/123", payload=0xBEEF)   # returns the owning group
    >>> r.offer_read(b"user/123")
    >>> gstate = r.flush(gstate)               # one tick, batches applied

    `flush` is one serving tick: drain up to cfg.max_props queued payloads
    per group into the grouped `propose`, submit queued read counts, then
    `step_groups`.  Queues keep their overflow for the next flush.  The
    grouped tick runs on `device` (the CUDA card unless the caller names
    another); a flush copies its batches to it and reads nothing back.
    """

    def __init__(self, cfg: SimConfig, groups: int, seed: int = 0,
                 obs=None, device=None) -> None:
        self.cfg = cfg
        self.groups = groups
        self.seed = seed
        self.obs = obs                      # optional MultiRaftObs
        self.device = device
        self._writes: list[list[int]] = [[] for _ in range(groups)]
        self._reads = np.zeros((groups,), np.int64)
        self.routed = 0                     # keys accepted into queues
        self.spilled = 0                    # flushes deferred by capacity
        # cumulative per-group flow, the heat detector's inputs
        # (multiraft/heat.py): offered keys and capacity spills by group
        self.routed_by_group = np.zeros((groups,), np.int64)
        self.spilled_by_group = np.zeros((groups,), np.int64)

    def group_of(self, key) -> int:
        return group_of_key(key, self.groups, self.seed)

    def offer(self, key, payload: int) -> int:
        """Queue one write of `payload` (uint32; bit 31 reserved for conf
        entries) under `key`; returns the owning group."""
        g = self.group_of(key)
        self._writes[g].append(int(payload) & 0x7FFFFFFF)
        self.routed += 1
        self.routed_by_group[g] += 1
        if self.obs is not None:
            self.obs.router_keys("routed")
        return g

    def offer_read(self, key, count: int = 1) -> int:
        """Queue `count` linearizable read ops under `key`; returns the
        owning group (cfg.read_batch > 0 required at flush time)."""
        g = self.group_of(key)
        self._reads[g] += count
        self.routed += count
        self.routed_by_group[g] += count
        if self.obs is not None:
            self.obs.router_keys("routed", count)
        return g

    def pending(self) -> tuple[int, int]:
        """(queued writes, queued read ops) across all groups."""
        return (sum(len(q) for q in self._writes), int(self._reads.sum()))

    def flush(self, gstate: SimState) -> SimState:
        """Apply one tick's batches and advance every group one tick."""
        cap = self.cfg.max_props
        payloads = np.zeros((self.groups, cap), np.uint32)
        counts = np.zeros((self.groups,), np.int32)
        spilled = 0
        for g, q in enumerate(self._writes):
            take = min(len(q), cap)
            over = len(q) - take
            spilled += over
            self.spilled_by_group[g] += over
            if take:
                payloads[g, :take] = q[:take]
                counts[g] = take
                self._writes[g] = q[take:]
        if spilled:
            self.spilled += spilled
            if self.obs is not None:
                self.obs.router_keys("spilled", spilled)
        if counts.any():
            gstate = propose_groups(gstate, self.cfg, payloads, counts,
                                    device=self.device)
        if self._reads.any():
            rc = np.minimum(self._reads, np.iinfo(np.int32).max)
            gstate = submit_reads_groups(gstate, self.cfg,
                                         rc.astype(np.int32),
                                         device=self.device)
            self._reads[:] = 0
        return step_groups(gstate, self.cfg, device=self.device)
