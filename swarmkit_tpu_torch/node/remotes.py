"""Weighted-random manager address book.

Reference: remotes/remotes.go (:21-136) — tracks known manager addresses
with observation weights: successful contact raises the weight
(DefaultObservationWeight 10), failure penalizes it; selection is weighted
random so agents spread across managers but avoid flaky ones.
"""

from __future__ import annotations

import random
from typing import Optional

from swarmkit_tpu_torch.api import Peer

DEFAULT_OBSERVATION_WEIGHT = 10   # reference: remotes.go:21
MAX_OBSERVATION_WEIGHT = 100


class Remotes:
    def __init__(self, *peers: Peer, rng: Optional[random.Random] = None
                 ) -> None:
        self._weights: dict[str, int] = {}   # addr -> weight
        self._peers: dict[str, Peer] = {}
        self._rng = rng or random.Random()
        for p in peers:
            self.observe(p, DEFAULT_OBSERVATION_WEIGHT)

    def observe(self, peer: Peer, weight: int = DEFAULT_OBSERVATION_WEIGHT
                ) -> None:
        """Record an observation; positive reinforces, negative penalizes
        (reference: Observe/ObserveIfExists remotes.go:60)."""
        if not peer.addr:
            return
        cur = self._weights.get(peer.addr, 0)
        nxt = max(-MAX_OBSERVATION_WEIGHT,
                  min(MAX_OBSERVATION_WEIGHT, cur + weight))
        self._weights[peer.addr] = nxt
        self._peers[peer.addr] = peer

    def remove(self, *addrs: str) -> None:
        for a in addrs:
            self._weights.pop(a, None)
            self._peers.pop(a, None)

    def select(self, *excludes: str) -> Peer:
        """Weighted random pick (reference: Select remotes.go:94)."""
        pool = [(a, w) for a, w in self._weights.items()
                if a not in excludes]
        if not pool:
            raise LookupError("no manager addresses known")
        # shift so the lowest weight still has a small chance
        low = min(w for _, w in pool)
        shifted = [(a, (w - low) + 1) for a, w in pool]
        total = sum(w for _, w in shifted)
        pick = self._rng.uniform(0, total)
        acc = 0.0
        for a, w in shifted:
            acc += w
            if pick <= acc:
                return self._peers[a]
        return self._peers[shifted[-1][0]]

    def weights(self) -> dict[str, int]:
        return dict(self._weights)

    def __len__(self) -> int:
        return len(self._weights)
