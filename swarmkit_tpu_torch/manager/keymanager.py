"""Gossip/IPSec key rotation loop.

Reference: manager/keymanager/keymanager.go — keeps a ring of 3 keys per
subsystem in the Cluster object, rotates the primary every 12 h
(DefaultKeyRotationInterval), stamping each key with a lamport time so
agents order them (rotateKey :124, Run :173).

The port's own copy of the JAX package's manager/keymanager.py.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from swarmkit_tpu_torch.api.objects import EncryptionKey
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.keymanager")

DEFAULT_KEY_LEN = 16
DEFAULT_KEY_ROTATION_INTERVAL = 12 * 3600.0
SUBSYSTEM_GOSSIP = "networking:gossip"
SUBSYSTEM_IPSEC = "networking:ipsec"
KEYRING_SIZE = 3
AES_128_GCM = 0


class KeyManager:
    def __init__(self, store: MemoryStore, cluster_id: str = "",
                 subsystems: tuple[str, ...] = (SUBSYSTEM_GOSSIP,
                                                SUBSYSTEM_IPSEC),
                 rotation_interval: float = DEFAULT_KEY_ROTATION_INTERVAL,
                 clock: Optional[Clock] = None) -> None:
        self.store = store
        self.cluster_id = cluster_id
        self.subsystems = subsystems
        self.rotation_interval = rotation_interval
        self.clock = clock or SystemClock()
        self._task: Optional[asyncio.Task] = None
        self._running = False

    def _cluster(self):
        if self.cluster_id:
            return self.store.get("cluster", self.cluster_id)
        clusters = self.store.find("cluster")
        return clusters[0] if clusters else None

    def _allocate_key(self, subsystem: str, lamport: int) -> EncryptionKey:
        return EncryptionKey(subsystem=subsystem, algorithm=AES_128_GCM,
                             key=os.urandom(DEFAULT_KEY_LEN),
                             lamport_time=lamport)

    async def start(self) -> None:
        await self.rotate_if_needed(initial=True)
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self) -> None:
        try:
            while self._running:
                await self.clock.sleep(self.rotation_interval)
                if self._running:
                    await self.rotate_if_needed()
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("key manager crashed")

    async def rotate_if_needed(self, initial: bool = False) -> None:
        """reference: rotateKey keymanager.go:124 — push a fresh key per
        subsystem, trim the ring to 3, bump the lamport clock."""
        cluster = self._cluster()
        if cluster is None:
            return
        if initial and cluster.network_bootstrap_keys:
            return  # keys exist; nothing to seed

        def txn(tx):
            cl = tx.get("cluster", cluster.id)
            if cl is None:
                return
            cl = cl.copy()
            cl.encryption_key_lamport_clock += 1
            lamport = cl.encryption_key_lamport_clock
            keep: list[EncryptionKey] = []
            for subsys in self.subsystems:
                ring = [k for k in cl.network_bootstrap_keys
                        if k.subsystem == subsys]
                ring.append(self._allocate_key(subsys, lamport))
                ring.sort(key=lambda k: -k.lamport_time)
                keep.extend(ring[:KEYRING_SIZE])
            cl.network_bootstrap_keys = keep
            tx.update(cl)
        await self.store.update(txn)
