"""Network allocator: assigns network resources before tasks can schedule.

Reference: manager/allocator/ (allocator.go actor loop; network.go
doNetworkInit :70 / doNetworkAlloc :164 / doNodeAlloc :307 / doTaskAlloc;
cnmallocator/networkallocator.go IPAM; portallocator.go).  Tasks enter the
cluster in NEW and only become PENDING (schedulable) once every allocator has
acted — here that means: their service's endpoint (VIPs, published ports) and
their network attachments exist.

TPU-era simplification: a flat in-process IPAM — sequential /24 subnets from
10.<n>.0.0, sequential host addresses, and a dynamic published-port range
from 30000 (reference dynamicPortStart portallocator.go) — no external
drivers.  The allocation *protocol* (watch → allocate → PENDING, idempotent
re-allocation on restore) mirrors the reference.

The port's own copy of the JAX package's manager/allocator.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from swarmkit_tpu_torch.api import TaskState
from swarmkit_tpu_torch.api.types import (
    Endpoint, EndpointVIP, IPAMConfig, IPAMOptions, NetworkAttachment,
    PortConfig,
)
from swarmkit_tpu_torch.store.memory import Event, EventCommit, MemoryStore, match, match_commit
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock

log = logging.getLogger("swarmkit_tpu_torch.allocator")

DYNAMIC_PORT_START = 30000   # reference: portallocator.go dynamicPortStart
DYNAMIC_PORT_END = 32767
INGRESS_NETWORK_NAME = "ingress"


def _gateway(subnet: str) -> str:
    """NETWORK base address + 1 — the host bits of the spec address are
    masked off first, so 10.5.0.7/24 -> 10.5.0.1 and non-octet-aligned
    subnets work too (192.168.7.128/25 -> 192.168.7.129)."""
    addr, prefix = subnet.split("/")
    parts = [int(x) for x in addr.split(".")]
    raw = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
    v = (raw & ~((1 << (32 - int(prefix))) - 1)) + 1
    return f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"


class PortConflict(Exception):
    """An explicitly requested published port is already taken
    (reference: portallocator.go allocation error)."""


class SubnetExhausted(Exception):
    """A network's subnets have no free host addresses left."""


class _Subnet:
    """One CIDR pool with a sequential cursor (.1 reserved as gateway)."""

    def __init__(self, cidr: str) -> None:
        self.cidr = cidr
        addr, prefix = cidr.split("/")
        self.prefix = int(prefix)
        parts = [int(x) for x in addr.split(".")]
        raw = (parts[0] << 24) | (parts[1] << 16) \
            | (parts[2] << 8) | parts[3]
        self.size = 1 << (32 - self.prefix)
        # normalize to the network base: a spec subnet like 10.5.0.7/24
        # means the 10.5.0.0/24 network (reference IPAM parses CIDRs with
        # net.ParseCIDR, which masks the host bits the same way)
        self.base = raw & ~(self.size - 1)
        self.next_host = 2           # .0 network, .1 gateway
        self.used: set[int] = set()

    def _fmt(self, off: int) -> str:
        v = self.base + off
        return (f"{(v >> 24) & 255}.{(v >> 16) & 255}."
                f"{(v >> 8) & 255}.{v & 255}/{self.prefix}")

    def allocate(self) -> Optional[str]:
        while self.next_host < self.size - 1:   # last addr = broadcast
            off = self.next_host
            self.next_host += 1
            if off not in self.used:
                self.used.add(off)
                return self._fmt(off)
        return None

    def contains(self, addr: str) -> bool:
        parts = [int(x) for x in addr.split("/")[0].split(".")]
        v = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
        return self.base <= v < self.base + self.size

    def note(self, addr: str) -> None:
        parts = [int(x) for x in addr.split("/")[0].split(".")]
        v = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
        self.used.add(v - self.base)


class IPAM:
    """Multi-pool IPAM: user-configured subnets (NetworkSpec.ipam configs,
    reference cnmallocator IPAM options) or auto-assigned 10.<n>.0.0/24
    pools; a network GROWS an extra auto pool when its subnets fill
    (reference networks carry multiple IPAMConfig entries)."""

    def __init__(self) -> None:
        self._next_auto = 1
        self._pools: dict[str, list[_Subnet]] = {}

    def subnets(self, network_id: str) -> list[str]:
        return [sn.cidr for sn in self._pools.get(network_id, [])]

    def _overlaps(self, sn: "_Subnet") -> bool:
        for pools in self._pools.values():
            for other in pools:
                if (sn.base < other.base + other.size
                        and other.base < sn.base + sn.size):
                    return True
        return False

    def _auto_cidr(self) -> str:
        cidr = f"10.{self._next_auto}.0.0/24"
        self._next_auto += 1
        return cidr

    def allocate_subnet(self, network_id: str,
                        requested: str = "") -> str:
        return self.allocate_subnets(network_id,
                                     [requested] if requested else [])[0]

    def allocate_subnets(self, network_id: str,
                         requested: list[str]) -> list[str]:
        """Allocate ALL of `requested` (or one auto pool if empty)
        atomically: every subnet is validated against existing pools AND
        each other before any is registered, so a rejection leaks
        nothing."""
        new: list[_Subnet] = []

        def clashes(sn: _Subnet) -> bool:
            return self._overlaps(sn) or any(
                sn.base < o.base + o.size and o.base < sn.base + sn.size
                for o in new)

        for cidr in requested:
            sn = _Subnet(cidr)
            if clashes(sn):
                raise ValueError(
                    f"subnet {cidr} overlaps an allocated pool")
            new.append(sn)
        if not new:
            # auto pools skip over anything a user subnet already covers
            sn = _Subnet(self._auto_cidr())
            while clashes(sn):
                sn = _Subnet(self._auto_cidr())
            new.append(sn)
        self._pools.setdefault(network_id, []).extend(new)
        return [sn.cidr for sn in new]

    def release_network(self, network_id: str) -> None:
        """Drop every pool the network held (network removal) so its
        subnets become allocatable again."""
        self._pools.pop(network_id, None)

    def grow(self, network_id: str) -> str:
        """Append a fresh auto pool once the existing subnets fill."""
        return self.allocate_subnet(network_id)

    def restore_subnet(self, network_id: str, subnet: str) -> None:
        self._pools.setdefault(network_id, []).append(_Subnet(subnet))
        try:
            parts = subnet.split("/")[0].split(".")
            if parts[0] == "10":
                self._next_auto = max(self._next_auto, int(parts[1]) + 1)
        except (ValueError, IndexError):
            pass

    def allocate_address(self, network_id: str) -> str:
        if network_id not in self._pools:
            self.allocate_subnet(network_id)
        for sn in self._pools[network_id]:
            addr = sn.allocate()
            if addr is not None:
                return addr
        raise SubnetExhausted(
            f"network {network_id}: all subnets exhausted")

    def restore_address(self, network_id: str, addr: str) -> None:
        for sn in self._pools.get(network_id, []):
            if sn.contains(addr):
                sn.note(addr)
                return


class _PortSpace:
    """One protocol's port space (reference portallocator.go portSpace):
    a master set holding every allocation 1-65535 plus a dynamic cursor
    over [30000, 32767] that wraps, so churned dynamic ports are reusable
    after release."""

    def __init__(self) -> None:
        self.master: set[int] = set()
        self.cursor = DYNAMIC_PORT_START

    def allocate(self, port: int = 0) -> int:
        if port:
            if port in self.master:
                raise PortConflict(f"port {port} is already published")
            self.master.add(port)
            return port
        span = DYNAMIC_PORT_END - DYNAMIC_PORT_START + 1
        for _ in range(span):
            cand = self.cursor
            self.cursor += 1
            if self.cursor > DYNAMIC_PORT_END:
                self.cursor = DYNAMIC_PORT_START
            if cand not in self.master:
                self.master.add(cand)
                return cand
        raise PortConflict("dynamic port space exhausted")

    def release(self, port: int) -> None:
        self.master.discard(port)


class PortAllocator:
    """Published-port bookkeeping, one space PER PROTOCOL
    (reference: portallocator.go portSpaces map keyed tcp/udp/sctp)."""

    def __init__(self) -> None:
        self._spaces: dict[str, _PortSpace] = {}

    def _space(self, proto: str) -> _PortSpace:
        return self._spaces.setdefault(proto or "tcp", _PortSpace())

    def allocate(self, proto: str, port: int = 0) -> int:
        try:
            return self._space(proto).allocate(port)
        except PortConflict as e:
            raise PortConflict(f"{proto} {e}") from None

    def restore(self, proto: str, port: int) -> None:
        self._space(proto).master.add(port)

    def release(self, proto: str, port: int) -> None:
        self._space(proto).release(port)


class Allocator:
    """reference: allocator.Allocator allocator.go:16 (network actor only —
    the sole actor in the reference too)."""

    def __init__(self, store: MemoryStore, clock: Optional[Clock] = None
                 ) -> None:
        self.store = store
        self.clock = clock or SystemClock()
        self.ipam = IPAM()
        self.ports = PortAllocator()
        self._pending_tasks: set[str] = set()
        self._pending_services: set[str] = set()
        self._pending_networks: set[str] = set()
        self._task: Optional[asyncio.Task] = None
        self._running = False

    async def start(self) -> None:
        watcher = self.store.watch(match(kind="task"), match(kind="service"),
                                   match(kind="network"), match_commit)
        # restore state from the store (reference: doNetworkInit network.go:70)
        for net in self.store.find("network"):
            if net.ipam is not None and net.ipam.configs:
                for c in net.ipam.configs:
                    self.ipam.restore_subnet(net.id, c.subnet)
            else:
                self._pending_networks.add(net.id)
        for svc in self.store.find("service"):
            ep = svc.endpoint
            if ep is not None:
                for vip in ep.virtual_ips:
                    self.ipam.restore_address(vip.network_id, vip.addr)
                for p in ep.ports:
                    if p.published_port and p.publish_mode == "ingress":
                        self.ports.restore(p.protocol, p.published_port)
            if not self._service_allocated(svc):
                self._pending_services.add(svc.id)
        for t in self.store.find("task"):
            if t.status.state == TaskState.NEW:
                self._pending_tasks.add(t.id)
            for att in t.networks:
                for addr in att.addresses:
                    self.ipam.restore_address(att.network_id, addr)
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run(watcher))

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self, watcher) -> None:
        try:
            if self._pending_networks or self._pending_services \
                    or self._pending_tasks:
                await self.tick()
            while self._running:
                ev = await watcher.get()
                if isinstance(ev, Event):
                    self._handle(ev)
                elif isinstance(ev, EventCommit) and (
                        self._pending_tasks or self._pending_services
                        or self._pending_networks):
                    await self.tick()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("allocator crashed")

    def _handle(self, ev: Event) -> None:
        if ev.action == "remove":
            if ev.kind == "service" and ev.object.endpoint is not None:
                for p in ev.object.endpoint.ports:
                    if p.published_port and p.publish_mode == "ingress":
                        self.ports.release(p.protocol, p.published_port)
            elif ev.kind == "network":
                # free the network's subnets so an overlapping (or
                # identical) subnet can be allocated again
                self.ipam.release_network(ev.object.id)
            return
        if ev.kind == "network":
            self._pending_networks.add(ev.object.id)
        elif ev.kind == "service":
            if not self._service_allocated(ev.object):
                self._pending_services.add(ev.object.id)
        elif ev.kind == "task":
            if ev.object.status.state == TaskState.NEW:
                self._pending_tasks.add(ev.object.id)

    # ------------------------------------------------------------------
    def _service_allocated(self, svc) -> bool:
        spec_ep = svc.spec.endpoint
        if spec_ep is None or not spec_ep.ports:
            return True
        if svc.endpoint is None or svc.endpoint.spec is None:
            return False
        if svc.endpoint.spec.to_dict() != spec_ep.to_dict():
            return False  # spec changed since last allocation
        # only ingress-mode ports receive dynamic published ports; host-mode
        # ports without an explicit published_port stay 0 by design
        have = {(p.protocol, p.target_port) for p in svc.endpoint.ports
                if p.published_port}
        want = {(p.protocol, p.target_port) for p in spec_ep.ports
                if p.publish_mode == "ingress" or p.published_port}
        return want <= have

    async def tick(self) -> None:
        nets, self._pending_networks = self._pending_networks, set()
        for nid in nets:
            await self._alloc_network(nid)
        svcs, self._pending_services = self._pending_services, set()
        for sid in svcs:
            await self._alloc_service(sid)
        tasks, self._pending_tasks = self._pending_tasks, set()
        if tasks:
            await self._alloc_tasks(tasks)

    def _address_with_growth(self, tx, network_id: str) -> Optional[str]:
        """Allocate an address, GROWING the network by a fresh auto subnet
        when its pools fill (persisted to the network record so restore
        sees every pool).  None only when growth itself is impossible."""
        try:
            return self.ipam.allocate_address(network_id)
        except SubnetExhausted:
            pass
        subnet = self.ipam.grow(network_id)
        net = tx.get("network", network_id)
        if net is not None:
            if net.ipam is None:
                net.ipam = IPAMOptions(driver="default", configs=[])
            net.ipam.configs.append(IPAMConfig(
                subnet=subnet, gateway=_gateway(subnet)))
            tx.update(net)
        try:
            return self.ipam.allocate_address(network_id)
        except SubnetExhausted:
            return None

    async def _alloc_network(self, network_id: str) -> None:
        """reference: doNetworkAlloc network.go:164 — user-configured
        subnets (spec.ipam, cnmallocator IPAM options) are honored;
        otherwise an auto 10.<n>.0.0/24 pool is assigned."""
        def txn(tx):
            net = tx.get("network", network_id)
            if net is None:
                return
            if net.ipam is not None and net.ipam.configs:
                return  # already allocated
            requested = []
            if net.spec.ipam is not None:
                requested = [c.subnet for c in net.spec.ipam.configs
                             if c.subnet]
            try:
                subnets = self.ipam.allocate_subnets(network_id, requested)
            except ValueError as e:
                # a bad/overlapping user subnet is THIS network's failure,
                # not the allocator loop's: leave the network unallocated
                # and keep serving everyone else (reference: doNetworkAlloc
                # logs and continues, allocator.go actor loop survives)
                log.warning("network %s allocation rejected: %s",
                            network_id, e)
                return
            net.ipam = IPAMOptions(driver="default", configs=[
                IPAMConfig(subnet=sn, gateway=_gateway(sn))
                for sn in subnets])
            tx.update(net)
        await self.store.update(txn)

    async def _alloc_service(self, service_id: str) -> None:
        """Allocate endpoint: published ports + VIPs
        (reference: allocateService networkallocator)."""
        def txn(tx):
            svc = tx.get("service", service_id)
            if svc is None or self._service_allocated(svc):
                return
            spec_ep = svc.spec.endpoint
            ep = svc.endpoint or Endpoint()
            ep.spec = spec_ep.copy()
            existing = {(p.protocol, p.target_port): p for p in ep.ports}
            # decide which current allocations survive the new spec: same
            # mode and either dynamic or the same explicit published port
            reused: set[tuple[str, int]] = set()
            plan: list[tuple] = []  # (spec port, reuse cur | None)
            for p in spec_ep.ports:
                cur = existing.get((p.protocol, p.target_port))
                if (cur is not None and cur.published_port
                        and cur.publish_mode == p.publish_mode
                        and p.published_port in (0, cur.published_port)):
                    plan.append((p, cur))
                    # only ingress ports live in the allocator's books; a
                    # reused host-mode port must not shield a dropped
                    # ingress port with the same number from release
                    if cur.publish_mode == "ingress":
                        reused.add((cur.protocol, cur.published_port))
                else:
                    plan.append((p, None))
            # release ports the new spec dropped or changed BEFORE
            # allocating, so swapping a port within one update works
            # (reference: portallocator serviceDeallocatePorts on update).
            # Only ingress ports live in the allocator's books — host-mode
            # ports are per-node and never tracked.
            released = [(c.protocol, c.published_port)
                        for c in existing.values()
                        if c.published_port and c.publish_mode == "ingress"
                        and (c.protocol, c.published_port) not in reused]
            for proto, port in released:
                self.ports.release(proto, port)
            ports = []
            fresh: list[tuple[str, int]] = []
            for p, cur in plan:
                if cur is not None:
                    ports.append(cur)
                    continue
                try:
                    published = self.ports.allocate(
                        p.protocol, p.published_port) \
                        if p.publish_mode == "ingress" else p.published_port
                except PortConflict as e:
                    # leave the service unallocated; roll back this pass so
                    # the allocator's books match the (unchanged) store
                    # (reference: allocator records the error and retries)
                    for proto, port in fresh:
                        self.ports.release(proto, port)
                    for proto, port in released:
                        self.ports.restore(proto, port)
                    log.warning("service %s: %s", service_id, e)
                    return
                if published and p.publish_mode == "ingress":
                    fresh.append((p.protocol, published))
                ports.append(PortConfig(
                    name=p.name, protocol=p.protocol,
                    target_port=p.target_port, published_port=published,
                    publish_mode=p.publish_mode))
            ep.ports = ports
            # one VIP per attached network (+ ingress implicit for ports)
            want_nets = list(svc.spec.networks) or list(svc.spec.task.networks)
            have_vips = {v.network_id for v in ep.virtual_ips}
            for nid in want_nets:
                if nid not in have_vips:
                    addr = self._address_with_growth(tx, nid)
                    if addr is None:
                        log.warning("service %s VIP: network %s exhausted",
                                    service_id, nid)
                        continue
                    ep.virtual_ips.append(EndpointVIP(network_id=nid,
                                                      addr=addr))
            svc.endpoint = ep
            tx.update(svc)
        await self.store.update(txn)

    async def _alloc_tasks(self, task_ids: set[str]) -> None:
        """reference: doTaskAlloc + taskBallot allocator.go:45 — move NEW
        tasks to PENDING once their resources exist."""
        batch = self.store.batch()
        for tid in task_ids:
            def txn(tx, tid=tid):
                t = tx.get("task", tid)
                if t is None or t.status.state != TaskState.NEW:
                    return
                svc = tx.get("service", t.service_id) if t.service_id else None
                if svc is not None and not self._service_allocated(svc):
                    self._pending_tasks.add(tid)  # retry after service alloc
                    return
                # attach task to its networks
                want = list(t.spec.networks)
                if svc is not None:
                    want = want or list(svc.spec.networks)
                have = {a.network_id for a in t.networks}
                for nid in want:
                    if nid in have:
                        continue
                    net = tx.get("network", nid)
                    if net is None:
                        continue
                    addr = self._address_with_growth(tx, nid)
                    if addr is None:
                        log.warning("task %s: network %s exhausted",
                                    tid, nid)
                        continue
                    drv = ""
                    if net.spec.driver_config is not None:
                        drv = net.spec.driver_config.name
                    t.networks.append(NetworkAttachment(
                        network_id=nid, addresses=[addr], driver=drv))
                if svc is not None and svc.endpoint is not None:
                    t.endpoint = svc.endpoint.copy()
                t.status.state = TaskState.PENDING
                t.status.message = "pending task scheduling"
                t.status.timestamp = self.clock.now()
                tx.update(t)
            await batch.update(txn)
        await batch.commit()
