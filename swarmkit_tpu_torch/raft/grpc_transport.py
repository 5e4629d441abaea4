"""Transport impl #2: the raft wire over real gRPC sockets.

Reference: manager/state/raft/transport/ + api/raft.proto — services
``Raft.ProcessRaftMessage`` (:12) and ``RaftMembership.Join/Leave`` (:37),
4 MiB message cap with snapshot chunking (transport/peer.go:24,:156),
NotLeader redirects carrying the leader address, and ErrMemberRemoved as a
typed RPC error.

``GrpcNetwork`` is a drop-in for the in-process ``Network`` seam
(raft/transport.py): ``register`` starts a grpc.aio server for the local
raft node, ``server(frm, to)`` returns a stub whose calls cross real
sockets.  Wire format is msgpack, through the port's own codec in
raft/wire.py (the generic-handler path — no protoc
codegen, mirroring the hand-rolled Message dataclasses), with large
snapshots split into ≤4 MiB chunks over a client-streaming RPC exactly
like StreamRaftMessage.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional

import grpc

from swarmkit_tpu_torch.metrics import catalog as obs_catalog
from swarmkit_tpu_torch.metrics import registry as obs_registry
from swarmkit_tpu_torch.raft.faults import FaultSurface
from swarmkit_tpu_torch.raft.messages import (
    ConfChange, ConfChangeType, Entry, EntryType, Message, MsgType, Snapshot,
    SnapshotMeta,
)
from swarmkit_tpu_torch.raft.transport import PeerRemoved, Unreachable
from swarmkit_tpu_torch.raft.wire import packb, unpackb

log = logging.getLogger("swarmkit_tpu_torch.raft.grpc")

GRPC_MAX_MSG_SIZE = 4 * 1024 * 1024   # reference: peer.go:24
_CHUNK = GRPC_MAX_MSG_SIZE - (64 * 1024)   # headroom for framing

_SVC = "swarmkit.Raft"
_BOOT = "swarmkit.Bootstrap"
_MEM = "swarmkit.RaftMembership"


# --------------------------------------------------------------------------
# codec: the shared versioned raft wire format (one codec for every
# transport — device-mesh mailboxes and this gRPC bridge must interoperate)

from swarmkit_tpu_torch.raft.wire import decode_message, encode_message  # noqa: E402,F401

_IDENT = lambda b: b


# --------------------------------------------------------------------------
# server side

class _RaftService:
    """Hosts one local raft node behind the gRPC services.

    With a SecurityConfig every raft RPC is manager-only, authorized from
    the mTLS peer certificate (reference: api/raft.proto tls_authorization
    roles=swarm-manager; ca/auth.go AuthorizeOrgAndRole)."""

    def __init__(self, node, security=None) -> None:
        self.node = node
        self.security = security

    async def _authorize(self, context) -> None:
        if self.security is None:
            return
        from swarmkit_tpu_torch.ca.auth import PermissionDenied
        from swarmkit_tpu_torch.ca.certificates import MANAGER_ROLE_OU
        from swarmkit_tpu_torch.ca.tlsutil import authorize_peer

        try:
            authorize_peer(context, self.security, MANAGER_ROLE_OU)
        except PermissionDenied as e:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))

    async def process_raft_message(self, request: bytes, context) -> bytes:
        await self._authorize(context)
        try:
            await self.node.process_raft_message(decode_message(request))
        except PeerRemoved:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED,
                                "member removed")
        return b""

    # Reassembled stream cap: bounds a misbehaving peer's buffering before
    # the message is even parsed (the per-message gRPC cap is 4 MiB; a
    # snapshot stream may legitimately span many chunks).
    MAX_STREAM_BYTES = 512 * 1024 * 1024

    async def stream_raft_message(self, request_iterator, context) -> bytes:
        """Chunked delivery for big snapshots
        (reference: StreamRaftMessage raft.go:1330; reassembly then Step).
        Authorization runs BEFORE consuming the stream so an unauthorized
        peer cannot make us buffer unbounded data."""
        await self._authorize(context)
        chunks, total = [], 0
        async for chunk in request_iterator:
            total += len(chunk)
            if total > self.MAX_STREAM_BYTES:
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                    "stream exceeds reassembly cap")
            chunks.append(chunk)
        return await self.process_raft_message(b"".join(chunks), context)

    async def join(self, request: bytes, context) -> bytes:
        from swarmkit_tpu_torch.raft.node import NotLeaderError

        await self._authorize(context)
        node_id, addr = unpackb(request)
        try:
            resp = await self.node.join(node_id, addr)
        except NotLeaderError as e:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                f"not-leader:{e.leader_addr}")
        return packb((
            resp.raft_id,
            [(m.raft_id, m.node_id, m.addr) for m in resp.members],
            list(resp.removed)))

    async def leave(self, request: bytes, context) -> bytes:
        await self._authorize(context)
        (raft_id,) = unpackb(request)
        await self.node.leave(raft_id)
        return b""

    def handlers(self) -> list:
        raft = grpc.method_handlers_generic_handler(_SVC, {
            "ProcessRaftMessage": grpc.unary_unary_rpc_method_handler(
                self.process_raft_message,
                request_deserializer=_IDENT, response_serializer=_IDENT),
            "StreamRaftMessage": grpc.stream_unary_rpc_method_handler(
                self.stream_raft_message,
                request_deserializer=_IDENT, response_serializer=_IDENT),
        })
        membership = grpc.method_handlers_generic_handler(_MEM, {
            "Join": grpc.unary_unary_rpc_method_handler(
                self.join,
                request_deserializer=_IDENT, response_serializer=_IDENT),
            "Leave": grpc.unary_unary_rpc_method_handler(
                self.leave,
                request_deserializer=_IDENT, response_serializer=_IDENT),
        })
        return [raft, membership]


# --------------------------------------------------------------------------
# client side

class _RemoteStub:
    """What ``GrpcNetwork.server(frm, to)`` hands the raft node/transport:
    the same duck type as a local raft node, backed by RPCs."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._process = channel.unary_unary(
            f"/{_SVC}/ProcessRaftMessage",
            request_serializer=_IDENT, response_deserializer=_IDENT)
        self._stream = channel.stream_unary(
            f"/{_SVC}/StreamRaftMessage",
            request_serializer=_IDENT, response_deserializer=_IDENT)
        self._join = channel.unary_unary(
            f"/{_MEM}/Join",
            request_serializer=_IDENT, response_deserializer=_IDENT)
        self._leave = channel.unary_unary(
            f"/{_MEM}/Leave",
            request_serializer=_IDENT, response_deserializer=_IDENT)

    async def process_raft_message(self, m: Message) -> None:
        raw = encode_message(m)
        try:
            if len(raw) > _CHUNK:
                async def chunks():
                    for off in range(0, len(raw), _CHUNK):
                        yield raw[off:off + _CHUNK]
                await self._stream(chunks())
            else:
                await self._process(raw)
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e)

    async def join(self, node_id: str, addr: str):
        from swarmkit_tpu_torch.raft.node import JoinResponse, NotLeaderError
        from swarmkit_tpu_torch.raft.membership import Member

        try:
            raw = await self._join(packb((node_id, addr)))
        except grpc.aio.AioRpcError as e:
            details = e.details() or ""
            if e.code() == grpc.StatusCode.FAILED_PRECONDITION \
                    and details.startswith("not-leader:"):
                raise NotLeaderError(details.split(":", 1)[1])
            raise _map_rpc_error(e)
        raft_id, members, removed = unpackb(raw)
        return JoinResponse(
            raft_id=raft_id,
            members=[Member(raft_id=r, node_id=n, addr=a)
                     for r, n, a in members],
            removed=list(removed))

    async def leave(self, raft_id: int) -> None:
        try:
            await self._leave(packb((raft_id,)))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e)


def _map_rpc_error(e: grpc.aio.AioRpcError) -> Exception:
    if e.code() == grpc.StatusCode.PERMISSION_DENIED \
            and "member removed" in (e.details() or ""):
        return PeerRemoved(e.details())
    return Unreachable(f"rpc failed: {e.code().name}: {e.details()}")


# --------------------------------------------------------------------------
# active peer health probing

class _PeerProber:
    """Active health probe for one peer address.

    Serves ``GrpcNetwork.healthy``/``reachable`` the way the reference's
    raft transport consumes manager/health (health.go:21, raft.go:1422):
    a loop Checks the peer's Health service; ``failure_threshold``
    consecutive failures flip the peer unhealthy, redials back off
    exponentially with jitter, and recovery requires sustained success
    spanning ``grace_period`` so a flapping peer does not oscillate the
    vote-health gate."""

    def __init__(self, net: "GrpcNetwork", addr: str) -> None:
        self.net = net
        self.addr = addr
        self.failures = 0          # consecutive probe failures
        self._healthy = True       # optimistic until proven otherwise
        self._first_ok: Optional[float] = None
        obs = net.obs
        self._m_probes = obs_catalog.get(
            obs, "swarm_transport_probes_total")
        self._m_transitions = obs_catalog.get(
            obs, "swarm_transport_probe_transitions_total")
        self._m_healthy = obs_catalog.get(
            obs, "swarm_transport_probe_healthy").labels(peer=addr)
        self._m_healthy.set(1.0)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    @property
    def healthy(self) -> bool:
        return self._healthy

    def _set_healthy(self, healthy: bool) -> None:
        if healthy == self._healthy:
            return
        self._healthy = healthy
        state = "healthy" if healthy else "unhealthy"
        self._m_transitions.labels(peer=self.addr, state=state).inc()
        self._m_healthy.set(1.0 if healthy else 0.0)

    def reset(self) -> None:
        """Forget accumulated failure state (peer process bounced)."""
        self.failures = 0
        self._first_ok = None

    def stop(self) -> None:
        self._task.cancel()

    async def _probe_once(self) -> bool:
        if self.addr in self.net._down:
            return False
        # Injected partitions block at the dial seam, not the socket, so the
        # health RPC itself would still succeed — mirror the block here so
        # probe state flips the way a real severed link would make it.
        frms = [a for a in self.net._local if a != self.addr]
        if frms and all(self.net._fault_blocked(f, self.addr) for f in frms):
            return False
        try:
            raw = await asyncio.wait_for(
                self.net._health_call(self.addr)(packb("Raft")),
                timeout=self.net.probe_timeout)
            return unpackb(raw) == 1   # HealthStatus.SERVING
        except asyncio.CancelledError:
            raise
        except Exception:
            return False

    async def _loop(self) -> None:
        net = self.net
        while True:
            ok = await self._probe_once()
            self._m_probes.labels(
                peer=self.addr, result="ok" if ok else "fail").inc()
            now = asyncio.get_running_loop().time()
            if ok:
                self.failures = 0
                if not self._healthy:
                    if self._first_ok is None:
                        self._first_ok = now
                    if now - self._first_ok >= net.grace_period:
                        self._set_healthy(True)
                        self._first_ok = None
                await asyncio.sleep(
                    net.probe_interval * (0.75 + 0.5 * net._rng.random()))
            else:
                self.failures += 1
                self._first_ok = None
                if self.failures >= net.failure_threshold:
                    self._set_healthy(False)
                base, cap = net.dial_backoff
                delay = min(cap, base * (2 ** min(self.failures - 1, 8)))
                await asyncio.sleep(delay * (0.5 + 0.5 * net._rng.random()))


# --------------------------------------------------------------------------
# the Network-shaped seam

class GrpcNetwork(FaultSurface):
    """Drop-in for raft.transport.Network over real sockets.

    Addresses are host:port listen addresses.  ``register`` starts a
    grpc.aio server for the node (raft + a gRPC health service);
    ``server(frm, to)`` returns a cached remote stub, refusing the dial
    when fault injection blocks the edge — the same down/drop/partition/
    delay vocabulary as the in-process Network (FaultSurface).
    ``healthy``/``reachable`` are backed by active peer probing
    (_PeerProber) instead of the seed's hardcoded True, so vote-health
    gating and the CanRemoveMember quorum precheck operate for real
    across processes.
    """

    wire_name = "grpc"   # transport metric label (see metrics/catalog.py)

    def __init__(self, security=None, seed: int = 0,
                 probe_interval: float = 0.5,
                 probe_timeout: float = 1.0,
                 failure_threshold: int = 3,
                 grace_period: float = 1.0,
                 redial_backoff: float = 0.05,
                 redial_backoff_max: float = 2.0,
                 obs: Optional[obs_registry.MetricsRegistry] = None) -> None:
        # security: a ca.SecurityConfig or a zero-arg callable returning one
        # (late-bound: swarmd loads its identity after the network object
        # exists). When set, the listener serves with TLS from the node
        # identity (client certs verified when presented) and every dialed
        # channel is mutual-TLS; raft RPCs then require the swarm-manager
        # role OU (reference: manager.go:252-270 + ca/auth.go). A companion
        # plaintext BOOTSTRAP port (port+1) serves only the public root CA
        # certificate so joiners can pin it against their token digest (the
        # python-grpc analog of the reference's InsecureSkipVerify +
        # digest-pin GetRemoteCA, ca/certificates.go).
        # None = plaintext, for in-process tests only.
        super().__init__(seed=seed)
        self.obs = obs or obs_registry.DEFAULT
        self._security_arg = security
        self._servers: dict[str, grpc.aio.Server] = {}
        self._channels: dict[str, grpc.aio.Channel] = {}
        self._stubs: dict[str, _RemoteStub] = {}
        self._local: dict[str, Any] = {}
        self._extra_handlers: dict[str, list] = {}
        self._join_handlers: dict[str, list] = {}
        self._bind_map: dict[str, str] = {}   # advertise -> bind address
        # health-probe knobs (see _PeerProber)
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.failure_threshold = failure_threshold
        self.grace_period = grace_period
        # redial backoff (base, cap): consumed both by _PeerProber and by
        # the shared transport's per-peer drain loop (_Peer._redial_backoff)
        self.dial_backoff = (redial_backoff, redial_backoff_max)
        self._probers: dict[str, _PeerProber] = {}
        self._health_rpcs: dict[str, Any] = {}
        # addr -> HealthServer (or zero-arg callable returning one); set by
        # the manager before its raft node registers (Manager.start)
        self._health_refs: dict[str, Any] = {}

    @property
    def security(self):
        s = self._security_arg
        return s() if callable(s) else s

    def add_service(self, addr: str, handlers: list) -> None:
        """Queue extra generic handlers (dispatcher/CA/control services) to
        serve alongside the raft services once ``register`` runs — gRPC
        servers only accept handlers before start."""
        self._extra_handlers.setdefault(addr, []).extend(handlers)

    def set_bind_addr(self, advertise: str, listen: str) -> None:
        """Bind `listen` for the server whose ADVERTISED address is
        `advertise` (reference --listen-remote-api vs
        --advertise-remote-api: wildcard/NAT-internal binds with a
        dialable advertised address). Call before register()."""
        self._bind_map[advertise] = listen

    def set_health(self, addr: str, health_ref) -> None:
        """Point the wire health service for `addr` at a HealthServer (or a
        zero-arg callable returning one). The manager calls this before its
        raft node registers, promoting manager/health.py onto the wire
        (reference: the HealthServer registration manager.go:526-548)."""
        self._health_refs[addr] = health_ref

    def _health_check_fn(self, addr: str, node: Any):
        """Per-service status for this listener: the manager's HealthServer
        when one is wired, else derived from the raft node's liveness (bare
        raft-node clusters in tests/tools have no manager)."""
        def check(service: str) -> int:
            ref = self._health_refs.get(addr)
            h = ref() if callable(ref) else ref
            if h is not None:
                status = int(h.check(service))
                if status != 0:       # not UNKNOWN
                    return status
            current = self._local.get(addr)
            target = current if current is not None else node
            return 1 if getattr(target, "running", True) else 2
        return check

    def register(self, addr: str, node: Any) -> None:
        # gRPC server startup is async; do it lazily-but-synchronously via
        # the running loop (register is called from async context in
        # node.start)
        from swarmkit_tpu_torch.rpc import health_handlers

        self._local[addr] = node
        self._down.discard(addr)
        bind = self._bind_map.get(addr, addr)
        loop = asyncio.get_event_loop()
        server = grpc.aio.server(options=[
            ("grpc.max_send_message_length", GRPC_MAX_MSG_SIZE),
            ("grpc.max_receive_message_length", GRPC_MAX_MSG_SIZE),
        ])
        for h in _RaftService(node, security=self.security).handlers():
            server.add_generic_rpc_handlers((h,))
        for h in health_handlers(self._health_check_fn(addr, node)):
            server.add_generic_rpc_handlers((h,))
        for h in self._extra_handlers.get(addr, ()):
            server.add_generic_rpc_handlers((h,))
        if self.security is not None:
            from swarmkit_tpu_torch.ca.tlsutil import server_credentials

            bound = server.add_secure_port(bind,
                                           server_credentials(self.security))
        else:
            bound = server.add_insecure_port(bind)
        if bound == 0:
            raise RuntimeError(f"cannot bind raft listener on {bind}")
        self._servers[addr] = server
        loop.create_task(server.start())
        if self.security is not None:
            self._start_bootstrap(addr, loop)

    def add_join_service(self, addr: str, handlers: list) -> None:
        """Handlers served to certificate-less joiners on the TLS join port
        (port+2): certificate issuance + leader info."""
        self._join_handlers.setdefault(addr, []).extend(handlers)

    def _start_bootstrap(self, addr: str, loop) -> None:
        """Two companion listeners for the join dance (see ca/tlsutil):
        plaintext port+1 serves ONLY the public root CA certificate (joiners
        digest-pin it against their SWMTKN — the reference's
        InsecureSkipVerify + pin, ca/certificates.go GetRemoteCA; python-grpc
        cannot skip verify); TLS port+2 (server-auth only) serves
        certificate issuance so the join token never travels plaintext."""
        from swarmkit_tpu_torch.ca.tlsutil import join_server_credentials

        async def get_root(request: bytes, context) -> bytes:
            sec = self.security
            return sec.root_ca.cert_pem if sec is not None else b""

        host, port = self._bind_map.get(addr, addr).rsplit(":", 1)
        boot = grpc.aio.server()
        boot.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(_BOOT, {
                "GetRootCACertificate": grpc.unary_unary_rpc_method_handler(
                    get_root, request_deserializer=_IDENT,
                    response_serializer=_IDENT)}),))
        if boot.add_insecure_port(f"{host}:{int(port) + 1}") == 0:
            log.warning("cannot bind bootstrap listener on %s:%d — joins "
                        "from certificate-less nodes will fail",
                        host, int(port) + 1)
        else:
            self._servers[addr + "/bootstrap"] = boot
            loop.create_task(boot.start())

        join_handlers = self._join_handlers.get(addr, ())
        if join_handlers:
            join_srv = grpc.aio.server()
            for h in join_handlers:
                join_srv.add_generic_rpc_handlers((h,))
            if join_srv.add_secure_port(
                    f"{host}:{int(port) + 2}",
                    join_server_credentials(self.security)) == 0:
                log.warning("cannot bind join listener on %s:%d",
                            host, int(port) + 2)
            else:
                self._servers[addr + "/join"] = join_srv
                loop.create_task(join_srv.start())

    def unregister(self, addr: str) -> None:
        self._local.pop(addr, None)
        for key in (addr, addr + "/bootstrap", addr + "/join"):
            server = self._servers.pop(key, None)
            if server is not None:
                asyncio.get_event_loop().create_task(server.stop(grace=0.1))

    # -- dialing -----------------------------------------------------------
    def _channel(self, to: str) -> grpc.aio.Channel:
        channel = self._channels.get(to)
        if channel is None:
            options = [
                ("grpc.max_send_message_length", GRPC_MAX_MSG_SIZE),
                ("grpc.max_receive_message_length", GRPC_MAX_MSG_SIZE),
            ]
            if self.security is not None:
                from swarmkit_tpu_torch.ca.tlsutil import (
                    channel_credentials, secure_channel_options,
                )

                channel = grpc.aio.secure_channel(
                    to, channel_credentials(self.security),
                    options=secure_channel_options(options))
            else:
                channel = grpc.aio.insecure_channel(to, options=options)
            self._channels[to] = channel
        return channel

    def server(self, frm: str, to: str) -> _RemoteStub:
        """Dial: connection-level fault interception happens HERE — this is
        called per delivery attempt (the per-peer drain loop and the join
        flow), so an injected down/partition refuses the edge immediately,
        without touching the socket."""
        if self._fault_blocked(frm, to):
            raise Unreachable(f"{to} blocked from {frm} by fault injection")
        self._ensure_prober(to)
        stub = self._stubs.get(to)
        if stub is None:
            stub = _RemoteStub(self._channel(to))
            self._stubs[to] = stub
        return stub

    # -- health probing ----------------------------------------------------
    def _health_call(self, addr: str):
        call = self._health_rpcs.get(addr)
        if call is None:
            from swarmkit_tpu_torch.rpc import HEALTH_SVC

            call = self._channel(addr).unary_unary(
                f"/{HEALTH_SVC}/Check",
                request_serializer=_IDENT, response_deserializer=_IDENT)
            self._health_rpcs[addr] = call
        return call

    def _ensure_prober(self, addr: str) -> Optional[_PeerProber]:
        p = self._probers.get(addr)
        if p is None:
            try:
                p = _PeerProber(self, addr)
            except RuntimeError:
                return None   # no running loop (sync caller): stay optimistic
            self._probers[addr] = p
        return p

    # -- reachability (fault injection + live probe state) -----------------
    def reachable(self, frm: str, to: str) -> bool:
        if self._fault_blocked(frm, to):
            return False
        p = self._probers.get(to)
        return True if p is None else p.healthy

    def healthy(self, addr: str) -> bool:
        if addr in self._down:
            return False
        p = self._probers.get(addr) or self._ensure_prober(addr)
        return True if p is None else p.healthy

    def crash_restart(self, addr: str) -> None:
        """Sever cached wire state for a bounced process at `addr`: close
        its channel (in-flight RPCs fail, the next dial reconnects) and
        reset the prober's accumulated failure window."""
        self._stubs.pop(addr, None)
        self._health_rpcs.pop(addr, None)
        channel = self._channels.pop(addr, None)
        if channel is not None:
            try:
                asyncio.get_running_loop().create_task(channel.close())
            except RuntimeError:
                pass
        p = self._probers.get(addr)
        if p is not None:
            p.reset()

    async def close(self) -> None:
        for p in self._probers.values():
            p.stop()
        self._probers = {}
        for ch in self._channels.values():
            await ch.close()
        self._channels = {}
        self._stubs = {}
        self._health_rpcs = {}
        for server in self._servers.values():
            await server.stop(grace=0.1)
        self._servers = {}
