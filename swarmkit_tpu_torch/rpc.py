"""Cluster RPC services: dispatcher sessions, CA joins and control-API
forwarding over the same gRPC server the raft transport uses.

Reference: the manager's service registrations at manager/manager.go:526-548
(Dispatcher, CA/NodeCA, Control + the generated RaftProxy wrappers that
forward follower requests to the leader) and the agent's gRPC session
(api/dispatcher.proto).  With this module, swarmd's --join-addr/--join-token
work across real processes: workers join by token, open session/assignment
streams, and report statuses over sockets; control requests hitting a
follower are forwarded to the leader (the raftproxy analog).

Server side: ``add_cluster_services(net, addr, node_ref)`` queues generic
handlers on the GrpcNetwork before the raft server starts.  Client side:
``RemoteManager`` implements the Manager duck type the connection broker
needs (cached is_leader/leader_addr + remote dispatcher/CA/control).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable, Optional

import grpc

from swarmkit_tpu_torch.api import TaskStatus, WeightedPeer
from swarmkit_tpu_torch.api.dispatcher_msgs import (
    AssignmentsMessage, HeartbeatResponse, SessionMessage,
)
from swarmkit_tpu_torch.api.types import NodeDescription
from swarmkit_tpu_torch.ca.certificates import MANAGER_ROLE_OU, WORKER_ROLE_OU
from swarmkit_tpu_torch.metrics import trace as obs_trace
from swarmkit_tpu_torch.raft.wire import packb, unpackb

log = logging.getLogger("swarmkit_tpu_torch.rpc")

_DISP = "swarmkit.Dispatcher"
_LOGS = "swarmkit.LogBroker"
_CA = "swarmkit.CA"
_CTL = "swarmkit.Control"
_INFO = "swarmkit.Manager"
_WATCH = "swarmkit.Watch"
_RES = "swarmkit.ResourceAllocator"
HEALTH_SVC = "swarmkit.Health"

_IDENT = lambda b: b


class RpcError(Exception):
    pass


# --------------------------------------------------------------------------
# health on the wire (reference: manager/health/health.go served as the gRPC
# health-checking protocol, manager.go:526; consumed by the raft transport's
# peer probing and by `swarmctl`-style liveness checks)

def health_handlers(check: Callable[[str], int]) -> list:
    """Generic handlers serving the health Check RPC from `check(service)`,
    a callable returning a HealthStatus int (manager/health.py). The raft
    listener registers these so every manager answers health probes on the
    same port its raft service lives on."""

    async def check_rpc(request: bytes, context) -> bytes:
        service = unpackb(request) if request else ""
        try:
            status = int(check(service))
        except Exception:          # a crashing backend reads as NOT_SERVING
            status = 2
        return packb(status)

    return [grpc.method_handlers_generic_handler(HEALTH_SVC, {
        "Check": grpc.unary_unary_rpc_method_handler(
            check_rpc, request_deserializer=_IDENT,
            response_serializer=_IDENT)})]


async def check_health(channel: grpc.aio.Channel, service: str = "",
                       timeout: float = 2.0) -> int:
    """Client side of the health protocol: returns the HealthStatus int
    (1 = SERVING). Raises RpcError when the endpoint is unreachable."""
    call = channel.unary_unary(f"/{HEALTH_SVC}/Check",
                               request_serializer=_IDENT,
                               response_deserializer=_IDENT)
    try:
        raw = await asyncio.wait_for(call(packb(service)),
                                     timeout=timeout)
    except (grpc.aio.AioRpcError, asyncio.TimeoutError) as e:
        raise RpcError(f"health check failed: {e!r}")
    return unpackb(raw)


# --------------------------------------------------------------------------
# metrics on the wire: the /metrics scrape endpoint, served next to the
# health service on the manager's raft listener (the text analog of the
# reference's prometheus handler on the control socket)

METRICS_SVC = "swarmkit.Metrics"


def metrics_handlers(scrape: Callable[[], str]) -> list:
    """Generic handlers serving ``Scrape`` from `scrape()`, a callable
    returning the Prometheus text exposition (Manager.metrics_text)."""

    async def scrape_rpc(request: bytes, context) -> bytes:
        try:
            return scrape().encode()
        except Exception as e:
            await context.abort(grpc.StatusCode.INTERNAL, str(e))

    return [grpc.method_handlers_generic_handler(METRICS_SVC, {
        "Scrape": grpc.unary_unary_rpc_method_handler(
            scrape_rpc, request_deserializer=_IDENT,
            response_serializer=_IDENT)})]


async def scrape_metrics(channel: grpc.aio.Channel,
                         timeout: float = 2.0) -> str:
    """Client side: fetch a manager's metrics text over its raft listener.
    Raises RpcError when the endpoint is unreachable."""
    call = channel.unary_unary(f"/{METRICS_SVC}/Scrape",
                               request_serializer=_IDENT,
                               response_deserializer=_IDENT)
    try:
        raw = await asyncio.wait_for(call(b""), timeout=timeout)
    except (grpc.aio.AioRpcError, asyncio.TimeoutError) as e:
        raise RpcError(f"metrics scrape failed: {e!r}")
    return raw.decode()


# --------------------------------------------------------------------------
# server

class ClusterService:
    """Hosts the manager-side services for one swarmd process.

    ``node_ref()`` returns the local swarmkit_tpu_torch.node.Node (its running
    manager may come and go with promotions).

    Authorization (reference: the authenticatedwrapper codegen +
    ca/auth.go): when the node has a SecurityConfig, each RPC checks the
    mTLS peer certificate's role OU — dispatcher RPCs admit workers and
    managers, control admits managers, certificate issuance is open (the
    join token authorizes), renewal needs any valid certificate.
    """

    def __init__(self, node_ref: Callable[[], Any]) -> None:
        self.node_ref = node_ref

    # -- helpers ---------------------------------------------------------
    def _manager(self):
        node = self.node_ref()
        m = node._running_manager() if node is not None else None
        if m is None:
            raise RpcError("this node is not a manager")
        return m

    def _security(self):
        node = self.node_ref()
        return getattr(node, "security", None) if node is not None else None

    async def _authorize(self, context, *roles):
        """Role-gate an RPC on the peer certificate; no-op when the node
        runs without TLS identities (in-process tests)."""
        sec = self._security()
        if sec is None:
            return None
        from swarmkit_tpu_torch.ca.auth import PermissionDenied
        from swarmkit_tpu_torch.ca.tlsutil import authorize_peer

        try:
            return authorize_peer(context, sec, *roles)
        except PermissionDenied as e:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))

    async def _bind_identity(self, context, info, node_id: str) -> None:
        """The node_id in a dispatcher payload MUST be the authenticated
        certificate's CN — a worker cert cannot impersonate another node
        (reference: the dispatcher derives the node from the TLS identity,
        dispatcher.go nodeIDFromContext / ca.RemoteNode)."""
        if info is not None and node_id and info.node_id != node_id:
            await context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                f"certificate identity {info.node_id!r} may not act as "
                f"{node_id!r}")

    def _leader_manager(self):
        m = self._manager()
        if m.is_leader():
            return m
        raise RpcError(f"not-leader:{m.leader_addr}")

    async def _abort(self, context, e: Exception):
        msg = str(e)
        if msg.startswith("not-leader:"):
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, msg)
        await context.abort(grpc.StatusCode.UNAVAILABLE, msg)

    # -- Manager info ----------------------------------------------------
    async def info(self, request: bytes, context) -> bytes:
        node = self.node_ref()
        m = node._running_manager() if node is not None else None
        if m is None:
            return packb((False, "", False))
        return packb((m.is_leader(), m.leader_addr, True))

    # -- Dispatcher ------------------------------------------------------
    async def session(self, request: bytes, context):
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        vals = unpackb(request)
        # 5th tuple element (optional, newer clients): the caller's span
        # id, so the dispatcher.session span reparents across the wire
        node_id, desc_json, session_id, addr = vals[:4]
        parent_span = vals[4] if len(vals) > 4 else ""
        await self._bind_identity(context, info, node_id)
        description = (NodeDescription.decode(desc_json)
                       if desc_json else None)
        try:
            d = self._leader_manager().dispatcher
            async for msg in d.session(node_id, description,
                                       session_id=session_id, addr=addr,
                                       parent_span=parent_span):
                yield msg.encode()
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def assignments(self, request: bytes, context):
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, session_id = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            d = self._leader_manager().dispatcher
            async for msg in d.assignments(node_id, session_id):
                yield msg.encode()
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def heartbeat(self, request: bytes, context) -> bytes:
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, session_id = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            resp = await self._leader_manager().dispatcher.heartbeat(
                node_id, session_id)
            return packb(resp.period)
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def update_task_status(self, request: bytes, context) -> bytes:
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, session_id, updates = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            d = self._leader_manager().dispatcher
            await d.update_task_status(
                node_id, session_id,
                [(tid, TaskStatus.decode(st)) for tid, st in updates])
            return b""
        except RpcError as e:
            await self._abort(context, e)
        except PermissionError as e:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    # -- LogBroker (agent + client sides of `service logs`) --------------
    async def listen_subscriptions(self, request: bytes, context):
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            lb = self._leader_manager().logbroker
            async for m in lb.listen_subscriptions(node_id):
                yield packb(_pack_submsg(m))
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def publish_logs(self, request: bytes, context) -> bytes:
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, sub_id, msgs, close = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            lb = self._leader_manager().logbroker
            await lb.publish_logs(sub_id, [_unpack_logmsg(m) for m in msgs],
                                  node_id=node_id, close=close)
            return b""
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def subscribe_logs(self, request: bytes, context):
        await self._authorize(context, MANAGER_ROLE_OU)
        sel, follow, tail = unpackb(request)
        from swarmkit_tpu_torch.manager.logbroker import (
            LogSelector, SubscribeLogsOptions,
        )

        selector = LogSelector(service_ids=list(sel[0]),
                               node_ids=list(sel[1]),
                               task_ids=list(sel[2]))
        try:
            lb = self._leader_manager().logbroker
            async for m in lb.subscribe_logs(
                    selector, SubscribeLogsOptions(follow=follow,
                                                   tail=tail)):
                yield packb(_pack_logmsg(m))
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    # -- CA --------------------------------------------------------------
    def _ca(self):
        ca = self._leader_manager().ca_server
        if ca is None:
            raise RpcError("leader has no CA")
        return ca

    async def issue_certificate(self, request: bytes, context) -> bytes:
        csr, token, addr, requested_id = unpackb(request)
        try:
            node_id, issued = await self._ca().issue_node_certificate(
                csr, token, addr=addr, requested_node_id=requested_id)
            return packb((node_id, issued.cert_pem, issued.key_pem,
                                  self._ca().get_root_ca_certificate()))
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    async def renew_certificate(self, request: bytes, context) -> bytes:
        from swarmkit_tpu_torch.ca.certificates import (
            MANAGER_ROLE_OU, WORKER_ROLE_OU,
        )

        # any valid cluster identity may renew — but only its own cert
        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, old_cert, csr = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            issued = await self._ca().renew_node_certificate(
                node_id, old_cert, csr)
            return packb((issued.cert_pem, issued.key_pem,
                                  issued.root_bundle))
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    # -- Control (JSON dispatch, shared with the unix socket) ------------
    async def control(self, request: bytes, context) -> bytes:
        from swarmkit_tpu_torch.cmd.ctl import CtlError, dispatch_control
        from swarmkit_tpu_torch.manager.controlapi import ControlError

        # remote control API is manager-only (reference: controlapi RPCs
        # carry tls_authorization roles=swarm-manager); operators use the
        # local unix socket
        await self._authorize(context, MANAGER_ROLE_OU)
        req = json.loads(request)
        # optional span_id from control_call: dispatch under a span
        # parented to the remote caller so inner spans (raft.propose)
        # nest in one cross-process trace
        parent_span = req.get("span_id", "")
        try:
            c = self._leader_manager().control_api
            with obs_trace.DEFAULT.span("control.dispatch",
                                        parent_id=parent_span or None,
                                        method=req.get("method", "")):
                result = await dispatch_control(c, req.get("method", ""),
                                                req.get("params", {}))
            return json.dumps({"result": result}).encode()
        except RpcError as e:
            await self._abort(context, e)
        except (ControlError, CtlError) as e:
            # typed errors keep their code so remote == local behavior
            return json.dumps({"error": str(e), "code": e.code}).encode()
        except Exception as e:
            return json.dumps({"error": str(e),
                               "code": "internal"}).encode()

    # -- Watch (reference: manager/watchapi/server.go served over gRPC) --
    async def watch(self, request: bytes, context):
        # watch is manager-only, like the reference's watchapi
        # tls_authorization (operators and control loops, not workers)
        await self._authorize(context, MANAGER_ROLE_OU)
        from swarmkit_tpu_torch.manager.watchapi import WatchSelector

        selectors_raw, resume_from, include_old = unpackb(request)
        selectors = [WatchSelector(kind=k, id_prefix=p, name=n,
                                   actions=tuple(a))
                     for k, p, n, a in selectors_raw]
        try:
            # any manager serves watches from its replicated store (the
            # reference's watchapi is not leader-only either)
            ws = self._manager().watch_server
            async for msg in ws.watch(selectors=selectors,
                                      resume_from=resume_from,
                                      include_old_object=include_old):
                yield packb(_pack_watchmsg(msg))
        except RpcError as e:
            await self._abort(context, e)
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    # -- ResourceAllocator (reference: manager/resourceapi/allocator.go) -
    async def attach_network(self, request: bytes, context) -> bytes:
        from swarmkit_tpu_torch.manager.resourceapi import ResourceError

        info = await self._authorize(context, WORKER_ROLE_OU,
                                     MANAGER_ROLE_OU)
        node_id, network_id, container_id = unpackb(request)
        await self._bind_identity(context, info, node_id)
        try:
            attachment_id = await self._leader_manager() \
                .resource_api.attach_network(node_id, network_id,
                                             container_id)
            return packb(attachment_id)
        except RpcError as e:
            await self._abort(context, e)
        except ResourceError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def detach_network(self, request: bytes, context) -> bytes:
        from swarmkit_tpu_torch.manager.resourceapi import ResourceError

        await self._authorize(context, WORKER_ROLE_OU, MANAGER_ROLE_OU)
        (attachment_id,) = unpackb(request)
        try:
            await self._leader_manager().resource_api.detach_network(
                attachment_id)
            return b""
        except RpcError as e:
            await self._abort(context, e)
        except ResourceError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    # -- registration ----------------------------------------------------
    def handlers(self) -> list:
        u = grpc.unary_unary_rpc_method_handler
        s = grpc.unary_stream_rpc_method_handler
        return [
            grpc.method_handlers_generic_handler(_INFO, {
                "Info": u(self.info, request_deserializer=_IDENT,
                          response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_DISP, {
                "Session": s(self.session, request_deserializer=_IDENT,
                             response_serializer=_IDENT),
                "Assignments": s(self.assignments,
                                 request_deserializer=_IDENT,
                                 response_serializer=_IDENT),
                "Heartbeat": u(self.heartbeat, request_deserializer=_IDENT,
                               response_serializer=_IDENT),
                "UpdateTaskStatus": u(self.update_task_status,
                                      request_deserializer=_IDENT,
                                      response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_CA, {
                "IssueNodeCertificate": u(self.issue_certificate,
                                          request_deserializer=_IDENT,
                                          response_serializer=_IDENT),
                "RenewNodeCertificate": u(self.renew_certificate,
                                          request_deserializer=_IDENT,
                                          response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_LOGS, {
                "ListenSubscriptions": s(self.listen_subscriptions,
                                         request_deserializer=_IDENT,
                                         response_serializer=_IDENT),
                "PublishLogs": u(self.publish_logs,
                                 request_deserializer=_IDENT,
                                 response_serializer=_IDENT),
                "SubscribeLogs": s(self.subscribe_logs,
                                   request_deserializer=_IDENT,
                                   response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_CTL, {
                "Call": u(self.control, request_deserializer=_IDENT,
                          response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_WATCH, {
                "Watch": s(self.watch, request_deserializer=_IDENT,
                           response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_RES, {
                "AttachNetwork": u(self.attach_network,
                                   request_deserializer=_IDENT,
                                   response_serializer=_IDENT),
                "DetachNetwork": u(self.detach_network,
                                   request_deserializer=_IDENT,
                                   response_serializer=_IDENT)}),
        ]

    def join_handlers(self) -> list:
        """The subset served on the TLS join port to certificate-less
        joiners: token-gated issuance + leader info for redirects."""
        u = grpc.unary_unary_rpc_method_handler
        return [
            grpc.method_handlers_generic_handler(_CA, {
                "IssueNodeCertificate": u(self.issue_certificate,
                                          request_deserializer=_IDENT,
                                          response_serializer=_IDENT)}),
            grpc.method_handlers_generic_handler(_INFO, {
                "Info": u(self.info, request_deserializer=_IDENT,
                          response_serializer=_IDENT)}),
        ]


# --------------------------------------------------------------------------
# client

def pack_session_request(node_id, description=None, session_id="",
                         addr="") -> bytes:
    """Wire form of a dispatcher session request.  The 5th element is the
    caller's current span id (or ""), carried so the server-side
    dispatcher.session span reparents under the caller's trace instead of
    rooting a fresh tree across the process boundary; pre-span servers
    that unpack only 4 values still work."""
    return packb((node_id,
                          description.encode() if description else b"",
                          session_id, addr,
                          obs_trace.current_span_id() or ""))


def _redirectable(e: grpc.aio.AioRpcError) -> Exception:
    details = e.details() or ""
    if details.startswith("not-leader:"):
        return NotLeader(details.split(":", 1)[1])
    return RpcError(f"{e.code().name}: {details}")


class NotLeader(Exception):
    def __init__(self, leader_addr: str) -> None:
        super().__init__(f"not the leader (leader at {leader_addr})")
        self.leader_addr = leader_addr


class RemoteDispatcher:
    """Dispatcher duck type over gRPC (matches manager.dispatcher's
    surface used by agent/session.py)."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._session = channel.unary_stream(
            f"/{_DISP}/Session", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._assignments = channel.unary_stream(
            f"/{_DISP}/Assignments", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._heartbeat = channel.unary_unary(
            f"/{_DISP}/Heartbeat", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._uts = channel.unary_unary(
            f"/{_DISP}/UpdateTaskStatus", request_serializer=_IDENT,
            response_deserializer=_IDENT)

    async def session(self, node_id, description=None, session_id="",
                      addr=""):
        req = pack_session_request(node_id, description, session_id, addr)
        try:
            async for raw in self._session(req):
                yield SessionMessage.decode(raw)
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)

    async def assignments(self, node_id, session_id):
        req = packb((node_id, session_id))
        try:
            async for raw in self._assignments(req):
                yield AssignmentsMessage.decode(raw)
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)

    async def heartbeat(self, node_id, session_id) -> HeartbeatResponse:
        try:
            raw = await self._heartbeat(packb((node_id, session_id)))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)
        return HeartbeatResponse(period=unpackb(raw))

    async def update_task_status(self, node_id, session_id, updates) -> None:
        req = packb((node_id, session_id,
                             [(tid, st.encode()) for tid, st in updates]))
        try:
            await self._uts(req)
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.PERMISSION_DENIED:
                raise PermissionError(e.details())
            raise _redirectable(e)


class RemoteCA:
    """CAServer duck type over gRPC (surface used by node.py)."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._issue = channel.unary_unary(
            f"/{_CA}/IssueNodeCertificate", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._renew = channel.unary_unary(
            f"/{_CA}/RenewNodeCertificate", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._root_ca_pem: bytes = b""

    async def issue_node_certificate(self, csr_pem, token, addr="",
                                     requested_node_id=""):
        from swarmkit_tpu_torch.ca import IssuedCertificate

        try:
            raw = await self._issue(packb(
                (csr_pem, token, addr, requested_node_id)))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)
        node_id, cert_pem, key_pem, root_pem = unpackb(raw)
        self._root_ca_pem = root_pem
        # the bundle arrived over the pin-verified TLS channel, so it is
        # authenticated trust (unlike the plaintext bootstrap fetch)
        return node_id, IssuedCertificate(cert_pem=cert_pem,
                                          key_pem=key_pem,
                                          root_bundle=root_pem or b"")

    async def renew_node_certificate(self, node_id, old_cert_pem, csr_pem):
        from swarmkit_tpu_torch.ca import IssuedCertificate

        try:
            raw = await self._renew(packb(
                (node_id, old_cert_pem, csr_pem)))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)
        parts = unpackb(raw)
        cert_pem, key_pem = parts[0], parts[1]
        root_bundle = parts[2] if len(parts) > 2 else b""
        return IssuedCertificate(cert_pem=cert_pem, key_pem=key_pem,
                                 root_bundle=root_bundle or b"")

    def get_root_ca_certificate(self) -> bytes:
        return self._root_ca_pem


async def fetch_root_ca(addr: str, timeout: float = 5.0) -> bytes:
    """Fetch the cluster root CA certificate from a manager's plaintext
    BOOTSTRAP port (addr's port + 1). The returned PEM is UNTRUSTED until
    the caller verifies its digest against the join-token pin (reference:
    GetRemoteCA digest pinning, ca/certificates.go)."""
    host, port = addr.rsplit(":", 1)
    boot_addr = f"{host}:{int(port) + 1}"
    channel = grpc.aio.insecure_channel(boot_addr)
    try:
        call = channel.unary_unary(
            "/swarmkit.Bootstrap/GetRootCACertificate",
            request_serializer=_IDENT, response_deserializer=_IDENT)
        return await asyncio.wait_for(call(b""), timeout=timeout)
    finally:
        await channel.close()


def _pack_submsg(m) -> tuple:
    return (m.id, (list(m.selector.service_ids), list(m.selector.node_ids),
                   list(m.selector.task_ids)), m.close, m.options)


def _unpack_submsg(t):
    from swarmkit_tpu_torch.manager.logbroker import (
        LogSelector, SubscriptionMessage,
    )

    sid, sel, close, options = t
    return SubscriptionMessage(
        id=sid, selector=LogSelector(service_ids=list(sel[0]),
                                     node_ids=list(sel[1]),
                                     task_ids=list(sel[2])),
        close=close, options=dict(options))


def _pack_logmsg(m) -> tuple:
    return (m.context.service_id, m.context.node_id, m.context.task_id,
            m.timestamp, int(m.stream), m.data)


def _unpack_logmsg(t):
    from swarmkit_tpu_torch.manager.logbroker import (
        LogContext, LogMessage, LogStream,
    )

    svc, node, task, ts, stream, data = t
    return LogMessage(context=LogContext(service_id=svc, node_id=node,
                                         task_id=task),
                      timestamp=ts, stream=LogStream(stream), data=data)


def _pack_watchmsg(m) -> tuple:
    from swarmkit_tpu_torch.api.objects import kind_of

    def enc(obj):
        return (kind_of(obj), obj.encode()) if obj is not None else ("", b"")

    return (m.action, m.kind, enc(m.object), enc(m.old_object), m.version)


def _unpack_watchmsg(t):
    from swarmkit_tpu_torch.api.objects import OBJECT_KINDS
    from swarmkit_tpu_torch.manager.watchapi import WatchMessage

    def dec(pair):
        kind, raw = pair
        return OBJECT_KINDS[kind].decode(raw) if kind else None

    action, kind, obj, old, version = t
    return WatchMessage(action=action, kind=kind, object=dec(obj),
                        old_object=dec(old), version=version)


class RemoteWatch:
    """WatchServer duck type over gRPC (reference: watchapi client)."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._watch = channel.unary_stream(
            f"/{_WATCH}/Watch", request_serializer=_IDENT,
            response_deserializer=_IDENT)

    async def watch(self, selectors=None, resume_from=None,
                    include_old_object: bool = False):
        req = packb((
            [(s.kind, s.id_prefix, s.name, list(s.actions))
             for s in (selectors or [])],
            resume_from, include_old_object))
        try:
            async for raw in self._watch(req):
                yield _unpack_watchmsg(unpackb(raw))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)


class RemoteResourceAllocator:
    """ResourceApi duck type over gRPC (reference: resourceapi client used
    by the engine for network attachments)."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._attach = channel.unary_unary(
            f"/{_RES}/AttachNetwork", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._detach = channel.unary_unary(
            f"/{_RES}/DetachNetwork", request_serializer=_IDENT,
            response_deserializer=_IDENT)

    async def attach_network(self, node_id: str, network_id: str,
                             container_id: str = "") -> str:
        from swarmkit_tpu_torch.manager.resourceapi import ResourceError

        try:
            raw = await self._attach(packb(
                (node_id, network_id, container_id)))
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                raise ResourceError(e.details())
            raise _redirectable(e)
        return unpackb(raw)

    async def detach_network(self, attachment_id: str) -> None:
        from swarmkit_tpu_torch.manager.resourceapi import ResourceError

        try:
            await self._detach(packb((attachment_id,)))
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                raise ResourceError(e.details())
            raise _redirectable(e)


class RemoteLogBroker:
    """LogBroker duck type over gRPC (surface used by agent/logs.py and
    the control socket's subscribe-logs)."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        self._listen = channel.unary_stream(
            f"/{_LOGS}/ListenSubscriptions", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._publish = channel.unary_unary(
            f"/{_LOGS}/PublishLogs", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._subscribe = channel.unary_stream(
            f"/{_LOGS}/SubscribeLogs", request_serializer=_IDENT,
            response_deserializer=_IDENT)

    async def listen_subscriptions(self, node_id: str):
        try:
            async for raw in self._listen(packb(node_id)):
                yield _unpack_submsg(unpackb(raw))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)

    async def publish_logs(self, sub_id: str, messages,
                           node_id: str = "", close: bool = False) -> None:
        req = packb((node_id, sub_id,
                             [_pack_logmsg(m) for m in messages], close))
        try:
            await self._publish(req)
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)

    async def subscribe_logs(self, selector, options=None):
        from swarmkit_tpu_torch.manager.logbroker import SubscribeLogsOptions

        options = options or SubscribeLogsOptions()
        req = packb(((list(selector.service_ids),
                              list(selector.node_ids),
                              list(selector.task_ids)),
                             options.follow, options.tail))
        try:
            async for raw in self._subscribe(req):
                yield _unpack_logmsg(unpackb(raw))
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)


class RemoteManager:
    """Manager duck type over gRPC for the connection broker: cached
    is_leader/leader_addr (refreshed on use) + remote services.

    Channel security (reference: manager.go client-side mTLS everywhere):
    - with a SecurityConfig (``security_ref``): mutual TLS;
    - certificate-less but holding a join token (``expected_ca_digest``):
      fetch the root CA from the bootstrap port, verify the token's digest
      pin, then server-authenticated TLS — the join dance;
    - neither: plaintext (in-process tests only).
    The channel is rebuilt when the node's security state changes (a joiner
    upgrades pinned -> mTLS once its certificate is issued).
    """

    def __init__(self, addr: str, refresh_interval: float = 1.0,
                 security_ref: Optional[Callable[[], Any]] = None,
                 expected_ca_digest: str = "") -> None:
        self.addr = addr
        self._security_ref = security_ref or (lambda: None)
        self._expected_digest = expected_ca_digest
        self._pinned_root: Optional[bytes] = None
        self._mode: Optional[str] = None
        self._channel: Optional[grpc.aio.Channel] = None
        self._info = None
        self._ctl = None
        self.dispatcher: Optional[RemoteDispatcher] = None
        self.ca_server: Optional[RemoteCA] = None
        self.logbroker: Optional[RemoteLogBroker] = None
        self.watch_server: Optional[RemoteWatch] = None
        self.resource_api: Optional[RemoteResourceAllocator] = None
        self._is_leader = False
        self._leader_addr = ""
        self._has_manager = False
        self._refresh_interval = refresh_interval
        self._last_refresh = 0.0
        self._refresher: Optional[asyncio.Task] = None
        self._running = True
        self._connect_lock: Optional[asyncio.Lock] = None
        self._last_connect_error: str = ""

    async def _connect(self) -> None:
        # refresh loop and in-flight RPCs can race channel rebuilds
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            await self._connect_locked()

    async def _connect_locked(self) -> None:
        sec = self._security_ref()
        want = ("mtls" if sec is not None
                else "pinned" if self._expected_digest
                else "insecure")
        if self._channel is not None and want == self._mode:
            return
        if self._channel is not None:
            await self._channel.close()
        if want == "insecure":
            channel = grpc.aio.insecure_channel(self.addr)
        else:
            from swarmkit_tpu_torch.ca.tlsutil import (
                channel_credentials, secure_channel_options,
            )

            if want == "pinned":
                if self._pinned_root is None:
                    import hmac

                    from swarmkit_tpu_torch.ca.certificates import split_bundle

                    root_pem = await fetch_root_ca(self.addr)
                    # compare against the raw digest (the caller passes the
                    # SWMTKN's pin component, not the whole token).  The
                    # served trust may be an old+new BUNDLE mid-rotation —
                    # trust ONLY the member matching the pin, never the
                    # whole unauthenticated bundle.
                    pin = next(
                        (c for c, d in split_bundle(root_pem)
                         if hmac.compare_digest(d, self._expected_digest)),
                        None)
                    if pin is None:
                        raise RpcError(
                            "remote CA digest does not match the join "
                            "token pin — refusing to join (possible MITM)")
                    self._pinned_root = pin
                creds = channel_credentials(
                    pinned_root_pem=self._pinned_root)
                # certificate-less joiners talk to the TLS join port
                host, port = self.addr.rsplit(":", 1)
                target = f"{host}:{int(port) + 2}"
            else:
                creds = channel_credentials(sec)
                target = self.addr
            channel = grpc.aio.secure_channel(
                target, creds, options=secure_channel_options())
        self._channel = channel
        self._mode = want
        self._info = channel.unary_unary(
            f"/{_INFO}/Info", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self._ctl = channel.unary_unary(
            f"/{_CTL}/Call", request_serializer=_IDENT,
            response_deserializer=_IDENT)
        self.dispatcher = RemoteDispatcher(channel)
        self.ca_server = RemoteCA(channel)
        self.logbroker = RemoteLogBroker(channel)
        self.watch_server = RemoteWatch(channel)
        self.resource_api = RemoteResourceAllocator(channel)

    def start(self) -> None:
        self._refresher = asyncio.get_running_loop().create_task(
            self._refresh_loop())

    async def close(self) -> None:
        self._running = False
        if self._refresher is not None:
            self._refresher.cancel()
            try:
                await self._refresher
            except (asyncio.CancelledError, Exception):
                pass
        if self._channel is not None:
            await self._channel.close()

    async def refresh(self) -> None:
        try:
            await self._connect()
            raw = await asyncio.wait_for(self._info(b""), timeout=2.0)
            self._is_leader, self._leader_addr, self._has_manager = \
                unpackb(raw)
            self._last_connect_error = ""
        except Exception as e:
            # A digest-pin refusal is a security event, not connection
            # noise — surface it (once per distinct message, the refresh
            # loop runs every second).
            msg = f"{type(e).__name__}: {e}"
            if msg != self._last_connect_error:
                self._last_connect_error = msg
                level = (log.error if "digest" in str(e).lower()
                         else log.debug)
                level("manager %s unavailable: %s", self.addr, msg)
            self._is_leader, self._has_manager = False, False

    async def _refresh_loop(self) -> None:
        while self._running:
            await self.refresh()
            await asyncio.sleep(self._refresh_interval)

    # Manager duck type (sync; served from the refreshed cache)
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def leader_addr(self) -> str:
        return self._leader_addr

    @property
    def _running_(self) -> bool:   # parity only
        return self._has_manager

    async def control_call(self, method: str, params: dict):
        """Raw control dispatch (same JSON protocol as the unix socket)."""
        await self._connect()
        try:
            raw = await self._ctl(json.dumps(
                {"method": method, "params": params,
                 "span_id": obs_trace.current_span_id() or ""}).encode())
        except grpc.aio.AioRpcError as e:
            raise _redirectable(e)
        resp = json.loads(raw)
        if "error" in resp:
            from swarmkit_tpu_torch.cmd.ctl import CtlError

            raise CtlError(resp["error"], resp.get("code", "unknown"))
        return resp["result"]
