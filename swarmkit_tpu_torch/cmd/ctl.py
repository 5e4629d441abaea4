"""Control-API-over-unix-socket: the swarmd ↔ swarmctl wire.

Reference: swarmd's ``--listen-control-api`` unix socket serving the
Control gRPC service (cmd/swarmd/main.go:255-273, manager.go:526) and
swarmctl dialing it (cmd/swarmctl).  Here the wire is newline-delimited
JSON ``{"method": ..., "params": {...}}`` → ``{"result": ...}`` /
``{"error": ..., "code": ...}`` — the gRPC semantics (method-per-RPC,
typed errors) without protobuf.

The port's own copy of the JAX package's cmd/ctl.py.  It differs in one
place: both ends read a line of up to ``MAX_LINE`` bytes.  asyncio's
default of 64 KiB fails any answer longer than that with "chunk is
longer than limit" (``task-ls`` of a 100-replica service is ~90 KiB), and
the reference's gRPC control API takes messages of 4 MiB and more.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from swarmkit_tpu_torch.api import (
    ConfigSpec, NetworkSpec, NodeAvailability, NodeRole, SecretSpec,
    ServiceSpec,
)
from swarmkit_tpu_torch.manager.controlapi import ControlError

log = logging.getLogger("swarmkit_tpu_torch.ctl")

# the longest request or answer line either end reads
MAX_LINE = 64 * 1024 * 1024


class CtlError(Exception):
    def __init__(self, message: str, code: str = "unknown") -> None:
        super().__init__(message)
        self.code = code


class ControlSocketServer:
    """Serves a Node's control API on a unix socket."""

    def __init__(self, node, path: str) -> None:
        self.node = node
        self.path = path
        self._server: Optional[asyncio.AbstractServer] = None

    def _control(self):
        from swarmkit_tpu_torch.node.connectionbroker import NoManagerError

        if self.node._running_manager() is None:
            raise CtlError("this node is not a manager", "unavailable")
        try:
            # follower sockets forward to the leader (the raftproxy analog);
            # a remote leader is driven via its Control.Call gRPC
            leader = self.node.broker.select_leader()
        except NoManagerError:
            raise CtlError("no leader available", "unavailable")
        return leader

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(
            self._handle, path=self.path, limit=MAX_LINE)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    method = req.get("method", "")
                    if method == "logs.subscribe":
                        await self._stream_logs(req.get("params", {}),
                                                writer)
                        continue
                    result = await self._dispatch(method,
                                                  req.get("params", {}))
                    resp = {"result": result}
                except ControlError as e:
                    resp = {"error": str(e), "code": e.code}
                except CtlError as e:
                    resp = {"error": str(e), "code": e.code}
                except Exception as e:
                    log.exception("ctl request failed")
                    resp = {"error": str(e), "code": "internal"}
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            writer.close()

    # ------------------------------------------------------------------
    async def _stream_logs(self, p: dict, writer) -> None:
        """`service logs` over the socket: one {"stream": msg} line per
        LogMessage, then {"result": "eof"} (reference: the Logs gRPC
        server stream, api/logbroker.proto SubscribeLogs)."""
        from swarmkit_tpu_torch.manager.logbroker import (
            LogSelector, SubscribeLogsOptions,
        )

        leader = self._control()
        lb = getattr(leader, "logbroker", None)
        if lb is None:
            raise CtlError("leader has no log broker", "unavailable")
        selector = LogSelector(service_ids=p.get("service_ids") or [],
                               node_ids=p.get("node_ids") or [],
                               task_ids=p.get("task_ids") or [])
        options = SubscribeLogsOptions(follow=bool(p.get("follow", False)),
                                       tail=int(p.get("tail", -1)))
        try:
            async for m in lb.subscribe_logs(selector, options):
                writer.write(json.dumps({"stream": {
                    "service_id": m.context.service_id,
                    "node_id": m.context.node_id,
                    "task_id": m.context.task_id,
                    "timestamp": m.timestamp,
                    "stream": int(m.stream),
                    "data": m.data.decode("utf-8", "replace"),
                }}).encode() + b"\n")
                await writer.drain()
        except Exception as e:
            # terminate with the ERROR, never a clean eof: the client must
            # see truncation as a failure, and exactly ONE response line
            # may end the stream (a second would corrupt the next request)
            writer.write(json.dumps(
                {"error": str(e), "code": "unavailable"}).encode() + b"\n")
            await writer.drain()
            return
        writer.write(json.dumps({"result": "eof"}).encode() + b"\n")
        await writer.drain()

    async def _dispatch(self, method: str, p: dict):
        leader = self._control()
        if hasattr(leader, "control_call"):
            # remote leader (gRPC): forward the raw JSON request
            return await leader.control_call(method, p)
        return await dispatch_control(leader.control_api, method, p)


async def dispatch_control(c, method: str, p: dict):
    """Shared control-API JSON dispatch (unix socket + gRPC Control.Call)."""
    if method == "cluster.inspect":
        return c.get_cluster().to_dict()
    if method == "cluster.metrics":
        # hot-path latency percentiles + object gauges (reference: the
        # prometheus endpoint; names match raft.go:69-71 / memory.go:81-110)
        from swarmkit_tpu_torch.utils import metrics as _metrics

        reg = getattr(c, "metrics_registry", None) or _metrics.REGISTRY
        out = {"timers": reg.snapshot()}
        collector = getattr(c, "metrics", None)
        if collector is not None:
            out["gauges"] = collector.snapshot()
        return out
    if method == "cluster.update":
        # mutate the live spec (reference: cmd/swarmctl/cluster/update.go
        # reads-modifies-writes ClusterSpec; components re-read on
        # EventUpdateCluster — reaper retention, dispatcher heartbeat
        # period, CA cert expiry)
        cl = c.get_cluster()
        spec = cl.spec.copy()
        if "task_history" in p:
            spec.orchestration.task_history_retention_limit = \
                int(p["task_history"])
        if "heartbeat_period" in p:
            spec.dispatcher.heartbeat_period = float(p["heartbeat_period"])
        if "cert_expiry" in p:
            spec.ca_config.node_cert_expiry = float(p["cert_expiry"])
        cl2 = await c.update_cluster(
            cl.id, spec, version=cl.meta.version.index,
            rotate_worker_token=bool(p.get("rotate_worker_token")),
            rotate_manager_token=bool(p.get("rotate_manager_token")))
        return cl2.to_dict()
    if method == "cluster.rotate-ca":
        return await c.rotate_root_ca()
    if method == "cluster.autolock":
        cl = c.get_cluster()
        spec = cl.spec.copy()
        spec.encryption_config.auto_lock_managers = bool(p["enabled"])
        await c.update_cluster(cl.id, spec,
                               version=cl.meta.version.index)
        return c.get_unlock_key()
    if method == "cluster.get-unlock-key":
        return c.get_unlock_key()
    if method == "cluster.rotate-unlock-key":
        return await c.rotate_unlock_key()
    if method == "cluster.unlock-key":
        # historical name: returns the JOIN TOKENS (swarmctl
        # cluster-tokens); the autolock key lives at cluster.get-unlock-key
        cl = c.get_cluster()
        return {"worker": cl.root_ca.join_token_worker,
                "manager": cl.root_ca.join_token_manager}
    if method == "node.ls":
        return [n.to_dict() for n in c.list_nodes()]
    if method == "node.inspect":
        return c.get_node(p["id"]).to_dict()
    if method == "node.rm":
        await c.remove_node(p["id"], force=p.get("force", False))
        return {}
    if method in ("node.promote", "node.demote", "node.update"):
        node = c.get_node(p["id"])
        spec = node.spec.copy()
        if method == "node.promote":
            spec.desired_role = NodeRole.MANAGER
        elif method == "node.demote":
            spec.desired_role = NodeRole.WORKER
        if "availability" in p:
            spec.availability = NodeAvailability(p["availability"])
        if "labels_add" in p or "labels_rm" in p:
            # node labels live on the SPEC annotations (the operator's
            # half; reference cmd/swarmctl/node/update.go) — the
            # constraint language reads them from there.  `spec` is
            # already a deep copy (Message.copy), so mutate in place.
            spec.annotations.labels.update(p.get("labels_add") or {})
            for k in p.get("labels_rm") or []:
                spec.annotations.labels.pop(k, None)
        node2 = await c.update_node(p["id"], spec,
                                    version=node.meta.version.index)
        return node2.to_dict()
    if method == "service.create":
        spec = ServiceSpec.from_dict(p["spec"])
        return (await c.create_service(spec)).to_dict()
    if method == "service.ls":
        return [s.to_dict() for s in c.list_services()]
    if method == "service.inspect":
        return c.get_service(p["id"]).to_dict()
    if method == "service.update":
        spec = ServiceSpec.from_dict(p["spec"])
        return (await c.update_service(
            p["id"], spec, version=p.get("version"))).to_dict()
    if method == "service.rollback":
        return (await c.rollback_service(
            p["id"], version=p.get("version"))).to_dict()
    if method == "service.rm":
        await c.remove_service(p["id"])
        return {}
    if method == "task.ls":
        return [t.to_dict() for t in c.list_tasks(
            service_ids=p.get("service_ids"),
            node_ids=p.get("node_ids"))]
    if method == "task.inspect":
        return c.get_task(p["id"]).to_dict()
    if method == "network.create":
        spec = NetworkSpec.from_dict(p["spec"])
        return (await c.create_network(spec)).to_dict()
    if method == "network.ls":
        return [n.to_dict() for n in c.list_networks()]
    if method == "network.inspect":
        return c.get_network(p["id"]).to_dict()
    if method == "network.rm":
        await c.remove_network(p["id"])
        return {}
    if method == "secret.create":
        spec = SecretSpec.from_dict(p["spec"])
        return (await c.create_secret(spec)).to_dict()
    if method == "secret.ls":
        return [s.to_dict() for s in c.list_secrets()]
    if method == "secret.inspect":
        return c.get_secret(p["id"]).to_dict()
    if method == "secret.rm":
        await c.remove_secret(p["id"])
        return {}
    if method == "config.create":
        spec = ConfigSpec.from_dict(p["spec"])
        return (await c.create_config(spec)).to_dict()
    if method == "config.inspect":
        return c.get_config(p["id"]).to_dict()
    if method == "config.ls":
        return [s.to_dict() for s in c.list_configs()]
    if method == "config.rm":
        await c.remove_config(p["id"])
        return {}
    raise CtlError(f"unknown method {method!r}", "unimplemented")


class ControlSocketClient:
    """swarmctl's side of the socket."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_unix_connection(
            self.path, limit=MAX_LINE)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._reader = None

    async def stream(self, method: str, **params):
        """Server-streaming call: yields {"stream": ...} payloads until
        the terminating {"result": "eof"} line."""
        if self._writer is None:
            await self.connect()
        self._writer.write(json.dumps(
            {"method": method, "params": params}).encode() + b"\n")
        await self._writer.drain()
        while True:
            line = await self._reader.readline()
            if not line:
                raise CtlError("connection closed", "unavailable")
            resp = json.loads(line)
            if "error" in resp:
                raise CtlError(resp["error"], resp.get("code", "unknown"))
            if "stream" in resp:
                yield resp["stream"]
                continue
            return

    async def call(self, method: str, **params):
        if self._writer is None:
            await self.connect()
        self._writer.write(json.dumps(
            {"method": method, "params": params}).encode() + b"\n")
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise CtlError("connection closed", "unavailable")
        resp = json.loads(line)
        if "error" in resp:
            raise CtlError(resp["error"], resp.get("code", "unknown"))
        return resp["result"]
