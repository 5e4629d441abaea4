"""Live-daemon debug surface: the `swarmd --listen-debug` analog.

Reference: cmd/swarmd/main.go:4-8,183 serves Go pprof + expvar over HTTP
when --listen-debug is set, so an operator can inspect a WEDGED running
daemon.  The asyncio build's equivalents:

  /debug/tasks    asyncio task dump (name, coro, current stack frame) —
                  the goroutine-stack-dump analog (signal.DumpStacks)
  /debug/store    write-lock state, in-flight proposal ages, WEDGED flag
                  (store.wedged(), reference memory.go:972), object
                  counts, current version
  /debug/queues   watch-queue fan-out: watcher count + per-watcher buffer
                  depth/overflow (watch/queue.go LimitQueue state)
  /debug/metrics  the metrics registry snapshot (expvar analog)
  /debug/vars     everything above in one JSON document
  /debug/kernels  this process's CUDA kernel launches by wrapper
                  (parallel/cuda_ops.py LAUNCHES) and the card it runs on

The port's own copy of the JAX package's node/debug.py, plus
/debug/kernels: the port's kernels launch inside the daemons (the
manager's scheduler, the tpu executor), and their counts live in the
daemon's process.

Served over a unix control socket or TCP with a minimal HTTP/1.0
responder — no framework, read-only, JSON bodies.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time
from typing import Optional

log = logging.getLogger("swarmkit_tpu_torch.debug")


def _task_dump() -> list[dict]:
    out = []
    for t in asyncio.all_tasks():
        coro = t.get_coro()
        frame = getattr(coro, "cr_frame", None)
        where = None
        if frame is not None:
            where = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        out.append({
            "name": t.get_name(),
            "coro": getattr(coro, "__qualname__", str(coro)),
            "state": ("cancelled" if t.cancelled() else
                      "done" if t.done() else "pending"),
            "at": where,
        })
    return sorted(out, key=lambda d: d["name"])


def _store_dump(store) -> dict:
    now = store._now()
    # oldest first: the stuck proposal IS the diagnostic
    in_flight = sorted((round(now - t0, 3)
                        for t0 in store._in_flight.values()), reverse=True)
    counts = {}
    for kind, table in store._tables.items():
        counts[kind] = len(table.objects)
    return {
        "wedged": store.wedged(),
        "wedge_timeout_s": store.WEDGE_TIMEOUT,
        "write_lock_held": store._write_lock.locked(),
        "in_flight_proposals": len(in_flight),
        "in_flight_ages_s": in_flight[:32],
        "version": store._local_version,
        "objects": counts,
    }


def _kernel_dump() -> dict:
    """The launches of each kernel wrapper in this process; the card's
    name only where the process already opened CUDA."""
    from swarmkit_tpu_torch.parallel import cuda_ops

    torch = cuda_ops.torch
    return {"launches": dict(cuda_ops.LAUNCHES),
            "device": (torch.cuda.get_device_name()
                       if torch.cuda.is_initialized() else None)}


def _queue_dump(store) -> dict:
    q = store.queue
    watchers = []
    for w in list(q._watchers):
        watchers.append({
            "depth": len(w),
            "limit": w._limit,
            "overflowed": w.overflowed,
            "closed": w.closed,
        })
    return {
        "watchers": len(watchers),
        "max_depth": max((w["depth"] for w in watchers), default=0),
        "detail": sorted(watchers, key=lambda d: -d["depth"])[:64],
    }


class DebugServer:
    """Read-only diagnostic HTTP server bound to a unix socket or TCP
    port.  Takes the Node (manager may come and go with role changes);
    every request re-resolves the live store."""

    def __init__(self, node) -> None:
        self.node = node
        self._server: Optional[asyncio.AbstractServer] = None

    def _store(self):
        m = self.node._running_manager()
        return None if m is None else m.store

    def _registry(self):
        m = self.node._running_manager()
        return None if m is None else m.metrics_registry

    # ------------------------------------------------------------------
    def snapshot(self, path: str) -> tuple[int, dict]:
        store = self._store()
        if path in ("/", "/debug", "/debug/vars"):
            body = {
                "node_id": self.node.node_id,
                "is_manager": store is not None,
                "is_leader": self.node.is_leader(),
                "time": time.time(),
                "python": sys.version.split()[0],
                "tasks": _task_dump(),
            }
            if store is not None:
                body["store"] = _store_dump(store)
                body["queues"] = _queue_dump(store)
            reg = self._registry()
            if reg is not None:
                body["metrics"] = reg.snapshot()
            return 200, body
        if path == "/debug/tasks":
            return 200, {"tasks": _task_dump()}
        if path == "/debug/kernels":
            return 200, _kernel_dump()
        if store is None:
            return 503, {"error": "no running manager on this node"}
        if path == "/debug/store":
            return 200, _store_dump(store)
        if path == "/debug/queues":
            return 200, _queue_dump(store)
        if path == "/debug/metrics":
            reg = self._registry()
            return 200, reg.snapshot() if reg is not None else {}
        return 404, {"error": f"unknown path {path}",
                     "paths": ["/debug/vars", "/debug/tasks",
                               "/debug/store", "/debug/queues",
                               "/debug/metrics", "/debug/kernels"]}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = line.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers (HTTP/1.0, ignore body); bounded so a
            # slow-drip client cannot pin the handler forever
            for _ in range(100):
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
            status, body = self.snapshot(path.split("?")[0])
            payload = json.dumps(body, default=str).encode()
            reason = {200: "OK", 404: "Not Found",
                      503: "Service Unavailable"}.get(status, "OK")
            writer.write(
                f"HTTP/1.0 {status} {reason}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n\r\n".encode())
            writer.write(payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        except Exception:
            log.exception("debug request failed")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def start(self, listen: str) -> None:
        """listen: 'host:port' (IPv6 hosts bracketed, '[::1]:8080') for
        TCP, anything else = unix socket path."""
        if ":" in listen and not listen.startswith(("/", ".")):
            host, port = listen.rsplit(":", 1)
            host = host.strip("[]")
            self._server = await asyncio.start_server(
                self._handle, host or "127.0.0.1", int(port))
        else:
            self._server = await asyncio.start_unix_server(
                self._handle, path=listen)
        log.info("debug server listening on %s", listen)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
