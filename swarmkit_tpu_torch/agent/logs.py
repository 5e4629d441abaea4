"""Agent-side task log capture + subscription publishing (the PyTorch
port's own copy of the JAX package's agent/logs.py, unchanged in
behaviour).

Reference: the agent half of `service logs` — agent/session.go:249-273
(the ListenSubscriptions stream), agent/agent.go:207 (subscription
handling) and the log-driver read-back the Docker controller uses to
serve tails.  Here the runtime is the TPU executor, so workloads write
their stdout/stderr-equivalent lines into an in-memory per-task ring
(`TaskLogBuffer`), and a `SubscriptionPublisher` per active subscription
ships the buffered tail plus (in follow mode) live lines back through
PublishLogs.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from typing import Iterable, Optional

from swarmkit_tpu_torch.manager.logbroker import LogContext, LogMessage, LogStream
from swarmkit_tpu_torch.watch.queue import Queue

log = logging.getLogger("swarmkit_tpu_torch.agent.logs")


async def _cancel_and_wait(task: asyncio.Task, timeout: float = 3.0) -> None:
    """Cancel `task` and wait BOUNDED for it to unwind.

    Two shutdown hazards this guards against (both found by the
    integration suite):
    - absorbing the CURRENT task's own cancellation while awaiting the
      child (it would stay 'cancelling' forever) — re-raised below;
    - a child stuck in a gRPC stream read whose cancel handshake never
      completes: after `timeout` the child is abandoned — it dies when
      the channel closes (Go's context-cancel semantics likewise never
      block shutdown on stream drain)."""
    task.cancel()
    try:
        done, pending = await asyncio.wait({task}, timeout=timeout)
        if pending:
            log.info("abandoning task %r after %.1fs cancel wait",
                     task.get_coro(), timeout)
    except asyncio.CancelledError:
        raise
    cur = asyncio.current_task()
    cancelling = getattr(cur, "cancelling", None)   # 3.11+; 3.10: best effort
    if cancelling is not None and cancelling():
        raise asyncio.CancelledError()


class TaskLogBuffer:
    """Per-task ring of LogMessage + a live fan-out bus.

    The executor writes lines via `publish`; subscription publishers read
    tails and watch for live lines.  Bounded per task (the reference
    relies on the container log driver's retention; here the ring cap
    plays that role).
    """

    def __init__(self, maxlen: int = 1000) -> None:
        self.maxlen = maxlen
        self._rings: dict[str, deque] = {}
        self._bus: Queue = Queue()   # every new LogMessage, all tasks
        self._seq = 0                # monotonic ring position, all tasks

    def publish(self, task_id: str, stream: LogStream, data: bytes,
                service_id: str = "", node_id: str = "",
                timestamp: float = 0.0) -> None:
        self._seq += 1
        msg = LogMessage(
            context=LogContext(service_id=service_id, node_id=node_id,
                               task_id=task_id),
            timestamp=timestamp, stream=stream, data=data, seq=self._seq)
        ring = self._rings.setdefault(task_id, deque(maxlen=self.maxlen))
        ring.append(msg)
        self._bus.publish(msg)

    def tail(self, task_id: str, n: int = -1) -> list[LogMessage]:
        ring = self._rings.get(task_id)
        if not ring:
            return []
        msgs = list(ring)
        return msgs if n < 0 else msgs[len(msgs) - min(n, len(msgs)):]

    def watch(self):
        return self._bus.watch()

    def drop(self, task_id: str) -> None:
        self._rings.pop(task_id, None)


def selector_matches(selector, task, node_id: str) -> bool:
    """Does this local task feed the subscription?  (reference:
    subscription.go match — any of the selector dimensions hits.)"""
    if task.id in (selector.task_ids or []):
        return True
    if getattr(task, "service_id", "") in (selector.service_ids or []):
        return True
    if node_id in (selector.node_ids or []):
        return True
    return False


class SubscriptionPublisher:
    """Publishes one subscription's matching local task logs.

    Backlog first (respecting options.tail), then — in follow mode —
    live lines from the buffer bus; in non-follow mode a close marker
    tells the broker this node is done (broker.go publisher tracking).
    """

    def __init__(self, sub_msg, worker, logs: TaskLogBuffer, client,
                 node_id: str) -> None:
        self.sub = sub_msg
        self.worker = worker
        self.logs = logs
        self.client = client
        self.node_id = node_id
        self.follow = bool(sub_msg.options.get("follow", True))
        self.tail_n = int(sub_msg.options.get("tail", -1))
        self._published: set[str] = set()   # task ids whose tail was sent
        self._tail_seq: dict[str, int] = {}  # last ring seq in that tail
        self._task: Optional[asyncio.Task] = None
        # created HERE, not in _run: a re-announce can arrive before the
        # publisher task ever gets scheduled
        self._rescan_event = asyncio.Event()

    def matching_tasks(self) -> list:
        out = []
        for tm in self.worker.task_managers.values():
            t = getattr(tm, "task", None)
            if t is not None and selector_matches(self.sub.selector, t,
                                                  self.node_id):
                out.append(t)
        return out

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            await _cancel_and_wait(self._task)
            self._task = None

    def rescan(self) -> None:
        """Re-announced subscription (tasks moved onto this node): ship
        tails for newly matching tasks without restarting the stream."""
        if self._task is not None and not self._task.done():
            self._rescan_event.set()

    async def _publish(self, msgs: Iterable[LogMessage],
                       close: bool = False) -> None:
        msgs = list(msgs)
        if msgs or close:
            await self.client.publish_logs(self.sub.id, msgs,
                                           node_id=self.node_id,
                                           close=close)

    async def _send_tails(self) -> None:
        for t in self.matching_tasks():
            if t.id in self._published:
                continue
            self._published.add(t.id)
            msgs = self.logs.tail(t.id, self.tail_n)
            if msgs:
                # live lines at or before this position are already in
                # the snapshot; the follow loop skips them (the watcher
                # opened BEFORE tail(), so overlap means duplicates, not
                # gaps)
                self._tail_seq[t.id] = msgs[-1].seq
            await self._publish(msgs)

    async def _run(self) -> None:
        try:
            if not self.follow:
                await self._send_tails()
                await self._publish([], close=True)
                return
            # follow: open the live watcher BEFORE the tail snapshot so no
            # line can fall between backlog and stream
            watcher = self.logs.watch()
            try:
                await self._send_tails()
                get = asyncio.ensure_future(watcher.__anext__())
                while True:
                    resc = asyncio.ensure_future(self._rescan_event.wait())
                    done, _ = await asyncio.wait(
                        {get, resc}, return_when=asyncio.FIRST_COMPLETED)
                    if resc in done:
                        self._rescan_event.clear()
                        await self._send_tails()
                    else:
                        resc.cancel()
                    if get in done:
                        msg = get.result()
                        t_id = msg.context.task_id
                        if t_id in self._published:
                            if msg.seq > self._tail_seq.get(t_id, 0):
                                await self._publish([msg])
                        elif any(t.id == t_id
                                 for t in self.matching_tasks()):
                            self._published.add(t_id)
                            msgs = self.logs.tail(t_id, self.tail_n)
                            if msgs:
                                # same dedup as _send_tails: this live
                                # line (and any later ones already in
                                # the ring) ride the snapshot
                                self._tail_seq[t_id] = msgs[-1].seq
                            await self._publish(msgs)
                        get = asyncio.ensure_future(watcher.__anext__())
            finally:
                watcher.close()
        except asyncio.CancelledError:
            pass
        except Exception as e:
            log.info("log publisher for %s failed: %s", self.sub.id, e)


class LogSubscriptionLoop:
    """Consumes ListenSubscriptions and manages one publisher per active
    subscription (reference: agent.go:207 handleSubscriptions)."""

    def __init__(self, client, worker, logs: TaskLogBuffer,
                 node_id: str) -> None:
        self.client = client
        self.worker = worker
        self.logs = logs
        self.node_id = node_id
        self.publishers: dict[str, SubscriptionPublisher] = {}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            await _cancel_and_wait(self._task)
            self._task = None
        for p in list(self.publishers.values()):
            await p.stop()
        self.publishers = {}

    async def _run(self) -> None:
        try:
            async for smsg in self.client.listen_subscriptions(self.node_id):
                pub = self.publishers.get(smsg.id)
                if smsg.close:
                    if pub is not None:
                        await pub.stop()
                        self.publishers.pop(smsg.id, None)
                    continue
                if pub is None:
                    pub = SubscriptionPublisher(smsg, self.worker, self.logs,
                                                self.client, self.node_id)
                    self.publishers[smsg.id] = pub
                    pub.start()
                else:
                    pub.rescan()
        except asyncio.CancelledError:
            pass
        except Exception as e:
            log.info("log subscription loop ended: %s", e)
