"""Cluster-wide service logs: subscription fan-out to agents, message relay
back to API clients.

Reference: manager/logbroker/broker.go (LogBroker :38, SubscribeLogs :224,
ListenSubscriptions :306 — the agent side, PublishLogs :380) and
subscription.go (task/node resolution from a LogSelector).  A client's
SubscribeLogs creates a subscription; every agent whose node runs a matching
task hears it via ListenSubscriptions, streams its workloads' output through
PublishLogs, and the broker relays to the client queue.

The port's own copy of the JAX package's manager/logbroker.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

from swarmkit_tpu_torch.store.by import ByNode, ByService
from swarmkit_tpu_torch.store.memory import MemoryStore
from swarmkit_tpu_torch.utils.identity import new_id
from swarmkit_tpu_torch.watch.queue import Queue


class LogStream(enum.IntEnum):
    UNKNOWN = 0
    STDOUT = 1
    STDERR = 2


@dataclass
class LogContext:
    service_id: str = ""
    node_id: str = ""
    task_id: str = ""


@dataclass
class LogMessage:
    context: LogContext = field(default_factory=LogContext)
    timestamp: float = 0.0
    stream: LogStream = LogStream.STDOUT
    data: bytes = b""
    # producer-local monotonic position (TaskLogBuffer ring sequence);
    # lets a follow-mode publisher skip live lines already shipped in the
    # tail snapshot (duplicate suppression) — never crosses the wire as
    # an identity, purely ordering metadata
    seq: int = 0


@dataclass
class LogSelector:
    service_ids: list[str] = field(default_factory=list)
    node_ids: list[str] = field(default_factory=list)
    task_ids: list[str] = field(default_factory=list)


@dataclass
class SubscribeLogsOptions:
    """reference: api/logbroker.proto:24-28 SubscribeLogsOptions."""

    follow: bool = True        # keep streaming after the backlog
    tail: int = -1             # last N buffered messages (-1 = all)
    streams: tuple = ()        # () = both stdout and stderr
    # non-follow safety valve: a matching node that never publishes (down,
    # no agent) must not hang the stream forever — after this many seconds
    # the backlog collected so far is returned (the reference blocks until
    # context cancellation; a CLI deserves a bound)
    max_wait: float = 10.0


@dataclass
class SubscriptionMessage:
    id: str = ""
    selector: LogSelector = field(default_factory=LogSelector)
    close: bool = False
    options: dict = field(default_factory=dict)


class Subscription:
    def __init__(self, selector: LogSelector, store: MemoryStore,
                 options: Optional[SubscribeLogsOptions] = None) -> None:
        self.id = new_id()
        self.selector = selector
        self.options = options or SubscribeLogsOptions()
        self.store = store
        self.queue: Queue = Queue()
        self.closed = False
        # non-follow completion (reference: broker.go publisher tracking):
        # nodes expected to publish a backlog; when every one has sent its
        # close marker and follow is off, the client stream ends
        self.pending_nodes: set[str] = set()

    def node_ids(self) -> set[str]:
        """Nodes whose agents should feed this subscription
        (reference: subscription.go match)."""
        nodes = set(self.selector.node_ids)
        for tid in self.selector.task_ids:
            t = self.store.get("task", tid)
            if t is not None and t.node_id:
                nodes.add(t.node_id)
        for sid in self.selector.service_ids:
            for t in self.store.find("task", ByService(sid)):
                if t.node_id:
                    nodes.add(t.node_id)
        return nodes

    def message(self, close: bool = False) -> SubscriptionMessage:
        return SubscriptionMessage(
            id=self.id, selector=self.selector, close=close,
            options={"follow": self.options.follow,
                     "tail": self.options.tail,
                     "streams": [int(x) for x in self.options.streams]})


class LogBroker:
    def __init__(self, store: MemoryStore) -> None:
        self.store = store
        self.subscriptions: dict[str, Subscription] = {}
        self.subscription_bus: Queue = Queue()  # SubscriptionMessage fan-out

    # -- client side -----------------------------------------------------
    async def subscribe_logs(self, selector: LogSelector,
                             options: Optional[SubscribeLogsOptions] = None
                             ) -> AsyncIterator[LogMessage]:
        """reference: SubscribeLogs broker.go:224.  With follow=False the
        stream ends once every matching node published its backlog."""
        import asyncio

        sub = Subscription(selector, self.store, options)
        self.subscriptions[sub.id] = sub
        if not sub.options.follow:
            sub.pending_nodes = sub.node_ids()
        watcher = sub.queue.watch()
        self.subscription_bus.publish(sub.message())
        # re-announce when the service's tasks land on new nodes, so agents
        # that start matching after the subscribe pick it up
        # (reference: subscription.Run watches task events)
        refresher = asyncio.get_running_loop().create_task(
            self._refresh_subscription(sub))
        timer = None
        try:
            if not sub.options.follow:
                if not sub.pending_nodes:
                    return   # nothing runs anywhere: empty backlog
                # on expiry the stream must FAIL, not end with a clean
                # eof: nodes that never published their backlog mean the
                # tail is incomplete, and the client cannot otherwise
                # tell a complete tail from a truncated one
                timer = asyncio.get_running_loop().call_later(
                    max(sub.options.max_wait, 0.0),
                    lambda: sub.queue.publish(_TIMEOUT))
            async for msg in watcher:
                if msg is _EOF:
                    return
                if msg is _TIMEOUT:
                    if sub.pending_nodes:
                        raise LogsTruncated(
                            f"{len(sub.pending_nodes)} node(s) never "
                            f"published their backlog within "
                            f"{sub.options.max_wait}s: "
                            f"{sorted(sub.pending_nodes)}")
                    return
                yield msg
        finally:
            if timer is not None:
                timer.cancel()
            refresher.cancel()
            watcher.close()
            sub.closed = True
            self.subscriptions.pop(sub.id, None)
            self.subscription_bus.publish(sub.message(close=True))

    async def _refresh_subscription(self, sub: Subscription) -> None:
        import asyncio

        from swarmkit_tpu_torch.store.memory import Event, match

        known = sub.node_ids()
        watcher = self.store.watch(match(kind="task"))
        try:
            async for ev in watcher:
                now = sub.node_ids()
                if now - known:
                    self.subscription_bus.publish(sub.message())
                known = now
        except asyncio.CancelledError:
            pass
        finally:
            watcher.close()

    # -- agent side ------------------------------------------------------
    async def listen_subscriptions(self, node_id: str
                                   ) -> AsyncIterator[SubscriptionMessage]:
        """reference: ListenSubscriptions broker.go:306 — current matching
        subscriptions first, then live updates."""
        watcher = self.subscription_bus.watch()
        try:
            for sub in list(self.subscriptions.values()):
                if node_id in sub.node_ids():
                    yield sub.message()
            async for msg in watcher:
                sub = self.subscriptions.get(msg.id)
                if msg.close:
                    yield msg
                    continue
                if sub is not None and node_id in sub.node_ids():
                    yield msg
        finally:
            watcher.close()

    async def publish_logs(self, subscription_id: str,
                           messages: list[LogMessage],
                           node_id: str = "", close: bool = False) -> None:
        """reference: PublishLogs broker.go:380.  `close` marks this
        node's publisher finished — with follow=False the subscription
        completes once every pending node closed."""
        sub = self.subscriptions.get(subscription_id)
        if sub is None or sub.closed:
            return
        for m in messages:
            sub.queue.publish(m)
        if close and not sub.options.follow:
            sub.pending_nodes.discard(node_id)
            if not sub.pending_nodes:
                sub.queue.publish(_EOF)


class LogsTruncated(Exception):
    """Non-follow subscription timed out with nodes still pending — the
    returned tail is incomplete and the client must treat it as a failure
    (ctl._stream_logs turns this into an error line, never a clean eof)."""


class _Eof:
    """Stream-end sentinel on a subscription queue."""


class _Timeout:
    """max_wait expiry sentinel: eof if nothing is pending, else error."""


_EOF = _Eof()
_TIMEOUT = _Timeout()
