"""Event bus: the backbone of every control loop (the PyTorch port's own
copy of the JAX package's watch/queue.py, unchanged in behaviour; the
port's TaskLogBuffer fans its lines out through it).

Reference: watch/watch.go (Queue: broadcaster + per-watcher filter) and
watch/queue/queue.go (LimitQueue: a watcher that is force-closed when its
buffer exceeds a limit instead of blocking the publisher — "drop vs close"
semantics).  Publishing never blocks; slow consumers are sacrificed.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, Callable, Iterable, Optional


class WatcherClosed(Exception):
    """Raised from get() when the watcher was closed (possibly by overflow)."""


class Watcher:
    def __init__(self, queue: "Queue", matchers: tuple[Callable[[Any], bool], ...],
                 limit: int = 0) -> None:
        self._queue = queue
        self._matchers = matchers
        self._limit = limit
        self._buf: deque = deque()
        self._closed = False
        self.overflowed = False
        self._wakeup: Optional[asyncio.Future] = None

    # -- publisher side -------------------------------------------------
    def _offer(self, event: Any) -> None:
        if self._closed:
            return
        if self._matchers and not any(m(event) for m in self._matchers):
            return
        self._buf.append(event)
        if self._limit and len(self._buf) > self._limit:
            # Reference watch/queue/queue.go:21 — close the watcher rather
            # than block or silently drop.
            self.overflowed = True
            self.close()
            return
        self._wake()

    def _wake(self) -> None:
        if self._wakeup is not None and not self._wakeup.done():
            self._wakeup.set_result(None)

    # -- consumer side --------------------------------------------------
    def __len__(self) -> int:
        return len(self._buf)

    def poll(self) -> list:
        """Drain everything buffered, non-blocking."""
        out = list(self._buf)
        self._buf.clear()
        return out

    def try_get(self):
        if self._buf:
            return self._buf.popleft()
        return None

    async def get(self) -> Any:
        while True:
            if self._buf:
                return self._buf.popleft()
            if self._closed:
                raise WatcherClosed(
                    "watcher closed" + (" (overflow)" if self.overflowed else ""))
            self._wakeup = asyncio.get_running_loop().create_future()
            try:
                await self._wakeup
            finally:
                self._wakeup = None

    def __aiter__(self) -> "Watcher":
        return self

    async def __anext__(self) -> Any:
        try:
            return await self.get()
        except WatcherClosed:
            raise StopAsyncIteration

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue._watchers.discard(self)
        self._wake()

    @property
    def closed(self) -> bool:
        return self._closed


class Queue:
    """Non-blocking broadcaster with filtered, bounded watchers."""

    def __init__(self, limit: int = 0) -> None:
        self._watchers: set[Watcher] = set()
        self._default_limit = limit

    def watch(self, *matchers: Callable[[Any], bool], limit: Optional[int] = None
              ) -> Watcher:
        w = Watcher(self, matchers,
                    self._default_limit if limit is None else limit)
        self._watchers.add(w)
        return w

    def publish(self, event: Any) -> None:
        for w in list(self._watchers):
            w._offer(event)

    def publish_all(self, events: Iterable[Any]) -> None:
        for ev in events:
            self.publish(ev)

    def close(self) -> None:
        for w in list(self._watchers):
            w.close()

    def __len__(self) -> int:
        return len(self._watchers)


async def watch_with_sweep(watcher: Watcher, clock, interval: float):
    """Yield events from ``watcher`` plus ``None`` sweep ticks every
    ``interval`` — the shape of every event-driven-with-periodic-reconcile
    control loop (role manager, member-record reconciler).  Terminates
    cleanly when the watcher closes; cancels its internal futures on exit
    (asyncio.wait does NOT cancel the futures it waited on), and closes the
    watcher so callers can't leak the subscription."""
    get_ev = timer = None
    try:
        while True:
            get_ev = asyncio.ensure_future(watcher.get())
            timer = asyncio.ensure_future(clock.sleep(interval))
            done, pending = await asyncio.wait(
                {get_ev, timer}, return_when=asyncio.FIRST_COMPLETED)
            for p in pending:
                p.cancel()
            if get_ev in done:
                try:
                    yield get_ev.result()
                except WatcherClosed:
                    return
            else:
                yield None
    finally:
        for t in (get_ev, timer):
            if t is not None and not t.done():
                t.cancel()
        watcher.close()
