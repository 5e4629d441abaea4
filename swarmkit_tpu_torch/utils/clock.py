"""Injectable time source for deterministic tests.

The reference injects a fakeclock.FakeClock into the raft node
(manager/state/raft/raft.go:187-190) and pumps it from tests
(manager/state/raft/testutils/testutils.go).  We reproduce that seam for the
asyncio control plane: every component takes a ``Clock``; tests use
``FakeClock`` and call ``advance()`` to fire timers deterministically.

The port's own copy of the JAX package's utils/clock.py.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time as _time
from typing import Optional


class Clock:
    """Abstract time source."""

    def now(self) -> float:
        raise NotImplementedError

    async def sleep(self, delay: float) -> None:
        raise NotImplementedError

    def ticker(self, interval: float) -> "Ticker":
        return Ticker(self, interval)


class SystemClock(Clock):
    def now(self) -> float:
        return _time.monotonic()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


class FakeClock(Clock):
    """Deterministic clock: time moves only via ``advance()``.

    ``advance`` wakes every sleeper whose deadline has passed and yields to
    the event loop so woken tasks run before it returns.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = start
        self._sleepers: list[tuple[float, int, asyncio.Future]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    async def sleep(self, delay: float) -> None:
        if delay <= 0:
            await asyncio.sleep(0)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        heapq.heappush(self._sleepers, (self._now + delay, next(self._seq), fut))
        await fut

    def sleeper_count(self) -> int:
        return len(self._sleepers)

    async def advance(self, delta: float) -> None:
        """Move time forward, firing due sleepers in deadline order."""
        target = self._now + delta
        while self._sleepers and self._sleepers[0][0] <= target:
            deadline, _, fut = heapq.heappop(self._sleepers)
            self._now = max(self._now, deadline)
            if not fut.done():
                fut.set_result(None)
            # Let the woken task (and anything it schedules) run.
            for _ in range(4):
                await asyncio.sleep(0)
        self._now = target
        for _ in range(4):
            await asyncio.sleep(0)


class Ticker:
    """Periodic timer built on a Clock; async-iterable."""

    def __init__(self, clock: Clock, interval: float) -> None:
        self._clock = clock
        self.interval = interval
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    def __aiter__(self) -> "Ticker":
        return self

    async def __anext__(self) -> float:
        if self._stopped:
            raise StopAsyncIteration
        await self._clock.sleep(self.interval)
        if self._stopped:
            raise StopAsyncIteration
        return self._clock.now()


async def wait_for(predicate, clock: Optional[Clock] = None, timeout: float = 5.0,
                   interval: float = 0.01):
    """Poll ``predicate`` until truthy or timeout (reference: testutils/poll.go)."""
    clock = clock or SystemClock()
    deadline = clock.now() + timeout
    while True:
        val = predicate()
        if val:
            return val
        if clock.now() >= deadline:
            raise TimeoutError("condition not met within %.2fs" % timeout)
        await clock.sleep(interval)
