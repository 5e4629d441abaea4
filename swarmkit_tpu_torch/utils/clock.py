"""Injectable time source (the port's own copy of the part of the JAX
package's utils/clock.py that the scheduler uses: `now`).

The scheduler reads `now()` once per group to age failure taints; tests
pass a clock of their own to pin it.
"""

from __future__ import annotations

import time as _time


class Clock:
    """Abstract time source."""

    def now(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    def now(self) -> float:
        return _time.monotonic()
