"""Proposal wait registry: correlates in-flight raft proposals with their
commit callbacks.  Reference: manager/state/raft/wait.go (register/trigger/
cancel/cancelAll over an id->channel map).

The port's own copy of the JAX package's raft/wait.py.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class WaitItem:
    def __init__(self, on_commit: Optional[Callable[[Any], None]],
                 on_cancel: Optional[Callable[[], None]]) -> None:
        self.on_commit = on_commit
        self.on_cancel = on_cancel


class Wait:
    def __init__(self) -> None:
        self._items: dict[int, WaitItem] = {}

    def register(self, id: int, on_commit: Optional[Callable[[Any], None]],
                 on_cancel: Optional[Callable[[], None]] = None) -> None:
        if id in self._items:
            raise RuntimeError(f"duplicate wait id {id:x}")
        self._items[id] = WaitItem(on_commit, on_cancel)

    def trigger(self, id: int, value: Any) -> bool:
        item = self._items.pop(id, None)
        if item is None:
            return False
        if item.on_commit is not None:
            item.on_commit(value)
        return True

    def cancel(self, id: int) -> None:
        item = self._items.pop(id, None)
        if item is not None and item.on_cancel is not None:
            item.on_cancel()

    def forget(self, id: int) -> None:
        """Drop a wait without firing either callback (timeout path)."""
        self._items.pop(id, None)

    def cancel_all(self) -> None:
        for id in list(self._items):
            self.cancel(id)

    def __len__(self) -> int:
        return len(self._items)
