"""Watch API: filtered store event streams with resume-from-version.

Reference: manager/watchapi/server.go (:17) + watch.go — clients subscribe
to (kind, id-prefix/name) selectors; events arrive with the old object when
requested; ``resume_from`` replays history between the requested version
and now via the raft log (store.WatchFrom memory.go:871) before going live.

The port's own copy of the JAX package's manager/watchapi.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

from swarmkit_tpu_torch.store.memory import Event, EventCommit, MemoryStore

_KIND_ALL = ""


@dataclass
class WatchSelector:
    kind: str = _KIND_ALL
    id_prefix: str = ""
    name: str = ""
    actions: tuple[str, ...] = ()     # subset of create/update/remove


@dataclass
class WatchMessage:
    action: str
    kind: str
    object: object
    old_object: object = None
    version: int = 0


class WatchServer:
    def __init__(self, store: MemoryStore, proposer=None) -> None:
        self.store = store
        self.proposer = proposer   # for changes_between on resume

    def _matches(self, selectors: list[WatchSelector], ev: Event) -> bool:
        if not selectors:
            return True
        for s in selectors:
            if s.kind and ev.kind != s.kind:
                continue
            if s.actions and ev.action not in s.actions:
                continue
            if s.id_prefix and not ev.object.id.startswith(s.id_prefix):
                continue
            if s.name:
                ann = getattr(ev.object, "annotations", None)
                if ann is None or ann.name != s.name:
                    continue
            return True
        return False

    async def watch(self, selectors: Optional[list[WatchSelector]] = None,
                    resume_from: Optional[int] = None,
                    include_old_object: bool = False
                    ) -> AsyncIterator[WatchMessage]:
        """One subscription (reference: watchapi/watch.go Watch RPC)."""
        selectors = selectors or []
        watcher = self.store.watch(
            lambda e: isinstance(e, (Event, EventCommit)))
        version = self.store.version
        try:
            if resume_from is not None and self.proposer is not None:
                for idx, actions in self.proposer.changes_between(
                        resume_from, version):
                    for a in actions:
                        ev = Event(_ACTIONS[a.action], a.kind, a.object())
                        if self._matches(selectors, ev):
                            yield WatchMessage(
                                action=ev.action, kind=ev.kind,
                                object=ev.object, version=idx)
            pending: list[Event] = []
            async for ev in watcher:
                if isinstance(ev, Event):
                    if self._matches(selectors, ev):
                        pending.append(ev)
                    continue
                for p in pending:  # flush on commit with its version
                    yield WatchMessage(
                        action=p.action, kind=p.kind, object=p.object,
                        old_object=(p.old_object if include_old_object
                                    else None),
                        version=ev.version)
                pending = []
        finally:
            watcher.close()


def _action_name(kind_val) -> str:
    from swarmkit_tpu_torch.api.raft_msgs import StoreActionKind

    return {StoreActionKind.CREATE: "create", StoreActionKind.UPDATE: "update",
            StoreActionKind.REMOVE: "remove"}[kind_val]


class _Actions:
    def __getitem__(self, kind_val) -> str:
        return _action_name(kind_val)


_ACTIONS = _Actions()
