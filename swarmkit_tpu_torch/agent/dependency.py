"""Worker-side secret/config stores.

The PyTorch port's own copy of the JAX package's agent/dependency.py,
unchanged in behaviour.

Reference: agent/secrets/secrets.go, agent/configs/configs.go,
agent/dependency.go — in-memory maps fed by assignment changes, read by
controllers when materializing task filesystems/env.
"""

from __future__ import annotations

from typing import Optional


class _DepStore:
    def __init__(self) -> None:
        self._items: dict[str, object] = {}

    def get(self, dep_id: str) -> Optional[object]:
        return self._items.get(dep_id)

    def add(self, *items) -> None:
        for it in items:
            self._items[it.id] = it

    def remove(self, ids) -> None:
        for dep_id in ids:
            self._items.pop(dep_id, None)

    def reset(self) -> None:
        self._items = {}

    def __len__(self) -> int:
        return len(self._items)


class Secrets(_DepStore):
    """reference: agent/secrets/secrets.go:18."""


class Configs(_DepStore):
    """reference: agent/configs/configs.go:18."""


class Dependencies:
    """reference: agent/dependency.go dependencyManager."""

    def __init__(self) -> None:
        self.secrets = Secrets()
        self.configs = Configs()

    def templated(self, task, node=None) -> "TemplatedDependencies":
        """Per-task view whose gets expand templated payloads
        (reference: template/getter.go NewTemplatedDependencyGetter)."""
        return TemplatedDependencies(self, task, node)


class _TemplatedStore:
    def __init__(self, store: _DepStore, task, node) -> None:
        self._store = store
        self._task = task
        self._node = node

    def get(self, dep_id: str) -> Optional[object]:
        from swarmkit_tpu_torch.template import expand_secret_spec

        item = self._store.get(dep_id)
        if item is None:
            return None
        return expand_secret_spec(item, self._task, self._node)

    def __len__(self) -> int:
        return len(self._store)


class TemplatedDependencies:
    """reference: template/getter.go templatedDependencyGetter."""

    def __init__(self, deps: Dependencies, task, node) -> None:
        self.secrets = _TemplatedStore(deps.secrets, task, node)
        self.configs = _TemplatedStore(deps.configs, task, node)
