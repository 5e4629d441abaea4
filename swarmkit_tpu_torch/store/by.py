"""Query combinators (reference: manager/state/store/by.go).

A ``By`` resolves against a table's secondary indexes; ``Or`` unions.
Index names here must match those registered in memory.py's TABLE_INDEXES.

The port's own copy of the JAX package's store/by.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


class By:
    pass


@dataclass(frozen=True)
class All(By):
    pass


@dataclass(frozen=True)
class ByID(By):
    id: str


@dataclass(frozen=True)
class ByIDPrefix(By):
    prefix: str


@dataclass(frozen=True)
class ByName(By):
    name: str


@dataclass(frozen=True)
class ByNamePrefix(By):
    prefix: str


@dataclass(frozen=True)
class ByService(By):
    service_id: str


@dataclass(frozen=True)
class ByNode(By):
    node_id: str


@dataclass(frozen=True)
class BySlot(By):
    service_id: str
    slot: int


@dataclass(frozen=True)
class ByDesiredState(By):
    state: int


@dataclass(frozen=True)
class ByTaskState(By):
    state: int


@dataclass(frozen=True)
class ByRole(By):
    role: int


@dataclass(frozen=True)
class ByMembership(By):
    membership: int


@dataclass(frozen=True)
class ByReferencedSecret(By):
    secret_id: str


@dataclass(frozen=True)
class ByReferencedConfig(By):
    config_id: str


class Or(By):
    def __init__(self, *bys: By) -> None:
        self.bys = bys


@dataclass(frozen=True)
class Custom(By):
    """Linear-scan predicate escape hatch (no reference analog; convenience)."""

    predicate: Callable
