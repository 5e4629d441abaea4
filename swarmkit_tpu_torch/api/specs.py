"""The task spec fields the executor reads (the port's own copy of the
JAX package's api/specs.py ContainerSpec, SecretReference,
ConfigReference and TaskSpec; fields the executor never reads are left
out)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SecretReference:
    secret_id: str = ""
    secret_name: str = ""
    target_name: str = ""


@dataclass
class ConfigReference:
    config_id: str = ""
    config_name: str = ""
    target_name: str = ""


@dataclass
class ContainerSpec:
    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    secrets: list[SecretReference] = field(default_factory=list)
    configs: list[ConfigReference] = field(default_factory=list)


@dataclass
class TaskSpec:
    container: Optional[ContainerSpec] = None
