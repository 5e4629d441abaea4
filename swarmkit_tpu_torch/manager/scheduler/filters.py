"""Scheduler filter pipeline.

Reference: manager/scheduler/filter.go (Ready/Resource/Plugin/Constraint/
Platform/HostPort/MaxReplicas filters) and pipeline.go (Pipeline.Process:
SetTask once per task, then Check per node, collecting failure explanations).

The port's own copy of the JAX package's module of the same name, line
for line.
"""

from __future__ import annotations

from swarmkit_tpu_torch.api import NodeAvailability, NodeState
from swarmkit_tpu_torch.manager import constraint as constraint_mod
from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo, task_reserved


class Filter:
    name = "filter"

    def set_task(self, task) -> bool:
        """Return False if this filter is a no-op for the task."""
        raise NotImplementedError

    def check(self, info: NodeInfo) -> bool:
        raise NotImplementedError


class ReadyFilter(Filter):
    """Node must be READY and ACTIVE (filter.go:31)."""

    name = "ready"

    def set_task(self, task) -> bool:
        return True

    def check(self, info: NodeInfo) -> bool:
        return (info.node.status.state == NodeState.READY
                and info.node.spec.availability == NodeAvailability.ACTIVE)


class ResourceFilter(Filter):
    """Reservations must fit remaining resources (filter.go:58)."""

    name = "resource"

    def __init__(self) -> None:
        self._cpus = 0
        self._mem = 0
        self._generic: dict[str, int] = {}

    def set_task(self, task) -> bool:
        self._cpus, self._mem, self._generic = task_reserved(task)
        return bool(self._cpus or self._mem or self._generic)

    def check(self, info: NodeInfo) -> bool:
        if self._cpus > info.available_cpus:
            return False
        if self._mem > info.available_memory:
            return False
        for k, v in self._generic.items():
            # a named id set satisfies a count reservation when enough ids
            # remain free (reference: filter.go:107-150 generic resources)
            if k in info.available_named:
                if v > len(info.available_named[k]):
                    return False
            elif v > info.available_generic.get(k, 0):
                return False
        return True


class ConstraintFilter(Filter):
    """Placement constraint expressions (filter.go:153)."""

    name = "constraint"

    def __init__(self) -> None:
        self._constraints: list = []

    def set_task(self, task) -> bool:
        p = task.spec.placement
        if p is None or not p.constraints:
            self._constraints = []
            return False
        try:
            self._constraints = constraint_mod.parse(p.constraints)
        except constraint_mod.InvalidConstraint:
            # a stored task with an unparseable constraint (pre-validation
            # data, WAL replay) must not crash the scheduler loop — stay
            # active and reject every node so the task parks with an
            # explanation instead
            self._constraints = None
        return True

    def check(self, info: NodeInfo) -> bool:
        if self._constraints is None:
            return False
        return constraint_mod.node_matches(self._constraints, info.node)


class PlatformFilter(Filter):
    """Image/spec platform must match node platform (filter.go:250)."""

    name = "platform"

    def __init__(self) -> None:
        self._platforms: list[str] = []

    def set_task(self, task) -> bool:
        p = task.spec.placement
        self._platforms = list(p.platforms) if p is not None else []
        return bool(self._platforms)

    def check(self, info: NodeInfo) -> bool:
        desc = info.node.description
        plat = desc.platform if desc is not None else None
        if plat is None:
            return False
        node_plat = f"{plat.os}/{plat.architecture}"
        for want in self._platforms:
            if "/" not in want:
                want = f"{want}/{plat.architecture}"
            w_os, w_arch = want.split("/", 1)
            if (not w_os or w_os == plat.os) \
                    and (not w_arch or w_arch == plat.architecture):
                return True
        return False


class HostPortFilter(Filter):
    """Host-mode published ports must be free on the node (filter.go:300)."""

    name = "hostport"

    def __init__(self) -> None:
        self._ports: list[tuple[str, int]] = []

    @staticmethod
    def _host_ports(task) -> list[tuple[str, int]]:
        ep = task.endpoint
        if ep is None:
            return []
        return [(p.protocol, p.published_port) for p in ep.ports
                if p.publish_mode == "host" and p.published_port]

    def set_task(self, task) -> bool:
        self._ports = self._host_ports(task)
        return bool(self._ports)

    def check(self, info: NodeInfo) -> bool:
        used = set()
        for t in info.tasks.values():
            if info.counts_toward_load(t):
                used.update(self._host_ports(t))
        return not any(p in used for p in self._ports)


class MaxReplicasFilter(Filter):
    """placement.max_replicas per node (filter.go:356)."""

    name = "maxreplicas"

    def __init__(self) -> None:
        self._max = 0
        self._service = ""

    def set_task(self, task) -> bool:
        p = task.spec.placement
        self._max = p.max_replicas if p is not None else 0
        self._service = task.service_id
        return self._max > 0

    def check(self, info: NodeInfo) -> bool:
        return info.count_for_service(self._service) < self._max


class PluginFilter(Filter):
    """Node must carry the network/log driver plugins the task references
    (filter.go:104-201).  Plugin entries on EngineDescription.plugins are
    'Type/name' strings ('Network/overlay', 'Log/json-file').  Mirrors the
    reference's leniencies: no engine description -> pass; a named log
    driver only filters when the node reports ANY Log/ plugins (older
    engines didn't report them)."""

    name = "plugin"

    def __init__(self) -> None:
        self._log_driver = ""
        self._net_drivers: list[str] = []

    def set_task(self, task) -> bool:
        # the RESOLVED driver (task.log_driver, populated by new_task from
        # the spec or the cluster's TaskDefaults) — not the raw spec field
        ld = task.log_driver if task.log_driver is not None \
            else getattr(task.spec, "log_driver", None)
        self._log_driver = ld.name if ld is not None \
            and ld.name not in ("", "none") else ""
        self._net_drivers = [a.driver for a in task.networks if a.driver]
        return bool(self._log_driver or self._net_drivers)

    def check(self, info: NodeInfo) -> bool:
        desc = info.node.description
        if desc is None:
            return True   # not running an engine: plugins unsupported
        plugins = set(desc.engine.plugins)
        for d in self._net_drivers:
            if f"Network/{d}" not in plugins:
                return False
        if self._log_driver:
            reports_log = any(p.startswith("Log/") for p in plugins)
            if reports_log and f"Log/{self._log_driver}" not in plugins:
                return False
        return True


DEFAULT_FILTERS = (ReadyFilter, PluginFilter, ResourceFilter,
                   ConstraintFilter, PlatformFilter, HostPortFilter,
                   MaxReplicasFilter)


class Pipeline:
    """reference: pipeline.go:37."""

    def __init__(self, filters=None) -> None:
        self._all = [f() for f in (filters or DEFAULT_FILTERS)]
        self._active: list[Filter] = []

    def set_task(self, task) -> None:
        self._active = [f for f in self._all if f.set_task(task)]

    def process(self, info: NodeInfo) -> bool:
        return all(f.check(info) for f in self._active)

    def explain(self, info: NodeInfo) -> str:
        failed = [f.name for f in self._active if not f.check(info)]
        return "no suitable node (%s)" % ", ".join(failed) if failed else ""
