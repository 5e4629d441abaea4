"""The scheduler: its store loop and group placement (the port's own
copy of the JAX package's manager/scheduler)."""

from swarmkit_tpu_torch.manager.scheduler.scheduler import Scheduler
from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo
from swarmkit_tpu_torch.manager.scheduler.filters import (
    Filter, Pipeline, ReadyFilter, ResourceFilter, ConstraintFilter,
    PlatformFilter, HostPortFilter, MaxReplicasFilter,
)

__all__ = ["Scheduler", "NodeInfo", "Filter", "Pipeline", "ReadyFilter",
           "ResourceFilter", "ConstraintFilter", "PlatformFilter",
           "HostPortFilter", "MaxReplicasFilter"]
