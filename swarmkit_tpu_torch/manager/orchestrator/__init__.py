"""Orchestrators: reconcile service specs into tasks.

Reference: manager/orchestrator/ — replicated + global orchestrators, the
restart and update supervisors, task reaper, constraint enforcer, and the
shared task helpers (task.go).

The port's own copy of the JAX package's manager/orchestrator/__init__.py.
"""

from swarmkit_tpu_torch.manager.orchestrator.common import (
    new_task, is_task_dirty, restart_condition, slot_tuple,
)

__all__ = ["new_task", "is_task_dirty", "restart_condition", "slot_tuple"]
