"""Per-session assignment diff tracker.

Reference: manager/dispatcher/assignments.go (assignmentSet :19).  Tracks the
set of tasks assigned to one node plus the secrets/configs those tasks
reference; ``add_or_update_task``/``remove_task`` accumulate pending changes,
``message()`` drains them into one AssignmentsMessage.  Dependencies are
reference-counted so a secret is only REMOVEd once the last task using it
goes away (assignments.go tasksUsingDependency), and are released when a
task reaches a terminal state (addOrUpdateTask :229).

The port's own copy of the JAX package's manager/dispatcher/assignments.py.
"""

from __future__ import annotations

from swarmkit_tpu_torch.api import Config, Secret, Task, TaskState
from swarmkit_tpu_torch.api.dispatcher_msgs import (
    Assignment, AssignmentAction, AssignmentChange, AssignmentsMessage,
    AssignmentsType,
)


def _task_dependencies(t) -> list[tuple[str, str]]:
    deps: list[tuple[str, str]] = []
    c = getattr(t.spec, "container", None)
    if c is not None:
        deps += [("secret", r.secret_id) for r in c.secrets]
        deps += [("config", r.config_id) for r in c.configs]
    return deps


def tasks_equal_stable(a, b) -> bool:
    """Equality ignoring status/meta (reference: api/equality
    TasksEqualStable)."""
    da, db = a.to_dict(), b.to_dict()
    for d in (da, db):
        d.pop("status", None)
        d.pop("meta", None)
    return da == db


class AssignmentSet:
    def __init__(self, node_id: str, drivers=None) -> None:
        self.node_id = node_id
        self.drivers = drivers  # DriverProvider for external secrets
        self.tasks: dict[str, Task] = {}
        # (kind, id) -> set of task ids using it
        self.tasks_using_dependency: dict[tuple[str, str], set[str]] = {}
        self.changes: dict[tuple[str, str], AssignmentChange] = {}

    # ------------------------------------------------------------------
    def _add_task_dependencies(self, read_tx, t) -> None:
        from swarmkit_tpu_torch.manager.drivers import resolve_secret

        for kind, dep_id in _task_dependencies(t):
            key = (kind, dep_id)
            users = self.tasks_using_dependency.setdefault(key, set())
            if not users:
                if kind == "secret":
                    # External secrets resolve through their driver at
                    # assignment time, once per node per secret with the
                    # FIRST task's context — exactly the reference's dedup
                    # (assignments.go addTaskDependencies:
                    # len(tasksUsingDependency)==0 gate + assignSecret).
                    # Any driver failure withholds the secret, never the
                    # whole assignment stream.
                    try:
                        obj = resolve_secret(self.drivers, read_tx, t,
                                             dep_id)
                    except Exception as e:
                        import logging

                        logging.getLogger(
                            "swarmkit_tpu_torch.dispatcher").warning(
                            "secret %s for task %s unavailable: %s",
                            dep_id, t.id, e)
                        obj = None
                else:
                    obj = read_tx.get(kind, dep_id)
                if obj is not None:
                    self.changes[key] = AssignmentChange(
                        assignment=Assignment(**{kind: obj}),
                        action=AssignmentAction.UPDATE)
            users.add(t.id)

    def _release_task_dependencies(self, t) -> bool:
        modified = False
        for kind, dep_id in _task_dependencies(t):
            key = (kind, dep_id)
            users = self.tasks_using_dependency.get(key)
            if users is None:
                continue
            users.discard(t.id)
            if not users:
                del self.tasks_using_dependency[key]
                stub = (Secret if kind == "secret" else Config)(id=dep_id)
                self.changes[key] = AssignmentChange(
                    assignment=Assignment(**{kind: stub}),
                    action=AssignmentAction.REMOVE)
                modified = True
        return modified

    # ------------------------------------------------------------------
    def add_or_update_task(self, read_tx, t) -> bool:
        """Reference: assignments.go addOrUpdateTask :214."""
        if t.status.state < TaskState.ASSIGNED:
            return False
        old = self.tasks.get(t.id)
        if old is not None:
            # States <= ASSIGNED are set by the orchestrator/scheduler, not
            # the agent, so those must always be re-sent; otherwise a
            # spec-stable update is agent-reported status echo — swallow it.
            if tasks_equal_stable(old, t) and t.status.state > TaskState.ASSIGNED:
                self.tasks[t.id] = t
                if t.status.state > TaskState.RUNNING:
                    return self._release_task_dependencies(t)
                return False
        elif t.status.state <= TaskState.RUNNING:
            self._add_task_dependencies(read_tx, t)
        self.tasks[t.id] = t
        self.changes[("task", t.id)] = AssignmentChange(
            assignment=Assignment(task=t),
            action=AssignmentAction.UPDATE)
        return True

    def remove_task(self, t) -> bool:
        """Reference: assignments.go removeTask :256."""
        if t.id not in self.tasks:
            return False
        self.changes[("task", t.id)] = AssignmentChange(
            assignment=Assignment(task=Task(id=t.id)),
            action=AssignmentAction.REMOVE)
        del self.tasks[t.id]
        self._release_task_dependencies(t)
        return True

    # ------------------------------------------------------------------
    def message(self, type: AssignmentsType = AssignmentsType.INCREMENTAL
                ) -> AssignmentsMessage:
        """Drain pending changes (assignments.go message :279)."""
        msg = AssignmentsMessage(type=type, changes=list(self.changes.values()))
        self.changes = {}
        return msg
