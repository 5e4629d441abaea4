"""Worker-local task persistence.

Reference: agent/storage.go — a boltdb file with per-task buckets holding the
task data, its latest status, and an "assigned" flag, so a restarted worker
can reconcile running work against fresh assignments.  Re-expressed over
sqlite3 (in this image; boltdb is Go-only): one table, same three facts.

The port's own copy of the JAX package's agent/storage.py.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Iterable, Optional

from swarmkit_tpu_torch.api import Task, TaskStatus


class TaskDB:
    def __init__(self, path: str = ":memory:") -> None:
        if path != ":memory:":
            import os

            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS tasks ("
            " id TEXT PRIMARY KEY,"
            " data TEXT NOT NULL,"
            " status TEXT,"
            " assigned INTEGER NOT NULL DEFAULT 0)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta ("
            " key TEXT PRIMARY KEY, value TEXT NOT NULL)")
        self._db.commit()

    def close(self) -> None:
        self._db.close()

    # ------------------------------------------------------------------
    def put_task(self, task) -> None:
        """reference: PutTask storage.go — stores spec-side task data."""
        self._db.execute(
            "INSERT INTO tasks (id, data, assigned) VALUES (?, ?, 0)"
            " ON CONFLICT(id) DO UPDATE SET data = excluded.data",
            (task.id, json.dumps(task.to_dict())))
        self._db.commit()

    def get_task(self, task_id: str) -> Optional[Task]:
        row = self._db.execute(
            "SELECT data FROM tasks WHERE id = ?", (task_id,)).fetchone()
        if row is None:
            return None
        return Task.from_dict(json.loads(row[0]))

    def delete_task(self, task_id: str) -> None:
        self._db.execute("DELETE FROM tasks WHERE id = ?", (task_id,))
        self._db.commit()

    def put_task_status(self, task_id: str, status: TaskStatus) -> None:
        self._db.execute(
            "UPDATE tasks SET status = ? WHERE id = ?",
            (json.dumps(status.to_dict()), task_id))
        self._db.commit()

    def get_task_status(self, task_id: str) -> Optional[TaskStatus]:
        row = self._db.execute(
            "SELECT status FROM tasks WHERE id = ?", (task_id,)).fetchone()
        if row is None or row[0] is None:
            return None
        return TaskStatus.from_dict(json.loads(row[0]))

    def set_task_assignment(self, task_id: str, assigned: bool) -> None:
        self._db.execute(
            "UPDATE tasks SET assigned = ? WHERE id = ?",
            (1 if assigned else 0, task_id))
        self._db.commit()

    def task_assigned(self, task_id: str) -> bool:
        row = self._db.execute(
            "SELECT assigned FROM tasks WHERE id = ?", (task_id,)).fetchone()
        return bool(row and row[0])

    def put_node(self, node) -> None:
        """Persist the last-known node object so a restarted worker can
        expand task templates before the first session message arrives."""
        self._db.execute(
            "INSERT INTO meta (key, value) VALUES ('node', ?)"
            " ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (json.dumps(node.to_dict()),))
        self._db.commit()

    def get_node(self):
        from swarmkit_tpu_torch.api import Node

        row = self._db.execute(
            "SELECT value FROM meta WHERE key = 'node'").fetchone()
        if row is None:
            return None
        return Node.from_dict(json.loads(row[0]))

    def walk(self) -> Iterable[tuple[Task, Optional[TaskStatus], bool]]:
        for tid, data, status, assigned in self._db.execute(
                "SELECT id, data, status, assigned FROM tasks ORDER BY id"):
            t = Task.from_dict(json.loads(data))
            st = TaskStatus.from_dict(json.loads(status)) if status else None
            yield t, st, bool(assigned)
