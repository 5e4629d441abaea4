"""Startup task fixing shared by orchestrators.

Reference: manager/orchestrator/taskinit/init.go CheckTasks — after a leader
change, re-arm delayed restarts for tasks parked in READY and restart tasks
that died while no orchestrator was watching.

The port's own copy of the JAX package's manager/orchestrator/taskinit.py.
"""

from __future__ import annotations

from swarmkit_tpu_torch.api import Mode, TaskState
from swarmkit_tpu_torch.manager.orchestrator import common


async def check_tasks(store, restart_supervisor, mode: Mode) -> None:
    dead: list = []
    parked: list = []
    by_slot: dict[tuple, list] = {}
    for t in store.find("task"):
        if not t.service_id:
            continue
        service = store.get("service", t.service_id)
        if service is None or service.spec.mode != mode:
            continue
        by_slot.setdefault(common.slot_tuple(t), []).append(t)
        if common.in_terminal_state(t) \
                and t.desired_state <= TaskState.RUNNING:
            dead.append((service, t))
        elif t.desired_state == TaskState.READY \
                and t.status.state < TaskState.RUNNING:
            parked.append(t)

    clusters = store.find("cluster")
    cluster = clusters[0] if clusters else None
    for service, task in dead:
        await store.update(
            lambda tx, s=service, t=task:
            restart_supervisor.restart(tx, cluster, s, t))
    for t in parked:
        policy = common.restart_policy(t)
        # credit time already waited before the failover: the delay runs
        # from the predecessor's failure timestamp, not from re-arm
        # (reference init.go:74-87 restartTime arithmetic)
        delay = policy.delay
        if delay > 0 and t.status.timestamp:
            elapsed = restart_supervisor.clock.now() - t.status.timestamp
            delay = max(0.0, delay - elapsed)
        # unlike the reference (init.go:94 passes a nil oldTask), keep the
        # old-task wait across failovers: the slot's predecessor — still
        # draining toward SHUTDOWN — is recoverable from the slot itself
        old = next((o for o in by_slot.get(common.slot_tuple(t), [])
                    if o.id != t.id
                    and o.desired_state > TaskState.RUNNING
                    and o.status.state <= TaskState.RUNNING), None)
        restart_supervisor.delay_start(t.id, delay, old_task=old)
