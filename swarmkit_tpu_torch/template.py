"""Go-template-style expansion in container specs.

The PyTorch port's own copy of the JAX package's template.py, unchanged
in behaviour.

Reference: template/ (513 LoC) — expands ``{{.Service.Name}}``,
``{{.Task.Slot}}``, ``{{.Node.Hostname}}`` … in env vars, hostname and
mount sources of a task's container spec, with the per-task context built
from the task + node objects (template/context.go NewContext).
"""

from __future__ import annotations

import re

_VAR_RE = re.compile(r"\{\{\s*\.([A-Za-z.]+)\s*\}\}")


class TemplateError(Exception):
    pass


def task_context(task, node=None) -> dict[str, str]:
    """reference: template/context.go Context fields."""
    service_name = task.service_annotations.name
    slot = str(task.slot) if task.slot else task.node_id
    ctx = {
        "Service.ID": task.service_id,
        "Service.Name": service_name,
        "Task.ID": task.id,
        "Task.Name": f"{service_name}.{slot}.{task.id}" if service_name
                     else task.id,
        "Task.Slot": str(task.slot),
    }
    for k, v in task.service_annotations.labels.items():
        ctx[f"Service.Labels.{k}"] = v
    if node is not None:
        ctx["Node.ID"] = node.id
        hostname = node.description.hostname if node.description else ""
        ctx["Node.Hostname"] = hostname
        plat = node.description.platform if node.description else None
        ctx["Node.Platform.OS"] = plat.os if plat else ""
        ctx["Node.Platform.Architecture"] = plat.architecture if plat else ""
    return ctx


def expand(text: str, ctx: dict[str, str]) -> str:
    def sub(m: re.Match) -> str:
        key = m.group(1)
        if key not in ctx:
            raise TemplateError(f"unknown template variable .{key}")
        return ctx[key]

    return _VAR_RE.sub(sub, text)


def expand_secret_spec(secret, task, node=None):
    """Per-task expansion of a templated secret/config PAYLOAD
    (reference: template/expand.go:132 ExpandSecretSpec,
    template/getter.go templatedSecretGetter).  No templating driver ->
    returned unchanged; expansion errors raise TemplateError so the task
    is rejected rather than fed a half-expanded payload."""
    if getattr(secret.spec, "templating", None) is None:
        return secret
    ctx = task_context(task, node)
    out = secret.copy()
    try:
        text = secret.spec.data.decode("utf-8")
    except UnicodeDecodeError:
        # a binary payload with templating enabled is a spec error, not a
        # crash: surface the documented TemplateError so the task FSM
        # rejects the task cleanly
        name = getattr(secret.spec.annotations, "name", "") or secret.id
        raise TemplateError(
            f"templated payload of {name} is not valid UTF-8")
    out.spec.data = expand(text, ctx).encode("utf-8")
    return out


def expand_container_spec(task, node=None):
    """Return a task copy with its container spec expanded
    (reference: template/expand.go ExpandContainerSpec)."""
    if task.spec.container is None:
        return task
    ctx = task_context(task, node)
    t = task.copy()
    c = t.spec.container
    c.env = [expand(e, ctx) for e in c.env]
    if c.hostname:
        c.hostname = expand(c.hostname, ctx)
    for m in c.mounts:
        # reference template/expand.go:expandMounts — per-task volume
        # sources like "data-{{.Task.Slot}}" and label values expand here
        if m.source:
            m.source = expand(m.source, ctx)
        if m.target:
            m.target = expand(m.target, ctx)
        m.volume_labels = {k: expand(v, ctx)
                           for k, v in m.volume_labels.items()}
    return t
