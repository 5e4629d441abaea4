"""swarmctl: CLI over the control socket.

Reference: cmd/swarmctl — cluster/node/service/task/network/secret/config
subcommands against the Control API unix socket.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from swarmkit_tpu_torch.api import TaskState
from swarmkit_tpu_torch.cmd.ctl import ControlSocketClient, CtlError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="swarmctl")
    p.add_argument("--socket", "-s", default="./swarmkitstate/swarmd.sock")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("cluster-inspect")
    sub.add_parser("metrics")
    sub.add_parser("cluster-tokens")
    sub.add_parser("cluster-rotate-ca")
    sp = sub.add_parser("cluster-update")
    sp.add_argument("--task-history", type=int, default=None,
                    help="dead tasks retained per slot (reaper)")
    sp.add_argument("--heartbeat-period", type=float, default=None,
                    help="agent heartbeat period seconds (dispatcher)")
    sp.add_argument("--cert-expiry", type=float, default=None,
                    help="node certificate lifetime seconds (CA)")
    sp.add_argument("--rotate-worker-token", action="store_true")
    sp.add_argument("--rotate-manager-token", action="store_true")
    sp = sub.add_parser("cluster-autolock")
    sp.add_argument("enabled", choices=["on", "off"])
    sp = sub.add_parser("cluster-unlock-key")
    sp.add_argument("--rotate", action="store_true")

    sub.add_parser("node-ls")
    for name in ("node-inspect", "node-rm", "node-promote", "node-demote"):
        sp = sub.add_parser(name)
        sp.add_argument("id")
        if name == "node-rm":
            sp.add_argument("--force", action="store_true")
    # reference: cmd/swarmctl/node/update.go (activate/pause/drain live as
    # their own verbs there; one verb + --availability covers all three)
    sp = sub.add_parser("node-update")
    sp.add_argument("id")
    sp.add_argument("--availability", choices=["active", "pause", "drain"])
    sp.add_argument("--label-add", action="append", default=[],
                    metavar="KEY=VALUE")
    sp.add_argument("--label-rm", action="append", default=[],
                    metavar="KEY")

    sp = sub.add_parser("service-create")
    sp.add_argument("--name", required=True)
    sp.add_argument("--image", required=True)
    sp.add_argument("--mode", choices=["replicated", "global"],
                    default="replicated")
    sp.add_argument("--replicas", type=int, default=None,
                    help="replica count (replicated mode only; default 1)")
    sp.add_argument("--env", action="append", default=[])
    sp.add_argument("--constraint", action="append", default=[])
    sp.add_argument("--mount", action="append", default=[],
                    help="type=bind|volume|tmpfs,source=...,target=...,"
                         "[readonly] (repeatable; reference swarmctl "
                         "--bind/--volume/--tmpfs folded into one flag)")
    sp.add_argument("--label", action="append", default=[],
                    metavar="KEY=VALUE", help="service label (repeatable)")
    sp.add_argument("--hostname", default=None,
                    help="container hostname (templated, e.g. "
                         "{{.Service.Name}}-{{.Task.Slot}})")
    sp.add_argument("--command", action="append", default=[],
                    help="override entrypoint (repeatable)")
    sp.add_argument("--arg", action="append", default=[],
                    help="container arg (repeatable)")
    sp.add_argument("--restart-window", type=float, default=None,
                    help="seconds over which restart attempts are counted")
    sp.add_argument("--generic-resource", action="append", default=[],
                    metavar="KIND=N",
                    help="generic resource reservation, e.g. tpu-chip=2")
    sp.add_argument("--limit-cpu", type=float, default=None,
                    help="CPU cores limit per task")
    sp.add_argument("--limit-memory", type=int, default=None,
                    help="bytes of memory limit per task")
    sp.add_argument("--log-driver", default=None)
    sp.add_argument("--log-opt", action="append", default=[],
                    metavar="KEY=VALUE")
    sp.add_argument("--publish", action="append", default=[],
                    help="published:target port, e.g. 8080:80")
    sp.add_argument("--network", action="append", default=[],
                    help="attach to network (name or id; repeatable)")
    sp.add_argument("--secret", action="append", default=[],
                    help="expose secret to the task (name; repeatable)")
    sp.add_argument("--config", action="append", default=[],
                    help="expose config to the task (name; repeatable)")
    sp.add_argument("--reserve-cpu", type=float, default=None,
                    help="CPUs to reserve per task (cores, e.g. 0.5)")
    sp.add_argument("--reserve-memory", type=int, default=None,
                    help="bytes of memory to reserve per task")
    sp.add_argument("--restart-condition", default=None,
                    choices=["any", "failure", "none"])
    sp.add_argument("--restart-delay", type=float, default=None,
                    help="seconds between restarts")
    sp.add_argument("--restart-max-attempts", type=int, default=None)
    sub.add_parser("service-ls")
    for name in ("service-inspect", "service-rm"):
        sub.add_parser(name).add_argument("id")
    sp = sub.add_parser("service-scale")
    sp.add_argument("id")
    sp.add_argument("replicas", type=int)

    sp = sub.add_parser("task-ls")
    sp.add_argument("--service", default=None)
    sub.add_parser("task-inspect").add_argument("id")

    sp = sub.add_parser("service-update")
    sp.add_argument("id")
    sp.add_argument("--image", default=None)
    sp.add_argument("--replicas", type=int, default=None)
    sp.add_argument("--env", action="append", default=None,
                    help="replace the env list (repeatable)")
    sp.add_argument("--command", action="append", default=None,
                    help="replace the entrypoint (repeatable)")
    sp.add_argument("--arg", action="append", default=None,
                    help="replace the args list (repeatable)")
    sp.add_argument("--hostname", default=None)
    sp.add_argument("--mount", action="append", default=None,
                    help="replace the mount list (repeatable; same syntax "
                         "as service-create)")
    sp.add_argument("--label-add", action="append", default=[],
                    metavar="KEY=VALUE")
    sp.add_argument("--label-rm", action="append", default=[],
                    metavar="KEY")
    sp.add_argument("--restart-condition", default=None,
                    choices=["any", "failure", "none"])
    sp.add_argument("--restart-delay", type=float, default=None)
    sp.add_argument("--restart-max-attempts", type=int, default=None)
    sp.add_argument("--restart-window", type=float, default=None)
    sp.add_argument("--force", action="store_true",
                    help="bump force_update to replace tasks even with an "
                         "unchanged spec")
    sp.add_argument("--update-parallelism", type=int, default=None)
    sp.add_argument("--update-delay", type=float, default=None)
    sp.add_argument("--update-order", default=None,
                    choices=["stop-first", "start-first"])
    sp.add_argument("--update-failure-action", default=None,
                    choices=["pause", "continue", "rollback"])
    sp.add_argument("--update-monitor", type=float, default=None)
    sp.add_argument("--update-max-failure-ratio", type=float, default=None)
    sp.add_argument("--rollback-parallelism", type=int, default=None)
    sp.add_argument("--rollback-order", default=None,
                    choices=["stop-first", "start-first"])
    sub.add_parser("service-rollback").add_argument("id")

    sp = sub.add_parser("service-logs")
    sp.add_argument("id", help="service id (or task id with --task)")
    sp.add_argument("--task", action="store_true",
                    help="treat id as a task id")
    sp.add_argument("--follow", "-f", action="store_true")
    sp.add_argument("--tail", type=int, default=-1,
                    help="last N buffered lines per task (-1 = all)")

    sp = sub.add_parser("network-create")
    sp.add_argument("--name", required=True)
    sp.add_argument("--driver", default=None,
                    help="network driver name (scheduler plugin-filters "
                         "driver-named networks)")
    sp.add_argument("--subnet", action="append", default=[],
                    help="CIDR pool (repeatable; default: auto 10.x.0.0/24)")
    sub.add_parser("network-ls")
    sub.add_parser("network-inspect").add_argument("id")
    sub.add_parser("network-rm").add_argument("id")

    for kind in ("secret", "config"):
        sp = sub.add_parser(f"{kind}-create")
        sp.add_argument("name")
        sp.add_argument("--data", required=True)
        sub.add_parser(f"{kind}-ls")
        sub.add_parser(f"{kind}-inspect").add_argument("id")
        sub.add_parser(f"{kind}-rm").add_argument("id")
    return p


def _parse_mount(text: str) -> dict:
    """type=bind,source=/x,target=/y[,readonly] -> Mount dict."""
    m: dict = {"type": "bind", "read_only": False}
    for part in text.split(","):
        if part == "readonly" or part == "ro":
            m["read_only"] = True
        elif "=" in part:
            k, _, v = part.partition("=")
            if k not in ("type", "source", "target"):
                raise CtlError(f"unknown mount option {k!r}", "invalid")
            m[k] = v
        elif part:
            raise CtlError(f"bad mount option {part!r}", "invalid")
    return m


_RESTART_CONDITIONS = {"none": 0, "failure": 1, "any": 2}


def _restart_flags(args) -> Optional[dict]:
    """RestartPolicy fields present on `args`, or None if none given
    (shared by service-create and service-update)."""
    if args.restart_condition is None and args.restart_delay is None \
            and args.restart_max_attempts is None \
            and args.restart_window is None:
        return None
    restart: dict = {}
    if args.restart_condition is not None:
        restart["condition"] = _RESTART_CONDITIONS[args.restart_condition]
    if args.restart_delay is not None:
        restart["delay"] = args.restart_delay
    if args.restart_max_attempts is not None:
        restart["max_attempts"] = args.restart_max_attempts
    if args.restart_window is not None:
        restart["window"] = args.restart_window
    return restart


def _kv_pairs(items: list[str], what: str) -> dict:
    out = {}
    for kv in items:
        if "=" not in kv:
            raise CtlError(f"{what} wants KEY=VALUE, got {kv!r}", "invalid")
        k, _, v = kv.partition("=")
        out[k] = v
    return out


def _service_spec(args, networks=None, secrets=None, configs=None) -> dict:
    container = {"image": args.image, "env": args.env}
    if args.mount:
        container["mounts"] = [_parse_mount(s) for s in args.mount]
    if args.hostname:
        container["hostname"] = args.hostname
    if args.command:
        container["command"] = list(args.command)
    if args.arg:
        container["args"] = list(args.arg)
    if secrets:
        container["secrets"] = [
            {"secret_id": sid, "secret_name": name}
            for sid, name in secrets]
    if configs:
        container["configs"] = [
            {"config_id": cid, "config_name": name}
            for cid, name in configs]
    task = {"container": container,
            "placement": {"constraints": args.constraint}}
    if networks:
        task["networks"] = list(networks)
    resources: dict = {}
    generic = {}
    for k, v in _kv_pairs(args.generic_resource,
                          "--generic-resource").items():
        try:
            generic[k] = int(v)
        except ValueError:
            raise CtlError(
                f"--generic-resource wants KIND=N, got {k}={v!r}",
                "invalid")
        if generic[k] < 0:
            raise CtlError(
                f"--generic-resource {k} must be non-negative", "invalid")
    if args.reserve_cpu is not None or args.reserve_memory is not None \
            or generic:
        resources["reservations"] = {
            "nano_cpus": int((args.reserve_cpu or 0) * 1e9),
            "memory_bytes": args.reserve_memory or 0,
            "generic": generic}
    if args.limit_cpu is not None or args.limit_memory is not None:
        resources["limits"] = {
            "nano_cpus": int((args.limit_cpu or 0) * 1e9),
            "memory_bytes": args.limit_memory or 0}
    if resources:
        task["resources"] = resources
    restart = _restart_flags(args)
    if restart is not None:
        task["restart"] = restart
    if args.log_opt and not args.log_driver:
        raise CtlError("--log-opt requires --log-driver", "invalid")
    if args.log_driver:
        task["log_driver"] = {
            "name": args.log_driver,
            "options": _kv_pairs(args.log_opt, "--log-opt")}
    spec = {
        "annotations": {"name": args.name,
                        "labels": _kv_pairs(args.label, "--label")},
        "task": task,
    }
    if getattr(args, "mode", "replicated") == "global":
        from swarmkit_tpu_torch.api.specs import Mode
        spec["mode"] = int(Mode.GLOBAL)
        spec["global_"] = {}
    else:
        spec["replicated"] = {"replicas": 1 if args.replicas is None
                              else args.replicas}
    if args.publish:
        ports = []
        for spec_str in args.publish:
            pub, _, tgt = spec_str.partition(":")
            ports.append({"protocol": "tcp", "published_port": int(pub),
                          "target_port": int(tgt or pub),
                          "publish_mode": "ingress"})
        spec["endpoint"] = {"ports": ports}
    return spec


async def _resolve(client, kind: str, names: list[str]) -> list:
    """Resolve refs (name | id | unique id prefix) to (id, name) pairs.

    The <kind>.ls scan is fetched at most once per call no matter how many
    refs miss the direct-Get fast path."""
    out, objs = [], None
    for ref in names:
        try:
            obj = await client.call(f"{kind}.inspect", id=ref)
        except CtlError as e:
            if e.code != "not_found":
                raise
            if objs is None:
                objs = await client.call(f"{kind}.ls")
            obj = _match_ref(kind, objs, ref)
        out.append((obj["id"], _display_name(kind, obj)))
    return out


def _display_name(kind: str, obj: dict) -> str:
    if kind == "node":
        # nodes are addressed by hostname (reference cmd/swarmctl/node/
        # util.go getNode: ID first, then hostname scan)
        return (obj.get("description") or {}).get("hostname") or ""
    return (((obj.get("spec") or {}).get("annotations") or {})
            .get("name") or "")


async def _resolve_obj(client, kind: str, ref: str) -> dict:
    """Exact id, name (hostname for nodes), or unique id prefix -> object.

    Every positional object argument accepts any of the three, the way the
    reference CLI does (cmd/swarmctl/service/util.go getService,
    node/util.go getNode, network/util.go, secret/config util) — ambiguity
    and absence are CLI errors, never a silent no-match.  Like the
    reference, the direct Get is tried first; the <kind>.ls scan only runs
    when the ref is not an exact id.  Returns the fetched object so
    callers never pay a second inspect for it.
    """
    try:
        return await client.call(f"{kind}.inspect", id=ref)
    except CtlError as e:
        if e.code != "not_found":
            raise
    return _match_ref(kind, await client.call(f"{kind}.ls"), ref)


def _match_ref(kind: str, objs: list, ref: str) -> dict:
    """Scan a <kind>.ls result for a name or unique-id-prefix match."""
    by_name: dict[str, list[dict]] = {}
    for o in objs:
        nm = _display_name(kind, o)
        if nm:
            by_name.setdefault(nm, []).append(o)
    if ref in by_name:
        matches = by_name[ref]
        if len(matches) > 1:
            raise CtlError(f"{kind} name {ref!r} is ambiguous "
                           f"({len(matches)} matches)", "ambiguous")
        return matches[0]
    pref = [o for o in objs if o["id"].startswith(ref)] if ref else []
    if len(pref) == 1:
        return pref[0]
    if len(pref) > 1:
        raise CtlError(f"{kind} id prefix {ref!r} is ambiguous "
                       f"({len(pref)} matches)", "ambiguous")
    raise CtlError(f"{kind} {ref!r} not found", "not_found")


async def _resolve_ref(client, kind: str, ref: str) -> str:
    return (await _resolve_obj(client, kind, ref))["id"]


async def run(args, out=None) -> int:
    out = out or sys.stdout
    client = ControlSocketClient(args.socket)

    def show(obj):
        json.dump(obj, out, indent=2, default=str)
        out.write("\n")

    try:
        c = args.cmd
        # Normalize the positional object ref (name | id | unique id
        # prefix) for every `<kind>-<verb>` command that takes one.
        kind = c.split("-")[0]
        resolved = None   # the fetched object; saves handlers a re-inspect
        if getattr(args, "id", None) is not None and kind in (
                "service", "node", "network", "secret", "config", "task"):
            if c == "service-logs" and args.task:
                kind = "task"
            resolved = await _resolve_obj(client, kind, args.id)
            args.id = resolved["id"]
        if c == "task-ls" and args.service:
            args.service = await _resolve_ref(client, "service",
                                              args.service)
        if c == "cluster-inspect":
            show(await client.call("cluster.inspect"))
        elif c == "metrics":
            show(await client.call("cluster.metrics"))
        elif c == "cluster-tokens":
            show(await client.call("cluster.unlock-key"))
        elif c == "cluster-update":
            p2: dict = {}
            if args.task_history is not None:
                p2["task_history"] = args.task_history
            if args.heartbeat_period is not None:
                p2["heartbeat_period"] = args.heartbeat_period
            if args.cert_expiry is not None:
                p2["cert_expiry"] = args.cert_expiry
            if args.rotate_worker_token:
                p2["rotate_worker_token"] = True
            if args.rotate_manager_token:
                p2["rotate_manager_token"] = True
            show(await client.call("cluster.update", **p2))
        elif c == "cluster-rotate-ca":
            show(await client.call("cluster.rotate-ca"))
        elif c == "cluster-autolock":
            show(await client.call("cluster.autolock",
                                   enabled=args.enabled == "on"))
        elif c == "cluster-unlock-key":
            method = ("cluster.rotate-unlock-key" if args.rotate
                      else "cluster.get-unlock-key")
            show(await client.call(method))
        elif c == "node-ls":
            for n in await client.call("node.ls"):
                role = "manager" if n.get("role") else "worker"
                state = {0: "unknown", 1: "down", 2: "ready",
                         3: "disconnected"}.get(
                    n.get("status", {}).get("state", 0), "?")
                out.write(f"{n['id']}\t{role}\t{state}\n")
        elif c == "node-inspect":
            show(resolved)
        elif c == "node-rm":
            await client.call("node.rm", id=args.id, force=args.force)
        elif c == "node-promote":
            await client.call("node.promote", id=args.id)
        elif c == "node-demote":
            await client.call("node.demote", id=args.id)
        elif c == "node-update":
            p: dict = {"id": args.id}
            if args.availability is not None:
                from swarmkit_tpu_torch.api.types import NodeAvailability
                p["availability"] = int(
                    NodeAvailability[args.availability.upper()])
            if args.label_add:
                p["labels_add"] = _kv_pairs(args.label_add, "--label-add")
            if args.label_rm:
                p["labels_rm"] = list(args.label_rm)
            show(await client.call("node.update", **p))
        elif c == "service-create":
            if args.mode == "global" and args.replicas is not None:
                print("error: --replicas conflicts with --mode global "
                      "(global services run one task per node)",
                      file=sys.stderr)
                return 1
            networks = [nid for nid, _ in
                        await _resolve(client, "network", args.network)]
            secrets = await _resolve(client, "secret", args.secret)
            configs = await _resolve(client, "config", args.config)
            show(await client.call("service.create",
                                   spec=_service_spec(args, networks,
                                                      secrets, configs)))
        elif c == "service-ls":
            for s in await client.call("service.ls"):
                name = s["spec"]["annotations"]["name"]
                replicas = s["spec"].get("replicated", {}).get("replicas", "")
                out.write(f"{s['id']}\t{name}\t{replicas}\n")
        elif c == "service-inspect":
            show(resolved)
        elif c == "service-scale":
            svc = resolved
            if not svc["spec"].get("replicated"):
                print("error: only replicated services can be scaled",
                      file=sys.stderr)
                return 1
            svc["spec"]["replicated"]["replicas"] = args.replicas
            show(await client.call(
                "service.update", id=args.id, spec=svc["spec"],
                version=svc["meta"]["version"]["index"]))
        elif c == "service-rm":
            await client.call("service.rm", id=args.id)
        elif c == "service-update":
            cur = resolved
            spec = cur["spec"]
            # only materialize task/container sub-objects when a container
            # flag was actually given — an unrelated update must not
            # mutate a container-less service spec
            cont_flags = {"image": args.image, "env": args.env,
                          "command": args.command, "args": args.arg,
                          "hostname": args.hostname}
            if any(v is not None for v in cont_flags.values()) \
                    or args.mount is not None:
                cont = spec.setdefault("task", {}).setdefault(
                    "container", {})
                for key, v in cont_flags.items():
                    if v is not None:
                        cont[key] = list(v) if isinstance(v, list) else v
                if args.mount is not None:
                    cont["mounts"] = [_parse_mount(s) for s in args.mount]
            if args.label_add or args.label_rm:
                labels = spec.setdefault("annotations", {}).setdefault(
                    "labels", {})
                labels.update(_kv_pairs(args.label_add, "--label-add"))
                for k in args.label_rm:
                    labels.pop(k, None)
            rflags = _restart_flags(args)
            if rflags is not None:
                spec.setdefault("task", {}).setdefault(
                    "restart", {}).update(rflags)
            if args.replicas is not None and spec.get("replicated"):
                spec["replicated"]["replicas"] = args.replicas
            if args.force:
                task_spec = spec.setdefault("task", {})
                task_spec["force_update"] = \
                    int(task_spec.get("force_update", 0)) + 1
            upd = spec.get("update") or {}
            for flag, key in (("update_parallelism", "parallelism"),
                              ("update_delay", "delay"),
                              ("update_monitor", "monitor"),
                              ("update_max_failure_ratio",
                               "max_failure_ratio")):
                v = getattr(args, flag)
                if v is not None:
                    upd[key] = v
            if args.update_order is not None:
                upd["order"] = {"stop-first": 0,
                                "start-first": 1}[args.update_order]
            if args.update_failure_action is not None:
                upd["failure_action"] = {
                    "pause": 0, "continue": 1,
                    "rollback": 2}[args.update_failure_action]
            if upd:
                spec["update"] = upd
            rb = spec.get("rollback") or {}
            if args.rollback_parallelism is not None:
                rb["parallelism"] = args.rollback_parallelism
            if args.rollback_order is not None:
                rb["order"] = {"stop-first": 0,
                               "start-first": 1}[args.rollback_order]
            if rb:
                spec["rollback"] = rb
            show(await client.call(
                "service.update", id=args.id, spec=spec,
                version=cur["meta"]["version"]["index"]))
        elif c == "service-rollback":
            show(await client.call("service.rollback", id=args.id))
        elif c == "service-logs":
            sel = ({"task_ids": [args.id]} if args.task
                   else {"service_ids": [args.id]})
            async for m in client.stream("logs.subscribe", follow=args.follow,
                                         tail=args.tail, **sel):
                tag = "ERR" if m["stream"] == 2 else "OUT"
                out.write(f"{m['task_id'][:12]}@{m['node_id'][:12]} "
                          f"{tag} | {m['data']}\n")
        elif c == "task-inspect":
            show(resolved)
        elif c == "task-ls":
            ids = [args.service] if args.service else None
            for t in await client.call("task.ls", service_ids=ids):
                state = TaskState(t.get("status", {}).get("state", 0)).name
                out.write(f"{t['id']}\t{t.get('node_id','')}\t{state}\n")
        elif c == "network-create":
            nspec: dict = {"annotations": {"name": args.name}}
            if args.driver:
                nspec["driver_config"] = {"name": args.driver}
            if args.subnet:
                nspec["ipam"] = {"configs": [{"subnet": sn}
                                             for sn in args.subnet]}
            show(await client.call("network.create", spec=nspec))
        elif c == "network-inspect":
            show(resolved)
        elif c == "network-ls":
            for n in await client.call("network.ls"):
                out.write(f"{n['id']}\t{n['spec']['annotations']['name']}\n")
        elif c == "network-rm":
            await client.call("network.rm", id=args.id)
        elif c.endswith("-create") and c.split("-")[0] in ("secret",
                                                          "config"):
            kind = c.split("-")[0]
            import base64

            show(await client.call(
                f"{kind}.create",
                spec={"annotations": {"name": args.name},
                      "data": {"__b64__": base64.b64encode(
                          args.data.encode()).decode()}}))
        elif c in ("secret-inspect", "config-inspect"):
            show(resolved)
        elif c in ("secret-ls", "config-ls"):
            kind = c.split("-")[0]
            for s in await client.call(f"{kind}.ls"):
                out.write(f"{s['id']}\t{s['spec']['annotations']['name']}\n")
        elif c in ("secret-rm", "config-rm"):
            await client.call(f"{c.split('-')[0]}.rm", id=args.id)
        else:
            out.write(f"unknown command {c}\n")
            return 2
        return 0
    except CtlError as e:
        print(f"error ({e.code}): {e}", file=sys.stderr)
        return 1
    finally:
        await client.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return asyncio.run(run(args))
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) went away — normal CLI etiquette
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
