"""tools/verify_controlplane.py's flow on the port: a swarmd manager and
swarmctl over its control socket drive a service with a published port
(8080 -> 80 on the ingress space) to RUNNING, tail its logs, roll it to a
new image with the update flags (parallelism 1, start-first, monitor
0.2 s) and roll it back.  The JAX package's own cases of these verbs run
on the port in tests/test_torch_cli.py (service-logs follow and tail,
service-update and rollback) and the allocator's port spaces in
tests/test_torch_allocator.py."""

from __future__ import annotations

import asyncio
import io
import json
import tempfile

from tests.test_torch_cli import ROOTS, _daemon, _m, _stop
from tests.torch_port_copies import on_cpu


async def _flow() -> list:
    ctl_cmd = _m(ROOTS["port"], "cmd.swarmctl")
    seen = []
    with tempfile.TemporaryDirectory(prefix="verify-cp-") as tmp:
        node, sock = await _daemon(ROOTS["port"], tmp)

        async def ctl(*argv):
            out = io.StringIO()
            rc = await ctl_cmd.run(ctl_cmd.build_parser().parse_args(
                ["--socket", sock, *argv]), out=out)
            return rc, out.getvalue()

        try:
            rc, out = await ctl("service-create", "--name", "app",
                                "--image", "v1", "--replicas", "2",
                                "--publish", "8080:80")
            assert rc == 0, out
            svc = json.loads(out)["id"]
            for _ in range(200):
                rc, out = await ctl("task-ls", "--service", svc)
                if out.count("RUNNING") == 2:
                    break
                await asyncio.sleep(0.05)
            assert out.count("RUNNING") == 2, out
            rc, out = await ctl("service-inspect", svc)
            port = json.loads(out)["endpoint"]["ports"][0]
            assert (port["published_port"], port["target_port"]) == \
                (8080, 80)
            seen.append("published")

            for c in node.config.executor.controllers.values():
                if c.task.service_id == svc:
                    c.write_log("app line")
            rc, out = await ctl("service-logs", svc, "--tail", "10")
            assert rc == 0 and "app line" in out and "started" in out
            seen.append("logs")

            rc, out = await ctl("service-update", svc, "--image", "v2",
                                "--update-parallelism", "1",
                                "--update-order", "start-first",
                                "--update-monitor", "0.2")
            assert rc == 0, out
            spec = json.loads(out)["spec"]
            assert spec["update"]["parallelism"] == 1
            st = {}
            for _ in range(300):
                rc, out = await ctl("service-inspect", svc)
                st = json.loads(out).get("update_status") or {}
                if st.get("state") == "completed":
                    break
                await asyncio.sleep(0.05)
            assert st.get("state") == "completed", st
            seen.append("updated")

            rc, out = await ctl("service-rollback", svc)
            assert rc == 0
            assert json.loads(out)["spec"]["task"]["container"][
                "image"] == "v1"
            seen.append("rolled back")
        finally:
            await _stop(node)
    return seen


def test_verify_controlplane_flow_on_port(monkeypatch):
    on_cpu(monkeypatch)
    assert asyncio.run(_flow()) == ["published", "logs", "updated",
                                    "rolled back"]
