"""swarmd: the node daemon.

Reference: cmd/swarmd/main.go (flags at :255-273 — --state-dir,
--join-addr, --join-token, --listen-control-api, --hostname,
--heartbeat-tick, --election-tick, --manager).  Runs one
``swarmkit_tpu_torch.node.Node``; the control API is served on a unix
socket for swarmctl, the raft and cluster services on gRPC sockets
(--backend grpc, the default) or an in-process Network (--backend inproc).

The port's own copy of the JAX package's cmd/swarmd.py, plus ``--device``:
where the node's CUDA work runs (the manager's scheduler kernel,
``sched_place``, and the ``tpu`` executor's programs).  It defaults to the
CUDA card and raises without one; ``--device cpu`` runs both on the CPU::

    python -m swarmkit_tpu_torch.cmd.swarmd --manager \
        --state-dir /tmp/m1 --listen-remote-api 127.0.0.1:4242 \
        --listen-control-api /tmp/m1/swarmd.sock [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
from typing import Optional

from swarmkit_tpu_torch.agent.testutils import TestExecutor
from swarmkit_tpu_torch.cmd.ctl import ControlSocketServer
from swarmkit_tpu_torch.node import Node, NodeConfig
from swarmkit_tpu_torch.raft.transport import Network


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="swarmd", description="swarmkit-tpu node daemon")
    p.add_argument("--state-dir", default="./swarmkitstate",
                   help="state directory (reference default: "
                        "$HOME/.swarmkit)")
    p.add_argument("--hostname", default="",
                   help="override reported hostname")
    p.add_argument("--node-id", default="", help="node id (default: random)")
    p.add_argument("--join-addr", default="",
                   help="address of a manager to join")
    p.add_argument("--join-token", default="", help="cluster join token")
    p.add_argument("--advertise-remote-api", default="",
                   help="address peers should dial (defaults to "
                        "--listen-remote-api; set when binding a "
                        "wildcard or NAT-internal address)")
    p.add_argument("--listen-remote-api", default="0.0.0.0:4242",
                   help="listen address for raft/dispatcher traffic")
    p.add_argument("--listen-control-api", default="./swarmkitstate/swarmd.sock",
                   help="control API unix socket for swarmctl")
    p.add_argument("--manager", action="store_true",
                   help="start as a manager (bootstrap if no join-addr)")
    p.add_argument("--force-new-cluster", action="store_true")
    p.add_argument("--heartbeat-tick", type=int, default=1)
    p.add_argument("--election-tick", type=int, default=10)
    p.add_argument("--unlock-key", default="")
    p.add_argument("--autolock", action="store_true",
                   help="bootstrap the cluster with manager autolock "
                        "enabled (reference swarmd --autolock); the "
                        "unlock key prints once on stdout")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--listen-debug", default="",
                   help="serve the live diagnostic surface (asyncio task "
                        "dump, store wedge state, watch-queue depths, "
                        "metrics) on host:port or a unix socket path "
                        "(reference: swarmd --listen-debug pprof/expvar, "
                        "cmd/swarmd/main.go:183)")
    p.add_argument("--backend", choices=["grpc", "inproc"], default="grpc",
                   help="raft/cluster wire: real gRPC sockets (default) or "
                        "in-process (single-node/testing)")
    def _gnr(value: str) -> str:
        try:
            _parse_generic_resources(value)   # validate at CLI-parse time
        except ValueError as e:
            # argparse swallows ValueError's message ("invalid _gnr
            # value"); ArgumentTypeError's str() is shown to the operator
            raise argparse.ArgumentTypeError(str(e))
        return value

    p.add_argument("--generic-node-resources", default="", type=_gnr,
                   help="user-defined generic resources this node offers, "
                        "e.g. 'fpga=2,gpu=UUID1,gpu=UUID2' — integer "
                        "values are discrete counts, strings are named "
                        "ids; a kind is either discrete OR named "
                        "(reference: cmd/swarmd/main.go:267)")
    p.add_argument("--executor", choices=["tpu", "test"], default="tpu",
                   help="task runtime: PyTorch programs and their CUDA "
                        "kernels on the local card (tpu, default) or the "
                        "instant fake (test)")
    p.add_argument("--device", default=None,
                   help="where the scheduler's kernel and the tpu "
                        "executor run (default: the CUDA card; 'cpu' runs "
                        "their plain versions)")
    return p


def _parse_generic_resources(spec: str):
    """'fpga=2,gpu=UUID1,gpu=UUID2' -> (discrete counts, named id sets).

    A kind is EITHER discrete or named — mixing ('gpu=2,gpu=UUID1') or
    duplicate ids are rejected, like the reference's parser
    (cmd/swarmd/main.go:155-158 + api/genericresource validation):
    the scheduler sizes a named kind by its id set, so a mixed spec
    would advertise phantom capacity no task could ever claim."""
    counts: dict[str, int] = {}
    named: dict[str, list[str]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, value = part.partition("=")
        name, value = name.strip(), value.strip()
        if not eq or not name or not value:
            raise ValueError(
                f"--generic-node-resources wants name=value, got {part!r}")
        if any(ch.isspace() for ch in name) or \
                any(ch.isspace() for ch in value):
            raise ValueError(
                f"--generic-node-resources: whitespace inside "
                f"name or value: {part!r}")
        try:
            n = int(value)
        except ValueError:
            if name in counts:
                raise ValueError(
                    f"--generic-node-resources: kind {name!r} mixes a "
                    f"discrete count with named ids")
            ids = named.setdefault(name, [])
            if value in ids:
                raise ValueError(
                    f"--generic-node-resources: duplicate id "
                    f"{name}={value}")
            ids.append(value)
        else:
            if name in named:
                raise ValueError(
                    f"--generic-node-resources: kind {name!r} mixes a "
                    f"discrete count with named ids")
            if n <= 0:
                raise ValueError(
                    f"--generic-node-resources: discrete count must be "
                    f"positive, got {name}={n}")
            counts[name] = counts.get(name, 0) + n
    # named ids are ALSO countable (the scheduler counts, then claims ids)
    for name, ids in named.items():
        counts[name] = len(ids)
    return counts, named


class _GenericResourcesExecutor:
    """Executor wrapper merging operator-declared generic resources into
    the node description the agent registers with."""

    def __init__(self, inner, parsed) -> None:
        self._inner = inner
        self._counts, self._named = parsed

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def describe(self):
        desc = await self._inner.describe()
        if desc.resources is None:
            from swarmkit_tpu_torch.api.types import NodeResources
            desc.resources = NodeResources()
        for k, v in self._counts.items():
            if k in self._named:
                continue  # named kinds get their count from the id set
            if k in desc.resources.generic_named:
                # the executor already advertises this kind as NAMED ids
                # (e.g. tpu-chip): a flat count would be phantom capacity
                # the scheduler can never claim — drop it loudly
                logging.getLogger("swarmkit_tpu_torch.swarmd").warning(
                    "--generic-node-resources: ignoring discrete count "
                    "for %r — the executor advertises it as named ids", k)
                continue
            desc.resources.generic[k] = \
                desc.resources.generic.get(k, 0) + v
        for k, ids in self._named.items():
            if k in desc.resources.generic \
                    and k not in desc.resources.generic_named:
                # mirror of the discrete-over-named guard: the executor
                # advertises this kind as a DISCRETE count; operator ids
                # would overwrite real capacity with phantom claimable
                # ids no runtime backs — drop them loudly
                logging.getLogger("swarmkit_tpu_torch.swarmd").warning(
                    "--generic-node-resources: ignoring named ids for "
                    "%r — the executor advertises it as a discrete "
                    "count", k)
                continue
            have = desc.resources.generic_named.setdefault(k, [])
            have.extend(i for i in ids if i not in have)
            desc.resources.generic[k] = len(have)
        return desc


async def run(args, network=None, executor=None, registry=None) -> Node:
    """Build + start the node; returns it (caller owns shutdown).

    ``registry`` is the node directory the dialer resolves addresses
    against — share one dict (and one Network) across run() calls to host
    several joined nodes in one process.  Cross-process joins ride the gRPC
    transport once wired; a lone daemon resolves only itself.
    """
    from swarmkit_tpu_torch.utils.identity import new_id

    use_grpc = getattr(args, "backend", "inproc") == "grpc" \
        and network is None
    node_box: list = []
    if use_grpc:
        from swarmkit_tpu_torch.raft.grpc_transport import GrpcNetwork

        # late-bound security: the node's TLS identity is loaded during
        # node.start(), before the raft listener registers
        network = GrpcNetwork(
            security=lambda: node_box[0].security if node_box else None)
    network = network or Network()
    node_id = args.node_id or new_id()
    if executor is None:
        if getattr(args, "executor", "tpu") == "tpu":
            from swarmkit_tpu_torch.agent.tpu import TpuExecutor

            executor = TpuExecutor(hostname=args.hostname or node_id,
                                   device=getattr(args, "device", None))
        else:
            executor = TestExecutor(hostname=args.hostname or node_id)
    extra = getattr(args, "generic_node_resources", "")
    if extra:
        executor = _GenericResourcesExecutor(
            executor, _parse_generic_resources(extra))
    nodes = registry if registry is not None else {}
    remote_managers: dict[str, object] = {}

    def dialer(addr):
        for n in nodes.values():
            m = n._running_manager()
            if m is not None and m.addr == addr:
                return m
        if use_grpc and addr:
            from swarmkit_tpu_torch.rpc import RemoteManager

            rm = remote_managers.get(addr)
            if rm is None:
                expected_digest = ""
                if args.join_token:
                    from swarmkit_tpu_torch.ca.config import parse_join_token

                    expected_digest = parse_join_token(
                        args.join_token).ca_digest
                rm = RemoteManager(
                    addr,
                    security_ref=lambda: (node_box[0].security
                                          if node_box else None),
                    expected_ca_digest=expected_digest)
                rm.start()
                remote_managers[addr] = rm
            return rm
        return None

    advertise = getattr(args, "advertise_remote_api", "") \
        or args.listen_remote_api
    if use_grpc:
        # serve dispatcher/CA/control alongside raft on the same port
        # (reference: manager.go:526-548 service registrations); services
        # are keyed by the ADVERTISED address (the node's identity on the
        # wire) while the sockets bind the listen address
        from swarmkit_tpu_torch.rpc import ClusterService

        cluster_service = ClusterService(
            lambda: node_box[0] if node_box else None)
        if advertise != args.listen_remote_api:
            network.set_bind_addr(advertise, args.listen_remote_api)
        network.add_service(advertise, cluster_service.handlers())
        network.add_join_service(advertise, cluster_service.join_handlers())

    node = Node(NodeConfig(
        node_id=node_id,
        state_dir=args.state_dir,
        executor=executor,
        network=network,
        dialer=dialer,
        listen_addr=args.listen_remote_api,
        advertise_addr=getattr(args, "advertise_remote_api", ""),
        join_addr=args.join_addr,
        join_token=args.join_token,
        is_manager=args.manager,
        force_new_cluster=args.force_new_cluster,
        election_tick=args.election_tick,
        heartbeat_tick=args.heartbeat_tick,
        device=getattr(args, "device", None),
        unlock_key=args.unlock_key.encode() if args.unlock_key else None))
    node_box.append(node)
    nodes[node_id] = node
    await node.start()
    node._remote_managers = remote_managers

    if getattr(args, "autolock", False) and not (
            args.manager and not args.join_addr):
        logging.getLogger("swarmd").warning(
            "--autolock only applies to the bootstrap (seed) manager; "
            "use `swarmctl cluster-autolock on` on a running cluster")
    if getattr(args, "autolock", False) and args.manager \
            and not args.join_addr:
        # bootstrap-time autolock (reference swarmd --autolock): enable it
        # the moment this seed manager leads, and print the unlock key
        # once — the only time the operator can capture it
        async def _enable_autolock():
            # leadership comes first, the seeded cluster object a beat
            # later — retry the whole read-modify-write until both exist
            last_err: Optional[Exception] = None
            for _ in range(600):
                m = node._running_manager()
                if m is not None and node.is_leader():
                    try:
                        c = m.control_api
                        cl = c.get_cluster()
                        spec = cl.spec.copy()
                        spec.encryption_config.auto_lock_managers = True
                        await c.update_cluster(
                            cl.id, spec, version=cl.meta.version.index)
                        print(f"cluster autolock enabled; unlock key: "
                              f"{c.get_unlock_key()['unlock_key']}",
                              flush=True)
                        return
                    except Exception as e:
                        last_err = e   # not seeded yet / version race
                await asyncio.sleep(0.1)
            logging.getLogger("swarmd").error(
                "autolock bootstrap never completed (last error: %r)",
                last_err)

        t = asyncio.get_running_loop().create_task(_enable_autolock())
        node._autolock_bootstrap = t
        node._aux_tasks = getattr(node, "_aux_tasks", []) + [t]

    os.makedirs(os.path.dirname(args.listen_control_api) or ".",
                exist_ok=True)
    if os.path.exists(args.listen_control_api):
        os.unlink(args.listen_control_api)
    ctl = ControlSocketServer(node, args.listen_control_api)
    await ctl.start()
    node._ctl_server = ctl
    node._debug_server = None
    if args.listen_debug:
        from swarmkit_tpu_torch.node.debug import DebugServer
        dbg = DebugServer(node)
        await dbg.start(args.listen_debug)
        node._debug_server = dbg
    return node


async def main_async(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(name)s %(message)s")
    node = await run(args)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if getattr(node, "_debug_server", None) is not None:
        await node._debug_server.stop()
    await node._ctl_server.stop()
    await node.stop()


def main(argv=None) -> None:
    asyncio.run(main_async(argv))


if __name__ == "__main__":
    main()
