"""Task executor of the port: tasks are PyTorch programs run on the CUDA
card.

The framework's analog of the reference's Docker executor
(agent/exec/dockerapi/controller.go: Prepare pulls the image and creates
the container, Start runs it, Wait blocks on exit).  Prepare resolves the
named program, allocates its operands on the device and builds the CUDA
kernels it launches, so a bad parameter, an nvcc failure or a loader
failure fails the task at PREPARING, like a bad image pull.  Start launches
the program on a worker thread and records a CUDA event after it; Wait
completes when the event has fired and the result is on the host.
Shutdown/Terminate cancel the host-side wait (a launched kernel is not
preemptible).

The image scheme stays ``tpu://`` and the classes keep their names
(`TpuExecutor`, `TpuController`): the scheme is the user-facing API, so the
same ServiceSpec runs on the JAX package's executor or on this one.
Parameters come from ContainerSpec.args (``k=v``) and env (``K=V``)::

    ContainerSpec(image="tpu://pallas_matmul", args=["n=8192", "steps=16"])

A program's factory takes ``(params, device, operands=None)`` and returns
``(fn, args)``.  Seeded operands come from a CPU ``torch.Generator`` and
are then moved to the device, so one seed gives the same operands on the
CPU and on the card; they are not the JAX package's ``jax.random`` values.
``operands`` (a dict of tensors; `operands_from_numpy` makes one from
numpy arrays, bfloat16 included) replaces the seeded ones, so a task can
run on operands carried across from elsewhere.

``tpu://pmatmul`` shards its batch over the executor's list of local
devices (`TpuExecutor.devices`: every card of the machine, or the CPU),
one controller in one process as the JAX package's single-process SPMD
program is: the per-shard scalars are summed across the devices where JAX
calls ``psum``.  ``k=v`` lines of the secrets and configs a task
references, template-expanded per task, become program parameters; the
prepare log line names them and never shows their values.  There is no
fallback: without a card the executor needs ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from swarmkit_tpu_torch.agent.exec import (
    Controller, Executor, TaskError, TaskRejected,
)
from swarmkit_tpu_torch.agent.dependency import Dependencies
from swarmkit_tpu_torch.agent.logs import TaskLogBuffer
from swarmkit_tpu_torch.api.types import (
    EngineDescription, NodeDescription, NodeResources, Platform,
)
from swarmkit_tpu_torch.device import resolve_device
from swarmkit_tpu_torch.manager.logbroker import LogStream
from swarmkit_tpu_torch.parallel import (
    cuda_ops, local_devices, psum, shard_count,
)

SCHEME = "tpu://"
_LANE = 128   # with 256, the aligned default tiles of pallas_matmul

# name -> factory(params, device, operands=None) -> (fn, args); a sharded
# program's factory also takes devices=, the executor's local devices
PROGRAMS: dict[str, Callable] = {}
SHARDED: set[str] = set()


def register_program(name: str, factory: Callable,
                     sharded: bool = False) -> None:
    PROGRAMS[name] = factory
    if sharded:
        SHARDED.add(name)
    else:
        SHARDED.discard(name)


def operands_from_numpy(arrays: dict, device) -> dict[str, torch.Tensor]:
    """Tensors on `device` with the values of numpy arrays, keyed as given.
    bfloat16 arrays (ml_dtypes, as numpy holds JAX's bf16) go across
    through their uint16 bits: torch.from_numpy does not take them."""
    out = {}
    for name, arr in arrays.items():
        arr = np.array(arr, order="C")   # a writable copy, 0-d kept
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device)
    return out


def _operand(operands, name, shape, dtype, device, make):
    """operands[name] checked against shape and dtype and put on `device`,
    or `make()` when no operands were given."""
    if operands is None:
        return make()
    t = operands[name]
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"operand {name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.to(device)


def _seeded_normal(shape, seed: int, device) -> torch.Tensor:
    """A bf16 standard normal from a CPU generator, then moved."""
    g = torch.Generator("cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16).to(device)


def _square_operand(params, device, operands):
    """The chains' bf16 [n, n] operand `a`."""
    n = int(params.get("n", 256))
    seed = int(params.get("seed", 0))
    return _operand(operands, "a", (n, n), torch.bfloat16, device,
                    lambda: _seeded_normal((n, n), seed, device))


def _builtin_matmul(params: dict, device, operands=None):
    """bf16 matmul chain of plain products — keeps the tensor cores busy
    for `steps` iterations (the JAX package's XLA chain; its product is
    outside any Pallas kernel, so here it is torch.matmul)."""
    steps = int(params.get("steps", 4))
    a = _square_operand(params, device, operands)

    def fn(x):
        for _ in range(steps):
            y = torch.matmul(x, a)
            # renormalize so the chain neither explodes nor vanishes
            denom = torch.clamp_min(
                torch.sqrt(torch.mean(torch.square(y.float()))), 1e-6)
            x = y / denom.to(torch.bfloat16)
        return torch.sum(x.float())

    return fn, (a,)


def _builtin_axpy(params: dict, device, operands=None):
    n = int(params.get("n", 1 << 16))
    alpha = float(params.get("alpha", 2.0))
    x = _operand(operands, "x", (n,), torch.float32, device,
                 lambda: torch.arange(n, dtype=torch.float32, device=device))
    y = _operand(operands, "y", (n,), torch.float32, device,
                 lambda: x * 0.5)

    def fn(x, y):
        return torch.sum(alpha * x + y)

    return fn, (x, y)


# tpu://pmatmul's shard count is the meshes' divisor rule: the largest
# count <= len(devices) that divides the batch
pmatmul_shards = shard_count


def pmatmul_chain(xs: list, as_: list, steps: int) -> list:
    """The sharded chain: shard i holds xs[i] and its copy as_[i] of `a` on
    one device.  Each step is a local bf16 product, the mean square in
    f32 per shard, and the shards' sum of those, dividing by
    sqrt(total / d)."""
    d = len(xs)
    devices = [x.device for x in xs]
    for _ in range(steps):
        ys = [torch.matmul(x, a) for x, a in zip(xs, as_)]
        totals = psum([torch.mean(torch.square(y.float())) for y in ys],
                      devices)
        xs = [y / torch.clamp_min(torch.sqrt(t / d), 1e-6)
              .to(torch.bfloat16) for y, t in zip(ys, totals)]
    return xs


def _builtin_pmatmul(params: dict, device, operands=None, devices=None):
    """Sharded bf16 matmul chain over the local devices: the batch axis is
    split into d shards, one a device (`pmatmul_chain`), and the result
    is the shards' sum of their f32 sums.  The product is the JAX
    package's XLA ``carry @ a``, outside any Pallas kernel, so here it is
    torch.matmul.  `devices` defaults to [device]; a list may name one
    device more than once (the CPU's shards are slices on the one CPU
    device)."""
    n = int(params.get("n", 256))
    steps = int(params.get("steps", 4))
    batch = int(params.get("batch", 8))
    if n <= 0 or batch <= 0:
        raise TaskRejected(f"n={n} and batch={batch} must be positive")
    devices = list(devices or [device])
    d = shard_count(batch, devices)
    devices = devices[:d]
    a = _square_operand(params, devices[0], operands)
    x = _operand(operands, "x", (batch, n, n), torch.bfloat16, devices[0],
                 lambda: _seeded_normal((batch, n, n), 1, devices[0]))
    xs = [xi.to(dev) for xi, dev in zip(torch.chunk(x, d), devices)]
    as_ = [a.to(dev) for dev in devices]

    def fn(*xs):
        out = pmatmul_chain(list(xs), as_, steps)
        return psum([torch.sum(o.float()) for o in out], devices)[0]

    return fn, tuple(xs)


def _builtin_pallas_matmul(params: dict, device, operands=None):
    """Matmul chain through the hand-written kernels (cuda_ops.matmul and
    cuda_ops.sumsq): the port of the JAX package's Pallas chain."""
    n = int(params.get("n", 256))
    steps = int(params.get("steps", 4))
    if "tile" in params:
        tile = int(params["tile"])
        if tile <= 0:
            raise TaskRejected(f"tile={tile} must be positive")
    else:
        # the first aligned divisor of n, else one whole-array tile
        tile = next((t for t in (256, _LANE) if n % t == 0), n)
    if n <= 0 or n % tile:
        raise TaskRejected(f"n={n} must be positive and a multiple of "
                           f"tile={tile}")
    a = _square_operand(params, device, operands)
    if torch.device(device).type == "cuda":
        cuda_ops.load_kernels("matmul", "sumsq")

    def fn(x):
        out = cuda_ops.matmul_chain(x, a, steps, tile=tile)
        return torch.sum(out.float())

    return fn, (a,)


def _builtin_spin(params: dict, device, operands=None):
    """Fixed-length device loop — a long-running task for lifecycle tests
    (one scalar launch pair per iteration)."""
    iters = int(params.get("iters", 1000))
    x0 = _operand(operands, "x", (), torch.float32, device,
                  lambda: torch.tensor(1.0, device=device))

    def fn(x):
        for _ in range(iters):
            x = x * 1.000001 + 1e-7
        return x

    return fn, (x0,)


register_program("matmul", _builtin_matmul)
register_program("pallas_matmul", _builtin_pallas_matmul)
register_program("pmatmul", _builtin_pmatmul, sharded=True)
register_program("axpy", _builtin_axpy)
register_program("spin", _builtin_spin)


def parse_program(container) -> tuple[str, dict]:
    """(program name, params) from a ContainerSpec, or TaskRejected."""
    image = container.image or ""
    if not image.startswith(SCHEME):
        raise TaskRejected(
            f"image {image!r} is not a {SCHEME} program — this node runs "
            "the TPU executor")
    name = image[len(SCHEME):].strip("/")
    params: dict[str, str] = {}
    for kv in [*container.env, *container.args]:
        if "=" in kv:
            k, v = kv.split("=", 1)
            params[k.lower()] = v
    return name, params


def _on(device: torch.device):
    """Make `device` current for the calling thread (a no-op off CUDA)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class TpuController(Controller):
    """One task = one program on the executor's device (reference FSM:
    dockerapi/controller.go; Prepare/Start/Wait mapping in module doc).
    Lifecycle and result lines go to the executor's TaskLogBuffer."""

    def __init__(self, task, executor: "TpuExecutor",
                 operands: Optional[dict] = None) -> None:
        self.task = task
        self.executor = executor
        self.operands = operands
        self._fn = None
        self._args = None
        self._run_fut: Optional[asyncio.Future] = None
        self.result = None

    def _log(self, line: str, stream=LogStream.STDOUT) -> None:
        self.executor.logs.publish(
            self.task.id, stream, line.encode(),
            service_id=self.task.service_id, node_id=self.task.node_id,
            timestamp=time.time())

    async def update(self, task) -> None:
        self.task = task  # spec changes beyond desired-state are rejected
        # upstream by the orchestrator creating a replacement task

    def _dep_params(self) -> dict:
        """k=v lines from referenced secret/config payloads become program
        parameters (the runtime's analog of mounting secret files; payloads
        are template-expanded per task, template/getter.go)."""
        deps = self.executor.dependencies
        c = self.task.spec.container
        if deps is None or c is None or (not c.secrets and not c.configs):
            return {}
        view = deps.templated(self.task, self.executor._node)
        out: dict[str, str] = {}
        for ref, store in ([(r, view.secrets) for r in c.secrets]
                           + [(r, view.configs) for r in c.configs]):
            dep_id = getattr(ref, "secret_id", "") \
                or getattr(ref, "config_id", "")
            item = store.get(dep_id)
            if item is None:
                raise TaskError(f"missing dependency {dep_id!r}")
            for line in item.spec.data.decode("utf-8",
                                              "replace").splitlines():
                if "=" in line:
                    k, v = line.split("=", 1)
                    out[k.strip().lower()] = v.strip()
        return out

    async def prepare(self) -> None:
        name, params = parse_program(self.task.spec.container)
        public_params = dict(params)   # loggable: image args/env only
        dep = self._dep_params()
        params.update(dep)
        factory = PROGRAMS.get(name)
        if factory is None:
            raise TaskRejected(f"unknown TPU program {name!r} "
                               f"(have: {sorted(PROGRAMS)})")
        dev = self.executor.device
        kw = {"devices": self.executor.devices} if name in SHARDED else {}
        loop = asyncio.get_running_loop()

        def build():
            with _on(dev):
                fn, args = factory(params, dev, self.operands, **kw)
                for d in {dev, *kw.get("devices", ())}:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            return fn, args

        try:
            self._fn, self._args = await loop.run_in_executor(None, build)
            # dependency-sourced params are secret material: log their
            # names only, never values (they would be served cluster-wide
            # through `service logs`)
            shown = [f"{k}={v}" for k, v in public_params.items()]
            shown += [f"{k}=<from-dependency>" for k in dep]
            self._log(f"prepared tpu://{name} {' '.join(shown)} on {dev}")
        except TaskRejected:
            raise
        except Exception as e:
            self._log(f"preparation of {name!r} failed: {e}",
                      LogStream.STDERR)
            raise TaskError(f"preparation of {name!r} failed: {e}") from e

    async def start(self) -> None:
        if self._fn is None:
            raise TaskError("start before prepare")
        dev = self.executor.device
        loop = asyncio.get_running_loop()

        def run():
            with _on(dev):
                out = self._fn(*self._args)
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
            return out.item() if out.numel() == 1 else out.cpu()

        self._run_fut = loop.run_in_executor(None, run)
        self._log("started on device")

    async def wait(self) -> None:
        if self._run_fut is None:
            raise TaskError("wait before start")
        try:
            self.result = await asyncio.shield(self._run_fut)
            self._log(f"result: {self.result}")
            self._log("task complete")
        except asyncio.CancelledError:
            raise TaskError("task cancelled")
        except Exception as e:
            self._log(f"device execution failed: {e}", LogStream.STDERR)
            raise TaskError(f"device execution failed: {e}") from e

    async def shutdown(self) -> None:
        if self._run_fut is not None and not self._run_fut.done():
            self._run_fut.cancel()

    async def terminate(self) -> None:
        await self.shutdown()

    async def remove(self) -> None:
        self._fn = None
        self._args = None

    async def close(self) -> None:
        await self.remove()


class TpuExecutor(Executor):
    """Executor advertising its local devices; reference:
    dockerapi/executor.go Describe + Controller factory.

    `device` defaults to the current CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU.  Programs run on `device`;
    ``tpu://pmatmul`` shards over `devices`, which defaults to every card
    of the machine on CUDA and to the CPU alone on the CPU.  A list may
    name a device more than once, each entry one shard (the CPU's
    counterpart of XLA's virtual host devices).  The node advertises the
    distinct devices of `devices`: ``gpu-chip`` with each card's index
    (the key and shape the JAX package's executor emits on a GPU node),
    ``cpu-chip`` for the CPU.  `dependencies` (an
    agent.dependency.Dependencies, set by the agent's worker) serves the
    secrets and configs that tasks reference."""

    def __init__(self, hostname: str = "", device=None, devices=None) -> None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if devices is None:
            devices = local_devices(dev)
        self.hostname = hostname
        self.device = dev
        self.devices = [torch.device(d) for d in devices]
        self.dependencies: Optional[Dependencies] = None
        self._node = None
        self.logs = TaskLogBuffer()   # served via `service logs`

    async def describe(self) -> NodeDescription:
        platform = "gpu" if self.device.type == "cuda" else self.device.type
        key = f"{platform}-chip"
        ids = sorted({d.index or 0 for d in self.devices})
        return NodeDescription(
            hostname=self.hostname,
            platform=Platform(architecture=platform, os="torch"),
            engine=EngineDescription(engine_version=f"torch/{platform}",
                                     labels={"executor": "tpu"}),
            resources=NodeResources(
                generic={key: len(ids)},
                # named ids let the scheduler claim SPECIFIC chips per task
                generic_named={key: [str(i) for i in ids]}),
        )

    async def configure(self, node) -> None:
        self._node = node

    async def controller(self, task, operands: Optional[dict] = None
                         ) -> TpuController:
        return TpuController(task, self, operands)
