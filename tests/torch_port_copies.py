"""The JAX package's own test modules, run on the PyTorch port.

``port_copy("test_ca")`` loads tests/test_ca.py with every name of the JAX
package (``swarmkit_tpu``) turned into the port's (``swarmkit_tpu_torch``),
and the harness modules it imports (tests/integration_harness.py and its
kind, tests/test_device_transport.py's ``DeviceRaftHarness``) likewise, so
each JAX case runs unchanged on the port and meets the JAX test's own
checks.  The root ``tools.fault_sweep`` becomes the port's
``swarmkit_tpu_torch.tools.fault_sweep``; only a copy's ``free_port`` is
this module's (a port outside the kernel's ephemeral range, with the two
after it free).  ``on_cpu(monkeypatch)`` makes the port's entry points
default to the CPU where a JAX case calls them without a device (the port
raises without a card; these tests run on the CPU).  ``params(mod)`` and
``run_case(mod, case, request)`` run every case of a copy, test classes'
methods included, as parametrised cases that keep the JAX case's own marks
and get the fixtures it asks for.
"""

from __future__ import annotations

import inspect
import pathlib
import random
import re
import socket
import sys
import types

TESTS = pathlib.Path(__file__).resolve().parent
HARNESSES = ("integration_harness", "node_harness", "raft_harness",
             "test_device_transport")
# root tools/ modules a JAX test imports, and the port's counterpart of each
TOOLS = {"tools.fault_sweep": "swarmkit_tpu_torch.tools.fault_sweep"}


def free_port() -> int:
    """A free port p below the kernel's ephemeral range (32768-60999 by
    default) with p + 1 and p + 2 free too: swarmd binds all three (the
    root-CA bootstrap and the TLS join port), and a listener outside the
    range never takes a port another test's bind(0) was handed."""
    rng = random.Random()
    while True:
        p = rng.randrange(20000, 32000)
        try:
            for q in (p, p + 1, p + 2):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", q))
        except OSError:
            continue
        return p


def _port_source(text: str) -> str:
    text = re.sub(r"\bswarmkit_tpu\b", "swarmkit_tpu_torch", text)
    for h in HARNESSES:
        text = text.replace(f"tests.{h}", f"tests._port_{h}")
    for tool, port in TOOLS.items():
        text = re.sub(rf"(?<![\w.]){re.escape(tool)}\b", port, text)
    return text


def port_copy(name: str) -> types.ModuleType:
    """tests/<name>.py on the port, loaded once a process as the module
    ``tests._port_<name>``."""
    key = f"tests._port_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = TESTS / f"{name}.py"
    text = path.read_text()
    for h in HARNESSES:
        if f"tests.{h}" in text:
            port_copy(h)
    mod = types.ModuleType(key)
    mod.__file__ = str(path)
    sys.modules[key] = mod
    try:
        exec(compile(_port_source(text), str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[key]
        raise
    if "free_port" in mod.__dict__:
        mod.free_port = free_port
    return mod


def cases(mod: types.ModuleType) -> list[str]:
    """The names of the module's test functions, in file order, then
    ``Class.method`` for each test method of its ``Test*`` classes."""
    out = [n for n, v in vars(mod).items()
           if n.startswith("test_") and callable(v)]
    for cname, cls in vars(mod).items():
        if cname.startswith("Test") and inspect.isclass(cls) \
                and cls.__module__ == mod.__name__:
            out += [f"{cname}.{m}" for m, v in vars(cls).items()
                    if m.startswith("test_") and callable(v)]
    return out


def _case_fn(mod: types.ModuleType, case: str):
    if "." not in case:
        return getattr(mod, case)
    cname, meth = case.split(".")
    return getattr(mod, cname).__dict__[meth]


def params(mod: types.ModuleType) -> list:
    """``cases(mod)`` as ``pytest.param``s, each id naming the JAX file
    and the case and carrying the case's own marks (its skip stays)."""
    import pytest

    file = pathlib.Path(mod.__file__).stem
    return [pytest.param(mod, c, id=f"{file}::{c}",
                         marks=getattr(_case_fn(mod, c), "pytestmark", []))
            for c in cases(mod)]


def run_case(mod: types.ModuleType, case: str, request) -> None:
    """Run one case of a copy: a method on a fresh instance of its class,
    with each pytest fixture its signature names."""
    fn = _case_fn(mod, case)
    args = []
    if "." in case:
        args.append(getattr(mod, case.split(".")[0])())
    kwargs = {n: request.getfixturevalue(n)
              for n in inspect.signature(fn).parameters if n != "self"}
    fn(*args, **kwargs)


def on_cpu(monkeypatch) -> None:
    """Every port module's ``resolve_device`` defaults to the CPU for the
    rest of the test (the entry points the JAX cases reach are loaded
    first, so a later import inside a case finds the patched name)."""
    import importlib

    from swarmkit_tpu_torch import device

    for name in ("manager.manager", "manager.scheduler.kernel",
                 "agent.tpu", "transport.device_mesh", "cmd.swarm_bench"):
        importlib.import_module(f"swarmkit_tpu_torch.{name}")
    orig = device.resolve_device

    def cpu_default(dev=None):
        return orig("cpu" if dev is None else dev)

    for name, mod in list(sys.modules.items()):
        if name.startswith("swarmkit_tpu_torch") and \
                getattr(mod, "resolve_device", None) is orig:
            monkeypatch.setattr(mod, "resolve_device", cpu_default)
