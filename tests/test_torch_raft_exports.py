"""The port's raft package root exports what the JAX package's does.

Each of the JAX package's sixteen names imports from
``swarmkit_tpu_torch.raft`` and is the port module's own object; the two
``__all__`` lists are equal.  The root stays light: a fresh interpreter
that imports it (or ``raft.sim``) loads neither the node shell, its WAL
nor a wire, and sets up no import cycle.
"""

from __future__ import annotations

import importlib
import pathlib
import subprocess
import sys

import pytest

import swarmkit_tpu.raft as jraft
import swarmkit_tpu_torch.raft as traft

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_all_equals_jax():
    assert traft.__all__ == jraft.__all__
    assert len(traft.__all__) == 16


@pytest.mark.parametrize("name", jraft.__all__)
def test_name_is_the_port_modules_own(name):
    obj = getattr(traft, name)
    mod = importlib.import_module(getattr(jraft, name).__module__.replace(
        "swarmkit_tpu.", "swarmkit_tpu_torch.", 1))
    assert obj is getattr(mod, name)
    assert obj.__module__.startswith("swarmkit_tpu_torch.raft.")


@pytest.mark.parametrize("target", ["swarmkit_tpu_torch.raft",
                                    "swarmkit_tpu_torch.raft.sim"])
def test_root_stays_light(target):
    code = (f"import sys, {target}\n"
            "from swarmkit_tpu_torch.raft import Config, RawNode, Ready\n"
            "heavy = [m for m in ('node', 'storage', 'transport',\n"
            "         'grpc_transport')\n"
            "         if f'swarmkit_tpu_torch.raft.{m}' in sys.modules]\n"
            "print(heavy, 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "False"]
