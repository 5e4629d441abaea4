"""Nothing under benchmark/ imports JAX or the JAX package, comparing
each imported module's top-level name whole (the port's own name,
swarmkit_tpu_torch, begins with the JAX package's), and a run's process
holds none of them."""

import ast
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "swarmkit_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    seen = set()
    for f in files:
        names = set(_imports(f))
        assert not names & BANNED, f
        seen |= names
    assert "swarmkit_tpu_torch" in seen   # whole names: the port is fine


def test_the_run_loads_no_banned_module():
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from conftest import rehearse
from benchmark import run
res = rehearse("n4096-reads", seconds=0.3, n=16)
assert res["correct"], res["checks"]
print("BANNED", run.banned_modules(), res["banned"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "BANNED [] []" in out.stdout
