"""Build and load the port's CUDA sources (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface under `build/kernels/` at the checkout root (listed in
.gitignore), then loaded with ctypes.  A library is rebuilt when it is
missing or older than its source.  Nothing happens at import: the first
launch of a kernel builds it, and `build_all` compiles every source at once
(one nvcc process each, started together).  A lock serialises building and
loading, so threads that need the same kernel at once (two tasks preparing
on the executor's worker threads) run one nvcc, not two.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return not lib.exists() \
        or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), Path(tmp)


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
    os.replace(tmp, lib_path(name))   # atomic: no half-written library
    return out


def build_all() -> dict[str, str]:
    """Compile every stale source in parallel; returns nvcc's output (the
    -Xptxas -v register and spill report) per rebuilt source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {nm: _start(nm) for nm in names if _stale(nm)}
        return {nm: _finish(nm, *pt) for nm, pt in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib
