"""The WAL frame codec (the port's own copy of the JAX package's
native/__init__.py and native/wal_codec.cpp).

The reference's WAL hot path lives in compiled Go (coreos/etcd/wal); here
it is wal_codec.cpp, host C++ with a plain C interface, loaded through
ctypes.  ``wal_codec()`` returns the process-wide codec by name:

    frame(bodies: list[bytes]) -> bytes         # batch-frame records
    scan(blob: bytes) -> (list[bytes], status)  # validated record bodies
        status: 0 clean, 1 torn tail dropped, 2 corrupt mid-stream

``"native"`` (the default, what the raft WAL uses) is the compiled codec:
g++ builds wal_codec.cpp into ``build/native/`` at the checkout root
(listed in .gitignore) at its first use, and again when the library is
older than its source.  A failed build raises: the WAL never drops to
another codec on its own.  ``"python"`` is the plain version with the same
frames and statuses, chosen by name (the tests hold the native codec to
it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

_FRAME = struct.Struct("<II")

STATUS_OK = 0
STATUS_TORN_TAIL = 1
STATUS_CORRUPT = 2

SRC = Path(__file__).resolve().parent / "wal_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
LIB = BUILD_DIR / "libwal_codec.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


class PyWalCodec:
    """The plain version; frames and statuses identical to wal_codec.cpp."""

    name = "python"

    def frame(self, bodies: list[bytes]) -> bytes:
        out = bytearray()
        for body in bodies:
            out += _FRAME.pack(len(body), zlib.crc32(body)) + body
        return bytes(out)

    def scan(self, blob: bytes) -> tuple[list[bytes], int]:
        records: list[bytes] = []
        off = 0
        n = len(blob)
        while off < n:
            if off + _FRAME.size > n:
                return records, STATUS_TORN_TAIL
            length, crc = _FRAME.unpack_from(blob, off)
            body = blob[off + _FRAME.size: off + _FRAME.size + length]
            if len(body) < length:
                return records, STATUS_TORN_TAIL
            if zlib.crc32(body) != crc:
                if off + _FRAME.size + length >= n:
                    return records, STATUS_TORN_TAIL
                return records, STATUS_CORRUPT
            records.append(body)
            off += _FRAME.size + length
        return records, STATUS_OK


class NativeWalCodec:
    name = "native"

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.wal_frame_size.restype = ctypes.c_uint64
        lib.wal_frame_size.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.c_uint64]
        lib.wal_frame.restype = ctypes.c_uint64
        lib.wal_frame.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_uint64, ctypes.c_char_p]
        lib.wal_scan.restype = ctypes.c_uint64
        lib.wal_scan.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_uint64]
        lib.wal_scan_status.restype = ctypes.c_int
        lib.wal_scan_consumed.restype = ctypes.c_uint64

    def frame(self, bodies: list[bytes]) -> bytes:
        n = len(bodies)
        lens = (ctypes.c_uint64 * n)(*[len(b) for b in bodies])
        concat = b"".join(bodies)
        total = self._lib.wal_frame_size(lens, n)
        out = ctypes.create_string_buffer(total)
        written = self._lib.wal_frame(concat, lens, n, out)
        return out.raw[:written]

    # bounded per-pass offset buffers; chunked resume via wal_scan_consumed
    # avoids worst-case (len/8) allocations on huge segments
    _SCAN_BATCH = 1 << 16

    def scan(self, blob: bytes) -> tuple[list[bytes], int]:
        batch = min(self._SCAN_BATCH, max(1, len(blob) // _FRAME.size))
        offs = (ctypes.c_uint64 * batch)()
        lens = (ctypes.c_uint64 * batch)()
        records: list[bytes] = []
        base = 0
        view = blob
        while True:
            count = self._lib.wal_scan(view, len(view), offs, lens, batch)
            status = self._lib.wal_scan_status()
            records.extend(view[offs[i]: offs[i] + lens[i]]
                           for i in range(count))
            consumed = self._lib.wal_scan_consumed()
            if status != STATUS_OK or consumed >= len(view) or count == 0:
                return records, status
            base += consumed
            view = blob[base:]


def _stale() -> bool:
    return not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime


def build() -> Path:
    """Compile wal_codec.cpp into LIB when it is missing or stale; a
    failure raises with the compiler's output.  The library is written
    under a temporary name and renamed, so a concurrent loader sees a
    whole library or none."""
    if not _stale():
        return LIB
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the WAL codec (native/"
                           "wal_codec.cpp) builds with the host C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on wal_codec.cpp:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, LIB)
    return LIB


_native = None
_lock = threading.Lock()


def wal_codec(name: str = "native"):
    """The codec called `name`: the native one (built at first use, then
    shared by the process) or the plain Python one."""
    global _native
    if name == "python":
        return PyWalCodec()
    if name != "native":
        raise ValueError(f"unknown WAL codec {name!r}")
    if _native is None:
        with _lock:
            if _native is None:
                _native = NativeWalCodec(ctypes.CDLL(str(build())))
    return _native
