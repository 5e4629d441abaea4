"""Hand-written Hopper kernels of the port, with their plain twins.

Counterpart of the JAX package's parallel/pallas_ops.py.  Each wrapper
checks its arguments, runs the plain PyTorch version when the tensors lie
on the CPU, and otherwise launches its CUDA kernel (csrc/, built by
_build.py for sm_90a) or raises — it never falls back.  `LAUNCHES` counts
kernel launches per wrapper, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from swarmkit_tpu_torch import _build

LAUNCHES: dict[str, int] = {"append_band_copy": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _band_copy_fn():
    fn = _build.load("band_copy").band_copy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def append_band_copy_plain(log_term: torch.Tensor, log_data: torch.Tensor,
                           off: int, src_term: torch.Tensor,
                           src_data: torch.Tensor,
                           write: torch.Tensor) -> None:
    """Plain PyTorch version of append_band_copy (same contract)."""
    c = write.shape[1]
    lt, ld = log_term[:, off:off + c], log_data[:, off:off + c]
    lt.copy_(torch.where(write, src_term, lt))
    ld.copy_(torch.where(write, src_data, ld))


def append_band_copy(log_term: torch.Tensor, log_data: torch.Tensor,
                     off: int, src_term: torch.Tensor,
                     src_data: torch.Tensor, write: torch.Tensor) -> None:
    """Masked in-place write-back of one [N, C] chunk of both log rings:
    ``log_*[i, off + c] = src_*[i, c] if write[i, c] else log_*[i, off + c]``.

    log_term/log_data: [N, L] int32 rings (log_data holds uint32 bits);
    src_term/src_data: [N, C] int32; write: [N, C] bool; 0 <= off and
    off + C <= L.  One CUDA launch updates both rings under the shared
    mask; the JAX package made two Pallas launches per chunk plus a
    dynamic_update_slice each."""
    n, L = log_term.shape
    c = write.shape[1] if write.dim() == 2 else -1
    for name, t, shape, dtype in (
            ("log_term", log_term, (n, L), torch.int32),
            ("log_data", log_data, (n, L), torch.int32),
            ("src_term", src_term, (n, c), torch.int32),
            ("src_data", src_data, (n, c), torch.int32),
            ("write", write, (n, c), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != log_term.device:
            raise ValueError(f"{name} is on {t.device}, log_term on "
                             f"{log_term.device}")
    if not (0 <= off and off + c <= L):
        raise ValueError(f"chunk [{off}, {off + c}) does not fit a ring of "
                         f"width {L}")
    if log_term.device.type == "cpu":
        append_band_copy_plain(log_term, log_data, off, src_term, src_data,
                               write)
        return
    if log_term.device.type != "cuda":
        raise ValueError(f"no kernel for device {log_term.device}")
    fn = _band_copy_fn()
    with torch.cuda.device(log_term.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(log_term.data_ptr(), log_data.data_ptr(),
                src_term.data_ptr(), src_data.data_ptr(), write.data_ptr(),
                n, L, off, c, stream)
    if rc != 0:
        raise RuntimeError(f"band_copy launch failed: CUDA error {rc}")
    LAUNCHES["append_band_copy"] += 1
