"""uint32 arithmetic on int32 bit patterns.

The JAX kernel keeps payloads and state-machine checksums (`log_data`,
`snap_chk`, `apply_chk`) as uint32 and relies on its wraparound.  torch's
uint32 lacks `>>`, `+`, `%`, ordering and `where`, and its `sum` widens, so
the port stores those fields as int32 tensors holding the same 32 bits.
Bitwise ops and equality agree under either reading.  Everything else runs
on int64 tensors holding the unsigned value in [0, 2**32) ("unsigned form"
below) and comes back through `to_bits`.
"""

from __future__ import annotations

import torch

MASK = 0xFFFF_FFFF


def unsigned(x: torch.Tensor) -> torch.Tensor:
    """Unsigned form of an integer tensor's low 32 bits (int32 bit patterns
    and negative indexes wrap exactly like a uint32 cast)."""
    return x.to(torch.int64) & MASK


def to_bits(u: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the low 32 bits of an int64 tensor."""
    return (((u & MASK) ^ 0x8000_0000) - 0x8000_0000).to(torch.int32)


def mul(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2**32 for u in unsigned form and a constant c < 2**32,
    split at 16 bits so no int64 product can overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & MASK


def hash32(u: torch.Tensor) -> torch.Tensor:
    """splitmix32-style mix, unsigned form in and out (logical shifts:
    the int64 operand is never negative)."""
    u = u ^ (u >> 16)
    u = mul(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = mul(u, 0x846CA68B)
    return u ^ (u >> 16)


def wrap_sum(u: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular (uint32) sum along `dim`, unsigned form in and out.  Each
    term is below 2**32, so int64 holds any sum of fewer than 2**31 terms."""
    return u.sum(dim, dtype=torch.int64) & MASK
