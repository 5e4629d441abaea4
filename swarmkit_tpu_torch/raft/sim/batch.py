"""The tick's batch axis (PyTorch port): B independent clusters as a
leading axis of every SimState field.

`Bx` is the one place that knows how that axis is laid out; the tick
(raft/sim/kernel.py) and the read path (raft/read/serve.py) index through
it, so the unbatched program is the same op for op with or without it.
"""

from __future__ import annotations

from typing import Optional

import torch


class Bx:
    """The tick's batch axis: B independent clusters as a leading axis of
    every SimState field ([B, N], [B, N, N], [B, N, L], ...), the port's
    form of the JAX package's jax.vmap(step) (explore's schedule axis).

    Each helper emits today's unbatched op when there is no batch axis
    (`on` False), so the unbatched tick runs the same program as before,
    and its batched form when there is: sender-row gathers (`take`, `at`,
    `pick`), last-axis ring stores (`put_at`), ring slots per row
    (`ring_ix`), the transpose and diagonal of the last two axes,
    per-node vectors broadcast as columns or rows,
    the ring rows of all clusters as one [B*N, L] matrix (`rows`),
    reduction axes shifted past the batch axis (`d`), and the tick, a
    per-cluster scalar, shaped for an operand of a given rank (`t`)."""

    def __init__(self, batch: Optional[int] = None):
        self.on = batch is not None
        self.B = batch

    def d(self, dim):
        """Reduction axis (int or tuple) `dim` of the unbatched tensor."""
        if not self.on:
            return dim
        return tuple(x + 1 for x in dim) if isinstance(dim, tuple) \
            else dim + 1

    def t(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """A per-cluster scalar (0-d, or [B]) broadcast against an operand
        of per-cluster rank `rank` ([N] is 1, [N, N] is 2, ...)."""
        return x.view((-1,) + (1,) * rank) if self.on else x

    def col(self, x):
        """[.., N] -> [.., N, 1]."""
        return x[:, :, None] if self.on else x[:, None]

    def row(self, x):
        """[.., N] -> [.., 1, N]."""
        return x[:, None, :] if self.on else x[None, :]

    def slot(self, x):
        """[.., N, N] -> [.., N, N, 1]: an edge value per mailbox slot."""
        return x[:, :, :, None] if self.on else x[:, :, None]

    def col_k(self, x):
        """[.., N] -> [.., N, 1, 1]."""
        return x[:, :, None, None] if self.on else x[:, None, None]

    def row_k(self, x):
        """[.., N] -> [.., 1, N, 1]."""
        return x[:, None, :, None] if self.on else x[None, :, None]

    def T(self, x):
        """Transpose of the last two axes."""
        return x.transpose(-1, -2) if self.on else x.T

    def diag(self, x):
        """Diagonal of the last two axes."""
        return torch.diagonal(x, dim1=-2, dim2=-1) if self.on \
            else torch.diagonal(x)

    def rows(self, x):
        """[.., N, L] -> the ring rows [N, L], or [B*N, L] batched: a view,
        so an in-place write through it lands in x (x contiguous)."""
        return x.view(-1, x.shape[-1]) if self.on else x

    def ring_ix(self, slot):
        """The advanced index of ring slots `slot` [.., N, K] (int64) in an
        [.., N, L] ring: x[ring_ix(slot)] reads, and assigns, each row's K
        slots."""
        n = slot.shape[-2]
        rows = torch.arange(n, device=slot.device)
        if not self.on:
            return rows[:, None], slot
        b = torch.arange(self.B, device=slot.device)
        return b[:, None, None], rows[None, :, None], slot

    def take(self, x, idx):
        """x[idx]: rows of a per-node [.., N] or [.., N, M] tensor by the
        int64 row ids idx [.., N]."""
        if not self.on:
            return x[idx]
        if x.dim() == 2:
            return x.gather(1, idx)
        return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    def at(self, x, i, j):
        """x[i, j]: one element of an [.., N, M] tensor per (i, j) pair of
        broadcastable int64 index tensors."""
        if not self.on:
            return x[i, j]
        m = x.shape[2]
        return x.reshape(x.shape[0], -1).gather(
            1, (i * m + j).expand(x.shape[0], -1))

    def put_at(self, x, i, j, vals) -> None:
        """x[i, j] = vals, in place (x contiguous)."""
        if not self.on:
            x[i, j] = vals
            return
        m = x.shape[2]
        x.view(x.shape[0], -1).scatter_(
            1, (i * m + j).expand(x.shape[0], -1), vals)

    def pick(self, x, idx):
        """x.gather(1, idx[:, None])[:, 0]: one column of [.., N, M] per
        row."""
        if not self.on:
            return x.gather(1, idx[:, None])[:, 0]
        return x.gather(2, idx[:, :, None])[:, :, 0]

    def csum(self, x, dtype=None):
        """A value reduction over a cluster's rows: the whole tensor when
        unbatched, each cluster's [N] (or [N, ...]) when batched."""
        if not self.on:
            return x.sum(dtype=dtype)
        return x.reshape(self.B, -1).sum(1, dtype=dtype)

    def stack(self, xs):
        """Per-cluster scalars stacked into a vector on the last axis."""
        return torch.stack(xs, dim=-1) if self.on else torch.stack(xs)


NOBATCH = Bx()
