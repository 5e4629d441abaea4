"""The tick's batch axis (PyTorch port): B independent clusters as a
leading axis of every SimState field.

`Bx` is the one place that knows how that axis is laid out; the tick
(raft/sim/kernel.py) and the read path (raft/read/serve.py) index through
it, so the unbatched program is the same op for op with or without it.

It also carries the row exchange of a row-sharded tick (`rx`,
parallel.Rx): one cluster's rows split over the entries of a row mesh,
each shard holding rows [r0, r1) of every row-indexed field with all N
columns.  Then the helpers that read across rows meet the other shards:
`row` all-gathers the [N] vector it broadcasts, `T` is the all-to-all
transpose, `diag` the shard's rows of the diagonal, `csum` a sum over
shards, `cmax` / `cany` the reductions over the row axis, and `gtake` /
`gat` read other rows by global row id.  Without an exchange (`rx` None,
every unsharded and every batched tick) each is today's op.
"""

from __future__ import annotations

from typing import Optional

import torch

from swarmkit_tpu_torch.parallel import current_rx

_AMBIENT = object()


class Bx:
    """The tick's batch axis: B independent clusters as a leading axis of
    every SimState field ([B, N], [B, N, N], [B, N, L], ...), the port's
    form of the JAX package's jax.vmap(step) (explore's schedule axis).

    Each helper emits today's unbatched op when there is no batch axis
    (`on` False), so the unbatched tick runs the same program as before,
    and its batched form when there is: sender-row gathers (`take`, `at`,
    `pick`), last-axis ring stores (`put_at`), ring slots per row
    (`ring_ix`), the transpose and diagonal of the last two axes,
    per-node vectors broadcast as columns or rows, column bands and row
    bands of a cluster's [R, N] matrix (`cols`, `row_band`), the slab's
    scatter of [A] rows back into N (`put_rows`), the ring rows of all
    clusters, or of one chunk of them, as one [B*N, C] matrix (`rows`),
    reduction axes shifted past the batch axis (`d`), and the tick, a
    per-cluster scalar, shaped for an operand of a given rank (`t`).

    Under role-sparse progress the row ids are [A] (unbatched) or [B, A],
    each cluster's own active rows: `take` gathers them, `put_rows`
    writes them back."""

    def __init__(self, batch: Optional[int] = None, rx=_AMBIENT):
        self.on = batch is not None
        self.B = batch
        # the row exchange: the calling shard's (parallel.current_rx) unless
        # given; a batched state never shards its rows
        self.rx = current_rx() if rx is _AMBIENT else rx
        if self.rx is not None and self.on:
            raise NotImplementedError("a batched state over a row mesh")
        # the shard that keeps the host's counts (every tick has one)
        self.lead = self.rx is None or self.rx.lead
        # the tick's all-gathers by input tensor (its [N] vectors are never
        # written in place, and a kept input cannot lend its id to another)
        self._whole: dict = {}

    def full(self, x):
        """An [N] vector whole: this shard's [N/D] rows all-gathered (once
        a tensor for the life of this Bx, one tick's)."""
        if self.rx is None:
            return x
        hit = self._whole.get(id(x))
        if hit is None:
            hit = self._whole[id(x)] = (x, self.rx.allgather(x))
        return hit[1]

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
        return x[:, None, :] if self.on else self.full(x)[None, :]

    def slot(self, x):
        """[.., N, N] -> [.., N, N, 1]: an edge value per mailbox slot."""
        return x[:, :, :, None] if self.on else x[:, :, None]

    def col_k(self, x):
        """[.., N] -> [.., N, 1, 1]."""
        return x[:, :, None, None] if self.on else x[:, None, None]

    def row_k(self, x):
        """[.., N] -> [.., 1, N, 1]."""
        return x[:, None, :, None] if self.on \
            else self.full(x)[None, :, None]

    def T(self, x):
        """Transpose of the last two axes."""
        if self.rx is not None:
            return self.rx.transpose(x)
        return x.transpose(-1, -2) if self.on else x.T

    def diag(self, x):
        """Diagonal of the last two axes (a shard's rows of it: the
        diagonal at offset r0 of its [N/D, N] rows)."""
        if self.rx is not None:
            return torch.diagonal(x, offset=self.rx.r0)
        return torch.diagonal(x, dim1=-2, dim2=-1) if self.on \
            else torch.diagonal(x)

    def cmax(self, x, dim=0):
        """x.amax over the row axis (and any other axes in `dim`): the
        [N] per-column maximum, a shard's rows of it reduced over shards."""
        m = x.amax(dim=self.d(dim))
        return m if self.rx is None else self.rx.reduce_scatter(m, "max")

    def cany(self, x):
        """x.any over the row axis, per column (as cmax)."""
        m = x.any(self.d(0))
        return m if self.rx is None else self.rx.reduce_scatter(m, "or")

    def gtake(self, x, ids):
        """take() by global row ids: rows of another shard are fetched
        ([N] vectors by an all-gather, matrices and rings by a gather of
        the requested rows)."""
        if self.rx is None:
            return self.take(x, ids)
        if x.dim() == 1:
            return self.full(x)[ids]
        return self.rx.take(x, ids)

    def gat(self, x, i, j):
        """at() with global row ids `i` (an element of another shard's
        row is fetched from it)."""
        if self.rx is None:
            return self.at(x, i, j)
        return self.rx.take(x, i, j)

    def rows(self, x):
        """[.., N, C] -> the ring rows [N, C], or [B*N, C] batched: a view,
        so an in-place write through it lands in x (x contiguous).  C is
        the whole ring L, or one chunk's width for a chunk's operands."""
        return x.view(-1, x.shape[-1]) if self.on else x

    def cols(self, x, j0: int, w: int):
        """Columns [j0, j0 + w) of the last axis of an [.., R, N] matrix:
        a peer band, or a log chunk of an [.., N, L] ring (a view)."""
        return x[..., j0:j0 + w] if self.on else x[:, j0:j0 + w]

    def row_band(self, x, i0: int, w: int):
        """Rows [i0, i0 + w) of an [.., N, M] matrix (a view)."""
        return x[:, i0:i0 + w] if self.on else x[i0:i0 + w]

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
        """x[idx]: rows of a per-node [.., N], [.., N, M] or [.., N, M, K]
        tensor by the int64 row ids idx [.., R] (R = N for sender rows, A
        for the slab's rows)."""
        if not self.on:
            return x[idx]
        if x.dim() == 2:
            return x.gather(1, idx)
        return x.gather(1, self._rows_ix(x, idx))

    @staticmethod
    def _rows_ix(x, idx):
        """[B, R] row ids broadcast over x's trailing axes (axis-1 gather
        and scatter index)."""
        return idx.view(idx.shape + (1,) * (x.dim() - 2)) \
            .expand(idx.shape + x.shape[2:])

    def put_rows(self, full, idx, rows, inplace: bool = True):
        """full[idx] = rows along the row axis (the slab's rows written
        back): in place, or into a copy with inplace=False."""
        if not self.on:
            return full.index_copy_(0, idx, rows) if inplace \
                else full.index_copy(0, idx, rows)
        ix = self._rows_ix(full, idx)
        return full.scatter_(1, ix, rows) if inplace \
            else full.scatter(1, ix, rows)

    def at(self, x, i, j):
        """x[i, j]: one element of an [.., N, M] tensor per (i, j) pair of
        broadcastable int64 index tensors ([.., N] pairs, or [.., N, K]
        windows of them)."""
        if not self.on:
            return x[i, j]
        m = x.shape[2]
        k = i * m + j
        if k.dim() > 2:
            return x.reshape(x.shape[0], -1).gather(
                1, k.reshape(x.shape[0], -1)).view(k.shape)
        return x.reshape(x.shape[0], -1).gather(1, k.expand(x.shape[0], -1))

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
        unbatched (summed over the shards of a row-sharded tick), each
        cluster's [N] (or [N, ...]) when batched."""
        if not self.on:
            s = x.sum(dtype=dtype)
            return s if self.rx is None else self.rx.allreduce(s, "sum")
        return x.reshape(self.B, -1).sum(1, dtype=dtype)

    def csums(self, xs, dtype=None):
        """csum of each of xs, stacked on the last axis: one sum over the
        shards for all of them on a row-sharded tick."""
        if self.rx is None or self.on:
            return self.stack([self.csum(x, dtype) for x in xs])
        return self.rx.allreduce(
            torch.stack([x.sum(dtype=dtype) for x in xs]), "sum")

    def stack(self, xs):
        """Per-cluster scalars stacked into a vector on the last axis."""
        return torch.stack(xs, dim=-1) if self.on else torch.stack(xs)


NOBATCH = Bx(rx=None)
