"""SimState fingerprints: order-salted hash32 folds (Zobrist hashing)
(PyTorch port of the JAX package's mc/fingerprint.py, bit for bit).

A fingerprint must be (a) computable on the device for a whole [W]
frontier chunk at once, (b) position-sensitive (swapping two rows' terms
must change it), and (c) stable across processes — it feeds the dedup
sets, the LTS node ids, and the cross-process stability test.  The
construction is the model checker's classic Zobrist form: every uint32
word of the flattened state is XOR'd in as ``hash32(word ^
hash32(position))``, so each (position, value) pair contributes an
independent pseudo-random mask and the fold is one vectorized hash +
XOR-reduce, no sequential chain.  Two such folds with different salt
constants give 64 bits: at the documented scopes (~1e6 states) the
birthday bound is ~1e-7, and a collision can only MERGE two states
(under-approximation — may hide, never fabricate, a violation).

The word stream is the JAX package's: the SimState fields in declaration
order (the JAX package's pytree leaf order), absent (None) fields
skipped, each field raveled and taken as uint32 bits (bools as 0/1, the
int32 bit patterns of the uint32 fields as themselves).  The arithmetic
runs on int64 tensors holding the unsigned value (raft/sim/u32.py), so a
port fingerprint equals JAX's on the same state.  Fingerprints are
comparable only between states of the SAME SimConfig: which Optional
field groups exist (reads, telemetry, mailboxes) is a cfg choice.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from swarmkit_tpu_torch.raft.sim import u32
from swarmkit_tpu_torch.raft.sim.state import (
    FIELD_NAMES, SimState, batch_size,
)

_SALT1 = 0x9E3779B9   # golden-ratio constants, distinct per fold
_SALT2 = 0x6A09E667


def _words(state: SimState) -> torch.Tensor:
    """[.., W] int64 unsigned form: every present field raveled, field
    order ([B, W] for a batched state)."""
    b = batch_size(state)
    ws = []
    for name in FIELD_NAMES:
        t = getattr(state, name)
        if t is None:
            continue
        t = t.reshape(b, -1) if b is not None else t.reshape(-1)
        ws.append(u32.unsigned(t))
    return torch.cat(ws, dim=-1)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce of the last axis (halving: log2(W) passes)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if x.shape[-1] % 2:
            y[..., :1] ^= x[..., 2 * h:]
        x = y
    return x[..., 0]


def fingerprint(state: SimState) -> torch.Tensor:
    """(hi, lo) fingerprint, int64 tensors holding the uint32 values: [2]
    for one state, [B, 2] for each cluster of a batched state."""
    w = _words(state)
    pos = torch.arange(w.shape[-1], dtype=torch.int64, device=w.device)
    h1 = u32.hash32(w ^ u32.hash32((pos + _SALT1) & u32.MASK))
    h2 = u32.hash32(((w + _SALT2) & u32.MASK)
                    ^ u32.hash32(pos ^ _SALT2))
    del w
    return torch.stack([_xor_fold(h1), _xor_fold(h2)], dim=-1)


# ---------------------------------------------------------------------------
# node relabeling (the optional symmetry reduction)

# [N, N(, K)] leaves permute BOTH node axes; these carry node indices as
# VALUES and remap them through the inverse permutation (NONE = -1 passes
# through).  Every other non-global field is a plain [N, ...] row permute.
_PAIR_FIELDS = frozenset((
    "match", "next_", "granted", "rejected", "recent_active", "member",
    "vreq_at", "vreq_term", "vreq_pre", "vresp_at", "vresp_term",
    "vresp_grant", "vresp_pre", "app_at", "app_prev", "app_term",
    "snp_at", "snp_term", "probing", "aresp_at", "aresp_term",
    "aresp_match", "aresp_ok", "hb_at", "hb_term", "hb_commit",
    "hbr_at", "hbr_term",
))
_INDEX_VALUED = frozenset(("vote", "lead", "transferee", "tn_from"))
_GLOBAL_FIELDS = frozenset((
    "tick", "stats", "tel_commit_hist", "tel_elect_hist", "tel_read_hist",
    "tel_series",
))


def relabel_state(state: SimState, perm) -> SimState:
    """Relabel nodes: new row k is old row perm[k], index values follow
    (each cluster of a batched state alike).

    NOT behavior-preserving in general: ``rand_timeout(cfg, node, term)``
    keys on the ROW INDEX, so a relabeled state draws different future
    election timeouts than the original (its `timeout` field keeps the
    permuted historical draws).  That is exactly why the symmetry-
    canonical dedup below is an opt-in heuristic rather than part of the
    exhaustive claim.
    """
    ax = 0 if batch_size(state) is None else 1
    n = state.vote.shape[-1]
    dev = state.vote.device
    perm = torch.as_tensor(list(perm), dtype=torch.int64, device=dev)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=torch.int64, device=dev)

    def remap(a):
        return torch.where(a >= 0, inv[torch.clamp(a, 0, n - 1).long()]
                           .to(a.dtype), a)

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None or f.name in _GLOBAL_FIELDS:
            out[f.name] = v
        elif f.name in _PAIR_FIELDS:
            out[f.name] = v.index_select(ax, perm).index_select(ax + 1, perm)
        elif f.name in _INDEX_VALUED:
            out[f.name] = remap(v).index_select(ax, perm)
        else:
            out[f.name] = v.index_select(ax, perm)
    return SimState(**out)


def canonical_fingerprint(state: SimState, n: int) -> torch.Tensor:
    """The lexicographic minimum of `fingerprint` over all n! node
    relabelings ([2], or [B, 2] per cluster): symmetric states collapse
    to one value.  Opt-in (``exhaustive_scan(symmetry=True)``): see
    `relabel_state` for why this reduction is a heuristic against the real
    kernel."""
    best = None
    for perm in itertools.permutations(range(n)):
        fp = fingerprint(relabel_state(state, perm))
        if best is None:
            best = fp
        else:
            less = (fp[..., 0] < best[..., 0]) \
                | ((fp[..., 0] == best[..., 0]) & (fp[..., 1] < best[..., 1]))
            best = torch.where(less[..., None], fp, best)
    return best
