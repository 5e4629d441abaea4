"""Hand-written Hopper kernels of the port, with their plain twins.

Counterpart of the JAX package's parallel/pallas_ops.py.  Each wrapper
checks its arguments, runs the plain PyTorch version when the tensors lie
on the CPU, and otherwise launches its CUDA kernel (csrc/, built by
_build.py for sm_90a) or raises — it never falls back.  `LAUNCHES` counts
kernel launches per wrapper, so a run can show that its path went through
the kernels; append_band_copy also counts each of its paths under
`append_band_copy_<path>`, matmul each of its three kernels under
`matmul_<variant>`, and place_greedy each of its kernels under
`sched_place_<variant>`.  `place_greedy` (the scheduler's group placement)
has no Pallas ancestor: the JAX package runs that loop as plain jnp/lax.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from swarmkit_tpu_torch import _build

# band_copy.cu's paths, in its codes' order (band_copy_path says which
# takes a call); its first version, "v1", is never on the path
BAND_COPY_PATHS = ("flat", "chunk", "scalar", "words")
# the whole rings that take the flat path's 512-element warp tiles; a
# smaller one runs at about the launch floor, where one 4-element word a
# thread (the words path) has the shorter chain of dependent reads: on the
# H100 0.0017 against the tiles' 0.0023 ms on fault_sweep's [40, 64] ring,
# level from [3072, 512] up, while the tiles stream a 100 MB mask with no
# set byte 1.8 times as fast (tools/band_copy_probe.py)
FLAT_TILES_MIN = 1 << 20
MATMUL_VARIANTS = ("wgmma", "wmma", "simt")
# sched_place.cu's kernels: the tree kernel (keys in two words where they
# fit), the same comparing every key field by field, and the rescan kernel
# the tree kernel replaced
PLACE_VARIANTS = ("tree", "tree_fields", "rescan")
LAUNCHES: dict[str, int] = {
    "append_band_copy": 0, "matmul": 0, "sumsq": 0, "sched_place": 0,
    **{f"append_band_copy_{p}": 0 for p in (*BAND_COPY_PATHS, "v1")},
    **{f"matmul_{v}": 0 for v in MATMUL_VARIANTS},
    **{f"sched_place_{v}": 0 for v in PLACE_VARIANTS}}
_launches_lock = threading.Lock()   # tasks launch from executor threads

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (csrc/<source>.cu, C function) -> its argument types
_ENTRY = {
    ("band_copy", "band_copy"): [_P] * 5 + [_I64] * 4 + [_I32, _P],
    ("band_copy", "band_copy_v1"): [_P] * 5 + [_I64] * 4 + [_P],
    ("band_copy", "band_copy_empty_launch"): [_P],
    **{("matmul", f"matmul_{v}"): [_P] * 3 + [_I64] * 3 + [_P]
       for v in MATMUL_VARIANTS},
    ("matmul", "matmul_wgmma_smem_bytes"): [],
    ("sumsq", "sumsq"): [_P, _I64, _I32, _P, _P],
    ("sumsq", "sumsq_scratch_floats"): [],
    **{("sched_place", f): [_P, _I64, _I64, _I64, _I32, _I32, _P, _P, _P]
       for f in ("sched_place", "sched_place_rescan")},
    ("sched_place", "sched_place_scratch_words"): [_I64, _I64, _I32],
}
# the C functions that return something other than an int
_RESTYPE = {("sched_place", "sched_place_scratch_words"): ctypes.c_longlong}
# the dtypes the kernels take, with sumsq.cu's codes for them
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1


def _kernel(source: str, name: str | None = None):
    """C function `name` (default: `source`) of csrc/<source>.cu, built,
    loaded and typed."""
    name = name or source
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ENTRY[source, name]
        fn.restype = _RESTYPE.get((source, name), ctypes.c_int)
    return fn


def load_kernels(*sources: str) -> None:
    """Build and load csrc/<source>.cu for each source now, so a build or
    loader failure surfaces here rather than at the first launch."""
    for source in sources:
        _build.load(source)


def _launch(source: str, device: torch.device, *args,
            name: str | None = None) -> None:
    """Launch C function `name` (default: `source`) of csrc/<source>.cu on
    `device`'s current stream; raise on a CUDA error (a negative code is
    the CUresult of encoding a TMA tensor map)."""
    name = name or source
    fn = _kernel(source, name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc > 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if rc < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {-rc})")


def _check_tensors(**tensors) -> torch.device:
    """A kernel dtype, contiguity and a shared device for each named
    tensor; returns the device."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                             f"{sorted(map(str, _DTYPE_CODE))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


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
    _band_copy_launch(log_term, log_data, off, src_term, src_data, write)


def band_copy_path(n: int, ring: int, off: int, width: int,
                   *addresses: int) -> str:
    """The path of band_copy.cu that takes a call on [n, ring] rings and
    [n, width] chunks at `off`, whose tensors start at `addresses`: for
    the whole ring (off 0, width = ring) "flat" from FLAT_TILES_MIN
    elements up and "words" below; "chunk" for 16-element vectors (width
    a multiple of 16 and at most 16 x 32 x 65535, the grid's column
    tiles; off and ring multiples of 4); "scalar" for any other shape.
    All but the scalar path need every base 16-byte aligned."""
    if any(a % 16 for a in addresses):
        return "scalar"
    if off == 0 and width == ring:
        return "flat" if n * ring >= FLAT_TILES_MIN else "words"
    if width % 16 == 0 and width // 16 <= 32 * 65535 and off % 4 == 0 \
            and ring % 4 == 0:
        return "chunk"
    return "scalar"


def _band_copy_launch(log_term, log_data, off, src_term, src_data, write,
                      variant: str = "") -> None:
    """Launch the band copy on checked CUDA tensors and count it: the
    kernel on the path band_copy_path names, or, with variant "v1", the
    first version (only the card's tests, chip_smoke.py and
    tools/band_copy_probe.py ask for it, to hold the two side by side on
    the same inputs)."""
    n, L = log_term.shape
    c = write.shape[1]
    ptrs = [t.data_ptr() for t in (log_term, log_data, src_term, src_data,
                                   write)]
    if variant == "v1":
        _launch("band_copy", log_term.device, *ptrs, n, L, off, c,
                name="band_copy_v1")
        _count("append_band_copy_v1")
        return
    path = band_copy_path(n, L, off, c, *ptrs)
    _launch("band_copy", log_term.device, *ptrs, n, L, off, c,
            BAND_COPY_PATHS.index(path))
    _count("append_band_copy")
    _count(f"append_band_copy_{path}")


def launch_empty(device: torch.device) -> None:
    """One empty kernel of one block on `device`'s current stream: the
    launch floor chip_smoke.py times beside the band copy (not counted)."""
    _launch("band_copy", device, name="band_copy_empty_launch")


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of matmul: f32 products and sums, rounded
    once to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def _matmul_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes a @ b, from dtype, shape and alignment alone:
    "wgmma" for bfloat16 that TMA can load (K and N multiples of 8, so
    every row pitch is a multiple of 16 bytes, and 16-byte aligned bases;
    the output is allocated aligned), "wmma" for other bfloat16, "simt"
    for float32."""
    if a.dtype == torch.float32:
        return "simt"
    k, n = b.shape
    if k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0 \
            and b.data_ptr() % 16 == 0:
        return "wgmma"
    return "wmma"


def _matmul_launch(a: torch.Tensor, b: torch.Tensor,
                   variant: str) -> torch.Tensor:
    """Launch one matmul kernel on checked CUDA operands and count it.
    `matmul` passes the variant its shape rule names; only the card's
    tests and chip_smoke.py pass another, to hold two kernels side by
    side on the same inputs."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _launch("matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, n, k, name=f"matmul_{variant}")
    _count("matmul")
    _count(f"matmul_{variant}")
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, tile_m: int = 256,
           tile_n: int = 256, tile_k: int = 256) -> torch.Tensor:
    """[M, K] @ [K, N] -> [M, N] in a's dtype, accumulated in f32.

    The tiles are the TPU kernel's contract, kept for its checks in its
    order: each is clamped to its dimension, then must divide it.  The CUDA
    kernels tile on their own terms and take any shape that passes them.
    bfloat16 runs on the tensor cores (the wgmma kernel where TMA can load
    the operands, else the WMMA one), float32 in full f32 FMA; see
    `_matmul_variant`.  A kernel that fails raises: no other kernel and no
    plain version stands in for it."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    tile_m, tile_n, tile_k = min(tile_m, m), min(tile_n, n), min(tile_k, ka)
    if m % tile_m or n % tile_n or ka % tile_k:
        raise ValueError(
            f"shapes ({m},{ka})@({kb},{n}) must divide tiles "
            f"({tile_m},{tile_n},{tile_k})")
    if b.dtype != a.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} @ {b.dtype}")
    device = _check_tensors(a=a, b=b)
    if device.type == "cpu":
        return matmul_plain(a, b)
    return _matmul_launch(a, b, _matmul_variant(a, b))


def sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sumsq."""
    return x.float().square().sum()


def sumsq(x: torch.Tensor, *, tile_m: int = 256) -> torch.Tensor:
    """Sum of squares of an [M, N] bfloat16 or float32 tensor as a 0-d f32
    tensor.

    `tile_m` is the TPU kernel's row tile, kept for its check: clamped to
    M, it must divide M.  On the card two passes (per-block partials, then
    one block) with no atomics: repeated calls agree bit for bit."""
    if x.dim() != 2:
        raise ValueError(f"sumsq takes a 2-D tensor, got {tuple(x.shape)}")
    m = x.shape[0]
    tile_m = min(tile_m, m)
    if m % tile_m:
        raise ValueError(f"rows {m} must divide tile {tile_m}")
    device = _check_tensors(x=x)
    if device.type == "cpu":
        return sumsq_plain(x)
    scratch = torch.empty(_kernel("sumsq", "sumsq_scratch_floats")(),
                          dtype=torch.float32, device=device)
    _launch("sumsq", device, x.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
            scratch.data_ptr())
    _count("sumsq")
    return scratch[0]


def matmul_chain(x: torch.Tensor, a: torch.Tensor, steps: int, *,
                 tile: int = 256) -> torch.Tensor:
    """`steps` rounds of x <- normalize(x @ a) through the matmul and sumsq
    kernels, as the JAX package's pallas_ops.matmul_chain.  A host loop
    takes the place of lax.scan; the norm stays on the device, so a round
    costs no host sync."""
    for _ in range(steps):
        y = matmul(x, a, tile_m=tile, tile_n=tile, tile_k=tile)
        ss = sumsq(y, tile_m=tile)
        denom = torch.clamp_min(torch.sqrt(ss / y.numel()), 1e-6)
        x = (y.float() / denom).to(y.dtype)
    return x


# the kernel place_greedy launches
PLACE_VARIANT = "tree"
# the rows of place_greedy's [6, N] int32 column block
PLACE_COLUMNS = ("static_ok", "cap", "count0", "active0", "taint", "branch")
_NONE = 1 << 30   # the JAX kernel's "no node" index


def _refine(m: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Narrow mask m to the entries minimising vals (one lexicographic
    stage; an all-false mask stays all-false)."""
    best = torch.where(m, vals, _NONE).min()
    return m & (vals == best)


def place_greedy_plain(cols: torch.Tensor, n_branches: int,
                       has_service: bool, n_tasks: int) -> torch.Tensor:
    """Plain PyTorch version of place_greedy: the JAX package's greedy
    fori_loop body, one task at a time, in torch ops on cols' device.  On
    the CPU it stops at the first task that finds no node (none later can:
    `a` only grows); elsewhere it runs every task without reading back."""
    ok, cap, count0, active0, taint, branch = cols
    n, dev = cols.shape[1], cols.device
    if n_branches and n and not 0 <= int(branch.min()) <= int(branch.max()) \
            < n_branches:
        raise ValueError(f"branch ids must lie in [0, {n_branches})")
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    branch64 = branch.long()
    ok = ok != 0
    a = torch.zeros(n, dtype=torch.int32, device=dev)
    choices = torch.full((n_tasks,), -1, dtype=torch.int32, device=dev)
    hs = 1 if has_service else 0
    for i in range(n_tasks if n else 0):
        count = count0 + a * hs
        active = active0 + a
        feas = ok & (a < cap)
        found = feas.any()
        if n_branches:
            load_b = torch.zeros(n_branches, dtype=torch.int32,
                                 device=dev).scatter_add_(
                0, branch64, torch.where(feas, count, 0))
            first_b = torch.full((n_branches,), _NONE, dtype=torch.int32,
                                 device=dev).scatter_reduce_(
                0, branch64, torch.where(feas, idx, _NONE), "amin")
            bm = _refine(first_b < _NONE, load_b)
            bm = _refine(bm, first_b)
            feas = feas & (branch == bm.to(torch.int8).argmax())
        m = _refine(feas, taint)
        m = _refine(m, count)
        m = _refine(m, active)
        pick = torch.where(m, idx, _NONE).min()
        choice = torch.where(found, pick, -1).to(torch.int32)
        a.index_add_(0, choice.clamp(min=0).view(1),
                     found.to(torch.int32).view(1))
        choices[i] = choice
        if dev.type == "cpu" and not bool(found):
            break
    return choices


def _rescan_threads(n: int, n_branches: int) -> int:
    """The rescan kernel's block width: about four nodes (or branches) a
    thread, in whole warps, 32 to 1024."""
    per = -(-max(n, n_branches, 1) // 4)
    return min(1024, max(32, -(-per // 32) * 32))


def _place_launch(cols: torch.Tensor, n_branches: int, has_service: bool,
                  n_tasks: int, variant: str) -> torch.Tensor:
    """Launch one of sched_place.cu's kernels on checked CUDA columns and
    count it.  `place_greedy` passes PLACE_VARIANT; only the card's tests
    and chip_smoke.py pass another, to hold the kernels side by side on
    the same columns."""
    n = cols.shape[1]
    rescan = variant == "rescan"
    choices = torch.empty(n_tasks, dtype=torch.int32, device=cols.device)
    words = _kernel("sched_place", "sched_place_scratch_words")(
        n, n_branches, int(rescan))
    scratch = torch.empty(words, dtype=torch.int32, device=cols.device) \
        if words else None
    _launch("sched_place", cols.device, cols.data_ptr(), n, n_tasks,
            n_branches, int(bool(has_service)),
            _rescan_threads(n, n_branches) if rescan
            else int(variant == "tree"), choices.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            name="sched_place_rescan" if rescan else "sched_place")
    _count("sched_place")
    _count(f"sched_place_{variant}")
    return choices


def place_greedy(cols: torch.Tensor, n_branches: int, has_service: bool,
                 n_tasks: int) -> torch.Tensor:
    """Greedy placement of `n_tasks` tasks of one spec over N encoded
    nodes; returns [n_tasks] int32 node indices, -1 where no node fits.

    cols: [6, N] int32, the rows of PLACE_COLUMNS (static_ok and taint 0
    or 1, cap already clamped, branch ids in [0, n_branches) or all 0
    with n_branches = 0 for no spread level).  Task i takes the feasible
    node (static_ok and fewer than cap tasks of the group so far) with
    the least (taint, count, active, index), inside the least-loaded
    spread branch (least (load, first feasible index)) when there is one;
    as the JAX package's place_group.  On the card, one launch of the
    tree kernel (an incremental argmin in one warp) runs every task."""
    if cols.dim() != 2 or cols.shape[0] != len(PLACE_COLUMNS) \
            or cols.dtype != torch.int32:
        raise ValueError(f"cols: expected int32 [{len(PLACE_COLUMNS)}, N], "
                         f"got {cols.dtype} {tuple(cols.shape)}")
    if not cols.is_contiguous():
        raise ValueError("cols must be contiguous")
    n = cols.shape[1]
    if n >= _NONE:
        raise ValueError(f"{n} nodes: node indices must stay below 2^30")
    if n_branches < 0 or n_tasks < 0:
        raise ValueError(f"n_branches={n_branches}, n_tasks={n_tasks} for "
                         f"{n} nodes")
    if cols.device.type == "cpu":
        return place_greedy_plain(cols, n_branches, has_service, n_tasks)
    if cols.device.type != "cuda":
        raise ValueError(f"no kernel for device {cols.device}")
    return _place_launch(cols, n_branches, has_service, n_tasks,
                         PLACE_VARIANT)
