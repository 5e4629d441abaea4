// Masked in-place write-back of one ring chunk for both raft log buffers.
//
// Replaces the Pallas TPU kernel append_band_copy / _band_copy_kernel of
// the JAX package (swarmkit_tpu/parallel/pallas_ops.py:169-211, its
// pallas_call at :203), which the tick kernel's banded append pass calls
// once per buffer per band chunk.  Here one launch updates both buffers
// under one shared mask, in place:
//
//   term[i, off + c] = src_term[i, c] if write[i, c] else term[i, off + c]
//   data[i, off + c] = src_data[i, c] if write[i, c] else data[i, off + c]
//
// for i < n, c < width.  term and data are [n, ring] int32 rings (data holds
// uint32 payload bits; the copy never looks at values), src_* are [n, width]
// int32 and write is [n, width] bool (one byte per element).
//
// Bound: bytes.  There is no arithmetic to speak of, so the least time is
// the mask read once plus, for each written element, its two int32 sources
// read and its two ring slots written, over device-memory bandwidth
// (chip_smoke.py's band_bytes).  Where few elements are written the mask is
// most of it: the model checker's [3145728, 32] pass writes 1.3% of its
// elements, so its 100.7 MB mask is 83% of that bound.  What the design
// does about it:
//
//   - On the flat and chunk paths a warp takes a tile of 512 elements:
//     each lane reads 16 mask bytes (16 elements) as one uint4, so a warp
//     reads 512 contiguous mask bytes in one access, and a tile with no
//     set byte costs that access alone.
//   - Lane-contiguous sources and rings.  A tile with writes goes through
//     shared memory (512 bytes a warp): lane l then takes the 4-element
//     words l, 32 + l, 64 + l and 96 + l, so the warp reads and writes its
//     sources and rings 512 contiguous bytes an access (16 bytes a lane,
//     four accesses in flight a lane), and whole 32-byte sectors where a
//     word is fully set.  A lane that took its own 16 elements writes
//     half-sectors with each 16-byte store: on the H100 that wrote the
//     whole [3145728, 32] ring in 1.0245 ms against this kernel's 0.5653.
//   - Writes read no ring.  A word whose four mask bytes are all set stores
//     its sources as one int4 a buffer; a partly set word stores only its
//     written elements (4-byte stores).  Sources are read as int4s, and
//     only for words with a set byte.  Reading a partly written word's
//     sector back to write it whole was slower on the model checker's
//     pass (0.2529 against 0.2434 ms).
//   - flat (off == 0 and width == ring, from 2^20 elements up: the
//     untiled whole-ring write of the batched tools and the model checker,
//     and the tiled tick's full-pass fallback at full width): mask,
//     sources and rings are one flat array of n * ring elements and a
//     tile is 512 of them, indexed with no row or column arithmetic.  The
//     last n * ring % 16 elements are written one by one.
//   - words (a whole ring below cuda_ops.py's FLAT_TILES_MIN, 2^20
//     elements: fault_sweep, the differential sweep, the DST sweep at
//     S=256): one 4-element word a thread, its 4-byte mask read and then,
//     where a byte is set, its int4 sources.  Such rings take about the
//     launch floor, where the tile's vote and shared-memory step lengthen
//     the chain of dependent reads: 0.0017 against the tiles' 0.0023 ms
//     on fault_sweep's [40, 64] ring and on the differential sweep's
//     [128, 128] (the first version 0.0019); from [3072, 512] up the two
//     are level, and a 100 MB mask with no set byte streams 1.8 times as
//     fast in tiles (0.0343 against 0.0618 ms).
//   - chunk (a tiled chunk: width a multiple of 16, off and ring multiples
//     of 4): the grid is row groups by 512-element column tiles, and a warp
//     takes one row's tile, or 32 / (width / 16) whole rows where the width
//     is under 512, so a lane's row and column come from its block, warp
//     and lane (one division of the lane index a thread), never from
//     dividing an element index.  After the shared-memory step a lane takes
//     each word's source and ring offset from the lane that read its mask
//     (a warp shuffle).
//   - scalar (any other offset, width, ring or base alignment): a 2-D grid
//     of rows by columns, one element a thread.
//   - Indices are 32-bit wherever n * max(ring, width) fits in 31 bits
//     (every shape the port runs), else 64-bit.
//   - The grid covers the work once, a warp a tile, and the block scheduler
//     keeps every SM full as blocks finish.  A stride loop over one wave of
//     blocks (the SM count times the blocks an SM holds) was measured
//     slower: it serialises each thread's dependent mask-then-source reads,
//     which the model checker's scattered writes feel most (0.2691 against
//     0.2434 ms for the same tile).
//   - What bounds the model checker's pass instead: its 1.29 M written
//     elements lie one to a row, so each costs a whole 32-byte sector of
//     both sources and both rings, 0.0794 ms at 3.35 TB/s before any
//     other cost (chip_smoke.py's band_sector_bytes); storing those partly
//     written sectors, beyond the mask read, takes 0.149 ms of the
//     kernel's 0.2434.
//   - No TMA or wgmma: nothing is read twice.
// The figures are tools/band_copy_probe.py's, on an H100 80GB HBM3 at
// 700 W; that file keeps each variant named here.
//
// ptxas -v for sm_90a (CUDA 12.8, on the H100's machine): band_copy_flat
// 48 registers with 32-bit indices (63 with 64-bit), band_copy_chunk 64
// (63), both 4,096 bytes of static shared memory; band_copy_words 32
// (20), band_copy_scalar 19 (22); the first version 30 and 30; no stack
// frame and no spills.
//
// band_copy_v1 below is the first design, kept as the yardstick that
// chip_smoke.py times beside this one and never on the path: a row-major
// grid-stride loop over 4-column vectors (one 4-byte mask word a thread, a
// 64-bit division for each vector's row), a grid of at most 132 x 16
// blocks, and partly written vectors that read the ring back before they
// write it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kFull = 0x01010101u;     // four set bool bytes

enum Path { kFlat = 0, kChunk = 1, kScalar = 2, kWords = 3 };

__device__ __forceinline__ bool nonzero(uint4 m) {
  return (m.x | m.y | m.z | m.w) != 0u;
}

// Elements [0, 4) of both rings at t and x take the sources a and b where
// the bytes of mask word w (not zero) are set: one int4 a buffer when all
// four are, else 4-byte stores of the written elements only.
__device__ __forceinline__ void store_word(int32_t* t, int32_t* x, int4 a,
                                           int4 b, uint32_t w) {
  if (w == kFull) {
    *reinterpret_cast<int4*>(t) = a;
    *reinterpret_cast<int4*>(x) = b;
    return;
  }
  if (w & 0x000000FFu) { t[0] = a.x; x[0] = b.x; }
  if (w & 0x0000FF00u) { t[1] = a.y; x[1] = b.y; }
  if (w & 0x00FF0000u) { t[2] = a.z; x[2] = b.z; }
  if (w & 0xFF000000u) { t[3] = a.w; x[3] = b.w; }
}

// One warp's 512-element tile.  m is this lane's 16 mask bytes (zero for a
// lane past the work).  Flat: s is the tile's first element, in the sources
// and the rings alike.  Chunk: s and d are this lane's 16 elements' first
// offsets in the sources and the rings.  sm is the warp's 128 words.
template <bool Flat, typename I>
__device__ __forceinline__ void put_tile(
    uint32_t* sm, uint4 m, I s, I d, int lane, int32_t* __restrict__ term,
    int32_t* __restrict__ data, const int32_t* __restrict__ src_term,
    const int32_t* __restrict__ src_data) {
  if (!__any_sync(kAll, nonzero(m))) return;
  reinterpret_cast<uint4*>(sm)[lane] = m;
  __syncwarp();
  uint32_t w[4];
  I su[4], du[4];
  int4 a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // word 32k + lane: the (lane & 3)-th word of lane 8k + lane / 4's 16
    w[k] = sm[32 * k + lane];
    if (Flat) {
      su[k] = du[k] = s + 4 * (32 * k + lane);
    } else {
      const int from = 8 * k + (lane >> 2);
      su[k] = __shfl_sync(kAll, s, from) + 4 * (lane & 3);
      du[k] = __shfl_sync(kAll, d, from) + 4 * (lane & 3);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (w[k] == 0u) continue;
    a[k] = __ldg(reinterpret_cast<const int4*>(src_term + su[k]));
    b[k] = __ldg(reinterpret_cast<const int4*>(src_data + su[k]));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (w[k] != 0u) store_word(term + du[k], data + du[k], a[k], b[k], w[k]);
  __syncwarp();   // the words are read before the next tile's land
}

// off == 0 and width == ring: `total` = n * ring elements, one flat array;
// a warp a 512-element tile.
template <typename I>
__global__ void __launch_bounds__(kThreads)
band_copy_flat(int32_t* __restrict__ term, int32_t* __restrict__ data,
               const int32_t* __restrict__ src_term,
               const int32_t* __restrict__ src_data,
               const uint8_t* __restrict__ write, I total) {
  __shared__ __align__(16) uint32_t sm[kWarps][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const I tile = (I)blockIdx.x * kWarps + warp;
  const I v = tile * 32 + lane;   // this lane's 16 elements
  const I vecs = total >> 4;
  const uint4 m = v < vecs ? __ldg(reinterpret_cast<const uint4*>(write) + v)
                           : make_uint4(0u, 0u, 0u, 0u);
  put_tile<true, I>(sm[warp], m, tile * 512, tile * 512, lane, term, data,
                    src_term, src_data);
  const I e = (vecs << 4) + (I)threadIdx.x;   // the last total % 16
  if (blockIdx.x == 0 && e < total && write[e]) {
    term[e] = src_term[e];
    data[e] = src_data[e];
  }
}

// A whole ring below FLAT_TILES_MIN elements (cuda_ops.py): one 4-element
// word a thread, `total` = n * ring elements, one flat array.
template <typename I>
__global__ void __launch_bounds__(kThreads)
band_copy_words(int32_t* __restrict__ term, int32_t* __restrict__ data,
                const int32_t* __restrict__ src_term,
                const int32_t* __restrict__ src_data,
                const uint8_t* __restrict__ write, I total) {
  const I g = (I)blockIdx.x * kThreads + threadIdx.x;   // this word
  const I words = total >> 2;
  if (g < words) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(write) + g);
    if (w != 0u)
      store_word(term + 4 * g, data + 4 * g,
                 __ldg(reinterpret_cast<const int4*>(src_term) + g),
                 __ldg(reinterpret_cast<const int4*>(src_data) + g), w);
  }
  const I e = (words << 2) + (I)threadIdx.x;   // the last total % 4
  if (blockIdx.x == 0 && e < total && write[e]) {
    term[e] = src_term[e];
    data[e] = src_data[e];
  }
}

// A chunk of 16-element vectors, `vecs` a row.  blockIdx.y is a 32-vector
// column tile, blockIdx.x a group of kWarps * rows rows; a warp takes
// `rows` rows of `lanes` lanes each (rows = 1, lanes = 32 where a row has
// 32 vectors or more; else lanes = vecs, rows = 32 / vecs).
template <typename I>
__global__ void __launch_bounds__(kThreads)
band_copy_chunk(int32_t* __restrict__ term, int32_t* __restrict__ data,
                const int32_t* __restrict__ src_term,
                const int32_t* __restrict__ src_data,
                const uint8_t* __restrict__ write, I n, I ring, I off,
                I width, int lanes, int rows) {
  __shared__ __align__(16) uint32_t sm[kWarps][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane / lanes;
  const I row = ((I)blockIdx.x * kWarps + warp) * rows + lr;
  const I col = (I)blockIdx.y * 32 + (lane - lr * lanes);   // a vector
  const bool in = lr < rows && row < n && col < (width >> 4);
  const I s = in ? row * width + (col << 4) : 0;
  const I d = in ? row * ring + off + (col << 4) : 0;
  const uint4 m = in ? __ldg(reinterpret_cast<const uint4*>(write + s))
                     : make_uint4(0u, 0u, 0u, 0u);
  put_tile<false, I>(sm[warp], m, s, d, lane, term, data, src_term,
                     src_data);
}

// Any alignment: blockDim.x over a row's columns (stepping by blockDim.x
// past 256), blockDim.y over rows.
template <typename I>
__global__ void __launch_bounds__(kThreads)
band_copy_scalar(int32_t* __restrict__ term, int32_t* __restrict__ data,
                 const int32_t* __restrict__ src_term,
                 const int32_t* __restrict__ src_data,
                 const uint8_t* __restrict__ write, I n, I ring, I off,
                 I width) {
  const I row = (I)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;
  for (I c = threadIdx.x; c < width; c += blockDim.x) {
    if (!write[row * width + c]) continue;
    term[row * ring + off + c] = src_term[row * width + c];
    data[row * ring + off + c] = src_data[row * width + c];
  }
}

__global__ void band_copy_empty() {}

// ---- the first version: the yardstick, never on the path -----------------

constexpr int kV1MaxBlocks = 132 * 16;  // H100 SMs x resident blocks

__global__ void v1_vec4(int32_t* __restrict__ term,
                        int32_t* __restrict__ data,
                        const int32_t* __restrict__ src_term,
                        const int32_t* __restrict__ src_data,
                        const uint8_t* __restrict__ write, int64_t n,
                        int64_t ring, int64_t off, int64_t width) {
  const int64_t groups = width / 4;
  const int64_t total = n * groups;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       v < total; v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = v / groups;
    const int64_t col = (v - row * groups) * 4;
    const int64_t s = row * width + col;
    const uint32_t m = *reinterpret_cast<const uint32_t*>(write + s);
    if (m == 0u) continue;
    const int64_t d = row * ring + off + col;
    const int4 st = *reinterpret_cast<const int4*>(src_term + s);
    const int4 sd = *reinterpret_cast<const int4*>(src_data + s);
    int4* pt = reinterpret_cast<int4*>(term + d);
    int4* pd = reinterpret_cast<int4*>(data + d);
    if (m == kFull) {
      *pt = st;
      *pd = sd;
      continue;
    }
    int4 t = *pt;
    int4 x = *pd;
    if (m & 0x000000FFu) { t.x = st.x; x.x = sd.x; }
    if (m & 0x0000FF00u) { t.y = st.y; x.y = sd.y; }
    if (m & 0x00FF0000u) { t.z = st.z; x.z = sd.z; }
    if (m & 0xFF000000u) { t.w = st.w; x.w = sd.w; }
    *pt = t;
    *pd = x;
  }
}

__global__ void v1_scalar(int32_t* __restrict__ term,
                          int32_t* __restrict__ data,
                          const int32_t* __restrict__ src_term,
                          const int32_t* __restrict__ src_data,
                          const uint8_t* __restrict__ write, int64_t n,
                          int64_t ring, int64_t off, int64_t width) {
  const int64_t total = n * width;
  for (int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       s < total; s += (int64_t)gridDim.x * blockDim.x) {
    if (!write[s]) continue;
    const int64_t row = s / width;
    const int64_t d = row * ring + off + (s - row * width);
    term[d] = src_term[s];
    data[d] = src_data[s];
  }
}

int v1_blocks(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  if (b > kV1MaxBlocks) b = kV1MaxBlocks;
  return b < 1 ? 1 : (int)b;
}

// ---- launching ----------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename I>
void launch_path(int path, int32_t* term, int32_t* data,
                 const int32_t* src_term, const int32_t* src_data,
                 const uint8_t* write, long long n, long long ring,
                 long long off, long long width, cudaStream_t st) {
  if (path == kFlat) {
    const long long total = n * ring;
    const long long grid = cdiv(cdiv(total / 16, 32), kWarps);
    band_copy_flat<I><<<(unsigned)(grid > 0 ? grid : 1), kThreads, 0, st>>>(
        term, data, src_term, src_data, write, (I)total);
  } else if (path == kWords) {
    const long long total = n * ring;
    const long long grid = cdiv(total / 4, kThreads);
    band_copy_words<I><<<(unsigned)(grid > 0 ? grid : 1), kThreads, 0, st>>>(
        term, data, src_term, src_data, write, (I)total);
  } else if (path == kChunk) {
    const long long vecs = width / 16;
    const int lanes = vecs < 32 ? (int)vecs : 32;
    const int rows = 32 / lanes;
    const dim3 grid((unsigned)cdiv(n, (long long)kWarps * rows),
                    (unsigned)cdiv(vecs, 32));
    band_copy_chunk<I><<<grid, kThreads, 0, st>>>(
        term, data, src_term, src_data, write, (I)n, (I)ring, (I)off,
        (I)width, lanes, rows);
  } else {
    const int tx = width < kThreads ? (int)width : kThreads;
    const dim3 block(tx, kThreads / tx);
    band_copy_scalar<I><<<(unsigned)cdiv(n, block.y), block, 0, st>>>(
        term, data, src_term, src_data, write, (I)n, (I)ring, (I)off,
        (I)width);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() right after the
// launch (cudaErrorInvalidValue, launching nothing, for a path whose
// conditions the arguments do not meet).
//
// `path` is the caller's choice (parallel/cuda_ops.py band_copy_path):
// 0 flat, 1 chunk, 2 scalar, 3 words.
extern "C" int band_copy(void* term, void* data, const void* src_term,
                         const void* src_data, const void* write,
                         long long n, long long ring, long long off,
                         long long width, int path, void* stream) {
  if (n <= 0 || width <= 0) return (int)cudaGetLastError();
  const bool aligned = aligned16(term) && aligned16(data) &&
                       aligned16(src_term) && aligned16(src_data) &&
                       aligned16(write);
  const bool ok =
      path == kScalar ||
      ((path == kFlat || path == kWords) && aligned && off == 0 &&
       width == ring) ||
      (path == kChunk && aligned && width % 16 == 0 && off % 4 == 0 &&
       ring % 4 == 0 && width / 16 <= 32LL * 65535);   // grid.y's limit
  if (!ok || off < 0 || off + width > ring) return (int)cudaErrorInvalidValue;
  const long long wide = ring > width ? ring : width;
  const bool small = n <= INT32_MAX / wide;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int32_t* t = static_cast<int32_t*>(term);
  int32_t* x = static_cast<int32_t*>(data);
  const int32_t* a = static_cast<const int32_t*>(src_term);
  const int32_t* b = static_cast<const int32_t*>(src_data);
  const uint8_t* w = static_cast<const uint8_t*>(write);
  if (small) {
    launch_path<int32_t>(path, t, x, a, b, w, n, ring, off, width, st);
  } else {
    launch_path<int64_t>(path, t, x, a, b, w, n, ring, off, width, st);
  }
  return (int)cudaGetLastError();
}

// The first version, same arguments but the path (it picks its own).
extern "C" int band_copy_v1(void* term, void* data, const void* src_term,
                            const void* src_data, const void* write,
                            long long n, long long ring, long long off,
                            long long width, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || width <= 0) return (int)cudaGetLastError();
  const bool vec = width % 4 == 0 && off % 4 == 0 && ring % 4 == 0 &&
                   aligned16(term) && aligned16(data) &&
                   aligned16(src_term) && aligned16(src_data) &&
                   (reinterpret_cast<uintptr_t>(write) & 3u) == 0;
  if (vec) {
    v1_vec4<<<v1_blocks(n * (width / 4)), kThreads, 0, st>>>(
        static_cast<int32_t*>(term), static_cast<int32_t*>(data),
        static_cast<const int32_t*>(src_term),
        static_cast<const int32_t*>(src_data),
        static_cast<const uint8_t*>(write), n, ring, off, width);
  } else {
    v1_scalar<<<v1_blocks(n * width), kThreads, 0, st>>>(
        static_cast<int32_t*>(term), static_cast<int32_t*>(data),
        static_cast<const int32_t*>(src_term),
        static_cast<const int32_t*>(src_data),
        static_cast<const uint8_t*>(write), n, ring, off, width);
  }
  return (int)cudaGetLastError();
}

// An empty kernel of one block: the launch floor that chip_smoke.py times
// beside the band copy.
extern "C" int band_copy_empty_launch(void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  band_copy_empty<<<1, kThreads, 0, st>>>();
  return (int)cudaGetLastError();
}
