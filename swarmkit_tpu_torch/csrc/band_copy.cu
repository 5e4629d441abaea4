// Masked in-place write-back of one ring chunk for both raft log buffers.
//
// Replaces the Pallas TPU kernel append_band_copy / _band_copy_kernel of
// the JAX package (parallel/pallas_ops.py), which the tick kernel's banded
// append pass calls once per buffer per band chunk.  Here one launch
// updates both buffers under one shared mask, in place:
//
//   term[i, off + c] = src_term[i, c] if write[i, c] else term[i, off + c]
//   data[i, off + c] = src_data[i, c] if write[i, c] else data[i, off + c]
//
// for i < n, c < width.  term and data are [n, ring] int32 rings (data holds
// uint32 payload bits; the copy never looks at values), src_* are [n, width]
// int32 and write is [n, width] bool (one byte per element).
//
// Bound: bytes.  There is no arithmetic to speak of, so the least time is
// the mask read plus, for the elements written, the source read and the
// ring write of both buffers, over device-memory bandwidth.  The design
// aims at that: a row-major grid-stride loop in which each thread takes
// four neighbouring columns of one row as one 16-byte vector (int4) per
// buffer and one 4-byte mask word, so a warp moves 512 contiguous bytes per
// buffer per access.  A mask word of zero skips the source read and the
// ring write entirely; a full mask word writes the source without reading
// the ring.  When the chunk offset, the width, the ring width or a base
// pointer is not 16-byte aligned the scalar loop runs instead.  No shared
// memory, TMA or wgmma: nothing is reused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // H100 SMs x resident blocks

__global__ void band_copy_vec4(int32_t* __restrict__ term,
                               int32_t* __restrict__ data,
                               const int32_t* __restrict__ src_term,
                               const int32_t* __restrict__ src_data,
                               const uint8_t* __restrict__ write,
                               int64_t n, int64_t ring, int64_t off,
                               int64_t width) {
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
    if (m == 0x01010101u) {
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

__global__ void band_copy_scalar(int32_t* __restrict__ term,
                                 int32_t* __restrict__ data,
                                 const int32_t* __restrict__ src_term,
                                 const int32_t* __restrict__ src_data,
                                 const uint8_t* __restrict__ write,
                                 int64_t n, int64_t ring, int64_t off,
                                 int64_t width) {
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() right after the launch.
extern "C" int band_copy(void* term, void* data, const void* src_term,
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
    band_copy_vec4<<<blocks_for(n * (width / 4)), kThreads, 0, st>>>(
        static_cast<int32_t*>(term), static_cast<int32_t*>(data),
        static_cast<const int32_t*>(src_term),
        static_cast<const int32_t*>(src_data),
        static_cast<const uint8_t*>(write), n, ring, off, width);
  } else {
    band_copy_scalar<<<blocks_for(n * width), kThreads, 0, st>>>(
        static_cast<int32_t*>(term), static_cast<int32_t*>(data),
        static_cast<const int32_t*>(src_term),
        static_cast<const int32_t*>(src_data),
        static_cast<const uint8_t*>(write), n, ring, off, width);
  }
  return (int)cudaGetLastError();
}
