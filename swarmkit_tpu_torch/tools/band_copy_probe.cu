// Variants of the band copy (csrc/band_copy.cu, included below) that its
// design was measured against, and the parts of its memory traffic taken
// apart.  tools/band_copy_probe.py builds this file and times each variant
// beside the kernel on the model checker's pass; none is on any path.
//
//   loop     the flat kernel's tile in a stride loop over one wave of blocks
//            (SM count x the blocks an SM holds, from the occupancy API)
//   lane16   a lane takes its own 16 elements (uint4 of mask, four int4 of
//            each source and ring at a 64-byte lane stride), one-shot grid
//   paired   the flat tile, but a lane whose sector-mate lane (lane ^ 1) has
//            writes writes its own 4-element word whole, the ring read back
//            where its mask is not set, so the pair writes whole sectors
//   mask     the mask read alone
//   loads    the mask and the written words' sources read, nothing written
//   stores   the mask read and the written elements stored (constants), no
//            source read

#include "../csrc/band_copy.cu"

namespace {

enum Probe { kLoop = 0, kLane16, kPaired, kMask, kLoads, kStores };

__global__ void __launch_bounds__(kThreads)
probe_loop(int32_t* __restrict__ term, int32_t* __restrict__ data,
           const int32_t* __restrict__ src_term,
           const int32_t* __restrict__ src_data,
           const uint8_t* __restrict__ write, int total) {
  __shared__ __align__(16) uint32_t sm[kWarps][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vecs = total >> 4;
  for (int tile = blockIdx.x * kWarps + warp; tile * 32 < vecs;
       tile += gridDim.x * kWarps) {
    const int v = tile * 32 + lane;
    const uint4 m = v < vecs
                        ? __ldg(reinterpret_cast<const uint4*>(write) + v)
                        : make_uint4(0u, 0u, 0u, 0u);
    put_tile<true, int>(sm[warp], m, tile * 512, tile * 512, lane, term,
                        data, src_term, src_data);
  }
}

__global__ void __launch_bounds__(kThreads)
probe_lane16(int32_t* __restrict__ term, int32_t* __restrict__ data,
             const int32_t* __restrict__ src_term,
             const int32_t* __restrict__ src_data,
             const uint8_t* __restrict__ write, int total) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= (total >> 4)) return;
  const uint4 m = __ldg(reinterpret_cast<const uint4*>(write) + v);
  if (!nonzero(m)) return;
  const uint32_t w[4] = {m.x, m.y, m.z, m.w};
  const int4* a = reinterpret_cast<const int4*>(src_term) + 4 * v;
  const int4* b = reinterpret_cast<const int4*>(src_data) + 4 * v;
  int4 va[4], vb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (w[k]) {
      va[k] = __ldg(a + k);
      vb[k] = __ldg(b + k);
    }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (w[k])
      store_word(term + 16 * v + 4 * k, data + 16 * v + 4 * k, va[k], vb[k],
                 w[k]);
}

// One flat tile as put_tile, with the variant's memory traffic.
template <Probe P>
__device__ __forceinline__ void probe_tile(uint32_t* sm, uint4 m, int e0,
                                           int lane, int32_t* term,
                                           int32_t* data,
                                           const int32_t* src_term,
                                           const int32_t* src_data) {
  if (!__any_sync(kAll, nonzero(m))) return;
  reinterpret_cast<uint4*>(sm)[lane] = m;
  __syncwarp();
  uint32_t w[4];
  bool whole[4];
  int4 a[4], b[4], ot[4], ox[4];
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = sm[32 * k + lane];
    whole[k] = P == kPaired && w[k] != kFull &&
               (w[k] | sm[32 * k + (lane ^ 1)]) != 0u;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = e0 + 4 * (32 * k + lane);
    if (w[k] && P != kStores) {
      a[k] = __ldg(reinterpret_cast<const int4*>(src_term + e));
      b[k] = __ldg(reinterpret_cast<const int4*>(src_data + e));
      acc ^= a[k].x ^ a[k].y ^ a[k].z ^ a[k].w ^ b[k].x ^ b[k].y ^ b[k].z ^
             b[k].w;
    }
    if (whole[k]) {
      ot[k] = *reinterpret_cast<const int4*>(term + e);
      ox[k] = *reinterpret_cast<const int4*>(data + e);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = e0 + 4 * (32 * k + lane);
    if (P == kLoads) break;
    if (P == kStores) {
      if (w[k])
        store_word(term + e, data + e, make_int4(1, 2, 3, 4),
                   make_int4(5, 6, 7, 8), w[k]);
      continue;
    }
    if (w[k] == kFull || (w[k] && !whole[k])) {
      store_word(term + e, data + e, a[k], b[k], w[k]);
    } else if (whole[k]) {
      int4 t = ot[k], x = ox[k];
      if (w[k] & 0x000000FFu) { t.x = a[k].x; x.x = b[k].x; }
      if (w[k] & 0x0000FF00u) { t.y = a[k].y; x.y = b[k].y; }
      if (w[k] & 0x00FF0000u) { t.z = a[k].z; x.z = b[k].z; }
      if (w[k] & 0xFF000000u) { t.w = a[k].w; x.w = b[k].w; }
      *reinterpret_cast<int4*>(term + e) = t;
      *reinterpret_cast<int4*>(data + e) = x;
    }
  }
  if (P == kLoads && acc == 0x7fffffff) term[e0] = acc;   // keeps the reads
  __syncwarp();
}

template <Probe P>
__global__ void __launch_bounds__(kThreads)
probe_flat(int32_t* __restrict__ term, int32_t* __restrict__ data,
           const int32_t* __restrict__ src_term,
           const int32_t* __restrict__ src_data,
           const uint8_t* __restrict__ write, int total) {
  __shared__ __align__(16) uint32_t sm[kWarps][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kWarps + warp;
  const int v = tile * 32 + lane;
  const uint4 m = v < (total >> 4)
                      ? __ldg(reinterpret_cast<const uint4*>(write) + v)
                      : make_uint4(0u, 0u, 0u, 0u);
  if (P == kMask) {
    if ((m.x | m.y | m.z | m.w) & 0x02020202u) term[0] = 1;   // never
    return;
  }
  probe_tile<P>(sm[warp], m, tile * 512, lane, term, data, src_term,
                src_data);
}

}  // namespace

// Launch probe `probe` over a flat [total] array of int32 rings, sources
// and a bool mask (total a multiple of 16, below 2^31, bases 16-byte
// aligned), on `stream`; returns cudaGetLastError().
extern "C" int band_copy_probe(int probe, void* term, void* data,
                               const void* src_term, const void* src_data,
                               const void* write, long long total,
                               void* stream) {
  if (total % 16 != 0 || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int32_t* t = static_cast<int32_t*>(term);
  int32_t* x = static_cast<int32_t*>(data);
  const int32_t* a = static_cast<const int32_t*>(src_term);
  const int32_t* b = static_cast<const int32_t*>(src_data);
  const uint8_t* w = static_cast<const uint8_t*>(write);
  const int n = (int)total;
  const int tiles_grid = (int)cdiv(cdiv(total / 16, 32), kWarps);
  switch (probe) {
    case kLoop: {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_loop,
                                                    kThreads, 0);
      const int wave = sms * (per_sm > 0 ? per_sm : 1);
      const int grid = tiles_grid < wave ? tiles_grid : wave;
      probe_loop<<<grid, kThreads, 0, st>>>(t, x, a, b, w, n);
      break;
    }
    case kLane16:
      probe_lane16<<<(int)cdiv(total / 16, kThreads), kThreads, 0, st>>>(
          t, x, a, b, w, n);
      break;
    case kPaired:
      probe_flat<kPaired><<<tiles_grid, kThreads, 0, st>>>(t, x, a, b, w, n);
      break;
    case kMask:
      probe_flat<kMask><<<tiles_grid, kThreads, 0, st>>>(t, x, a, b, w, n);
      break;
    case kLoads:
      probe_flat<kLoads><<<tiles_grid, kThreads, 0, st>>>(t, x, a, b, w, n);
      break;
    case kStores:
      probe_flat<kStores><<<tiles_grid, kThreads, 0, st>>>(t, x, a, b, w, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
