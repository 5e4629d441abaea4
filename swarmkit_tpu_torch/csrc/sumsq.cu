// Sum of squares of a contiguous tensor, as one f32 scalar.
//
// Replaces the Pallas TPU kernel sumsq / _rms_kernel of the JAX package
// (parallel/pallas_ops.py), which the executor's tpu://pallas_matmul
// program calls once per chain step to normalise the product.  The TPU
// kernel walks row tiles in sequence and carries the sum in SMEM; Hopper's
// blocks run in no order, so here the reduction takes two passes and no
// float atomics:
//
//   pass 1: each block of a fixed grid walks the tensor with a grid-stride
//           loop, squares the values in f32 (bf16 is widened exactly
//           first) and writes one f32 partial;
//   pass 2: one block adds the partials in a fixed tree order.
//
// The grid depends only on the element count and type, and each thread's
// share and every tree step are fixed, so two calls on the same input
// agree bit for bit.
//
// Bound: bytes.  Two flops per element against 2 (bf16) or 4 (f32) bytes
// read; at the executor's [8192, 8192] bf16 the least time is 128 MiB over
// 3.35 TB/s, ~0.04 ms.  Each thread reads 16 bytes per load and keeps two
// loads in flight, and the grid fills every SM with 2048 threads, so enough
// bytes are in flight to cover the memory latency.  An unaligned base
// pointer takes the scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // H100 SMs x resident 256-thread blocks
constexpr int kFinalThreads = 1024;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float load_f(const float* x, int64_t i) {
  return x[i];
}

__device__ __forceinline__ float load_f(const uint16_t* x, int64_t i) {
  return __uint_as_float((uint32_t)x[i] << 16);
}

__device__ __forceinline__ float sq_vec(const uint4& v, float acc, float) {
  acc = fmaf(__uint_as_float(v.x), __uint_as_float(v.x), acc);
  acc = fmaf(__uint_as_float(v.y), __uint_as_float(v.y), acc);
  acc = fmaf(__uint_as_float(v.z), __uint_as_float(v.z), acc);
  return fmaf(__uint_as_float(v.w), __uint_as_float(v.w), acc);
}

__device__ __forceinline__ float sq_vec(const uint4& v, float acc,
                                        uint16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float lo = bf16_lo(w[e]), hi = bf16_hi(w[e]);
    acc = fmaf(lo, lo, acc);
    acc = fmaf(hi, hi, acc);
  }
  return acc;
}

// Block-wide sum in a fixed order: shuffle tree inside each warp, then the
// first warp sums the warp totals.  Result valid in thread 0.
template <int Threads>
__device__ float block_sum(float v) {
  __shared__ float warp_sums[Threads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < Threads / 32 ? warp_sums[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

// T is float or uint16_t (bf16 bits).  Vectors of 16 bytes hold kVec
// elements; the tail past the last whole vector is read element-wise.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sumsq_partials(const T* __restrict__ x, int64_t n, bool vec,
                   float* __restrict__ partials) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  float acc0 = 0.0f, acc1 = 0.0f;
  int64_t done = 0;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int64_t nv = n / kVec;
    int64_t v = tid;
    for (; v + stride < nv; v += 2 * stride) {
      const uint4 p = xv[v], q = xv[v + stride];
      acc0 = sq_vec(p, acc0, T());
      acc1 = sq_vec(q, acc1, T());
    }
    if (v < nv) acc0 = sq_vec(xv[v], acc0, T());
    done = nv * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float f = load_f(x, i);
    acc0 = fmaf(f, f, acc0);
  }
  const float total = block_sum<kThreads>(acc0 + acc1);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
    sumsq_final(const float* __restrict__ partials, int count,
                float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < count; i += kFinalThreads) v += partials[i];
  v = block_sum<kFinalThreads>(v);
  if (threadIdx.x == 0) *out = v;
}

int blocks_for(int64_t n, int vec_elems) {
  const int64_t vecs = (n + vec_elems - 1) / vec_elems;
  int64_t b = (vecs + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

// Floats of scratch `sumsq` needs: the result, then one partial per block.
extern "C" int sumsq_scratch_floats() { return 1 + kMaxBlocks; }

// Plain C entry point (loaded with ctypes).  dtype 0 = float32, 1 =
// bfloat16; x is a contiguous tensor of n elements.  The sum lands in
// scratch[0]; scratch[1:] holds the partials.  Launches both passes on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int sumsq(const void* x, long long n, int dtype, void* scratch,
                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(scratch);
  float* partials = out + 1;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  int blocks;
  if (dtype == 1) {
    blocks = blocks_for(n, 8);
    sumsq_partials<uint16_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), n, vec, partials);
  } else if (dtype == 0) {
    blocks = blocks_for(n, 4);
    sumsq_partials<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, vec, partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sumsq_final<<<1, kFinalThreads, 0, st>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
