// Tiled matrix product out[M, N] = a[M, K] @ b[K, N], all row-major.
//
// Replaces the Pallas TPU kernel matmul / _mm_kernel of the JAX package
// (parallel/pallas_ops.py), which the executor's tpu://pallas_matmul
// program calls once per chain step.  Same contract: the products are
// accumulated in f32 and rounded once, at the end, to the output type
// (round-to-nearest-even for bf16, as JAX's astype).  Nothing is carried
// over from the TPU kernel's grid: its K-innermost sequential sweep with a
// VMEM accumulator becomes a K loop inside each block, with the f32
// accumulator in registers.
//
// Bound: operations.  At the executor's [8192]^3 bf16 step the product is
// 1.10 TFLOP against 0.4 GB of operands and result, ~9x past the H100's
// ridge point, so the tensor cores are the limit.
//
// bf16 (the executor's type): a 128x128 output tile per block of 8 warps,
// K in slices of 32.  Each warp owns a 64x32 sub-tile as 4x2 WMMA
// m16n16k16 fragments (bf16 in, f32 accumulate).  A and B slices go to
// shared memory through 16-byte cp.async, double-buffered, so the next
// slice's load overlaps this slice's products; rows are padded by 8
// elements against bank conflicts.  This is the simple right kernel:
// mma.sync-class tensor-core instructions, not Hopper's wgmma/TMA, which
// are what a faster version needs.
//
// f32 (tests only): CUDA-core FMA, a 64x64 tile per 256-thread block, each
// thread 4x4 outputs, K in slices of 16 through shared memory.  No TF32:
// every product and sum is full f32.
//
// Edges: every global load is predicated on the M, N and K edges and fills
// the tile with zeros, and every store on the M and N edges, so any shape
// runs.  The 16-byte loads need K (for A) or N (for B) to be a multiple of
// 8 and the base pointers 16-byte aligned; otherwise those tiles are loaded
// element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---- bf16: WMMA tensor cores --------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int WM = 64, WN = 32;          // warp sub-tile: 2 x 4 warps
constexpr int FM = WM / 16, FN = WN / 16;  // 4 x 2 fragments per warp
constexpr int A_LD = BK + 8;             // padded row pitch, elements
constexpr int B_LD = BN + 8;
constexpr int kVecs = (BM * BK) / 8;     // 16-byte vectors per A slice
static_assert(kVecs == (BK * BN) / 8, "A and B slices differ in size");
static_assert(kVecs % kThreads == 0, "slice not a whole number of rounds");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 8-element row piece of a tile: src points at element (row, col) of a
// [rows, cols] row-major matrix; `vec` says 16-byte loads are allowed.
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int64_t row,
                                      int64_t rows, int64_t col,
                                      int64_t cols, bool vec) {
  if (row < rows && vec && col + 8 <= cols) {
    cp_async16(dst, src + row * cols + col);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (row < rows && col + e < cols) ? src[row * cols + col + e]
                                             : zero;
  }
}

__device__ __forceinline__ void load_slices(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* a,
    const __nv_bfloat16* b, int64_t m0, int64_t n0, int64_t k0, int64_t M,
    int64_t N, int64_t K, bool vec_a, bool vec_b) {
#pragma unroll
  for (int r = 0; r < kVecs / kThreads; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int ar = v / (BK / 8), ac = (v % (BK / 8)) * 8;
    load8(as + ar * A_LD + ac, a, m0 + ar, M, k0 + ac, K, vec_a);
    const int br = v / (BN / 8), bc = (v % (BN / 8)) * 8;
    load8(bs + br * B_LD + bc, b, k0 + br, K, n0 + bc, N, vec_b);
  }
}

__global__ void __launch_bounds__(kThreads)
    mm_bf16_wmma(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ out, int64_t M, int64_t N,
                 int64_t K, bool vec_a, bool vec_b) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float stage[kWarps][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int64_t slices = (K + BK - 1) / BK;
  load_slices(As[0], Bs[0], a, b, m0, n0, 0, M, N, K, vec_a, vec_b);
  cp_async_commit();
  for (int64_t s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) {
      load_slices(As[cur ^ 1], Bs[cur ^ 1], a, b, m0, n0, (s + 1) * BK, M,
                  N, K, vec_a, vec_b);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As[cur] + (wm * WM + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs[cur] + kk * B_LD + wn * WN + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next round's loads overwrite this buffer
  }

  // Epilogue: each fragment goes through the warp's 16x16 f32 stage, is
  // rounded once to bf16 and stored where it lies inside [M, N].
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t r0 = m0 + wm * WM + i * 16, c0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int64_t r = r0 + e / 16, c = c0 + e % 16;
        if (r < M && c < N) out[r * N + c] = __float2bfloat16_rn(st[e]);
      }
      __syncwarp();
    }
  }
}

// ---- f32: CUDA-core FMA -------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    mm_f32_simt(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int64_t M, int64_t N, int64_t K) {
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = (int64_t)blockIdx.y * FBM, n0 = (int64_t)blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int r = 0; r < (FBM * FBK) / kFThreads; ++r) {
      const int v = threadIdx.x + r * kFThreads;
      const int am = v / FBK, ak = v % FBK;
      const int64_t gm = m0 + am, gk = k0 + ak;
      As[ak][am] = (gm < M && gk < K) ? a[gm * K + gk] : 0.0f;
      const int bk = v / FBN, bn = v % FBN;
      const int64_t hk = k0 + bk, hn = n0 + bn;
      Bs[bk][bn] = (hk < K && hn < N) ? b[hk * N + hn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx + 16 * j;
      if (r < M && c < N) out[r * N + c] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype 0 = float32, 1 =
// bfloat16; a, b and out are contiguous row-major tensors of that type.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() right after the launch.
extern "C" int matmul(const void* a, const void* b, void* out, long long m,
                      long long n, long long k, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (dtype == 1) {
    const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    mm_bf16_wmma<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), m, n, k,
        k % 8 == 0 && aligned16(a), n % 8 == 0 && aligned16(b));
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((n + FBN - 1) / FBN),
                    (unsigned)((m + FBM - 1) / FBM));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    mm_f32_simt<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(a),
                                            static_cast<const float*>(b),
                                            static_cast<float*>(out), m, n, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
