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
// ridge point, so the tensor cores are the limit.  Three kernels; the
// wrapper (parallel/cuda_ops.py::_matmul_variant) picks one from the shape:
//
// bf16, TMA-able (K and N multiples of 8, 16-byte aligned bases; the
// executor's case): mm_bf16_wgmma, built for the tensor cores' only
// full-rate path on Hopper, the asynchronous warpgroup product (wgmma).
// - A 128x256 output tile per block, K in slices of 64 (64 bf16 = 128
//   bytes, one row of the 128-byte swizzle).  128x256 is the largest tile
//   two m64n256k16 warpgroups cover, and it reads the fewest operand bytes
//   per product from L2.
// - Three warpgroups.  WG0 is the producer: it gives up registers
//   (setmaxnreg.dec to 40) and one thread issues TMA loads
//   (cp.async.bulk.tensor) into a 4-stage ring in dynamic shared memory
//   (48 KB a stage: A [128, 64] and B [64, 256]; 192 KB in all), with a
//   full and an empty mbarrier per stage.  WG1 and WG2 are consumers
//   (setmaxnreg.inc to 232): each owns 64 rows x 256 columns, 128 f32
//   accumulators per thread, and issues 4 wgmma.m64n256k16 per stage
//   straight from shared memory, keeping one group in flight; a stage goes
//   back to the producer once the group that read it has retired.  Loads
//   never stall the products, operands never pass through registers, and
//   a stage needs no block barrier.
// - A is K-major in a {64 K, 128 M} box.  B is read as it lies, [K, N]
//   with N contiguous (MN-major, wgmma's transpose bit), as 4 boxes of
//   {64 N, 64 K}: the 128-byte swizzle caps a box's inner extent at 128
//   bytes.  Both are 128-byte swizzled by TMA, which the descriptors name.
// - TMA fills out-of-bounds elements with zeros, so the M, N and K edges
//   need no masking on the load side; the epilogue rounds each f32 pair
//   to bf16x2 and stores it from registers, predicated on the M and N
//   edges.
// - One block per SM (the ring fills shared memory).  Tiles are ordered
//   in groups of 8 M-tiles so that blocks running together share A and B
//   panels in the 50 MB L2.
//
// bf16, other shapes: mm_bf16_wmma, the first port's kernel: a 128x128
// output tile per block of 8 warps, K in slices of 32.  Each warp owns a
// 64x32 sub-tile as 4x2 WMMA m16n16k16 fragments (bf16 in, f32
// accumulate).  A and B slices go to shared memory through 16-byte
// cp.async, double-buffered; rows are padded by 8 elements against bank
// conflicts.  Every global load is predicated on the M, N and K edges and
// fills the tile with zeros, and every store on the M and N edges, so any
// shape runs; shapes whose rows break 16-byte alignment load element by
// element.
//
// f32 (tests only): mm_f32_simt, CUDA-core FMA, a 64x64 tile per
// 256-thread block, each thread 4x4 outputs, K in slices of 16 through
// shared memory.  No TF32: every product and sum is full f32.
//
// The tensor maps are encoded on the host for each call by
// cuTensorMapEncodeTiled, fetched from libcuda at run time through
// cudaGetDriverEntryPointByVersion (CUDA 12.5 or later), so the library
// links against nothing but the CUDA runtime.

#include <cuda.h>  // CUtensorMap and its enums only; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---- bf16: warp-specialised wgmma + TMA ---------------------------------

namespace wg {

constexpr int BM = 128, BN = 256, BK = 64, kStages = 4, kGroupM = 8;
constexpr int kThreads = 384;                  // producer + 2 consumer WGs
constexpr int kBoxN = 64;                      // B box width: 128 bytes
constexpr int kABytes = BM * BK * 2;           // 16 KB
constexpr int kBBoxBytes = kBoxN * BK * 2;     // 8 KB
constexpr int kBBytes = (BN / kBoxN) * kBBoxBytes;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
// the ring, the 2 x kStages mbarriers, and room to align the ring to the
// 1024-byte swizzle atom
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
// descriptor strides, bytes: A (K-major) steps 8 rows of 128 bytes; B
// (MN-major) steps 8 K-rows (SBO) and one 64-wide N box (LBO)
constexpr uint32_t kASbo = 1024, kBSbo = 1024, kBLbo = kBBoxBytes;
constexpr uint32_t kAStepK = 16 * 2;           // 16 K-columns of a row
constexpr uint32_t kBStepK = 16 * kBoxN * 2;   // 16 K-rows of a box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// d[64 x 256] += A[64 x 16] (K-major) @ B[16 x 256] (MN-major), f32.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, "
      // scale-d p (accumulate), scale-a/b 1, A K-major, B MN-major
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    mm_bf16_wgmma(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the ring starts on a 1024-byte boundary: the swizzle repeats every
  // 8 rows of 128 bytes, and the descriptors assume it starts there
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_ring = ring, b_ring = ring + kStages * kABytes;
  const uint32_t full = ring + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile order: groups of kGroupM M-tiles sweep the N-tiles together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int group = blockIdx.x / per_group, in_group = blockIdx.x % per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int slices = (K + BK - 1) / BK;

  // One if/else for the roles, never rejoined: ptxas then knows each
  // branch's register count and honours setmaxnreg.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < slices; ++kt) {
        mbar_wait(empty + 8 * s, phase ^ 1);  // first round: free
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kStageBytes);   // out-of-bounds zeros count too
        tma_load(a_ring + s * kABytes, &map_a, bar, kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j)
          tma_load(b_ring + s * kBBytes + j * kBBoxBytes, &map_b, bar,
                   n0 + j * kBoxN, kt * BK);
        if (++s == kStages) s = 0, phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;  // consumer 0: rows 0-63, 1: 64-127
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < slices; ++kt) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = a_ring + s * kABytes + c * 64 * BK * 2;
      const uint32_t b = b_ring + s * kBBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(d, desc(a + kk * kAStepK, 0, kASbo),
                         desc(b + kk * kBStepK, kBLbo, kBSbo));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous slice's group has retired: its stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == kStages) s = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // d[4j + e] holds row r0 + 8 * (e / 2), column 8j + 2 * (lane % 4) +
    // e % 2 of this warpgroup's 64 x 256 block
    const int r0 = m0 + c * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;  // N is even, so col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * N + col) =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's encoder, looked up once; null if libcuda lacks it.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] bf16 matrix read in {box_cols, box_rows} boxes,
// 128-byte swizzled, out-of-bounds elements read as zero.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base,
                int64_t rows, int64_t cols, uint32_t box_cols,
                uint32_t box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Lifts the kernel's dynamic shared-memory limit, once per device.
cudaError_t allow_ring() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  rc = cudaFuncSetAttribute(mm_bf16_wgmma,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmemBytes);
  if (rc == cudaSuccess) done.fetch_or(bit);
  return rc;
}

}  // namespace wg

// ---- bf16: WMMA tensor cores (other shapes) ------------------------------

using namespace nvcuda;

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

// Plain C entry points (loaded with ctypes), one per kernel.  a, b and out
// are contiguous row-major tensors: bf16 for matmul_wgmma and matmul_wmma,
// f32 for matmul_simt.  Each launches on `stream`, does not synchronise,
// and returns cudaGetLastError() right after the launch (0 = launched), a
// CUDA error code for arguments its kernel does not take, or the negated
// CUresult of a failed tensor-map encoding (matmul_wgmma; -1 when the
// libcuda has no encoder).

// The wgmma kernel: K and N multiples of 8, a, b and out 16-byte aligned.
extern "C" int matmul_wgmma(const void* a, const void* b, void* out,
                            long long m, long long n, long long k,
                            void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 8 || !aligned16(a) ||
      !aligned16(b) || !aligned16(out) || m > INT32_MAX || n > INT32_MAX ||
      k > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      ((m + wg::BM - 1) / wg::BM) * ((n + wg::BN - 1) / wg::BN);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const wg::EncodeTiled fn = wg::encoder();
  if (fn == nullptr) return -1;
  CUtensorMap map_a, map_b;
  CUresult cr = wg::encode(fn, &map_a, a, m, k, wg::BK, wg::BM);
  if (cr == CUDA_SUCCESS)
    cr = wg::encode(fn, &map_b, b, k, n, wg::kBoxN, wg::BK);
  if (cr != CUDA_SUCCESS) return -(int)cr;
  const cudaError_t rc = wg::allow_ring();
  if (rc != cudaSuccess) return (int)rc;
  wg::mm_bf16_wgmma<<<(unsigned)tiles, wg::kThreads, wg::kSmemBytes,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), (int)m, (int)n,
      (int)k);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one wgmma block, bytes.
extern "C" int matmul_wgmma_smem_bytes() { return wg::kSmemBytes; }

// The WMMA kernel: any bf16 shape.
extern "C" int matmul_wmma(const void* a, const void* b, void* out,
                           long long m, long long n, long long k,
                           void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mm_bf16_wmma<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      m, n, k, k % 8 == 0 && aligned16(a), n % 8 == 0 && aligned16(b));
  return (int)cudaGetLastError();
}

// The SIMT kernel: any f32 shape.
extern "C" int matmul_simt(const void* a, const void* b, void* out,
                           long long m, long long n, long long k,
                           void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + FBN - 1) / FBN),
                  (unsigned)((m + FBM - 1) / FBM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  mm_f32_simt<<<grid, kFThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k);
  return (int)cudaGetLastError();
}
