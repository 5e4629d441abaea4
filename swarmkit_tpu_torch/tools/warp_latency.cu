// Dependent-chain latencies, in SM cycles, of the warp primitives that
// the scheduler's placement kernel (csrc/sched_place.cu) chains once a
// tree level: one warp runs 16 dependent copies of each operation a loop
// step and reads clock64() around the loop.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/warp_latency \
//       swarmkit_tpu_torch/tools/warp_latency.cu && build/warp_latency
//
// Each line is one operation plus what keeps the chain dependent (an add
// or an and, a cycle or so).

#include <cuda_runtime.h>
#include <stdio.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kIters = 2000, kChain = 16;

enum Op {
  kShfl,        // __shfl_xor_sync
  kRedux,       // __reduce_min_sync
  kTwoWord,     // the kernel's two-word minimum: two redux.sync
  kButterfly,   // a 64-bit minimum by five shuffle steps
  kLoad,        // a shared load whose address is the last load's value
  kStoreLoad,   // a shared store, __syncwarp, a load of another word
  kSyncwarp,    // __syncwarp on a converged warp
  kBallot,      // __ballot_sync
  kMatchAny,    // __match_any_sync
};

template <Op M>
__global__ void chain(int iters, int* out, long long* cycles) {
  __shared__ int sm[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) sm[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  int x = lane;
  unsigned u = lane * 2654435761u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kChain; ++r) {
      if (M == kShfl) x = __shfl_xor_sync(kAll, x, 1) + 1;
      if (M == kRedux) x = (int)__reduce_min_sync(kAll, (unsigned)x) + lane;
      if (M == kTwoWord) {
        const unsigned h = __reduce_min_sync(kAll, u);
        const unsigned l = __reduce_min_sync(kAll, u == h ? (unsigned)x : ~0u);
        u += h + (l & 1);
        x += l;
      }
      if (M == kButterfly) {
        unsigned long long v = (unsigned long long)u << 32 | (unsigned)x;
        for (int o = 16; o > 0; o >>= 1) {
          const unsigned long long w = __shfl_xor_sync(kAll, v, o);
          v = w < v ? w : v;
        }
        u += (unsigned)(v >> 32) & 1;
        x += (int)v & 1;
      }
      if (M == kLoad) x = sm[x & 1023];
      if (M == kStoreLoad) {
        sm[(x + lane) & 1023] = x;
        __syncwarp();
        x = sm[(x + lane + 1) & 1023];
      }
      if (M == kSyncwarp) {
        x += 1;
        __syncwarp();
      }
      if (M == kBallot) x = (int)__ballot_sync(kAll, x & 1) + lane;
      if (M == kMatchAny) x = (int)__match_any_sync(kAll, x & 3) + lane;
    }
  }
  const long long t1 = clock64();
  out[lane] = x + (int)u;
  if (lane == 0) *cycles = t1 - t0;
}

template <Op M>
bool report(const char* name, int* out, long long* cycles) {
  chain<M><<<1, 32>>>(10, out, cycles);   // warm
  chain<M><<<1, 32>>>(kIters, out, cycles);
  long long c = 0;
  if (cudaMemcpy(&c, cycles, sizeof c, cudaMemcpyDeviceToHost) !=
      cudaSuccess)
    return false;
  printf("%-44s %6.1f cycles\n", name, (double)c / (kIters * kChain));
  return true;
}

}  // namespace

int main() {
  int* out;
  long long* cycles;
  if (cudaMalloc(&out, 32 * sizeof(int)) != cudaSuccess ||
      cudaMalloc(&cycles, sizeof(long long)) != cudaSuccess) {
    fprintf(stderr, "warp_latency: no CUDA device\n");
    return 1;
  }
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s\n", prop.name);
  const bool ok =
      report<kShfl>("shfl_xor + add", out, cycles) &&
      report<kRedux>("redux.sync min + add", out, cycles) &&
      report<kTwoWord>("two-word minimum (2 redux.sync)", out, cycles) &&
      report<kButterfly>("64-bit minimum, 5 shuffle steps", out, cycles) &&
      report<kLoad>("shared load, address from the last", out, cycles) &&
      report<kStoreLoad>("shared store, __syncwarp, load", out, cycles) &&
      report<kSyncwarp>("add + __syncwarp", out, cycles) &&
      report<kBallot>("ballot + add", out, cycles) &&
      report<kMatchAny>("match_any + add", out, cycles);
  const cudaError_t e = cudaGetLastError();
  if (!ok || e != cudaSuccess) {
    fprintf(stderr, "warp_latency: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
