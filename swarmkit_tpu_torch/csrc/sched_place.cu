// Greedy placement of one scheduler task group: T tasks that share one
// spec over N encoded nodes, in one launch.
//
// Replaces the greedy loop of the JAX package's scheduler kernel
// (manager/scheduler/kernel.py:183-216, `_build_place`: a jitted
// lax.fori_loop).  That loop is plain jnp/lax and has no Pallas ancestor;
// written as torch ops it would be some 20-30 launches a task, hundreds of
// thousands for a group of 30,000 replicas.  Here one thread block runs the
// whole loop.  Per task i, with a[n] the tasks of this group placed on node
// n so far:
//
//   feas[n]  = static_ok[n] && a[n] < cap[n]
//   count[n] = count0[n] + a[n] * has_service
//   with a spread level (nb > 0 branches):
//     load[b]  = sum of count over feasible nodes of branch b
//     first[b] = least feasible node index of branch b
//     the branch is the lexicographic minimum of (load, first) over the
//     branches with a feasible node, and feas keeps only its nodes
//   choice = the lexicographic minimum of
//            (taint, count, active0 + a, index) over feas, or -1
//   a[choice] += 1
//
// The tuples are compared field by field, never packed into one word.
// Once a task finds no feasible node none later can (a only grows), so
// the rest are -1 and the loop stops: that is exact.
//
// Input: a [6, N] int32 column block (static_ok, cap, count0, active0,
// taint, branch; cap already clamped by the caller), branch ids in
// [0, nb) (encode_group's ids; a node with another id is never placed).
// Output: choices [T] int32.
//
// Bound, from what the placement needs and not from this kernel's rescan.
// Bytes: the six columns read once and T choices written, 24 N + 4 T.
// Operations: between tasks only a[choice] changes, so only one node's key
// and one branch's (load, first) change; an incremental argmin (a
// tournament tree over the nodes, and one over the branches) needs
// ceil(log2 N) + ceil(log2 nb) tuple compares a task.  At Docker's
// published scale (N = 1,000, T = 30,000) that is bound by the bytes, some
// 0.04 us.  This kernel instead rescans every node each task (about eight
// integer operations a node a task), which is simple and exact; a
// tree-based argmin is later work.  The real floor is the chain: task
// i + 1 reads the a[] that task i wrote, so the T block-wide reductions run
// one after another, each a barrier and a log2 of the block's warps.  The
// design keeps that chain short: the columns and a[] sit in shared memory
// (each node is read and written only by the thread that owns it, node n
// by thread n mod blockDim), a task costs two barriers without a spread
// level (warp shuffles, then one warp over the warps' partials) and four
// with one (the branch atomics, the branch minimum, the node minimum), the
// branch counters are reset by the thread that reads them, and the block
// holds a few nodes a thread so that it has few warps to reduce over.
// Spreading one group over several SMs or a cluster is later work.  When
// the columns and branch counters do not fit in shared memory the same
// code runs on a global scratch buffer that the wrapper allocates.
// Integer atomics are exact, so the result does not depend on their order.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;        // the JAX kernel's "none" index
constexpr int kMaxWarps = 1024 / 32;
// dynamic shared memory a block may take on sm_90 (232,448 bytes) less
// a margin for the static partials below
constexpr long long kDynSmemMax = 232448 - 1024;

struct NodeKey {
  int taint;  // 2: no feasible node
  int count;
  int active;
  int idx;
};

struct BranchKey {
  int load;
  int first;  // kBig: no feasible node in the branch
};

__device__ __forceinline__ bool node_less(const NodeKey& x,
                                          const NodeKey& y) {
  if (x.taint != y.taint) return x.taint < y.taint;
  if (x.count != y.count) return x.count < y.count;
  if (x.active != y.active) return x.active < y.active;
  return x.idx < y.idx;
}

__device__ __forceinline__ bool branch_less(const BranchKey& x,
                                            const BranchKey& y) {
  const bool xn = x.first >= kBig, yn = y.first >= kBig;
  if (xn != yn) return yn;
  if (x.load != y.load) return x.load < y.load;
  return x.first < y.first;
}

__device__ __forceinline__ NodeKey warp_min(NodeKey k) {
  for (int off = 16; off > 0; off >>= 1) {
    NodeKey o;
    o.taint = __shfl_down_sync(0xffffffffu, k.taint, off);
    o.count = __shfl_down_sync(0xffffffffu, k.count, off);
    o.active = __shfl_down_sync(0xffffffffu, k.active, off);
    o.idx = __shfl_down_sync(0xffffffffu, k.idx, off);
    if (node_less(o, k)) k = o;
  }
  return k;
}

__device__ __forceinline__ BranchKey warp_min(BranchKey k) {
  for (int off = 16; off > 0; off >>= 1) {
    BranchKey o;
    o.load = __shfl_down_sync(0xffffffffu, k.load, off);
    o.first = __shfl_down_sync(0xffffffffu, k.first, off);
    if (branch_less(o, k)) k = o;
  }
  return k;
}

// Block-wide minimum: every thread passes its key and gets the block's.
// Two barriers; `part` holds one key a warp, `out` the result.
template <typename Key>
__device__ __forceinline__ Key block_min(Key k, Key none, Key* part,
                                         Key* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  k = warp_min(k);
  if (lane == 0) part[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < (int)(blockDim.x >> 5) ? part[lane] : none;
    k = warp_min(k);
    if (lane == 0) *out = k;
  }
  __syncthreads();
  return *out;
}

__global__ void place_greedy(const int32_t* __restrict__ cols, int n,
                             int n_tasks, int nb, int has_service,
                             int32_t* __restrict__ choices,
                             int32_t* __restrict__ scratch) {
  extern __shared__ int32_t dyn[];
  __shared__ NodeKey node_part[kMaxWarps];
  __shared__ BranchKey branch_part[kMaxWarps];
  __shared__ NodeKey node_best;
  __shared__ BranchKey branch_best;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long N = n;
  int32_t* buf = scratch != nullptr ? scratch : dyn;
  int32_t* cap = buf;               // 0 where static_ok is false
  int32_t* cnt = buf + N;           // count0
  int32_t* act = buf + 2 * N;       // active0
  int32_t* tnt = buf + 3 * N;       // taint, 0 or 1
  int32_t* br = buf + 4 * N;        // branch id
  int32_t* a = buf + 5 * N;         // tasks of this group placed so far
  int32_t* load = buf + 6 * N;      // [nb]
  int32_t* first = load + nb;       // [nb]

  for (int i = tid; i < n; i += nt) {
    br[i] = cols[5 * N + i];
    // a node outside every branch is never placed under a spread level,
    // and never indexes the branch counters
    const bool in_tree = nb == 0 || (unsigned)br[i] < (unsigned)nb;
    cap[i] = cols[i] != 0 && in_tree ? cols[N + i] : 0;
    cnt[i] = cols[2 * N + i];
    act[i] = cols[3 * N + i];
    tnt[i] = cols[4 * N + i] != 0 ? 1 : 0;
    a[i] = 0;
  }
  for (int b = tid; b < nb; b += nt) {
    load[b] = 0;
    first[b] = kBig;
  }
  __syncthreads();

  const NodeKey node_none = {2, INT_MAX, INT_MAX, INT_MAX};
  const BranchKey branch_none = {INT_MAX, kBig};
  int t = 0;
  for (; t < n_tasks; ++t) {
    int sel = -1;
    if (nb > 0) {
      for (int i = tid; i < n; i += nt) {
        const int ai = a[i];
        if (ai < cap[i]) {
          atomicAdd(&load[br[i]], cnt[i] + ai * has_service);
          atomicMin(&first[br[i]], i);
        }
      }
      __syncthreads();
      BranchKey bk = branch_none;
      for (int b = tid; b < nb; b += nt) {
        const BranchKey c = {load[b], first[b]};
        if (branch_less(c, bk)) bk = c;
        load[b] = 0;        // reset for the next task by its only reader
        first[b] = kBig;
      }
      bk = block_min(bk, branch_none, branch_part, &branch_best);
      if (bk.first >= kBig) break;   // no feasible node: the same everywhere
      sel = br[bk.first];            // the branch of its first node
    }
    NodeKey nk = node_none;
    for (int i = tid; i < n; i += nt) {
      const int ai = a[i];
      if (ai < cap[i] && (sel < 0 || br[i] == sel)) {
        const NodeKey c = {tnt[i], cnt[i] + ai * has_service, act[i] + ai,
                           i};
        if (node_less(c, nk)) nk = c;
      }
    }
    nk = block_min(nk, node_none, node_part, &node_best);
    if (nk.taint > 1) break;
    if (tid == 0) choices[t] = nk.idx;
    if (nk.idx % nt == tid) a[nk.idx] += 1;   // the owner's own node
  }
  for (int i = t + tid; i < n_tasks; i += nt) choices[i] = -1;
}

long long words(long long n, long long nb) { return 6 * n + 2 * nb; }

}  // namespace

// Words of global scratch the launch needs: 0 when the columns and the
// branch counters fit in shared memory.
extern "C" long long sched_place_scratch_words(long long n, long long nb) {
  return words(n, nb) * 4 <= kDynSmemMax ? 0 : words(n, nb);
}

// Plain C entry point (loaded with ctypes).  `cols` is the [6, n] int32
// column block, `choices` [n_tasks] int32, `scratch` the buffer that
// sched_place_scratch_words asks for (or null).  Launches one block of
// `threads` threads (a multiple of 32, at most 1024) on `stream`, does not
// synchronise, and returns cudaGetLastError() right after the launch.
extern "C" int sched_place(const void* cols, long long n, long long n_tasks,
                           long long nb, int has_service, int threads,
                           void* choices, void* scratch, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n < 0 || n >= kBig || n_tasks < 0 || n_tasks > INT_MAX || nb < 0 ||
      nb > INT_MAX || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (scratch == nullptr && sched_place_scratch_words(n, nb) != 0))
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  const long long smem = scratch != nullptr ? 0 : words(n, nb) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        place_greedy, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  place_greedy<<<1, threads, (size_t)smem, st>>>(
      static_cast<const int32_t*>(cols), (int)n, (int)n_tasks, (int)nb,
      has_service != 0 ? 1 : 0, static_cast<int32_t*>(choices),
      static_cast<int32_t*>(scratch));
  return (int)cudaGetLastError();
}
