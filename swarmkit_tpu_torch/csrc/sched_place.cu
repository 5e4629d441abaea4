// Greedy placement of one scheduler task group: T tasks that share one
// spec over N encoded nodes, in one launch.
//
// Replaces the greedy loop of the JAX package's scheduler kernel
// (manager/scheduler/kernel.py:183-216, `_build_place`: a jitted
// lax.fori_loop).  That loop is plain jnp/lax and has no Pallas ancestor;
// written as torch ops it would be some 20-30 launches a task, hundreds of
// thousands for a group of 30,000 replicas.  Per task i, with a[n] the
// tasks of this group placed on node n so far:
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
// The tuples are compared field by field (or as two packed words where
// the set-up proves that gives the same order, see Pack), and the sums
// wrap in 32-bit two's complement as JAX's scatter-add does.
// Once a task finds no feasible node none later can (a only grows), so
// the rest are -1 and the loop stops: that is exact.  A node whose branch
// id lies outside [0, nb) is never placed and never indexes a branch.
//
// Input: a [6, N] int32 column block (static_ok, cap, count0, active0,
// taint, branch; cap already clamped by the caller).  Output: choices [T].
//
// Bound, from what the placement needs (chip_smoke.py's place_bound_ms):
// the six columns read once and T choices written, 24 N + 4 T bytes at
// 3.35 TB/s, against ceil(log2 N) + ceil(log2 nb) tuple compares of up to
// four integer operations for each task the loop runs, at 67 T/s.  At
// Docker's published scale (N = 1,000, T = 30,000) the bytes bound it,
// some 0.04 us.  The real floor is the chain: task i + 1 reads the a[]
// that task i wrote, so the T argmins run one after another.
//
// Design: an incremental argmin that one warp runs, with no block barrier
// and no atomic in the task loop.  Between two tasks only a[choice]
// changes, so only one node's key and one branch's (load, first) change.
//   - Set-up (the whole block, once a launch): the nodes are grouped by
//     branch in a stable counting pass (warp 0, __match_any_sync over 32
//     nodes a step), index order kept inside a branch, so a branch is one
//     range of positions and, inside it, the position orders ties as the
//     node index does.  Each branch gets a 32-ary tournament tree over its
//     positions (leaves: (taint, count, active, position), an infeasible
//     node has taint 2), stored level by level, one warp a branch; one
//     more tree runs over the branches (leaves: (load, first); no
//     feasible node is first = 2^30).  No spread level is one branch.
//   - Per task (warp 0): the branch tree's root gives the branch, that
//     branch's root the node.  The node's leaf is rewritten and its path
//     to the root recomputed; the branch's load moves by has_service, or
//     by minus the node's count when the node leaves; first[b] is a
//     pointer that only moves forward (nodes leave and never return), so
//     its scans cost O(N / 32) ballots over the whole launch; then the
//     branch's path in the branch tree is recomputed.
//   - The dependent path a task is ceil(log32 N_b) + ceil(log32 nb)
//     levels (N_b the chosen branch's nodes).  A level is one warp-wide
//     minimum, the 32 children one a lane, by redux.sync
//     (__reduce_min_sync): two of them on a key packed into two words
//     where the set-up proves the fields fit (see Pack), else one a field.
//     Binary trees walked by every lane, ten levels at N = 1,000 against
//     two, ran 2.4-3.7 times slower on the H100 (PERF.md).
//   - The path's keys never make a round trip through memory: the key
//     just computed stays in registers as its parent's child, the roots'
//     keys stay in registers from one task to the next (each branch's
//     node-tree root also sits in an array indexed by branch), and every
//     lane writes the same values, so nothing in the loop branches by
//     lane and a task needs only two __syncwarp.
// What that does to the rescan's costs (the yardstick kept below as
// `place_rescan`: one 256-thread block over every node each task, 2-4
// block barriers a task and, with a spread level, an atomicAdd and an
// atomicMin per feasible node onto nb shared counters): no node is
// rescanned, no barrier and no atomic remains in the loop, and the few
// levels a task walks sit in shared memory as structure-of-arrays, so the
// lanes of a level read 32 consecutive words, free of bank conflicts.
// When the columns, trees and branch arrays do not fit the 227 KB of
// shared memory the same code runs on a global scratch buffer that the
// wrapper allocates (sched_place_scratch_words).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;        // the JAX kernel's "none" index
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWarps = 1024 / 32;
constexpr int kTreeThreads = 256;    // the set-up's width
constexpr int kArity = 32;           // a tree level: one child a lane
// dynamic shared memory a block may take on sm_90 (232,448 bytes) less
// a margin for the rescan's static partials
constexpr long long kDynSmemMax = 232448 - 1024;

struct NodeKey {
  int taint;  // 2: no feasible node
  int count;
  int active;
  int idx;    // node index (rescan), position in the grouped order (tree)
};

struct BranchKey {
  int load;
  int first;  // kBig: no feasible node in the branch
};

__device__ __forceinline__ bool less(const NodeKey& x, const NodeKey& y) {
  if (x.taint != y.taint) return x.taint < y.taint;
  if (x.count != y.count) return x.count < y.count;
  if (x.active != y.active) return x.active < y.active;
  return x.idx < y.idx;
}

__device__ __forceinline__ bool less(const BranchKey& x,
                                     const BranchKey& y) {
  const bool xn = x.first >= kBig, yn = y.first >= kBig;
  if (xn != yn) return yn;
  if (x.load != y.load) return x.load < y.load;
  return x.first < y.first;
}

// c ? x : y, field by field: a conditional between two structs in memory
// would select between their addresses, and put both on the stack.
__device__ __forceinline__ NodeKey pick(bool c, const NodeKey& x,
                                        const NodeKey& y) {
  return {c ? x.taint : y.taint, c ? x.count : y.count,
          c ? x.active : y.active, c ? x.idx : y.idx};
}

__device__ __forceinline__ BranchKey pick(bool c, const BranchKey& x,
                                          const BranchKey& y) {
  return {c ? x.load : y.load, c ? x.first : y.first};
}

__device__ __forceinline__ int wrap_add(int x, unsigned y) {
  return (int)((unsigned)x + y);   // two's complement, as JAX's int32
}

// ---- the rescan kernel: the yardstick, never on the path ---------------

__device__ __forceinline__ NodeKey shfl_min(NodeKey k) {
  for (int off = 16; off > 0; off >>= 1) {
    NodeKey o;
    o.taint = __shfl_down_sync(kAll, k.taint, off);
    o.count = __shfl_down_sync(kAll, k.count, off);
    o.active = __shfl_down_sync(kAll, k.active, off);
    o.idx = __shfl_down_sync(kAll, k.idx, off);
    if (less(o, k)) k = o;
  }
  return k;
}

__device__ __forceinline__ BranchKey shfl_min(BranchKey k) {
  for (int off = 16; off > 0; off >>= 1) {
    BranchKey o;
    o.load = __shfl_down_sync(kAll, k.load, off);
    o.first = __shfl_down_sync(kAll, k.first, off);
    if (less(o, k)) k = o;
  }
  return k;
}

// Block-wide minimum: every thread passes its key and gets the block's.
// Two barriers; `part` holds one key a warp, `out` the result.
template <typename Key>
__device__ __forceinline__ Key block_min(Key k, Key none, Key* part,
                                         Key* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  k = shfl_min(k);
  if (lane == 0) part[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < (int)(blockDim.x >> 5) ? part[lane] : none;
    k = shfl_min(k);
    if (lane == 0) *out = k;
  }
  __syncthreads();
  return *out;
}

// Every task rescans every node: node n is read and written only by
// thread n mod blockDim; a task costs two block barriers without a spread
// level and four with one (the branch atomics, the branch minimum, the
// node minimum).  Integer atomics are exact, so the result does not
// depend on their order.
__global__ void place_rescan(const int32_t* __restrict__ cols, int n,
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
        if (less(c, bk)) bk = c;
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
        if (less(c, nk)) nk = c;
      }
    }
    nk = block_min(nk, node_none, node_part, &node_best);
    if (nk.taint > 1) break;
    if (tid == 0) choices[t] = nk.idx;
    if (nk.idx % nt == tid) a[nk.idx] += 1;   // the owner's own node
  }
  for (int i = t + tid; i < n_tasks; i += nt) choices[i] = -1;
}

long long rescan_words(long long n, long long nb) { return 6 * n + 2 * nb; }

// ---- the tree kernel ----------------------------------------------------

// Slots of a 32-ary tree over s leaves, stored level by level above the
// leaves (ceil(s/32), ceil(s/32^2), ..., 1: at least one level, so a lone
// leaf has a root slot too).  At most 2 s - 1.
__host__ __device__ __forceinline__ long long inner_size(long long s) {
  long long total = 0;
  while (s > 0) {
    s = (s + kArity - 1) / kArity;
    total += s;
    if (s == 1) break;
  }
  return total;
}

// The launch's arrays, carved from shared memory or the global scratch.
struct Layout {
  // by position in the grouped order
  int32_t *nidx;           // node index
  int32_t *rem;            // tasks the node can still take
  int32_t *kt, *kc, *ka;   // the leaf key: taint (2: infeasible), count,
                           // active
  int32_t *brid;           // by node index: its branch id
  // the node trees' inner slots (2 N), one tree a branch
  int32_t *it, *ic, *ia, *ip;
  // by branch ([nbe + 1] and [nbe]; no spread level is one branch)
  int32_t *bstart;         // its first position; bstart[nbe] = positions
  int32_t *btree;          // its tree's first inner slot
  int32_t *bptr;           // its first feasible position, or its end
  int32_t *bload;          // the sum of count over its feasible nodes
  int32_t *bfirst;         // the node index at bptr, or kBig
  int32_t *rt, *rc, *ra, *rp;   // its node tree's root key, kept beside
                                // the root slot so a task reads it by b
  // the branch tree's inner slots (2 nbe)
  int32_t *jl, *jf;
};

long long tree_words(long long n, long long nbe) {
  return 14 * n + 13 * nbe + 2;
}

__device__ Layout carve(int32_t* buf, long long n, long long nbe) {
  Layout L;
  int32_t* p = buf;
  auto take = [&p](long long words) {
    int32_t* q = p;
    p += words;
    return q;
  };
  L.nidx = take(n);
  L.rem = take(n);
  L.kt = take(n);
  L.kc = take(n);
  L.ka = take(n);
  L.brid = take(n);
  L.it = take(2 * n);
  L.ic = take(2 * n);
  L.ia = take(2 * n);
  L.ip = take(2 * n);
  L.bstart = take(nbe + 1);
  L.btree = take(nbe + 1);
  L.bptr = take(nbe);
  L.bload = take(nbe);
  L.bfirst = take(nbe);
  L.rt = take(nbe);
  L.rc = take(nbe);
  L.ra = take(nbe);
  L.rp = take(nbe);
  L.jl = take(2 * nbe);
  L.jf = take(2 * nbe);
  return L;
}

// One branch's node tree: leaves are the branch's positions from `start`,
// inner slots from `base`.
struct NodeTree {
  using Key = NodeKey;
  const Layout& L;
  int start, base;
  __device__ NodeKey leaf(int k) const {
    const int p = start + k;
    return {L.kt[p], L.kc[p], L.ka[p], p};
  }
  __device__ NodeKey inner(int k) const {
    const int q = base + k;
    return {L.it[q], L.ic[q], L.ia[q], L.ip[q]};
  }
  __device__ void put(int k, const NodeKey& v) const {
    const int q = base + k;
    L.it[q] = v.taint;
    L.ic[q] = v.count;
    L.ia[q] = v.active;
    L.ip[q] = v.idx;
  }
  static __device__ NodeKey none() { return {2, INT_MAX, INT_MAX, INT_MAX}; }
};

__device__ __forceinline__ NodeKey root(const Layout& L, int b) {
  return {L.rt[b], L.rc[b], L.ra[b], L.rp[b]};
}

__device__ __forceinline__ void put_root(const Layout& L, int b,
                                         const NodeKey& v) {
  L.rt[b] = v.taint;
  L.rc[b] = v.count;
  L.ra[b] = v.active;
  L.rp[b] = v.idx;
}

// The tree over the branches: leaf b is (bload[b], bfirst[b]).
struct BranchTree {
  using Key = BranchKey;
  const Layout& L;
  __device__ BranchKey leaf(int k) const { return {L.bload[k], L.bfirst[k]}; }
  __device__ BranchKey inner(int k) const { return {L.jl[k], L.jf[k]}; }
  __device__ void put(int k, const BranchKey& v) const {
    L.jl[k] = v.load;
    L.jf[k] = v.first;
  }
  static __device__ BranchKey none() { return {INT_MAX, kBig}; }
};

// Two-word keys: where the kernel proves at set-up, from the columns'
// extremes and T, that every field stays in range for the whole launch,
// a key is compared as two unsigned words and a warp-wide minimum takes
// two redux.sync instead of one a field.
//   node:   hi = taint << 30 | count    lo = active << pbits | position
//   branch: hi = none << 31 | load      lo = first
// That needs count0, active0 >= 0, max count0 + T * has_service < 2^30,
// max active0 + T < 2^(32 - pbits) (positions < 2^pbits) and, with a
// spread level, N (max count0 + T * has_service) < 2^31 for the loads.
// Elsewhere the fields are compared one by one.
struct Pack {
  bool on;
  int pbits;
};

// Warp-wide lexicographic minimum; a lane with valid = false takes no
// part.  Field by field, each redux.sync takes the least value of a field
// among the lanes still tied.
__device__ __forceinline__ NodeKey warp_min(const NodeKey& k, bool valid,
                                            const Pack& pk) {
  if (pk.on) {
    const unsigned hi =
        valid ? (unsigned)k.taint << 30 | (unsigned)k.count : ~0u;
    const unsigned lo =
        valid ? (unsigned)k.active << pk.pbits | (unsigned)k.idx : ~0u;
    const unsigned h = __reduce_min_sync(kAll, hi);
    const unsigned l = __reduce_min_sync(kAll, hi == h ? lo : ~0u);
    return {(int)(h >> 30), (int)(h & ((1u << 30) - 1)),
            (int)(l >> pk.pbits), (int)(l & ((1u << pk.pbits) - 1))};
  }
  const int t = __reduce_min_sync(kAll, valid ? k.taint : INT_MAX);
  bool m = valid && k.taint == t;
  const int c = __reduce_min_sync(kAll, m ? k.count : INT_MAX);
  m = m && k.count == c;
  const int a = __reduce_min_sync(kAll, m ? k.active : INT_MAX);
  m = m && k.active == a;
  return {t, c, a, __reduce_min_sync(kAll, m ? k.idx : INT_MAX)};
}

__device__ __forceinline__ BranchKey warp_min(const BranchKey& k,
                                              bool valid, const Pack& pk) {
  const bool none = k.first >= kBig;
  if (pk.on) {
    const unsigned hi =
        valid ? (none ? 1u : 0u) << 31 | (unsigned)k.load : ~0u;
    const unsigned lo = valid ? (unsigned)k.first : ~0u;
    const unsigned h = __reduce_min_sync(kAll, hi);
    const unsigned l = __reduce_min_sync(kAll, hi == h ? lo : ~0u);
    return {(int)(h & 0x7fffffffu), (int)l};
  }
  const int nn = __reduce_min_sync(kAll, valid ? (none ? 1 : 0) : 2);
  bool m = valid && (none ? 1 : 0) == nn;
  const int l = __reduce_min_sync(kAll, m ? k.load : INT_MAX);
  m = m && k.load == l;
  return {l, __reduce_min_sync(kAll, m ? k.first : INT_MAX)};
}

// The least of children [lo, hi) of a level (at most 32), in every lane;
// `at(k)` reads child k.  Building: every child comes from memory.
template <typename Tree, typename At>
__device__ __forceinline__ typename Tree::Key level_min(At at, int lo,
                                                        int hi,
                                                        const Pack& pk) {
  if (hi - lo == 1) return at(lo);
  const int k = lo + (int)(threadIdx.x & 31);
  return warp_min(at(min(k, hi - 1)), k < hi, pk);
}

// The same on the path: child `path` is `cur`, the key just computed, held
// in registers and never read back.  Every lane loads a child that exists
// and then selects, so nothing in a level branches by lane.
template <typename Key, typename At>
__device__ __forceinline__ Key path_min(At at, int lo, int hi, int path,
                                        const Key& cur, const Pack& pk) {
  if (hi - lo == 1) return cur;
  const int k = lo + (int)(threadIdx.x & 31);
  return warp_min(pick(k == path, cur, at(min(k, hi - 1))), k < hi, pk);
}

// Every inner slot of a tree over s > 0 leaves, bottom up, by one warp, a
// node at a time.
template <typename Tree>
__device__ void build(const Tree& tr, int s, const Pack& pk) {
  int lvl = -1, out = 0, sz = s;
  do {
    const int up = (sz + kArity - 1) / kArity;
    for (int j = 0; j < up; ++j)
      tr.put(out + j, level_min<Tree>(
                          [&](int k) {
                            return lvl < 0 ? tr.leaf(k) : tr.inner(lvl + k);
                          },
                          j * kArity, min(j * kArity + kArity, sz), pk));
    __syncwarp();
    lvl = out;
    out += up;
    sz = up;
  } while (sz > 1);
}

// Leaf i of a tree over s leaves now holds `cur`: recompute its path to
// the root and return the root's key.  Every lane writes the same keys,
// and the loads are of slots off the path, which no lane writes here.
template <typename Tree>
__device__ __forceinline__ typename Tree::Key update_path(
    const Tree& tr, int i, int s, typename Tree::Key cur, const Pack& pk) {
  int j = i / kArity, sz = (s + kArity - 1) / kArity;
  cur = path_min([&](int k) { return tr.leaf(k); }, j * kArity,
                 min(j * kArity + kArity, s), i, cur, pk);
  tr.put(j, cur);
  for (int lvl = 0, out = sz; sz > 1;) {
    i = j;
    j = i / kArity;
    cur = path_min([&](int k) { return tr.inner(lvl + k); }, j * kArity,
                   min(j * kArity + kArity, sz), i, cur, pk);
    tr.put(out + j, cur);
    lvl = out;
    sz = (sz + kArity - 1) / kArity;
    out += sz;
  }
  return cur;
}

// kGlobal: the arrays lie in the global scratch (a compile-time choice,
// so that on the shared-memory path every access is a shared load).
// allow_pack = 0 compares every key field by field.
template <bool kGlobal>
__global__ void __launch_bounds__(kTreeThreads)
place_tree(const int32_t* __restrict__ cols, int n, int n_tasks, int nb,
           int has_service, int allow_pack, int32_t* __restrict__ choices,
           int32_t* __restrict__ scratch) {
  extern __shared__ int32_t dyn[];
  __shared__ int ext[4];   // min and max of count0, of active0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nbe = nb > 0 ? nb : 1;
  const long long N = n;
  const Layout L = carve(kGlobal ? scratch : dyn, N, nbe);

  // 1. each branch's size, each node's branch, the extremes
  for (int b = tid; b < nbe; b += blockDim.x) L.bstart[b] = 0;
  if (tid == 0) {
    ext[0] = ext[2] = INT_MAX;
    ext[1] = ext[3] = INT_MIN;
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int b = nb > 0 ? cols[5 * N + i] : 0;
    L.brid[i] = b;
    if ((unsigned)b < (unsigned)nbe) atomicAdd(&L.bstart[b], 1);
    const int c = cols[2 * N + i], a = cols[3 * N + i];
    atomicMin(&ext[0], c);
    atomicMax(&ext[1], c);
    atomicMin(&ext[2], a);
    atomicMax(&ext[3], a);
  }
  __syncthreads();
  Pack pk;
  pk.pbits = n > 1 ? 32 - __clz(n - 1) : 0;
  {
    const long long count_max = (long long)ext[1] + (long long)n_tasks *
                                                        (has_service != 0);
    pk.on = allow_pack != 0 && n > 0 && ext[0] >= 0 && ext[2] >= 0 &&
            count_max < (1LL << 30) &&
            (long long)ext[3] + n_tasks < (1LL << (32 - pk.pbits)) &&
            (nb == 0 || N * count_max < (1LL << 31));
  }

  if (warp == 0) {
    // 2. the branches' first positions and first inner slots: exclusive
    // sums, 32 branches a step
    int pos0 = 0, slot0 = 0;
    for (int b0 = 0; b0 < nbe; b0 += 32) {
      const int b = b0 + lane;
      const int size = b < nbe ? L.bstart[b] : 0;
      const int slots = (int)inner_size(size);
      int ps = size, ss = slots;
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(kAll, ps, off);
        const int y = __shfl_up_sync(kAll, ss, off);
        if (lane >= off) {
          ps += x;
          ss += y;
        }
      }
      if (b < nbe) {
        L.bstart[b] = pos0 + ps - size;
        L.bfirst[b] = pos0 + ps - size;   // the scatter's cursor
        L.btree[b] = slot0 + ss - slots;
        L.bload[b] = 0;
      }
      pos0 += __shfl_sync(kAll, ps, 31);
      slot0 += __shfl_sync(kAll, ss, 31);
    }
    if (lane == 0) {
      L.bstart[nbe] = pos0;
      L.btree[nbe] = slot0;
    }
    __syncwarp();
    for (int b = lane; b < nbe; b += 32) L.bptr[b] = L.bstart[b + 1];
    __syncwarp();

    // 3. the stable scatter: 32 nodes a step in index order; the nodes of
    // one branch in a step take consecutive positions by lane
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int b = i < n ? L.brid[i] : -1;
      const bool in = i < n && (unsigned)b < (unsigned)nbe;
      const unsigned act = __ballot_sync(kAll, in);
      unsigned peers = 0;
      if (in) {
        peers = __match_any_sync(act, b);
        const int p = L.bfirst[b] + __popc(peers & ((1u << lane) - 1));
        const int cap = cols[i] != 0 ? cols[N + i] : 0;
        const int count0 = cols[2 * N + i];
        L.nidx[p] = i;
        L.rem[p] = cap;
        L.kc[p] = count0;
        L.ka[p] = cols[3 * N + i];
        L.kt[p] = cap > 0 ? (cols[4 * N + i] != 0 ? 1 : 0) : 2;
        if (cap > 0) {
          atomicAdd(&L.bload[b], count0);   // wraps, as JAX's scatter-add
          atomicMin(&L.bptr[b], p);
        }
      }
      __syncwarp();
      if (in && lane == 31 - __clz(peers)) L.bfirst[b] += __popc(peers);
      __syncwarp();
    }
    for (int b = lane; b < nbe; b += 32) {
      const int p = L.bptr[b];
      L.bfirst[b] = p < L.bstart[b + 1] ? L.nidx[p] : kBig;
    }
  }
  __syncthreads();

  // 4. every warp builds the node trees of its branches
  for (int b = warp; b < nbe; b += nwarps) {
    const int s = L.bstart[b + 1] - L.bstart[b];
    if (s > 0) {
      const NodeTree tree{L, L.bstart[b], L.btree[b]};
      build(tree, s, pk);
      put_root(L, b, tree.inner(L.btree[b + 1] - 1 - L.btree[b]));
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 5. the task loop, in warp 0 alone.  The roots' keys stay in registers
  // from one task to the next: `bkey` the branch tree's, `key` the chosen
  // branch's node tree's (without a spread level, the one tree's).
  const BranchTree branches{L};
  if (nb > 0) build(branches, nb, pk);
  const unsigned hs = has_service != 0 ? 1u : 0u;
  int b = 0, start = L.bstart[0], end = L.bstart[1], base = L.btree[0];
  BranchKey bkey = BranchTree::none();
  NodeKey key = NodeTree::none();
  if (nb > 0)
    bkey = branches.inner((int)inner_size(nb) - 1);
  else if (n > 0)
    key = root(L, 0);
  int t = 0;
  if (n > 0) {
    for (; t < n_tasks; ++t) {
      int load = 0, ptr = 0;
      if (nb > 0) {
        if (bkey.first >= kBig) break;   // no branch has a feasible node
        b = L.brid[bkey.first];
        start = L.bstart[b];
        end = L.bstart[b + 1];
        base = L.btree[b];
        key = root(L, b);
        load = L.bload[b];
        ptr = L.bptr[b];
      }
      if (key.taint > 1) break;          // no feasible node
      const int p = key.idx, rem = L.rem[p], choice = L.nidx[p];
      const bool left = rem == 1;
      const NodeKey leaf = {left ? 2 : key.taint, wrap_add(key.count, hs),
                            wrap_add(key.active, 1u), p};
      __syncwarp();   // every lane has read what this task rewrites
      if (lane == 0) choices[t] = choice;
      L.rem[p] = rem - 1;
      L.kt[p] = leaf.taint;
      L.kc[p] = leaf.count;
      L.ka[p] = leaf.active;
      const int before = key.count;
      key = update_path(NodeTree{L, start, base}, p - start, end - start,
                        leaf, pk);
      if (nb > 0) {
        put_root(L, b, key);
        // the branch: its first feasible node moves forward past a node
        // that left, its load by has_service or by minus the count lost
        if (left && p == ptr) {
          for (ptr = p + 1;; ptr += 32) {
            const int k = ptr + lane;
            const unsigned f = __ballot_sync(kAll, k < end && L.kt[k] != 2);
            if (f != 0) {
              ptr += __ffs(f) - 1;
              break;
            }
            if (ptr + 32 >= end) {
              ptr = end;
              break;
            }
          }
          L.bptr[b] = ptr;
        }
        const BranchKey bleaf = {
            wrap_add(load, left ? 0u - (unsigned)before : hs),
            ptr < end ? L.nidx[ptr] : kBig};
        L.bload[b] = bleaf.load;
        L.bfirst[b] = bleaf.first;
        bkey = update_path(branches, b, nb, bleaf, pk);
      }
      __syncwarp();   // this task's writes, seen by every lane
    }
  }
  for (int i = t + lane; i < n_tasks; i += 32) choices[i] = -1;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long smem, int threads, cudaStream_t st,
           Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, threads, (size_t)smem, st>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_sizes(long long n, long long n_tasks, long long nb) {
  return n < 0 || n >= kBig || n_tasks < 0 || n_tasks > INT_MAX || nb < 0 ||
         nb >= kBig;
}

}  // namespace

// Words of global scratch a launch needs: 0 when its arrays fit in shared
// memory.  `rescan` != 0 asks for the rescan kernel's.
extern "C" long long sched_place_scratch_words(long long n, long long nb,
                                               int rescan) {
  const long long w =
      rescan ? rescan_words(n, nb) : tree_words(n, nb > 0 ? nb : 1);
  return w * 4 <= kDynSmemMax ? 0 : w;
}

// Plain C entry points (loaded with ctypes).  `cols` is the [6, n] int32
// column block, `choices` [n_tasks] int32, `scratch` the buffer that
// sched_place_scratch_words asks for (or null).  Each launches one block
// on `stream`, does not synchronise, and returns cudaGetLastError() right
// after the launch.
//
// sched_place: the tree kernel; `allow_pack` 0 compares every key field
// by field (for the tests and the measurement of the two-word keys).
extern "C" int sched_place(const void* cols, long long n, long long n_tasks,
                           long long nb, int has_service, int allow_pack,
                           void* choices, void* scratch, void* stream) {
  if (bad_sizes(n, n_tasks, nb) ||
      (scratch == nullptr && sched_place_scratch_words(n, nb, 0) != 0))
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  const long long smem =
      scratch != nullptr ? 0 : tree_words(n, nb > 0 ? nb : 1) * 4;
  auto kernel =
      scratch != nullptr ? place_tree<true> : place_tree<false>;
  return launch(kernel, smem, kTreeThreads,
                reinterpret_cast<cudaStream_t>(stream),
                static_cast<const int32_t*>(cols), (int)n, (int)n_tasks,
                (int)nb, has_service != 0 ? 1 : 0, allow_pack != 0 ? 1 : 0,
                static_cast<int32_t*>(choices),
                static_cast<int32_t*>(scratch));
}

// sched_place_rescan: the rescan kernel, with `threads` threads (a
// multiple of 32, at most 1024).
extern "C" int sched_place_rescan(const void* cols, long long n,
                                  long long n_tasks, long long nb,
                                  int has_service, int threads,
                                  void* choices, void* scratch,
                                  void* stream) {
  if (bad_sizes(n, n_tasks, nb) || threads < 32 || threads > 1024 ||
      threads % 32 != 0 ||
      (scratch == nullptr && sched_place_scratch_words(n, nb, 1) != 0))
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  const long long smem = scratch != nullptr ? 0 : rescan_words(n, nb) * 4;
  return launch(place_rescan, smem, threads,
                reinterpret_cast<cudaStream_t>(stream),
                static_cast<const int32_t*>(cols), (int)n, (int)n_tasks,
                (int)nb, has_service != 0 ? 1 : 0,
                static_cast<int32_t*>(choices),
                static_cast<int32_t*>(scratch));
}
