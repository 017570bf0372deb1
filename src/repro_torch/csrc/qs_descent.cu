// Q1: the QuickScorer descent of the fused propose step, on Hopper.
//
// No Pallas original: the reference computes this step with jnp inside its
// jitted propose program (repro/kernels/forest_eval/propose.py,
// _qs_leaf_stats), and the port needs it on the card as a kernel. It
// computes per-tree leaf (mean, var), each (T, N) float64, for N candidate
// rows of X (N, D) by QuickScorer (Lucchese et al., SIGIR'15): a node's
// false mask clears the leaves of its left subtree where thr < v, the AND
// of the masks of every node a candidate fails leaves each tree's exit leaf
// as its lowest set bit, and the leaf's ordinal indexes the leaf stats.
// There is no float arithmetic, only strict compares, ANDs and a lowest
// set bit, so both routes give the descent's `v > thr` routing bit for bit.
//
// Route `per_tree`. Each tree keeps only the features it splits on,
// in one record a tree with the tree's leaf stats (kernels/forest_eval/
// propose.py, build_tree_records): a feature split once is a single, its
// threshold and its false mask; one split n > 1 times keeps its n sorted
// thresholds and n + 1 prefix-ANDed leaf words of that tree alone. Words are
// uint32 where every tree has at most 32 leaves, uint64 up to 64, two uint64
// up to 128. Row r of a pair is the merged table's row at the global rank
// restricted to the tree, so the result cannot differ. At the tuner's 12
// sources x 10 trees and 60 knobs a candidate then reads 1607 (tree,
// feature) entries where the merged tables made it read 60 x 120 rows, and
// the whole plane, 76640 bytes, fits one block's shared memory.
// - Staging: a persistent grid of 512-thread blocks walks units (tree
//   chunk, candidate tile), chunk-major; a block copies a chunk's records
//   into shared memory with one bulk asynchronous copy (cp.async.bulk,
//   completion on an mbarrier) when its chunk changes, and X tiles through
//   a ring of two, each feature's column of the tile contiguous at an odd
//   stride (8-byte cp.async, conflict-free both ways), the next tile's
//   copies in flight during this tile's walk.
// - Walk: a warp takes one tree on the whole tile (128 candidates, four a
//   lane 32 apart; 64 where the ring of 128 does not fit), the next tree
//   from a counter in shared memory. A single costs a 16-byte broadcast, a
//   broadcast word, and a strict compare and a predicated AND a candidate,
//   with nothing carried from one single to the next but the ANDs, so the
//   unrolled loop keeps several in flight; a pair a rank by strict compares
//   and the word at that rank. The exit leaf by __ffs, its stats from the
//   record, and a warp writes 32 neighbouring candidates of one tree row a
//   store, coalesced.
// - The plan (qs_plan) cuts the trees into chunks that fit beside the ring
//   and, where the tiles alone do not fill the SMs, into the fewest trees a
//   chunk with which chunks x tiles fits one round of the SMs. Where one
//   tree's record cannot fit beside a ring of 64 candidates, it takes
//   `merged`.
// What bounds it: the bytes it must move, X in and the two (T, N) outputs,
// 0.094 ms at 131072 candidates; its shared-memory reads, about 10
// wavefronts a warp and single (the four X values take 8), come next.
//
// Route `merged` (the first design): tables merged across every
// tree, per feature j the sorted thresholds and a prefix-ANDed false-node
// table of n_j + 1 rows of T trees' W uint64 leaf words. A candidate's rank
// r = #(thr < v) on feature j picks table row r (word 0 first; an empty
// word counts 64). It reads one row of T W words per feature with a
// threshold whether a tree splits on it or not: 60 x 120 x 8 bytes, about
// 58 KB a candidate, some 7.5 GB of L2 traffic at 131072 candidates, which
// bounds it. A block takes 32 candidates and a chunk of 128 trees. Its 256
// threads first rank the 32 x D (candidate, feature) pairs by binary search,
// each pair's table row into shared memory; then a warp a candidate, the
// lanes over trees (four a lane), ANDs the rows' words, coalesced across the
// warp; each exit leaf's index goes to shared memory, and the block writes
// the two outputs a tree row at a time, 32 neighbouring candidates a warp.
//
// Both routes read T and the word width from `meta` on the device, so a
// captured CUDA graph replays the kernel for any plane whose tables fit its
// buffers (and, on per_tree, whose chunks fit the plan); rows of the
// outputs at or past T are left as they were.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 32;           // candidates a block
constexpr int kThreads = 256;       // 8 warps
constexpr int kPerLane = 4;         // trees a lane
constexpr int kChunk = 32 * kPerLane;

__device__ __forceinline__ int rank_below(const double* __restrict__ thr, int n, double v) {
  // #(thr < v) over sorted thr: numpy's searchsorted(side="left")
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(thr + mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int lowbit(unsigned long long w) {
  return w ? __ffsll((long long)w) - 1 : 64;
}

template <int W>
__device__ __forceinline__ void walk(const unsigned long long* __restrict__ tables,
                                     const int* __restrict__ leaf_off, const int* row_of,
                                     int* leaf_of, int D, int T, int t_base, int r, int lane) {
  unsigned long long acc[kPerLane][W];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[k][w] = ~0ull;
  for (int j = 0; j < D; ++j) {
    const int row = row_of[r * D + j];
    if (row < 0) continue;  // a feature no tree splits on
    const unsigned long long* p = tables + (int64_t)row * T * W;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int t = t_base + lane + 32 * k;
      if (t < T) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[k][w] &= __ldg(p + (int64_t)t * W + w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int t = t_base + lane + 32 * k;
    if (t < T) {
      int leaf = lowbit(acc[k][0]);
      if (W == 2 && acc[k][0] == 0) leaf = 64 + lowbit(acc[k][W - 1]);
      leaf_of[(lane + 32 * k) * kRows + r] = __ldg(leaf_off + t) + leaf;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
qs_descent_kernel(const double* __restrict__ X, const double* __restrict__ thr,
                  const int* __restrict__ thr_off, const unsigned long long* __restrict__ tables,
                  const double* __restrict__ leaf_mean, const double* __restrict__ leaf_var,
                  const int* __restrict__ leaf_off, const int* __restrict__ meta,
                  double* __restrict__ m_out, double* __restrict__ v_out, int N, int D) {
  extern __shared__ int smem[];
  const int T = __ldg(meta), W = __ldg(meta + 1);
  const int t_base = blockIdx.y * kChunk;
  if (t_base >= T) return;
  const int n0 = blockIdx.x * kRows;
  const int nrows = min(kRows, N - n0);
  int* row_of = smem;                   // [kRows][D]: table row, -1 where no threshold
  int* leaf_of = smem + kRows * D;      // [kChunk][kRows]: exit leaf index

  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    const int a = __ldg(thr_off + j), b = __ldg(thr_off + j + 1);
    row_of[i] = a == b ? -1 : a + j + rank_below(thr + a, b - a, __ldg(X + (int64_t)(n0 + r) * D + j));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += kThreads / 32) {
    if (W == 2) walk<2>(tables, leaf_off, row_of, leaf_of, D, T, t_base, r, lane);
    else walk<1>(tables, leaf_off, row_of, leaf_of, D, T, t_base, r, lane);
  }
  __syncthreads();

  const int trees = min(kChunk, T - t_base);
  for (int i = threadIdx.x; i < trees * kRows; i += kThreads) {
    const int tl = i / kRows, r = i - tl * kRows;
    if (r < nrows) {
      const int id = leaf_of[i];
      const int64_t o = (int64_t)(t_base + tl) * N + n0 + r;
      m_out[o] = __ldg(leaf_mean + id);
      v_out[o] = __ldg(leaf_var + id);
    }
  }
}

// ------------------------------------------------------------- per_tree

constexpr int kTreeThreads = 512;   // 16 warps
constexpr int kBar = 16;            // the mbarrier and the tree counter, ahead of the ring

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory at `dst`, counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// orders this block's earlier generic reads of shared memory before a later
// bulk copy's writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void set_ones(uint32_t& w) { w = ~0u; }
__device__ __forceinline__ void set_ones(unsigned long long& w) { w = ~0ull; }
__device__ __forceinline__ void set_ones(ulonglong2& w) { w.x = ~0ull; w.y = ~0ull; }
__device__ __forceinline__ void and_in(uint32_t& a, const uint32_t* p) { a &= *p; }
__device__ __forceinline__ void and_in(unsigned long long& a, const unsigned long long* p) {
  a &= *p;
}
__device__ __forceinline__ void and_in(ulonglong2& a, const ulonglong2* p) {
  const ulonglong2 b = *p;
  a.x &= b.x;
  a.y &= b.y;
}
__device__ __forceinline__ void and_if(uint32_t& a, uint32_t b, bool f) { a &= f ? b : ~0u; }
__device__ __forceinline__ void and_if(unsigned long long& a, unsigned long long b, bool f) {
  a &= f ? b : ~0ull;
}
__device__ __forceinline__ void and_if(ulonglong2& a, ulonglong2 b, bool f) {
  a.x &= f ? b.x : ~0ull;
  a.y &= f ? b.y : ~0ull;
}
// a tree's word always keeps its exit leaf's bit
__device__ __forceinline__ int exit_leaf(uint32_t w) { return __ffs(w) - 1; }
__device__ __forceinline__ int exit_leaf(unsigned long long w) { return __ffsll((long long)w) - 1; }
__device__ __forceinline__ int exit_leaf(ulonglong2 w) {
  return w.x ? __ffsll((long long)w.x) - 1 : 64 + __ffsll((long long)w.y) - 1;
}

// tile candidates [n0, n0 + tile) of X into `buf`, feature-major at the odd
// stride tile + 1: buf[j * (tile + 1) + r]; rows past N are not copied
__device__ __forceinline__ void load_tile(double* buf, const double* __restrict__ X, int n0,
                                          int tile, int N, int D) {
  const int rows = min(tile, N - n0), stride = tile + 1;
  const double* src = X + (int64_t)n0 * D;
  for (int e = threadIdx.x; e < rows * D; e += kTreeThreads) {
    const int r = e / D, j = e - r * D;
    cp_async8(hopper::smem_u32(buf + j * stride + r), src + e);
  }
}

// one warp's item: tree t (its record at `rec`) on the tile's candidates
// lane + 32 c, c < C, in `xs`. Singles first: one 16-byte broadcast (feature,
// threshold), one broadcast word, and C compares and predicated ANDs, with
// no dependence from one single to the next, so the unrolled loop keeps
// several in flight; then the pairs of more thresholds, each a rank by
// strict compares and the word at that rank.
template <typename Word, int C>
__device__ __forceinline__ void walk_item(const unsigned char* rec, const double* xs, int stride,
                                          int lane, int t, int n0, int N,
                                          double* __restrict__ m_out,
                                          double* __restrict__ v_out) {
  const int4 h = *reinterpret_cast<const int4*>(rec);
  const int S = h.x, P = h.y, M = h.z, L = h.w;
  const int4* singles = reinterpret_cast<const int4*>(rec + 16);
  const int2* pairs = reinterpret_cast<const int2*>(rec + 16 + 16 * S);
  const double* thr = reinterpret_cast<const double*>(rec + 16 + 16 * S + 8 * P);
  const double* lmean = thr + M;
  const double* lvar = lmean + L;
  const Word* words =
      reinterpret_cast<const Word*>(rec + ((16 + 16 * S + 8 * (P + M) + 16 * L + 15) & ~15));
  const double* x0 = xs + lane;
  Word a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) set_ones(a[c]);
#pragma unroll 4
  for (int i = 0; i < S; ++i) {
    const int4 e = singles[i];
    const double z = __hiloint2double(e.w, e.z);
    const Word w = words[i];
    const double* xj = x0 + e.x * stride;
#pragma unroll
    for (int c = 0; c < C; ++c) and_if(a[c], w, z < xj[32 * c]);
  }
  const Word* pw = words + S;
  for (int p = 0; p < P; ++p) {
    const int2 q = pairs[p];
    const int n = q.y >> 16;
    const double* xj = x0 + (q.y & 0xFFFF) * stride;
    double v[C];
    int r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = xj[32 * c];
      r[c] = 0;
    }
    for (int k = 0; k < n; ++k) {
      const double y = thr[q.x + k];
#pragma unroll
      for (int c = 0; c < C; ++c) r[c] += y < v[c];
    }
    const Word* w = pw + q.x + p;
#pragma unroll
    for (int c = 0; c < C; ++c) and_in(a[c], w + r[c]);
  }
  const int64_t o = (int64_t)t * N + n0 + lane;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (n0 + lane + 32 * c < N) {
      const int l = exit_leaf(a[c]);
      m_out[o + 32 * c] = lmean[l];
      v_out[o + 32 * c] = lvar[l];
    }
  }
}

// a unit's items for C candidates a lane (tile = 32 C): each warp takes the
// chunk's next tree from the counter `next` until none is left (trees differ
// in pairs, 7 to 20 at the tuner's plane, so a fixed share would wait on the
// warp that drew the most)
template <int C>
__device__ __forceinline__ void walk_unit(const unsigned char* tabs,
                                          const int* __restrict__ tree_off, int base, int t0,
                                          int nt, int wb, const double* xs, int stride, int n0,
                                          int N, int* next, double* __restrict__ m_out,
                                          double* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int tl = 0;
    if (lane == 0) tl = atomicAdd(next, 1);
    tl = __shfl_sync(0xffffffffu, tl, 0);
    if (tl >= nt) break;
    const unsigned char* rec = tabs + (__ldg(tree_off + t0 + tl) - base);
    if (wb == 4)
      walk_item<uint32_t, C>(rec, xs, stride, lane, t0 + tl, n0, N, m_out, v_out);
    else if (wb == 8)
      walk_item<unsigned long long, C>(rec, xs, stride, lane, t0 + tl, n0, N, m_out, v_out);
    else
      walk_item<ulonglong2, C>(rec, xs, stride, lane, t0 + tl, n0, N, m_out, v_out);
  }
}

__global__ void __launch_bounds__(kTreeThreads, 1)
qs_descent_tree_kernel(const double* __restrict__ X, const unsigned char* __restrict__ blob,
               const int* __restrict__ tree_off, const int* __restrict__ meta,
               double* __restrict__ m_out, double* __restrict__ v_out, int N, int D, int tile,
               int per) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  const int T = __ldg(meta), wb = __ldg(meta + 1);
  const int tiles = (N + tile - 1) / tile;
  const int units = ((T + per - 1) / per) * tiles;
  if ((int)blockIdx.x >= units) return;
  const int stride = tile + 1, xlen = D * stride;
  double* ring = reinterpret_cast<double*>(tsmem + kBar);
  unsigned char* tabs = tsmem + kBar + 2 * (size_t)xlen * sizeof(double);
  const uint32_t bar = hopper::smem_u32(tsmem);
  int* next = reinterpret_cast<int*>(tsmem + 8);   // the unit's next tree, beside the mbarrier
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
    *next = 0;
  }
  __syncthreads();
  int chunk = -1, t0 = 0, nt = 0, base = 0;
  uint32_t phase = 0;
  int u = blockIdx.x;
  load_tile(ring, X, (u % tiles) * tile, tile, N, D);
  cp_commit();
  for (int k = 0; u < units; ++k, u += gridDim.x) {
    const int c = u / tiles, i = u - c * tiles;
    const int later = u + gridDim.x;
    if (later < units)
      load_tile(ring + ((k + 1) & 1) * xlen, X, (later % tiles) * tile, tile, N, D);
    cp_commit();   // an empty group past the last unit keeps the wait below uniform
    if (c != chunk) {   // every warp left the last chunk's tables at the barrier below
      chunk = c;
      t0 = c * per;
      nt = min(per, T - t0);
      base = __ldg(tree_off + t0);
      if (threadIdx.x == 0) {
        const uint32_t bytes = (uint32_t)(__ldg(tree_off + t0 + nt) - base);
        fence_proxy_async();
        hopper::mbar_arrive_expect_tx(bar, bytes);
        bulk_load(hopper::smem_u32(tabs), blob + base, bytes, bar);
      }
      hopper::mbar_wait(bar, phase);
      phase ^= 1;
    }
    cp_wait1();
    __syncthreads();
    const double* xs = ring + (k & 1) * xlen;
    if (tile == 128)
      walk_unit<4>(tabs, tree_off, base, t0, nt, wb, xs, stride, i * tile, N, next, m_out, v_out);
    else
      walk_unit<2>(tabs, tree_off, base, t0, nt, wb, xs, stride, i * tile, N, next, m_out, v_out);
    __syncthreads();
    if (threadIdx.x == 0) *next = 0;   // read again only after the next unit's barrier
  }
}

}  // namespace

extern "C" int qs_descent_launch(const void* X, const void* thr, const void* thr_off,
                                 const void* tables, const void* leaf_mean, const void* leaf_var,
                                 const void* leaf_off, const void* meta, void* m_out, void* v_out,
                                 int N, int D, int t_rows, int smem, void* stream) {
  if (N <= 0 || t_rows <= 0) return 0;
  if (D <= 0 || smem != 4 * (kRows * D + kChunk * kRows)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // per call: the attribute is the current device's
    const cudaError_t e = cudaFuncSetAttribute(
        qs_descent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kRows - 1) / kRows, (t_rows + kChunk - 1) / kChunk);
  qs_descent_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const double*)X, (const double*)thr, (const int*)thr_off,
      (const unsigned long long*)tables, (const double*)leaf_mean, (const double*)leaf_var,
      (const int*)leaf_off, (const int*)meta, (double*)m_out, (double*)v_out, N, D);
  return (int)cudaGetLastError();
}

extern "C" int qs_tree_launch(const void* X, const void* blob, const void* tree_off,
                              const void* meta, void* m_out, void* v_out, int N, int D, int tile,
                              int per, int grid, int smem, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || (tile != 64 && tile != 128) || per <= 0 || grid <= 0 ||
      smem < kBar + 2 * D * (tile + 1) * (int)sizeof(double) + 16)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // per call: the attribute is the current device's
    const cudaError_t e = cudaFuncSetAttribute(
        qs_descent_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  qs_descent_tree_kernel<<<grid, kTreeThreads, smem, (cudaStream_t)stream>>>(
      (const double*)X, (const unsigned char*)blob, (const int*)tree_off, (const int*)meta,
      (double*)m_out, (double*)v_out, N, D, tile, per);
  return (int)cudaGetLastError();
}
