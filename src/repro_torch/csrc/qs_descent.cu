// Q1: the merged QuickScorer descent of the fused propose step, on Hopper.
//
// No Pallas original: the reference computes this step with jnp inside its
// jitted propose program (repro/kernels/forest_eval/propose.py,
// _qs_leaf_stats), and the port needs it on the card as a kernel. It
// computes per-tree leaf (mean, var), each (T, N) float64, for N candidate
// rows of X (N, D) through QuickScorer tables merged across every source's
// trees (Lucchese et al., SIGIR'15): per feature j the sorted thresholds
// and a prefix-ANDed false-node table of n_j + 1 rows of T trees' W leaf
// words. A candidate's rank r = #(thr < v) on feature j picks table row r,
// the AND over features leaves each tree's exit leaf as its lowest set bit
// (word 0 first; an empty word counts 64), and the leaf's ordinal indexes
// the leaf stats. There is no float arithmetic, only compares, so the
// result is bit-identical to the descent's `v > thr` routing.
//
// What bounds it on this card: the table reads, from L2. A candidate reads
// one row of T W words per feature with a threshold: 60 x 120 x 8 bytes,
// about 58 KB, at the tuner's 60 knobs and 120 trees, some 7.5 GB of L2
// traffic at 131072 candidates, where the bytes it must move (X in, the
// two (T, N) outputs) take 0.094 ms at the memory rate.
//
// Design (the first, simple one): a block takes 32 candidates and a chunk
// of 128 trees. Its 256 threads first rank the 32 x D (candidate, feature)
// pairs by binary search, each pair's table row into shared memory; then a
// warp a candidate, the lanes over trees (four a lane), ANDs the rows'
// words, coalesced across the warp; each exit leaf's index goes to shared
// memory, and the block writes the two outputs a tree row at a time, 32
// neighbouring candidates a warp. T and W come from `meta` on the device,
// so a captured CUDA graph replays the kernel for any plane whose tables
// fit its buffers; rows of the outputs at or past T are left as they were.

#include <cuda_runtime.h>
#include <stdint.h>

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
