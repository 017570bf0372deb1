// K2: per-row stable radix rank of monotone uint64 keys on Hopper.
//
// Replaces the Pallas kernel repro/kernels/forest_eval/rank.py
// (radix_rank_pallas, body _radix_rank_kernel). For every row s of an
// (S, N) key matrix it writes rank[s, i] = position of element i under a
// stable ascending sort of the keys, as float64. With the keys from
// monotone_keys this is the rank of np.argsort(-scores, kind="stable").
//
// Algorithm: 8 LSD passes over 8-bit digits, each a stable counting sort
// of the current permutation. The 8 digit histograms do not depend on the
// permutation, so one sweep over the keys builds all of them (shared-memory
// atomics) and one exclusive scan per digit gives the bases. Each pass then
// walks the row in consecutive tiles of 1024 elements, in order, with a
// running per-digit count: inside a tile an element's offset among equal
// digits is (equal digits in earlier warps of the tile, from per-warp digit
// counts in shared memory) + (equal digits in earlier lanes of its warp,
// __match_any_sync + __popc). That keeps every pass stable across tiles.
// The permutation ping-pongs between two global scratch rows from the
// wrapper (a 131072-key row is 512 KB of int32 per buffer).
//
// What bounds it on this card: the ideal is memory (each key read once,
// each rank written once: 16 bytes per element, 25 MB at 12 x 131072).
// This first version is latency-bound instead: one block per row, 8
// dependent passes with block-wide barriers per tile, and random 8-byte
// key gathers through the permutation. Spreading a row over several blocks
// (a decoupled look-back scan) is the known way to the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 8;

__global__ void __launch_bounds__(kThreads)
radix_rank_kernel(const unsigned long long* __restrict__ keys, double* __restrict__ rank,
                  int* __restrict__ perm_a, int* __restrict__ perm_b, int N) {
  __shared__ int base[kPasses][kBins];
  __shared__ int warp_cnt[kWarps][kBins];
  __shared__ int run[kBins];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t row = (size_t)blockIdx.x * N;
  keys += row;
  rank += row;
  perm_a += row;
  perm_b += row;

  for (int i = tid; i < kPasses * kBins; i += kThreads) (&base[0][0])[i] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    const unsigned long long k = keys[i];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) atomicAdd(&base[p][(k >> (8 * p)) & 0xFF], 1);
  }
  __syncthreads();
  if (tid < kPasses) {  // exclusive scan: histogram -> first slot of each digit
    int acc = 0;
    for (int b = 0; b < kBins; ++b) {
      const int c = base[tid][b];
      base[tid][b] = acc;
      acc += c;
    }
  }

  const int* src = nullptr;  // nullptr = identity permutation (first pass)
  int* dst = perm_a;
  for (int p = 0; p < kPasses; ++p) {
    if (tid < kBins) run[tid] = 0;
    __syncthreads();
    for (int tile = 0; tile < N; tile += kThreads) {
      const int i = tile + tid;
      const bool active = i < N;
      const int e = active ? (src ? src[i] : i) : 0;
      // inactive lanes get a digit no active lane has, so they match none
      const int d = active ? (int)((keys[e] >> (8 * p)) & 0xFF) : kBins + lane;
#pragma unroll
      for (int j = lane; j < kBins; j += 32) warp_cnt[warp][j] = 0;
      __syncwarp();
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      const int before = __popc(peers & lanes_below);
      if (active && before == 0) warp_cnt[warp][d] = __popc(peers);
      __syncthreads();
      if (active) {
        int off = base[p][d] + run[d] + before;
        for (int w = 0; w < warp; ++w) off += warp_cnt[w][d];
        dst[off] = e;
      }
      __syncthreads();
      if (tid < kBins) {
        int c = 0;
        for (int w = 0; w < kWarps; ++w) c += warp_cnt[w][tid];
        run[tid] += c;
      }
      __syncthreads();
    }
    src = dst;
    dst = (dst == perm_a) ? perm_b : perm_a;
  }
  for (int i = tid; i < N; i += kThreads) rank[src[i]] = (double)i;
}

}  // namespace

extern "C" int radix_rank_launch(const void* keys, void* rank, void* perm_a, void* perm_b,
                                 int S, int N, void* stream) {
  if (S <= 0 || N <= 0) return 0;
  radix_rank_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (double*)rank, (int*)perm_a, (int*)perm_b, N);
  return (int)cudaGetLastError();
}
