// K3: Shapley-chain exit-leaf ordinals (QuickScorer walk) on Hopper.
//
// Replaces the Pallas kernel repro/kernels/forest_eval/kernel.py
// (chain_ordinals_pallas, body _chain_kernel); the oracle is the numpy walk
// ChainPlan._leaf_ordinals (kernels/forest_eval/chain.py). For chain c with
// permutation perm[c] (d features), level k in 0..d and background row b,
// the exit leaf of tree t is the lowest set bit of
//     prefix_and_{j < k}(word_x[c, perm[j], t]) & suffix_and_{j >= k}(word_b[b, perm[j], t])
// over W = 1 or 2 uint64 leaf words (word 0 scanned first). Output
// (C, d+1, nb, T) int32.
//
// What bounds it on this card: memory. The work is one 64-bit AND and one
// find-first-set per (chain, level, background row, tree) and word; the
// output alone is 4 * C * (d+1) * nb * T bytes, and each background word is
// read once per chain (it stays in L2: nb * d * T * W * 8 bytes).
//
// Design: one block per chain. The chain's d+1 prefix-AND word vectors are
// built once into shared memory (d <= 64, so (d+1) * T * W * 8 bytes; the
// launcher raises the dynamic shared-memory limit when that passes 48 KB).
// Each thread then owns one (background row, tree) pair and walks the
// levels d..0 with its suffix-AND in registers, so a level costs one shared
// load, one global load and one coalesced int32 store per pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chain_ordinals_kernel(const unsigned long long* __restrict__ wx,
                                      const unsigned long long* __restrict__ wb,
                                      const int* __restrict__ perms, int* __restrict__ out,
                                      int d, int nb, int T, int W) {
  extern __shared__ unsigned long long pref[];  // (d + 1) * T * W words, then d ints
  const int TW = T * W;
  int* sperm = reinterpret_cast<int*>(pref + (size_t)(d + 1) * TW);
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned long long ones = ~0ull;

  for (int i = tid; i < d; i += blockDim.x) sperm[i] = perms[(size_t)c * d + i];
  for (int i = tid; i < TW; i += blockDim.x) pref[i] = ones;
  __syncthreads();
  const unsigned long long* wxc = wx + (size_t)c * d * TW;
  for (int k = 0; k < d; ++k) {
    const unsigned long long* row = wxc + (size_t)sperm[k] * TW;
    for (int i = tid; i < TW; i += blockDim.x)
      pref[(size_t)(k + 1) * TW + i] = pref[(size_t)k * TW + i] & row[i];
    __syncthreads();
  }

  int* outc = out + (size_t)c * (d + 1) * nb * T;
  for (int j = tid; j < nb * T; j += blockDim.x) {
    const int b = j / T;
    const int t = j - b * T;
    const unsigned long long* wbb = wb + (size_t)b * d * TW + (size_t)t * W;
    unsigned long long s0 = ones, s1 = ones;
    for (int k = d; k >= 0; --k) {
      const unsigned long long* pk = pref + (size_t)k * TW + (size_t)t * W;
      const unsigned long long a0 = pk[0] & s0;
      int o;
      if (W == 1 || a0 != 0ull) {
        o = __ffsll((long long)a0) - 1;
      } else {
        o = 63 + __ffsll((long long)(pk[1] & s1));
      }
      outc[((size_t)k * nb + b) * T + t] = o;
      if (k > 0) {
        const unsigned long long* w = wbb + (size_t)sperm[k - 1] * TW;
        s0 &= w[0];
        if (W == 2) s1 &= w[1];
      }
    }
  }
}

}  // namespace

extern "C" int chain_ordinals_launch(const void* word_x, const void* word_b, const void* perms,
                                     void* out, int C, int d, int nb, int T, int W,
                                     void* stream) {
  if (C <= 0) return 0;
  const size_t smem = (size_t)(d + 1) * T * W * sizeof(unsigned long long) + (size_t)d * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_ordinals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = nb * T;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : ((threads + 31) / 32) * 32);
  chain_ordinals_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned long long*)word_x, (const unsigned long long*)word_b, (const int*)perms,
      (int*)out, d, nb, T, W);
  return (int)cudaGetLastError();
}
