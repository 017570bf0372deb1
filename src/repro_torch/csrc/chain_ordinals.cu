// K3: Shapley-chain exit-leaf ordinals (QuickScorer walk) on Hopper, and
// the chain values they give.
//
// Replaces the Pallas kernel repro/kernels/forest_eval/kernel.py
// (chain_ordinals_pallas, body _chain_kernel); the oracle is the numpy walk
// ChainPlan._leaf_ordinals (kernels/forest_eval/chain.py). For chain c with
// permutation perm[c] (d features), level k in 0..d and background row b,
// the exit leaf of tree t is the lowest set bit of
//     prefix_and_{j < k}(word_x[c, perm[j], t]) & suffix_and_{j >= k}(word_b[b, perm[j], t])
// over W = 1 or 2 uint64 leaf words (word 0 scanned first; the second
// word's ordinal is 64 + its lowest set bit). Ordinals are (C, d+1, nb, T)
// int32.
//
// What bounds it on this card: memory. The work is one 64-bit AND and one
// find-first-set per (chain, level, background row, tree) and word; the
// ordinals alone are 4 * C * (d+1) * nb * T bytes (10.46 MB at the tuner's
// largest call, 268 chains x 61 levels x 16 rows x 10 trees), the inputs
// a few hundred KB. Fused with the float tail the output is (C, d+1)
// float64 and the bound falls under a launch.
//
// Three routes (kernels/forest_eval/chain.py::ordinals_plan and
// values_plan pick one):
//
// `staged` (chain_staged_kernel). A grid of (chain group, tree tile)
// blocks of 320 threads, two an SM where shared memory lets: block (g,
// tile) walks chains g, g + groups, ... over the tile's trees. Where one
// block holds every tree there is a block a chain (the blocks on an SM
// overlap one another's phases); tiled trees take one wave of blocks. A
// block copies the tile's background words (nb x d x trees x W) into
// shared memory once, and each chain's words (d x trees x W, from the row x_of_chain[c]
// where given) and permutation into one of two slots, every copy in flight
// at once (cp.async, 16 bytes where aligned): the next chain's copy runs
// while the current chain walks. The
// prefix-AND table ((d+1) x trees x W) is built from shared memory in two
// passes (eight segments of levels scanned side by side, then each ANDed
// with the totals of the segments before it), so no load from device
// memory sits in a dependent chain. The walk of each (background row,
// tree) pair is cut into up to four segments of levels, as many as the
// block's threads hold: a thread owns one (segment, pair), starts from
// the AND of the background words of the segments above it (each upper
// segment's AND is taken beside the prefix table's second pass), and walks
// its levels down with the suffix-AND in registers, reading only shared
// memory, eight levels' loads issued before their stores. Each level's
// ordinals of a chain are stored coalesced, 4 bytes a thread (16-byte
// stores by a thread that owned four pairs measured slower: fewer threads
// to hide the walk's latency). What bounds it here is issue and shared
// memory, not device memory: scripts/chain_variants.py times each part.
//
// `values` (chain_values_kernel): `staged` with all T trees in one block
// and ChainPlan.eval_chains' float tail fused, bit for bit with the torch
// tail (chain.py::chain_tail): one slot of chain words, the next chain's
// copy running while a chain walks and sums; the walk keeps each ordinal
// as a byte in shared memory (rows of T rounded up to 4, read a word at a
// time); then, for each (level, background row), the leaf means
// (staged in shared memory) are gathered and summed in tree order from
// x[0] + 0.0, divided by T, multiplied by y_std and added to y_mean, each a
// separate IEEE operation (built with --fmad=false; the intrinsics say so
// too); then, for each level, numpy's pairwise sum over the background
// rows, + 0.0, divided by nb. Output (C, d+1) float64.
//
// `per_chain` (chain_ordinals_kernel), the first design: one block per
// chain builds the prefix table from device memory one level at a time,
// then each thread walks one (row, tree) pair reading the background words
// from device memory at every level. It takes what `staged` refuses (a
// tree whose background words do not fit a block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kOnes = ~0ull;
constexpr int kThreads = 320;     // the staged routes' block (two an SM at <= 96 registers)
constexpr int kSegs = 8;          // segments of the prefix scan
constexpr int kWalkSegs = 4;      // segments of the levels a (row, tree) pair's walk takes at most
constexpr int kPairwiseDepth = 4; // halvings of the pairwise sum (nb <= 1808)
constexpr int kChunk = 8;         // levels whose loads issue together
constexpr size_t kSmemMax = 232448;

__global__ void chain_ordinals_kernel(const u64* __restrict__ wx, const u64* __restrict__ wb,
                                      const int* __restrict__ perms, int* __restrict__ out,
                                      int d, int nb, int T, int W) {
  extern __shared__ u64 pref[];  // (d + 1) * T * W words, then d ints
  const int TW = T * W;
  int* sperm = reinterpret_cast<int*>(pref + (size_t)(d + 1) * TW);
  const int c = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < d; i += blockDim.x) sperm[i] = perms[(size_t)c * d + i];
  for (int i = tid; i < TW; i += blockDim.x) pref[i] = kOnes;
  __syncthreads();
  const u64* wxc = wx + (size_t)c * d * TW;
  for (int k = 0; k < d; ++k) {
    const u64* row = wxc + (size_t)sperm[k] * TW;
    for (int i = tid; i < TW; i += blockDim.x)
      pref[(size_t)(k + 1) * TW + i] = pref[(size_t)k * TW + i] & row[i];
    __syncthreads();
  }

  int* outc = out + (size_t)c * (d + 1) * nb * T;
  for (int j = tid; j < nb * T; j += blockDim.x) {
    const int b = j / T;
    const int t = j - b * T;
    const u64* wbb = wb + (size_t)b * d * TW + (size_t)t * W;
    u64 s0 = kOnes, s1 = kOnes;
    for (int k = d; k >= 0; --k) {
      const u64* pk = pref + (size_t)k * TW + (size_t)t * W;
      const u64 a0 = pk[0] & s0;
      int o;
      if (W == 1 || a0 != 0ull) {
        o = __ffsll((long long)a0) - 1;
      } else {
        o = 63 + __ffsll((long long)(pk[1] & s1));
      }
      outc[((size_t)k * nb + b) * T + t] = o;
      if (k > 0) {
        const u64* w = wbb + (size_t)sperm[k - 1] * TW;
        s0 &= w[0];
        if (W == 2) s1 &= w[1];
      }
    }
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// every group but the newest (or every group) has landed (this thread's
// copies)
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }


// Byte offsets of a staged block's shared memory; T > 0 is the values
// route's: one slot of chain words (not two), its rows sharing the walk
// segments' totals' place, leaf means, tree offsets and ordinal bytes.
// kernels/forest_eval/chain.py::_smem mirrors `total`.
struct Layout {
  size_t bg, xw0, xw1, pref, seg, tot, lm, rows, pb0, pb1, sperm, offs, ords, total;
  __host__ __device__ Layout(int d, int nb, int trees, int W, int T, int n_leaves) {
    const size_t row = (size_t)trees * W * sizeof(u64);  // one feature's words of the tile
    const bool values = T > 0;
    size_t o = 0;
    bg = o;    o += (size_t)nb * d * row;
    xw0 = o;   o += (size_t)d * row;
    xw1 = o;   o += values ? 0 : (size_t)d * row;
    pref = o;  o += (size_t)(d + 1) * row;
    seg = o;   o += (size_t)kSegs * row;
    tot = o;
    rows = o;
    const size_t tot_bytes = (size_t)kThreads * W * sizeof(u64);
    const size_t rows_bytes = values ? (size_t)(d + 1) * nb * sizeof(double) : 0;
    o += tot_bytes > rows_bytes ? tot_bytes : rows_bytes;
    lm = o;    o += (size_t)n_leaves * sizeof(double);
    pb0 = o;   o += align16((size_t)d * sizeof(int));
    pb1 = o;   o += values ? 0 : align16((size_t)d * sizeof(int));
    sperm = o; o += align16((size_t)d * sizeof(int));
    offs = o;  o += align16((size_t)T * sizeof(int));
    ords = o;  o += values ? align16((size_t)(d + 1) * nb * ((T + 3) & ~3)) : 0;
    total = o;
  }
};

// the index of the lowest set bit, -1 for 0 (__ffsll - 1), from 32-bit halves
__device__ __forceinline__ int lowest_bit(u64 a) {
  const unsigned lo = (unsigned)a, hi = (unsigned)(a >> 32);
  return lo ? __ffs(lo) - 1 : (hi ? 31 + __ffs(hi) : -1);
}

template <int W>
__device__ __forceinline__ int exit_ordinal(u64 a0, u64 a1) {
  if (W == 1 || a0 != 0ull) return lowest_bit(a0);
  return 64 + lowest_bit(a1);
}

// numpy's pairwise sum of n <= 128 values: a plain sum below 8, else eight
// accumulators, their fixed tree, then the remainder
__device__ __forceinline__ double pairwise_block(const double* x, int n) {
  if (n < 8) {
    double acc = x[0];
    for (int i = 1; i < n; ++i) acc = __dadd_rn(acc, x[i]);
    return acc;
  }
  double r0 = x[0], r1 = x[1], r2 = x[2], r3 = x[3], r4 = x[4], r5 = x[5], r6 = x[6], r7 = x[7];
  int i = 8;
  const int stop = n - n % 8;
  for (; i < stop; i += 8) {
    r0 = __dadd_rn(r0, x[i]);
    r1 = __dadd_rn(r1, x[i + 1]);
    r2 = __dadd_rn(r2, x[i + 2]);
    r3 = __dadd_rn(r3, x[i + 3]);
    r4 = __dadd_rn(r4, x[i + 4]);
    r5 = __dadd_rn(r5, x[i + 5]);
    r6 = __dadd_rn(r6, x[i + 6]);
    r7 = __dadd_rn(r7, x[i + 7]);
  }
  double res = __dadd_rn(__dadd_rn(__dadd_rn(r0, r1), __dadd_rn(r2, r3)),
                         __dadd_rn(__dadd_rn(r4, r5), __dadd_rn(r6, r7)));
  for (; i < n; ++i) res = __dadd_rn(res, x[i]);
  return res;
}

// beyond 128 values, halves rounded down to a multiple of 8
template <int D>
__device__ __forceinline__ double pairwise(const double* x, int n) {
  if (n <= 128) return pairwise_block(x, n);
  int n2 = n / 2;
  n2 -= n2 % 8;
  return __dadd_rn(pairwise<D - 1>(x, n2), pairwise<D - 1>(x + n2, n - n2));
}

template <>
__device__ __forceinline__ double pairwise<0>(const double* x, int n) {
  return pairwise_block(x, n);
}

template <int W, bool VALUES>
__device__ __forceinline__ void walk(const u64* __restrict__ words, const int* __restrict__ xoc,
                                     const u64* __restrict__ wb, const int* __restrict__ perms,
                                     int* __restrict__ out, const double* __restrict__ leaf_mean,
                                     const long long* __restrict__ leaf_offs,
                                     double* __restrict__ vals, int C, int d, int nb, int T,
                                     int trees, int n_leaves, double y_std, double y_mean) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, nb, trees, W, VALUES ? T : 0, VALUES ? n_leaves : 0);
  u64* bg = reinterpret_cast<u64*>(smem + L.bg);
  u64* xw0 = reinterpret_cast<u64*>(smem + L.xw0);
  u64* xw1 = reinterpret_cast<u64*>(smem + L.xw1);
  int* pb0 = reinterpret_cast<int*>(smem + L.pb0);
  int* pb1 = reinterpret_cast<int*>(smem + L.pb1);
  u64* pref = reinterpret_cast<u64*>(smem + L.pref);
  u64* seg = reinterpret_cast<u64*>(smem + L.seg);
  u64* tot = reinterpret_cast<u64*>(smem + L.tot);
  int* sperm = reinterpret_cast<int*>(smem + L.sperm);
  double* lm = reinterpret_cast<double*>(smem + L.lm);
  double* rows = reinterpret_cast<double*>(smem + L.rows);
  int* offs = reinterpret_cast<int*>(smem + L.offs);
  unsigned char* ords = smem + L.ords;

  const int tid = threadIdx.x, nth = blockDim.x;
  const int groups = gridDim.x;
  const int t0 = blockIdx.y * trees;
  const int tn = min(trees, T - t0);      // trees of this tile
  const int rw = trees * W, tnW = tn * W; // a feature row's stride and width, in words

  // every copy in flight at once: runs of whole rows as 16-byte copies where
  // source and destination agree modulo 16 (the tile holds every tree)
  auto copy_rows = [&](u64* dst, const u64* src, int rows) {
    if (tn == trees && tn == T &&
        ((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
      const int n = rows * tnW;
      const int head = (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0;
      const int pairs = (n - head) / 2;
      for (int i = tid; i < pairs; i += nth) cp_async16(dst + head + 2 * i, src + head + 2 * i);
      if (tid == 0 && head && n > 0) cp_async8(dst, src);
      if (tid == 0 && head + 2 * pairs < n) cp_async8(dst + n - 1, src + n - 1);
      return;
    }
    for (int i = tid; i < rows * tnW; i += nth) {
      const int r = i / tnW, q = i - r * tnW;
      cp_async8(dst + (size_t)r * rw + q, src + (size_t)r * T * W + q);
    }
  };
  const int bs = d * rw;                  // words from one background row to the next
  copy_rows(bg, wb + (size_t)t0 * W, nb * d);
  if (VALUES) {
    for (int i = tid; i < n_leaves; i += nth) cp_async8(lm + i, leaf_mean + i);
    for (int i = tid; i < T; i += nth) offs[i] = (int)leaf_offs[i];
  }
  auto stage = [&](int c, int slot) {
    const int x = xoc != nullptr ? xoc[c] : c;
    copy_rows(slot ? xw1 : xw0, words + ((size_t)x * d * T + t0) * W, d);
    int* pdst = slot ? pb1 : pb0;
    for (int i = tid; i < d; i += nth) cp_async4(pdst + i, perms + (size_t)c * d + i);
  };
  // staged: two slots, the chain after next copied while a chain walks;
  // values: one slot, the next chain copied while a chain walks and sums
  constexpr int ahead = VALUES ? 1 : 2;
  const int first = blockIdx.x;
  stage(first, 0);
  cp_commit();
  if (!VALUES && first + groups < C) stage(first + groups, 1);
  cp_commit();

  // Loads are issued kChunk at a time before the chunk's stores: a store
  // the compiler cannot tell from the shared words would otherwise hold
  // every following load until it is done.
  const int segs = max(1, min(kSegs, nth / tnW));
  const int seg_len = (d + segs - 1) / segs;
  const int np = nb * tn;                    // (row, tree) pairs of the tile
  const int T4 = (T + 3) & ~3;               // values: a row's ordinal bytes, 4-byte aligned
  const size_t level = (size_t)nb * T;       // ordinals of one level of a chain
  // each pair's levels 0..d in `hs` segments [h * hl, (h + 1) * hl), each
  // walked by its own thread from the AND of the higher segments' words
  const int hs = max(1, min(kWalkSegs, nth / np));
  const int hl = (d + 1 + hs - 1) / hs;
  int slot = 0;
  for (int c = first; c < C; c += groups, slot ^= ahead - 1) {
    const u64* xw = slot ? xw1 : xw0;
    const int* pb = slot ? pb1 : pb0;
    if constexpr (VALUES) {
      cp_wait_all();
    } else {
      cp_wait_all_but_one();
    }
    __syncthreads();
    // the prefix table: each segment of levels scanned alone, its total kept
    for (int u = tid; u < segs * tnW; u += nth) {
      const int s = u / tnW, q = u - s * tnW;
      const int k1 = min(d, (s + 1) * seg_len);
      u64 acc = kOnes;
      for (int k = s * seg_len; k < k1; k += kChunk) {
        u64 w[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) w[i] = k + i < k1 ? xw[(size_t)pb[k + i] * rw + q] : kOnes;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          acc &= w[i];
          if (k + i < k1) pref[(size_t)(k + i + 1) * rw + q] = acc;
        }
      }
      seg[s * rw + q] = acc;
      if (s == 0) pref[q] = kOnes;
    }
    for (int i = tid; i < d; i += nth) sperm[i] = pb[i];
    __syncthreads();
    // ... then ANDed with the totals of the segments before it
    for (int u = tnW + tid; u < segs * tnW; u += nth) {
      const int s = u / tnW, q = u - s * tnW;
      u64 carry = kOnes;
      for (int r = 0; r < s; ++r) carry &= seg[r * rw + q];
      const int k1 = min(d, (s + 1) * seg_len);
      for (int k = s * seg_len; k < k1; k += kChunk) {
        u64 w[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          w[i] = k + i < k1 ? pref[(size_t)(k + i + 1) * rw + q] : 0ull;
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (k + i < k1) pref[(size_t)(k + i + 1) * rw + q] = w[i] & carry;
      }
    }
    // beside it, each upper walk segment's AND of background words: the
    // features perm[j] for j in [h * hl - 1, (h + 1) * hl - 1), those the
    // levels below the segment take in
    for (int u = np + tid; u < hs * np; u += nth) {
      const int h = u / np, p = u - h * np, b = p / tn, tl = p - b * tn;
      const u64* bp = bg + b * bs + tl * W;
      const int j1 = min(d, (h + 1) * hl - 1);
      u64 a0 = kOnes, a1 = kOnes;
      for (int j = h * hl - 1; j < j1; j += kChunk) {
        u64 w0[kChunk], w1[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const size_t o = j + i < j1 ? (size_t)sperm[j + i] * rw : 0;
          w0[i] = j + i < j1 ? bp[o] : kOnes;
          w1[i] = W == 2 && j + i < j1 ? bp[o + W - 1] : kOnes;
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          a0 &= w0[i];
          a1 &= w1[i];
        }
      }
      tot[(size_t)u * W] = a0;
      if constexpr (W == 2) tot[(size_t)u * W + 1] = a1;
    }
    __syncthreads();
    // the chain after next (values: the next) lands in this slot while this
    // one walks
    if (c + ahead * groups < C) stage(c + ahead * groups, slot);
    cp_commit();

    // the walk: each segment's levels from its top down, in chunks of L
    // levels, each chunk's loads first (values: half as many, its tail's
    // registers beside them; at two blocks an SM, 96 a thread, the values
    // kernel spills a word all the same)
    constexpr int L = (VALUES ? kChunk / 2 : kChunk) / W;
    for (int u = tid; u < hs * np; u += nth) {
      const int h = u / np, p = u - h * np, b = p / tn, tl = p - b * tn;
      const u64* bq = bg + b * bs + tl * W;   // 32-bit offsets: shared memory
      const u64* pq = pref + tl * W;
      u64 s0 = kOnes, s1 = kOnes;
      for (int r = h + 1; r < hs; ++r) {
        s0 &= tot[(r * np + p) * W];
        if constexpr (W == 2) s1 &= tot[(r * np + p) * W + 1];
      }
      const int lo = h * hl, top = min(d, (h + 1) * hl - 1);
      int* op = VALUES ? nullptr : out + ((size_t)c * (d + 1) * level + (size_t)b * T + t0 + tl);
      unsigned char* ob = VALUES ? ords + b * T4 + tl : nullptr;
      const int ostep = nb * (VALUES ? T4 : T);
      for (int k = top; k >= lo; k -= L) {
        u64 p0w[L], p1w[L], b0w[L], b1w[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int kk = k - i;
          const int j = kk > lo ? sperm[kk - 1] * rw : 0;
          p0w[i] = kk >= lo ? pq[kk * rw] : 0ull;
          b0w[i] = kk > lo ? bq[j] : kOnes;
          p1w[i] = W == 2 && kk >= lo ? pq[kk * rw + W - 1] : 0ull;
          b1w[i] = W == 2 && kk > lo ? bq[j + W - 1] : kOnes;
        }
        int ord[L];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          ord[i] = exit_ordinal<W>(p0w[i] & s0, p1w[i] & s1);
          s0 &= b0w[i];
          s1 &= b1w[i];
        }
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int kk = k - i;
          if (kk < lo) break;
          if constexpr (VALUES) {
            ob[kk * ostep] = (unsigned char)ord[i];
          } else {
            op[(size_t)kk * ostep] = ord[i];
          }
        }
      }
    }

    if constexpr (VALUES) {
      __syncthreads();
      // each (level, row): the tree mean of its leaf means, denormalised
      const double tdiv = (double)T;
      for (int i = tid; i < (d + 1) * nb; i += nth) {
        // the row's ordinals as 32-bit words, four trees a load
        const unsigned* ow = reinterpret_cast<const unsigned*>(ords + (size_t)i * T4);
        auto ord_at = [&](int t) { return (int)((ow[t >> 2] >> (8 * (t & 3))) & 255u); };
        double s = __dadd_rn(lm[offs[0] + ord_at(0)], 0.0);
        int t = 1;
        for (; t + 2 <= T; t += 2) {   // two trees' loads ahead of their adds
          const double m0 = lm[offs[t] + ord_at(t)], m1 = lm[offs[t + 1] + ord_at(t + 1)];
          s = __dadd_rn(__dadd_rn(s, m0), m1);
        }
        for (; t < T; ++t) s = __dadd_rn(s, lm[offs[t] + ord_at(t)]);
        s = __ddiv_rn(s, tdiv);
        s = __dmul_rn(s, y_std);
        rows[i] = __dadd_rn(s, y_mean);
      }
      __syncthreads();
      // each level: the mean over the background rows
      const double bdiv = (double)nb;
      for (int k = tid; k <= d; k += nth) {
        const double s = __dadd_rn(pairwise<kPairwiseDepth>(rows + (size_t)k * nb, nb), 0.0);
        vals[(size_t)c * (d + 1) + k] = __ddiv_rn(s, bdiv);
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    chain_staged_kernel(const u64* __restrict__ words, const int* __restrict__ xoc,
                        const u64* __restrict__ wb, const int* __restrict__ perms,
                        int* __restrict__ out, int C, int d, int nb, int T, int trees) {
  walk<W, false>(words, xoc, wb, perms, out, nullptr, nullptr, nullptr, C, d, nb, T, trees,
                      0, 0.0, 0.0);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    chain_values_kernel(const u64* __restrict__ words, const int* __restrict__ xoc,
                        const u64* __restrict__ wb, const int* __restrict__ perms,
                        const double* __restrict__ leaf_mean,
                        const long long* __restrict__ leaf_offs, double* __restrict__ vals,
                        int C, int d, int nb, int T, int n_leaves, double y_std,
                        double y_mean) {
  walk<W, true>(words, xoc, wb, perms, nullptr, leaf_mean, leaf_offs, vals, C, d, nb, T, T,
                   n_leaves, y_std, y_mean);
}

// lets `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// whole carveout as shared memory so two such blocks can share an SM
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int chain_ordinals_launch(const void* word_x, const void* word_b, const void* perms,
                                     void* out, int C, int d, int nb, int T, int W,
                                     void* stream) {
  if (C <= 0) return 0;
  const size_t smem = (size_t)(d + 1) * T * W * sizeof(u64) + (size_t)d * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_ordinals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = nb * T;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : ((threads + 31) / 32) * 32);
  chain_ordinals_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
      (const u64*)word_x, (const u64*)word_b, (const int*)perms, (int*)out, d, nb, T, W);
  return (int)cudaGetLastError();
}

// words: (n, d, T, W) rows, chain c's row x_of_chain[c] (or (C, d, T, W)
// with x_of_chain null); a grid of (groups, ceil(T / trees)) blocks.
extern "C" int chain_staged_launch(const void* words, const void* x_of_chain, const void* word_b,
                                   const void* perms, void* out, int C, int d, int nb, int T,
                                   int W, int trees, int groups, int threads, void* stream) {
  if (C <= 0) return 0;
  const int tiles = trees > 0 ? (T + trees - 1) / trees : 0;
  if (d < 1 || nb < 1 || T < 1 || trees < 1 || trees > T || groups < 1 || groups > C ||
      tiles > 65535 || threads < 32 || threads > kThreads || (W != 1 && W != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, nb, trees, W, 0, 0).total;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  void (*kernel)(const u64*, const int*, const u64*, const int*, int*, int, int, int, int, int) =
      W == 1 ? chain_staged_kernel<1> : chain_staged_kernel<2>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(groups, tiles), threads, smem, (cudaStream_t)stream>>>(
      (const u64*)words, (const int*)x_of_chain, (const u64*)word_b, (const int*)perms,
      (int*)out, C, d, nb, T, trees);
  return (int)cudaGetLastError();
}

// vals: (C, d+1) float64; leaf_mean (n_leaves,) float64, leaf_offs (T,)
// int64, every leaf_offs[t] + ordinal inside leaf_mean.
extern "C" int chain_values_launch(const void* words, const void* x_of_chain, const void* word_b,
                                   const void* perms, const void* leaf_mean,
                                   const void* leaf_offs, void* vals, int C, int d, int nb, int T,
                                   int W, int n_leaves, int groups, int threads, double y_std,
                                   double y_mean, void* stream) {
  if (C <= 0) return 0;
  if (d < 1 || nb < 1 || T < 1 || n_leaves < 1 || groups < 1 || groups > C || threads < 32 ||
      threads > kThreads || (W != 1 && W != 2) || nb > 1808)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, nb, T, W, T, n_leaves).total;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  void (*kernel)(const u64*, const int*, const u64*, const int*, const double*, const long long*,
                 double*, int, int, int, int, int, double, double) =
      W == 1 ? chain_values_kernel<1> : chain_values_kernel<2>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<groups, threads, smem, (cudaStream_t)stream>>>(
      (const u64*)words, (const int*)x_of_chain, (const u64*)word_b, (const int*)perms,
      (const double*)leaf_mean, (const long long*)leaf_offs, (double*)vals, C, d, nb, T,
      n_leaves, y_std, y_mean);
  return (int)cudaGetLastError();
}
