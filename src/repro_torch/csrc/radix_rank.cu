// K2: per-row stable rank of monotone uint64 keys on Hopper.
//
// Replaces the Pallas kernel repro/kernels/forest_eval/rank.py
// (radix_rank_pallas, body _radix_rank_kernel). For every row s of an
// (S, N) key matrix it writes rank[s, i] = position of element i under a
// stable ascending sort of the keys, as float64. With the keys from
// monotone_keys this is the rank of np.argsort(-scores, kind="stable").
//
// What bounds it on this card: memory. Each key read once and each rank
// written once is 16 bytes an element (25 MB at 12 x 131072, 0.0075 ms).
// A radix sort moves more: the onesweep design below carries (key, index)
// pairs through 8 passes, 24 bytes an element a pass, which puts its own
// floor near 0.10 ms there.
//
// Three routes (kernels/forest_eval/rank.py::rank_route picks one):
//
// `count` (radix_rank_count), for short rows (the tuner's rows are 256
// keys). A block loads its row's keys into shared memory; each thread ranks
// one element by counting, rank(i) = #{j < i : k_j <= k_i} + #{j > i :
// k_j < k_i}, which is stable by construction. The loop over j splits at
// the warp's first and last element, so each part runs one unsigned 64-bit
// compare a key, warp-uniform, over keys every lane reads at once. No
// digit passes, no global scratch, one barrier; ranks leave coalesced.
//
// `onesweep` (onesweep_hist, onesweep_pass), for long rows (12 x 131072 at
// the fused propose step's scale). 8 LSD passes over 8-bit digits:
//   - onesweep_hist: many blocks a row build the row's 8 digit histograms
//     (shared-memory atomics, added to global memory); the last block of
//     a row to finish scans them to each digit's first slot, lists the
//     passes that are not trivial (a pass whose digit is one value for the
//     whole row is the identity), and clears the histograms for the next
//     call. Nothing goes back to the host.
//   - onesweep_pass, launched 8 times: launch k runs the row's k-th
//     non-trivial pass (its blocks exit at once past the row's count) on
//     a grid of (tile, row). A tile is 256 threads x 16 keys, each warp 512
//     consecutive elements in 16 rounds of 32: the (key, index) pairs are
//     read coalesced from the previous pass (the keys themselves and i at
//     the first), never gathered through a permutation. An element's
//     offset among equal digits in its tile is the warp's running count
//     (__match_any_sync, one shared-memory counter a (warp, digit)) plus
//     the counts of earlier warps. Tiles take ids in order from an atomic
//     counter; the tile's digit counts go out as status words (flag in the
//     top two bits: aggregate, or inclusive of every earlier tile; count
//     in the rest) and a decoupled look-back over earlier tiles' words,
//     16 read at once, gives each digit's global offset. The tile's pairs
//     are sorted by digit in shared memory, then leave in that order for
//     base[digit] + prefix + offset, so neighbouring threads store
//     neighbouring slots (runs of 16 pairs a digit on average, where an
//     unsorted scatter stores 32 sectors a warp store); the last pass
//     writes rank[index] = position in float64 instead, straight from
//     registers. A row whose keys are all equal gets rank = i at launch 0.
//   - Workspace (rank.py caches it per device and stream): the two pair
//     buffers, the histograms (zero between calls), the per-row plan, and
//     two regions of tile counters and status words. Launch k uses region
//     k % 2 and clears the other for launch k + 1, so every call finds
//     its regions at zero without a memset.
//
// `block` (radix_rank_kernel), the first design: one 1024-thread block a
// row, 8 dependent passes over the row in 1024-element tiles with three
// barriers a tile, keys gathered through a permutation in global scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 8;

__global__ void __launch_bounds__(kThreads)
radix_rank_kernel(const u64* __restrict__ keys, double* __restrict__ rank,
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
    const u64 k = keys[i];
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

// ---------------------------------------------------------------- count

constexpr int kCountThreads = 128;

__global__ void __launch_bounds__(kCountThreads)
radix_rank_count(const u64* __restrict__ keys, double* __restrict__ rank, int N) {
  extern __shared__ u64 row_keys[];
  const size_t row = (size_t)blockIdx.y * N;
  keys += row;
  rank += row;
  for (int j = threadIdx.x; j < N; j += kCountThreads) row_keys[j] = __ldg(keys + j);
  __syncthreads();
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  const int first = blockIdx.x * kCountThreads + (threadIdx.x & ~31);  // the warp's first
  if (first >= N) return;
  const int last = min(first + 32, N);
  const u64 k = row_keys[min(i, N - 1)];
  int c = 0;
#pragma unroll 8
  for (int j = 0; j < first; ++j) c += row_keys[j] <= k;
  for (int j = first; j < last; ++j) c += j < i ? row_keys[j] <= k : row_keys[j] < k;
#pragma unroll 8
  for (int j = last; j < N; ++j) c += row_keys[j] < k;
  if (i < N) rank[i] = (double)c;
}

// ------------------------------------------------------------- onesweep

constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kItems = 16;                               // keys a thread
constexpr int kTile = kSweepThreads * kItems;            // keys a tile
constexpr int kPlanWords = kPasses * kBins + kPasses + 1;  // bases, pass list, its length
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kCountMask = kAggregate - 1u;
constexpr int kLookBack = 16;                            // status words read at once
static_assert(kSweepThreads == kBins, "one thread a digit in the look-back");

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// grid (blocks a row, S); each block counts `chunk` keys of its row
__global__ void __launch_bounds__(kSweepThreads)
onesweep_hist(const u64* __restrict__ keys, int* __restrict__ hist, int* __restrict__ done,
              int* __restrict__ plan, int N, int chunk) {
  __shared__ int h[kPasses * kBins];
  __shared__ int trivial[kPasses];
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  keys += (size_t)row * N;
  hist += row * kPasses * kBins;
  plan += row * kPlanWords;
  for (int j = tid; j < kPasses * kBins; j += kSweepThreads) h[j] = 0;
  __syncthreads();
  const int begin = blockIdx.x * chunk;
  const int end = min(N, begin + chunk);
  for (int i = begin + tid; i < end; i += kSweepThreads) {
    const u64 k = __ldg(keys + i);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) atomicAdd(&h[p * kBins + ((k >> (8 * p)) & 0xFF)], 1);
  }
  __syncthreads();
  for (int j = tid; j < kPasses * kBins; j += kSweepThreads)
    if (h[j]) atomicAdd(&hist[j], h[j]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&done[row], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // warp w scans pass w: lane l holds bins 8l .. 8l + 7
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int c[8];
  int sum = 0;
  bool whole = false;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    c[b] = __ldcg(&hist[warp * kBins + lane * 8 + b]);
    whole |= c[b] == N;
    sum += c[b];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  int acc = incl - sum;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    plan[warp * kBins + lane * 8 + b] = acc;
    acc += c[b];
    hist[warp * kBins + lane * 8 + b] = 0;
  }
  const bool skip = __any_sync(0xFFFFFFFFu, whole);
  if (lane == 0) trivial[warp] = skip;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int p = 0; p < kPasses; ++p)
      if (!trivial[p]) plan[kPasses * kBins + n++] = p;
    plan[kPasses * kBins + kPasses] = n;
    done[row] = 0;
  }
}

// grid (tiles, S). sync holds two regions of `region` words: S tile
// counters, then S * tiles * 256 status words.
__global__ void __launch_bounds__(kSweepThreads)
onesweep_pass(const u64* __restrict__ keys, u64* __restrict__ key_a, u64* __restrict__ key_b,
              int* __restrict__ idx_a, int* __restrict__ idx_b, double* __restrict__ rank,
              const int* __restrict__ plan, int* __restrict__ sync, int region, int N, int k) {
  __shared__ u64 sorted[kTile];               // the tile in digit order (keys, then indices)
  __shared__ unsigned char sorted_digit[kTile];
  __shared__ int wcount[kSweepWarps][kBins];  // per warp, then exclusive over warps
  __shared__ int tile_start[kBins];           // first slot of each digit in the tile's order
  __shared__ int shift_out[kBins];            // global slot of a digit's run, less its tile slot
  __shared__ int warp_sum[kSweepWarps];
  __shared__ int tile_id;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.y;
  const int S = gridDim.y;
  const int tiles = gridDim.x;

  {  // clear the other region for launch k + 1
    int* other = sync + ((k + 1) & 1) * region;
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    const int stride = gridDim.x * gridDim.y * kSweepThreads;
    for (int i = b * kSweepThreads + tid; i < region; i += stride) other[i] = 0;
  }
  const int* pl = plan + row * kPlanWords;
  const int n_pass = pl[kPasses * kBins + kPasses];
  const size_t off_row = (size_t)row * N;
  if (n_pass == 0) {  // every key of the row equal: rank = index
    if (k == 0)
      for (int i = blockIdx.x * kTile + tid; i < min(N, (blockIdx.x + 1) * kTile);
           i += kSweepThreads)
        rank[off_row + i] = (double)i;
    return;
  }
  if (k >= n_pass) return;
  const int shift = 8 * pl[kPasses * kBins + k];
  const bool last = k == n_pass - 1;
  int* counters = sync + (k & 1) * region;
  unsigned* status = reinterpret_cast<unsigned*>(counters + S) + (size_t)row * tiles * kBins;
  const u64* src_key = (k == 0 ? keys : ((k - 1) & 1 ? key_b : key_a)) + off_row;
  const int* src_idx = ((k - 1) & 1 ? idx_b : idx_a) + off_row;
  u64* dst_key = (k & 1 ? key_b : key_a) + off_row;
  int* dst_idx = (k & 1 ? idx_b : idx_a) + off_row;

  if (tid == 0) tile_id = atomicAdd(&counters[row], 1);
  for (int j = lane; j < kBins; j += 32) wcount[warp][j] = 0;
  __syncthreads();
  const int tile = tile_id;

  // the warp's 512 consecutive elements, 32 a round
  const int e0 = tile * kTile + warp * (kItems * 32) + lane;
  const unsigned below = (1u << lane) - 1u;
  u64 key[kItems];
  int idx[kItems];
  int off[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int e = e0 + r * 32;
    const bool valid = e < N;
    key[r] = valid ? src_key[e] : 0ull;
    idx[r] = valid ? (k == 0 ? e : src_idx[e]) : -1;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool valid = idx[r] >= 0;
    // a lane past the row gets a digit of its own, which matches no other
    const int d = valid ? (int)((key[r] >> shift) & 0xFF) : kBins + lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank_in = __popc(peers & below);
    const int cur = valid ? wcount[warp][d] : 0;
    __syncwarp();
    if (valid && rank_in == 0) wcount[warp][d] = cur + __popc(peers);
    __syncwarp();
    off[r] = cur + rank_in;
  }
  __syncthreads();

  {  // thread d: the tile's count of digit d, its slot in the tile, its
     // global offset by look-back
    const int d = tid;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSweepWarps; ++w) {
      const int c = wcount[w][d];
      wcount[w][d] = total;
      total += c;
    }
    int excl = 0;
    if (tile == 0) {
      store_status(&status[d], kInclusive | (unsigned)total);
    } else {
      store_status(&status[tile * kBins + d], kAggregate | (unsigned)total);
      // read kLookBack earlier tiles' words at once; take them in order up
      // to the first inclusive one, or reread from the first not yet set
      bool done = false;
      for (int p = tile - 1; !done;) {
        unsigned w[kLookBack];
#pragma unroll
        for (int j = 0; j < kLookBack; ++j)
          w[j] = p - j >= 0 ? load_status(&status[(p - j) * kBins + d]) : kInclusive;
        bool stop = false;
        int used = 0;
#pragma unroll
        for (int j = 0; j < kLookBack; ++j) {
          if (!stop && (w[j] & ~kCountMask)) {
            excl += (int)(w[j] & kCountMask);
            used = j + 1;
            stop = done = (w[j] & kInclusive) != 0;
          } else {
            stop = true;
          }
        }
        p -= used;
      }
      store_status(&status[tile * kBins + d], kInclusive | (unsigned)(excl + total));
    }
    // exclusive scan of the tile's digit counts: each digit's first slot
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int start = incl - total;
    for (int w = 0; w < warp; ++w) start += warp_sum[w];
    tile_start[d] = start;
    shift_out[d] = pl[(shift >> 3) * kBins + d] + excl - start;
  }
  __syncthreads();

  // each element's slot in the tile's digit order
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (idx[r] < 0) continue;
    const int d = (int)((key[r] >> shift) & 0xFF);
    const int slot = tile_start[d] + wcount[warp][d] + off[r];
    if (last) {
      rank[off_row + idx[r]] = (double)(shift_out[d] + slot);
    } else {
      sorted[slot] = key[r];
      sorted_digit[slot] = (unsigned char)d;
      off[r] = slot;
    }
  }
  if (last) return;
  __syncthreads();
  // the tile's runs of equal digits go out in order: neighbouring threads
  // store neighbouring slots
  const int n_tile = min(kTile, N - tile * kTile);
  for (int i = tid; i < n_tile; i += kSweepThreads)
    dst_key[shift_out[sorted_digit[i]] + i] = sorted[i];
  __syncthreads();
  int* sorted_idx = reinterpret_cast<int*>(sorted);
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (idx[r] >= 0) sorted_idx[off[r]] = idx[r];
  __syncthreads();
  for (int i = tid; i < n_tile; i += kSweepThreads)
    dst_idx[shift_out[sorted_digit[i]] + i] = sorted_idx[i];
}

}  // namespace

extern "C" int radix_rank_launch(const void* keys, void* rank, void* perm_a, void* perm_b,
                                 int S, int N, void* stream) {
  if (S <= 0 || N <= 0) return 0;
  radix_rank_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)keys, (double*)rank, (int*)perm_a, (int*)perm_b, N);
  return (int)cudaGetLastError();
}

extern "C" int radix_rank_count_launch(const void* keys, void* rank, int S, int N,
                                       void* stream) {
  if (S <= 0 || N <= 0) return 0;
  if ((size_t)N * sizeof(u64) > 48 * 1024 || S > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kCountThreads - 1) / kCountThreads, S);
  radix_rank_count<<<grid, kCountThreads, N * sizeof(u64), (cudaStream_t)stream>>>(
      (const u64*)keys, (double*)rank, N);
  return (int)cudaGetLastError();
}

// hist: S * 2048 ints and done: S ints, zero between calls; plan: S *
// kPlanWords ints; sync: 2 * region ints, zero between calls, region >= S
// + S * tiles * 256.
extern "C" int radix_rank_onesweep_launch(const void* keys, void* rank, void* key_a, void* key_b,
                                          void* idx_a, void* idx_b, void* hist, void* done,
                                          void* plan, void* sync, int S, int N, int region,
                                          int hist_blocks, void* stream) {
  if (S <= 0 || N <= 0) return 0;
  const int tiles = (N + kTile - 1) / kTile;
  if (S > 65535 || hist_blocks <= 0 || N >= (1 << 30) ||
      (long long)region < (long long)S + (long long)S * tiles * kBins)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk = (N + hist_blocks - 1) / hist_blocks;
  onesweep_hist<<<dim3((N + chunk - 1) / chunk, S), kSweepThreads, 0, st>>>(
      (const u64*)keys, (int*)hist, (int*)done, (int*)plan, N, chunk);
  cudaError_t e = cudaGetLastError();
  for (int k = 0; k < kPasses && e == cudaSuccess; ++k) {
    onesweep_pass<<<dim3(tiles, S), kSweepThreads, 0, st>>>(
        (const u64*)keys, (u64*)key_a, (u64*)key_b, (int*)idx_a, (int*)idx_b, (double*)rank,
        (const int*)plan, (int*)sync, region, N, k);
    e = cudaGetLastError();
  }
  return (int)e;
}
