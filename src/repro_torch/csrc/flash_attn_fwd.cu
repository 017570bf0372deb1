// K4: FlashAttention-2 forward on Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attn/kernel.py
// (flash_fwd_pallas, body _fwd_kernel). Computes, for q (BH, Sq, G, D) and
// k, v (BH, Sk, D) in grouped-query layout (BH = batch * kv heads, G query
// heads per kv head), o (BH, Sq, G, D) in q's dtype and lse (BH, Sq, G) in
// float32, with the reference's arithmetic: q upcast to float32 and scaled
// by 1/sqrt(D), an online-softmax recurrence in float32 with the masked
// score -1e30, o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). The
// mask is positional: query row r sits at position q_offset + r / G, key j
// at j; causal keeps j <= position, a window keeps position - j < window.
// KV tiles that no row of a q tile may see (past the causal diagonal or
// before the window) are skipped: the recurrence would wipe their
// contribution to exactly zero. That holds only for rows that see some
// key. A row that sees none (a window that ends before key 0 or starts past
// Sk - 1) keeps m = -1e30, so every masked score gets p = exp(0) = 1 and
// the reference returns the mean of all V rows with lse = -1e30; a q tile
// holding such a row therefore walks every KV tile. Keys past Sk get p = 0
// and q rows past Sq * G are not written.
//
// What bounds it on this card: operations. A causal prefill at llama3-8b's
// width (16 x 4096 x 4 rows, D = 128) does 2.75e11 flop over the visible
// (query, key) pairs against 0.2 GB of q, k, v, o and lse; at the tensor
// cores' 989 TFLOP/s that is 0.278 ms, against 0.05 ms of bytes.
//
// Two routes, one per dtype.
//
// bfloat16: flash_fwd_hopper, both products on the tensor cores.
// - A block of 384 threads takes 128 flattened q rows of one (batch, kv
//   head): warpgroup 0 is the producer (one thread issues every TMA load,
//   setmaxnreg gives its registers away), warpgroups 1 and 2 the consumers,
//   64 rows each. The q tile is loaded once; K and V tiles of 128 keys
//   stream through two shared-memory stages, each guarded by a "full"
//   mbarrier (TMA's bytes) and an "empty" one (the consumers' 8 warps).
// - Tiles are 128-byte-swizzled atoms of 64 columns from 3-D tensor maps
//   (D, rows, BH), encoded on the host for each call, so a box past Sq * G
//   or Sk reads zeros inside its own head (a 2-D map would read the next
//   head's keys; zeroed V rows keep p * v finite). Every D in {16, 32, 64,
//   80, 128} takes one layout: the columns past D are zero-filled and cost
//   shared memory, no arithmetic (cuTensorMapEncodeTiled takes a 64-column
//   box over a tensor of 16 or 32 columns).
// - S = Q . K^T is wgmma m64n128k16 with both operands in shared memory
//   (D / 16 steps); the online softmax runs in float32 on the accumulator
//   registers, each row's max and sum reduced over the 4 threads that hold
//   it, with exp2 and log2(e) folded in: p = 2^(s log2 e - m log2 e).
// - P goes back as the register A operand of O += P . V (wgmma m64nDk16,
//   V the MN-major B operand), repacked from the accumulator fragment with
//   no trip through shared memory, split in two bf16 halves, hi = bf16(p)
//   and lo = bf16(p - hi), each its own product into the same float32 O.
//   One bf16 P would round p to 2^-9 relative; where a row's output
//   cancels to near 0 that exceeds the bf16 gate's 1e-3 absolute
//   (tests/test_torch_flash_split.py, seeded causal cases on the CPU: G =
//   4, D = 128, 2 x 1024 positions, 43 of 1048576 elements out, 5565 with
//   inputs x 3; G = 1, D = 80, 2 x 256: 6 of 40960; hi + lo: none, about 16
//   bits of p). The second product costs half the function's tensor-core
//   work again: the kernel's own floor at the serve shape is 0.417 ms, 1.5
//   x the function's 0.278 ms bound.
// - Blocks take q tiles heaviest first (the causal tail is the last tile
//   of each head), so short tiles fill the SMs at the end.
// - A consumer runs each tile in order: Q . K^T, wait, softmax, P . V,
//   wait; its softmax never overlaps its own products (the two consumers
//   interleave on the SM instead). Overlapping them, and a TMA store of O,
//   are work for a later PR. At the serve shape this takes 0.87 ms on an
//   H100, 48 % of the tensor cores' peak on the kernel's own work
//   (PERF.md section 6).
//
// float32: flash_fwd_kernel (namespace simt), the CUDA-core design of the
// first port, for the float32 gate of 2e-5 that TF32 cannot meet: one
// block of 256 threads per tile of 64 rows, 64-key tiles staged as float32
// in shared memory, both products as fmaf, each thread a 4 x 4 patch of
// the scores and 4 x D/16 of the accumulator. Its bf16 instantiation stays
// exported as flash_attn_fwd_bf16_simt, for timing the two designs side by
// side; the wrappers never reach it.
//
// The port builds with --fmad=false: every fused multiply-add is written
// as fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct TileRange {
  int begin, end;
};

// The KV tiles of `bn` keys that flattened q rows r0 ... r_last may see;
// all of them when one of the rows sees no key (such rows lie at the ends
// of the position range).
__device__ __forceinline__ TileRange kv_tiles(int r0, int r_last, int G, int Sk, int bn,
                                              int causal, int has_window, int window,
                                              int q_offset) {
  const int p_lo = q_offset + r0 / G;
  const int p_hi = q_offset + r_last / G;
  auto sees_none = [&](int p) {
    const int hi = causal ? min(Sk, p + 1) : Sk;
    const int lo = has_window ? max(0, p - window + 1) : 0;
    return hi <= lo;
  };
  int k_end = Sk, k_begin = 0;
  if (!sees_none(p_lo) && !sees_none(p_hi)) {
    if (causal) k_end = max(0, min(Sk, p_hi + 1));
    if (has_window) k_begin = max(0, p_lo - window + 1);
  }
  const int t_begin = k_begin / bn;
  return {t_begin, k_end > k_begin ? (k_end + bn - 1) / bn : t_begin};
}

// ------------------------------------------------- float32: CUDA cores

namespace simt {


constexpr int BM = 64;   // flattened q rows (position x group) per block
constexpr int BN = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  // sQ (BM x D+1), sK (BN x D+1), sV (BN x D), sS (BM x BN+1), corr, l
  return sizeof(float) * (size_t)(BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int G, int causal,
    int has_window, int window, int q_offset, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DQ = D + 1;   // padded row stride of sQ and sK
  constexpr int SS = BN + 1;  // padded row stride of sS
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * DQ;
  float* sV = sK + BN * DQ;
  float* sS = sV + BN * D;
  float* sCorr = sS + BM * SS;
  float* sL = sCorr + BM;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;    // product mapping: rows ty+16i, cols tx+16j
  const int srow = tid >> 2, spart = tid & 3;  // softmax mapping: 4 threads per row
  const int rows = Sq * G;
  const int r0 = blockIdx.x * BM;
  const int64_t bh = blockIdx.y;
  const T* qb = q + bh * rows * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;

  for (int e = tid; e < BM * D; e += NT) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    sQ[r * DQ + c] = gr < rows ? to_f32(qb[(int64_t)gr * D + c]) * scale : 0.f;
  }

  const TileRange tr = kv_tiles(r0, min(r0 + BM, rows) - 1, G, Sk, BN, causal, has_window, window,
                                q_offset);
  const int t_begin = tr.begin, t_end = tr.end;

  const int qpos = q_offset + (r0 + srow) / G;  // this thread's softmax row
  float m_i = kNegInf, l_i = 0.f;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's sK, sV and sS are consumed
    for (int e = tid; e < BN * D; e += NT) {
      const int r = e / D, c = e % D;
      const int kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < Sk) {
        kx = to_f32(kb[(int64_t)kr * D + c]);
        vx = to_f32(vb[(int64_t)kr * D + c]);
      }
      sK[r * DQ + c] = kx;
      sV[r * D + c] = vx;
    }
    __syncthreads();

    // scores: S = (q * scale) . k^T
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * DQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sS[(ty + 16 * i) * SS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // online softmax over this tile, four threads per row
    {
      float x[16];
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = (jj & 7) + 8 * spart + 32 * (jj >> 3);
        const int kpos = k0 + c;
        const bool ok = (!causal || qpos >= kpos) && (!has_window || qpos - kpos < window);
        x[jj] = ok ? sS[srow * SS + c] : kNegInf;
        if (kpos < Sk) mt = fmaxf(mt, x[jj]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_i, mt);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = (jj & 7) + 8 * spart + 32 * (jj >> 3);
        const float p = k0 + c < Sk ? expf(x[jj] - m_new) : 0.f;
        sS[srow * SS + c] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + rs;
      m_i = m_new;
      if (spart == 0) sCorr[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sCorr[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  __syncthreads();
  if (spart == 0) {
    sL[srow] = l_i;
    if (r0 + srow < rows) lse[bh * rows + r0 + srow] = m_i + logf(fmaxf(l_i, 1e-30f));
  }
  __syncthreads();
  T* ob = o + bh * rows * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty + 16 * i;
    if (gr >= rows) continue;
    const float denom = fmaxf(sL[ty + 16 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_as(ob + (int64_t)gr * D + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
             int Sk, int G, int causal, int has_window, int window, int q_offset,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the reference scales by float32(1 / np.sqrt(D)), rounded from double
  const float scale = (float)(1.0 / sqrt((double)D));
  const int rows = Sq * G;
  dim3 grid((rows + BM - 1) / BM, BH);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, G, causal, has_window,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
           int Sk, int G, int D, int causal, int has_window, int window, int q_offset,
           void* stream) {
  if (BH <= 0 || Sq <= 0 || G <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(q, k, v, o, lse, BH, Sq, Sk, G, causal, has_window, window, q_offset, st);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}


}  // namespace simt

// ---------------------------------------- bfloat16: wgmma, TMA, mbarrier

namespace hop {

using namespace hopper;

constexpr int BM = 128;     // flattened q rows a block: two consumer warpgroups of 64
constexpr int BN = 128;     // keys a tile
constexpr int STAGES = 2;   // K/V tiles in flight
constexpr int NT = 384;     // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int ATOMS = (D + 63) / 64;         // 64-column swizzle atoms a row
  static constexpr int Q_BYTES = ATOMS * BM * 128;    // the q tile
  static constexpr int KV_BYTES = ATOMS * BN * 128;   // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 bytes of slack to align the tiles to the swizzle period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

// One consumer row's softmax step over its 32 scores of the tile (s[4i + e]
// and s[4i + 2 + e], h = 0 or 2 picks the row): the new max m, the
// correction exp(m_old - m) and the tile's sum of p, p written over s.
template <int H>
__device__ __forceinline__ float softmax_row(float (&s)[64], float& m, float& l) {
  float mt = kNegInf;
#pragma unroll
  for (int i = 0; i < 16; ++i) mt = fmaxf(mt, fmaxf(s[4 * i + H], s[4 * i + H + 1]));
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
  const float m_new = fmaxf(m, mt);
  float rs = 0.f;
  if (m_new == kNegInf) {
    // the row has seen no key yet: masked scores (-1e30) get exp(0) = 1,
    // keys past Sk (-inf) get 0
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = s[4 * i + H + e] == kNegInf ? 1.f : 0.f;
        s[4 * i + H + e] = p;
        rs += p;
      }
  } else {
    const float ml = m_new * kLog2e;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[4 * i + H + e], kLog2e, -ml));
        s[4 * i + H + e] = p;
        rs += p;
      }
  }
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  rs += __shfl_xor_sync(0xffffffffu, rs, 2);
  const float corr = exp2f((m - m_new) * kLog2e);
  l = l * corr + rs;
  m = m_new;
  return corr;
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int BH, int Sq, int Sk, int G, int causal, int has_window,
    int window, int q_offset, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16 up to 128");
  using S = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + S::Q_BYTES;            // STAGES K tiles
  const uint32_t sV = sK + STAGES * S::KV_BYTES;  // STAGES V tiles
  const uint32_t bar = sV + STAGES * S::KV_BYTES;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (STAGES + s); };
  const uint32_t qbar = bar + 8u * 2 * STAGES;

  // q tiles heaviest first: the linear block index walks the tiles from the
  // last (the most keys under a causal mask) down, every head at each step
  const int rows = Sq * G;
  const int n_qt = (int)gridDim.x;
  const int64_t lin = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = n_qt - 1 - (int)(lin / BH);
  const int bh = (int)(lin % BH);
  const int r0 = qt * BM;
  const TileRange tr = kv_tiles(r0, min(r0 + BM, rows) - 1, G, Sk, BN, causal, has_window,
                                window, q_offset);
  const int n_tiles = tr.end - tr.begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qbar, S::Q_BYTES);
#pragma unroll
      for (int a = 0; a < S::ATOMS; ++a) tma_load_3d(sQ + a * BM * 128, &tq, qbar, 64 * a, r0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * S::KV_BYTES);
        const int k0 = (tr.begin + it) * BN;
#pragma unroll
        for (int a = 0; a < S::ATOMS; ++a) {
          tma_load_3d(sK + s * S::KV_BYTES + a * BN * 128, &tk, full(s), 64 * a, k0, bh);
          tma_load_3d(sV + s * S::KV_BYTES + a * BN * 128, &tv, full(s), 64 * a, k0, bh);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int rowA = r0 + 64 * cw + 16 * warp + lane / 4;  // rows of s[4i + {0,1}]
  const int rowB = rowA + 8;                             // rows of s[4i + {2,3}]
  const int colq = 2 * (lane % 4);                       // first column of each 8
  // each row's visible keys [lo, hi): hi <= lo for a row that sees none
  const int posA = q_offset + rowA / G, posB = q_offset + rowB / G;
  const int hiA = causal ? min(Sk, posA + 1) : Sk, hiB = causal ? min(Sk, posB + 1) : Sk;
  const int loA = has_window ? max(0, posA - window + 1) : 0;
  const int loB = has_window ? max(0, posB - window + 1) : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  const uint32_t q_base = sQ + 64 * cw * 128;
  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = (tr.begin + it) * BN;
    mbar_wait(full(s), (it / STAGES) & 1);

    // S = Q . K^T, raw (unscaled) float32
    float sc[64];
    const uint32_t k_base = sK + s * S::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * BM * 128 + (ks % 4) * 32;
      const uint32_t koff = (ks / 4) * BN * 128 + (ks % 4) * 32;
      wgmma_ss_m64n128k16(sc, desc_sw128(q_base + off, 16, 1024),
                          desc_sw128(k_base + koff, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // scale; on a tile that is not wholly visible to both rows, masked
    // scores become -1e30 and keys past Sk -inf
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale;
    if (k0 < max(loA, loB) || k0 + BN > min(hiA, hiB)) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * i + colq + e;
          const float past = -INFINITY;
          if (kp >= Sk) {
            sc[4 * i + e] = past;
            sc[4 * i + 2 + e] = past;
          } else {
            if (kp < loA || kp >= hiA) sc[4 * i + e] = kNegInf;
            if (kp < loB || kp >= hiB) sc[4 * i + 2 + e] = kNegInf;
          }
        }
    }
    const float corrA = softmax_row<0>(sc, mA, lA);
    const float corrB = softmax_row<2>(sc, mB, lB);

    // O = O * corr + P . V, P as hi + lo bf16 halves
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16_pair(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1], ph[j][r], pl[j][r]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= corrA;
      acc[4 * i + 1] *= corrA;
      acc[4 * i + 2] *= corrB;
      acc[4 * i + 3] *= corrB;
    }
    const uint32_t v_base = sV + s * S::KV_BYTES;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_rs<D>(acc, ph[j], desc_sw128(v_base + j * 2048, BN * 128, 1024), 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_rs<D>(acc, pl[j], desc_sw128(v_base + j * 2048, BN * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // o = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30))
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
  const int64_t head = (int64_t)bh * rows;
  if (lane % 4 == 0) {
    if (rowA < rows) lse[head + rowA] = mA + logf(dA);
    if (rowB < rows) lse[head + rowB] = mB + logf(dB);
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + colq;
    if (rowA < rows)
      *reinterpret_cast<__nv_bfloat162*>(o + (head + rowA) * D + c) =
          __floats2bfloat162_rn(acc[4 * i] / dA, acc[4 * i + 1] / dA);
    if (rowB < rows)
      *reinterpret_cast<__nv_bfloat162*>(o + (head + rowB) * D + c) =
          __floats2bfloat162_rn(acc[4 * i + 2] / dB, acc[4 * i + 3] / dB);
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
             int Sk, int G, int causal, int has_window, int window, int q_offset,
             cudaStream_t stream) {
  using S = Shape<D>;
  // TMA reads from 16-byte-aligned addresses
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorMisalignedAddress;
  const uint64_t rows = (uint64_t)Sq * G;
  CUtensorMap tq, tk, tv;
  int rc = encode_bf16_3d_sw128(&tq, q, D, rows, BH, BM);
  if (rc == 0) rc = encode_bf16_3d_sw128(&tk, k, D, Sk, BH, BN);
  if (rc == 0) rc = encode_bf16_3d_sw128(&tv, v, D, Sk, BH, BN);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_hopper<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((unsigned)((rows + BM - 1) / BM), BH);
  flash_fwd_hopper<D><<<grid, NT, S::SMEM, stream>>>(tq, tk, tv, (__nv_bfloat16*)o, (float*)lse,
                                                     BH, Sq, Sk, G, causal, has_window, window,
                                                     q_offset, scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq, int Sk,
           int G, int D, int causal, int has_window, int window, int q_offset, void* stream) {
  if (BH <= 0 || Sq <= 0 || G <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(DD) \
  case DD:             \
    return launch_d<DD>(q, k, v, o, lse, BH, Sq, Sk, G, causal, has_window, window, q_offset, st);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace hop

}  // namespace

extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int BH, int Sq, int Sk, int G, int D, int causal,
                                  int has_window, int window, int q_offset, void* stream) {
  return simt::launch<float>(q, k, v, o, lse, BH, Sq, Sk, G, D, causal, has_window, window,
                             q_offset, stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int BH, int Sq, int Sk, int G, int D, int causal,
                                   int has_window, int window, int q_offset, void* stream) {
  return hop::launch(q, k, v, o, lse, BH, Sq, Sk, G, D, causal, has_window, window, q_offset,
                     stream);
}

// The CUDA-core design in bfloat16, for timing it beside the Hopper route;
// the port's wrappers never call it.
extern "C" int flash_attn_fwd_bf16_simt(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int BH, int Sq, int Sk, int G, int D,
                                        int causal, int has_window, int window, int q_offset,
                                        void* stream) {
  return simt::launch<__nv_bfloat16>(q, k, v, o, lse, BH, Sq, Sk, G, D, causal, has_window,
                                     window, q_offset, stream);
}
