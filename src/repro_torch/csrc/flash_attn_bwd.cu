// K5 and K6: FlashAttention-2 backward on Hopper.
//
// K5 (dq) replaces the Pallas kernel repro/kernels/flash_attn/kernel.py
// flash_dq_pallas (body _dq_kernel); K6 (dk, dv) replaces flash_dkv_pallas
// (body _dkv_kernel). Inputs, in grouped-query layout (BH = batch * kv
// heads, G query heads per kv head): q and do (BH, Sq, G, D), k and v (BH,
// Sk, D), one dtype (bf16 or float32); lse and delta (BH, Sq, G) in float32
// (lse from K4, delta = sum(do * o) over D). Both kernels recompute, for
// each (query row, key):
//   s  = (q * scale) . k        (q upcast, scale = float32(1 / sqrt(D)))
//   p  = exp(s' - lse)          (s' = s where the key is visible, else -1e30)
//   dp = do . v
//   ds = p * (dp - delta) * scale
// K5 writes dq = sum_keys ds . k in q's dtype; K6 writes dv = sum_rows p . do
// and dk = sum_rows ds . q (q unscaled: the scale sits in ds, as the
// reference folds it) in k's and v's dtypes. The mask is K4's: query row r
// sits at position q_offset + r / G, key j at j; causal keeps j <= position,
// a window keeps position - j < window. Both stay two kernels, as in the
// reference, and neither uses atomics: each block owns its outputs' whole
// sums, so they are the same from run to run.
//
// Tiles no row may see are skipped: for a row that sees some key, an
// invisible key gets p = exp(-1e30 - lse) = 0 and adds exactly zero. A row
// that sees no key (a window that ends before key 0 or starts past Sk - 1)
// has lse = -1e30, so the reference gives every key p = exp(0) = 1; such
// rows lie at the end of the position range, and a tile holding one walks,
// or is walked by, every tile. Keys past Sk and rows past Sq * G add
// exactly zero.
//
// What bounds them on this card: operations. At llama3-8b's training shape
// (q 16 x 4096 x 4 x 128, causal) K5 runs three products (q.k, do.v, ds.k)
// and K6 four (q.k, do.v, p.do, ds.q) over the 2.1e8 visible (row, key)
// pairs: 4.1e11 and 5.5e11 flop, 0.417 and 0.556 ms at the tensor cores'
// bf16 rate, against about 0.05 ms of bytes each.
//
// Two routes, one per dtype.
//
// bfloat16: flash_dq_hopper and flash_dkv_hopper, every product on the
// tensor cores, in the shape of K4's flash_fwd_hopper
// (csrc/flash_attn_fwd.cu): 384 threads, warpgroup 0 the producer (one
// thread issues every TMA load, setmaxnreg gives its registers away),
// warpgroups 1 and 2 the consumers, 64 rows of the block's tile each; tiles
// are 128-byte-swizzled atoms of 64 columns from 3-D tensor maps (D, rows,
// BH) that zero-fill past Sq * G or Sk inside each head, streamed through
// two shared-memory stages, each guarded by a "full" and an "empty"
// mbarrier. Every D in {16, 32, 64, 80, 128} takes one layout: the columns
// past D are zero-filled (D = 80 is one full and one zero-padded atom).
// The second-stage products take p and ds from the first-stage
// accumulators as the register A operand, repacked with no trip through
// shared memory, each split in two bf16 halves, hi = bf16(x) and lo =
// bf16(x - hi), two products into one float32 sum: one bf16 ds breaks the
// unchanged bf16 gate for dq and dk on seeded causal cases, one bf16 p
// breaks it for dv on seeded cases without a mask, and hi + lo meets it
// everywhere (tests/test_torch_flash_bwd_split.py). So K5 runs four
// products and K6 six, and the kernels' own floors at the training shape
// are 0.556 and 0.834 ms.
//  - K5: a block takes 128 flattened q rows of one (batch, kv head), q
//    tiles heaviest first (the causal tail first). The Q and dO tiles load
//    once; K and V tiles of 64 keys stream. Per key tile: S = Q . K^T and
//    dP = dO . V^T (wgmma m64n64k16, both operands in shared memory,
//    K-major); p = exp2(s scale log2 e - lse log2 e) and ds in float32 on
//    the accumulator registers, lse and delta the thread's two rows g and
//    g + 8; dQ += dS . K with K the MN-major B operand (as K4 uses V).
//    Accumulators: 32 + 32 + D / 2 floats a thread.
//  - K6: a block takes 128 keys of one (batch, kv head), key tiles
//    heaviest first (under a causal mask the first of each head). The K
//    and V tiles load once; tiles of 64 flattened q rows stream with their
//    lse and delta slices (copied into the stage by a second producer
//    warp). It computes the transposed scores, so that both second-stage
//    products take their A operand from registers: S^T = K . Q^T and dP^T
//    = V . dO^T (ss, K-major), P^T and dS^T from lse and delta indexed by
//    column, dV += P^T . dO and dK += dS^T . Q (rs). One swizzled Q (and
//    dO) tile is the K-major B operand of the score product and the
//    MN-major B operand of the second, two descriptors over one tile
//    (csrc/hopper.cuh). Accumulators: 32 + 32 + D / 2 + D / 2 floats.
//  - A consumer runs each tile in order: both score products, wait, the
//    elementwise pass, the second-stage products, wait; the two consumers
//    interleave on the SM. Overlapping a warpgroup's elementwise pass with
//    its own products is work for a later PR.
//
// float32: flash_dq_kernel and flash_dkv_kernel (namespace simt), the
// CUDA-core design of the first port, for the float32 gate of 2e-5 that
// TF32 cannot meet: 256 threads, tiles of 64 flattened q rows by 64 keys,
// float32 copies of the tiles in shared memory padded by one word, each
// thread a 4 x 4 patch of the score tile and a 4 x D/16 patch of the
// accumulators; K5 one block per (q tile, BH) with ds through shared
// memory, K6 one block per (key tile, BH) walking the q tiles in order
// (149 and 166 KB of shared memory at D = 128). Its bf16 instantiations stay
// exported as flash_attn_dq_bf16_simt and flash_attn_dkv_bf16_simt, for
// timing the two designs side by side; the wrappers never reach them.
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

struct Mask {
  int Sk, causal, has_window, window, q_offset;
  // the keys [lo, hi) that position qpos may see; hi <= lo: none
  __device__ int lo(int qpos) const { return has_window ? max(0, qpos - window + 1) : 0; }
  __device__ int hi(int qpos) const { return causal ? min(Sk, qpos + 1) : Sk; }
  __device__ bool visible(int qpos, int kpos) const {
    return (!causal || qpos >= kpos) && (!has_window || qpos - kpos < window);
  }
  __device__ bool sees_none(int qpos) const { return hi(qpos) <= lo(qpos); }
};

// the tiles [t_begin, t_end) of `bn` keys that rows at positions [p_lo,
// p_hi] may see; every tile when a row sees no key
__device__ void visible_tiles(const Mask& m, int p_lo, int p_hi, int bn, int* t_begin,
                              int* t_end) {
  int k_end = m.Sk, k_begin = 0;
  if (!m.sees_none(p_lo) && !m.sees_none(p_hi)) {
    if (m.causal) k_end = max(0, min(m.Sk, p_hi + 1));
    if (m.has_window) k_begin = max(0, p_lo - m.window + 1);
  }
  *t_begin = k_begin / bn;
  *t_end = k_end > k_begin ? (k_end + bn - 1) / bn : *t_begin;
}

// ------------------------------------------------- float32: CUDA cores

namespace simt {

constexpr int BM = 64;   // flattened q rows (position x group) per tile
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr int SS = BN + 1;  // padded row stride of the p / ds tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// rows [r0, r0 + n) of a (rows, D) slab as float32 (times mul) into a
// (BM, D + 1) tile; rows past `rows` are zero
template <typename T, int D>
__device__ void stage_rows(float* dst, const T* src, int r0, int rows, float mul) {
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_f32(src[(int64_t)gr * D + c]) * mul : 0.f;
  }
}

// s = a . b^T and dp = c . e^T over D for rows ty + 16 i of (a, c) and rows
// tx + 16 j of (b, e), all four tiles with row stride D + 1; a is scaled by
// `a_mul` on the fly (1 where the tile holds q * scale already)
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* b, const float* c,
                                             const float* e, float a_mul, float s[4][4],
                                             float dp[4][4]) {
  constexpr int DP = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4], u[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = a[(ty + 16 * i) * DP + d] * a_mul;
      u[i] = c[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = b[(tx + 16 * j) * DP + d];
      w[j] = e[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        dp[i][j] = fmaf(u[i], w[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO, sK, sV (64 x D+1 each), sDS (64 x 65), lse, delta
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BM * SS + 2 * BM);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sDO (64 x D+1 each), sP, sDS (64 x 65 each), lse, delta
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BM * SS + 2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int G, Mask m, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;  // q * scale
  float* sDO = sQ + BM * DP;
  float* sK = sDO + BM * DP;
  float* sV = sK + BN * DP;
  float* sDS = sV + BN * DP;
  float* sLse = sDS + BM * SS;
  float* sDelta = sLse + BM;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int rows = Sq * G;
  const int r0 = blockIdx.x * BM;
  const int64_t bh = blockIdx.y;
  const T* kb = k + bh * m.Sk * D;
  const T* vb = v + bh * m.Sk * D;

  stage_rows<T, D>(sQ, q + bh * rows * D, r0, rows, scale);
  stage_rows<T, D>(sDO, dout + bh * rows * D, r0, rows, 1.f);
  if (tid < BM) {
    const int gr = r0 + tid;
    sLse[tid] = gr < rows ? lse[bh * rows + gr] : 0.f;
    sDelta[tid] = gr < rows ? delta[bh * rows + gr] : 0.f;
  }

  const int last_row = min(r0 + BM, rows) - 1;
  int t_begin, t_end;
  visible_tiles(m, m.q_offset + r0 / G, m.q_offset + last_row / G, BN, &t_begin, &t_end);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's sK, sV and sDS are consumed
    stage_rows<T, D>(sK, kb, k0, m.Sk, 1.f);
    stage_rows<T, D>(sV, vb, k0, m.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sQ, sK, sDO, sV, 1.f, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = m.q_offset + (r0 + row) / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (key < m.Sk) {
          const float x = m.visible(qpos, key) ? s[i][j] : kNegInf;
          const float p = expf(x - sLse[row]);
          ds = p * (dp[i][j] - sDelta[row]) * scale;
        }
        sDS[row * SS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // dq += ds . k
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sDS[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sK[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = dq + bh * rows * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty + 16 * i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store_as(dqb + (int64_t)gr * D + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int G, Mask m, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * DP;
  float* sQ = sV + BN * DP;  // q unscaled: ds . q needs it so
  float* sDO = sQ + BM * DP;
  float* sP = sDO + BM * DP;
  float* sDS = sP + BM * SS;
  float* sLse = sDS + BM * SS;
  float* sDelta = sLse + BM;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int rows = Sq * G;
  const int k0 = blockIdx.x * BN;
  const int k_last = min(k0 + BN, m.Sk) - 1;
  const int64_t bh = blockIdx.y;
  const T* qb = q + bh * rows * D;
  const T* dob = dout + bh * rows * D;

  stage_rows<T, D>(sK, k + bh * m.Sk * D, k0, m.Sk, 1.f);
  stage_rows<T, D>(sV, v + bh * m.Sk * D, k0, m.Sk, 1.f);

  // this thread's keys are k0 + ty + 16 i, its columns tx + 16 j
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (rows + BM - 1) / BM;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int r0 = qt * BM;
    const int p_lo = m.q_offset + r0 / G;
    const int p_hi = m.q_offset + (min(r0 + BM, rows) - 1) / G;
    // skip a q tile none of whose rows may see these keys, unless one of
    // its rows sees no key at all (and so sees every key with p = 1)
    if (!m.sees_none(p_lo) && !m.sees_none(p_hi) &&
        ((m.causal && p_hi < k0) || (m.has_window && p_lo - k_last >= m.window)))
      continue;
    __syncthreads();  // the previous q tile's sQ, sDO, sP and sDS are consumed
    stage_rows<T, D>(sQ, qb, r0, rows, 1.f);
    stage_rows<T, D>(sDO, dob, r0, rows, 1.f);
    if (tid < BM) {
      const int gr = r0 + tid;
      sLse[tid] = gr < rows ? lse[bh * rows + gr] : 0.f;
      sDelta[tid] = gr < rows ? delta[bh * rows + gr] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sQ, sK, sDO, sV, scale, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int gr = r0 + row;
      const int qpos = m.q_offset + gr / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (gr < rows && key < m.Sk) {
          const float x = m.visible(qpos, key) ? s[i][j] : kNegInf;
          p = expf(x - sLse[row]);
          ds = p * (dp[i][j] - sDelta[row]) * scale;
        }
        sP[row * SS + tx + 16 * j] = p;
        sDS[row * SS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // dv += p^T . do, dk += ds^T . q over this tile's rows, in row order
#pragma unroll 2
    for (int r = 0; r < BM; ++r) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = sP[r * SS + ty + 16 * i];
        dsk[i] = sDS[r * SS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = sDO[r * DP + tx + 16 * j];
        const float qv = sQ[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pk[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsk[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

  T* dkb = dk + bh * m.Sk * D;
  T* dvb = dv + bh * m.Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= m.Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store_as(dkb + (int64_t)key * D + tx + 16 * j, dk_acc[i][j]);
      store_as(dvb + (int64_t)key * D + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

}  // namespace simt

// ---------------------------------------- bfloat16: wgmma, TMA, mbarrier

namespace hop {

using namespace hopper;

constexpr int NT = 384;     // producer warpgroup + two consumers
constexpr int STAGES = 2;   // streamed tiles in flight
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr int TM = 128;     // the block's own tile: q rows (K5) or keys (K6)
constexpr int TS = 64;      // a streamed tile: keys (K5) or q rows (K6)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int ATOMS = (D + 63) / 64;        // 64-column swizzle atoms a row
  static constexpr int OWN_BYTES = ATOMS * TM * 128;  // one of the block's own tiles
  static constexpr int TILE_BYTES = ATOMS * TS * 128; // one streamed tile
  static constexpr int LD_BYTES = 2 * TS * 4;         // K6: a stage's lse and delta
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 bytes of slack to align the tiles to the swizzle period
  static constexpr int SMEM =
      1024 + 2 * OWN_BYTES + 2 * STAGES * TILE_BYTES + STAGES * LD_BYTES + BAR_BYTES;
};

// The block's shared memory: two own tiles (Q and dO, or K and V), STAGES
// streamed pairs (K and V, or Q and dO), K6's lse and delta stages, then
// the barriers: full[STAGES], empty[STAGES], own.
template <int D>
struct Smem {
  using S = Shape<D>;
  uint32_t own0, own1, str0, str1, ld, bar;
  float* ld_ptr;
  __device__ Smem(uint8_t* raw) {
    const uint32_t base = smem_u32(raw);
    own0 = (base + 1023u) & ~1023u;
    own1 = own0 + S::OWN_BYTES;
    str0 = own1 + S::OWN_BYTES;
    str1 = str0 + STAGES * S::TILE_BYTES;
    ld = str1 + STAGES * S::TILE_BYTES;
    bar = ld + STAGES * S::LD_BYTES;
    ld_ptr = reinterpret_cast<float*>(raw + (ld - base));
  }
  __device__ uint32_t full(int s) const { return bar + 8u * s; }
  __device__ uint32_t empty(int s) const { return bar + 8u * (STAGES + s); }
  __device__ uint32_t own_bar() const { return bar + 8u * 2 * STAGES; }
};

// K-major descriptor of k16 step ks of a tile whose atoms hold `rows` rows,
// starting at row `row0`
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0, int ks) {
  return desc_sw128(tile + (ks / 4) * rows * 128 + row0 * 128 + (ks % 4) * 32, 16, 1024);
}

// MN-major descriptor of k16 step j (rows 16 j ... 16 j + 15) of a tile of
// `rows` rows
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int j) {
  return desc_sw128(tile + j * 2048, rows * 128, 1024);
}

// both score products of one consumer: a (64 x D, rows row0 ... of an own
// tile of TM rows) times b^T (N x D, rows b_row0 ... of a streamed tile),
// into x and y
template <int D, int N>
__device__ __forceinline__ void score_products(float (&x)[N / 2], float (&y)[N / 2], uint32_t a0,
                                               uint32_t b0, uint32_t a1, uint32_t b1, int row0,
                                               int b_row0) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss<N>(x, kmajor(a0, TM, row0, ks), kmajor(b0, TS, b_row0, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss<N>(y, kmajor(a1, TM, row0, ks), kmajor(b1, TS, b_row0, ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(x);
  fence_operands(y);
}

// x (64 x N, float32 accumulator registers) as the A operands of N / 16
// k16 steps, hi and lo bf16 halves
template <int N>
__device__ __forceinline__ void pack_split(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16_pair(x[8 * j + 2 * r], x[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
}

// acc (64 x D) += (hi + lo) (64 x 16 J) times rows 16 j0 ... 16 (j0 + J) - 1
// of the streamed tile b (MN-major), two products into one float32 sum;
// issued, not waited for
template <int D, int J>
__device__ __forceinline__ void split_product(float (&acc)[D / 2], const uint32_t (&hi)[J][4],
                                              const uint32_t (&lo)[J][4], uint32_t b, int j0) {
#pragma unroll
  for (int j = 0; j < J; ++j) wgmma_rs<D>(acc, hi[j], mnmajor(b, TS, j0 + j), 1);
#pragma unroll
  for (int j = 0; j < J; ++j) wgmma_rs<D>(acc, lo[j], mnmajor(b, TS, j0 + j), 1);
}

// rows g and g + 8 of a consumer's 64 x D accumulator, as bf16, where valid
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           int64_t rowA, bool okA, bool okB, int colq) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + colq;
    if (okA)
      *reinterpret_cast<__nv_bfloat162*>(out + rowA * D + c) =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    if (okB)
      *reinterpret_cast<__nv_bfloat162*>(out + (rowA + 8) * D + c) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ------------------------------------------------------------------- K5

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_dq_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int BH, int Sq, int G, Mask m, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16 up to 128");
  using S = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const uint32_t sQ = sm.own0, sDO = sm.own1, sK = sm.str0, sV = sm.str1;

  // q tiles heaviest first: the linear block index walks the tiles from the
  // last (the most keys under a causal mask) down, every head at each step
  const int rows = Sq * G;
  const int64_t lin = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = (int)gridDim.x - 1 - (int)(lin / BH);
  const int bh = (int)(lin % BH);
  const int r0 = qt * TM;
  int t_begin, t_end;
  visible_tiles(m, m.q_offset + r0 / G, m.q_offset + (min(r0 + TM, rows) - 1) / G, TS, &t_begin,
                &t_end);
  const int n_tiles = t_end - t_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(sm.own_bar(), 1);
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
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(sm.own_bar(), 2 * S::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < S::ATOMS; ++a) {
        tma_load_3d(sQ + a * TM * 128, &tq, sm.own_bar(), 64 * a, r0, bh);
        tma_load_3d(sDO + a * TM * 128, &tdo, sm.own_bar(), 64 * a, r0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), 2 * S::TILE_BYTES);
        const int k0 = (t_begin + it) * TS;
#pragma unroll
        for (int a = 0; a < S::ATOMS; ++a) {
          tma_load_3d(sK + s * S::TILE_BYTES + a * TS * 128, &tk, sm.full(s), 64 * a, k0, bh);
          tma_load_3d(sV + s * S::TILE_BYTES + a * TS * 128, &tv, sm.full(s), 64 * a, k0, bh);
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
  const int rowA = r0 + 64 * cw + 16 * warp + lane / 4;  // rows of x[4i + {0,1}]
  const int rowB = rowA + 8;                             // rows of x[4i + {2,3}]
  const int colq = 2 * (lane % 4);                       // first column of each 8
  const int posA = m.q_offset + rowA / G, posB = m.q_offset + rowB / G;
  const int loA = m.lo(posA), hiA = m.hi(posA), loB = m.lo(posB), hiB = m.hi(posB);
  const int64_t head = (int64_t)bh * rows;
  // rows past the end read 0 and are not written
  const float lseA = rowA < rows ? lse[head + rowA] : 0.f;
  const float lseB = rowB < rows ? lse[head + rowB] : 0.f;
  const float dA = rowA < rows ? delta[head + rowA] : 0.f;
  const float dB = rowB < rows ? delta[head + rowB] : 0.f;
  const float lA = lseA * kLog2e, lB = lseB * kLog2e;
  // p of a masked key, exp(-1e30 - lse): 1 in a row that sees no key
  const float pmA = expf(kNegInf - lseA), pmB = expf(kNegInf - lseB);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(sm.own_bar(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = (t_begin + it) * TS;
    const uint32_t k_tile = sK + s * S::TILE_BYTES, v_tile = sV + s * S::TILE_BYTES;
    mbar_wait(sm.full(s), (it / STAGES) & 1);

    // S = Q . K^T (raw) into x, dP = dO . V^T into y
    float x[32], y[32];
    score_products<D, TS>(x, y, sQ, k_tile, sDO, v_tile, 64 * cw, 0);

    // p, then ds = p * (dp - delta) * scale, over y
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float l = (i & 2) ? lB : lA;
      x[i] = exp2f(fmaf(x[i] * scale, kLog2e, -l));
    }
    if (k0 < max(loA, loB) || k0 + TS > min(hiA, hiB)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * i + colq + e;
          if (kp >= m.Sk) {  // past the keys: zero-filled, adds nothing
            x[4 * i + e] = 0.f;
            x[4 * i + 2 + e] = 0.f;
          } else {
            if (kp < loA || kp >= hiA) x[4 * i + e] = pmA;
            if (kp < loB || kp >= hiB) x[4 * i + 2 + e] = pmB;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = (i & 2) ? dB : dA;
      y[i] = x[i] * (y[i] - d) * scale;
    }

    // dQ += dS . K, dS as hi + lo bf16 halves, K the MN-major B operand
    uint32_t hi[TS / 16][4], lo[TS / 16][4];
    pack_split<TS>(y, hi, lo);
    fence_operands(acc);
    wgmma_fence();
    split_product<D, TS / 16>(acc, hi, lo, k_tile, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(s));
  }

  store_rows<D>(dq + head * D, acc, rowA, rowA < rows, rowB < rows, colq);
}

// ------------------------------------------------------------------- K6

// The q tiles of TS rows that keys [k0, k_last] need: [a, b) holds the rows
// that may see one of them, [c, n) the rows that see no key at all (they
// lie at the end of the position range and see every key with p = 1).
struct QTiles {
  int a, b, c, n;
  __device__ int count() const { return (b - a) + (n - c); }
  __device__ int at(int i) const { return i < b - a ? a + i : c + (i - (b - a)); }
};

__device__ QTiles q_tiles(const Mask& m, int rows, int G, int k0, int k_last) {
  const int64_t R = rows;
  auto first_row = [&](int64_t pos) {  // the first row at position >= pos
    const int64_t r = (pos - m.q_offset) * G;
    return r < 0 ? (int64_t)0 : (r > R ? R : r);
  };
  // rows at positions in [k0, k_last + window - 1] may see a key of the tile
  const int64_t v0 = m.causal ? first_row(k0) : 0;
  const int64_t v1 = m.has_window ? first_row((int64_t)k_last + m.window) : R;
  // rows at positions >= Sk + window - 1 see no key
  const int64_t none = m.has_window ? first_row((int64_t)m.Sk + m.window - 1) : R;
  QTiles t;
  t.n = (int)((R + TS - 1) / TS);
  t.c = none < R ? (int)(none / TS) : t.n;
  t.a = (int)(v0 / TS);
  t.b = v1 > v0 ? (int)((v1 + TS - 1) / TS) : t.a;
  t.b = min(t.b, t.c);
  if (t.a >= t.b) t.a = t.b = t.c;
  return t;
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_dkv_hopper(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int BH, int Sq, int G,
    Mask m, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16 up to 128");
  using S = Shape<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const uint32_t sK = sm.own0, sV = sm.own1, sQ = sm.str0, sDO = sm.str1;
  // q rows a sub-tile: at D = 128, 64 would hold 64 + 64 + 128 accumulator
  // floats a thread at once, past the consumers' registers
  constexpr int N = D > 80 ? 32 : TS;

  // key tiles heaviest first: under a causal mask the first key tiles of
  // each head are seen by the most rows
  const int rows = Sq * G;
  const int64_t lin = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int kt = (int)(lin / BH);
  const int bh = (int)(lin % BH);
  const int k0 = kt * TM;
  const QTiles tiles = q_tiles(m, rows, G, k0, min(k0 + TM, m.Sk) - 1);
  const int n_tiles = tiles.count();
  const int64_t head = (int64_t)bh * rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 2);   // the TMA thread and the lse/delta warp
      mbar_init(sm.empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(sm.own_bar(), 1);
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
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(sm.own_bar(), 2 * S::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < S::ATOMS; ++a) {
        tma_load_3d(sK + a * TM * 128, &tk, sm.own_bar(), 64 * a, k0, bh);
        tma_load_3d(sV + a * TM * 128, &tv, sm.own_bar(), 64 * a, k0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(sm.full(s), 2 * S::TILE_BYTES);
        const int r0 = tiles.at(it) * TS;
#pragma unroll
        for (int a = 0; a < S::ATOMS; ++a) {
          tma_load_3d(sQ + s * S::TILE_BYTES + a * TS * 128, &tq, sm.full(s), 64 * a, r0, bh);
          tma_load_3d(sDO + s * S::TILE_BYTES + a * TS * 128, &tdo, sm.full(s), 64 * a, r0, bh);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // the stage's lse and delta, 0 past the rows
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const int r0 = tiles.at(it) * TS;
        mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
        float* ld = sm.ld_ptr + s * 2 * TS;
        for (int r = lane; r < TS; r += 32) {
          const bool ok = r0 + r < rows;
          ld[r] = ok ? lse[head + r0 + r] : 0.f;
          ld[TS + r] = ok ? delta[head + r0 + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.full(s));
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // this warpgroup's 64 keys of the block
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int kc0 = k0 + 64 * cw;                   // the consumer's first key
  const int keyA = kc0 + 16 * warp + lane / 4;    // keys of x[4i + {0,1}]
  const int keyB = keyA + 8;                      // keys of x[4i + {2,3}]
  const int colq = 2 * (lane % 4);                // first column (q row) of each 8

  float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dv[i] = acc_dk[i] = 0.f;

  mbar_wait(sm.own_bar(), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int r0 = tiles.at(it) * TS;
    const uint32_t q_tile = sQ + s * S::TILE_BYTES, do_tile = sDO + s * S::TILE_BYTES;
    const float* ld = sm.ld_ptr + s * 2 * TS;
    mbar_wait(sm.full(s), (it / STAGES) & 1);

    // the tile in sub-tiles of N q rows (fewer registers at large D)
#pragma unroll 1
    for (int h = 0; h < TS / N; ++h) {
      // S^T = K . Q^T (raw) into x, dP^T = V . dO^T into y: rows keys,
      // columns q rows
      float x[N / 2], y[N / 2];
      score_products<D, N>(x, y, sK, q_tile, sV, do_tile, 64 * cw, h * N);

      // every (key, row) of the consumer's 64 x N visible and in range?
      const int rs = r0 + h * N;
      const int p_lo = m.q_offset + rs / G, p_hi = m.q_offset + (rs + N - 1) / G;
      const bool whole = rs + N <= rows && m.lo(p_hi) <= kc0 && m.hi(p_lo) >= kc0 + 64;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = h * N + 8 * i + colq + e;
          const float l = ld[c], d = ld[TS + c];
          float pA = exp2f(fmaf(x[4 * i + e] * scale, kLog2e, -l * kLog2e));
          float pB = exp2f(fmaf(x[4 * i + 2 + e] * scale, kLog2e, -l * kLog2e));
          if (!whole) {
            if (r0 + c >= rows) {  // past the rows: zero-filled, adds nothing
              pA = pB = 0.f;
            } else {
              const int pos = m.q_offset + (r0 + c) / G;
              const int klo = m.lo(pos), khi = m.hi(pos);
              // p of a masked key, exp(-1e30 - lse): 1 in a row that sees no key
              if (keyA < klo || keyA >= khi) pA = expf(kNegInf - l);
              if (keyB < klo || keyB >= khi) pB = expf(kNegInf - l);
            }
          }
          x[4 * i + e] = pA;
          x[4 * i + 2 + e] = pB;
          y[4 * i + e] = pA * (y[4 * i + e] - d) * scale;
          y[4 * i + 2 + e] = pB * (y[4 * i + 2 + e] - d) * scale;
        }

      // dV += P^T . dO and dK += dS^T . Q, each A as hi + lo bf16 halves,
      // the stage's dO and Q tiles the MN-major B operands
      uint32_t ph[N / 16][4], pl[N / 16][4], dh[N / 16][4], dl[N / 16][4];
      pack_split<N>(x, ph, pl);
      pack_split<N>(y, dh, dl);
      fence_operands(acc_dv);
      fence_operands(acc_dk);
      wgmma_fence();
      split_product<D, N / 16>(acc_dv, ph, pl, do_tile, h * N / 16);
      split_product<D, N / 16>(acc_dk, dh, dl, q_tile, h * N / 16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc_dv);
      fence_operands(acc_dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(s));
  }

  const int64_t khead = (int64_t)bh * m.Sk;
  store_rows<D>(dk + khead * D, acc_dk, keyA, keyA < m.Sk, keyB < m.Sk, colq);
  store_rows<D>(dv + khead * D, acc_dv, keyA, keyA < m.Sk, keyB < m.Sk, colq);
}

// The four tensor maps of a launch: q and do in boxes of `q_box` rows, k
// and v in boxes of `kv_box`; 0 or the error code
inline int encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
                       const void* dout, int D, int BH, int Sq, int Sk, int G, int q_box,
                       int kv_box) {
  // TMA reads from 16-byte-aligned addresses
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15)
    return (int)cudaErrorMisalignedAddress;
  const uint64_t rows = (uint64_t)Sq * G;
  int rc = encode_bf16_3d_sw128(&maps[0], q, D, rows, BH, q_box);
  if (rc == 0) rc = encode_bf16_3d_sw128(&maps[1], k, D, Sk, BH, kv_box);
  if (rc == 0) rc = encode_bf16_3d_sw128(&maps[2], v, D, Sk, BH, kv_box);
  if (rc == 0) rc = encode_bf16_3d_sw128(&maps[3], dout, D, rows, BH, q_box);
  return rc;
}

}  // namespace hop

// ------------------------------------------------------------ launchers

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int BH, Sq, Sk, G;
  Mask m;
  cudaStream_t stream;
};

// the reference scales by float32(1 / np.sqrt(D)), rounded from double
inline float scale_of(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename T, int D>
int launch_dq_simt(const Args& a, void* dq) {
  const size_t smem = simt::dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(simt::flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq * a.G + simt::BM - 1) / simt::BM, a.BH);
  simt::flash_dq_kernel<T, D><<<grid, simt::NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
      (const float*)a.delta, (T*)dq, a.Sq, a.G, a.m, scale_of(D));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_simt(const Args& a, void* dk, void* dv) {
  const size_t smem = simt::dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(simt::flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.m.Sk + simt::BN - 1) / simt::BN, a.BH);
  simt::flash_dkv_kernel<T, D><<<grid, simt::NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
      (const float*)a.delta, (T*)dk, (T*)dv, a.Sq, a.G, a.m, scale_of(D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_hop(const Args& a, void* dq) {
  CUtensorMap maps[4];
  int rc = hop::encode_maps(maps, a.q, a.k, a.v, a.dout, D, a.BH, a.Sq, a.m.Sk, a.G, hop::TM,
                            hop::TS);
  if (rc != 0) return rc;
  const int smem = hop::Shape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(hop::flash_dq_hopper<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)a.Sq * a.G;
  dim3 grid((unsigned)((rows + hop::TM - 1) / hop::TM), a.BH);
  hop::flash_dq_hopper<D><<<grid, hop::NT, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)dq, a.BH, a.Sq, a.G, a.m, scale_of(D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_hop(const Args& a, void* dk, void* dv) {
  CUtensorMap maps[4];
  int rc = hop::encode_maps(maps, a.q, a.k, a.v, a.dout, D, a.BH, a.Sq, a.m.Sk, a.G, hop::TS,
                            hop::TM);
  if (rc != 0) return rc;
  const int smem = hop::Shape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(hop::flash_dkv_hopper<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.m.Sk + hop::TM - 1) / hop::TM, a.BH);
  hop::flash_dkv_hopper<D><<<grid, hop::NT, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a.BH, a.Sq, a.G, a.m, scale_of(D));
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int BH, int Sq, int Sk, int G, int causal, int has_window,
               int window, int q_offset, void* stream) {
  return Args{q, k, v, dout, lse, delta, BH, Sq, Sk, G,
              Mask{Sk, causal, has_window, window, q_offset}, (cudaStream_t)stream};
}

#define BWD_SWITCH(D, CALL)                  \
  switch (D) {                               \
    case 16: { constexpr int DD = 16; CALL; } \
    case 32: { constexpr int DD = 32; CALL; } \
    case 64: { constexpr int DD = 64; CALL; } \
    case 80: { constexpr int DD = 80; CALL; } \
    case 128: { constexpr int DD = 128; CALL; } \
    default:                                 \
      return (int)cudaErrorInvalidValue;     \
  }

// Route: 0 the CUDA-core design in T, 1 the Hopper design (bf16 only)
template <typename T, int ROUTE>
int dq_entry(const Args& a, int D, void* dq) {
  if (a.BH <= 0 || a.Sq <= 0 || a.G <= 0) return 0;
  if constexpr (ROUTE == 1) {
    BWD_SWITCH(D, return (launch_dq_hop<DD>(a, dq)))
  } else {
    BWD_SWITCH(D, return (launch_dq_simt<T, DD>(a, dq)))
  }
}

template <typename T, int ROUTE>
int dkv_entry(const Args& a, int D, void* dk, void* dv) {
  if (a.BH <= 0 || a.m.Sk <= 0) return 0;
  if constexpr (ROUTE == 1) {
    BWD_SWITCH(D, return (launch_dkv_hop<DD>(a, dk, dv)))
  } else {
    BWD_SWITCH(D, return (launch_dkv_simt<T, DD>(a, dk, dv)))
  }
}

}  // namespace

#define DQ_FN(NAME, T, ROUTE)                                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,          \
                      const void* lse, const void* delta, void* dq, int BH, int Sq, int Sk,   \
                      int G, int D, int causal, int has_window, int window, int q_offset,     \
                      void* stream) {                                                         \
    return dq_entry<T, ROUTE>(make_args(q, k, v, dout, lse, delta, BH, Sq, Sk, G, causal,    \
                                        has_window, window, q_offset, stream),                \
                              D, dq);                                                         \
  }

#define DKV_FN(NAME, T, ROUTE)                                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,          \
                      const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq, \
                      int Sk, int G, int D, int causal, int has_window, int window,           \
                      int q_offset, void* stream) {                                           \
    return dkv_entry<T, ROUTE>(make_args(q, k, v, dout, lse, delta, BH, Sq, Sk, G, causal,   \
                                         has_window, window, q_offset, stream),               \
                               D, dk, dv);                                                    \
  }

DQ_FN(flash_attn_dq_f32, float, 0)
DQ_FN(flash_attn_dq_bf16, __nv_bfloat16, 1)
DKV_FN(flash_attn_dkv_f32, float, 0)
DKV_FN(flash_attn_dkv_bf16, __nv_bfloat16, 1)
// The CUDA-core design in bfloat16, for timing it beside the Hopper route;
// the port's wrappers never call them.
DQ_FN(flash_attn_dq_bf16_simt, __nv_bfloat16, 0)
DKV_FN(flash_attn_dkv_bf16_simt, __nv_bfloat16, 0)
