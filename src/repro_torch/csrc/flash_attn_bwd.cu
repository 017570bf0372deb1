// K5 and K6: FlashAttention-2 backward on Hopper.
//
// K5 (flash_dq_kernel) replaces the Pallas kernel
// repro/kernels/flash_attn/kernel.py flash_dq_pallas (body _dq_kernel);
// K6 (flash_dkv_kernel) replaces flash_dkv_pallas (body _dkv_kernel).
// Inputs, in grouped-query layout (BH = batch * kv heads, G query heads per
// kv head): q and do (BH, Sq, G, D), k and v (BH, Sk, D), one dtype (bf16 or
// float32); lse and delta (BH, Sq, G) in float32 (lse from K4, delta =
// sum(do * o) over D). Both kernels recompute, for each (query row, key):
//   s  = (q * scale) . k        (q upcast, scale = float32(1 / sqrt(D)))
//   p  = exp(s' - lse)          (s' = s where the key is visible, else -1e30)
//   dp = do . v
//   ds = p * (dp - delta) * scale
// K5 writes dq = sum_keys ds . k in q's dtype; K6 writes dv = sum_rows p . do
// and dk = sum_rows ds . q (q unscaled: the scale sits in ds, as the
// reference folds it) in k's and v's dtypes. The mask is K4's: query row r
// sits at position q_offset + r / G, key j at j; causal keeps j <= position,
// a window keeps position - j < window.
//
// What bounds them on this card: operations. At llama3-8b's training shape
// (q 16 x 4096 x 4 x 128, causal) K5 runs three products (q.k, do.v, ds.k)
// and K6 four (q.k, do.v, p.do, ds.q) over the 2.1e8 visible (row, key)
// pairs: 4.1e11 and 5.5e11 flop, 0.42 and 0.56 ms at the tensor cores' bf16
// rate, against about 0.05 ms of bytes each. These kernels run every
// product on the float32 CUDA cores from shared memory, so they sit far
// above that bound; wgmma and TMA come later.
//
// Design, as K4's: 256 threads; tiles of 64 flattened q rows (position x
// group, so the G query heads of a kv head share every K/V tile) by 64 keys;
// float32 copies of the tiles in shared memory, rows padded by one word so
// that the products read them free of bank conflicts; each thread computes a
// 4 x 4 patch of the score tile (s and dp together) and owns a 4 x D/16
// patch of the float32 accumulators. Every product is written as fmaf (the
// port builds with --fmad=false).
//  - K5: one block per (tile of 64 q rows, BH). The q and do tiles, lse and
//    delta stay in shared memory; K and V tiles are staged in turn; ds goes
//    through shared memory to the ds . k product; dq stays in registers.
//    149 KB of shared memory at D = 128.
//  - K6: one block per (tile of 64 keys, BH), which owns its keys' whole
//    sums: it walks the q tiles (all G heads of the kv head) in order and
//    adds into dk and dv in registers (two 4 x D/16 patches a thread). No
//    atomics, so the sums are the same from run to run. K and V stay in
//    shared memory; q, do, lse and delta are staged per q tile, and p and ds
//    go through shared memory to the two transposed products. 166 KB of
//    shared memory at D = 128, one block per SM.
// Tiles no row may see are skipped: for a row that sees some key, an
// invisible key gets p = exp(-1e30 - lse) = 0 and adds exactly zero. A row
// that sees no key (a window that ends before key 0 or starts past Sk - 1)
// has lse = -1e30, so the reference gives every key p = exp(0) = 1; a tile
// holding such a row (they lie at the ends of the position range, so its
// first and last rows tell) walks, or is walked by, every tile. Keys past
// Sk and rows past Sq * G are masked at the ragged edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // flattened q rows (position x group) per tile
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr int SS = BN + 1;  // padded row stride of the p / ds tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Mask {
  int Sk, causal, has_window, window, q_offset;
  __device__ bool visible(int qpos, int kpos) const {
    return (!causal || qpos >= kpos) && (!has_window || qpos - kpos < window);
  }
  __device__ bool sees_none(int qpos) const {
    const int hi = causal ? min(Sk, qpos + 1) : Sk;
    const int lo = has_window ? max(0, qpos - window + 1) : 0;
    return hi <= lo;
  }
};

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

// the tiles [t_begin, t_end) of 64 that rows at positions [p_lo, p_hi] may
// see; every tile when a row sees no key
__device__ void visible_tiles(const Mask& m, int p_lo, int p_hi, int* t_begin, int* t_end) {
  int k_end = m.Sk, k_begin = 0;
  if (!m.sees_none(p_lo) && !m.sees_none(p_hi)) {
    if (m.causal) k_end = max(0, min(m.Sk, p_hi + 1));
    if (m.has_window) k_begin = max(0, p_lo - m.window + 1);
  }
  *t_begin = k_begin / BN;
  *t_end = k_end > k_begin ? (k_end + BN - 1) / BN : *t_begin;
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

// ------------------------------------------------------------------- K5

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
  visible_tiles(m, m.q_offset + r0 / G, m.q_offset + last_row / G, &t_begin, &t_end);

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

// ------------------------------------------------------------------- K6

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
int launch_dq(const Args& a, void* dq) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq * a.G + BM - 1) / BM, a.BH);
  flash_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
      (const float*)a.delta, (T*)dq, a.Sq, a.G, a.m, scale_of(D));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.m.Sk + BN - 1) / BN, a.BH);
  flash_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, (const float*)a.lse,
      (const float*)a.delta, (T*)dk, (T*)dv, a.Sq, a.G, a.m, scale_of(D));
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
    case 128: { constexpr int DD = 128; CALL; } \
    default:                                 \
      return (int)cudaErrorInvalidValue;     \
  }

template <typename T>
int dq_entry(const Args& a, int D, void* dq) {
  if (a.BH <= 0 || a.Sq <= 0 || a.G <= 0) return 0;
  BWD_SWITCH(D, return (launch_dq<T, DD>(a, dq)))
}

template <typename T>
int dkv_entry(const Args& a, int D, void* dk, void* dv) {
  if (a.BH <= 0 || a.m.Sk <= 0) return 0;
  BWD_SWITCH(D, return (launch_dkv<T, DD>(a, dk, dv)))
}

}  // namespace

#define DQ_FN(NAME, T)                                                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,          \
                      const void* lse, const void* delta, void* dq, int BH, int Sq, int Sk,   \
                      int G, int D, int causal, int has_window, int window, int q_offset,     \
                      void* stream) {                                                         \
    return dq_entry<T>(make_args(q, k, v, dout, lse, delta, BH, Sq, Sk, G, causal,           \
                                 has_window, window, q_offset, stream),                       \
                       D, dq);                                                                \
  }

#define DKV_FN(NAME, T)                                                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,          \
                      const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq, \
                      int Sk, int G, int D, int causal, int has_window, int window,           \
                      int q_offset, void* stream) {                                           \
    return dkv_entry<T>(make_args(q, k, v, dout, lse, delta, BH, Sq, Sk, G, causal,          \
                                  has_window, window, q_offset, stream),                      \
                        D, dk, dv);                                                           \
  }

DQ_FN(flash_attn_dq_f32, float)
DQ_FN(flash_attn_dq_bf16, __nv_bfloat16)
DKV_FN(flash_attn_dkv_f32, float)
DKV_FN(flash_attn_dkv_bf16, __nv_bfloat16)
