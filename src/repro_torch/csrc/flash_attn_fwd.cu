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
//
// What bounds it on this card: operations. A causal prefill at llama3-8b's
// width (16 x 4096 x 4 rows, D = 128) does about 2.7e11 multiply-adds'
// worth of flops against 0.2 GB of q, k, v and o; at the tensor cores'
// bf16 rate that is about 0.28 ms, against 0.05 ms of bytes. This kernel
// runs the two products on the float32 CUDA cores from shared memory, so it
// sits well above that bound; wgmma and TMA come later.
//
// Design: one block of 256 threads per (BH, tile of 64 flattened q rows).
// The q tile is staged once in shared memory as scaled float32; K and V
// tiles of 64 keys are staged in turn (float32, K rows padded by one word
// so the Q.K^T reads are free of bank conflicts). Each thread computes a
// 4 x 4 patch of the 64 x 64 score tile; four threads share each row's
// softmax step (shuffles for max and sum) and keep its (m, l) in
// registers; each thread then owns a 4 x D/16 patch of the float32
// accumulator for the P.V product. Both products are written as fmaf, one
// fused multiply-add per step whatever the build's --fmad flag (the port
// builds every kernel with --fmad=false). KV tiles that no row of the q
// tile may see (past the causal diagonal or before the window) are
// skipped: the recurrence would wipe their contribution to exactly zero.
// That holds only
// for rows that see some key. A row that sees none (a window that ends
// before key 0 or starts past Sk - 1) keeps m = -1e30, so every masked score
// gets p = exp(0) = 1 and the reference returns the mean of all V rows with
// lse = -1e30; a q tile holding such a row therefore walks every KV tile.
// Keys past Sk and q rows past Sq * G are masked at the ragged edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // flattened q rows (position x group) per block
constexpr int BN = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block
constexpr float kNegInf = -1e30f;

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

  // the KV tiles some row of this q tile may see; all of them when a row
  // sees no key (such rows lie at the ends of the position range)
  const int last_row = min(r0 + BM, rows) - 1;
  const int p_lo = q_offset + r0 / G;
  const int p_hi = q_offset + last_row / G;
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
  const int t_begin = k_begin / BN;
  const int t_end = k_end > k_begin ? (k_end + BN - 1) / BN : t_begin;

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

}  // namespace

extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int BH, int Sq, int Sk, int G, int D, int causal,
                                  int has_window, int window, int q_offset, void* stream) {
  return launch<float>(q, k, v, o, lse, BH, Sq, Sk, G, D, causal, has_window, window, q_offset,
                       stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int BH, int Sq, int Sk, int G, int D, int causal,
                                   int has_window, int window, int q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, BH, Sq, Sk, G, D, causal, has_window, window,
                               q_offset, stream);
}
