// K7: split-KV decode attention on Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_decode/kernel.py
// (flash_decode_pallas, body _decode_kernel, and the jnp combine after it).
// For one query token: q (B, Hkv, G, D), the cache k, v (B, S, Hkv, D) in
// the model's layout, read where it lies, and lengths (B,): the S keys are
// cut into `splits` equal splits; block (b, h, split, group of up to 8
// query rows) walks its keys with an online softmax in float32 (q upcast
// and scaled by 1/sqrt(D), keys at or past the row's length scored -1e30)
// and writes its unnormalised partial o with its running max m and sum l;
// a second kernel merges each (b, h)'s partials by the log-sum-exp algebra,
// o = sum_s exp(m_s - m) o_s / max(sum_s exp(m_s - m) l_s, 1e-30), and
// writes o in q's dtype. A row of length 0 keeps m = -1e30, so every p is
// exp(0) = 1 and the row gets the mean of V over the whole cache, as the
// reference does. A row of length len > 0 stops at the last tile below
// len: a key past it would add exp(-1e30 - m) = 0 to l and to o, and a
// split with no key below len keeps (m, l, o) = (-1e30, 0, 0), which the
// merge weighs by exp(-1e30 - m) = 0, as it weighs the reference's partial
// of that split.
//
// What bounds it on this card: bytes. A decode step needs each row's first
// len keys of the cache (all S for len = 0) once (at zamba2-2.7b, 4 full
// rows of 4096 keys, 32 KV heads of 80 in bf16: 168 MB, 0.050 ms at
// 3.35 TB/s) and does 4 flop a needed cache element.
//
// Design (a first kernel that is right; see PERF.md for what it costs):
// - a (B * Hkv, splits, ceil(G / 8)) grid of 128-thread blocks, so any G
//   is taken with the accumulator at 8 x 128; each stages 32 keys of
//   K and V at a time in shared memory as float32 (K rows padded by one
//   word), scores them against its query rows (one thread a (row, key)),
//   updates each row's (m, l) with one warp's max and sum over the 32 keys,
//   and keeps its rows' accumulator in registers, 8 elements a thread;
// - the merge is a second launch of the same call, one block per (b, h);
// - products are written as fmaf (the port builds with --fmad=false).
// Wider loads, more keys in flight and one launch for split and merge are
// work for the PR that makes K7 fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int TK = 32;      // keys a tile: one per lane of a warp
constexpr int GMAX = 8;     // query rows a block
constexpr int DMAX = 128;   // ops.py's MAX_D
constexpr int NR = GMAX * DMAX / NT;  // accumulator elements a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_floats(int G, int D) {
  return (size_t)G * D + (size_t)TK * (D + 1) + (size_t)TK * D + (size_t)G * TK + 3 * GMAX;
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int Hkv, int S, int Gall, int D, int split, float scale) {
  extern __shared__ float smem[];
  const int g0 = blockIdx.z * GMAX;            // this block's query rows: g0 .. g0 + G - 1
  const int G = min(GMAX, Gall - g0);
  const int DP = D + 1;
  float* sQ = smem;               // G x D, scaled
  float* sK = sQ + G * D;         // TK x (D + 1)
  float* sV = sK + TK * DP;       // TK x D
  float* sP = sV + TK * D;        // G x TK: scores, then p
  float* sM = sP + G * TK;        // running max a row
  float* sL = sM + GMAX;          // running sum a row
  float* sCorr = sL + GMAX;       // this tile's correction a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, si = blockIdx.y, splits = gridDim.y;
  const int b = bh / Hkv, hh = bh % Hkv;
  const int len = lengths[b];
  const int64_t RS = (int64_t)Hkv * D;                    // between keys
  const int64_t kvb = (int64_t)b * S * RS + (int64_t)hh * D;
  const T* qb = q + ((int64_t)bh * Gall + g0) * D;

  for (int e = tid; e < G * D; e += NT) sQ[e] = to_f(qb[e]) * scale;
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  const int s_end = (si + 1) * split;
  for (int t0 = si * split; t0 < s_end && (len <= 0 || t0 < len); t0 += TK) {
    const int nk = min(TK, s_end - t0);
    __syncthreads();  // the previous tile is consumed; sQ, sM and sL are set
    for (int e = tid; e < nk * D; e += NT) {
      const int j = e / D, d = e % D;
      const int64_t off = kvb + (int64_t)(t0 + j) * RS + d;
      sK[j * DP + d] = to_f(k[off]);
      sV[j * D + d] = to_f(v[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * TK; e += NT) {
      const int g = e / TK, j = e % TK;
      if (j >= nk) continue;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[j * DP + d], s);
      sP[g * TK + j] = t0 + j < len ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NT / 32) {
      const float s = lane < nk ? sP[g * TK + lane] : -INFINITY;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mt);
      const float p = lane < nk ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < nk) sP[g * TK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
        sCorr[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = tid + NT * r;
      if (e >= G * D) break;
      const int g = e / D, d = e % D;
      float pv = 0.f;
      for (int j = 0; j < nk; ++j) pv = fmaf(sP[g * TK + j], sV[j * D + d], pv);
      acc[r] = acc[r] * sCorr[g] + pv;
    }
  }
  __syncthreads();
  const int64_t part = (int64_t)bh * splits + si;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int e = tid + NT * r;
    if (e < G * D) o_part[(part * Gall + g0) * D + e] = acc[r];
  }
  if (tid < G) {
    m_part[part * Gall + g0 + tid] = sM[tid];
    l_part[part * Gall + g0 + tid] = sL[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_combine(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ o, int G, int D, int splits) {
  const int bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += NT) {
    const int g = e / D;
    const float* mb = m_part + (int64_t)bh * splits * G + g;
    const float* lb = l_part + (int64_t)bh * splits * G + g;
    float m_all = mb[0];
    for (int s = 1; s < splits; ++s) m_all = fmaxf(m_all, mb[(int64_t)s * G]);
    float denom = 0.f, num = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float corr = expf(mb[(int64_t)s * G] - m_all);
      denom += corr * lb[(int64_t)s * G];
      num += o_part[((int64_t)bh * splits + s) * G * D + e] * corr;
    }
    store_as(o + (int64_t)bh * G * D + e, num / fmaxf(denom, 1e-30f));
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* lengths, void* o_part,
          void* m_part, void* l_part, void* o, int B, int Hkv, int S, int G, int D, int splits,
          void* stream) {
  if (G <= 0 || D <= 0 || D > DMAX || S <= 0 || splits <= 0 || S % splits || splits > 65535 ||
      (G + GMAX - 1) / GMAX > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hkv <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the reference scales by float32(1 / np.sqrt(D)), rounded from double
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t smem = smem_floats(min(G, GMAX), D) * sizeof(float);  // at most 38 KB
  dim3 grid(B * Hkv, splits, (G + GMAX - 1) / GMAX);
  decode_partial<T><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                            (const int*)lengths, (float*)o_part, (float*)m_part,
                                            (float*)l_part, Hkv, S, G, D, S / splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<B * Hkv, NT, 0, st>>>((const float*)o_part, (const float*)m_part,
                                            (const float*)l_part, (T*)o, G, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_f32(const void* q, const void* k, const void* v, const void* lengths,
                                void* o_part, void* m_part, void* l_part, void* o, int B, int Hkv,
                                int S, int G, int D, int splits, void* stream) {
  return entry<float>(q, k, v, lengths, o_part, m_part, l_part, o, B, Hkv, S, G, D, splits,
                      stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o_part, void* m_part, void* l_part,
                                 void* o, int B, int Hkv, int S, int G, int D, int splits,
                                 void* stream) {
  return entry<__nv_bfloat16>(q, k, v, lengths, o_part, m_part, l_part, o, B, Hkv, S, G, D,
                              splits, stream);
}
