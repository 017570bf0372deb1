// K12: the RWKV6 chunked WKV scan on Hopper.
//
// Replaces the Pallas kernel repro/kernels/rwkv6_wkv/kernel.py
// (wkv_fwd_pallas, body _wkv_kernel). For r, k, v (B, S, H, K) of one dtype
// (bfloat16 or float32), the log decay w (B, S, H, K) (bfloat16 or float32)
// and the bonus u (H, K), or one row of it per (b, h), float32: per (b, h)
// and per chunk of c rows, with cs the per-channel cumulative sum of w over
// the chunk, total its last row and m = (total - w[0]) / 2 (the midpoint
// shift that keeps both separable factors in float32 range at c <= 64 and
// the model's decay floor of -2):
//   y  = (r * exp(cs - w)) . S                            the state's part
//      + sum_{s < q} [(r * exp(cs - w - m))_q . (k * exp(m - cs))_s] v_s
//      + (r . (u * k)) v                                  the current token
//   S  = exp(total) * S + (k * exp(total - cs))^T . v
// in that order, y written in r's dtype and the final (K, K) float32 state
// beside it. Two instantiations of one body: BF16_INTRA = false is the
// Pallas kernel's function (every product in float32); BF16_INTRA = true is
// the reference model's _wkv_chunked (models/rwkv6.py), which rounds the
// two separable factors, the masked att and v to bfloat16 before the two
// intra-chunk products and sums them in float32.
//
// What bounds it on this card: at the rwkv6-7b prefill (2 x 4096 tokens,
// 64 heads of K = 64, c = 64) a launch reads r, k, v in bf16 and w in
// float32 and writes y: 0.40 GB, 0.12 ms at 3.35 TB/s; its products are
// about 1.3e10 float32 flop, 0.19 ms at 67 TFLOP/s. So operations, if the
// card were full; at B * H = 128 blocks it is less than one wave of 132
// SMs, one block of 8 warps per SM, and latency bounds it.
//
// Design (a first kernel that is right; see PERF.md for what it costs):
// - one 256-thread block per (b, h); the chunks are a loop inside it, as
//   the Pallas grid's fori_loop is;
// - the (K, K) float32 state lives in registers: thread (i = tid / 4, g =
//   tid % 4) holds column i, rows g, g + 4, ..., 16 values at K = 64;
// - a chunk's r, k, v, w, cs, the two separable factors and the (c, c) att
//   tile live in shared memory as float32, rows padded to K + 1 (and c + 1)
//   floats so that column walks hit distinct banks: 133 KB at c = K = 64,
//   above 48 KB, so the launch first raises the kernel's dynamic limit;
// - per chunk: load; cumsum per channel (K threads) beside the bonus per
//   row (c threads); the factors; att's strictly lower triangle; then each
//   thread reduces the state's part over its 16 rows with two shuffles
//   across the 4 threads of a column, adds the intra-chunk sum and the bonus
//   for the rows q = g mod 4 it owns, and updates its state values; y goes
//   out through shared memory in whole rows;
// - products are written as fmaf (the port builds with --fmad=false).
// Splitting the value columns across blocks would fill the card; that is
// work for the PR that makes K12 fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAXK = 64;  // K and c limits (ops.py's MAX_K, MAX_CHUNK)
constexpr int ROWS_PER = MAXK / 4;  // state rows per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

size_t smem_floats(int c, int K) {
  const size_t ld = K + 1;
  return 7 * (size_t)c * ld + (size_t)c * (c + 1) + c + K;
}

template <typename T, typename TW, bool BF16_INTRA>
__global__ void __launch_bounds__(NT) wkv_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
    float* __restrict__ sout, int S, int H, int K, int c, int u_per_row) {
  extern __shared__ float smem[];
  const int LD = K + 1, LA = c + 1;
  float* sR = smem;            // r, then r * exp(cs - w)
  float* sK = sR + c * LD;     // k, then k * exp(total - cs)
  float* sV = sK + c * LD;     // v
  float* sW = sV + c * LD;     // w
  float* sC = sW + c * LD;     // cs
  float* sF = sC + c * LD;     // r_f, then y
  float* sG = sF + c * LD;     // k_f
  float* sA = sG + c * LD;     // att (c, c + 1)
  float* sB = sA + c * LA;     // bonus per row
  float* sU = sB + c;          // u

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int h = b % H;
  const int64_t RS = (int64_t)H * K;                      // between time steps
  const int64_t base = (int64_t)(b / H) * S * RS + (int64_t)h * K;
  const int i = tid >> 2, g = tid & 3;                    // state column, row phase

  for (int j = tid; j < K; j += NT) sU[j] = u[(u_per_row ? (int64_t)b : (int64_t)h) * K + j];

  float st[ROWS_PER];
#pragma unroll
  for (int a = 0; a < ROWS_PER; ++a) st[a] = 0.f;

  for (int t0 = 0; t0 < S; t0 += c) {
    // load the chunk
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e % K;
      const int64_t off = base + (int64_t)(t0 + t) * RS + j;
      sR[t * LD + j] = to_f(r[off]);
      sK[t * LD + j] = to_f(k[off]);
      sV[t * LD + j] = to_f(v[off]);
      sW[t * LD + j] = to_f(w[off]);
    }
    __syncthreads();
    // cumsum per channel; the bonus r . (u * k) per row
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += sW[t * LD + tid];
        sC[t * LD + tid] = acc;
      }
    } else if (tid >= MAXK && tid - MAXK < c) {
      const int t = tid - MAXK;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc += sR[t * LD + j] * sU[j] * sK[t * LD + j];
      sB[t] = acc;
    }
    __syncthreads();
    // the factors
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e % K;
      const int at = t * LD + j;
      const float cs = sC[at], total = sC[(c - 1) * LD + j];
      const float m = 0.5f * (total - sW[j]);
      const float d = cs - sW[at];
      const float rv = sR[at], kv = sK[at];
      float rf = rv * expf(d - m), kf = kv * expf(m - cs);
      if (BF16_INTRA) {
        rf = bf16_round(rf);
        kf = bf16_round(kf);
      }
      sR[at] = rv * expf(d);
      sF[at] = rf;
      sG[at] = kf;
      sK[at] = kv * expf(total - cs);
    }
    __syncthreads();
    // att, strictly lower triangular
    for (int e = tid; e < c * c; e += NT) {
      const int q = e / c, s = e % c;
      float a = 0.f;
      if (s < q) {
        for (int j = 0; j < K; ++j) a = fmaf(sF[q * LD + j], sG[s * LD + j], a);
        if (BF16_INTRA) a = bf16_round(a);
      }
      sA[q * LA + s] = a;
    }
    __syncthreads();
    // the state's part of y (all threads take part in the shuffles)
    for (int q = 0; q < c; ++q) {
      float p = 0.f;
#pragma unroll
      for (int a = 0; a < ROWS_PER; ++a) {
        const int j = g + 4 * a;
        if (j < K) p = fmaf(sR[q * LD + j], st[a], p);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (i < K && g == (q & 3)) sF[q * LD + i] = p;
    }
    if (i < K) {
      // + the intra-chunk part, + the bonus, for the rows this thread owns
      for (int q = g; q < c; q += 4) {
        float a = 0.f;
        for (int s = 0; s < q; ++s) {
          const float vs = BF16_INTRA ? bf16_round(sV[s * LD + i]) : sV[s * LD + i];
          a = fmaf(sA[q * LA + s], vs, a);
        }
        const float yq = sF[q * LD + i] + a;
        sF[q * LD + i] = yq + sB[q] * sV[q * LD + i];
      }
      // the state update
#pragma unroll
      for (int a = 0; a < ROWS_PER; ++a) {
        const int j = g + 4 * a;
        if (j < K) {
          float acc = 0.f;
          for (int s = 0; s < c; ++s) acc = fmaf(sK[s * LD + j], sV[s * LD + i], acc);
          st[a] = expf(sC[(c - 1) * LD + j]) * st[a] + acc;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e % K;
      y[base + (int64_t)(t0 + t) * RS + j] = from_f<T>(sF[t * LD + j]);
    }
    // the next chunk's load writes sR, sK, sV, sW only; sF is rewritten
    // after two more barriers
  }

  if (i < K) {
#pragma unroll
    for (int a = 0; a < ROWS_PER; ++a) {
      const int j = g + 4 * a;
      if (j < K) sout[(int64_t)b * K * K + (int64_t)j * K + i] = st[a];
    }
  }
}

template <typename T, typename TW, bool BF16_INTRA>
int entry(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
          void* sout, int B, int S, int H, int K, int c, int u_per_row, void* stream) {
  if (K <= 0 || K > MAXK || c <= 0 || c > MAXK || (S > 0 && S % c)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || H <= 0) return 0;
  const size_t smem = smem_floats(c, K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv_kernel<T, TW, BF16_INTRA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<T, TW, BF16_INTRA><<<B * H, NT, smem, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u, (T*)y,
      (float*)sout, S, H, K, c, u_per_row);
  return (int)cudaGetLastError();
}

}  // namespace

#define WKV_ENTRY(SUFFIX, T, TW, BF16_INTRA)                                                 \
  extern "C" int rwkv6_wkv_##SUFFIX(const void* r, const void* k, const void* v,            \
                                    const void* w, const void* u, void* y, void* sout, int B, \
                                    int S, int H, int K, int c, int u_per_row,               \
                                    void* stream) {                                          \
    return entry<T, TW, BF16_INTRA>(r, k, v, w, u, y, sout, B, S, H, K, c, u_per_row,       \
                                    stream);                                                 \
  }

WKV_ENTRY(f32_f32_f32, float, float, false)
WKV_ENTRY(f32_f32_bf16, float, float, true)
WKV_ENTRY(f32_bf16_f32, float, __nv_bfloat16, false)
WKV_ENTRY(f32_bf16_bf16, float, __nv_bfloat16, true)
WKV_ENTRY(bf16_f32_f32, __nv_bfloat16, float, false)
WKV_ENTRY(bf16_f32_bf16, __nv_bfloat16, float, true)
WKV_ENTRY(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, false)
WKV_ENTRY(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, true)
