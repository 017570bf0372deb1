// K8: the Mamba2 SSD chunk scan on Hopper.
//
// Replaces the Pallas kernel repro/kernels/mamba2_ssd/kernel.py
// (ssd_fwd_pallas, body _ssd_kernel). For x (Bt, S, H, P), B and C (Bt, S,
// H, N) of one dtype (bfloat16 or float32) and the float32 log decay a
// (Bt, S, H; ops.py casts a bfloat16 one first, as the Pallas kernel
// does): per (b, h) and per chunk of c rows, with cs the float32
// cumulative sum of a over the chunk and total its last entry,
//   s  = (C . B^T) * exp(cs_q - cs_s)          for s <= q, else 0
//   y  = s . x + (C * exp(cs)) . h^T
//   h  = exp(total) * h + x^T . (B * exp(total - cs))
// in that order, y written in x's dtype and the final (P, N) float32 state
// beside it. One body, built for x in each dtype: MODEL = false is the Pallas
// kernel's function (every product in float32, y rounded once); MODEL =
// true is the reference model's _ssd_chunked (models/mamba2.py), which
// rounds C . B^T to x's dtype before the mask, the masked scores to x's
// dtype before the intra-chunk product, that product and the state's part
// each to x's dtype, and sums the two in x's dtype (no-ops in float32).
// Only the lower triangle of exp(cs_q - cs_s) is evaluated: an upper
// entry's exponent can overflow, and the reference's where() drops it.
//
// What bounds it on this card: at the zamba2-2.7b prefill (2 x 4096
// tokens, 80 heads of P = N = 64, c = 128) a launch reads x, B and C in bf16
// and a in float32 and writes y: about 0.34 GB, 0.10 ms at 3.35 TB/s. Its
// products are about 1.07e10 float32 flop (the state's part and the state
// update) and 1.08e10 on bf16 operands (the two triangular intra-chunk
// products): 0.17 ms at 67 and 989 TFLOP/s. So operations, if the card
// were full; at Bt * H = 160 blocks of 183 KB of shared memory it runs one
// block an SM in two waves, and shared-memory bandwidth bounds each block.
//
// Design (a first kernel that is right; see PERF.md for what it costs):
// - one 256-thread block per (b, h); the chunks are a loop inside it, as
//   the Pallas grid's fori_loop is;
// - a chunk's x, B and C, the (c, c) masked scores and the state live in
//   dynamic shared memory as float32, rows padded to 65 (and 129) floats so
//   that column walks hit distinct banks: 183 KB for c <= 128 and P, N <=
//   64, above 48 KB, so the launch first raises the kernel's limit and
//   checks the return code; rows past c and columns past P, N stay zero;
// - thread (ty = tid / 16, tx = tid % 16) computes rows ty + 16 i of each
//   product against columns tx + 16 j: an 8 x 8 patch of the scores, an
//   8 x 4 patch of y (kept as the two parts the model rounds apart) and a
//   4 x 4 patch of the state, which it keeps in registers and copies to
//   shared memory after each update for the next chunk's state part;
// - the cumsum is one warp's scan, four rows a lane;
// - products are written as fmaf (the port builds with --fmad=false).
// Tensor cores for the bf16 intra-chunk products and TMA loads are work
// for the PR that makes K8 fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int CMAX = 128;       // chunk rows (ops.py's MAX_CHUNK)
constexpr int WMAX = 64;        // P and N (ops.py's MAX_PN)
constexpr int LD = WMAX + 1;    // padded row of the x, B, C and state tiles
constexpr int LS = CMAX + 1;    // padded row of the score tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// a rounding to x's dtype that only the model's function makes
template <typename T, bool MODEL>
__device__ __forceinline__ float mrnd(float v) {
  return MODEL ? to_f(from_f<T>(v)) : v;
}

constexpr int SMEM_FLOATS = 3 * CMAX * LD + CMAX * LS + WMAX * LD + CMAX;  // 183,040 bytes

template <typename T, bool MODEL>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ a, T* __restrict__ y, float* __restrict__ hout, int S, int H, int P,
    int N, int c, int ldx, int ldb, int ldc) {
  extern __shared__ float smem[];
  float* sX = smem;                // x (CMAX, LD)
  float* sB = sX + CMAX * LD;      // B, then B * exp(total - cs)
  float* sC = sB + CMAX * LD;      // C
  float* sS = sC + CMAX * LD;      // masked scores (CMAX, LS)
  float* sH = sS + CMAX * LS;      // state h[p][n] at the chunk's start (WMAX, LD)
  float* sCs = sH + WMAX * LD;     // cs (CMAX)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int blk = blockIdx.x;
  const int b = blk / H, h = blk % H;
  const int64_t xb = (int64_t)b * S * ldx + (int64_t)h * P;
  const int64_t bb = (int64_t)b * S * ldb + (int64_t)h * N;
  const int64_t cb = (int64_t)b * S * ldc + (int64_t)h * N;
  const int64_t ab = (int64_t)b * S * H + h;
  const int64_t YS = (int64_t)H * P;                      // y's row stride
  const int64_t yb = (int64_t)b * S * YS + (int64_t)h * P;

  for (int e = tid; e < SMEM_FLOATS; e += NT) smem[e] = 0.f;
  float hr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[i][j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += c) {
    // load the chunk; warp 0 also scans a (four rows a lane)
    for (int e = tid; e < c * P; e += NT) {
      const int t = e / P, j = e % P;
      sX[t * LD + j] = to_f(x[xb + (int64_t)(t0 + t) * ldx + j]);
    }
    for (int e = tid; e < c * N; e += NT) {
      const int t = e / N, j = e % N;
      sB[t * LD + j] = to_f(Bm[bb + (int64_t)(t0 + t) * ldb + j]);
      sC[t * LD + j] = to_f(Cm[cb + (int64_t)(t0 + t) * ldc + j]);
    }
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * tid + r;
        run += t < c ? to_f(a[ab + (int64_t)(t0 + t) * H]) : 0.f;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * tid + r;
        if (t < c) sCs[t] = excl + v[r];
      }
    }
    __syncthreads();

    // scores: rows q = ty + 16 i, keys k = tx + 16 j, the lower triangle masked
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float cq[8], bk[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cq[i] = sC[(ty + 16 * i) * LD + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bk[j] = sB[(tx + 16 * j) * LD + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cq[i], bk[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          float s = 0.f;
          if (k <= q && q < c) {
            s = mrnd<T, MODEL>(mrnd<T, MODEL>(acc[i][j]) * expf(sCs[q] - sCs[k]));
          }
          sS[q * LS + k] = s;
        }
      }
    }
    __syncthreads();

    // y = s . x + (C * exp(cs)) . h^T: rows q = ty + 16 i, columns p = tx + 16 j
    {
      float yi[8][4], ys[8][4], e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = expf(sCs[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = ys[i][j] = 0.f;
      }
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float cd[8], hv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cd[i] = sC[(ty + 16 * i) * LD + n] * e[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = sH[(tx + 16 * j) * LD + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ys[i][j] = fmaf(cd[i], hv[j], ys[i][j]);
      }
#pragma unroll 2
      for (int k = 0; k < c; ++k) {
        float sv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) sv[i] = sS[(ty + 16 * i) * LS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[k * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(sv[i], xv[j], yi[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
        if (q >= c) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p >= P) continue;
          const float v = mrnd<T, MODEL>(yi[i][j]) + mrnd<T, MODEL>(ys[i][j]);
          y[yb + (int64_t)(t0 + q) * YS + p] = from_f<T>(v);
        }
      }
    }
    __syncthreads();

    // h = exp(total) h + x^T . (B * exp(total - cs)): p = ty + 16 i, n = tx + 16 j
    const float total = sCs[c - 1];
    for (int e = tid; e < c * N; e += NT) {
      const int t = e / N, n = e % N;
      sB[t * LD + n] = sB[t * LD + n] * expf(total - sCs[t]);
    }
    __syncthreads();
    {
      const float et = expf(total);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < c; ++k) {
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[k * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[k * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hr[i][j] = et * hr[i][j] + acc[i][j];
          sH[(ty + 16 * i) * LD + tx + 16 * j] = hr[i][j];
        }
    }
    __syncthreads();  // the next chunk overwrites sX, sB, sC and reads sH
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (p < P && n < N) hout[((int64_t)blk * P + p) * N + n] = hr[i][j];
    }
  }
}

template <typename T, bool MODEL>
int entry(const void* x, const void* Bm, const void* Cm, const void* a, void* y, void* hout,
          int Bt, int S, int H, int P, int N, int c, int ldx, int ldb, int ldc, void* stream) {
  if (P <= 0 || P > WMAX || N <= 0 || N > WMAX || c <= 0 || c > CMAX || S < 0 || S % c) {
    return (int)cudaErrorInvalidValue;
  }
  if (Bt <= 0 || H <= 0) return 0;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, MODEL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T, MODEL><<<Bt * H, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (T*)y, (float*)hout, S, H, P,
      N, c, ldx, ldb, ldc);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_ENTRY(SUFFIX, T, MODEL)                                                           \
  extern "C" int mamba2_ssd_##SUFFIX(const void* x, const void* Bm, const void* Cm,          \
                                     const void* a, void* y, void* hout, int Bt, int S, int H, \
                                     int P, int N, int c, int ldx, int ldb, int ldc,          \
                                     void* stream) {                                          \
    return entry<T, MODEL>(x, Bm, Cm, a, y, hout, Bt, S, H, P, N, c, ldx, ldb, ldc, stream); \
  }

SSD_ENTRY(f32_f32, float, false)
SSD_ENTRY(f32_model, float, true)
SSD_ENTRY(bf16_f32, __nv_bfloat16, false)
SSD_ENTRY(bf16_model, __nv_bfloat16, true)
