// K12b: the backward of the RWKV6 chunked WKV scan (K12) on Hopper.
//
// Replaces no Pallas kernel: the reference's backward of wkv_scan is
// jax.vjp of its sequential oracle (repro/kernels/rwkv6_wkv/ops.py,
// _wkv_bwd over wkv_ref), and the model's is JAX's autodiff of
// _wkv_chunked (repro/models/rwkv6.py). It was added so that the SSM family
// trains on the card. It computes the gradient of K12's function (csrc/
// rwkv6_wkv.cu; the plain version is autograd of ref.wkv_plain,
// ref.wkv_bwd_plain) chunk by chunk. With the chunk's forward
//   d  = cs - w, m = (total - w[0]) / 2,        cs the cumsum of w, total its last row
//   RD = r e^d, RF = r e^(d - m), KF = k e^(m - cs), KW = k e^(total - cs)
//   A  = strictly lower (RF KF^T)
//   y  = RD S0 + A v + (r . (u k)) v,  S1 = e^total S0 + KW^T v
// and dS the gradient of the chunk's end state S1 (the next chunk's start),
// a chunk's backward is
//   dA  = strictly lower (dy v^T)
//   dRF = dA KF, dKF = dA^T RF, dv = A^T dy + KW dS + cur dy
//   dRD = dy S0^T, dKW = v dS^T, dcur = rowsum(dy v)
//   dr  = dRD e^d + dRF e^(d - m) + dcur u k,  dk = dKW e^(total - cs) + dKF e^(m - cs) + dcur u r
//   du += sum_t dcur r k
//   dw  from the exponents: E1 = dRD RD, E2 = dRF RF, E3 = dKF KF, E4 = dKW KW,
//        g_cs = E1 + E2 - E3 - E4, g_w = -E1 - E2, g_m = colsum(E3 - E2),
//        g_total = colsum(E4) + e^total rowsum(dS S0) + g_m / 2, g_w[0] -= g_m / 2,
//        dw = g_w + the reverse cumsum of g_cs with g_total added at the last row
//   dS0 = e^total dS + RD^T dy          (the previous chunk's dS)
// which the per-step recurrence dS_{t-1} = e^{w_t} dS_t + r_t^T dy_t unrolls
// to. BF16_INTRA = true is the model's function: RF, KF, A and v enter the
// intra-chunk products rounded to bfloat16, and the gradients that cross
// those roundings (dA, dRF, dKF and A^T dy) are rounded to bfloat16 too,
// as JAX's transpose of a cast rounds them; the products are float32 sums
// of the rounded values (exact products), so no tensor core is needed to
// match.
//
// Design (the first, simple one): one 256-thread block per (b, h) walks
// its chunks. The chunks' starting states are not kept from the forward:
// the block first walks the chunks forward, S = e^total S + KW^T v (K12's
// serial state update), and writes each chunk's starting state into a
// float32 workspace (B, H, nc, K, K), 134 MB a layer at the rwkv6-7b
// training shape (2 x 4096 tokens, 64 heads); then it walks them backward
// carrying dS (K x K float32) in shared memory. Recomputing costs one
// c x K x K product a chunk against the backward's eleven, keeps the
// forward's memory and its launches unchanged, and serves both of K12's
// routes alike; a residual would hold 134 MB a layer from the forward to
// the backward, 1.07 GB at the smoke's 8 layers. Every product is a 4 x 4
// patch a thread on the CUDA cores (scan_bwd.cuh) over 64 x 65 float tiles
// in shared memory (12 tiles, 200 KB: one block an SM).
//
// What bounds it on this card: at the rwkv6-7b training shape a launch
// reads r, k, v, dy in bf16 and w in float32 (0.40 GB) and writes their
// gradients (0.40 GB), and its workspace is written and read once (0.27 GB):
// 0.32 ms at 3.35 TB/s. Its products are about 12 c K K + 5 c c K / 2 flop
// pairs a chunk, 2.9e10 flop in all, 0.44 ms at 67 TFLOP/s: so
// operations. The design is latency-bound first: 128 blocks (less than a
// wave of 132 SMs), 64 chunks each in order.
//
// Products are written as fmaf (the port builds with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_scan.cuh"
#include "scan_bwd.cuh"

namespace {

using chunk_scan::bf16_round;
using chunk_scan::from_f;
using chunk_scan::to_f;
using scan_bwd::NT;
using scan_bwd::patch;
using scan_bwd::zero;

constexpr int MAXK = 64;       // K and c limits (ops.py's MAX_K, MAX_CHUNK)
constexpr int LD = MAXK + 1;   // float row of every tile
constexpr int TILE = MAXK * LD;
constexpr int NTILES = 12;
constexpr size_t SMEM = (size_t)(NTILES * TILE + 5 * MAXK) * sizeof(float);

template <bool ROUND>
__device__ __forceinline__ float rnd(float v) {
  return ROUND ? bf16_round(v) : v;
}

template <typename T, typename TW, bool BF16_INTRA>
__global__ void __launch_bounds__(NT, 1) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, const T* __restrict__ dy,
    const float* __restrict__ dstate, T* __restrict__ dr, T* __restrict__ dk,
    T* __restrict__ dv, TW* __restrict__ dw, float* __restrict__ du, float* __restrict__ ws,
    int S, int H, int K, int c, int u_per_row) {
  extern __shared__ float sm[];
  float* sR = sm;              // r
  float* sK = sR + TILE;       // k
  float* sV = sK + TILE;       // v
  float* sD = sV + TILE;       // w, then d = cs - w
  float* sC = sD + TILE;       // cs
  float* sY = sC + TILE;       // dy
  float* sS0 = sY + TILE;      // the chunk's starting state S0 (K x K)
  float* sdS = sS0 + TILE;     // dS, the gradient of the chunk's end state
  float* sX0 = sdS + TILE;     // RF, then RD, then E3 - E2
  float* sX1 = sX0 + TILE;     // KF, then KW, then E4
  float* sX2 = sX1 + TILE;     // A, then g_cs
  float* sX3 = sX2 + TILE;     // dA, then g_w
  float* vCur = sX3 + TILE;    // r . (u k) per row
  float* vDcur = vCur + MAXK;  // dy . v per row
  float* vU = vDcur + MAXK;
  float* vTot = vU + MAXK;     // total per channel
  float* vM = vTot + MAXK;     // m per channel

  const int tid = threadIdx.x;
  const int b = blockIdx.x;    // (batch, head)
  const int h = b % H;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = (int64_t)(b / H) * S * RS + (int64_t)h * K;
  const int nc = S / c;
  const int64_t KK = (int64_t)K * K;
  float* wsb = ws + (int64_t)b * nc * KK;
  const int i0 = 4 * (tid >> 4), j0 = 4 * (tid & 15);   // this thread's patch

  for (int j = tid; j < K; j += NT) vU[j] = u[(u_per_row ? (int64_t)b : (int64_t)h) * K + j];

  auto load = [&](float* dst, const auto* src, int t0) {
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e - t * K;
      dst[t * LD + j] = to_f(src[base + (int64_t)(t0 + t) * RS + j]);
    }
  };
  // cs per channel from the w in sD, one running sum in row order (K12's)
  auto cumsum = [&]() {
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += sD[t * LD + tid];
        sC[t * LD + tid] = acc;
      }
    }
  };

  // 1. the forward walk: each chunk's starting state into the workspace
  float st[4][4];
  zero(st);
  for (int jc = 0; jc < nc; ++jc) {
    const int t0 = jc * c;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        if (i0 + a < K && j0 + bb < K) wsb[jc * KK + (i0 + a) * K + j0 + bb] = st[a][bb];
    load(sK, k, t0);
    load(sV, v, t0);
    load(sD, w, t0);
    __syncthreads();
    cumsum();
    __syncthreads();
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e - t * K;
      sX1[t * LD + j] = sK[t * LD + j] * expf(sC[(c - 1) * LD + j] - sC[t * LD + j]);
    }
    __syncthreads();
    float acc[4][4];
    zero(acc);
    patch(acc, i0, j0, 0, c, [&](int j, int s) { return sX1[s * LD + j]; },
          [&](int s, int i) { return sV[s * LD + i]; });
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float dec = i0 + a < K ? expf(sC[(c - 1) * LD + i0 + a]) : 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) st[a][bb] = dec * st[a][bb] + acc[a][bb];
    }
    __syncthreads();
  }

  // 2. the backward walk
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      if (i0 + a < K && j0 + bb < K)
        sdS[(i0 + a) * LD + j0 + bb] =
            dstate ? dstate[(int64_t)b * KK + (i0 + a) * K + j0 + bb] : 0.f;
  float du_acc = 0.f;
  for (int jc = nc - 1; jc >= 0; --jc) {
    const int t0 = jc * c;
    load(sR, r, t0);
    load(sK, k, t0);
    load(sV, v, t0);
    load(sD, w, t0);
    load(sY, dy, t0);
    for (int e = tid; e < K * K; e += NT) {
      const int j = e / K, i = e - j * K;
      sS0[j * LD + i] = wsb[jc * KK + e];
    }
    __syncthreads();
    if (tid < K) {
      cumsum();
      const float tot = sC[(c - 1) * LD + tid];
      vTot[tid] = tot;
      vM[tid] = 0.5f * (tot - sD[tid]);
      for (int t = 0; t < c; ++t) sD[t * LD + tid] = sC[t * LD + tid] - sD[t * LD + tid];
    } else if (tid >= MAXK && tid - MAXK < c) {
      const int t = tid - MAXK;
      float cu = 0.f, dc = 0.f;
      for (int j = 0; j < K; ++j) {
        cu += sR[t * LD + j] * vU[j] * sK[t * LD + j];
        dc += sY[t * LD + j] * sV[t * LD + j];
      }
      vCur[t] = cu;
      vDcur[t] = dc;
    }
    __syncthreads();
    // the separable factors as the intra-chunk products take them
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e - t * K;
      const int at = t * LD + j;
      const float m = vM[j];
      sX0[at] = rnd<BF16_INTRA>(sR[at] * expf(sD[at] - m));
      sX1[at] = rnd<BF16_INTRA>(sK[at] * expf(m - sC[at]));
    }
    __syncthreads();
    // A and dA, strictly lower triangular (c x c)
    if (i0 < c && j0 < c) {
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      patch(a1, i0, j0, 0, K, [&](int q, int j) { return sX0[q * LD + j]; },
            [&](int j, int s) { return sX1[s * LD + j]; });
      patch(a2, i0, j0, 0, K, [&](int q, int i) { return sY[q * LD + i]; },
            [&](int i, int s) { return rnd<BF16_INTRA>(sV[s * LD + i]); });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int q = i0 + a, s = j0 + bb;
          if (q < c && s < c) {
            sX2[q * LD + s] = s < q ? rnd<BF16_INTRA>(a1[a][bb]) : 0.f;
            sX3[q * LD + s] = s < q ? rnd<BF16_INTRA>(a2[a][bb]) : 0.f;
          }
        }
    }
    __syncthreads();
    // the intra-chunk gradients: dRF = dA KF, dKF = dA^T RF, A^T dy
    float gRF[4][4], gKF[4][4], gVi[4][4];
    zero(gRF);
    zero(gKF);
    zero(gVi);
    if (i0 < c) {
      patch(gRF, i0, j0, 0, min(c, i0 + 3), [&](int q, int s) { return sX3[q * LD + s]; },
            [&](int s, int j) { return sX1[s * LD + j]; });
      patch(gKF, i0, j0, i0 + 1, c, [&](int s, int q) { return sX3[q * LD + s]; },
            [&](int q, int j) { return sX0[q * LD + j]; });
      patch(gVi, i0, j0, i0 + 1, c, [&](int s, int q) { return sX2[q * LD + s]; },
            [&](int q, int i) { return sY[q * LD + i]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          gRF[a][bb] = rnd<BF16_INTRA>(gRF[a][bb]);
          gKF[a][bb] = rnd<BF16_INTRA>(gKF[a][bb]);
          gVi[a][bb] = rnd<BF16_INTRA>(gVi[a][bb]);
        }
    }
    __syncthreads();
    // RD and KW over RF and KF
    for (int e = tid; e < c * K; e += NT) {
      const int t = e / K, j = e - t * K;
      const int at = t * LD + j;
      sX0[at] = sR[at] * expf(sD[at]);
      sX1[at] = sK[at] * expf(vTot[j] - sC[at]);
    }
    __syncthreads();
    // the state's gradients: dRD = dy S0^T, dKW = v dS^T, KW dS, RD^T dy
    float gRD[4][4], gKW[4][4], gVs[4][4], gS[4][4];
    zero(gRD);
    zero(gKW);
    zero(gVs);
    zero(gS);
    if (i0 < c) {
      patch(gRD, i0, j0, 0, K, [&](int q, int i) { return sY[q * LD + i]; },
            [&](int i, int j) { return sS0[j * LD + i]; });
      patch(gKW, i0, j0, 0, K, [&](int s, int i) { return sV[s * LD + i]; },
            [&](int i, int j) { return sdS[j * LD + i]; });
      patch(gVs, i0, j0, 0, K, [&](int s, int j) { return sX1[s * LD + j]; },
            [&](int j, int i) { return sdS[j * LD + i]; });
    }
    patch(gS, i0, j0, 0, c, [&](int j, int q) { return sX0[q * LD + j]; },
          [&](int q, int i) { return sY[q * LD + i]; });
    __syncthreads();
    // dr, dk, dv out; the exponents' terms into the four scratch tiles
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int t = i0 + a, j = j0 + bb;
        if (t < c && j < K) {
          const int at = t * LD + j;
          const float d = sD[at], cs = sC[at], m = vM[j], tot = vTot[j];
          const float rv = sR[at], kv = sK[at], dc = vDcur[t], uj = vU[j];
          const float ed = expf(d), edm = expf(d - m), emc = expf(m - cs), etc = expf(tot - cs);
          const int64_t off = base + (int64_t)(t0 + t) * RS + j;
          dr[off] = from_f<T>(gRD[a][bb] * ed + gRF[a][bb] * edm + dc * uj * kv);
          dk[off] = from_f<T>(gKW[a][bb] * etc + gKF[a][bb] * emc + dc * uj * rv);
          dv[off] = from_f<T>(gVs[a][bb] + gVi[a][bb] + vCur[t] * sY[at]);
          const float e1 = gRD[a][bb] * (rv * ed), e2 = gRF[a][bb] * (rv * edm);
          const float e3 = gKF[a][bb] * (kv * emc), e4 = gKW[a][bb] * (kv * etc);
          sX0[at] = e3 - e2;
          sX1[at] = e4;
          sX2[at] = e1 + e2 - e3 - e4;
          sX3[at] = -(e1 + e2);
        }
      }
    __syncthreads();
    // dw per channel: the reverse cumsum of g_cs; du
    if (tid < K) {
      const int j = tid;
      float gm = 0.f, g4 = 0.f, rs = 0.f, dua = 0.f;
      for (int t = 0; t < c; ++t) {
        gm += sX0[t * LD + j];
        g4 += sX1[t * LD + j];
        dua += vDcur[t] * sR[t * LD + j] * sK[t * LD + j];
      }
      for (int i = 0; i < K; ++i) rs = fmaf(sdS[j * LD + i], sS0[j * LD + i], rs);
      du_acc += dua;
      float acc = g4 + expf(vTot[j]) * rs + 0.5f * gm;   // g_total, at the last row
      for (int t = c - 1; t >= 0; --t) {
        acc += sX2[t * LD + j];
        float g = sX3[t * LD + j] + acc;
        if (t == 0) g -= 0.5f * gm;
        dw[base + (int64_t)(t0 + t) * RS + j] = from_f<TW>(g);
      }
    }
    __syncthreads();
    // dS for the previous chunk
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = i0 + a, i = j0 + bb;
        if (j < K && i < K) sdS[j * LD + i] = expf(vTot[j]) * sdS[j * LD + i] + gS[a][bb];
      }
    __syncthreads();
  }
  if (tid < K) du[(int64_t)b * K + tid] = du_acc;
}

template <typename T, typename TW, bool BF16_INTRA>
int entry(const void* r, const void* k, const void* v, const void* w, const void* u,
          const void* dy, const void* dstate, void* dr, void* dk, void* dv, void* dw, void* du,
          void* ws, int B, int S, int H, int K, int c, int u_per_row, void* stream) {
  if (K <= 0 || K > MAXK || c <= 0 || c > MAXK || (S > 0 && S % c)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || H <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<T, TW, BF16_INTRA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_kernel<T, TW, BF16_INTRA><<<B * H, NT, SMEM, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u, (const T*)dy,
      (const float*)dstate, (T*)dr, (T*)dk, (T*)dv, (TW*)dw, (float*)du, (float*)ws, S, H, K,
      c, u_per_row);
  return (int)cudaGetLastError();
}

}  // namespace

#define WKV_BWD_ENTRY(SUFFIX, T, TW, BF16_INTRA)                                             \
  extern "C" int rwkv6_wkv_bwd_##SUFFIX(                                                      \
      const void* r, const void* k, const void* v, const void* w, const void* u,             \
      const void* dy, const void* dstate, void* dr, void* dk, void* dv, void* dw, void* du,  \
      void* ws, int B, int S, int H, int K, int c, int u_per_row, void* stream) {           \
    return entry<T, TW, BF16_INTRA>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du, ws, B, S, \
                                    H, K, c, u_per_row, stream);                             \
  }

WKV_BWD_ENTRY(f32_f32_f32, float, float, false)
WKV_BWD_ENTRY(f32_f32_bf16, float, float, true)
WKV_BWD_ENTRY(f32_bf16_f32, float, __nv_bfloat16, false)
WKV_BWD_ENTRY(f32_bf16_bf16, float, __nv_bfloat16, true)
WKV_BWD_ENTRY(bf16_f32_f32, __nv_bfloat16, float, false)
WKV_BWD_ENTRY(bf16_f32_bf16, __nv_bfloat16, float, true)
WKV_BWD_ENTRY(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, false)
WKV_BWD_ENTRY(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, true)
