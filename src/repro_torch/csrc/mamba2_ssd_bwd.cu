// K8b: the backward of the Mamba2 SSD chunk scan (K8) on Hopper.
//
// Replaces no Pallas kernel: the reference's backward of ssd_scan is
// jax.vjp of its sequential oracle (repro/kernels/mamba2_ssd/ops.py,
// _ssd_bwd over ssd_ref), and the model's is JAX's autodiff of
// _ssd_chunked (repro/models/mamba2.py). It was added so that the hybrid
// family trains on the card. It computes the gradient of K8's function
// (csrc/mamba2_ssd.cu; the plain version is autograd of ref.ssd_plain,
// ref.ssd_bwd_plain) chunk by chunk. With the chunk's forward, cs the
// cumsum of the log decay a over the chunk, total its last entry,
//   L[q][s] = e^(cs_q - cs_s) for s <= q,  SC = rnd(C B^T),  rs = rnd(SC L)
//   y  = rnd(rnd(rs x) + rnd((C e^cs) h0^T)),  h1 = e^total h0 + x^T (B e^(total - cs))
// (rnd rounds to x's dtype in the model's function in bfloat16, and is
// the identity otherwise) and dh the gradient of the chunk's end state h1,
// a chunk's backward is, with g = dy,
//   gs  = rnd(g x^T) on the lower triangle,  gSC = rnd(gs L)
//   dC  = gSC B + (g h0) e^cs,  dB = gSC^T C + (x dh) e^(total - cs)
//   dx  = rs^T g + (B e^(total - cs)) dh^T
//   dh0 = e^total dh + g^T (C e^cs)          (the previous chunk's dh)
//   da  = the reverse cumsum of g_cs, where
//   g_cs[q] = rowsum_q(gs SC L) - colsum_q(gs SC L) + rowsum(g h0 . C) e^cs_q
//             - rowsum(x dh . B)_q e^(total - cs_q),
//   plus e^total sum(dh h0) + sum_s rowsum(x dh . B)_s e^(total - cs_s) at the last row,
// which the per-step recurrence dh_t = dy_t^T C_t + e^{a_{t+1}} dh_{t+1}
// unrolls to. The gradients that cross a rounding are rounded as JAX's
// transpose of a cast rounds them (gs, gSC), and dx, dB and dC are written
// in x's dtype.
//
// Design (the first, simple one): one 256-thread block per (b, h) walks
// its chunks. The chunks' starting states are not kept from the forward:
// the block first walks the chunks forward, h = e^total h + x^T (B e^(total
// - cs)) (K8's state update), and writes each chunk's starting state into a
// float32 workspace (Bt, H, nc, P, N), 42 MB a layer at the zamba2-2.7b
// training shape (2 x 4096 tokens, 80 heads of P = N = 64, c = 128); then it
// walks them backward carrying dh (P x N float32) in shared memory, reading
// the chunk's h0 back from the workspace (L2). x, B, C and dy are float
// tiles in shared memory (rows of 65 floats), and the two c x c matrices
// (SC then rs, gs then gSC) packed lower triangles: 215 KB at c = 128, one
// block an SM. Every product is a 4 x 4 patch a thread on the CUDA cores
// (scan_bwd.cuh), two row passes at c = 128.
//
// What bounds it on this card: at the zamba2-2.7b training shape a launch
// reads x, B, C, dy in bf16 (0.17 GB with the log decay) and writes their
// gradients (0.17 GB), and its workspace is written and read once (0.08
// GB): 0.13 ms at 3.35 TB/s. Its products are about (3 c c (P + N) / 2 +
// 6 c P N) flop pairs a chunk, 2.6e10 flop in all, 0.38 ms at 67 TFLOP/s:
// so operations. The design is latency-bound first: 160 blocks (more than
// one wave of 132 SMs at one block an SM), 32 chunks each in order.
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
using scan_bwd::row_sum16;
using scan_bwd::zero;

constexpr int MAXPN = 64;   // P and N limits (ops.py's MAX_PN)
constexpr int MAXC = 128;   // chunk limit (ops.py's MAX_CHUNK)
constexpr int LD = MAXPN + 1;

// the rows of every chunk tile: 64, or 128 for longer chunks, so that a
// pass over 64 rows of patches never reads past its tile
__host__ __device__ inline int tile_rows(int c) { return c <= 64 ? 64 : MAXC; }

// shared floats for a chunk of c rows
__host__ __device__ inline int smem_floats(int c) {
  const int R = tile_rows(c);
  return 4 * R * LD + MAXPN * LD + R * (R + 1) + 7 * R + NT;
}

__device__ __forceinline__ int tri(int q, int s) { return q * (q + 1) / 2 + s; }

template <bool ROUND>
__device__ __forceinline__ float rnd(float v) {
  return ROUND ? bf16_round(v) : v;
}

template <typename T, bool RND>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ a, const T* __restrict__ dy, const float* __restrict__ dstate,
    T* __restrict__ dx, T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ da,
    float* __restrict__ ws, int S, int H, int P, int N, int c, int ldx, int ldb, int ldc) {
  extern __shared__ float sm[];
  const int c4 = (c + 3) & ~3, R = tile_rows(c);
  float* sX = sm;                  // x (c, P)
  float* sB = sX + R * LD;         // B (c, N)
  float* sC = sB + R * LD;         // C (c, N)
  float* sY = sC + R * LD;         // dy (c, P)
  float* sH = sY + R * LD;         // dh (P, N)
  float* T1 = sH + MAXPN * LD;     // SC, then rs (packed lower triangle)
  float* T2 = T1 + R * (R + 1) / 2;     // gs, then gSC
  float* vCs = T2 + R * (R + 1) / 2;    // cs
  float* vE = vCs + R;             // e^cs
  float* vW = vE + R;              // e^(total - cs)
  float* vRow = vW + R;            // row sums of gs SC L
  float* vCol = vRow + R;          // column sums of gs SC L
  float* vEx1 = vCol + R;          // rowsum(g h0 . C) e^cs
  float* vEx2 = vEx1 + R;          // rowsum(x dh . B)
  float* vPart = vEx2 + R;         // per-thread parts of sum(dh h0)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;       // (batch, head)
  const int bt = bh / H, h = bh % H;
  const int nc = S / c;
  const int64_t PN = (int64_t)P * N;
  float* wsb = ws + (int64_t)bh * nc * PN;
  const int i0 = 4 * (tid >> 4), j0 = 4 * (tid & 15);
  const int64_t ldy = (int64_t)H * P, ldg = (int64_t)H * N;

  auto load = [&](float* dst, const T* src, int64_t ld, int W, int t0) {
    for (int e = tid; e < c * W; e += NT) {
      const int t = e / W, j = e - t * W;
      dst[t * LD + j] = to_f(src[((int64_t)bt * S + t0 + t) * ld + (int64_t)h * W + j]);
    }
  };
  // cs, e^cs and e^(total - cs) of the chunk at t0, one running sum in row
  // order (K8's); returns total on thread 0
  auto decays = [&](int t0) {
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += a[((int64_t)bt * S + t0 + t) * H + h];
        vCs[t] = acc;
      }
    }
    __syncthreads();
    const float total = vCs[c - 1];
    for (int t = tid; t < c; t += NT) {
      vE[t] = expf(vCs[t]);
      vW[t] = expf(total - vCs[t]);
    }
  };

  // 1. the forward walk: each chunk's starting state into the workspace
  float st[4][4];
  zero(st);
  for (int jc = 0; jc < nc; ++jc) {
    const int t0 = jc * c;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (i0 + u < P && j0 + v < N) wsb[jc * PN + (i0 + u) * N + j0 + v] = st[u][v];
    load(sX, x, ldx, P, t0);
    load(sB, Bm, ldb, N, t0);
    decays(t0);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    patch(acc, i0, j0, 0, c, [&](int p, int s) { return sX[s * LD + p]; },
          [&](int s, int n) { return sB[s * LD + n] * vW[s]; });
    const float dec = expf(vCs[c - 1]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) st[u][v] = dec * st[u][v] + acc[u][v];
    __syncthreads();
  }

  // 2. the backward walk
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (i0 + u < P && j0 + v < N)
        sH[(i0 + u) * LD + j0 + v] =
            dstate ? dstate[(int64_t)bh * PN + (i0 + u) * N + j0 + v] : 0.f;
  const int nb = c4 / 4;
  for (int jc = nc - 1; jc >= 0; --jc) {
    const int t0 = jc * c;
    const float* h0 = wsb + jc * PN;
    load(sX, x, ldx, P, t0);
    load(sB, Bm, ldb, N, t0);
    load(sC, Cm, ldc, N, t0);
    load(sY, dy, ldy, P, t0);
    decays(t0);
    __syncthreads();
    // SC = rnd(C B^T) and gs = rnd(dy x^T) on the lower triangle
    for (int pi = tid; pi < nb * nb; pi += NT) {
      const int qb = 4 * (pi / nb), sb = 4 * (pi % nb);
      if (sb > qb) continue;
      float a1[4][4], a2[4][4];
      zero(a1);
      zero(a2);
      patch(a1, qb, sb, 0, N, [&](int q, int n) { return sC[q * LD + n]; },
            [&](int n, int s) { return sB[s * LD + n]; });
      patch(a2, qb, sb, 0, P, [&](int q, int p) { return sY[q * LD + p]; },
            [&](int p, int s) { return sX[s * LD + p]; });
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int q = qb + u, s = sb + v;
          if (s <= q && q < c) {
            T1[tri(q, s)] = rnd<RND>(a1[u][v]);
            T2[tri(q, s)] = rnd<RND>(a2[u][v]);
          }
        }
    }
    __syncthreads();
    // the row and column sums of gs SC L (the gradient of cs_q - cs_s)
    if (tid < c) {
      const int q = tid;
      float acc = 0.f;
      for (int s = 0; s <= q; ++s) acc += T2[tri(q, s)] * T1[tri(q, s)] * expf(vCs[q] - vCs[s]);
      vRow[q] = acc;
    } else if (tid >= MAXC && tid - MAXC < c) {
      const int s = tid - MAXC;
      float acc = 0.f;
      for (int q = s; q < c; ++q) acc += T2[tri(q, s)] * T1[tri(q, s)] * expf(vCs[q] - vCs[s]);
      vCol[s] = acc;
    }
    __syncthreads();
    // rs = rnd(SC L), gSC = rnd(gs L)
    for (int e = tid; e < c * c; e += NT) {
      const int q = e / c, s = e - q * c;
      if (s > q) continue;
      const float L = expf(vCs[q] - vCs[s]);
      const int at = tri(q, s);
      T1[at] = rnd<RND>(T1[at] * L);
      T2[at] = rnd<RND>(T2[at] * L);
    }
    __syncthreads();
    auto lower = [&](const float* Tm) {   // Tm[q][s], 0 above the diagonal
      return [=](int q, int s) { return s <= q ? Tm[tri(q, s)] : 0.f; };
    };
    auto upper = [&](const float* Tm) {   // Tm[q][s] read as [s][q]
      return [=](int s, int q) { return s <= q ? Tm[tri(q, s)] : 0.f; };
    };
    for (int rb = 0; rb < c4; rb += 64) {
      const int r0 = rb + i0;
      // dC = gSC B + (g h0) e^cs
      {
        float a1[4][4], a2[4][4];
        zero(a1);
        zero(a2);
        patch(a1, r0, j0, 0, min(c, r0 + 4), lower(T2),
              [&](int s, int n) { return sB[s * LD + n]; });
        patch(a2, r0, j0, 0, P, [&](int q, int p) { return sY[q * LD + p]; },
              [&](int p, int n) { return n < N ? h0[p * N + n] : 0.f; });
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = r0 + u;
          const float e = q < c ? vE[q] : 0.f;
          float ex = 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int n = j0 + v;
            if (n < N) {
              ex += a2[u][v] * sC[q * LD + n];
              if (q < c) dC[((int64_t)bt * S + t0 + q) * ldg + (int64_t)h * N + n] =
                  from_f<T>(a1[u][v] + a2[u][v] * e);
            }
          }
          ex = row_sum16(ex);
          if ((tid & 15) == 0 && q < c) vEx1[q] = ex * e;
        }
      }
      // dB = gSC^T C + (x dh) e^(total - cs)
      {
        float a1[4][4], a2[4][4];
        zero(a1);
        zero(a2);
        patch(a1, r0, j0, r0, c, upper(T2), [&](int q, int n) { return sC[q * LD + n]; });
        patch(a2, r0, j0, 0, P, [&](int s, int p) { return sX[s * LD + p]; },
              [&](int p, int n) { return sH[p * LD + n]; });
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = r0 + u;
          const float wg = s < c ? vW[s] : 0.f;
          float ex = 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int n = j0 + v;
            if (n < N) {
              ex += a2[u][v] * sB[s * LD + n];
              if (s < c) dB[((int64_t)bt * S + t0 + s) * ldg + (int64_t)h * N + n] =
                  from_f<T>(a1[u][v] + a2[u][v] * wg);
            }
          }
          ex = row_sum16(ex);
          if ((tid & 15) == 0 && s < c) vEx2[s] = ex;
        }
      }
      // dx = rs^T g + (B e^(total - cs)) dh^T
      {
        float a1[4][4], a2[4][4];
        zero(a1);
        zero(a2);
        patch(a1, r0, j0, r0, c, upper(T1), [&](int q, int p) { return sY[q * LD + p]; });
        patch(a2, r0, j0, 0, N, [&](int s, int n) { return sB[s * LD + n] * vW[s]; },
              [&](int n, int p) { return sH[p * LD + n]; });
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int s = r0 + u, p = j0 + v;
            if (s < c && p < P)
              dx[((int64_t)bt * S + t0 + s) * ldy + (int64_t)h * P + p] =
                  from_f<T>(a1[u][v] + a2[u][v]);
          }
      }
    }
    // dh0 = e^total dh + g^T (C e^cs), and the parts of sum(dh h0)
    float gh[4][4];
    zero(gh);
    patch(gh, i0, j0, 0, c, [&](int p, int q) { return sY[q * LD + p]; },
          [&](int q, int n) { return sC[q * LD + n] * vE[q]; });
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (i0 + u < P && j0 + v < N)
          part = fmaf(sH[(i0 + u) * LD + j0 + v], h0[(i0 + u) * N + j0 + v], part);
    vPart[tid] = part;
    __syncthreads();
    const float etot = expf(vCs[c - 1]);
    if (tid == 0) {
      float hh = 0.f, w2 = 0.f;
      for (int t = 0; t < NT; ++t) hh += vPart[t];
      for (int s = 0; s < c; ++s) w2 += vEx2[s] * vW[s];
      float acc = etot * hh + w2;   // the gradient of total, at the last row
      for (int t = c - 1; t >= 0; --t) {
        acc += vRow[t] - vCol[t] + vEx1[t] - vEx2[t] * vW[t];
        da[((int64_t)bt * S + t0 + t) * H + h] = acc;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (i0 + u < P && j0 + v < N) {
          float* hp = &sH[(i0 + u) * LD + j0 + v];
          *hp = etot * *hp + gh[u][v];
        }
    __syncthreads();
  }
}

template <typename T, bool RND>
int entry(const void* x, const void* Bm, const void* Cm, const void* a, const void* dy,
          const void* dstate, void* dx, void* dB, void* dC, void* da, void* ws, int Bt, int S,
          int H, int P, int N, int c, int ldx, int ldb, int ldc, void* stream) {
  if (P <= 0 || P > MAXPN || N <= 0 || N > MAXPN || c <= 0 || c > MAXC || (S > 0 && S % c)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Bt <= 0 || H <= 0 || S == 0) return 0;
  const size_t smem = (size_t)smem_floats(c) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<T, RND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<T, RND><<<Bt * H, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (const T*)dy,
      (const float*)dstate, (T*)dx, (T*)dB, (T*)dC, (float*)da, (float*)ws, S, H, P, N, c, ldx,
      ldb, ldc);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_BWD_ENTRY(SUFFIX, T, RND)                                                         \
  extern "C" int mamba2_ssd_bwd_##SUFFIX(                                                     \
      const void* x, const void* Bm, const void* Cm, const void* a, const void* dy,          \
      const void* dstate, void* dx, void* dB, void* dC, void* da, void* ws, int Bt, int S,   \
      int H, int P, int N, int c, int ldx, int ldb, int ldc, void* stream) {                 \
    return entry<T, RND>(x, Bm, Cm, a, dy, dstate, dx, dB, dC, da, ws, Bt, S, H, P, N, c,    \
                         ldx, ldb, ldc, stream);                                              \
  }

// the model's roundings are the identity in float32, so f32_model is f32_f32
SSD_BWD_ENTRY(f32_f32, float, false)
SSD_BWD_ENTRY(f32_model, float, false)
SSD_BWD_ENTRY(bf16_f32, __nv_bfloat16, false)
SSD_BWD_ENTRY(bf16_model, __nv_bfloat16, true)
