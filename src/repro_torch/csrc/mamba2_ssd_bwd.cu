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
// What bounds it on this card: at the zamba2-2.7b training shape (2 x
// 4096 tokens, 80 heads of P = N = 64, c = 128) a call reads x, B, C, dy in
// bf16 (0.34 GB with the log decay) and writes their gradients (0.34 GB):
// 0.20 ms at 3.35 TB/s. Its products are about (3 c c (P + N) / 2 + 6 c P
// N) flop pairs a chunk, 2.6e10 flop in all, 0.38 ms at 67 TFLOP/s: so
// operations.
//
// Two routes; kernels/mamba2_ssd/ops.py picks one by shape (ssd_route):
//
// serial (the first design; chunks whose length is not a multiple of 16):
// one 256-thread block per (b, h) walks its chunks. It first walks them
// forward, h = e^total h + x^T (B e^(total - cs)) (K8's state update),
// writing each chunk's starting state into a float32 workspace (Bt, H, nc,
// P, N), 84 MB a layer at zamba2-2.7b; then it walks them backward carrying
// dh (P x N float32) in shared memory. x, B, C and dy are float tiles in
// shared memory (rows of 65 floats), and the two c x c matrices (SC then
// rs, gs then gSC) packed lower triangles: 215 KB at c = 128, one block an
// SM. Every product is a 4 x 4 patch a thread on the CUDA cores
// (scan_bwd.cuh), two row passes at c = 128. 160 blocks at zamba2-2.7b,
// more than one wave of 132 SMs, 32 chunks each in order: latency bounds
// it.
//
// chunked (c a multiple of 16, P N of 4): the chunk-parallel form in three
// launches, a grid of (b, h, chunk), 5120 blocks at zamba2-2.7b:
// 1. ssd_bwd_states_kernel, a block a chunk: the cumsum of a in the serial
//    order (one running sum), then both increments, x^T (B e^(total - cs))
//    (the forward's) and dy^T (C e^cs) (the backward's), as the serial
//    kernel sums them (fmaf over the chunk's rows in order), and e^total,
//    into two float32 workspaces (Bt, H, nc, P, N) and the decays (Bt, H,
//    nc).
// 2. chunk_scan::state_pass_kernel, both directions in one launch: each
//    chunk's starting state h0 and the gradient of its end state dh, the
//    serial kernel's multiply and add, so bit for bit the serial route's.
// 3. a block a chunk, every gradient of the chunk from its h0 and dh:
//    - ssd_grad_mma_kernel (bf16 activations, the model's function), 512
//      threads: the chunk's tiles come in by cp.async, h0 and dh into
//      registers, landing during the score phase. SC = C B^T and gs = dy x^T
//      on the tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums),
//      a 16 x 16 block of the lower triangle at a time, 36 blocks at c = 128
//      dealt over sixteen warps; each block's rs = rnd(SC L) and gSC = rnd(gs
//      L) go to shared memory (bf16), and the row and column sums of gs SC L
//      to per-block partials summed in a fixed order. Then each warp takes a
//      16-row tile (w % 8) and half of the columns: dC = gSC B + (dy h0)
//      e^cs, dB = gSC^T C + (x dh) e^(total - cs) and dx = rs^T dy + (B
//      dh^T) e^(total - cs), every product on the tensor cores; the state
//      products' float32 operands h0 and dh enter as hi + lo bf16 halves
//      (the split K4-K6 use: each product then carries about 16 bits of
//      each state value where a float32 product carries 24; the outputs
//      are bf16), and e^(total - cs) multiplies dx's state part after its
//      sum instead of B before it. da is the reverse cumsum inside the
//      chunk, by one warp in runs of rows. 209 KB of shared memory, one
//      block an SM.
//    - otherwise (float32 activations or every product float32): the
//      serial kernel's chunk body for this one chunk, on the CUDA cores.
//    The products reduce over P's and N's columns, so there is no split of
//    them: the grid is short only for short sequences.
//
// Products are written as fmaf (the port builds with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_scan.cuh"
#include "scan_bwd.cuh"

namespace {

using chunk_scan::bf16_round;
using chunk_scan::ld4;
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

// The serial route's kernel (CHUNKED = false): a block per (b, h), its
// chunks' starting states into ws by a forward walk, then the chunks
// backward with dh carried. With CHUNKED, the chunked route's step 3 on the
// CUDA cores: a block per (chunk = blockIdx.x, h = blockIdx.y, b =
// blockIdx.z), the same chunk body from the starting state in ws and the
// end state's gradient in dsw (both (Bt, H, nc, P, N)).
template <typename T, bool RND, bool CHUNKED>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ a, const T* __restrict__ dy, const float* __restrict__ dstate,
    T* __restrict__ dx, T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ da,
    float* __restrict__ ws, const float* __restrict__ dsw, int S, int H, int P, int N, int c,
    int ldx, int ldb, int ldc) {
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
  const int bh = CHUNKED ? blockIdx.z * H + blockIdx.y : blockIdx.x;   // (batch, head)
  const int bt = bh / H, h = bh % H;
  const int nc = S / c;
  const int jc_hi = CHUNKED ? blockIdx.x : nc - 1, jc_lo = CHUNKED ? blockIdx.x : 0;
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
  for (int jc = 0; jc < (CHUNKED ? 0 : nc); ++jc) {
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
            CHUNKED ? dsw[((int64_t)bh * nc + jc_lo) * PN + (i0 + u) * N + j0 + v]
            : dstate ? dstate[(int64_t)bh * PN + (i0 + u) * N + j0 + v] : 0.f;
  const int nb = c4 / 4;
  for (int jc = jc_hi; jc >= jc_lo; --jc) {
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
    if constexpr (!CHUNKED) {
      patch(gh, i0, j0, 0, c, [&](int p, int q) { return sY[q * LD + p]; },
            [&](int q, int n) { return sC[q * LD + n] * vE[q]; });
    }
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
    if constexpr (!CHUNKED) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (i0 + u < P && j0 + v < N) {
            float* hp = &sH[(i0 + u) * LD + j0 + v];
            *hp = etot * *hp + gh[u][v];
          }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ chunked route

using bf16 = __nv_bfloat16;

constexpr int LDW = MAXPN;       // row of step 1's tiles
constexpr int LDB = MAXPN + 8;   // bf16 chunk tile row (144 bytes)
constexpr int LDS = MAXC + 8;    // bf16 score row (272 bytes)
constexpr int NTG = 512;         // step 3's tensor-core form: sixteen warps

// the cumsum of a's rows t0 .. t0 + c - 1 of (bt, h) into vCs, one running
// sum in row order (the serial kernel's), then e^cs into vE and e^(total -
// cs) into vW; vA takes the loads. Ends with a barrier.
__device__ __forceinline__ void chunk_decays(const float* __restrict__ a, int64_t ab, int H,
                                             int c, float* vA, float* vCs, float* vE, float* vW,
                                             int tid) {
  for (int t = tid; t < c; t += NT) vA[t] = a[ab + (int64_t)t * H];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < c; ++t) {
      acc += vA[t];
      vCs[t] = acc;
    }
  }
  __syncthreads();
  const float total = vCs[c - 1];
  for (int t = tid; t < c; t += NT) {
    vE[t] = expf(vCs[t]);
    vW[t] = expf(total - vCs[t]);
  }
  __syncthreads();
}

// step 1: both increments of chunk blockIdx.x of (b = blockIdx.z, h =
// blockIdx.y), x^T (B e^(total - cs)) into wsf and dy^T (C e^cs) into wsb
// (Bt, H, nc, P, N), and e^total into decay (Bt, H, nc): the serial
// kernel's arithmetic, element for element (B e^(total - cs) and C e^cs
// are the products it takes, formed as it forms them). x, B, C and dy stay
// in their dtype in shared memory (cp.async where vec allows)
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_states_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ a, const T* __restrict__ dy, float* __restrict__ wsf,
    float* __restrict__ wsb, float* __restrict__ decay, int S, int H, int P, int N, int c,
    int ldx, int ldb, int ldc, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) unsigned char sm1[];
  float* vA = reinterpret_cast<float*>(sm1);
  float* vCs = vA + MAXC;
  float* vE = vCs + MAXC;
  float* vW = vE + MAXC;
  T* sX = reinterpret_cast<T*>(vW + MAXC);      // x (c, LDW)
  T* sY = sX + c * LDW;                         // dy
  T* sB = sY + c * LDW;                         // B
  T* sC = sB + c * LDW;                         // C
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = j * c;
  const int64_t ldy = (int64_t)H * P;
  copy_tile(sX, LDW, x + ((int64_t)b * S + t0) * ldx + (int64_t)h * P, ldx, c, P, vec, tid, NT);
  copy_tile(sY, LDW, dy + ((int64_t)b * S + t0) * ldy + (int64_t)h * P, ldy, c, P, vec, tid, NT);
  copy_tile(sB, LDW, Bm + ((int64_t)b * S + t0) * ldb + (int64_t)h * N, ldb, c, N, vec, tid, NT);
  copy_tile(sC, LDW, Cm + ((int64_t)b * S + t0) * ldc + (int64_t)h * N, ldc, c, N, vec, tid, NT);
  cp_async_wait_all();
  chunk_decays(a, ((int64_t)b * S + t0) * H + h, H, c, vA, vCs, vE, vW, tid);
  // (outputs past P or N read columns never written and are not stored)
  const int p0 = 4 * (tid >> 4), n0 = 4 * (tid & 15);
  float af[4][4], ab[4][4];
  zero(af);
  zero(ab);
#pragma unroll 2
  for (int s = 0; s < c; ++s) {
    float xa[4], ya[4], ba[4], ca[4];
    ld4(&sX[s * LDW + p0], xa);
    ld4(&sY[s * LDW + p0], ya);
    ld4(&sB[s * LDW + n0], ba);
    ld4(&sC[s * LDW + n0], ca);
    const float ws = vW[s], es = vE[s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      ba[jj] = ba[jj] * ws;
      ca[jj] = ca[jj] * es;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        af[i][jj] = fmaf(xa[i], ba[jj], af[i][jj]);
        ab[i][jj] = fmaf(ya[i], ca[jj], ab[i][jj]);
      }
  }
  const int64_t bhj = ((int64_t)b * H + h) * nc + j;
  const int64_t PN = (int64_t)P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (p0 + i < P && n0 + jj < N) {
        wsf[bhj * PN + (p0 + i) * N + n0 + jj] = af[i][jj];
        wsb[bhj * PN + (p0 + i) * N + n0 + jj] = ab[i][jj];
      }
  if (tid == 0) decay[bhj] = expf(vCs[c - 1]);
}

// step 3's shared memory on the tensor cores: x, B, C, dy as they lie (bf16
// (MAXC, LDB)); rs and gSC rounded (bf16 (MAXC, LDS) lower triangles); h0^T
// [n][p], dh^T [n][p] and dh [p][n] as hi + lo bf16 halves (MAXPN, LDB);
// vectors: a, cs, e^cs, e^(total - cs), the row and column sums of gs SC L
// and their per-block partials (by key tile, by row tile), the two column
// halves' parts of rowsum(g h0 . C) and rowsum(x dh . B), and the threads'
// parts of sum(dh h0)
struct SsdGradSmem {
  static constexpr int NB = MAXC / 16;
  static constexpr int BYTES = 4 * MAXC * LDB * 2 + 2 * MAXC * LDS * 2 + 6 * MAXPN * LDB * 2 +
                               (6 * MAXC + 2 * NB * MAXC + 4 * MAXC + NTG) * 4;
  bf16 *sX, *sB, *sC, *sY, *sRS, *sGS;
  bf16 *hH0t, *lH0t, *hDHt, *lDHt, *hDH, *lDH;
  float *vA, *vCs, *vE, *vW, *vRow, *vCol, *vRowP, *vColP, *vEx1P, *vEx2P, *vPart;
  __device__ explicit SsdGradSmem(unsigned char* p) {
    sX = reinterpret_cast<bf16*>(p);
    sB = sX + MAXC * LDB;
    sC = sB + MAXC * LDB;
    sY = sC + MAXC * LDB;
    sRS = sY + MAXC * LDB;
    sGS = sRS + MAXC * LDS;
    hH0t = sGS + MAXC * LDS;
    lH0t = hH0t + MAXPN * LDB;
    hDHt = lH0t + MAXPN * LDB;
    lDHt = hDHt + MAXPN * LDB;
    hDH = lDHt + MAXPN * LDB;
    lDH = hDH + MAXPN * LDB;
    vA = reinterpret_cast<float*>(lDH + MAXPN * LDB);
    vCs = vA + MAXC;
    vE = vCs + MAXC;
    vW = vE + MAXC;
    vRow = vW + MAXC;
    vCol = vRow + MAXC;
    vRowP = vCol + MAXC;
    vColP = vRowP + NB * MAXC;
    vEx1P = vColP + NB * MAXC;
    vEx2P = vEx1P + 2 * MAXC;
    vPart = vEx2P + 2 * MAXC;
  }
};

// v as hi + lo bf16 halves: hi = v rounded, lo = what is left, rounded
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// v0, v1 as bf16 at p[0] and p[1] where col, col + 1 < W: one 4-byte store
// where W is even (the pair then aligned), else two
__device__ __forceinline__ void store_pair(bf16* p, int col, int W, float v0, float v1) {
  if ((W & 1) == 0 && col + 1 < W) {
    *reinterpret_cast<uint32_t*>(p) = chunk_scan::pack_bf16(v0, v1);
  } else {
    if (col < W) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < W) p[1] = __float2bfloat16_rn(v1);
  }
}

// the A fragment of X^T's 16 x 16 block at rows m0 .., columns k0 .. of
// X^T (X row-major bf16, row stride ld): column pairs of X
__device__ __forceinline__ void frag_t(uint32_t (&f)[4], const bf16* X, int ld, int m0, int k0,
                                       int g, int t4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = chunk_scan::ld_col_pair(&X[(k0 + 2 * t4 + 8 * (i >> 1)) * ld + m0 + g + 8 * (i & 1)],
                                   ld);
}
// the A fragment of X's 16 x 16 block at rows m0 .., columns k0 ..
__device__ __forceinline__ void frag(uint32_t (&f)[4], const bf16* X, int ld, int m0, int k0,
                                     int g, int t4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = chunk_scan::ld_pair(&X[(m0 + g + 8 * (i & 1)) * ld + k0 + 2 * t4 + 8 * (i >> 1)]);
}
// the B fragment (16 x 8) of the rows k0 .. k0 + 15 of X at column col
__device__ __forceinline__ void frag_b(uint32_t (&f)[2], const bf16* X, int ld, int k0, int col,
                                       int t4) {
  f[0] = chunk_scan::ld_col_pair(&X[(k0 + 2 * t4) * ld + col], ld);
  f[1] = chunk_scan::ld_col_pair(&X[(k0 + 2 * t4 + 8) * ld + col], ld);
}

// step 3 on the tensor cores (bf16 activations, the model's function): every
// gradient of chunk blockIdx.x of (b = blockIdx.z, h = blockIdx.y) from its
// starting state (wsf) and its end state's gradient (wsb)
__global__ void __launch_bounds__(NTG, 1) ssd_grad_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ a, const bf16* __restrict__ dy, const float* __restrict__ wsf,
    const float* __restrict__ wsb, bf16* __restrict__ dx, bf16* __restrict__ dB,
    bf16* __restrict__ dC, float* __restrict__ da, int S, int H, int P, int N, int c, int ldx,
    int ldb, int ldc, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) unsigned char smg[];
  const SsdGradSmem m(smg);
  const int jc = blockIdx.x, h = blockIdx.y, bt = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = jc * c;
  const int64_t ldy = (int64_t)H * P, ldg = (int64_t)H * N;
  const int64_t bhj = ((int64_t)bt * H + h) * nc + jc;
  const int64_t PN = (int64_t)P * N;
  const int P16 = (P + 15) & ~15, N16 = (N + 15) & ~15;

  // zero the pads the products read: x, dy columns [P, P16), B, C [N, N16),
  // the states' halves' tiles whole; the column halves' parts
  const bf16 z = __float2bfloat16_rn(0.f);
  for (int e = tid; e < c * (P16 - P); e += NTG) {
    const int t = e / (P16 - P), col = P + e % (P16 - P);
    m.sX[t * LDB + col] = z;
    m.sY[t * LDB + col] = z;
  }
  for (int e = tid; e < c * (N16 - N); e += NTG) {
    const int t = e / (N16 - N), col = N + e % (N16 - N);
    m.sB[t * LDB + col] = z;
    m.sC[t * LDB + col] = z;
  }
  for (int e = tid; e < 6 * MAXPN * LDB / 8; e += NTG)   // the halves' tiles, pads and all
    reinterpret_cast<uint4*>(m.hH0t)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < 4 * MAXC; e += NTG) m.vEx1P[e] = 0.f;   // vEx1P and vEx2P
  // the chunk's tiles, then (a second group) its two states as they lie
  copy_tile(m.sX, LDB, x + ((int64_t)bt * S + t0) * ldx + (int64_t)h * P, ldx, c, P, vec, tid, NTG);
  copy_tile(m.sY, LDB, dy + ((int64_t)bt * S + t0) * ldy + (int64_t)h * P, ldy, c, P, vec, tid,
            NTG);
  copy_tile(m.sB, LDB, Bm + ((int64_t)bt * S + t0) * ldb + (int64_t)h * N, ldb, c, N, vec, tid,
            NTG);
  copy_tile(m.sC, LDB, Cm + ((int64_t)bt * S + t0) * ldc + (int64_t)h * N, ldc, c, N, vec, tid,
            NTG);
  // the two states into registers, to land during the score phase
  constexpr int SPT = MAXPN * MAXPN / NTG;   // state values a thread
  float h0r[SPT], dhr[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int e = tid + i * NTG;
    h0r[i] = e < P * N ? wsf[bhj * PN + e] : 0.f;
    dhr[i] = e < P * N ? wsb[bhj * PN + e] : 0.f;
  }
  cp_async_wait_all();
  chunk_decays(a, ((int64_t)bt * S + t0) * H + h, H, c, m.vA, m.vCs, m.vE, m.vW, tid);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nct = c / 16, nblk = nct * (nct + 1) / 2;
  // SC = rnd(C B^T) and gs = rnd(dy x^T), a 16 x 16 block of the lower
  // triangle at a time: rs = rnd(SC L) and gSC = rnd(gs L) into shared
  // memory, the row and column sums of gs SC L into the block's partials
  for (int blk = warp; blk < nblk; blk += NTG / 32) {
    int qt = 0;
    while ((qt + 1) * (qt + 2) / 2 <= blk) ++qt;
    const int st = blk - qt * (qt + 1) / 2;
    float sc[2][4], gv[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = gv[nt][e] = 0.f;
    for (int ks = 0; ks < N16; ks += 16) {
      uint32_t af[4];
      frag(af, m.sC, LDB, 16 * qt, ks, g, t4);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bfr[2];
        bfr[0] = ld_pair(&m.sB[(16 * st + 8 * nt + g) * LDB + ks + 2 * t4]);
        bfr[1] = ld_pair(&m.sB[(16 * st + 8 * nt + g) * LDB + ks + 2 * t4 + 8]);
        mma_bf16(sc[nt], af, bfr);
      }
    }
    for (int ks = 0; ks < P16; ks += 16) {
      uint32_t af[4];
      frag(af, m.sY, LDB, 16 * qt, ks, g, t4);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bfr[2];
        bfr[0] = ld_pair(&m.sX[(16 * st + 8 * nt + g) * LDB + ks + 2 * t4]);
        bfr[1] = ld_pair(&m.sX[(16 * st + 8 * nt + g) * LDB + ks + 2 * t4 + 8]);
        mma_bf16(gv[nt], af, bfr);
      }
    }
    float rowp[2] = {0.f, 0.f}, colp[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      colp[nt][0] = colp[nt][1] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = 16 * qt + g + 8 * hf, s = 16 * st + 8 * nt + 2 * t4;
        float rv[2], gsc[2];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          rv[o] = gsc[o] = 0.f;
          if (s + o <= q) {
            const float SC = bf16_round(sc[nt][2 * hf + o]), gs = bf16_round(gv[nt][2 * hf + o]);
            const float L = expf(m.vCs[q] - m.vCs[s + o]);
            const float pr = gs * SC * L;
            rv[o] = SC * L;
            gsc[o] = gs * L;
            rowp[hf] += pr;
            colp[nt][o] += pr;
          }
        }
        *reinterpret_cast<uint32_t*>(&m.sRS[q * LDS + s]) = pack_bf16(rv[0], rv[1]);
        *reinterpret_cast<uint32_t*>(&m.sGS[q * LDS + s]) = pack_bf16(gsc[0], gsc[1]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rowp[hf] += __shfl_xor_sync(0xffffffffu, rowp[hf], 1);
      rowp[hf] += __shfl_xor_sync(0xffffffffu, rowp[hf], 2);
      if (t4 == 0) m.vRowP[st * MAXC + 16 * qt + g + 8 * hf] = rowp[hf];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float v = colp[nt][o];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) m.vColP[qt * MAXC + 16 * st + 8 * nt + 2 * t4 + o] = v;
      }
  }
  __syncthreads();
  // the row and column sums, over the blocks in a fixed order
  if (tid < c) {
    float acc = 0.f;
    for (int st = 0; st <= tid / 16; ++st) acc += m.vRowP[st * MAXC + tid];
    m.vRow[tid] = acc;
  } else if (tid >= MAXC && tid - MAXC < c) {
    const int s = tid - MAXC;
    float acc = 0.f;
    for (int qt = s / 16; qt < nct; ++qt) acc += m.vColP[qt * MAXC + s];
    m.vCol[s] = acc;
  }

  // the states as hi + lo bf16 halves, h0^T [n][p], dh^T [n][p] and dh
  // [p][n]; the threads' parts of sum(dh h0)
  {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int e = tid + i * NTG;
      if (e < P * N) {
        const int p = e / N, n = e - p * N;
        split_bf16(h0r[i], m.hH0t[n * LDB + p], m.lH0t[n * LDB + p]);
        split_bf16(dhr[i], m.hDHt[n * LDB + p], m.lDHt[n * LDB + p]);
        split_bf16(dhr[i], m.hDH[p * LDB + n], m.lDH[p * LDB + n]);
        part = fmaf(dhr[i], h0r[i], part);
      }
    }
    m.vPart[tid] = part;
  }
  __syncthreads();

  // warp w: the row tile w % 8 and half of the columns
  const int hv = warp >> 3;
  const int NT8 = (N + 7) >> 3, hn = (NT8 + 1) >> 1, nt0 = hv * hn;
  const int nnt = min(NT8, nt0 + hn) - nt0;
  const int PT8 = (P + 7) >> 3, hp = (PT8 + 1) >> 1, pt0 = hv * hp;
  const int npt = min(PT8, pt0 + hp) - pt0;
  if ((warp & 7) < nct) {
    const int rt = warp & 7;
    const int r0 = 16 * rt + g, rows[2] = {r0, r0 + 8};
    float acc1[4][4], acc2[4][4];
    // dC = gSC B + (dy h0) e^cs
    if (nnt > 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[nt][e] = acc2[nt][e] = 0.f;
      for (int kt = 0; kt <= rt; ++kt) {
        uint32_t af[4];
        frag(af, m.sGS, LDS, 16 * rt, 16 * kt, g, t4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < nnt) {
            uint32_t bfr[2];
            frag_b(bfr, m.sB, LDB, 16 * kt, (nt0 + nt) * 8 + g, t4);
            mma_bf16(acc1[nt], af, bfr);
          }
        }
      }
      // (dy h0) on the tensor cores: h0 as hi + lo halves
      for (int ks = 0; ks < P16; ks += 16) {
        uint32_t af[4];
        frag(af, m.sY, LDB, 16 * rt, ks, g, t4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < nnt) {
            const int col = (nt0 + nt) * 8 + g;
            uint32_t bfr[2];
            bfr[0] = ld_pair(&m.lH0t[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.lH0t[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[nt], af, bfr);
            bfr[0] = ld_pair(&m.hH0t[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.hH0t[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[nt], af, bfr);
          }
        }
      }
      float ex[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= nnt) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = rows[hf], n = (nt0 + nt) * 8 + 2 * t4;
          float o[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * hf + x;
            if (n + x < N) ex[hf] += acc2[nt][e] * to_f(m.sC[q * LDB + n + x]);
            o[x] = acc1[nt][e] + acc2[nt][e] * m.vE[q];
          }
          store_pair(&dC[((int64_t)bt * S + t0 + q) * ldg + (int64_t)h * N + n], n, N, o[0], o[1]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ex[rr] += __shfl_xor_sync(0xffffffffu, ex[rr], 1);
        ex[rr] += __shfl_xor_sync(0xffffffffu, ex[rr], 2);
        if (t4 == 0) m.vEx1P[hv * MAXC + rows[rr]] = ex[rr];
      }
      // dB = gSC^T C + (x dh) e^(total - cs)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[nt][e] = acc2[nt][e] = 0.f;
      for (int kt = rt; kt < nct; ++kt) {
        uint32_t af[4];
        frag_t(af, m.sGS, LDS, 16 * rt, 16 * kt, g, t4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < nnt) {
            uint32_t bfr[2];
            frag_b(bfr, m.sC, LDB, 16 * kt, (nt0 + nt) * 8 + g, t4);
            mma_bf16(acc1[nt], af, bfr);
          }
        }
      }
      // (x dh) on the tensor cores: dh as hi + lo halves
      for (int ks = 0; ks < P16; ks += 16) {
        uint32_t af[4];
        frag(af, m.sX, LDB, 16 * rt, ks, g, t4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < nnt) {
            const int col = (nt0 + nt) * 8 + g;
            uint32_t bfr[2];
            bfr[0] = ld_pair(&m.lDHt[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.lDHt[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[nt], af, bfr);
            bfr[0] = ld_pair(&m.hDHt[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.hDHt[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[nt], af, bfr);
          }
        }
      }
      ex[0] = ex[1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= nnt) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = rows[hf], n = (nt0 + nt) * 8 + 2 * t4;
          float o[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * hf + x;
            if (n + x < N) ex[hf] += acc2[nt][e] * to_f(m.sB[s * LDB + n + x]);
            o[x] = acc1[nt][e] + acc2[nt][e] * m.vW[s];
          }
          store_pair(&dB[((int64_t)bt * S + t0 + s) * ldg + (int64_t)h * N + n], n, N, o[0], o[1]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ex[rr] += __shfl_xor_sync(0xffffffffu, ex[rr], 1);
        ex[rr] += __shfl_xor_sync(0xffffffffu, ex[rr], 2);
        if (t4 == 0) m.vEx2P[hv * MAXC + rows[rr]] = ex[rr];
      }
    }
    // dx = rs^T dy + (B e^(total - cs)) dh^T
    if (npt > 0) {
#pragma unroll
      for (int pt = 0; pt < 4; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[pt][e] = acc2[pt][e] = 0.f;
      for (int kt = rt; kt < nct; ++kt) {
        uint32_t af[4];
        frag_t(af, m.sRS, LDS, 16 * rt, 16 * kt, g, t4);
#pragma unroll
        for (int pt = 0; pt < 4; ++pt) {
          if (pt < npt) {
            uint32_t bfr[2];
            frag_b(bfr, m.sY, LDB, 16 * kt, (pt0 + pt) * 8 + g, t4);
            mma_bf16(acc1[pt], af, bfr);
          }
        }
      }
      // B dh^T on the tensor cores (dh as hi + lo halves), then times e^(total - cs)
      for (int ks = 0; ks < N16; ks += 16) {
        uint32_t af[4];
        frag(af, m.sB, LDB, 16 * rt, ks, g, t4);
#pragma unroll
        for (int pt = 0; pt < 4; ++pt) {
          if (pt < npt) {
            const int col = (pt0 + pt) * 8 + g;
            uint32_t bfr[2];
            bfr[0] = ld_pair(&m.lDH[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.lDH[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[pt], af, bfr);
            bfr[0] = ld_pair(&m.hDH[col * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&m.hDH[col * LDB + ks + 2 * t4 + 8]);
            mma_bf16(acc2[pt], af, bfr);
          }
        }
      }
      const float wr[2] = {m.vW[rows[0]], m.vW[rows[1]]};
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        if (pt >= npt) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = rows[hf], p = (pt0 + pt) * 8 + 2 * t4;
          store_pair(&dx[((int64_t)bt * S + t0 + s) * ldy + (int64_t)h * P + p], p, P,
                     acc1[pt][2 * hf] + acc2[pt][2 * hf] * wr[hf],
                     acc1[pt][2 * hf + 1] + acc2[pt][2 * hf + 1] * wr[hf]);
        }
      }
    }
  }
  __syncthreads();
  // da: the reverse cumsum of the gradient of cs, with total's at the last
  // row, by warp 0: each lane a run of rows, the runs' sums scanned across
  // the lanes, then each run walked backward; the sums over the threads'
  // parts and the rows in a fixed order
  if (warp == 0) {
    float hh = 0.f, w2 = 0.f;
    for (int t = lane; t < NTG; t += 32) hh += m.vPart[t];
    for (int s = lane; s < c; s += 32) w2 += (m.vEx2P[s] + m.vEx2P[MAXC + s]) * m.vW[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hh += __shfl_xor_sync(0xffffffffu, hh, off);
      w2 += __shfl_xor_sync(0xffffffffu, w2, off);
    }
    const int lo = (lane * c) >> 5, hi = ((lane + 1) * c) >> 5;
    auto term = [&](int t) {
      const float ex1 = (m.vEx1P[t] + m.vEx1P[MAXC + t]) * m.vE[t];
      const float ex2 = m.vEx2P[t] + m.vEx2P[MAXC + t];
      return m.vRow[t] - m.vCol[t] + ex1 - ex2 * m.vW[t];
    };
    float run = 0.f;
    for (int t = lo; t < hi; ++t) run += term(t);
    float suffix = 0.f;   // the runs of the later lanes, from the last
#pragma unroll
    for (int l = 31; l > 0; --l) {
      const float o = __shfl_sync(0xffffffffu, run, l);
      if (l > lane) suffix += o;
    }
    float acc = expf(m.vCs[c - 1]) * hh + w2 + suffix;
    for (int t = hi - 1; t >= lo; --t) {
      acc += term(t);
      da[((int64_t)bt * S + t0 + t) * H + h] = acc;
    }
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
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<T, RND, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<T, RND, false><<<Bt * H, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (const T*)dy,
      (const float*)dstate, (T*)dx, (T*)dB, (T*)dC, (float*)da, (float*)ws, nullptr, S, H, P, N,
      c, ldx, ldb, ldc);
  return (int)cudaGetLastError();
}

// the chunked route's three launches: both increments, both state passes,
// every chunk's gradients
template <typename T, bool RND>
int entry_chunked(const void* x, const void* Bm, const void* Cm, const void* a, const void* dy,
                  const void* dstate, void* dx, void* dB, void* dC, void* da, void* wsf,
                  void* wsb, void* decay, int Bt, int S, int H, int P, int N, int c, int ldx,
                  int ldb, int ldc, int vec, void* stream) {
  if (P <= 0 || P > MAXPN || N <= 0 || N > MAXPN || (P * N) % 4 || c <= 0 || c > MAXC ||
      c % 16 || S <= 0 || S % c) {
    return (int)cudaErrorInvalidValue;
  }
  if (Bt <= 0 || H <= 0) return 0;
  if (H > 65535 || Bt > 65535) return (int)cudaErrorInvalidValue;
  const int nc = S / c;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const dim3 grid(nc, H, Bt);
  // 1: every chunk's two increments and its decay
  const size_t states_smem = (size_t)c * LDW * 4 * sizeof(T) + 4 * MAXC * sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)states_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_states_kernel<T><<<grid, NT, states_smem, st>>>(
      (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (const T*)dy, (float*)wsf,
      (float*)wsb, (float*)decay, S, H, P, N, c, ldx, ldb, ldc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2: each chunk's starting state and its end state's gradient
  const int rc = chunk_scan::launch_state_passes(
      chunk_scan::StatePass{(float*)wsf, (const float*)decay, nullptr, nullptr, 0},
      chunk_scan::StatePass{(float*)wsb, (const float*)decay, (const float*)dstate, nullptr, 1},
      Bt * H, nc, P * N, P * N, st);
  if (rc != 0) return rc;
  // 3: every chunk's gradients
  if constexpr (RND && sizeof(T) == 2) {
    constexpr int smem = SsdGradSmem::BYTES;
    err = cudaFuncSetAttribute(ssd_grad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    ssd_grad_mma_kernel<<<grid, NTG, smem, st>>>(
        (const bf16*)x, (const bf16*)Bm, (const bf16*)Cm, (const float*)a, (const bf16*)dy,
        (const float*)wsf, (const float*)wsb, (bf16*)dx, (bf16*)dB, (bf16*)dC, (float*)da, S, H,
        P, N, c, ldx, ldb, ldc, vec);
  } else {
    const size_t smem = (size_t)smem_floats(c) * sizeof(float);
    err = cudaFuncSetAttribute(ssd_bwd_kernel<T, RND, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_kernel<T, RND, true><<<grid, NT, smem, st>>>(
        (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (const T*)dy, nullptr, (T*)dx,
        (T*)dB, (T*)dC, (float*)da, (float*)wsf, (const float*)wsb, S, H, P, N, c, ldx, ldb, ldc);
  }
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
  }                                                                                           \
  extern "C" int mamba2_ssd_bwd_chunked_##SUFFIX(                                             \
      const void* x, const void* Bm, const void* Cm, const void* a, const void* dy,          \
      const void* dstate, void* dx, void* dB, void* dC, void* da, void* wsf, void* wsb,      \
      void* decay, int Bt, int S, int H, int P, int N, int c, int ldx, int ldb, int ldc,     \
      int vec, void* stream) {                                                                \
    return entry_chunked<T, RND>(x, Bm, Cm, a, dy, dstate, dx, dB, dC, da, wsf, wsb, decay,  \
                                 Bt, S, H, P, N, c, ldx, ldb, ldc, vec, stream);              \
  }

// the model's roundings are the identity in float32, so f32_model is f32_f32
SSD_BWD_ENTRY(f32_f32, float, false)
SSD_BWD_ENTRY(f32_model, float, false)
SSD_BWD_ENTRY(bf16_f32, __nv_bfloat16, false)
SSD_BWD_ENTRY(bf16_model, __nv_bfloat16, true)
