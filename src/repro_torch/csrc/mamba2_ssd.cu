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
// beside it. MODEL = false is the Pallas kernel's function (every product
// in float32, y rounded once); MODEL = true is the reference model's
// _ssd_chunked (models/mamba2.py), which rounds C . B^T to x's dtype before
// the mask, the masked scores to x's dtype before the intra-chunk product,
// that product and the state's part each to x's dtype, and sums the two in
// x's dtype (no-ops in float32). Only the lower triangle of exp(cs_q -
// cs_s) is evaluated: an upper entry's exponent can overflow, and the
// reference's where() drops it.
//
// What bounds it on this card: at the zamba2-2.7b prefill (2 x 4096 tokens,
// 80 heads of P = N = 64, c = 128) a launch reads x, B and C in bf16 and a
// in float32 and writes y: about 0.34 GB, 0.10 ms at 3.35 TB/s. Its
// products are about 1.07e10 float32 flop (the state's part and the state
// update) and 1.08e10 on bf16 operands (the two triangular intra-chunk
// products): 0.17 ms at 67 and 989 TFLOP/s. So operations.
//
// Two routes; kernels/mamba2_ssd/ops.py picks one by shape (ssd_route):
//
// serial (the first design; chunks whose length is not a multiple of 16):
// - one 256-thread block per (b, h); the chunks are a loop inside it, as
//   the Pallas grid's fori_loop is. At zamba2 that is 160 blocks of 183 KB
//   of shared memory, one an SM in two waves, and shared-memory bandwidth
//   bounds each block;
// - a chunk's x, B and C, the (c, c) masked scores and the state live in
//   dynamic shared memory as float32, rows padded to 65 (and 129) floats so
//   that column walks hit distinct banks; rows past c and columns past P, N
//   stay zero;
// - thread (ty = tid / 16, tx = tid % 16) computes rows ty + 16 i of each
//   product against columns tx + 16 j: an 8 x 8 patch of the scores, an
//   8 x 4 patch of y (kept as the two parts the model rounds apart) and a
//   4 x 4 patch of the state, which it keeps in registers and copies to
//   shared memory after each update for the next chunk's state part;
// - the cumsum is one warp's scan, four rows a lane.
//
// chunked (c a multiple of 16): the chunk scan of Mamba2's own kernels
// (Dao & Gu, arXiv:2405.21060, section 7) in three launches, so the grid is
// (b, h, chunk): 5120 blocks at zamba2 instead of 160.
// 1. ssd_states_kernel, a block a chunk: the same warp scan of a, then
//    inc = x^T . (B * exp(total - cs)) as the serial kernel sums it (fmaf
//    over the chunk's rows in order, float32 on the CUDA cores; one exp a
//    row), each thread a 4 x 4 patch read as float4, and exp(total); inc
//    goes to a float32 workspace (Bt, H, nc, P, N), 84 MB at zamba2.
// 2. chunk_scan::state_pass_kernel, a thread per (b, h, p, n): h =
//    exp(total) * h + inc over the chunks, the serial kernel's multiply and
//    add, each chunk's slot overwritten with its starting state. So the
//    final state is the serial route's bit for bit.
// 3. a block a chunk (and a share of P's columns where the grid is short,
//    psplit), y from the chunk's starting state:
//    - ssd_out_mma_kernel (bf16 x, the model's function): the scores C .
//      B^T and the intra-chunk product s . x on the tensor cores (mma.sync
//      m16n8k16, bf16 operands, float32 sums). Each of four warps takes two
//      tiles of 16 rows, w and 7 - w, so that all have as many key tiles up
//      to the diagonal, and only those; a tile's masked, rounded scores stay
//      in registers as the A fragments of s . x. The state's part (C *
//      exp(cs)) . h^T is float32 fmaf in the same fragment layout for the
//      four rows of a thread's two tiles at once, h read as float4, in the
//      serial kernel's order;
//    - ssd_out_simt_kernel (float32 products: model = false, or float32
//      x): the serial kernel's chunk body for one chunk, on CUDA cores.
//    Chunk tiles come in as cp.async copies of 16 bytes (tensor-core form)
//    or 16-byte loads, several in flight a thread, where the rows allow.
//
// Products are written as fmaf (the port builds with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_scan.cuh"

namespace {

using chunk_scan::from_f;
using chunk_scan::to_f;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;
constexpr int CMAX = 128;       // chunk rows (ops.py's MAX_CHUNK)
constexpr int WMAX = 64;        // P and N (ops.py's MAX_PN)
constexpr int LD = WMAX + 1;    // padded row of the serial x, B, C and state tiles
constexpr int LS = CMAX + 1;    // padded row of the serial score tile

// a rounding to x's dtype that only the model's function makes
template <typename T, bool MODEL>
__device__ __forceinline__ float mrnd(float v) {
  return MODEL ? to_f(from_f<T>(v)) : v;
}

constexpr int SMEM_FLOATS = 3 * CMAX * LD + CMAX * LS + WMAX * LD + CMAX;  // 183,040 bytes

// cs = the inclusive cumsum of a's rows t0 .. t0 + c - 1 (stride H from
// ab), by warp 0, four rows a lane: the order every route shares
__device__ __forceinline__ void scan_a(const float* __restrict__ a, int64_t ab, int H, int t0,
                                       int c, float* sCs, int tid) {
  if (tid >= 32) return;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * tid + r;
    run += t < c ? a[ab + (int64_t)(t0 + t) * H] : 0.f;
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

// the serial body's scores: rows q = ty + 16 i, keys k = tx + 16 j, the
// lower triangle masked, into sS
template <typename T, bool MODEL>
__device__ __forceinline__ void chunk_scores(const float* sB, const float* sC, const float* sCs,
                                             float* sS, int N, int c, int ty, int tx) {
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

// the serial body's y = s . x + (C * exp(cs)) . h^T: rows q = ty + 16 i,
// columns p = tx + 16 j, written to y's rows from yrow (stride YS)
template <typename T, bool MODEL>
__device__ __forceinline__ void chunk_y(const float* sX, const float* sC, const float* sS,
                                        const float* sH, const float* sCs, T* __restrict__ yrow,
                                        int64_t YS, int P, int N, int c, int ty, int tx) {
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
      yrow[(int64_t)q * YS + p] = from_f<T>(v);
    }
  }
}

// the serial body's chunk load: x, B and C as float32 into the padded tiles
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, const T* __restrict__ Bm,
                                           const T* __restrict__ Cm, int64_t xb, int64_t bb,
                                           int64_t cb, int t0, int c, int P, int N, int ldx,
                                           int ldb, int ldc, float* sX, float* sB, float* sC,
                                           int tid) {
  for (int e = tid; e < c * P; e += NT) {
    const int t = e / P, j = e % P;
    sX[t * LD + j] = to_f(x[xb + (int64_t)(t0 + t) * ldx + j]);
  }
  for (int e = tid; e < c * N; e += NT) {
    const int t = e / N, j = e % N;
    sB[t * LD + j] = to_f(Bm[bb + (int64_t)(t0 + t) * ldb + j]);
    sC[t * LD + j] = to_f(Cm[cb + (int64_t)(t0 + t) * ldc + j]);
  }
}

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
    load_chunk(x, Bm, Cm, xb, bb, cb, t0, c, P, N, ldx, ldb, ldc, sX, sB, sC, tid);
    scan_a(a, ab, H, t0, c, sCs, tid);
    __syncthreads();
    chunk_scores<T, MODEL>(sB, sC, sCs, sS, N, c, ty, tx);
    __syncthreads();
    chunk_y<T, MODEL>(sX, sC, sS, sH, sCs, y + yb + (int64_t)t0 * YS, YS, P, N, c, ty, tx);
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

// ------------------------------------------------------------ chunked route

// step 1: inc = x^T . (B * exp(total - cs)) of chunk blockIdx.x of (b =
// blockIdx.z, h = blockIdx.y) into ws (Bt, H, nc, P, N), exp(total) into
// decay (Bt, H, nc); the serial kernel's arithmetic, element for element
template <typename T>
__global__ void __launch_bounds__(NT) ssd_states_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const float* __restrict__ a,
    float* __restrict__ ws, float* __restrict__ decay, int S, int H, int P, int N, int c,
    int ldx, int ldb, int vec) {
  extern __shared__ __align__(16) float sm1[];
  float* sX = sm1;                 // x (c, WMAX); columns past P, N are never written
  float* sB = sX + c * WMAX;       // B, then B * exp(total - cs)
  float* sCs = sB + c * WMAX;      // cs (c)
  float* sE = sCs + c;             // exp(total - cs) (c)
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = j * c;
  chunk_scan::load_tile(sX, WMAX, x + ((int64_t)b * S + t0) * ldx + (int64_t)h * P, ldx, c, P,
                        vec, tid, NT);
  chunk_scan::load_tile(sB, WMAX, Bm + ((int64_t)b * S + t0) * ldb + (int64_t)h * N, ldb, c, N,
                        vec, tid, NT);
  scan_a(a, (int64_t)b * S * H + h, H, t0, c, sCs, tid);
  __syncthreads();
  const float total = sCs[c - 1];
  // one exp a row: the serial kernel's expf(total - cs) for every element
  // of the row is this value
  for (int t = tid; t < c; t += NT) sE[t] = expf(total - sCs[t]);
  __syncthreads();
  for (int e = tid; e < c * N; e += NT) {
    const int t = e / N, n = e % N;
    sB[t * WMAX + n] = sB[t * WMAX + n] * sE[t];
  }
  __syncthreads();
  // (outputs past P or N read columns never written and are not stored)
  const int p0 = 4 * (tid >> 4), n0 = 4 * (tid & 15);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
  for (int k = 0; k < c; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(&sX[k * WMAX + p0]);
    const float4 bv = *reinterpret_cast<const float4*>(&sB[k * WMAX + n0]);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w}, ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(xa[i], ba[jj], acc[i][jj]);
  }
  const int64_t bhj = ((int64_t)b * H + h) * nc + j;
  float* out = ws + bhj * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (p0 + i < P && n0 + jj < N) out[(p0 + i) * N + n0 + jj] = acc[i][jj];
  if (tid == 0) decay[bhj] = expf(total);
}

// step 3 on CUDA cores (float32 products): the serial body for one chunk
// from its starting state in ws
template <typename T, bool MODEL>
__global__ void __launch_bounds__(NT) ssd_out_simt_kernel(
    const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ a, const float* __restrict__ ws, T* __restrict__ y, int S, int H,
    int P, int N, int c, int ldx, int ldb, int ldc, int vec) {
  extern __shared__ float smem[];
  float* sX = smem;
  float* sB = sX + CMAX * LD;
  float* sC = sB + CMAX * LD;
  float* sS = sC + CMAX * LD;
  float* sH = sS + CMAX * LS;
  float* sCs = sH + WMAX * LD;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = j * c;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t YS = (int64_t)H * P;
  for (int e = tid; e < SMEM_FLOATS; e += NT) smem[e] = 0.f;
  __syncthreads();
  using chunk_scan::load_tile;
  load_tile(sX, LD, x + ((int64_t)b * S + t0) * ldx + (int64_t)h * P, ldx, c, P, vec, tid, NT);
  load_tile(sB, LD, Bm + ((int64_t)b * S + t0) * ldb + (int64_t)h * N, ldb, c, N, vec, tid, NT);
  load_tile(sC, LD, Cm + ((int64_t)b * S + t0) * ldc + (int64_t)h * N, ldc, c, N, vec, tid, NT);
  load_tile(sH, LD, ws + (((int64_t)b * H + h) * nc + j) * P * N, N, P, N, (N & 3) == 0, tid,
            NT);
  scan_a(a, (int64_t)b * S * H + h, H, t0, c, sCs, tid);
  __syncthreads();
  chunk_scores<T, MODEL>(sB, sC, sCs, sS, N, c, ty, tx);
  __syncthreads();
  chunk_y<T, MODEL>(sX, sC, sS, sH, sCs, y + ((int64_t)b * S + t0) * YS + (int64_t)h * P, YS, P,
                    N, c, ty, tx);
}

constexpr int LDH = WMAX + 8;   // bf16 tile row: 144 bytes, 16-byte aligned, conflict-free
constexpr int LDF = WMAX + 4;   // float state row: 272 bytes, float4 reads conflict-free
constexpr int NT3 = 128;        // step 3's tensor-core form: four warps
constexpr int MMA_SMEM = 3 * CMAX * LDH * 2 + (WMAX * LDF + CMAX) * 4;  // 73,216 bytes

// the intra-chunk part of y for the row tile rt (rows 16 rt .. 16 rt + 15)
// of the chunk in shared memory and P's column tiles pt0 .. pt0 + npt - 1
// on the tensor cores: the scores C . B^T against the key tiles up to the
// diagonal, masked and rounded as the model does, then s . x; returned
// rounded to bf16, as the D fragments' pairs
__device__ __forceinline__ void ssd_intra(const bf16* sC, const bf16* sB, const bf16* sX,
                                          const float* sCs, int N, int rt, int pt0, int npt,
                                          int lane, uint32_t (&yp)[8][2]) {
  using namespace chunk_scan;
  const int g = lane >> 2, t = lane & 3;
  const int N16 = (N + 15) & ~15;
  const int q0 = 16 * rt, r0 = q0 + g, r1 = r0 + 8;
  float sc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
  for (int ks = 0; ks < N16; ks += 16) {
    uint32_t af[4];
    af[0] = ld_pair(&sC[r0 * LDH + ks + 2 * t]);
    af[1] = ld_pair(&sC[r1 * LDH + ks + 2 * t]);
    af[2] = ld_pair(&sC[r0 * LDH + ks + 2 * t + 8]);
    af[3] = ld_pair(&sC[r1 * LDH + ks + 2 * t + 8]);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt <= 2 * rt + 1) {
        uint32_t bfr[2];
        bfr[0] = ld_pair(&sB[(nt * 8 + g) * LDH + ks + 2 * t]);
        bfr[1] = ld_pair(&sB[(nt * 8 + g) * LDH + ks + 2 * t + 8]);
        mma_bf16(sc[nt], af, bfr);
      }
    }
  }
  // mask and round as the model does, then pack as s . x's A fragments
  const float csr[2] = {sCs[r0], sCs[r1]};
  uint32_t sf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk <= rt) {
      float v[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = (e >> 1) ? r1 : r0;
          const int k = nt * 8 + 2 * t + (e & 1);
          float s = 0.f;
          if (k <= q) s = bf16_round(bf16_round(sc[nt][e]) * expf(csr[e >> 1] - sCs[k]));
          v[half][e] = s;
        }
      }
      sf[kk][0] = pack_bf16(v[0][0], v[0][1]);
      sf[kk][1] = pack_bf16(v[0][2], v[0][3]);
      sf[kk][2] = pack_bf16(v[1][0], v[1][1]);
      sf[kk][3] = pack_bf16(v[1][2], v[1][3]);
    }
  }
  float yi[8][4];
#pragma unroll
  for (int pt = 0; pt < 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[pt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk <= rt) {
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        if (pt < npt) {
          const int col = (pt0 + pt) * 8 + g;
          uint32_t bfr[2];
          bfr[0] = ld_col_pair(&sX[(16 * kk + 2 * t) * LDH + col], LDH);
          bfr[1] = ld_col_pair(&sX[(16 * kk + 2 * t + 8) * LDH + col], LDH);
          mma_bf16(yi[pt], sf[kk], bfr);
        }
      }
    }
  }
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    yp[pt][0] = pack_bf16(yi[pt][0], yi[pt][1]);
    yp[pt][1] = pack_bf16(yi[pt][2], yi[pt][3]);
  }
}

// step 3 on the tensor cores: a block a chunk (and a share of P's columns).
// Warp w takes the row tiles w and 7 - w, so that every warp has as many
// key tiles below the diagonal (18 at c = 128): first their intra-chunk
// parts, kept rounded in registers, then their state parts (C * exp(cs)) .
// h^T together, four rows a thread, so that each float4 of h read from
// shared memory feeds sixteen fmaf (over n in the serial kernel's order),
// then y = the two rounded parts summed and rounded, as bf16 pairs where P
// is even (every pair then 4-byte aligned).
__global__ void __launch_bounds__(NT3) ssd_out_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ a, const float* __restrict__ ws, bf16* __restrict__ y, int S, int H,
    int P, int N, int c, int ldx, int ldb, int ldc, int psplit, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) unsigned char sm3[];
  bf16* sC = reinterpret_cast<bf16*>(sm3);          // C (CMAX, LDH)
  bf16* sB = sC + CMAX * LDH;                       // B
  bf16* sX = sB + CMAX * LDH;                       // x
  float* sH = reinterpret_cast<float*>(sX + CMAX * LDH);  // starting state h[p][n] (WMAX, LDF)
  float* sCs = sH + WMAX * LDF;                     // cs (CMAX)
  const int j = blockIdx.x / psplit, ps = blockIdx.x % psplit;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / psplit;
  const int tid = threadIdx.x, t0 = j * c;
  const int N16 = (N + 15) & ~15, N4 = (N + 3) & ~3;

  // zero the pads the products read: C and B columns [N, N16), h's [N, N4)
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < c * (N16 - N); e += NT3) {
    const int r = e / (N16 - N), col = N + e % (N16 - N);
    sC[r * LDH + col] = zero;
    sB[r * LDH + col] = zero;
  }
  for (int e = tid; e < P * (N4 - N); e += NT3) {
    sH[(e / (N4 - N)) * LDF + N + e % (N4 - N)] = 0.f;
  }
  copy_tile(sC, LDH, Cm + ((int64_t)b * S + t0) * ldc + (int64_t)h * N, ldc, c, N, vec,
            tid, NT3);
  copy_tile(sB, LDH, Bm + ((int64_t)b * S + t0) * ldb + (int64_t)h * N, ldb, c, N, vec,
            tid, NT3);
  copy_tile(sX, LDH, x + ((int64_t)b * S + t0) * ldx + (int64_t)h * P, ldx, c, P, vec,
            tid, NT3);
  copy_tile(sH, LDF, ws + (((int64_t)b * H + h) * nc + j) * P * N, N, P, N, (N & 3) == 0, tid,
            NT3);
  scan_a(a, (int64_t)b * S * H + h, H, t0, c, sCs, tid);
  cp_async_wait_all();
  __syncthreads();

  // this block's column tiles of P; this warp's two row tiles (a tile past
  // c computes on rows never loaded and stores nothing)
  const int PT = (P + 7) >> 3, tps = (PT + psplit - 1) / psplit;
  const int pt0 = ps * tps, npt = min(PT, pt0 + tps) - pt0;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rts[2] = {warp, CMAX / 16 - 1 - warp};
  uint32_t yp[2][8][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (16 * rts[pass] < c) ssd_intra(sC, sB, sX, sCs, N, rts[pass], pt0, npt, lane, yp[pass]);
  }
  // the state parts of the four rows 16 rt + g (+ 8) of both tiles
  int rows[4];
  float e[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rows[r] = 16 * rts[r >> 1] + g + 8 * (r & 1);
    e[r] = expf(sCs[rows[r]]);
  }
  float ys[2][8][4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int pt = 0; pt < 8; ++pt)
#pragma unroll
      for (int q = 0; q < 4; ++q) ys[pass][pt][q] = 0.f;
  for (int n = 0; n < N4; n += 4) {
    float cd[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 u = *reinterpret_cast<const uint2*>(&sC[rows[r] * LDH + n]);
      const bf16* cb = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) cd[r][i] = __bfloat162float(cb[i]) * e[r];
    }
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      if (pt < npt) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int p = (pt0 + pt) * 8 + 2 * t + qq;
          const float4 hv = *reinterpret_cast<const float4*>(&sH[p * LDF + n]);
          const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float& acc = ys[r >> 1][pt][2 * (r & 1) + qq];
              acc = fmaf(cd[r][i], ha[i], acc);
            }
          }
        }
      }
    }
  }
  const int64_t YS = (int64_t)H * P;
  bf16* yrow = y + ((int64_t)b * S + t0) * YS + (int64_t)h * P;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (16 * rts[pass] >= c) continue;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      if (pt < npt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 16 * rts[pass] + g + 8 * half;
          const int p = (pt0 + pt) * 8 + 2 * t;
          const uint32_t yi = yp[pass][pt][half];
          const float v0 = __uint_as_float(yi << 16) + bf16_round(ys[pass][pt][2 * half]);
          const float v1 =
              __uint_as_float(yi & 0xffff0000u) + bf16_round(ys[pass][pt][2 * half + 1]);
          bf16* out = yrow + (int64_t)q * YS + p;
          if ((P & 1) == 0 && p + 1 < P) {
            *reinterpret_cast<uint32_t*>(out) = pack_bf16(v0, v1);
          } else {
            if (p < P) out[0] = __float2bfloat16_rn(v0);
            if (p + 1 < P) out[1] = __float2bfloat16_rn(v1);
          }
        }
      }
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

// the chunked route's three launches: the increments, the state pass, the
// outputs
template <typename T, bool MODEL>
int entry_chunked(const void* x, const void* Bm, const void* Cm, const void* a, void* y,
                  void* hout, void* ws, void* decay, int Bt, int S, int H, int P, int N, int c,
                  int ldx, int ldb, int ldc, int psplit, int vec, void* stream) {
  if (P <= 0 || P > WMAX || N <= 0 || N > WMAX || (P * N) % 4 || c <= 0 || c > CMAX || c % 16 ||
      S <= 0 || S % c || psplit <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (Bt <= 0 || H <= 0) return 0;
  const int nc = S / c;
  if (H > 65535 || Bt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  // 1: every chunk's increment and decay
  const size_t states_smem = (2 * c * WMAX + 2 * c) * sizeof(float);
  err = cudaFuncSetAttribute(ssd_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)states_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_states_kernel<T><<<dim3(nc, H, Bt), NT, states_smem, st>>>(
      (const T*)x, (const T*)Bm, (const float*)a, (float*)ws, (float*)decay, S, H, P, N, c,
      ldx, ldb, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2: the state pass, each chunk's starting state over its increment
  const int rc = chunk_scan::launch_state_pass((float*)ws, (const float*)decay, (float*)hout,
                                               Bt * H, nc, P * N, P * N, st);
  if (rc != 0) return rc;
  // 3: every chunk's outputs from its starting state
  if constexpr (MODEL && sizeof(T) == 2) {
    err = cudaFuncSetAttribute(ssd_out_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    ssd_out_mma_kernel<<<dim3(nc * psplit, H, Bt), NT3, MMA_SMEM, st>>>(
        (const bf16*)x, (const bf16*)Bm, (const bf16*)Cm, (const float*)a, (const float*)ws,
        (bf16*)y, S, H, P, N, c, ldx, ldb, ldc, psplit, vec);
  } else {
    const size_t smem = SMEM_FLOATS * sizeof(float);
    err = cudaFuncSetAttribute(ssd_out_simt_kernel<T, MODEL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_out_simt_kernel<T, MODEL><<<dim3(nc, H, Bt), NT, smem, st>>>(
        (const T*)x, (const T*)Bm, (const T*)Cm, (const float*)a, (const float*)ws, (T*)y, S,
        H, P, N, c, ldx, ldb, ldc, vec);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // namespace

#define SSD_ENTRY(SUFFIX, T, MODEL)                                                           \
  extern "C" int mamba2_ssd_##SUFFIX(const void* x, const void* Bm, const void* Cm,          \
                                     const void* a, void* y, void* hout, int Bt, int S, int H, \
                                     int P, int N, int c, int ldx, int ldb, int ldc,          \
                                     void* stream) {                                          \
    return entry<T, MODEL>(x, Bm, Cm, a, y, hout, Bt, S, H, P, N, c, ldx, ldb, ldc, stream); \
  }                                                                                           \
  extern "C" int mamba2_ssd_chunked_##SUFFIX(                                                 \
      const void* x, const void* Bm, const void* Cm, const void* a, void* y, void* hout,      \
      void* ws, void* decay, int Bt, int S, int H, int P, int N, int c, int ldx, int ldb,     \
      int ldc, int psplit, int vec, void* stream) {                                           \
    return entry_chunked<T, MODEL>(x, Bm, Cm, a, y, hout, ws, decay, Bt, S, H, P, N, c, ldx, \
                                   ldb, ldc, psplit, vec, stream);                            \
  }

SSD_ENTRY(f32_f32, float, false)
SSD_ENTRY(f32_model, float, true)
SSD_ENTRY(bf16_f32, __nv_bfloat16, false)
SSD_ENTRY(bf16_model, __nv_bfloat16, true)
