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
// about 6.6e9 float32 flop (the state's part and the state update) and
// 2.1e9 on bf16 operands (the two intra-chunk products): 0.10 ms at 67
// TFLOP/s. So operations.
//
// Two routes; kernels/rwkv6_wkv/ops.py picks one by shape (wkv_route):
//
// serial (the first design; chunks whose length is not a multiple of 16):
// - one 256-thread block per (b, h); the chunks are a loop inside it, as
//   the Pallas grid's fori_loop is: 128 blocks at rwkv6-7b, less than one
//   wave of 132 SMs, so latency bounds it;
// - the (K, K) float32 state lives in registers: thread (i = tid / 4, g =
//   tid % 4) holds column i, rows g, g + 4, ..., 16 values at K = 64;
// - a chunk's r, k, v, w, cs, the two separable factors and the (c, c) att
//   tile live in shared memory as float32, rows padded to K + 1 (and c + 1)
//   floats so that column walks hit distinct banks: 133 KB at c = K = 64;
// - per chunk: load; cumsum per channel (K threads) beside the bonus per
//   row (c threads); the factors; att's strictly lower triangle; then each
//   thread reduces the state's part over its 16 rows with two shuffles
//   across the 4 threads of a column, adds the intra-chunk sum and the bonus
//   for the rows q = g mod 4 it owns, and updates its state values; y goes
//   out through shared memory in whole rows.
//
// chunked (c a multiple of 16): the chunk-parallel form in three launches,
// a grid of (b, h, chunk), 8192 blocks at rwkv6-7b instead of 128:
// 1. wkv_states_kernel, a block a chunk: the per-channel cumsum of w, then
//    inc = (k * exp(total - cs))^T . v as the serial kernel sums it (fmaf
//    over the chunk's rows in order, float32 on the CUDA cores), each
//    thread a 4 x 4 patch read as float4, and exp(total) per channel, into
//    a float32 workspace (B, H, nc, K, K), 134 MB at rwkv6-7b. The cumsum
//    keeps the serial kernel's order, one running sum per channel, not a
//    parallel scan: a scan would round cs otherwise, and the final state
//    would then not be the serial route's bit for bit. It is c adds per
//    channel from shared memory, beside which the chunk's other loads wait.
// 2. chunk_scan::state_pass_kernel, a thread per (b, h, row, column): S =
//    exp(total)[row] * S + inc over the chunks, the serial kernel's
//    multiply and add, each chunk's slot overwritten with its starting
//    state. So the final state is the serial route's bit for bit.
// 3. a block of eight warps a chunk (and a share of the value columns where
//    the grid is short, vsplit), y from the chunk's starting state: the
//    cumsum again and the bonus r . (u * k) per row beside it, the factors
//    with the midpoint shift m, then
//    - wkv_out_mma_kernel (the model's function, BF16_INTRA): att = r_f .
//      k_f^T on the strict lower triangle and att . v on the tensor cores
//      (mma.sync m16n8k16, bf16 operands rounded where the serial kernel
//      rounds them, float32 sums); each of eight warps takes two tiles of 16
//      rows, w % 2 and 3 - w % 2 (as many key tiles up to the diagonal for
//      all), and a quarter of the value columns; a tile's rounded att stays
//      in registers as the A fragments of att . v.
//      The state's part (r * exp(cs - w)) . S is float32 fmaf in the same
//      fragment layout for the four rows of a warp's two tiles at once,
//      read as float4 from S^T;
//    - wkv_out_simt_kernel (every product float32): the same on CUDA cores.
//    y = the state's part + the intra part, then + the bonus, as serial.
//
// Products are written as fmaf (the port builds with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_scan.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXK = 64;  // K and c limits (ops.py's MAX_K, MAX_CHUNK)
constexpr int ROWS_PER = MAXK / 4;  // state rows per thread

using chunk_scan::bf16_round;
using chunk_scan::from_f;
using chunk_scan::to_f;
using bf16 = __nv_bfloat16;

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

// ------------------------------------------------------------ chunked route

constexpr int LDW = MAXK;       // float row of step 1's tiles (256 bytes)
constexpr int LDF = MAXK + 4;   // float row of step 3's tiles (272 bytes; float4 reads)
constexpr int LDH = MAXK + 8;   // bf16 row (144 bytes: aligned, fragment loads conflict-free)
constexpr int LDS1 = MAXK + 1;  // float row of the CUDA-core step 3's factor tiles

// step 1: inc = (k * exp(total - cs))^T . v of chunk blockIdx.x of (b =
// blockIdx.z, h = blockIdx.y) into ws (B, H, nc, K, K), exp(total) into
// decay (B, H, nc, K); the serial kernel's arithmetic, element for element.
// vec: bit 0 for 16-byte loads of k and v, bit 1 of w
template <typename T, typename TW>
__global__ void __launch_bounds__(NT) wkv_states_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const TW* __restrict__ w,
    float* __restrict__ ws, float* __restrict__ decay, int S, int H, int K, int c, int vec) {
  extern __shared__ __align__(16) float sm1[];
  float* sK = sm1;              // k, then k * exp(total - cs)  (c, LDW)
  float* sV = sK + c * LDW;     // v
  float* sC = sV + c * LDW;     // w, then cs
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = ((int64_t)b * S + (int64_t)j * c) * RS + (int64_t)h * K;
  chunk_scan::load_tile(sK, LDW, k + base, RS, c, K, vec & 1, tid, NT);
  chunk_scan::load_tile(sV, LDW, v + base, RS, c, K, vec & 1, tid, NT);
  chunk_scan::load_tile(sC, LDW, w + base, RS, c, K, (vec & 2) != 0, tid, NT);
  __syncthreads();
  if (tid < K) {
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < c; ++t) {
      acc += sC[t * LDW + tid];
      sC[t * LDW + tid] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < c * K; e += NT) {
    const int t = e / K, jj = e - t * K;
    const float cs = sC[t * LDW + jj], total = sC[(c - 1) * LDW + jj];
    sK[t * LDW + jj] = sK[t * LDW + jj] * expf(total - cs);
  }
  __syncthreads();
  const int j0 = 4 * (tid >> 4), i0 = 4 * (tid & 15);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
#pragma unroll 4
  for (int s = 0; s < c; ++s) {
    const float4 kv = *reinterpret_cast<const float4*>(&sK[s * LDW + j0]);
    const float4 vv = *reinterpret_cast<const float4*>(&sV[s * LDW + i0]);
    const float ka[4] = {kv.x, kv.y, kv.z, kv.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(ka[a], va[bb], acc[a][bb]);
  }
  const int64_t bhj = ((int64_t)b * H + h) * nc + j;
  float* out = ws + bhj * K * K;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      if (j0 + a < K && i0 + bb < K) out[(j0 + a) * K + i0 + bb] = acc[a][bb];
  if (tid < K) decay[bhj * K + tid] = expf(sC[(c - 1) * LDW + tid]);
}

// step 3's shared memory, in this order: three float (MAXK, LDF) tiles (w,
// then the factor exp(cs - w) folded into r; cs, then r * exp(cs - w); the
// starting state, transposed for the tensor-core form), four vectors
// (total, m, the bonus per row, u), the chunk's r, k and v as they lie
// (rows of 16-byte multiples), then three tiles of FT (r_f, k_f and v as
// the intra-chunk products take them) and, on the CUDA cores, att
template <typename T, typename FT>
struct Step3 {
  static constexpr int LDT = MAXK + 16 / (int)sizeof(T);
  static constexpr int LDX = sizeof(FT) == 2 ? LDH : LDS1;
  static constexpr int HEAD = (3 * MAXK * LDF + 4 * MAXK) * 4 + 3 * MAXK * LDT * (int)sizeof(T);
  static constexpr int BYTES = HEAD + 3 * MAXK * LDX * (int)sizeof(FT) +
                               (sizeof(FT) == 2 ? 0 : MAXK * LDS1 * 4);
  float *sW, *sC, *sS, *sTot, *sM, *sBo, *sU;
  T *sR, *sK, *sV;
  FT *sRf, *sKf, *sVi;
  float* sA;
  __device__ explicit Step3(unsigned char* base) {
    sW = reinterpret_cast<float*>(base);
    sC = sW + MAXK * LDF;
    sS = sC + MAXK * LDF;
    sTot = sS + MAXK * LDF;
    sM = sTot + MAXK;
    sBo = sM + MAXK;
    sU = sBo + MAXK;
    sR = reinterpret_cast<T*>(sU + MAXK);
    sK = sR + MAXK * LDT;
    sV = sK + MAXK * LDT;
    sRf = reinterpret_cast<FT*>(base + HEAD);
    sKf = sRf + MAXK * LDX;
    sVi = sKf + MAXK * LDX;
    sA = reinterpret_cast<float*>(sVi + MAXK * LDX);
  }
};

// step 3's phases before the products, by all NT threads of the block:
// - the chunk's r, k, v (cp.async where the rows allow), w and u into
//   shared memory, the starting state S (from ws) as it lies or, with
//   TRANS, transposed;
// - threads 0 .. K - 1 run the per-channel cumsum of w in the serial order
//   and keep cs, d = cs - w, total and m = (total - w[0]) / 2; threads
//   MAXK .. MAXK + c - 1 sum the bonus r . (u * k) of their row in order,
//   as the serial kernel does;
// - every (row, channel): r * exp(d) over cs, r_f = r * exp(d - m), k_f =
//   k * exp(m - cs) and v into the FT tiles (bf16 rounds them, as the
//   model's function does).
template <typename T, typename TW, typename FT, bool TRANS>
__device__ __forceinline__ void step3_prepare(const Step3<T, FT>& m, const T* __restrict__ r,
                                              const T* __restrict__ k, const T* __restrict__ v,
                                              const TW* __restrict__ w,
                                              const float* __restrict__ u,
                                              const float* __restrict__ st, int64_t base,
                                              int64_t RS, int K, int c, int u_row, int vec,
                                              int tid) {
  using namespace chunk_scan;
  constexpr int LDT = Step3<T, FT>::LDT, LDX = Step3<T, FT>::LDX;
  copy_tile(m.sR, LDT, r + base, RS, c, K, vec & 1, tid, NT);
  copy_tile(m.sK, LDT, k + base, RS, c, K, vec & 1, tid, NT);
  copy_tile(m.sV, LDT, v + base, RS, c, K, vec & 1, tid, NT);
  if constexpr (sizeof(TW) == 4) {
    copy_tile(m.sW, LDF, reinterpret_cast<const float*>(w) + base, RS, c, K, (vec & 2) != 0,
              tid, NT);
  } else {
    load_tile(m.sW, LDF, w + base, RS, c, K, (vec & 2) != 0, tid, NT);
  }
  // S (K, K), four values a thread a load, four loads in flight
  const int n4 = K * K / 4;
  for (int e0 = tid; e0 < n4; e0 += 4 * NT) {
    float4 sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (e0 + i * NT < n4) sv[i] = reinterpret_cast<const float4*>(st)[e0 + i * NT];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * (e0 + i * NT);
      if (e < K * K) {
        const int j = e / K, i0 = e - j * K;
        const float a[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (TRANS) {
            m.sS[(i0 + q) * LDF + j] = a[q];
          } else {
            m.sS[j * LDF + i0 + q] = a[q];
          }
        }
      }
    }
  }
  if (tid < K) m.sU[tid] = u[(int64_t)u_row * K + tid];
  cp_async_wait_all();
  __syncthreads();
  if (tid < K) {
    const float w0 = m.sW[tid];
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < c; ++t) {
      const float wv = m.sW[t * LDF + tid];
      acc += wv;
      m.sC[t * LDF + tid] = acc;
      m.sW[t * LDF + tid] = acc - wv;
    }
    m.sTot[tid] = acc;
    m.sM[tid] = 0.5f * (acc - w0);
  } else if (tid >= MAXK && tid - MAXK < c) {
    const int t = tid - MAXK;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < K; ++j) acc += to_f(m.sR[t * LDT + j]) * m.sU[j] * to_f(m.sK[t * LDT + j]);
    m.sBo[t] = acc;
  }
  __syncthreads();
  for (int e = tid; e < c * K; e += NT) {
    const int t = e / K, j = e - t * K;
    const float cs = m.sC[t * LDF + j], d = m.sW[t * LDF + j], mm = m.sM[j];
    const float rv = to_f(m.sR[t * LDT + j]), kv = to_f(m.sK[t * LDT + j]);
    m.sC[t * LDF + j] = rv * expf(d);
    m.sRf[t * LDX + j] = conv<FT, float>(rv * expf(d - mm));
    m.sKf[t * LDX + j] = conv<FT, float>(kv * expf(mm - cs));
    m.sVi[t * LDX + j] = conv<FT, T>(m.sV[t * LDT + j]);
  }
  __syncthreads();
}

// the intra-chunk part of y for the row tile rt (rows 16 rt .. 16 rt + 15)
// of the chunk in shared memory and the value-column tiles vt0 .. vt0 + nvt
// - 1 (at most 2) on the tensor cores: att = r_f . k_f^T on the strict
// lower triangle, rounded, then att . v, as D fragments
template <typename T>
__device__ __forceinline__ void wkv_intra(const Step3<T, bf16>& m, int K, int rt, int vt0,
                                          int nvt, int lane, float (&yi)[2][4]) {
  using namespace chunk_scan;
  const int g = lane >> 2, t = lane & 3;
  const int K16 = (K + 15) & ~15;
  const int q0 = 16 * rt, r0 = q0 + g, r1 = r0 + 8;
  // att = r_f . k_f^T against the key tiles up to the diagonal
  float sc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
  for (int ks = 0; ks < K16; ks += 16) {
    uint32_t af[4];
    af[0] = ld_pair(&m.sRf[r0 * LDH + ks + 2 * t]);
    af[1] = ld_pair(&m.sRf[r1 * LDH + ks + 2 * t]);
    af[2] = ld_pair(&m.sRf[r0 * LDH + ks + 2 * t + 8]);
    af[3] = ld_pair(&m.sRf[r1 * LDH + ks + 2 * t + 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt <= 2 * rt + 1) {
        uint32_t bfr[2];
        bfr[0] = ld_pair(&m.sKf[(nt * 8 + g) * LDH + ks + 2 * t]);
        bfr[1] = ld_pair(&m.sKf[(nt * 8 + g) * LDH + ks + 2 * t + 8]);
        mma_bf16(sc[nt], af, bfr);
      }
    }
  }
  // the strict lower triangle, rounded to bf16, as att . v's A fragments
  uint32_t sf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk <= rt) {
      float a[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = (e >> 1) ? r1 : r0;
          const int s = nt * 8 + 2 * t + (e & 1);
          a[half][e] = s < q ? bf16_round(sc[nt][e]) : 0.f;
        }
      }
      sf[kk][0] = pack_bf16(a[0][0], a[0][1]);
      sf[kk][1] = pack_bf16(a[0][2], a[0][3]);
      sf[kk][2] = pack_bf16(a[1][0], a[1][1]);
      sf[kk][3] = pack_bf16(a[1][2], a[1][3]);
    }
  }
#pragma unroll
  for (int vt = 0; vt < 2; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[vt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk <= rt) {
#pragma unroll
      for (int vt = 0; vt < 2; ++vt) {
        if (vt < nvt) {
          const int col = (vt0 + vt) * 8 + g;
          uint32_t bfr[2];
          bfr[0] = ld_col_pair(&m.sVi[(16 * kk + 2 * t) * LDH + col], LDH);
          bfr[1] = ld_col_pair(&m.sVi[(16 * kk + 2 * t + 8) * LDH + col], LDH);
          mma_bf16(yi[vt], sf[kk], bfr);
        }
      }
    }
  }
}

// step 3 on the tensor cores (the model's function), a block a chunk (and a
// share of the value columns where the grid is short)
template <typename T, typename TW>
__global__ void __launch_bounds__(NT, 2) wkv_out_mma_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, const float* __restrict__ ws,
    T* __restrict__ y, int S, int H, int K, int c, int u_per_row, int vsplit, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) unsigned char sm3[];
  const Step3<T, bf16> m(sm3);
  const int jc = blockIdx.x / vsplit, vs = blockIdx.x % vsplit;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / vsplit;
  const int tid = threadIdx.x;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = ((int64_t)b * S + (int64_t)jc * c) * RS + (int64_t)h * K;
  const int K16 = (K + 15) & ~15, K4 = (K + 3) & ~3;

  // zero the pads the products read: r_f's and k_f's columns [K, K16), the
  // state part's [K, K4)
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = tid; e < c * (K16 - K); e += NT) {
    const int t = e / (K16 - K), col = K + e % (K16 - K);
    m.sRf[t * LDH + col] = zero;
    m.sKf[t * LDH + col] = zero;
  }
  for (int e = tid; e < MAXK * (K4 - K); e += NT) {
    const int t = e / (K4 - K), col = K + e % (K4 - K);
    m.sC[t * LDF + col] = 0.f;
    m.sS[t * LDF + col] = 0.f;
  }
  step3_prepare<T, TW, bf16, true>(m, r, k, v, w, u,
                                   ws + (((int64_t)b * H + h) * nc + jc) * K * K, base, RS, K, c,
                                   u_per_row ? b * H + h : h, vec, tid);

  // warp w: the row tiles w % 2 and 3 - w % 2, so that every warp has as
  // many key tiles below the diagonal, and a quarter of this block's
  // value-column tiles; first the tiles' intra-chunk parts, then their
  // state parts together, four rows a thread (each float4 of S read from
  // shared memory feeds sixteen fmaf), then y (a tile past c computes on
  // rows never loaded and stores nothing)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int KT = (K + 7) >> 3, tpv = (KT + vsplit - 1) / vsplit;
  const int bv0 = vs * tpv, bnv = min(KT, bv0 + tpv) - bv0, qn = (bnv + 3) >> 2;
  const int vt0 = bv0 + (warp >> 1) * qn, nvt = min(bv0 + bnv, vt0 + qn) - vt0;
  if (nvt <= 0) return;
  const int rts[2] = {warp & 1, 3 - (warp & 1)};
  float yi[2][2][4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (16 * rts[pass] < c) wkv_intra(m, K, rts[pass], vt0, nvt, lane, yi[pass]);
  }
  int rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) rows[r] = 16 * rts[r >> 1] + g + 8 * (r & 1);
  float ys[2][2][4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int vt = 0; vt < 2; ++vt)
#pragma unroll
      for (int q = 0; q < 4; ++q) ys[pass][vt][q] = 0.f;
  for (int jj = 0; jj < K4; jj += 4) {
    float xr[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(&m.sC[rows[r] * LDF + jj]);
      xr[r][0] = a4.x;
      xr[r][1] = a4.y;
      xr[r][2] = a4.z;
      xr[r][3] = a4.w;
    }
#pragma unroll
    for (int vt = 0; vt < 2; ++vt) {
      if (vt < nvt) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int i = (vt0 + vt) * 8 + 2 * t + qq;
          const float4 hv = *reinterpret_cast<const float4*>(&m.sS[i * LDF + jj]);
          const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float& acc = ys[r >> 1][vt][2 * (r & 1) + qq];
              acc = fmaf(xr[r][mm], ha[mm], acc);
            }
          }
        }
      }
    }
  }
  constexpr int LDT = Step3<T, bf16>::LDT;
  T* yrow = y + base;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (16 * rts[pass] >= c) continue;
#pragma unroll
    for (int vt = 0; vt < 2; ++vt) {
      if (vt < nvt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 16 * rts[pass] + g + 8 * (e >> 1);
          const int i = (vt0 + vt) * 8 + 2 * t + (e & 1);
          if (i < K) {
            const float yq = ys[pass][vt][e] + yi[pass][vt][e];
            yrow[(int64_t)q * RS + i] = from_f<T>(yq + m.sBo[q] * to_f(m.sV[q * LDT + i]));
          }
        }
      }
    }
  }
}

// step 3 on CUDA cores (every product float32)
template <typename T, typename TW>
__global__ void __launch_bounds__(NT) wkv_out_simt_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, const float* __restrict__ ws,
    T* __restrict__ y, int S, int H, int K, int c, int u_per_row, int vec) {
  extern __shared__ __align__(16) unsigned char sm3[];
  const Step3<T, float> m(sm3);
  const int jc = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = ((int64_t)b * S + (int64_t)jc * c) * RS + (int64_t)h * K;
  step3_prepare<T, TW, float, false>(m, r, k, v, w, u,
                                     ws + (((int64_t)b * H + h) * nc + jc) * K * K, base, RS, K,
                                     c, u_per_row ? b * H + h : h, vec, tid);
  for (int e = tid; e < c * c; e += NT) {
    const int q = e / c, s = e - q * c;
    float a = 0.f;
    if (s < q) {
      for (int jj = 0; jj < K; ++jj) a = fmaf(m.sRf[q * LDS1 + jj], m.sKf[s * LDS1 + jj], a);
    }
    m.sA[q * LDS1 + s] = a;
  }
  __syncthreads();
  for (int e = tid; e < c * K; e += NT) {
    const int q = e / K, i = e - q * K;
    float ys = 0.f, yi = 0.f;
    for (int jj = 0; jj < K; ++jj) ys = fmaf(m.sC[q * LDF + jj], m.sS[jj * LDF + i], ys);
    for (int s = 0; s < q; ++s) yi = fmaf(m.sA[q * LDS1 + s], m.sVi[s * LDS1 + i], yi);
    const float yq = ys + yi;
    y[base + (int64_t)q * RS + i] = from_f<T>(yq + m.sBo[q] * m.sVi[q * LDS1 + i]);
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

// the chunked route's three launches: the increments, the state pass, the
// outputs
template <typename T, typename TW, bool BF16_INTRA>
int entry_chunked(const void* r, const void* k, const void* v, const void* w, const void* u,
                  void* y, void* sout, void* ws, void* decay, int B, int S, int H, int K, int c,
                  int u_per_row, int vsplit, int vec, void* stream) {
  if (K <= 0 || K > MAXK || K % 4 || c <= 0 || c > MAXK || c % 16 || S <= 0 || S % c ||
      vsplit <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || H <= 0) return 0;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int nc = S / c;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  // 1: every chunk's increment and decay
  const size_t states_smem = 3 * (size_t)c * LDW * sizeof(float);
  err = cudaFuncSetAttribute(wkv_states_kernel<T, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)states_smem);
  if (err != cudaSuccess) return (int)err;
  wkv_states_kernel<T, TW><<<dim3(nc, H, B), NT, states_smem, st>>>(
      (const T*)k, (const T*)v, (const TW*)w, (float*)ws, (float*)decay, S, H, K, c, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2: the state pass, each chunk's starting state over its increment
  const int rc = chunk_scan::launch_state_pass((float*)ws, (const float*)decay, (float*)sout,
                                               B * H, nc, K * K, K, st);
  if (rc != 0) return rc;
  // 3: every chunk's outputs from its starting state
  if constexpr (BF16_INTRA) {
    constexpr int smem = Step3<T, bf16>::BYTES;
    err = cudaFuncSetAttribute(wkv_out_mma_kernel<T, TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    wkv_out_mma_kernel<T, TW><<<dim3(nc * vsplit, H, B), NT, smem, st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u,
        (const float*)ws, (T*)y, S, H, K, c, u_per_row, vsplit, vec);
  } else {
    constexpr int smem = Step3<T, float>::BYTES;
    err = cudaFuncSetAttribute(wkv_out_simt_kernel<T, TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    wkv_out_simt_kernel<T, TW><<<dim3(nc, H, B), NT, smem, st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u,
        (const float*)ws, (T*)y, S, H, K, c, u_per_row, vec);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

}  // namespace

#define WKV_ENTRY(SUFFIX, T, TW, BF16_INTRA)                                                 \
  extern "C" int rwkv6_wkv_##SUFFIX(const void* r, const void* k, const void* v,            \
                                    const void* w, const void* u, void* y, void* sout, int B, \
                                    int S, int H, int K, int c, int u_per_row,               \
                                    void* stream) {                                          \
    return entry<T, TW, BF16_INTRA>(r, k, v, w, u, y, sout, B, S, H, K, c, u_per_row,       \
                                    stream);                                                 \
  }                                                                                          \
  extern "C" int rwkv6_wkv_chunked_##SUFFIX(                                                 \
      const void* r, const void* k, const void* v, const void* w, const void* u, void* y,    \
      void* sout, void* ws, void* decay, int B, int S, int H, int K, int c, int u_per_row,   \
      int vsplit, int vec, void* stream) {                                                   \
    return entry_chunked<T, TW, BF16_INTRA>(r, k, v, w, u, y, sout, ws, decay, B, S, H, K,  \
                                            c, u_per_row, vsplit, vec, stream);              \
  }

WKV_ENTRY(f32_f32_f32, float, float, false)
WKV_ENTRY(f32_f32_bf16, float, float, true)
WKV_ENTRY(f32_bf16_f32, float, __nv_bfloat16, false)
WKV_ENTRY(f32_bf16_bf16, float, __nv_bfloat16, true)
WKV_ENTRY(bf16_f32_f32, __nv_bfloat16, float, false)
WKV_ENTRY(bf16_f32_bf16, __nv_bfloat16, float, true)
WKV_ENTRY(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, false)
WKV_ENTRY(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, true)
