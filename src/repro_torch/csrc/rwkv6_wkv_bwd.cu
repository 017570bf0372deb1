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
// of the rounded values (exact products), which mma.sync's bf16 operands
// and float32 sums compute too.
//
// What bounds it on this card: at the rwkv6-7b training shape (2 x 4096
// tokens, 64 heads of K = 64, c = 64) a call reads r, k, v, dy in bf16 and
// w in float32 (0.40 GB) and writes their gradients (0.40 GB): 0.24 ms at
// 3.35 TB/s. Its products are about 12 c K K + 5 c c K / 2 flop pairs a
// chunk, 2.9e10 flop in all, 0.44 ms at 67 TFLOP/s: so operations.
//
// Two routes; kernels/rwkv6_wkv/ops.py picks one by shape (wkv_route):
//
// serial (the first design; chunks whose length is not a multiple of 16):
// one 256-thread block per (b, h) walks its chunks. It first walks them
// forward, S = e^total S + KW^T v (K12's serial state update), writing
// each chunk's starting state into a float32 workspace (B, H, nc, K, K),
// 134 MB a layer at rwkv6-7b; then it walks them backward carrying dS (K x
// K float32) in shared memory. Every product is a 4 x 4 patch a thread on
// the CUDA cores (scan_bwd.cuh) over 64 x 65 float tiles in shared memory
// (12 tiles, 200 KB: one block an SM). 128 blocks at rwkv6-7b, less than a
// wave of 132 SMs, 64 chunks each in order: latency bounds it.
//
// chunked (c a multiple of 16, K of 4): the chunk-parallel form in three
// launches, a grid of (b, h, chunk), 8192 blocks at rwkv6-7b:
// 1. wkv_bwd_states_kernel, a block a chunk: the per-channel cumsum of w in
//    the serial order, then both increments, KW^T v (the forward's) and
//    RD^T dy (the backward's), as the serial kernel sums them (fmaf over
//    the chunk's rows in order), and e^total, into two float32 workspaces
//    (B, H, nc, K, K) and the decays (B, H, nc, K).
// 2. chunk_scan::state_pass_kernel, both directions in one launch: S =
//    e^total S + inc forward from 0, each slot overwritten with its chunk's
//    starting state; dS = e^total dS + inc backward from dstate, each slot
//    overwritten with the gradient of its chunk's end state. Both are the
//    serial kernel's multiply and add, so S0 and dS are the serial route's
//    bit for bit.
// 3. a block a chunk, every gradient of the chunk from its S0 and dS:
//    - wkv_grad_mma_kernel (bf16 activations, the model's function), 512
//      threads: the chunk's tiles come in by cp.async, S0 and dS in a
//      second group that lands while the block computes the cumsum, the
//      factors and the intra-chunk products, which do not read them. A = RF
//      KF^T and dA = dy v^T on the strict lower triangle on the tensor cores
//      (mma.sync m16n8k16, bf16 operands the function has already rounded,
//      float32 sums), rounded into shared memory; then each of sixteen warps
//      takes a 16-row tile (w % 4) and a quarter of the columns: dRF = dA
//      KF, dKF = dA^T RF and A^T dy, then the state products dy S0^T, v dS^T
//      and KW dS, all on the tensor cores. The state products' float32
//      operands S0, dS and KW enter as hi + lo bf16 halves (the split K4-K6
//      use: dy S0h^T + dy S0l^T, and KWh dSh + KWh dSl + KWl dSh; each
//      product then carries about 16 bits of each float32 value where a
//      float32 product carries 24, and dr, dk, dv are bf16). Then dr, dk, dv
//      (a bf16 pair a store), the exponents' terms g_cs and g_w into shared
//      memory and their column sums (with du's terms) by shuffles; then
//      dw's reverse cumsum with a lane a channel and a warp a run of rows,
//      so that each read of a row is one conflict-free line. du is written
//      per chunk (B, H, nc, K) and summed over the chunks by the wrapper, in
//      a fixed order. 200 KB of shared memory, one block an SM.
//    - otherwise (float32 activations or every product float32): the
//      serial kernel's chunk body for this one chunk, on the CUDA cores.
//    The backward's products reduce over the value columns, so there is no
//    split of them: the grid is short only for short sequences.
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

// The serial route's kernel (CHUNKED = false): a block per (b, h), its
// chunks' starting states into ws by a forward walk, then the chunks
// backward with dS carried; du (B, H, K). With CHUNKED, the chunked route's
// step 3 on the CUDA cores: a block per (chunk = blockIdx.x, h = blockIdx.y,
// b = blockIdx.z), the same chunk body from the starting state in ws and
// the end state's gradient in dsw (both (B, H, nc, K, K)); du per chunk (B,
// H, nc, K).
template <typename T, typename TW, bool BF16_INTRA, bool CHUNKED>
__global__ void __launch_bounds__(NT, 1) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, const T* __restrict__ dy,
    const float* __restrict__ dstate, T* __restrict__ dr, T* __restrict__ dk,
    T* __restrict__ dv, TW* __restrict__ dw, float* __restrict__ du, float* __restrict__ ws,
    const float* __restrict__ dsw, int S, int H, int K, int c, int u_per_row) {
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
  const int b = CHUNKED ? blockIdx.z * H + blockIdx.y : blockIdx.x;   // (batch, head)
  const int h = b % H;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = (int64_t)(b / H) * S * RS + (int64_t)h * K;
  const int nc = S / c;
  const int jc_hi = CHUNKED ? blockIdx.x : nc - 1, jc_lo = CHUNKED ? blockIdx.x : 0;
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
  for (int jc = 0; jc < (CHUNKED ? 0 : nc); ++jc) {
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
            CHUNKED ? dsw[((int64_t)b * nc + jc_lo) * KK + (i0 + a) * K + j0 + bb]
            : dstate ? dstate[(int64_t)b * KK + (i0 + a) * K + j0 + bb] : 0.f;
  float du_acc = 0.f;
  for (int jc = jc_hi; jc >= jc_lo; --jc) {
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
    if constexpr (!CHUNKED) {
      patch(gS, i0, j0, 0, c, [&](int j, int q) { return sX0[q * LD + j]; },
            [&](int q, int i) { return sY[q * LD + i]; });
    }
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
    if constexpr (!CHUNKED) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = i0 + a, i = j0 + bb;
          if (j < K && i < K) sdS[j * LD + i] = expf(vTot[j]) * sdS[j * LD + i] + gS[a][bb];
        }
      __syncthreads();
    }
  }
  if (tid < K) du[((int64_t)b * (CHUNKED ? nc : 1) + (CHUNKED ? jc_lo : 0)) * K + tid] = du_acc;
}

// ------------------------------------------------------------ chunked route

using bf16 = __nv_bfloat16;

constexpr int LDW = MAXK;       // float row of step 1's tiles (256 bytes)
constexpr int LDF = MAXK + 4;   // float row of step 3's tiles (272 bytes; float4 reads)
constexpr int LDB = MAXK + 8;   // bf16 row (144 bytes: 16-byte rows, fragment loads conflict-free)
constexpr int NTG = 512;        // step 3's tensor-core form: sixteen warps

// step 1: both increments of chunk blockIdx.x of (b = blockIdx.z, h =
// blockIdx.y), KW^T v into wsf and RD^T dy into wsb (B, H, nc, K, K), and
// e^total into decay (B, H, nc, K): the serial kernel's arithmetic, element
// for element. r, k, v, dy stay in their dtype in shared memory (cp.async
// where the rows allow); w's tile becomes d, then RD, and cs's tile KW.
// vec: bit 0 for 16-byte copies of r, k, v and dy, bit 1 of w
template <typename T, typename TW>
__global__ void __launch_bounds__(NT, 2) wkv_bwd_states_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const TW* __restrict__ w, const T* __restrict__ dy, float* __restrict__ wsf,
    float* __restrict__ wsb, float* __restrict__ decay, int S, int H, int K, int c, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) float sm1[];
  float* sW = sm1;              // w, then d = cs - w, then RD = r e^d  (c, LDW)
  float* sC = sW + c * LDW;     // cs, then KW = k e^(total - cs)
  float* vTot = sC + c * LDW;   // total (MAXK)
  T* sK = reinterpret_cast<T*>(vTot + MAXK);   // (c, LDW) each
  T* sV = sK + c * LDW;
  T* sR = sV + c * LDW;
  T* sY = sR + c * LDW;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = ((int64_t)b * S + (int64_t)j * c) * RS + (int64_t)h * K;
  if constexpr (sizeof(TW) == 4) {
    copy_tile(sW, LDW, reinterpret_cast<const float*>(w) + base, RS, c, K, (vec & 2) != 0, tid,
              NT);
  } else {
    load_tile(sW, LDW, w + base, RS, c, K, (vec & 2) != 0, tid, NT);
  }
  copy_tile(sK, LDW, k + base, RS, c, K, vec & 1, tid, NT);
  copy_tile(sV, LDW, v + base, RS, c, K, vec & 1, tid, NT);
  copy_tile(sR, LDW, r + base, RS, c, K, vec & 1, tid, NT);
  copy_tile(sY, LDW, dy + base, RS, c, K, vec & 1, tid, NT);
  cp_async_wait_all();
  __syncthreads();
  if (tid < K) {
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < c; ++t) {
      const float wv = sW[t * LDW + tid];
      acc += wv;
      sC[t * LDW + tid] = acc;
      sW[t * LDW + tid] = acc - wv;
    }
    vTot[tid] = acc;
  }
  __syncthreads();
  for (int e = tid; e < c * K; e += NT) {
    const int t = e / K, jj = e - t * K;
    sC[t * LDW + jj] = to_f(sK[t * LDW + jj]) * expf(vTot[jj] - sC[t * LDW + jj]);
    sW[t * LDW + jj] = to_f(sR[t * LDW + jj]) * expf(sW[t * LDW + jj]);
  }
  __syncthreads();
  // (outputs past K read columns never written and are not stored)
  const int j0 = 4 * (tid >> 4), i0 = 4 * (tid & 15);
  float af[4][4], ab[4][4];
  zero(af);
  zero(ab);
#pragma unroll 2
  for (int s = 0; s < c; ++s) {
    float ka[4], va[4], ra[4], ya[4];
    ld4(&sC[s * LDW + j0], ka);
    ld4(&sV[s * LDW + i0], va);
    ld4(&sW[s * LDW + j0], ra);
    ld4(&sY[s * LDW + i0], ya);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        af[a][bb] = fmaf(ka[a], va[bb], af[a][bb]);
        ab[a][bb] = fmaf(ra[a], ya[bb], ab[a][bb]);
      }
  }
  const int64_t bhj = ((int64_t)b * H + h) * nc + j;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      if (j0 + a < K && i0 + bb < K) {
        wsf[bhj * K * K + (j0 + a) * K + i0 + bb] = af[a][bb];
        wsb[bhj * K * K + (j0 + a) * K + i0 + bb] = ab[a][bb];
      }
  if (tid < K) decay[bhj * K + tid] = expf(vTot[tid]);
}

// step 3's shared memory on the tensor cores, in this order: S0 and dS as
// they come (float (MAXK, LDF), rows j, columns i), which g_cs and g_w take
// after the products; S0, dS (rows j) and KW (rows t) as hi + lo bf16
// halves (MAXK, LDB); RF and KF (bf16); r, k, v, dy as they lie (bf16); d =
// cs - w and cs (float); A and dA rounded (bf16 (c, c) lower triangles,
// rows of LDB); six vectors (u, total, m, the bonus and dy . v per row,
// rowsum(dS . S0)); the column sums of e3 - e2, e4 and du's terms by row
// tile, and the sums of g_cs by run of rows
struct GradSmem {
  static constexpr int FT = MAXK * LDF * 4, BT = MAXK * LDB * 2;
  static constexpr int RUNS = 8;   // runs of rows of the reverse cumsum
  static constexpr int BYTES = 2 * FT + 6 * BT + 2 * BT + 4 * BT + 2 * FT + 2 * BT +
                               (6 + 3 * 4 + RUNS) * MAXK * 4;
  float *sS0, *sdS;
  bf16 *hS0, *lS0, *hdS, *ldS, *hKW, *lKW;
  bf16 *sRF, *sKF, *sR, *sK, *sV, *sY;
  float *sD, *sCs;
  bf16 *sA, *sdA;
  float *vU, *vTot, *vM, *vCur, *vDcur, *vRs, *vCol, *vRun;
  float *Gcs, *Gw;   // over sS0 and sdS
  __device__ explicit GradSmem(unsigned char* p) {
    sS0 = reinterpret_cast<float*>(p);
    sdS = sS0 + MAXK * LDF;
    hS0 = reinterpret_cast<bf16*>(sdS + MAXK * LDF);
    lS0 = hS0 + MAXK * LDB;
    hdS = lS0 + MAXK * LDB;
    ldS = hdS + MAXK * LDB;
    hKW = ldS + MAXK * LDB;
    lKW = hKW + MAXK * LDB;
    sRF = lKW + MAXK * LDB;
    sKF = sRF + MAXK * LDB;
    sR = sKF + MAXK * LDB;
    sK = sR + MAXK * LDB;
    sV = sK + MAXK * LDB;
    sY = sV + MAXK * LDB;
    sD = reinterpret_cast<float*>(sY + MAXK * LDB);
    sCs = sD + MAXK * LDF;
    sA = reinterpret_cast<bf16*>(sCs + MAXK * LDF);
    sdA = sA + MAXK * LDB;
    vU = reinterpret_cast<float*>(sdA + MAXK * LDB);
    vTot = vU + MAXK;
    vM = vTot + MAXK;
    vCur = vM + MAXK;
    vDcur = vCur + MAXK;
    vRs = vDcur + MAXK;
    vCol = vRs + MAXK;          // (3, 4, MAXK): e3 - e2, e4, du's terms by row tile
    vRun = vCol + 12 * MAXK;    // (RUNS, MAXK)
    Gcs = sS0;
    Gw = sdS;
  }
};

// v as hi + lo bf16 halves: hi = v rounded, lo = what is left, rounded
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// step 3 on the tensor cores (bf16 activations, the model's function): every
// gradient of chunk blockIdx.x of (b = blockIdx.z, h = blockIdx.y) from its
// starting state (wsf) and its end state's gradient (wsb); du per chunk
// into dup (B, H, nc, K). The states' copies land while the block computes
// the cumsum, the factors and the tensor-core products, which do not read
// them.
template <typename TW>
__global__ void __launch_bounds__(NTG, 1) wkv_grad_mma_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const TW* __restrict__ w, const float* __restrict__ u, const bf16* __restrict__ dy,
    const float* __restrict__ wsf, const float* __restrict__ wsb, bf16* __restrict__ dr,
    bf16* __restrict__ dk, bf16* __restrict__ dv, TW* __restrict__ dw, float* __restrict__ dup,
    int S, int H, int K, int c, int u_per_row, int vec) {
  using namespace chunk_scan;
  extern __shared__ __align__(16) unsigned char smg[];
  const GradSmem m(smg);
  const int jc = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x;
  const int64_t RS = (int64_t)H * K;
  const int64_t base = ((int64_t)b * S + (int64_t)jc * c) * RS + (int64_t)h * K;
  const int64_t bhj = ((int64_t)b * H + h) * nc + jc;
  const int K16 = (K + 15) & ~15;

  // zero the pads the tensor-core products read: columns [K, K16), and the
  // halves' tiles whole (rows past K of dS are the k rows of KW dS)
  const bf16 z = __float2bfloat16_rn(0.f);
  for (int e = tid; e < c * (K16 - K); e += NTG) {
    const int t = e / (K16 - K), col = K + e % (K16 - K);
    m.sV[t * LDB + col] = z;
    m.sY[t * LDB + col] = z;
    m.sRF[t * LDB + col] = z;
    m.sKF[t * LDB + col] = z;
  }
  for (int e = tid; e < 6 * MAXK * LDB / 8; e += NTG)
    reinterpret_cast<uint4*>(m.hS0)[e] = make_uint4(0u, 0u, 0u, 0u);
  // the chunk's tiles, then (a second group) its two states
  if constexpr (sizeof(TW) == 4) {
    copy_tile(m.sD, LDF, reinterpret_cast<const float*>(w) + base, RS, c, K, (vec & 2) != 0,
              tid, NTG);
  } else {
    load_tile(m.sD, LDF, w + base, RS, c, K, (vec & 2) != 0, tid, NTG);
  }
  copy_tile(m.sR, LDB, r + base, RS, c, K, vec & 1, tid, NTG);
  copy_tile(m.sK, LDB, k + base, RS, c, K, vec & 1, tid, NTG);
  copy_tile(m.sV, LDB, v + base, RS, c, K, vec & 1, tid, NTG);
  copy_tile(m.sY, LDB, dy + base, RS, c, K, vec & 1, tid, NTG);
  cp_async_commit();
  copy_tile(m.sS0, LDF, wsf + bhj * K * K, K, K, K, true, tid, NTG);
  copy_tile(m.sdS, LDF, wsb + bhj * K * K, K, K, K, true, tid, NTG);
  cp_async_commit();
  if (tid < K) m.vU[tid] = u[(u_per_row ? (int64_t)b * H + h : (int64_t)h) * K + tid];
  cp_async_wait_group<1>();
  __syncthreads();

  // the cumsum per channel in the serial order (d, cs, total, m); the bonus
  // r . (u k) and dy . v per row, two threads a row
  if (tid < K) {
    const float w0 = m.sD[tid];
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < c; ++t) {
      const float wv = m.sD[t * LDF + tid];
      acc += wv;
      m.sCs[t * LDF + tid] = acc;
      m.sD[t * LDF + tid] = acc - wv;
    }
    m.vTot[tid] = acc;
    m.vM[tid] = 0.5f * (acc - w0);
  } else if (tid >= MAXK && tid < MAXK + 2 * MAXK) {
    const int t = (tid - MAXK) >> 1, half = tid & 1;
    float cu = 0.f, dc = 0.f;
    if (t < c) {
#pragma unroll 4
      for (int j = half; j < K; j += 2) {
        cu += to_f(m.sR[t * LDB + j]) * m.vU[j] * to_f(m.sK[t * LDB + j]);
        dc += to_f(m.sY[t * LDB + j]) * to_f(m.sV[t * LDB + j]);
      }
    }
    cu += __shfl_xor_sync(0xffffffffu, cu, 1);
    dc += __shfl_xor_sync(0xffffffffu, dc, 1);
    if (t < c && half == 0) {
      m.vCur[t] = cu;
      m.vDcur[t] = dc;
    }
  }
  __syncthreads();
  // the factors: RF, KF rounded as the products take them; KW
  for (int e = tid; e < c * K; e += NTG) {
    const int t = e / K, j = e - t * K;
    const float d = m.sD[t * LDF + j], cs = m.sCs[t * LDF + j], mm = m.vM[j];
    const float rv = to_f(m.sR[t * LDB + j]), kv = to_f(m.sK[t * LDB + j]);
    m.sRF[t * LDB + j] = __float2bfloat16_rn(rv * expf(d - mm));
    m.sKF[t * LDB + j] = __float2bfloat16_rn(kv * expf(mm - cs));
    split_bf16(kv * expf(m.vTot[j] - cs), m.hKW[t * LDB + j], m.lKW[t * LDB + j]);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nct = c / 16;
  // A = RF KF^T (warps 0-3) and dA = dy v^T (warps 4-7), a 16-row tile a
  // warp against the key tiles up to the diagonal, rounded, 0 on and above
  // the diagonal
  {
    const int rt = warp & 3;
    if (warp < 8 && rt < nct) {
      const bf16* xa = warp < 4 ? m.sRF : m.sY;
      const bf16* xb = warp < 4 ? m.sKF : m.sV;
      bf16* out = warp < 4 ? m.sA : m.sdA;
      const int r0 = 16 * rt + g, r1 = r0 + 8;
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      for (int ks = 0; ks < K16; ks += 16) {
        uint32_t af[4];
        af[0] = ld_pair(&xa[r0 * LDB + ks + 2 * t4]);
        af[1] = ld_pair(&xa[r1 * LDB + ks + 2 * t4]);
        af[2] = ld_pair(&xa[r0 * LDB + ks + 2 * t4 + 8]);
        af[3] = ld_pair(&xa[r1 * LDB + ks + 2 * t4 + 8]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt <= 2 * rt + 1) {
            uint32_t bfr[2];
            bfr[0] = ld_pair(&xb[(nt * 8 + g) * LDB + ks + 2 * t4]);
            bfr[1] = ld_pair(&xb[(nt * 8 + g) * LDB + ks + 2 * t4 + 8]);
            mma_bf16(sc[nt], af, bfr);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt <= 2 * rt + 1) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int q = hf ? r1 : r0, s = nt * 8 + 2 * t4;
            const float v0 = s < q ? sc[nt][2 * hf] : 0.f;
            const float v1 = s + 1 < q ? sc[nt][2 * hf + 1] : 0.f;
            *reinterpret_cast<uint32_t*>(&out[q * LDB + s]) = pack_bf16(v0, v1);
          }
        }
      }
    }
  }
  __syncthreads();

  // warp w: the row tile w % 4 and a quarter of the column tiles. First the
  // tensor-core products: dRF = dA KF over the key tiles up to the
  // diagonal, dKF = dA^T RF and A^T dy over the row tiles from the diagonal
  // down (the A fragments of X^T are column pairs of X); rounded as the
  // function rounds them
  const int KT = (K + 7) >> 3, qn = (KT + 3) >> 2;
  const int vt0 = (warp >> 2) * qn, nvt = min(KT, vt0 + qn) - vt0;
  const int rt = warp & 3;
  const bool busy = rt < nct && nvt > 0;
  const int q0 = 16 * rt, r0 = q0 + g, r1 = r0 + 8;
  float gRF[2][4], gKF[2][4], gVi[2][4];
#pragma unroll
  for (int vt = 0; vt < 2; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gRF[vt][e] = gKF[vt][e] = gVi[vt][e] = 0.f;
  if (busy) {
    for (int kt = 0; kt <= rt; ++kt) {
      const int s0 = 16 * kt;
      uint32_t af[4];
      af[0] = ld_pair(&m.sdA[r0 * LDB + s0 + 2 * t4]);
      af[1] = ld_pair(&m.sdA[r1 * LDB + s0 + 2 * t4]);
      af[2] = ld_pair(&m.sdA[r0 * LDB + s0 + 2 * t4 + 8]);
      af[3] = ld_pair(&m.sdA[r1 * LDB + s0 + 2 * t4 + 8]);
#pragma unroll
      for (int vt = 0; vt < 2; ++vt) {
        if (vt < nvt) {
          const int col = (vt0 + vt) * 8 + g;
          uint32_t bfr[2];
          bfr[0] = ld_col_pair(&m.sKF[(s0 + 2 * t4) * LDB + col], LDB);
          bfr[1] = ld_col_pair(&m.sKF[(s0 + 2 * t4 + 8) * LDB + col], LDB);
          mma_bf16(gRF[vt], af, bfr);
        }
      }
    }
    for (int kt = rt; kt < nct; ++kt) {
      const int s0 = 16 * kt;
      uint32_t at[4], dat[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int at_off = (s0 + 2 * t4 + 8 * (f >> 1)) * LDB + q0 + g + 8 * (f & 1);
        at[f] = ld_col_pair(&m.sA[at_off], LDB);
        dat[f] = ld_col_pair(&m.sdA[at_off], LDB);
      }
#pragma unroll
      for (int vt = 0; vt < 2; ++vt) {
        if (vt < nvt) {
          const int col = (vt0 + vt) * 8 + g;
          uint32_t bfr[2];
          bfr[0] = ld_col_pair(&m.sRF[(s0 + 2 * t4) * LDB + col], LDB);
          bfr[1] = ld_col_pair(&m.sRF[(s0 + 2 * t4 + 8) * LDB + col], LDB);
          mma_bf16(gKF[vt], dat, bfr);
          bfr[0] = ld_col_pair(&m.sY[(s0 + 2 * t4) * LDB + col], LDB);
          bfr[1] = ld_col_pair(&m.sY[(s0 + 2 * t4 + 8) * LDB + col], LDB);
          mma_bf16(gVi[vt], at, bfr);
        }
      }
    }
#pragma unroll
    for (int vt = 0; vt < 2; ++vt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gRF[vt][e] = bf16_round(gRF[vt][e]);
        gKF[vt][e] = bf16_round(gKF[vt][e]);
        gVi[vt][e] = bf16_round(gVi[vt][e]);
      }
  }
  cp_async_wait_group<0>();
  __syncthreads();   // S0 and dS have landed
  // S0 and dS as hi + lo bf16 halves; rowsum(dS . S0) per channel in
  // float32, eight threads a channel (eighths of the columns, summed in a
  // fixed order)
  for (int e = tid; e < K * K; e += NTG) {
    const int jj = e / K, i = e - jj * K;
    split_bf16(m.sS0[jj * LDF + i], m.hS0[jj * LDB + i], m.lS0[jj * LDB + i]);
    split_bf16(m.sdS[jj * LDF + i], m.hdS[jj * LDB + i], m.ldS[jj * LDB + i]);
  }
  {
    const int cj = tid >> 3, part = tid & 7;
    const int q8 = K >> 3, rest = K - 8 * q8;   // parts of q8 or q8 + 1 columns
    const int i0 = part * q8 + min(part, rest), i1 = i0 + q8 + (part < rest ? 1 : 0);
    float rs = 0.f;
    if (cj < K) {
      for (int i = i0; i < i1; ++i) rs = fmaf(m.sdS[cj * LDF + i], m.sS0[cj * LDF + i], rs);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    rs += __shfl_xor_sync(0xffffffffu, rs, 4);
    if (part == 0 && cj < K) m.vRs[cj] = rs;
  }
  __syncthreads();

  // then the state products on the tensor cores, each float32 operand as
  // hi + lo bf16 halves (dy S0^T = dy S0h^T + dy S0l^T, v dS^T the same, KW
  // dS = KWh dSh + KWh dSl + KWl dSh), float32 sums; dr, dk, dv out, g_cs
  // and g_w kept for the reverse cumsum, the column sums of e3 - e2, e4 and
  // du's terms over the tile into vCol
  float ev[2][4][2];
  if (busy) {
    const int rows[2] = {r0, r1};
    float gRD[2][4], gKW[2][4], gVs[2][4];
#pragma unroll
    for (int vt = 0; vt < 2; ++vt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gRD[vt][e] = gKW[vt][e] = gVs[vt][e] = 0.f;
    for (int ks = 0; ks < K16; ks += 16) {
      uint32_t ay[4], av[4], ah[4], al[4];
      ay[0] = ld_pair(&m.sY[r0 * LDB + ks + 2 * t4]);
      ay[1] = ld_pair(&m.sY[r1 * LDB + ks + 2 * t4]);
      ay[2] = ld_pair(&m.sY[r0 * LDB + ks + 2 * t4 + 8]);
      ay[3] = ld_pair(&m.sY[r1 * LDB + ks + 2 * t4 + 8]);
      av[0] = ld_pair(&m.sV[r0 * LDB + ks + 2 * t4]);
      av[1] = ld_pair(&m.sV[r1 * LDB + ks + 2 * t4]);
      av[2] = ld_pair(&m.sV[r0 * LDB + ks + 2 * t4 + 8]);
      av[3] = ld_pair(&m.sV[r1 * LDB + ks + 2 * t4 + 8]);
      ah[0] = ld_pair(&m.hKW[r0 * LDB + ks + 2 * t4]);
      ah[1] = ld_pair(&m.hKW[r1 * LDB + ks + 2 * t4]);
      ah[2] = ld_pair(&m.hKW[r0 * LDB + ks + 2 * t4 + 8]);
      ah[3] = ld_pair(&m.hKW[r1 * LDB + ks + 2 * t4 + 8]);
      al[0] = ld_pair(&m.lKW[r0 * LDB + ks + 2 * t4]);
      al[1] = ld_pair(&m.lKW[r1 * LDB + ks + 2 * t4]);
      al[2] = ld_pair(&m.lKW[r0 * LDB + ks + 2 * t4 + 8]);
      al[3] = ld_pair(&m.lKW[r1 * LDB + ks + 2 * t4 + 8]);
#pragma unroll
      for (int vt = 0; vt < 2; ++vt) {
        if (vt < nvt) {
          const int col = (vt0 + vt) * 8 + g;
          uint32_t b[2];
          // B[k = i][n = j] = X[j][i]: row pairs of X's row j
          b[0] = ld_pair(&m.lS0[col * LDB + ks + 2 * t4]);
          b[1] = ld_pair(&m.lS0[col * LDB + ks + 2 * t4 + 8]);
          mma_bf16(gRD[vt], ay, b);
          b[0] = ld_pair(&m.hS0[col * LDB + ks + 2 * t4]);
          b[1] = ld_pair(&m.hS0[col * LDB + ks + 2 * t4 + 8]);
          mma_bf16(gRD[vt], ay, b);
          b[0] = ld_pair(&m.ldS[col * LDB + ks + 2 * t4]);
          b[1] = ld_pair(&m.ldS[col * LDB + ks + 2 * t4 + 8]);
          mma_bf16(gKW[vt], av, b);
          b[0] = ld_pair(&m.hdS[col * LDB + ks + 2 * t4]);
          b[1] = ld_pair(&m.hdS[col * LDB + ks + 2 * t4 + 8]);
          mma_bf16(gKW[vt], av, b);
          // B[k = j][n = i] = dS[j][i]: column pairs
          b[0] = ld_col_pair(&m.ldS[(ks + 2 * t4) * LDB + col], LDB);
          b[1] = ld_col_pair(&m.ldS[(ks + 2 * t4 + 8) * LDB + col], LDB);
          mma_bf16(gVs[vt], ah, b);
          b[0] = ld_col_pair(&m.hdS[(ks + 2 * t4) * LDB + col], LDB);
          b[1] = ld_col_pair(&m.hdS[(ks + 2 * t4 + 8) * LDB + col], LDB);
          mma_bf16(gVs[vt], al, b);
          mma_bf16(gVs[vt], ah, b);
        }
      }
    }
    // (j is even and K a multiple of 4: each pair (j, j + 1) lies in [0, K)
    // and its two bf16 are one aligned 4-byte word)
    float col[3][2][2];   // (e3 - e2, e4, du's terms) x vt x the pair's column
#pragma unroll
    for (int vt = 0; vt < 2; ++vt) {
#pragma unroll
      for (int x = 0; x < 2; ++x) col[0][vt][x] = col[1][vt][x] = col[2][vt][x] = 0.f;
      if (vt >= nvt) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = rows[hf], j0 = (vt0 + vt) * 8 + 2 * t4;
        if (j0 >= K) continue;
        float o[3][2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * hf + x, j = j0 + x;
          const float fRF = gRF[vt][e], fKF = gKF[vt][e], fVi = gVi[vt][e];
          const float d = m.sD[t * LDF + j], cs = m.sCs[t * LDF + j], mm = m.vM[j];
          const float tot = m.vTot[j];
          const float rv = to_f(m.sR[t * LDB + j]), kv = to_f(m.sK[t * LDB + j]);
          const float dc = m.vDcur[t], uj = m.vU[j];
          const float ed = expf(d), edm = expf(d - mm), emc = expf(mm - cs);
          const float etc = expf(tot - cs);
          o[0][x] = gRD[vt][e] * ed + fRF * edm + dc * uj * kv;
          o[1][x] = gKW[vt][e] * etc + fKF * emc + dc * uj * rv;
          o[2][x] = gVs[vt][e] + fVi + m.vCur[t] * to_f(m.sY[t * LDB + j]);
          const float e1 = gRD[vt][e] * (rv * ed), e2 = fRF * (rv * edm);
          const float e3 = fKF * (kv * emc), e4 = gKW[vt][e] * (kv * etc);
          ev[vt][e][0] = e1 + e2 - e3 - e4;
          ev[vt][e][1] = -(e1 + e2);
          col[0][vt][x] += e3 - e2;
          col[1][vt][x] += e4;
          col[2][vt][x] += dc * rv * kv;
        }
        const int64_t off = base + (int64_t)t * RS + j0;
        *reinterpret_cast<uint32_t*>(&dr[off]) = pack_bf16(o[0][0], o[0][1]);
        *reinterpret_cast<uint32_t*>(&dk[off]) = pack_bf16(o[1][0], o[1][1]);
        *reinterpret_cast<uint32_t*>(&dv[off]) = pack_bf16(o[2][0], o[2][1]);
      }
    }
    // the column sums over the tile's 16 rows: the eight lanes of a column
    // pair, in a fixed order
#pragma unroll
    for (int y = 0; y < 3; ++y)
#pragma unroll
      for (int vt = 0; vt < 2; ++vt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float v = col[y][vt][x];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          const int j = (vt0 + vt) * 8 + 2 * t4 + x;
          if (g == 0 && vt < nvt && j < K) m.vCol[(y * 4 + rt) * MAXK + j] = v;
        }
  }
  __syncthreads();   // the products are done: g_cs and g_w go over S0 and dS
  if (busy) {
#pragma unroll
    for (int vt = 0; vt < 2; ++vt) {
      if (vt >= nvt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = q0 + g + 8 * (e >> 1), j = (vt0 + vt) * 8 + 2 * t4 + (e & 1);
        if (j >= K) continue;
        m.Gcs[t * LDF + j] = ev[vt][e][0];
        m.Gw[t * LDF + j] = ev[vt][e][1];
      }
    }
  }
  __syncthreads();
  // dw per channel: the reverse cumsum of g_cs with g_total at the last
  // row. Warp w takes 32 channels (w % 2) and a run of c / 8 rows (w / 2):
  // the runs' sums, then each run walked backward from g_total plus the
  // later runs' sums (added in a fixed order); du and the column sums over
  // the row tiles in a fixed order
  const int j = 32 * (warp & 1) + lane, run = warp >> 1, rq = c / GradSmem::RUNS;
  {
    float sum = 0.f;   // (channels past K read columns never written)
    for (int t = run * rq; t < (run + 1) * rq; ++t) sum += m.Gcs[t * LDF + j];
    if (j < K) m.vRun[run * MAXK + j] = sum;
  }
  __syncthreads();
  if (j < K) {
    float gm = 0.f, g4 = 0.f, dua = 0.f;
    for (int q = 0; q < nct; ++q) {
      gm += m.vCol[q * MAXK + j];
      g4 += m.vCol[(4 + q) * MAXK + j];
      dua += m.vCol[(8 + q) * MAXK + j];
    }
    float acc = g4 + expf(m.vTot[j]) * m.vRs[j] + 0.5f * gm;   // g_total, at the last row
    for (int p = GradSmem::RUNS - 1; p > run; --p) acc += m.vRun[p * MAXK + j];
    for (int t = (run + 1) * rq - 1; t >= run * rq; --t) {
      acc += m.Gcs[t * LDF + j];
      float gg = m.Gw[t * LDF + j] + acc;
      if (t == 0) gg -= 0.5f * gm;
      dw[base + (int64_t)t * RS + j] = from_f<TW>(gg);
    }
    if (run == 0) dup[bhj * K + j] = dua;
  }
}

template <typename T, typename TW, bool BF16_INTRA>
int entry(const void* r, const void* k, const void* v, const void* w, const void* u,
          const void* dy, const void* dstate, void* dr, void* dk, void* dv, void* dw, void* du,
          void* ws, int B, int S, int H, int K, int c, int u_per_row, void* stream) {
  if (K <= 0 || K > MAXK || c <= 0 || c > MAXK || (S > 0 && S % c)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || H <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<T, TW, BF16_INTRA, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_kernel<T, TW, BF16_INTRA, false><<<B * H, NT, SMEM, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u, (const T*)dy,
      (const float*)dstate, (T*)dr, (T*)dk, (T*)dv, (TW*)dw, (float*)du, (float*)ws, nullptr, S,
      H, K, c, u_per_row);
  return (int)cudaGetLastError();
}

// the chunked route's three launches: both increments, both state passes,
// every chunk's gradients; du per chunk into dup (B, H, nc, K)
template <typename T, typename TW, bool BF16_INTRA>
int entry_chunked(const void* r, const void* k, const void* v, const void* w, const void* u,
                  const void* dy, const void* dstate, void* dr, void* dk, void* dv, void* dw,
                  void* dup, void* wsf, void* wsb, void* decay, int B, int S, int H, int K,
                  int c, int u_per_row, int vec, void* stream) {
  if (K <= 0 || K > MAXK || K % 4 || c <= 0 || c > MAXK || c % 16 || S <= 0 || S % c) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || H <= 0) return 0;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int nc = S / c;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const dim3 grid(nc, H, B);
  // 1: every chunk's two increments and its decay
  const size_t states_smem = (size_t)c * LDW * (2 * sizeof(float) + 4 * sizeof(T)) +
                             MAXK * sizeof(float);
  err = cudaFuncSetAttribute(wkv_bwd_states_kernel<T, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)states_smem);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_states_kernel<T, TW><<<grid, NT, states_smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const T*)dy, (float*)wsf,
      (float*)wsb, (float*)decay, S, H, K, c, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2: each chunk's starting state and its end state's gradient
  const int rc = chunk_scan::launch_state_passes(
      chunk_scan::StatePass{(float*)wsf, (const float*)decay, nullptr, nullptr, 0},
      chunk_scan::StatePass{(float*)wsb, (const float*)decay, (const float*)dstate, nullptr, 1},
      B * H, nc, K * K, K, st);
  if (rc != 0) return rc;
  // 3: every chunk's gradients
  if constexpr (BF16_INTRA && sizeof(T) == 2) {
    constexpr int smem = GradSmem::BYTES;
    err = cudaFuncSetAttribute(wkv_grad_mma_kernel<TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    wkv_grad_mma_kernel<TW><<<grid, NTG, smem, st>>>(
        (const bf16*)r, (const bf16*)k, (const bf16*)v, (const TW*)w, (const float*)u,
        (const bf16*)dy, (const float*)wsf, (const float*)wsb, (bf16*)dr, (bf16*)dk, (bf16*)dv,
        (TW*)dw, (float*)dup, S, H, K, c, u_per_row, vec);
  } else {
    err = cudaFuncSetAttribute(wkv_bwd_kernel<T, TW, BF16_INTRA, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    wkv_bwd_kernel<T, TW, BF16_INTRA, true><<<grid, NT, SMEM, st>>>(
        (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const float*)u, (const T*)dy,
        nullptr, (T*)dr, (T*)dk, (T*)dv, (TW*)dw, (float*)dup, (float*)wsf, (const float*)wsb,
        S, H, K, c, u_per_row);
  }
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
  }                                                                                          \
  extern "C" int rwkv6_wkv_bwd_chunked_##SUFFIX(                                              \
      const void* r, const void* k, const void* v, const void* w, const void* u,             \
      const void* dy, const void* dstate, void* dr, void* dk, void* dv, void* dw, void* dup, \
      void* wsf, void* wsb, void* decay, int B, int S, int H, int K, int c, int u_per_row,   \
      int vec, void* stream) {                                                               \
    return entry_chunked<T, TW, BF16_INTRA>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, dup,  \
                                            wsf, wsb, decay, B, S, H, K, c, u_per_row, vec,  \
                                            stream);                                         \
  }

WKV_BWD_ENTRY(f32_f32_f32, float, float, false)
WKV_BWD_ENTRY(f32_f32_bf16, float, float, true)
WKV_BWD_ENTRY(f32_bf16_f32, float, __nv_bfloat16, false)
WKV_BWD_ENTRY(f32_bf16_bf16, float, __nv_bfloat16, true)
WKV_BWD_ENTRY(bf16_f32_f32, __nv_bfloat16, float, false)
WKV_BWD_ENTRY(bf16_f32_bf16, __nv_bfloat16, float, true)
WKV_BWD_ENTRY(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, false)
WKV_BWD_ENTRY(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, true)
