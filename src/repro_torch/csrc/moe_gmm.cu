// K9: grouped expert matmul on Hopper.
//
// Replaces the Pallas kernel repro/kernels/moe_gmm/kernel.py (gmm_pallas,
// body _gmm_kernel). Computes, for x (E, C, D) and w (E, D, F) of one dtype
// (bfloat16 or float32), out[e, c, :] = x[e, c, :] . w[e] summed in float32
// and written in x's dtype, with rows c >= group_sizes[e] written as 0
// (group_sizes may be null: every row is valid). Any E, C, D and F are taken.
//
// What bounds it on this card: operations at the MoE prefill, bytes at
// decode. At mixtral-8x22b's first layer with 1 x 8192 tokens a call
// multiplies (8, 2560, 6144) by (8, 6144, 16384): 4.12e12 flop, 4.2 ms at
// the bf16 tensor cores' 989 TFLOP/s against 0.8 ms of bytes. At decode
// (C = 16) the 1.61 GB of expert weights take 0.48 ms at 3.35 TB/s and the
// products almost nothing.
//
// Four routes; kernels/moe_gmm/ops.py picks one by dtype, shape and
// alignment (gmm_route) and passes the grid it plans (gmm_plan):
//
// bfloat16 where TMA can describe both operands (D and F multiples of 8,
// x and w 16-byte aligned): wgmma and TMA, built from hopper.cuh.
// - gmm_prefill_hopper (C > 64): gmm_tiles.cuh's persistent pipeline, which
//   K9b's backward shares, in its FWD mode: one block an SM walking 128 x
//   256 output tiles, row tiles fastest, so the blocks at work at one time
//   share a few column blocks of w and one expert's x; a producer warpgroup
//   keeping four 64-deep stages in flight, x's 128 x 64 tile (K-major A)
//   and w's 64 x 256 tile as it lies (MN-major B), each from a 3-D tensor
//   map (D, C, E) or (F, D, E) that zero-fills past C, D and F inside each
//   expert; two consumer warpgroups on wgmma m64n256k16.
// - gmm_decode_hopper (C <= 64): the operands swapped, out^T = w^T . x^T,
//   so F fills wgmma's 64 rows and the C <= 64 token rows are its N (16, 32
//   or 64): no tile is mostly empty rows. A block takes 128 columns of w
//   of one expert over the whole of D, two consumer warpgroups of 64, w's
//   64 x 128 tile the MN-major A and x's N x 64 tile the K-major B, in as
//   many stages as let two blocks share an SM (six at N = 16): what
//   matters here is keeping w's bytes in flight.
// - bf16 products are exact in float32 and the sums are float32, so no
//   hi + lo split is needed (unlike K4-K6).
// - Rows past the group size lie inside the tile's box and are loaded, but
//   a row of x reaches only its own output row, which is written as 0. A
//   tile (prefill) or block (decode) with no valid row loads nothing and
//   writes zeros.
//
// bfloat16 otherwise (D or F not a multiple of 8, or an unaligned base):
// gmm_bf16_kernel, the design of the first port, one block per (128 rows,
// 128 columns, expert) tile, 32-deep slabs staged through registers,
// mma.sync m16n8k16, any shape. Also exported as moe_gmm_bf16_mma for
// timing it beside the wgmma routes.
//
// float32: gmm_f32_kernel, 64 x 64 tiles, 16-deep slabs, each thread a 4 x
// 4 register tile of fmaf on the CUDA cores (tf32 would miss the 2e-5
// gate; the port builds with --fmad=false, so the fused multiply-add is
// written out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tiles.cuh"

namespace {

constexpr int NT = 256;  // threads per block, both kernels

// ---------------------------------------------------------------- bfloat16

constexpr int HM = 128, HN = 128, HK = 32;
constexpr int SA = HK + 8;  // sA row stride in halves (80 bytes: 16-aligned, conflict-free)
constexpr int SB = HN + 8;  // sB row stride in halves (272 bytes)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 consecutive bf16 from row-major src (row stride ld), zero where row >=
// rows or col >= cols; one 16-byte load when vec (ld, col and the base are
// 8-element aligned).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int64_t ld, int row, int col,
                                       int rows, int cols, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return r;
  const __nv_bfloat16* p = src + (int64_t)row * ld + col;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  unsigned short h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = col + i < cols ? __bfloat16_as_ushort(p[i]) : (unsigned short)0;
  }
  r.x = h[0] | ((uint32_t)h[1] << 16);
  r.y = h[2] | ((uint32_t)h[3] << 16);
  r.z = h[4] | ((uint32_t)h[5] << 16);
  r.w = h[6] | ((uint32_t)h[7] << 16);
  return r;
}

__global__ void __launch_bounds__(NT) gmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int C, int D, int F, int vec) {
  __shared__ __align__(16) __nv_bfloat16 sA[HM * SA];
  __shared__ __align__(16) __nv_bfloat16 sB[HK * SB];

  const int e = blockIdx.z;
  const int r0 = blockIdx.x * HM;
  const int n0 = blockIdx.y * HN;
  const int tid = threadIdx.x;
  const int nv = valid_rows(gs, e, C);
  __nv_bfloat16* ob = out + (int64_t)e * C * F;

  if (r0 >= nv) {  // no valid row in this tile
    const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
    for (int i = tid; i < HM * HN; i += NT) {
      const int r = r0 + i / HN, n = n0 + i % HN;
      if (r < C && n < F) ob[(int64_t)r * F + n] = z;
    }
    return;
  }

  const __nv_bfloat16* xb = x + (int64_t)e * C * D;
  const __nv_bfloat16* wb = w + (int64_t)e * D * F;
  const bool vx = vec && (D % 8 == 0);
  const bool vw = vec && (F % 8 == 0);
  const int rows_here = min(nv - r0, HM);  // valid rows of this tile, >= 1

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64;  // warp's rows within the tile
  const int wn = (warp & 3) * 32;   // warp's columns within the tile
  const int g = lane >> 2, t = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // per thread: two 8-wide vectors of the A slab and two of the B slab
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * NT;
      const int ar = idx >> 2, ak = (idx & 3) * 8;  // A: 128 rows x 4 vectors
      ra[v] = load8(xb, D, r0 + ar, k0 + ak, r0 + rows_here, D, vx);
      const int bk = idx >> 4, bn = (idx & 15) * 8;  // B: 32 rows x 16 vectors
      rb[v] = load8(wb, F, k0 + bk, n0 + bn, D, F, vw);
    }
  };

  const int n_slabs = (D + HK - 1) / HK;
  if (n_slabs > 0) fetch(0);
  for (int s = 0; s < n_slabs; ++s) {
    __syncthreads();  // the previous slab is consumed
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * NT;
      *reinterpret_cast<uint4*>(&sA[(idx >> 2) * SA + (idx & 3) * 8]) = ra[v];
      *reinterpret_cast<uint4*>(&sB[(idx >> 4) * SB + (idx & 15) * 8]) = rb[v];
    }
    __syncthreads();
    if (s + 1 < n_slabs) fetch((s + 1) * HK);

#pragma unroll
    for (int ks = 0; ks < HK; ks += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + g;
        const unsigned short* b = reinterpret_cast<const unsigned short*>(sB);
        bf[j][0] = b[(ks + 2 * t) * SB + col] | ((uint32_t)b[(ks + 2 * t + 1) * SB + col] << 16);
        bf[j][1] = b[(ks + 2 * t + 8) * SB + col] |
                   ((uint32_t)b[(ks + 2 * t + 9) * SB + col] << 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + i * 16;
        if (row >= rows_here) continue;  // warp-uniform: no valid row in this group
        const uint32_t* a32 = reinterpret_cast<const uint32_t*>(sA);
        uint32_t af[4];
        af[0] = a32[((row + g) * SA + ks + 2 * t) >> 1];
        af[1] = a32[((row + g + 8) * SA + ks + 2 * t) >> 1];
        af[2] = a32[((row + g) * SA + ks + 2 * t + 8) >> 1];
        af[3] = a32[((row + g + 8) * SA + ks + 2 * t + 8) >> 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + i * 16 + g + 8 * h;
      if (r >= C) continue;
      const bool ok = r < nv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (n + q < F) {
            ob[(int64_t)r * F + n + q] = __float2bfloat16_rn(ok ? acc[i][j][2 * h + q] : 0.f);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(NT) gmm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ gs,
    float* __restrict__ out, int C, int D, int F) {
  __shared__ float sA[FM * (FK + 1)];
  __shared__ float sB[FK * FN];

  const int e = blockIdx.z;
  const int r0 = blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const int tid = threadIdx.x;
  const int nv = valid_rows(gs, e, C);
  float* ob = out + (int64_t)e * C * F;

  if (r0 >= nv) {
    for (int i = tid; i < FM * FN; i += NT) {
      const int r = r0 + i / FN, n = n0 + i % FN;
      if (r < C && n < F) ob[(int64_t)r * F + n] = 0.f;
    }
    return;
  }

  const float* xb = x + (int64_t)e * C * D;
  const float* wb = w + (int64_t)e * D * F;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16 i, columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += FK) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < (FM * FK) / NT; ++v) {
      const int idx = tid + v * NT;
      const int r = idx / FK, k = idx % FK;
      const int gr = r0 + r, gk = k0 + k;
      sA[r * (FK + 1) + k] = (gr < nv && gk < D) ? xb[(int64_t)gr * D + gk] : 0.f;
    }
#pragma unroll
    for (int v = 0; v < (FK * FN) / NT; ++v) {
      const int idx = tid + v * NT;
      const int k = idx / FN, n = idx % FN;
      const int gk = k0 + k, gn = n0 + n;
      sB[k * FN + n] = (gk < D && gn < F) ? wb[(int64_t)gk * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * (FK + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k * FN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) ob[(int64_t)r * F + n] = r < nv ? acc[i][j] : 0.f;
    }
  }
}

// ------------------------------------------- bfloat16: wgmma, TMA, mbarrier

namespace hop {

// ---- prefill: gmm_tiles.cuh's persistent 128 x 256 tiles, x . w

__global__ void __launch_bounds__(NTH, 1) gmm_prefill_hopper(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int E, int C, int D, int F) {
  gmm_tiles<FWD>(tx, tw, gs, out, E, C, D, F);
}

// ---- decode: out^T = w^T . x^T, 128 columns of w a block

constexpr int SF = 128;  // columns of F a block: two consumer warpgroups of 64

template <int NC>
struct Swap {
  static constexpr int W_BYTES = (SF / 64) * ATOM;  // w: 64 K rows x 128 columns
  static constexpr int X_BYTES = NC * 128;          // x: NC rows x 64 K
  static constexpr int STAGE = W_BYTES + X_BYTES;   // a multiple of 1024
  // two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
  static constexpr int STAGES = (114 * 1024 - 1024 - 1024 - 128) / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 8 * 2 * STAGES;
  static_assert(STAGE % 1024 == 0 && STAGES >= 3 && 2 * (SMEM + 1024) <= 228 * 1024,
                "decode stages must fit two blocks an SM");
};

template <int NC>
__global__ void __launch_bounds__(NTH, 2) gmm_decode_hopper(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  using S = Swap<NC>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + S::STAGES * S::STAGE;
  auto sW = [&](int s) { return base + s * S::STAGE; };
  auto sX = [&](int s) { return base + s * S::STAGE + S::W_BYTES; };
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (S::STAGES + s); };

  const int e = blockIdx.y, f0 = blockIdx.x * SF;
  const int nv = valid_rows(gs, e, C);
  const int kb_n = (D + BK - 1) / BK;
  __nv_bfloat16* ob = out + (int64_t)e * C * F;
  if (nv == 0) {  // no valid row in this expert: zeros, nothing loaded
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < C * (SF / 8); i += NTH) {
      const int r = i / (SF / 8), c = f0 + (i % (SF / 8)) * 8;
      if (c < F) *reinterpret_cast<uint4*>(ob + (int64_t)r * F + c) = z;
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tw);
      for (int kb = 0; kb < kb_n; ++kb) {
        const int s = kb % S::STAGES;
        mbar_wait(empty(s), ((kb / S::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), S::STAGE);
#pragma unroll
        for (int a = 0; a < SF / 64; ++a)
          tma_load_3d(sW(s) + a * ATOM, &tw, full(s), f0 + 64 * a, kb * BK, e);
        tma_load_3d(sX(s), &tx, full(s), kb * BK, 0, e);
      }
    }
    return;
  }

  const int cw = wg - 1;  // this warpgroup's 64 columns of w
  const int tq = threadIdx.x % 128, warp = tq / 32, lane = tq % 32;
  float acc[NC / 2];
  for (int kb = 0; kb < kb_n; ++kb) {
    const int s = kb % S::STAGES;
    mbar_wait(full(s), (kb / S::STAGES) & 1);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_ss_t<NC, 1, 0>(acc, desc_sw128(sW(s) + cw * ATOM + ks * K16, ATOM, 1024),
                           desc_sw128(sX(s) + ks * 32, 16, 1024), kb > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (kb > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((kb - 1) % S::STAGES));
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // acc[4i + {0,1}]: w column fa, token rows 8i + 2 (lane % 4) + {0,1};
  // acc[4i + {2,3}]: column fa + 8
  const int fa = f0 + 64 * cw + 16 * warp + lane / 4, fb = fa + 8;
#pragma unroll
  for (int i = 0; i < NC / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * i + 2 * (lane % 4) + h;
      if (r >= C) continue;
      const bool ok = r < nv;
      if (fa < F) ob[(int64_t)r * F + fa] = __float2bfloat16_rn(ok ? acc[4 * i + h] : 0.f);
      if (fb < F) ob[(int64_t)r * F + fb] = __float2bfloat16_rn(ok ? acc[4 * i + 2 + h] : 0.f);
    }
  }
}

int launch_prefill(const void* x, const void* w, const void* gs, void* out, int E, int C, int D,
                   int F, int blocks, cudaStream_t stream) {
  if (!tma_ok(x, w, D, F) || blocks <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const int rc = encode_tiles<FWD>(&tx, &tw, x, w, E, C, D, F);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(gmm_prefill_hopper,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, PSMEM);
  if (err != cudaSuccess) return (int)err;
  gmm_prefill_hopper<<<blocks, NTH, PSMEM, stream>>>(tx, tw, (const int*)gs, (__nv_bfloat16*)out,
                                                     E, C, D, F);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_decode_n(const void* x, const void* w, const void* gs, void* out, int E, int C, int D,
                    int F, cudaStream_t stream) {
  using S = Swap<NC>;
  CUtensorMap tx, tw;
  int rc = encode_bf16_3d_sw128(&tx, x, D, C, E, NC);
  if (rc == 0) rc = encode_bf16_3d_sw128(&tw, w, F, D, E, BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(gmm_decode_hopper<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + SF - 1) / SF, E);
  gmm_decode_hopper<NC><<<grid, NTH, S::SMEM, stream>>>(tx, tw, (const int*)gs,
                                                        (__nv_bfloat16*)out, C, D, F);
  return (int)cudaGetLastError();
}

int launch_decode(const void* x, const void* w, const void* gs, void* out, int E, int C, int D,
                  int F, cudaStream_t stream) {
  if (!tma_ok(x, w, D, F) || C > 64) return (int)cudaErrorInvalidValue;
  if (C <= 16) return launch_decode_n<16>(x, w, gs, out, E, C, D, F, stream);
  if (C <= 32) return launch_decode_n<32>(x, w, gs, out, E, C, D, F, stream);
  return launch_decode_n<64>(x, w, gs, out, E, C, D, F, stream);
}

}  // namespace hop

}  // namespace

// Each entry takes the grid that ops.gmm_plan planned and refuses any other,
// so the host's plan and the kernel's tiling cannot drift apart.

extern "C" int moe_gmm_bf16_wgmma(const void* x, const void* w, const void* gs, void* out, int E,
                                  int C, int D, int F, int gx, int gy, int gz, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (gy != 1 || gz != 1) return (int)cudaErrorInvalidConfiguration;
  return hop::launch_prefill(x, w, gs, out, E, C, D, F, gx, (cudaStream_t)stream);
}

extern "C" int moe_gmm_bf16_wgmma_decode(const void* x, const void* w, const void* gs, void* out,
                                         int E, int C, int D, int F, int gx, int gy, int gz,
                                         void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (gx != (F + hop::SF - 1) / hop::SF || gy != E || gz != 1)
    return (int)cudaErrorInvalidConfiguration;
  return hop::launch_decode(x, w, gs, out, E, C, D, F, (cudaStream_t)stream);
}

extern "C" int moe_gmm_bf16_mma(const void* x, const void* w, const void* gs, void* out, int E,
                                int C, int D, int F, int gx, int gy, int gz, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  dim3 grid((C + HM - 1) / HM, (F + HN - 1) / HN, E);
  if ((int)grid.x != gx || (int)grid.y != gy || (int)grid.z != gz)
    return (int)cudaErrorInvalidConfiguration;
  const int vec = aligned16(x) && aligned16(w);
  gmm_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)gs, (__nv_bfloat16*)out, C,
      D, F, vec);
  return (int)cudaGetLastError();
}

extern "C" int moe_gmm_f32(const void* x, const void* w, const void* gs, void* out, int E, int C,
                           int D, int F, int gx, int gy, int gz, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  dim3 grid((C + FM - 1) / FM, (F + FN - 1) / FN, E);
  if ((int)grid.x != gx || (int)grid.y != gy || (int)grid.z != gz)
    return (int)cudaErrorInvalidConfiguration;
  gmm_f32_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)gs, (float*)out, C, D, F);
  return (int)cudaGetLastError();
}
