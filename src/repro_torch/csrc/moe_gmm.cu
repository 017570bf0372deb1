// K9: grouped expert matmul on Hopper.
//
// Replaces the Pallas kernel repro/kernels/moe_gmm/kernel.py (gmm_pallas,
// body _gmm_kernel). Computes, for x (E, C, D) and w (E, D, F) of one dtype
// (bfloat16 or float32), out[e, c, :] = x[e, c, :] . w[e] summed in float32
// and written in x's dtype, with rows c >= group_sizes[e] written as 0
// (group_sizes may be null: every row is valid). Any E, C, D and F are taken;
// the ragged edges are masked here.
//
// What bounds it on this card: operations at the MoE prefill, bytes at
// decode. At mixtral-8x22b's first layer with 1 x 8192 tokens a call
// multiplies (8, 2560, 6144) by (8, 6144, 16384): 4.12e12 flop, 4.2 ms at
// the bf16 tensor cores' 989 TFLOP/s against 0.8 ms of bytes. At decode
// (C = 16) the 1.61 GB of expert weights take 0.48 ms at 3.35 TB/s and the
// products almost nothing.
//
// Design. One block per (tile of rows, tile of columns, expert); the row
// tiles are the fastest grid index, so the blocks that share one column
// tile of w run together and read it from device memory about once. D is
// streamed in slabs through shared memory; the next slab is loaded into
// registers while the current one is multiplied. A block whose rows all lie
// past the expert's group size (or past C) writes zeros and skips its loop;
// rows past the group size read no input.
// - bfloat16: 128 x 128 tiles, 32-deep slabs, 8 warps each owning a 64 x 32
//   patch, mma.sync m16n8k16 on the tensor cores (bf16 products are exact in
//   float32; the sums are float32). A warp skips the 16-row groups of its
//   patch that hold no valid row, so decode (C = 16) runs one of them.
// - float32: 64 x 64 tiles, 16-deep slabs, each thread a 4 x 4 register tile
//   of fmaf on the CUDA cores (the port builds with --fmad=false, so the
//   fused multiply-add is written out).
// wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, both kernels

__device__ __forceinline__ int valid_rows(const int* gs, int e, int C) {
  if (gs == nullptr) return C;
  return max(0, min(gs[e], C));
}

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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int moe_gmm_bf16(const void* x, const void* w, const void* gs, void* out, int E,
                            int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  dim3 grid((C + HM - 1) / HM, (F + HN - 1) / HN, E);
  const int vec = aligned16(x) && aligned16(w);
  gmm_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)gs, (__nv_bfloat16*)out, C,
      D, F, vec);
  return (int)cudaGetLastError();
}

extern "C" int moe_gmm_f32(const void* x, const void* w, const void* gs, void* out, int E, int C,
                           int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  dim3 grid((C + FM - 1) / FM, (F + FN - 1) / FN, E);
  gmm_f32_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)gs, (float*)out, C, D, F);
  return (int)cudaGetLastError();
}
