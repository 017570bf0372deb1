// K9b: the backward of the grouped expert matmul K9 on Hopper.
//
// Replaces no Pallas kernel: the reference's gmm_pallas
// (repro/kernels/moe_gmm/kernel.py) has no VJP, and the reference's model
// takes the gradients of its expert einsums (repro/models/moe.py:95-101)
// from JAX's autodiff. Training the MoE family through K9 needs the two
// products of its backward, for out = x . w per expert with rows
// c >= group_sizes[e] of out set to 0:
//
//   dx (E, C, D) = dy . w^T, rows c >= group_sizes[e] written as 0;
//   dw (E, D, F) = x^T . dy over the rows c < group_sizes[e] alone.
//
// Rows of x and dy past an expert's group size are never read into a sum
// (the forward wrote 0 there whatever the inputs were), so NaN or a stale
// cotangent there reaches neither output. Sums are float32, outputs in the
// inputs' dtype (bfloat16 or float32). Any E, C, D and F are taken.
//
// What bounds it on this card: operations. At mixtral-8x22b's training
// shapes (E = 8, C = 2560, D = 6144, F = 16384) each product is 4.12e12
// flop, 4.17 ms at the bf16 tensor cores' 989 TFLOP/s, against 0.9 ms of
// bytes. Every operand is read in its stored layout: one expert matrix is
// 1.61 GB, and a layer-step has six of these products, so a transposed copy
// would cost more than the product's bytes.
//
// Routes; kernels/moe_gmm/ops.py picks one (gmm_bwd_route) and plans its
// grid (gmm_bwd_plan):
//
// bfloat16 where TMA can describe every operand (D and F multiples of 8,
// 16-byte aligned bases): K9's persistent prefill pipeline (gmm_tiles.cuh,
// one copy for the three products: 128 x 256 output tiles, 64-deep TMA
// stages, two consumer warpgroups on wgmma m64n256k16) in its DX and DW
// modes, on one of two epilogues:
// - `wgmma_overlap` (gmm_bwd_overlap<0|1>, the route ops picks): the
//   EPI_HALVES epilogue, each tile's sums through a swizzled shared buffer
//   (stmatrix) and TMA stores, so the consumers go on to the next tile's
//   products while the stores drain; tiles in the raster groups that
//   ops.raster_group plans, so that a group's A operand stays in L2. At
//   mixtral's shapes the two products on the register epilogue, of equal
//   flops, differ by about 7.9 us for each tile an SM that dw computes more
//   than dx (186 tiles of 40 k-steps against 29 of 256): the tensor cores
//   idle while a tile is stored.
// - `wgmma` (gmm_bwd_hopper<0|1>, forced only): the epilogue from registers
//   (EPI_REGS), four stages.
// The operands' majorness is taken from the descriptors:
// - dx (MODE 0): M = C, N = D, K = F. dy's tile and w's tile as it lies,
//   (D, F) with F contiguous, are both K-major. dy's rows past the group
//   size reach only their own output row, written as 0.
// - dw (MODE 1): M = D, N = F, K = C, the K loop cut at the group size. x's
//   and dy's tiles, C rows of D or F contiguous columns, are both MN-major;
//   the last stage's rows past the group size are zeroed in shared memory
//   before the products. An expert with no valid row writes zeros.
//
// Otherwise (float32, or bf16 that TMA cannot describe): gmm_bwd_simt<T>,
// one kernel for both products through strides, 64 x 64 tiles, 16-deep
// slabs staged in shared memory along each operand's contiguous axis, each
// thread a 4 x 4 register tile of fmaf (the port builds with --fmad=false,
// so the fused multiply-add is written out; tf32 would miss the float32
// gate), float32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_tiles.cuh"

namespace {

// ------------------------------------------------------------ CUDA cores

constexpr int NT = 256;
constexpr int FM = 64, FN = 64, FK = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// out[e] (M, N) = sum over k < K of A[e][m, k] * B[e][k, n], with A's
// element (m, k) at a + e * a_e + m * a_m + k * a_k and B's (k, n) at
// b + e * b_e + k * b_k + n * b_n. MODE 0 (dx): M = C, rows m >= the group
// size read nothing and are written as 0. MODE 1 (dw): K = C, the sum
// stops at the group size.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT) gmm_bwd_simt(
    const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ gs,
    T* __restrict__ out, int C, int M, int N, int K, int64_t a_e, int64_t a_m, int64_t a_k,
    int64_t b_e, int64_t b_k, int64_t b_n) {
  __shared__ float sA[FM * (FK + 1)];
  __shared__ float sB[FK * FN];

  const int e = blockIdx.z;
  const int r0 = blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const int tid = threadIdx.x;
  const int nv = valid_rows(gs, e, C);
  const int mv = MODE == 0 ? nv : M;  // rows of out that get a sum
  const int kv = MODE == 1 ? nv : K;  // depth of the sum
  T* ob = out + (int64_t)e * M * N;

  if (r0 >= mv || kv == 0) {
    for (int i = tid; i < FM * FN; i += NT) {
      const int r = r0 + i / FN, n = n0 + i % FN;
      if (r < M && n < N) ob[(int64_t)r * N + n] = from_f<T>(0.f);
    }
    return;
  }

  const T* ab = a + (int64_t)e * a_e;
  const T* bb = b + (int64_t)e * b_e;
  const bool a_kfast = a_k == 1, b_nfast = b_n == 1;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty + 16 i, columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv; k0 += FK) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < (FM * FK) / NT; ++v) {
      const int idx = tid + v * NT;  // neighbouring threads along A's contiguous axis
      const int r = a_kfast ? idx / FK : idx % FM, k = a_kfast ? idx % FK : idx / FM;
      const int gr = r0 + r, gk = k0 + k;
      sA[r * (FK + 1) + k] = (gr < mv && gk < kv) ? to_f(ab[gr * a_m + gk * a_k]) : 0.f;
    }
#pragma unroll
    for (int v = 0; v < (FK * FN) / NT; ++v) {
      const int idx = tid + v * NT;
      const int k = b_nfast ? idx / FN : idx % FK, n = b_nfast ? idx % FN : idx / FK;
      const int gk = k0 + k, gn = n0 + n;
      sB[k * FN + n] = (gk < kv && gn < N) ? to_f(bb[gk * b_k + gn * b_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[(ty + 16 * i) * (FK + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k * FN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) ob[(int64_t)r * N + n] = from_f<T>(r < mv ? acc[i][j] : 0.f);
    }
  }
}

// ------------------------------------------- bfloat16: wgmma, TMA, mbarrier

namespace hop {

// MODE 0 (dx): ta over dy, tb over w; out dx (E, C, D). MODE 1 (dw): ta over
// x, tb over dy; out dw (E, D, F).
template <int MODE>
__global__ void __launch_bounds__(NTH, 1) gmm_bwd_hopper(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int E, int C, int D, int F) {
  gmm_tiles<MODE == 0 ? DX : DW>(ta, tb, gs, out, E, C, D, F);
}

// the same with the overlapped epilogue, in raster groups of `group` row
// tiles; `to` maps out (N, M, E)
template <int MODE>
__global__ void __launch_bounds__(NTH, 1) gmm_bwd_overlap(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap to, const int* __restrict__ gs,
    __nv_bfloat16* __restrict__ out, int E, int C, int D, int F, int group) {
  gmm_tiles<MODE == 0 ? DX : DW, EPI_HALVES>(ta, tb, gs, out, E, C, D, F, &to, group);
}

// cudaFuncSetAttribute of `kernel`'s dynamic shared memory on the current
// device, once a device: `done` is the caller's flag for that kernel
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t smem_attr_once(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// MODE's product on the epilogue EPI (EPI_REGS: gmm_bwd_hopper, which walks
// the plain order, `group` 0; EPI_HALVES: gmm_bwd_overlap)
template <int MODE, int EPI>
int launch(const void* p, const void* q, const void* gs, void* out, int E, int C, int D, int F,
           int blocks, int group, cudaStream_t stream) {
  if (!tma_ok(p, q, D, F) || !aligned16(out) || blocks <= 0 || group < 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int rc = encode_tiles<MODE == 0 ? DX : DW>(&ta, &tb, p, q, E, C, D, F);
  if (rc != 0) return rc;
  static bool smem_set[kMaxDevices] = {};  // one flag array per instantiation: one kernel
  if constexpr (EPI == EPI_REGS) {
    cudaError_t err = smem_attr_once(gmm_bwd_hopper<MODE>, PSMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_hopper<MODE><<<blocks, NTH, PSMEM, stream>>>(ta, tb, (const int*)gs,
                                                         (__nv_bfloat16*)out, E, C, D, F);
  } else {
    static_assert(EPI == EPI_HALVES, "gmm_bwd_overlap is built for EPI_HALVES");
    const int M = MODE == 0 ? C : D, N = MODE == 0 ? D : F;
    CUtensorMap to;
    rc = encode_bf16_3d_sw128(&to, out, N, M, E, EPI_BOX);
    if (rc != 0) return rc;
    constexpr int smem = Pipe<EPI>::SMEM;
    cudaError_t err = smem_attr_once(gmm_bwd_overlap<MODE>, smem, smem_set);
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_overlap<MODE><<<blocks, NTH, smem, stream>>>(ta, tb, to, (const int*)gs,
                                                         (__nv_bfloat16*)out, E, C, D, F, group);
  }
  return (int)cudaGetLastError();
}

}  // namespace hop

// the CUDA-core route of either product; checks the planned grid
template <typename T, int MODE>
int launch_simt(const void* p, const void* q, const void* gs, void* out, int E, int C, int D,
                int F, int gx, int gy, int gz, cudaStream_t stream) {
  const int M = MODE == 0 ? C : D, N = MODE == 0 ? D : F, K = MODE == 0 ? F : C;
  dim3 grid((M + FM - 1) / FM, (N + FN - 1) / FN, E);
  if ((int)grid.x != gx || (int)grid.y != gy || (int)grid.z != gz)
    return (int)cudaErrorInvalidConfiguration;
  const int64_t CD = (int64_t)C * D, CF = (int64_t)C * F, DF = (int64_t)D * F;
  if (MODE == 0)  // A = dy (m = c, k = f), B = w^T (k = f, n = d)
    gmm_bwd_simt<T, 0><<<grid, NT, 0, stream>>>((const T*)p, (const T*)q, (const int*)gs,
                                                (T*)out, C, M, N, K, CF, F, 1, DF, 1, F);
  else  // A = x^T (m = d, k = c), B = dy (k = c, n = f)
    gmm_bwd_simt<T, 1><<<grid, NT, 0, stream>>>((const T*)p, (const T*)q, (const int*)gs,
                                                (T*)out, C, M, N, K, CD, 1, D, CF, F, 1);
  return (int)cudaGetLastError();
}

}  // namespace

// dx entries take (dy, w, group_sizes, dx); dw entries (x, dy, group_sizes,
// dw); then E, C, D, F and the grid that ops.gmm_bwd_plan planned, which
// each entry checks, and on the overlap route the plan's raster group.

extern "C" int moe_gmm_bwd_dx_bf16_wgmma_overlap(const void* dy, const void* w, const void* gs,
                                                 void* dx, int E, int C, int D, int F, int gx,
                                                 int gy, int gz, int group, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  if (gy != 1 || gz != 1) return (int)cudaErrorInvalidConfiguration;
  return hop::launch<0, hop::EPI_HALVES>(dy, w, gs, dx, E, C, D, F, gx, group,
                                         (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dw_bf16_wgmma_overlap(const void* x, const void* dy, const void* gs,
                                                 void* dw, int E, int C, int D, int F, int gx,
                                                 int gy, int gz, int group, void* stream) {
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  if (gy != 1 || gz != 1) return (int)cudaErrorInvalidConfiguration;
  return hop::launch<1, hop::EPI_HALVES>(x, dy, gs, dw, E, C, D, F, gx, group,
                                         (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dx_bf16_wgmma(const void* dy, const void* w, const void* gs, void* dx,
                                         int E, int C, int D, int F, int gx, int gy, int gz,
                                         void* stream) {
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  if (gy != 1 || gz != 1) return (int)cudaErrorInvalidConfiguration;
  return hop::launch<0, hop::EPI_REGS>(dy, w, gs, dx, E, C, D, F, gx, 0, (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dw_bf16_wgmma(const void* x, const void* dy, const void* gs, void* dw,
                                         int E, int C, int D, int F, int gx, int gy, int gz,
                                         void* stream) {
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  if (gy != 1 || gz != 1) return (int)cudaErrorInvalidConfiguration;
  return hop::launch<1, hop::EPI_REGS>(x, dy, gs, dw, E, C, D, F, gx, 0, (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dx_bf16_simt(const void* dy, const void* w, const void* gs, void* dx,
                                        int E, int C, int D, int F, int gx, int gy, int gz,
                                        void* stream) {
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  return launch_simt<__nv_bfloat16, 0>(dy, w, gs, dx, E, C, D, F, gx, gy, gz,
                                       (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dw_bf16_simt(const void* x, const void* dy, const void* gs, void* dw,
                                        int E, int C, int D, int F, int gx, int gy, int gz,
                                        void* stream) {
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  return launch_simt<__nv_bfloat16, 1>(x, dy, gs, dw, E, C, D, F, gx, gy, gz,
                                       (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dx_f32(const void* dy, const void* w, const void* gs, void* dx, int E,
                                  int C, int D, int F, int gx, int gy, int gz, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  return launch_simt<float, 0>(dy, w, gs, dx, E, C, D, F, gx, gy, gz, (cudaStream_t)stream);
}

extern "C" int moe_gmm_bwd_dw_f32(const void* x, const void* dy, const void* gs, void* dw, int E,
                                  int C, int D, int F, int gx, int gy, int gz, void* stream) {
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  return launch_simt<float, 1>(x, dy, gs, dw, E, C, D, F, gx, gy, gz, (cudaStream_t)stream);
}
