// K10 and K11: the fused RMSNorm forward and backward on Hopper.
//
// Replaces the Pallas kernels repro/kernels/rmsnorm/kernel.py
// (rmsnorm_fwd_pallas, body _fwd_kernel; rmsnorm_bwd_pallas, body
// _bwd_kernel). For rows x (N, D) in bfloat16 or float32 and a gain w (D,)
// in either type:
// - K10: rstd = rsqrtf(mean(x^2) + eps) per row and out = x * rstd * w, in
//   float32, out written in x's dtype, rstd (N,) in float32;
// - K11: with xhat = x * rstd and dxhat = do * w, dx = rstd * (dxhat - xhat *
//   mean(dxhat * xhat)) in x's dtype (the Pallas body's order), and one
//   float32 dw partial row per tile of 128 rows, the sum of do * xhat over
//   the tile's rows; the caller sums the partials, as the reference does
//   outside its Pallas call.
// Any N and D are taken; the reference halves its row block until it
// divides N, here the edges are masked.
//
// What bounds them on this card: bytes. At the rwkv6-7b prefill (8192 x
// 4096 bf16) K10 reads and writes 134 MB, 0.04 ms at 3.35 TB/s, against a
// few flop a byte.
//
// Design.
// - K10: one warp per row, eight rows per 256-thread block. Each lane reads
//   eight elements at a time (one 16-byte load in bf16, two in float32) when
//   D is a multiple of 8 and the rows are 16-byte aligned, else one element
//   at a time; the sum of squares is a shuffle reduction, and the second
//   pass, which writes out, reads the row again from L1/L2.
// - K11: one block per tile of up to 128 rows. First each warp reduces
//   mean(dxhat * xhat) for its sixteen rows into shared memory; then each
//   thread owns eight columns (or one, unvectorised), walks the tile's rows,
//   writes dx and sums its columns' dw partial in registers, so no atomics
//   and no reduction across threads are needed. The rows are read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block, both kernels
constexpr int WARPS = NT / 32;
constexpr int TILE = 128;  // K11 rows per block (ref.py's ROWS)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// eight consecutive elements at p (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ K10

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_fwd_kernel(const T* __restrict__ x,
                                                         const W* __restrict__ w,
                                                         T* __restrict__ out,
                                                         float* __restrict__ rstd, int N, int D,
                                                         float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;  // warp-uniform
  const T* xr = x + row * D;
  T* orow = out + row * D;

  float ss = 0.f;
  if (vec) {
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float f = to_f(xr[c]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float rs = rsqrtf(ss / (float)D + eps);
  if (lane == 0) rstd[row] = rs;

  if (vec) {
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float f[8], g[8];
      load8(xr + c, f);
      load8(w + c, g);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] * rs * g[i];
      store8(orow + c, f);
    }
  } else {
    for (int c = lane; c < D; c += 32) orow[c] = from_f<T>(to_f(xr[c]) * rs * to_f(w[c]));
  }
}

// ------------------------------------------------------------------ K11

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const float* __restrict__ rstd,
    const T* __restrict__ dout, T* __restrict__ dx, float* __restrict__ parts, int N, int D,
    int vec) {
  __shared__ float s_rstd[TILE];
  __shared__ float s_mean[TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * TILE;
  const int64_t left = (int64_t)N - r0;
  const int nr = left < TILE ? (int)left : TILE;

  // mean(dxhat * xhat) of each row, a warp per row
  for (int r = warp; r < nr; r += WARPS) {
    const T* xr = x + (r0 + r) * D;
    const T* dr = dout + (r0 + r) * D;
    const float rs = rstd[r0 + r];
    float dot = 0.f;
    if (vec) {
      for (int c = lane * 8; c < D; c += 32 * 8) {
        float fx[8], fd[8], fw[8];
        load8(xr + c, fx);
        load8(dr + c, fd);
        load8(w + c, fw);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot += (fd[i] * fw[i]) * (fx[i] * rs);
      }
    } else {
      for (int c = lane; c < D; c += 32) dot += (to_f(dr[c]) * to_f(w[c])) * (to_f(xr[c]) * rs);
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      s_rstd[r] = rs;
      s_mean[r] = dot / (float)D;
    }
  }
  __syncthreads();

  float* prow = parts + (int64_t)blockIdx.x * D;
  if (vec) {
    for (int c = tid * 8; c < D; c += NT * 8) {
      float fw[8], acc[8];
      load8(w + c, fw);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int r = 0; r < nr; ++r) {
        const int64_t off = (r0 + r) * D + c;
        const float rs = s_rstd[r], mt = s_mean[r];
        float fx[8], fd[8];
        load8(x + off, fx);
        load8(dout + off, fd);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xhat = fx[i] * rs;
          acc[i] += fd[i] * xhat;
          fx[i] = rs * (fd[i] * fw[i] - xhat * mt);
        }
        store8(dx + off, fx);
      }
      store8(prow + c, acc);
    }
  } else {
    for (int c = tid; c < D; c += NT) {
      const float fw = to_f(w[c]);
      float acc = 0.f;
      for (int r = 0; r < nr; ++r) {
        const int64_t off = (r0 + r) * D + c;
        const float rs = s_rstd[r];
        const float xhat = to_f(x[off]) * rs;
        const float fd = to_f(dout[off]);
        acc += fd * xhat;
        dx[off] = from_f<T>(rs * (fd * fw - xhat * s_mean[r]));
      }
      prow[c] = acc;
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T, typename W>
int fwd_entry(const void* x, const void* w, void* out, void* rstd, int N, int D, float eps,
              void* stream) {
  if (N <= 0 || D <= 0) return 0;
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  rmsnorm_fwd_kernel<T, W><<<(N + WARPS - 1) / WARPS, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const W*)w, (T*)out, (float*)rstd, N, D, eps, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int bwd_entry(const void* x, const void* w, const void* rstd, const void* dout, void* dx,
              void* parts, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(dout) &&
                  aligned16(dx) && aligned16(parts);
  rmsnorm_bwd_kernel<T, W><<<(N + TILE - 1) / TILE, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const W*)w, (const float*)rstd, (const T*)dout, (T*)dx, (float*)parts, N,
      D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

#define RMSNORM_ENTRIES(SUFFIX, T, W)                                                        \
  extern "C" int rmsnorm_fwd_##SUFFIX(const void* x, const void* w, void* out, void* rstd,  \
                                      int N, int D, float eps, void* stream) {              \
    return fwd_entry<T, W>(x, w, out, rstd, N, D, eps, stream);                             \
  }                                                                                          \
  extern "C" int rmsnorm_bwd_##SUFFIX(const void* x, const void* w, const void* rstd,       \
                                      const void* dout, void* dx, void* parts, int N, int D, \
                                      void* stream) {                                        \
    return bwd_entry<T, W>(x, w, rstd, dout, dx, parts, N, D, stream);                      \
  }

RMSNORM_ENTRIES(f32_f32, float, float)
RMSNORM_ENTRIES(f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRIES(bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
