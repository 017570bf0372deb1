// Building blocks of the chunked scans' backward kernels (K12b,
// csrc/rwkv6_wkv_bwd.cu; K8b, csrc/mamba2_ssd_bwd.cu): a 4 x 4 patch of a
// small product on the CUDA cores, read from shared memory through
// accessors, and the sum of a value over the 16 threads that share a row of
// patches.
//
// A block of 256 threads covers a 64 x 64 output with one patch a thread:
// thread t takes rows 4 (t / 16) .. + 3 and columns 4 (t % 16) .. + 3, so
// the 16 threads of a row of patches are one half of a warp. Taller outputs
// (K8b's 128-row chunks) take the next 64 rows in a second pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_bwd {

constexpr int NT = 256;

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// acc[a][b] += sum over p in [p0, p1) of X(i0 + a, p) * Y(p, j0 + b), in
// the order of p, as fmaf
template <class FX, class FY>
__device__ __forceinline__ void patch(float (&acc)[4][4], int i0, int j0, int p0, int p1,
                                      FX X, FY Y) {
#pragma unroll 2
  for (int p = p0; p < p1; ++p) {
    float xa[4], yb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xa[a] = X(i0 + a, p);
#pragma unroll
    for (int b = 0; b < 4; ++b) yb[b] = Y(p, j0 + b);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
  }
}

// the sum of v over the 16 threads of this thread's half warp, in a fixed
// order (so the same on every run)
__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

}  // namespace scan_bwd
