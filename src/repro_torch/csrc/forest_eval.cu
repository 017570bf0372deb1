// K1: packed-forest gather descent on Hopper.
//
// Replaces the Pallas kernel repro/kernels/forest_eval/kernel.py
// (forest_eval_pallas, body _forest_kernel). Computes per-tree leaf
// (mean, var), each (T, N), for N candidate rows of X (N, D): `depth`
// rounds of branch-free descent over a packed node arena in which leaves
// carry thr = +inf and point at themselves, so every lane runs the same
// number of rounds and needs no active mask. The compare is the float64
// `x > thr` of the numpy oracle (core/surrogate.py::packed_descend), so
// leaf routing, and therefore (mean, var), is bit-identical.
//
// What bounds it on this card: memory. The outputs alone are
// 2 * T * N * 8 bytes (315 MB at 120 trees x 131072 candidates) and the
// arithmetic is one compare per round. The arena (a few thousand nodes per
// forest, more than the 227 KB a block can hold once 12 sources are fused)
// is read through the read-only cache with __ldg and stays in L2; X rows are
// read at random features, one 8-byte load per round.
//
// Design: one thread per (tree, candidate); blockIdx.y is the tree, so a
// warp descends one tree for 32 neighbouring candidates, the top rounds
// read the same node for the whole warp, and the two output rows are
// written coalesced. Node ids stay int64 as in the reference arena.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void forest_eval_kernel(const int64_t* __restrict__ feat,
                                   const double* __restrict__ thr,
                                   const int64_t* __restrict__ child,
                                   const double* __restrict__ mean,
                                   const double* __restrict__ var,
                                   const int64_t* __restrict__ roots,
                                   const double* __restrict__ X,
                                   double* __restrict__ m_out,
                                   double* __restrict__ v_out,
                                   int N, int D, int depth) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (n >= N) return;
  const double* x = X + (int64_t)n * D;
  int64_t nid = __ldg(roots + t);
  for (int r = 0; r < depth; ++r) {
    const int64_t f = __ldg(feat + nid);
    const int go_right = __ldg(x + f) > __ldg(thr + nid) ? 1 : 0;
    nid = __ldg(child + 2 * nid + go_right);
  }
  const int64_t o = (int64_t)t * N + n;
  m_out[o] = __ldg(mean + nid);
  v_out[o] = __ldg(var + nid);
}

}  // namespace

extern "C" int forest_eval_launch(const void* feat, const void* thr, const void* child,
                                  const void* mean, const void* var, const void* roots,
                                  const void* X, void* m_out, void* v_out,
                                  int T, int N, int D, int depth, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, T);
  forest_eval_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)feat, (const double*)thr, (const int64_t*)child,
      (const double*)mean, (const double*)var, (const int64_t*)roots,
      (const double*)X, (double*)m_out, (double*)v_out, N, D, depth);
  return (int)cudaGetLastError();
}
