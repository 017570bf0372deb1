// K1: packed-forest descent on Hopper.
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
// 2 * T * N * 8 bytes (252 MB at 120 trees x 131072 candidates), X is read
// once (63 MB there) and the arithmetic is one compare per round. At the
// tuner's shapes (a few hundred trees, 256 candidates or fewer) the work
// is a few microseconds: the latency of `depth` dependent lookups a lane.
//
// Two routes (kernels/forest_eval/ops.py::forest_plan picks one):
//
// `tiled` (forest_eval_tiled). The arena is renumbered into 16-byte records
// {double thr; int32 feat; int32 left} with siblings side by side (right =
// left + 1), grouped by tree (ops.py::pack_nodes), so a round is one
// record load and one X load, both from shared memory. The grid is
// (candidate tile, tree group): a block stages its tile of X (rows at an
// odd stride of doubles, or twice an odd one where 16-byte copies need
// aligned rows, so a warp's 32 rows spread over the banks when they read
// one feature), its group's records and tree entries once, every copy in
// flight at once (cp.async) and at least 256 threads to issue them, then
// thread (lane, row) walks
// trees lane, lane + lanes, ... of the group for its candidate, four side
// by side so their dependent lookups overlap, each for the tree's own
// number of levels (after which every lane sits on a leaf). A warp holds
// 32 neighbouring candidates of one tree: the top rounds read one record
// for the whole warp, and the two output rows are stored coalesced.
//
// `gather` (forest_eval_kernel), the first design: one thread per (tree,
// candidate), blockIdx.y the tree, the arena read through the read-only
// cache with three dependent loads a round (feature, X at it beside the
// threshold, then the child). It takes what the tiled route refuses.

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

constexpr int kBatch = 4;  // trees a thread walks side by side

// nodes: (R) records as int4 {thr lo, thr hi, feat, left}; stats: (R)
// {mean, var}; trees: (T + 1) {first record, levels}. Shared memory: the
// X tile (rows * xstride doubles, padded to 16 bytes), the group's
// records, then the group's tree entries.
__global__ void forest_eval_tiled(const int4* __restrict__ nodes,
                                  const double2* __restrict__ stats,
                                  const int2* __restrict__ trees,
                                  const double* __restrict__ X,
                                  double* __restrict__ m_out,
                                  double* __restrict__ v_out,
                                  int T, int N, int D, int depth, int rows, int xstride,
                                  int group, int lanes, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * rows;
  const int nrows = min(rows, N - n0);
  const int t0 = blockIdx.y * group;
  const int t1 = min(T, t0 + group);
  const int rec0 = __ldg(&trees[t0].x);
  const int nrec = __ldg(&trees[t1].x) - rec0;
  double* xs = reinterpret_cast<double*>(smem);
  int4* ns = reinterpret_cast<int4*>(smem + (((size_t)rows * xstride + 1) / 2) * 16);
  int2* ts = reinterpret_cast<int2*>(ns + nrec);

  // every copy in flight at once: a warp a row of X (coalesced; 16 bytes a
  // copy where rows allow), the records and tree entries spread over the
  // block, which has threads enough to issue them quickly
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const double* xg = X + (int64_t)n0 * D;
  if (vec) {
    for (int r = warp; r < nrows; r += warps)
      for (int c = 2 * lane; c < D; c += 64)
        cp_async16(xs + r * xstride + c, xg + (int64_t)r * D + c);
  } else {
    for (int r = warp; r < nrows; r += warps)
      for (int c = lane; c < D; c += 32)
        cp_async8(xs + r * xstride + c, xg + (int64_t)r * D + c);
  }
  for (int i = tid; i < nrec; i += blockDim.x) cp_async16(ns + i, nodes + rec0 + i);
  for (int i = tid; i < t1 - t0; i += blockDim.x) cp_async8(ts + i, trees + t0 + i);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int row = tid % rows;
  if (tid >= rows * lanes || row >= nrows) return;
  const double* x = xs + row * xstride;
  const int64_t col = n0 + row;
  // trees tid / rows + k * lanes of the group, kBatch at a time: their
  // walks are independent, so their loads overlap
  for (int tb = tid / rows; tb < t1 - t0; tb += kBatch * lanes) {
    int nid[kBatch], rounds[kBatch];
    int most = 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = tb + b * lanes;
      const int2 info = t < t1 - t0 ? ts[t] : make_int2(rec0, 0);
      nid[b] = info.x - rec0;
      rounds[b] = t < t1 - t0 ? min(depth, info.y) : 0;
      most = max(most, rounds[b]);
    }
    for (int r = 0; r < most; ++r) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (r < rounds[b]) {
          const int4 rec = ns[nid[b]];
          nid[b] = rec.w - rec0 + (x[rec.z] > __hiloint2double(rec.y, rec.x) ? 1 : 0);
        }
      }
    }
    double2 s[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (tb + b * lanes < t1 - t0) s[b] = __ldg(stats + rec0 + nid[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = tb + b * lanes;
      if (t < t1 - t0) {
        m_out[(int64_t)(t0 + t) * N + col] = s[b].x;
        v_out[(int64_t)(t0 + t) * N + col] = s[b].y;
      }
    }
  }
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

extern "C" int forest_eval_tiled_launch(const void* nodes, const void* stats, const void* trees,
                                        const void* X, void* m_out, void* v_out,
                                        int T, int N, int D, int depth, int rows, int xstride,
                                        int group, int lanes, int threads, int vec, int smem,
                                        void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (rows <= 0 || rows % 32 || group <= 0 || lanes <= 0 || rows * lanes > threads ||
      threads > 1024 || threads % 32 || xstride < D || (vec && (D % 2 || xstride % 2)))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // per call: the attribute is the current device's
    const cudaError_t e = cudaFuncSetAttribute(
        forest_eval_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + rows - 1) / rows, (T + group - 1) / group);
  forest_eval_tiled<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int4*)nodes, (const double2*)stats, (const int2*)trees, (const double*)X,
      (double*)m_out, (double*)v_out, T, N, D, depth, rows, xstride, group, lanes, vec);
  return (int)cudaGetLastError();
}
