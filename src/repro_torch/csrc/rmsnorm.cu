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
// - K10 (rmsnorm_fwd_resident: D a multiple of 8, 16-byte aligned x and
//   out, at most 8192 columns in bf16 and 4096 in float32): a persistent
//   grid of 256-thread blocks, as many as fit the SMs at once, a warp per
//   row. A block stages w in shared memory as float32 once; each warp walks
//   rows warp, warp + all the grid's warps, ... and holds its row in
//   registers as loaded (NV 16-byte vectors a lane, NV a template argument
//   of 4 to 32 picked by width), so the row is read from device memory
//   once: all of a row's loads are issued before its sum of squares, and
//   each vector of the next row is loaded as soon as this row's vector is
//   stored, so one row's stores overlap the next row's loads.
// - K10 (rmsnorm_fwd_two_pass: any other row, and the first design, kept
//   for timing the two side by side): one warp per row, eight rows per
//   256-thread block. Each lane reads eight elements at a time (one 16-byte
//   load in bf16, two in float32) when D is a multiple of 8 and the rows are
//   16-byte aligned, else one element at a time; the sum of squares is a
//   shuffle reduction, and the second pass, which writes out, reads the row
//   again (from L2, where the rows of all the warps in flight do not fit
//   L1) and reloads w for each row.
// - K11 (rmsnorm_bwd_cluster, D <= 8192): each 128-row tile is split by
//   columns over a thread-block cluster of ceil(D / 1024) blocks (at most 8,
//   the portable cluster size), so the training shape (8192 x 4096) runs
//   256 blocks on the 132 SMs where one block per tile ran 64; at 128
//   registers two blocks share an SM, so they all run at once. The tile is
//   walked in chunks of 16 rows. For each chunk every block reduces its
//   slice's share of sum(dxhat * xhat) for each row (a warp per row, two
//   rows a warp, several 16-byte loads of each in flight) into shared
//   memory; after a cluster barrier, 16 threads add the cluster's shares
//   read through distributed shared memory in rank order; then each thread
//   owns eight columns (a 16-byte vector) and half the chunk's rows, writes
//   dx and sums its columns' dw partial in registers. The chunk's rows are
//   read twice, the second time from L2: a chunk of every block in flight
//   is about 16 MB at the training shape, inside the 50 MB L2, so device
//   memory sees x and dout about once. The two halves' dw partials are
//   added in shared memory at the end, with no atomics.
// - K11 (rmsnorm_bwd_tile, D > 8192, and PR 15's design, kept for timing
//   the two side by side): one block per tile of up to 128 rows. First each
//   warp reduces mean(dxhat * xhat) for its sixteen rows into shared
//   memory; then each thread owns eight columns (or one, unvectorised),
//   walks the tile's rows, writes dx and sums its columns' dw partial in
//   registers. The rows are read twice.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block, both kernels
constexpr int WARPS = NT / 32;
constexpr int TILE = 128;  // K11 rows of a dw partial (ref.py's ROWS)
constexpr int RC = 16;       // K11 cluster route: rows a chunk
constexpr int SLICE = 1024;  // K11 cluster route: columns a block at most
constexpr int MAX_CLUSTER = 8;

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

// eight consecutive elements at p (16-byte aligned) kept as loaded, read
// back as float32 one at a time: a bf16 vector holds four registers, not
// eight, while its load is in flight
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const float4& v = i < 4 ? a : b;
    const int j = i & 3;
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const int k = i >> 1;
    const uint32_t v = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
    return __uint_as_float(i & 1 ? v & 0xffff0000u : v << 16);
  }
};

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

// a row in registers: NV 16-byte vectors a lane, vector i of lane l at
// columns 8 * (l + 32 i) .. + 7 (a float32 vector is two 16-byte loads)
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_fwd_resident(const T* __restrict__ x,
                                                           const W* __restrict__ w,
                                                           T* __restrict__ out,
                                                           float* __restrict__ rstd, int N,
                                                           int D, float eps) {
  extern __shared__ float s_w[];  // D
  const int lane = threadIdx.x & 31;
  const int nvec = D >> 3;
  const int64_t step = (int64_t)gridDim.x * WARPS;
  int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  Raw8<T> r[NV];
  if (row < N) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) r[i].load(x + row * D + 8 * (lane + 32 * i));
    }
  }
  for (int c = threadIdx.x; c < D; c += NT) s_w[c] = to_f(w[c]);
  __syncthreads();
  for (; row < N; row += step) {  // warp-uniform
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = r[i][e];
          ss += f * f;
        }
      }
    }
    ss = warp_sum(ss);
    const float rs = rsqrtf(ss / (float)D + eps);
    if (lane == 0) rstd[row] = rs;
    const int64_t next = row + step;
    T* orow = out + row * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < D) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = r[i][e] * rs * s_w[c + e];
        store8(orow + c, f);
        if (next < N) r[i].load(x + next * D + c);
      }
    }
  }
}

// ------------------------------------------------------------------ K11

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_tile(
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

// the blocks of a cluster that split D columns, and each one's width (a
// multiple of 8, so that 16-byte vectors never straddle two slices)
__host__ __device__ __forceinline__ int bwd_slices(int D) {
  const int cs = (D + SLICE - 1) / SLICE;
  return cs < 1 ? 1 : (cs > MAX_CLUSTER ? MAX_CLUSTER : cs);
}
__host__ __device__ __forceinline__ int bwd_slice_width(int D) {
  const int cs = bwd_slices(D);
  return ((D + cs - 1) / cs + 7) / 8 * 8;
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT, 2) rmsnorm_bwd_cluster(
    const T* __restrict__ x, const W* __restrict__ w, const float* __restrict__ rstd,
    const T* __restrict__ dout, T* __restrict__ dx, float* __restrict__ parts, int N, int D,
    int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float s_part[2][RC];  // this slice's share of each row's sum, by chunk parity
  __shared__ float s_mean[RC], s_rs[RC];
  __shared__ __align__(16) float s_dw[NT / 2 * 8];

  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t tile = blockIdx.x / cs;
  const int sw = bwd_slice_width(D);
  const int c_lo = rank * sw, c_hi = min(D, c_lo + sw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = tid / (NT / 2), tv = tid % (NT / 2);
  const int64_t r0 = tile * TILE;
  const int64_t left = (int64_t)N - r0;
  const int nr = left < TILE ? (int)left : TILE;

  // pass 2's columns: one vector of eight (or, unvectorised, eight columns
  // 128 apart), and their dw partials
  constexpr int PV = 8;
  auto col = [&](int i) { return vec ? c_lo + 8 * tv + i : c_lo + tv + (NT / 2) * i; };
  float acc[PV];
#pragma unroll
  for (int i = 0; i < PV; ++i) acc[i] = 0.f;
  // pass 1 reads device memory: a lane keeps U1 vectors of each of its two
  // rows in flight (a float32 vector is twice a bf16 one, so the same
  // bytes); pass 2 re-reads the chunk from L2, GR rows at a time. Both fit
  // 128 registers, two blocks an SM.
  constexpr int U1 = sizeof(T) == 2 ? 2 : 1;
  constexpr int GR = 2;

  for (int ch = 0; ch * RC < nr; ++ch) {
    const int buf = ch & 1;
    const int64_t cr0 = r0 + ch * RC;                 // the chunk's first row
    const int rcn = min(RC, nr - ch * RC);            // its rows
    // pass 1: this slice's share of sum(dxhat * xhat), a warp per row
    float dot[RC / WARPS], rsj[RC / WARPS];
#pragma unroll
    for (int j = 0; j < RC / WARPS; ++j) {
      const int rr = warp + WARPS * j;
      dot[j] = 0.f;
      rsj[j] = rr < rcn ? rstd[cr0 + rr] : 0.f;
    }
    if (vec) {
      for (int c0 = c_lo + lane * 8; c0 < c_hi; c0 += 32 * 8 * U1) {
        Raw8<T> fx[U1][RC / WARPS], fd[U1][RC / WARPS];
#pragma unroll
        for (int u = 0; u < U1; ++u) {
          const int c = c0 + 32 * 8 * u;
#pragma unroll
          for (int j = 0; j < RC / WARPS; ++j) {
            const int rr = warp + WARPS * j;
            if (rr < rcn && c < c_hi) {
              fx[u][j].load(x + (cr0 + rr) * D + c);
              fd[u][j].load(dout + (cr0 + rr) * D + c);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U1; ++u) {
          const int c = c0 + 32 * 8 * u;
          if (c >= c_hi) continue;
          Raw8<W> gw;
          gw.load(w + c);
#pragma unroll
          for (int j = 0; j < RC / WARPS; ++j) {
            const int rr = warp + WARPS * j;
            if (rr < rcn) {
#pragma unroll
              for (int i = 0; i < 8; ++i)
                dot[j] += (fd[u][j][i] * gw[i]) * (fx[u][j][i] * rsj[j]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RC / WARPS; ++j) {
        const int rr = warp + WARPS * j;
        if (rr >= rcn) continue;
        const float rs = rsj[j];
        const T* xr = x + (cr0 + rr) * D;
        const T* dr = dout + (cr0 + rr) * D;
        for (int c = c_lo + lane; c < c_hi; c += 32)
          dot[j] += (to_f(dr[c]) * to_f(w[c])) * (to_f(xr[c]) * rs);
      }
    }
#pragma unroll
    for (int j = 0; j < RC / WARPS; ++j) {
      const float v = warp_sum(dot[j]);
      if (lane == 0) s_part[buf][warp + WARPS * j] = v;
    }
    // every slice's shares are written; the other parity's buffer was last
    // read before this barrier's previous round
    cluster.sync();
    if (tid < RC) {
      float tot = 0.f;
      for (int q = 0; q < cs; ++q) tot += cluster.map_shared_rank(&s_part[buf][0], q)[tid];
      s_mean[tid] = tot / (float)D;
      s_rs[tid] = tid < rcn ? rstd[cr0 + tid] : 0.f;
    }
    __syncthreads();

    // pass 2: dx for this thread's columns over its half of the chunk's
    // rows, GR rows' loads in flight at a time
    constexpr int HR = RC / 2;
    if (vec) {
      const int c = col(0);
      if (c < c_hi) {
        Raw8<W> fw;
        fw.load(w + c);
        for (int g0 = 0; g0 < HR; g0 += GR) {
          Raw8<T> fx[GR], fd[GR];
#pragma unroll
          for (int j = 0; j < GR; ++j) {
            const int rr = half * HR + g0 + j;
            if (rr < rcn) {
              fx[j].load(x + (cr0 + rr) * D + c);
              fd[j].load(dout + (cr0 + rr) * D + c);
            }
          }
#pragma unroll
          for (int j = 0; j < GR; ++j) {
            const int rr = half * HR + g0 + j;
            if (rr < rcn) {
              const float rs = s_rs[rr], mt = s_mean[rr];
              float o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float xhat = fx[j][i] * rs;
                acc[i] += fd[j][i] * xhat;
                o[i] = rs * (fd[j][i] * fw[i] - xhat * mt);
              }
              store8(dx + (cr0 + rr) * D + c, o);
            }
          }
        }
      }
    } else {
      for (int j = 0; j < HR; ++j) {
        const int rr = half * HR + j;
        if (rr >= rcn) break;
        const float rs = s_rs[rr], mt = s_mean[rr];
#pragma unroll
        for (int i = 0; i < PV; ++i) {
          if (col(i) >= c_hi) continue;
          const int64_t off = (cr0 + rr) * D + col(i);
          const float xhat = to_f(x[off]) * rs;
          const float fd = to_f(dout[off]);
          acc[i] += fd * xhat;
          dx[off] = from_f<T>(rs * (fd * to_f(w[col(i)]) - xhat * mt));
        }
      }
    }
  }

  // the two halves' dw partials, added in shared memory: rows 0-7 of each
  // chunk plus rows 8-15
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < PV; ++i) s_dw[tv * PV + i] = acc[i];
  }
  __syncthreads();
  if (half == 0) {
    float* prow = parts + tile * D;
#pragma unroll
    for (int i = 0; i < PV; ++i)
      if (col(i) < c_hi) prow[col(i)] = acc[i] + s_dw[tv * PV + i];
  }
  // no block leaves while another of its cluster may read its s_part
  cluster.sync();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T, typename W>
int fwd_two_pass_entry(const void* x, const void* w, void* out, void* rstd, int N, int D, float eps,
              void* stream) {
  if (N <= 0 || D <= 0) return 0;
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  rmsnorm_fwd_kernel<T, W><<<(N + WARPS - 1) / WARPS, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const W*)w, (T*)out, (float*)rstd, N, D, eps, vec);
  return (int)cudaGetLastError();
}

// K10's resident route: the widest row it holds (ops.py's RESIDENT_MAX_D)
template <typename T>
constexpr int resident_max_d() { return 32 * 32 * 8 / (int)(sizeof(T) / 2); }

template <typename T, typename W, int NV>
int fwd_resident_launch(const void* x, const void* w, void* out, void* rstd, int N, int D,
                        float eps, cudaStream_t st) {
  // blocks that fit the card at once, per device, for a block's largest w
  static int grid_cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int cap = dev < 64 ? grid_cap[dev] : 0;
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_fwd_resident<T, W, NV>, NT, (size_t)NV * 32 * 8 * sizeof(float));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cap = (per_sm > 0 ? per_sm : 1) * sms;
    if (dev < 64) grid_cap[dev] = cap;
  }
  const int64_t want = ((int64_t)N + WARPS - 1) / WARPS;
  const int grid = (int)(want < cap ? want : cap);
  rmsnorm_fwd_resident<T, W, NV><<<grid, NT, (size_t)D * sizeof(float), st>>>(
      (const T*)x, (const W*)w, (T*)out, (float*)rstd, N, D, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int fwd_resident_entry(const void* x, const void* w, void* out, void* rstd, int N, int D,
                       float eps, void* stream) {
  if (D <= 0 || D % 8 || D > resident_max_d<T>() || !aligned16(x) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = (D / 8 + 31) / 32;  // 16-byte vectors of bf16 (32 bytes in float32)
  if (per_lane <= 4) return fwd_resident_launch<T, W, 4>(x, w, out, rstd, N, D, eps, st);
  if (per_lane <= 8) return fwd_resident_launch<T, W, 8>(x, w, out, rstd, N, D, eps, st);
  if (per_lane <= 16) return fwd_resident_launch<T, W, 16>(x, w, out, rstd, N, D, eps, st);
  if constexpr (sizeof(T) == 2) {
    if (per_lane <= 24) return fwd_resident_launch<T, W, 24>(x, w, out, rstd, N, D, eps, st);
    return fwd_resident_launch<T, W, 32>(x, w, out, rstd, N, D, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

int bwd_vec(const void* x, const void* w, const void* dout, void* dx, void* parts, int D) {
  return D % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(dout) && aligned16(dx) &&
         aligned16(parts);
}

template <typename T, typename W>
int bwd_tile_entry(const void* x, const void* w, const void* rstd, const void* dout, void* dx,
                   void* parts, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  const int vec = bwd_vec(x, w, dout, dx, parts, D);
  rmsnorm_bwd_tile<T, W><<<(N + TILE - 1) / TILE, NT, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const W*)w, (const float*)rstd, (const T*)dout, (T*)dx, (float*)parts, N,
      D, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int bwd_cluster_entry(const void* x, const void* w, const void* rstd, const void* dout, void* dx,
                      void* parts, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (D > MAX_CLUSTER * SLICE) return (int)cudaErrorInvalidValue;
  const int vec = bwd_vec(x, w, dout, dx, parts, D);
  const int cs = bwd_slices(D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cs * ((N + TILE - 1) / TILE)));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_cluster<T, W>, (const T*)x,
                                       (const W*)w, (const float*)rstd, (const T*)dout, (T*)dx,
                                       (float*)parts, N, D, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// rmsnorm_fwd_* is K10's resident route (rows that fit in registers),
// rmsnorm_fwd_two_pass_* the first design (any other row, and timing);
// ops.rmsnorm_fwd_route picks. rmsnorm_bwd_* is the cluster route (D <=
// 8192), rmsnorm_bwd_tile_* the first one-block-a-tile design (D > 8192, and
// timing); ops.rmsnorm_bwd_route picks.
#define RMSNORM_ENTRIES(SUFFIX, T, W)                                                          \
  extern "C" int rmsnorm_fwd_##SUFFIX(const void* x, const void* w, void* out, void* rstd,    \
                                      int N, int D, float eps, void* stream) {                \
    return fwd_resident_entry<T, W>(x, w, out, rstd, N, D, eps, stream);                      \
  }                                                                                            \
  extern "C" int rmsnorm_fwd_two_pass_##SUFFIX(const void* x, const void* w, void* out,       \
                                               void* rstd, int N, int D, float eps,           \
                                               void* stream) {                                 \
    return fwd_two_pass_entry<T, W>(x, w, out, rstd, N, D, eps, stream);                      \
  }                                                                                            \
  extern "C" int rmsnorm_bwd_##SUFFIX(const void* x, const void* w, const void* rstd,         \
                                      const void* dout, void* dx, void* parts, int N, int D,   \
                                      void* stream) {                                          \
    return bwd_cluster_entry<T, W>(x, w, rstd, dout, dx, parts, N, D, stream);                \
  }                                                                                            \
  extern "C" int rmsnorm_bwd_tile_##SUFFIX(const void* x, const void* w, const void* rstd,    \
                                           const void* dout, void* dx, void* parts, int N,     \
                                           int D, void* stream) {                              \
    return bwd_tile_entry<T, W>(x, w, rstd, dout, dx, parts, N, D, stream);                   \
  }

RMSNORM_ENTRIES(f32_f32, float, float)
RMSNORM_ENTRIES(f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRIES(bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRIES(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
