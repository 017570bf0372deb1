// Building blocks of the chunk-parallel scans (K8, csrc/mamba2_ssd.cu; K12,
// csrc/rwkv6_wkv.cu): dtype conversions, the bf16 mma.sync m16n8k16
// tensor-core product and its fragment loads from shared memory, tile
// copies with 16-byte loads and cp.async, and the state passes between the
// chunks (forward for the scans, reverse for their backward, K8b and K12b).
//
// mma.sync m16n8k16 (row.col, bf16 operands, float32 sums), lane = 4 g + t:
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8):             b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   D (16 x 8):             d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1];
// the lower 16 bits of each register hold the element of the lower index.
// So a D fragment of two neighbouring 8-column tiles is, packed in pairs, the
// A fragment of the next product over those 16 columns (a0 = d0, d1 of the
// first tile, a1 = d2, d3, a2 and a3 the same of the second).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chunk_scan {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as a bf16 pair, lo in the lower 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
// p[0], p[1] of a row (p 4-byte aligned)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// p[0] and p[ld]: two neighbouring rows of a column
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[ld]) << 16);
}

template <typename D, typename T> __device__ __forceinline__ D conv(T v);
template <> __device__ __forceinline__ float conv<float, float>(float v) { return v; }
template <> __device__ __forceinline__ float conv<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 conv<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 conv<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// rows x cols of src (row stride ld elements) into dst (row stride ldd),
// converted to D, by nt threads; with vec, 16-byte loads (the caller has
// checked that cols, ld and src are 16-byte multiples). Each thread issues
// U loads before it stores any, so that their latencies overlap.
template <typename T, typename D>
__device__ __forceinline__ void load_tile(D* dst, int ldd, const T* __restrict__ src, int64_t ld,
                                          int rows, int cols, bool vec, int tid, int nt) {
  constexpr int U = 4;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = cols / V, n = rows * vpr;
    for (int e0 = tid; e0 < n; e0 += U * nt) {
      uint4 u[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int e = e0 + i * nt;
        if (e < n) {
          const int r = e / vpr;
          u[i] = *reinterpret_cast<const uint4*>(src + (int64_t)r * ld + (e - r * vpr) * V);
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int e = e0 + i * nt;
        if (e < n) {
          const int r = e / vpr, cv = (e - r * vpr) * V;
          const T* pv = reinterpret_cast<const T*>(&u[i]);
#pragma unroll
          for (int j = 0; j < V; ++j) dst[r * ldd + cv + j] = conv<D, T>(pv[j]);
        }
      }
    }
  } else {
    const int n = rows * cols;
    for (int e0 = tid; e0 < n; e0 += 4 * U * nt) {
      T v[4 * U];
#pragma unroll
      for (int i = 0; i < 4 * U; ++i) {
        const int e = e0 + i * nt;
        if (e < n) {
          const int r = e / cols;
          v[i] = src[(int64_t)r * ld + e - r * cols];
        }
      }
#pragma unroll
      for (int i = 0; i < 4 * U; ++i) {
        const int e = e0 + i * nt;
        if (e < n) {
          const int r = e / cols;
          dst[r * ldd + e - r * cols] = conv<D, T>(v[i]);
        }
      }
    }
  }
}

// 16 bytes from device memory to shared memory without a register stop
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// close the group of this thread's cp.async copies issued so far; wait
// until at most N groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four neighbouring values of a shared-memory row as floats (p 16-byte
// aligned for float, 8-byte for bf16)
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}

// rows x cols of src (row stride ld) into dst (row stride ldd) of the same
// type, by nt threads: with vec, as cp.async copies of 16 bytes that the
// caller waits for with cp_async_wait_all (cols, ld, ldd, src and dst
// 16-byte multiples); else element by element through registers
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ldd, const T* __restrict__ src, int64_t ld,
                                          int rows, int cols, bool vec, int tid, int nt) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = cols / V;
    for (int e = tid; e < rows * vpr; e += nt) {
      const int r = e / vpr, cv = (e - r * vpr) * V;
      cp_async16(dst + r * ldd + cv, src + (int64_t)r * ld + cv);
    }
  } else {
    load_tile(dst, ldd, src, ld, rows, cols, false, tid, nt);
  }
}

// The state passes. A pass walks, for each of the n_rows rows of nc chunks
// of per_chunk float32 values in ws (row-major (n_rows, nc, per_chunk)), h
// = decay * h + inc over the chunks, a multiply and then an add, from h =
// h0 (n_rows, per_chunk; zero where h0 is null), overwriting each chunk's
// slot with h before its update, and writes the last h to hout (n_rows,
// per_chunk) where hout is not null. forward (reverse = 0) walks the chunks
// in order, so each slot ends as its chunk's starting state (the scans'
// forward); reverse walks them from the last, so each slot ends as the
// gradient of its chunk's end state (the backward's dS, with h0 the final
// state's gradient). The decay of value i of a chunk is decay[row, chunk, i
// / per_decay] (decay (n_rows, nc, per_chunk / per_decay)).
struct StatePass {
  float* ws;
  const float* decay;
  const float* h0;
  float* hout;
  int reverse;
};

// a thread takes four neighbouring values (per_decay a multiple of 4) as
// float4 and issues the loads of U chunks before it stores any;
// blockIdx.y picks the pass (one launch may run both)
__global__ void __launch_bounds__(256) state_pass_kernel(StatePass fwd, StatePass bwd, int n_rows,
                                                         int nc, int per_chunk, int per_decay) {
  const StatePass p = blockIdx.y ? bwd : fwd;
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= (int64_t)n_rows * per_chunk) return;
  const int64_t row = e / per_chunk;
  const int i = (int)(e - row * per_chunk);
  const int nd = per_chunk / per_decay;
  float* w = p.ws + row * nc * per_chunk + i;
  const float* d = p.decay + row * nc * nd + i / per_decay;
  float4 h = p.h0 ? *reinterpret_cast<const float4*>(p.h0 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int U = 8;
  for (int j0 = 0; j0 < nc; j0 += U) {
    float4 inc[U];
    float dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < nc) {
        const int64_t j = p.reverse ? nc - 1 - (j0 + u) : j0 + u;
        inc[u] = *reinterpret_cast<const float4*>(w + j * per_chunk);
        dv[u] = d[j * nd];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < nc) {
        const int64_t j = p.reverse ? nc - 1 - (j0 + u) : j0 + u;
        *reinterpret_cast<float4*>(w + j * per_chunk) = h;
        h.x = dv[u] * h.x + inc[u].x;
        h.y = dv[u] * h.y + inc[u].y;
        h.z = dv[u] * h.z + inc[u].z;
        h.w = dv[u] * h.w + inc[u].w;
      }
    }
  }
  if (p.hout) *reinterpret_cast<float4*>(p.hout + e) = h;
}

// bwd.ws null: the forward pass alone. per_chunk and per_decay multiples of
// 4; every buffer from the allocator (16-byte aligned)
inline int launch_state_passes(StatePass fwd, StatePass bwd, int n_rows, int nc, int per_chunk,
                               int per_decay, cudaStream_t stream) {
  if (per_chunk % 4 || per_decay % 4) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)n_rows * per_chunk / 4;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + 255) / 256), bwd.ws ? 2 : 1);
  state_pass_kernel<<<grid, 256, 0, stream>>>(fwd, bwd, n_rows, nc, per_chunk, per_decay);
  return (int)cudaGetLastError();
}

// the scans' forward: each chunk's starting state, the final state to hout
inline int launch_state_pass(float* ws, const float* decay, float* hout, int n_rows, int nc,
                             int per_chunk, int per_decay, cudaStream_t stream) {
  return launch_state_passes(StatePass{ws, decay, nullptr, hout, 0},
                             StatePass{nullptr, nullptr, nullptr, nullptr, 1}, n_rows, nc,
                             per_chunk, per_decay, stream);
}

}  // namespace chunk_scan
