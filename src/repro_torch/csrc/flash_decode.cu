// K7: split-KV decode attention on Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_decode/kernel.py
// (flash_decode_pallas, body _decode_kernel, and the jnp combine after it).
// For one query token: q (B, Hkv, G, D), the cache k, v (B, S, Hkv, D) in
// the model's layout, read where it lies, and lengths (B,): the keys are cut
// into splits; each split walks its keys with an online softmax in float32
// (q upcast and scaled by 1/sqrt(D), keys at or past the row's length
// scored -1e30) and keeps an unnormalised partial o with its running max m
// and sum l; the partials of each (b, h) are merged by the log-sum-exp
// algebra, o = sum_s exp(m_s - m) o_s / max(sum_s exp(m_s - m) l_s, 1e-30),
// and o is written in q's dtype. A row of length 0 keeps m = -1e30, so
// every p is exp(0) = 1 and the row gets the mean of V over the whole
// cache, as the reference does. A row of length len > 0 reads only its
// first len keys: a split with no key below len keeps (m, l, o) = (-1e30,
// 0, 0), which the merge weighs by exp(-1e30 - m) = 0, as it weighs the
// reference's partial of that split.
//
// What bounds it on this card: bytes. A decode step needs each row's first
// len keys of the cache (all S for len = 0) once and does 4 flop a needed
// cache element for each query row (at llama3-8b with 4 rows of 4096 keys,
// 8 KV heads of 128 in bf16: 67 MB, 0.020 ms at 3.35 TB/s; at zamba2-2.7b,
// 32 KV heads of 80: 168 MB, 0.050 ms).
//
// Two routes; kernels/flash_decode/ops.py picks one (decode_route) and, for
// the ring route, plans its splits on the host (ring_plan):
//
// - ring (D a multiple of 8, 16-byte aligned bases): decode_ring, a
//   (B * Hkv, splits, ceil(G / GB)) grid of 128-thread blocks, the split
//   count chosen from S, B * Hkv and the SM count: the longest splits (a
//   power-of-two number of tiles) that still give every SM a block (8
//   splits of 512 keys for llama3-8b's 32 (b, h) pairs at 4096 keys, 2 of
//   2048 for zamba2-2.7b's 128): on the card that measured faster than
//   twice the splits, which pay each block's start and the merge twice as
//   often (scripts/flash_decode_variants.py). A block takes 48 KB of
//   shared memory at most in bf16, so four share an SM. The
//   block walks 32-key tiles of K and V; each warp copies its own 8 keys of
//   every tile through a three-stage cp.async ring (16-byte copies straight
//   from the cache's strided rows, past the split's end zero-filled), so
//   two tiles are in flight while one is scored, and reads only those, so
//   the warps meet at no barrier until the end. Its GB <= 8 query rows sit
//   in registers:
//   L lanes share a key (L = 16 for D > 64, 8 for D > 32, else 4), each
//   lane holding one 8-element chunk of D, so a warp scores 32 / L keys at
//   once and sums each q . k across its L lanes with shuffles. Each group of
//   L lanes runs its own online softmax over its keys with P . V in
//   registers, on the CUDA cores in float32 (at G <= 8 decode does 4 flop a
//   cache byte, which wgmma's 64-row tiles would mostly waste). The groups
//   merge by shuffles, the warps through shared memory, and the splits in
//   the same launch: the last block of each (b, h) to finish, counted by
//   an atomic counter that it sets back to 0, merges the splits' partials.
//   One split writes o directly.
// - scalar (any D <= 128, any alignment; the first design): decode_partial
//   stages 32 keys of K and V at a time in shared memory as float32, one
//   element a load, and scores them one thread a (row, key) walking D in
//   shared memory, with the reference's split count; decode_combine, a
//   second launch, merges the splits.
//
// Products are written as fmaf (the port builds with --fmad=false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int TK = 32;      // keys a tile: one per lane of a warp
constexpr int GMAX = 8;     // query rows a block
constexpr int DMAX = 128;   // ops.py's MAX_D
constexpr int NR = GMAX * DMAX / NT;  // accumulator elements a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_floats(int G, int D) {
  return (size_t)G * D + (size_t)TK * (D + 1) + (size_t)TK * D + (size_t)G * TK + 3 * GMAX;
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int Hkv, int S, int Gall, int D, int split, float scale) {
  extern __shared__ float smem[];
  const int g0 = blockIdx.z * GMAX;            // this block's query rows: g0 .. g0 + G - 1
  const int G = min(GMAX, Gall - g0);
  const int DP = D + 1;
  float* sQ = smem;               // G x D, scaled
  float* sK = sQ + G * D;         // TK x (D + 1)
  float* sV = sK + TK * DP;       // TK x D
  float* sP = sV + TK * D;        // G x TK: scores, then p
  float* sM = sP + G * TK;        // running max a row
  float* sL = sM + GMAX;          // running sum a row
  float* sCorr = sL + GMAX;       // this tile's correction a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, si = blockIdx.y, splits = gridDim.y;
  const int b = bh / Hkv, hh = bh % Hkv;
  const int len = lengths[b];
  const int64_t RS = (int64_t)Hkv * D;                    // between keys
  const int64_t kvb = (int64_t)b * S * RS + (int64_t)hh * D;
  const T* qb = q + ((int64_t)bh * Gall + g0) * D;

  for (int e = tid; e < G * D; e += NT) sQ[e] = to_f(qb[e]) * scale;
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  const int s_end = (si + 1) * split;
  for (int t0 = si * split; t0 < s_end && (len <= 0 || t0 < len); t0 += TK) {
    const int nk = min(TK, s_end - t0);
    __syncthreads();  // the previous tile is consumed; sQ, sM and sL are set
    for (int e = tid; e < nk * D; e += NT) {
      const int j = e / D, d = e % D;
      const int64_t off = kvb + (int64_t)(t0 + j) * RS + d;
      sK[j * DP + d] = to_f(k[off]);
      sV[j * D + d] = to_f(v[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * TK; e += NT) {
      const int g = e / TK, j = e % TK;
      if (j >= nk) continue;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[j * DP + d], s);
      sP[g * TK + j] = t0 + j < len ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NT / 32) {
      const float s = lane < nk ? sP[g * TK + lane] : -INFINITY;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mt);
      const float p = lane < nk ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < nk) sP[g * TK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
        sCorr[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = tid + NT * r;
      if (e >= G * D) break;
      const int g = e / D, d = e % D;
      float pv = 0.f;
      for (int j = 0; j < nk; ++j) pv = fmaf(sP[g * TK + j], sV[j * D + d], pv);
      acc[r] = acc[r] * sCorr[g] + pv;
    }
  }
  __syncthreads();
  const int64_t part = (int64_t)bh * splits + si;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int e = tid + NT * r;
    if (e < G * D) o_part[(part * Gall + g0) * D + e] = acc[r];
  }
  if (tid < G) {
    m_part[part * Gall + g0 + tid] = sM[tid];
    l_part[part * Gall + g0 + tid] = sL[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_combine(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ o, int G, int D, int splits) {
  const int bh = blockIdx.x;
  for (int e = threadIdx.x; e < G * D; e += NT) {
    const int g = e / D;
    const float* mb = m_part + (int64_t)bh * splits * G + g;
    const float* lb = l_part + (int64_t)bh * splits * G + g;
    float m_all = mb[0];
    for (int s = 1; s < splits; ++s) m_all = fmaxf(m_all, mb[(int64_t)s * G]);
    float denom = 0.f, num = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float corr = expf(mb[(int64_t)s * G] - m_all);
      denom += corr * lb[(int64_t)s * G];
      num += o_part[((int64_t)bh * splits + s) * G * D + e] * corr;
    }
    store_as(o + (int64_t)bh * G * D + e, num / fmaxf(denom, 1e-30f));
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* lengths, void* o_part,
          void* m_part, void* l_part, void* o, int B, int Hkv, int S, int G, int D, int splits,
          void* stream) {
  if (G <= 0 || D <= 0 || D > DMAX || S <= 0 || splits <= 0 || S % splits || splits > 65535 ||
      (G + GMAX - 1) / GMAX > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hkv <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the reference scales by float32(1 / np.sqrt(D)), rounded from double
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t smem = smem_floats(min(G, GMAX), D) * sizeof(float);  // at most 38 KB
  dim3 grid(B * Hkv, splits, (G + GMAX - 1) / GMAX);
  decode_partial<T><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                            (const int*)lengths, (float*)o_part, (float*)m_part,
                                            (float*)l_part, Hkv, S, G, D, S / splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<B * Hkv, NT, 0, st>>>((const float*)o_part, (const float*)m_part,
                                            (const float*)l_part, (T*)o, G, D, splits);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- ring route

constexpr int RT = 128;              // threads a ring block: 4 warps
constexpr int RWARPS = RT / 32;
constexpr int RTK = 32;              // keys a ring stage (ops.py's RING_TILE)
constexpr int RSTAGES = 3;           // stages of each warp's cp.async ring
constexpr int RKW = RTK / RWARPS;    // keys a warp scores in each stage
constexpr int RGB = 8;               // query rows a block at most (ops.py's RING_ROWS)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared memory, or zeros where bytes == 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// lanes that share a key: one 8-element chunk of D each
template <typename T>
constexpr int ring_lanes_for(int D) {
  return sizeof(T) == 4 ? 16 : (D <= 32 ? 4 : D <= 64 ? 8 : 16);
}
constexpr int ring_rows_for(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : RGB; }

template <typename T>
constexpr size_t ring_smem(int D) {
  return (size_t)2 * RSTAGES * RTK * D * sizeof(T);  // K and V; the merge reuses it
}

// o of query rows g0 .. g0 + nrows - 1 of pair bh from the splits' partials:
// o_part (B * Hkv, splits, G, D), m_part and l_part (B * Hkv, splits, G),
// read past L1 (other blocks wrote them)
template <typename T>
__device__ void merge_splits(const float* o_part, const float* m_part, const float* l_part,
                             T* o, int bh, int g0, int nrows, int G, int D, int splits) {
  for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
    const int g = g0 + e / D, d = e % D;
    const int64_t ml = (int64_t)bh * splits * G + g;   // split 0's (m, l) of row g
    float m_all = __ldcg(m_part + ml);
    for (int s = 1; s < splits; ++s) m_all = fmaxf(m_all, __ldcg(m_part + ml + (int64_t)s * G));
    float denom = 0.f, num = 0.f;
    for (int s = 0; s < splits; ++s) {
      const int64_t i = ml + (int64_t)s * G;
      const float corr = expf(__ldcg(m_part + i) - m_all);
      denom += corr * __ldcg(l_part + i);
      num += __ldcg(o_part + i * D + d) * corr;
    }
    store_as(o + ((int64_t)bh * G + g) * D + d, num / fmaxf(denom, 1e-30f));
  }
}

template <typename T, int L, int GB>
__global__ void __launch_bounds__(RT) decode_ring(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ ws, int* __restrict__ counters,
    T* __restrict__ o, int Hkv, int S, int G, int D, int split_len, float scale) {
  constexpr int KPW = 32 / L;        // keys a warp scores at once, one a group of L lanes
  constexpr int NKG = RKW / KPW;     // keys a group scores in each stage
  constexpr int NS = NKG < 16 / GB ? NKG : (16 / GB > 0 ? 16 / GB : 1);  // keys a softmax step
  static_assert(NKG % NS == 0, "a stage's keys split evenly into softmax steps");
  constexpr int VE = 16 / sizeof(T); // elements a 16-byte copy
  static_assert(RKW % KPW == 0, "a warp's keys split evenly over its groups");
  extern __shared__ __align__(16) unsigned char ring_buf[];
  T* sK = reinterpret_cast<T*>(ring_buf);    // RSTAGES x RTK x D
  T* sV = sK + RSTAGES * RTK * D;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, c = lane % L;    // this lane's key group and chunk of D
  const bool has_chunk = c * 8 < D;
  const int bh = blockIdx.x, si = blockIdx.y, splits = gridDim.y;
  const int g0 = blockIdx.z * GB;
  const int b = bh / Hkv, hh = bh % Hkv;
  const int len = lengths[b];
  const int end = len > 0 ? min(len, S) : S;  // keys the row reads
  const int k_begin = si * split_len;
  const int k_end = min(k_begin + split_len, end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + RTK - 1) / RTK : 0;
  const int64_t RS = (int64_t)Hkv * D;       // between keys
  const T* kb = k + (int64_t)b * S * RS + (int64_t)hh * D;
  const T* vb = v + (int64_t)b * S * RS + (int64_t)hh * D;

  // this lane's chunk of the block's query rows, scaled
  float qr[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g0 + g < G && has_chunk) {
      load8(q + ((int64_t)bh * G + g0 + g) * D + c * 8, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }

  // each warp copies, and alone reads, its own RKW keys of every tile: the
  // warp's keys of tile t into stage t % RSTAGES, one commit group a tile
  // (empty past the last, so that the waits count alike in every lane)
  const int cpr = D / VE;                    // 16-byte copies a key row
  const float inv_cpr = 1.f / (float)cpr;
  const int wk = warp * RKW;                 // the warp's first key of a tile
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int t0 = k_begin + t * RTK + wk;
      T* dk = sK + ((t % RSTAGES) * RTK + wk) * D;
      T* dv = sV + ((t % RSTAGES) * RTK + wk) * D;
      for (int e = lane; e < RKW * cpr; e += 32) {
        const int j = __float2int_rz(((float)e + 0.5f) * inv_cpr);   // e / cpr, exactly
        const int p = e - j * cpr;
        const bool in = t0 + j < k_end;
        const int64_t off = (int64_t)(in ? t0 + j : k_begin) * RS + p * VE;
        cp_async16(smem_u32(dk + j * D + p * VE), kb + off, in ? 16 : 0);
        cp_async16(smem_u32(dv + j * D + p * VE), vb + off, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < RSTAGES - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<RSTAGES - 2>();  // this lane's copies of tile t have landed
    __syncwarp();                  // the warp's have; it is done with tile t - 1
    issue(t + RSTAGES - 1);        // into tile t - 1's stage
    const T* tk = sK + (t % RSTAGES) * RTK * D;
    const T* tv = sV + (t % RSTAGES) * RTK * D;
    const int t0 = k_begin + t * RTK;

    // the group's NKG keys (warp * RKW + j * KPW + grp), NS at a time:
    // scores, online softmax, P . V
#pragma unroll
    for (int j0 = 0; j0 < NKG; j0 += NS) {
      float s[GB][NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int kk = warp * RKW + (j0 + j) * KPW + grp;
        float kf[8];
        if (has_chunk) {
          load8(tk + kk * D + c * 8, kf);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
          s[g][j] = d;
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int j = 0; j < NS; ++j) s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], off);
        }
      }
      // keys past the split's end take no part; at or past len they score -1e30
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int key = t0 + warp * RKW + (j0 + j) * KPW + grp;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          s[g][j] = key >= k_end ? -INFINITY : (key < len ? s[g][j] : kNegInf);
        }
      }
      // s becomes p
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mt = s[g][0];
#pragma unroll
        for (int j = 1; j < NS; ++j) mt = fmaxf(mt, s[g][j]);
        const float m_new = fmaxf(m[g], mt);
        if (m_new != m[g]) {  // else corr = 1, which changes nothing
          const float corr = expf(m[g] - m_new);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
          m[g] = m_new;
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          s[g][j] = expf(s[g][j] - m_new);
          sum += s[g][j];
        }
        l[g] += sum;
      }
      if (has_chunk) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float vf[8];
          load8(tv + (warp * RKW + (j0 + j) * KPW + grp) * D + c * 8, vf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[g][j], vf[e], acc[g][e]);
          }
        }
      }
    }
  }

  // the warp's groups merge by shuffles
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mn), cb = expf(mo - mn);
      l[g] = l[g] * ca + lo * cb;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
    }
  }
  // the warps through shared memory, reusing the ring: (warp, row) -> m, l,
  // then D sums
  cp_async_wait<0>();
  __syncthreads();
  float* sm = reinterpret_cast<float*>(ring_buf);
  const int RW = D + 2;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float* r = sm + (warp * GB + g) * RW;
      if (c == 0) {
        r[0] = m[g];
        r[1] = l[g];
      }
      if (has_chunk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) r[2 + c * 8 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  const int nrows = min(GB, G - g0);
  const int64_t n_part = (int64_t)gridDim.x * splits * G;   // partial rows in all
  float* o_part = ws;
  float* m_part = ws + n_part * D;
  float* l_part = m_part + n_part;
  for (int e = tid; e < nrows * D; e += RT) {
    const int g = e / D, d = e - g * D;
    float m_all = sm[g * RW];
#pragma unroll
    for (int w = 1; w < RWARPS; ++w) m_all = fmaxf(m_all, sm[(w * GB + g) * RW]);
    float denom = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < RWARPS; ++w) {
      const float* r = sm + (w * GB + g) * RW;
      const float corr = expf(r[0] - m_all);
      denom += corr * r[1];
      num += r[2 + d] * corr;
    }
    if (splits == 1) {
      store_as(o + ((int64_t)bh * G + g0 + g) * D + d, num / fmaxf(denom, 1e-30f));
    } else {
      const int64_t i = ((int64_t)bh * splits + si) * G + g0 + g;
      o_part[i * D + d] = num;
      if (d == 0) {
        m_part[i] = m_all;
        l_part[i] = denom;
      }
    }
  }
  if (splits == 1) return;

  // the last block of this (b, h, row block) to finish merges the splits
  __threadfence();
  __syncthreads();
  int* counter = counters + (int64_t)bh * gridDim.z + blockIdx.z;
  if (tid == 0) s_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_splits(o_part, m_part, l_part, o, bh, g0, nrows, G, D, splits);
  if (tid == 0) *counter = 0;   // ready for the next call on this stream
}

template <typename T, int L, int GB>
int ring_launch(const void* q, const void* k, const void* v, const void* lengths, void* ws,
                void* counters, void* o, int B, int Hkv, int S, int G, int D, int splits,
                int split_len, cudaStream_t st) {
  const size_t smem = ring_smem<T>(D);
  if (smem + sizeof(int) > 48 * 1024) {  // beside s_last, past the default limit
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(decode_ring<T, L, GB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)ring_smem<T>(DMAX));
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) raised[dev] = true;
    }
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const int gz = (G + GB - 1) / GB;
  dim3 grid(B * Hkv, splits, gz);
  decode_ring<T, L, GB><<<grid, RT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (float*)ws, (int*)counters,
      (T*)o, Hkv, S, G, D, split_len, scale);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int ring_rows(const void* q, const void* k, const void* v, const void* lengths, void* ws,
              void* counters, void* o, int B, int Hkv, int S, int G, int D, int splits,
              int split_len, cudaStream_t st) {
  switch (ring_rows_for(G)) {
    case 1:
      return ring_launch<T, L, 1>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                                  split_len, st);
    case 2:
      return ring_launch<T, L, 2>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                                  split_len, st);
    case 4:
      return ring_launch<T, L, 4>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                                  split_len, st);
    default:
      return ring_launch<T, L, RGB>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                                    split_len, st);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// the host's plan (ops.py's ring_plan, ring_rows): split_len a multiple of
// RTK, splits = ceil(S / split_len), gz row blocks of ring_rows_for(G)
template <typename T>
int ring_entry(const void* q, const void* k, const void* v, const void* lengths, void* ws,
               void* counters, void* o, int B, int Hkv, int S, int G, int D, int splits,
               int split_len, int gz, void* stream) {
  if (G <= 0 || D <= 0 || D > DMAX || D % 8 || S <= 0 || split_len <= 0 || split_len % RTK ||
      splits <= 0 || splits > 65535 || (int64_t)(splits - 1) * split_len >= S ||
      (int64_t)splits * split_len < S || gz != (G + ring_rows_for(G) - 1) / ring_rows_for(G) ||
      gz > 65535 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (splits > 1 && (ws == nullptr || !aligned16(ws) || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Hkv <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 2) {
    if (ring_lanes_for<T>(D) == 4) {
      return ring_rows<T, 4>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                             split_len, st);
    }
    if (ring_lanes_for<T>(D) == 8) {
      return ring_rows<T, 8>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                             split_len, st);
    }
  }
  return ring_rows<T, 16>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits, split_len,
                          st);
}

}  // namespace

extern "C" int flash_decode_f32(const void* q, const void* k, const void* v, const void* lengths,
                                void* o_part, void* m_part, void* l_part, void* o, int B, int Hkv,
                                int S, int G, int D, int splits, void* stream) {
  return entry<float>(q, k, v, lengths, o_part, m_part, l_part, o, B, Hkv, S, G, D, splits,
                      stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o_part, void* m_part, void* l_part,
                                 void* o, int B, int Hkv, int S, int G, int D, int splits,
                                 void* stream) {
  return entry<__nv_bfloat16>(q, k, v, lengths, o_part, m_part, l_part, o, B, Hkv, S, G, D,
                              splits, stream);
}

// the ring route (ops.py's decode_route picks it where D % 8 == 0 and the
// bases are 16-byte aligned): ws holds the splits' partials (o, then m, then
// l), counters one int a (b, h, row block), zero between calls
extern "C" int flash_decode_ring_f32(const void* q, const void* k, const void* v,
                                     const void* lengths, void* ws, void* counters, void* o,
                                     int B, int Hkv, int S, int G, int D, int splits,
                                     int split_len, int gz, void* stream) {
  return ring_entry<float>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                           split_len, gz, stream);
}

extern "C" int flash_decode_ring_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, void* ws, void* counters, void* o,
                                      int B, int Hkv, int S, int G, int D, int splits,
                                      int split_len, int gz, void* stream) {
  return ring_entry<__nv_bfloat16>(q, k, v, lengths, ws, counters, o, B, Hkv, S, G, D, splits,
                                   split_len, gz, stream);
}
