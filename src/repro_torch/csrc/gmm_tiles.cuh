// The persistent wgmma pipeline of the grouped expert products, shared by
// K9's prefill route (moe_gmm.cu: gmm_prefill_hopper, out = x . w) and K9b's
// two products (moe_gmm_bwd.cu: gmm_bwd_hopper<0|1>, dx = dy . w^T and
// dw = x^T . dy), so the three keep one copy of it.
//
// out[e] (M, N) = A[e] (M, K) . B[e] (K, N) per expert, float32 sums, bf16
// out. One block an SM walks 128 x 256 output tiles: row tile fastest, then
// column tile, then expert; block b takes t = b, b + gridDim.x, ...
// (ops.persistent_tiles mirrors this order). A producer warpgroup (one
// thread, setmaxnreg down to 40) keeps the stages (64 deep each) in flight
// from 3-D tensor maps that zero-fill past each expert's edges, so ragged
// edges need no masking loads. Two consumer warpgroups (setmaxnreg up to
// 232) take 64 rows each on wgmma m64n256k16, keep one product group in
// flight and free a stage once the next stage's products have started; the
// producer runs on into the next tile while they store this one.
//
// The epilogue, a template parameter (EPI):
// - EPI_REGS (K9's prefill, K9b's `wgmma` route; four stages): each thread
//   stores its accumulators straight from registers, 128 four-byte
//   st.global, while the tensor cores wait for the next tile.
// - EPI_HALVES (four stages beside a 32 KB buffer), K9b's `wgmma_overlap`
//   route: each consumer warpgroup converts its 64 x 256 sums to bf16 and
//   writes them with stmatrix into its part of a shared buffer in TMA's
//   128-byte swizzle (64 x 64 atoms), in two 128-column halves; one thread
//   then stores each 64 x 64 box with a TMA store through a map of out (N,
//   M, E), which clips at M and N, and the warpgroup goes straight on to
//   the next tile's products. The buffer is written again only after that
//   thread's stores have read it (bulk_wait_read). ref.epilogue_byte and
//   ref.box_element model where each sum goes.
//
// `group` (the host's ops.raster_group for K9b's overlap route): tiles are
// walked in raster groups of `group` row tiles, all column tiles of a group
// (row tiles fastest) before the next group, so that one group's A operand
// stays in L2 while the waves of blocks move along the column tiles; 0 is
// one group of every row tile, the order above.
//
// The modes differ in the operands' majorness (the descriptors' transpose
// bits), their TMA boxes and where an expert's group size cuts; every
// operand is read as it lies:
// - FWD (K9): M = C, N = F, K = D. A is x's 128 x 64 tile from a (D, C, E)
//   map, K-major; B is w's 64 x 256 tile as it lies, from an (F, D, E) map,
//   MN-major (four 64-column atoms, LBO one atom).
// - DX (K9b): M = C, N = D, K = F. A is dy's 128 x 64 tile from an (F, C,
//   E) map, K-major; B is w's 256 x 64 tile, (D, F) with F contiguous, from
//   an (F, D, E) map in one box of 256 rows: K-major too.
// - DW (K9b): M = D, N = F, K = C cut at the group size. A is x's tile (64
//   C rows x 128 D columns) from a (D, C, E) map, MN-major, two atoms; B is
//   dy's 64 x 256 tile from an (F, C, E) map, MN-major, four atoms. Rows of
//   the last stage past the group size (inside C, so TMA does not zero
//   them) are zeroed in shared memory by the consumers before the products.
// FWD and DX: rows past the group size lie inside the tile's box and are
// loaded, but a row of A reaches only its own output row, written as 0; a
// tile with no valid row loads nothing and writes zeros. DW: an expert with
// no valid row loads nothing and writes zeros. Either epilogue writes those
// zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ int valid_rows(const int* gs, int e, int C) {
  if (gs == nullptr) return C;
  return max(0, min(gs[e], C));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

namespace hop {

using namespace hopper;

constexpr int NTH = 384;         // producer warpgroup + two consumer warpgroups
constexpr int BK = 64;           // K a stage: one 128-byte swizzle atom of bf16
constexpr int ATOM = 64 * 128;   // 64 rows x 64 columns, swizzled
constexpr int K16 = 16 * 128;    // a k16 step inside an MN-major atom

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// TMA reads 16-byte-aligned rows: D and F multiples of 8, aligned bases
bool tma_ok(const void* p, const void* q, int D, int F) {
  return D > 0 && F > 0 && D % 8 == 0 && F % 8 == 0 && aligned16(p) && aligned16(q);
}

enum Mode { FWD = 0, DX = 1, DW = 2 };
enum Epilogue { EPI_REGS = 0, EPI_HALVES = 1 };

constexpr int PM = 128, PN = 256, PSTAGES = 4;
constexpr int EPI_HN = PN / 2;                  // EPI_HALVES: columns a fill of the buffer
constexpr int EPI_BOX = 64;                     // a TMA store's box: 64 rows x 64 columns
constexpr int SMEM_LIMIT = 232448;              // dynamic shared memory a block may have
constexpr int PA_BYTES = PM * 128;  // 128 x 64 bf16 either way
constexpr int PB_BYTES = PN * 128;  // 256 x 64 bf16 either way
constexpr int PSTAGE = PA_BYTES + PB_BYTES;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536

// Epilogue buffer and dynamic shared memory of each epilogue: the stages,
// then the buffer (both warpgroups' rows, each warpgroup's part 64 x EPI_HN
// bf16), then the full and empty barriers, from a 1024-byte aligned base
template <int EPI>
struct Pipe {
  static constexpr int BUF = EPI == EPI_HALVES ? PM * EPI_HN * 2 : 0;
  static constexpr int SMEM = 1024 + PSTAGES * PSTAGE + BUF + 8 * 2 * PSTAGES;
  static_assert(SMEM <= SMEM_LIMIT, "the pipeline's shared memory is past a block's");
};
constexpr int PSMEM = Pipe<EPI_REGS>::SMEM;

// makes the consumers' plain stores to shared memory visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups (256 threads) meet; the producer does not
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// consumer warpgroup cw's 128 threads meet (barriers 2 and 3)
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
}

// The overlapped epilogue of one tile for consumer warpgroup cw (thread tq
// of its 128): its sums acc (zeros where `zero`, which leaves acc as it is:
// a write to an accumulator register outside wgmma serializes the
// products), rows row0 ... row0 + 63 of out[e] from column n0, rows at or
// past mv written as 0, through its part of the buffer at wbuf and TMA
// stores through the map `to` of out (N, M, E), in two halves of EPI_HN
// columns.
__device__ __forceinline__ void store_tile_tma(const float (&acc)[PN / 2], bool zero,
                                               const CUtensorMap* to, uint32_t wbuf, int cw,
                                               int tq, int row0, int n0, int e, int mv, int M,
                                               int N) {
  constexpr int HN = EPI_HN;
  const int warp = tq / 32, lane = tq % 32;
  // acc[4i + {0,1}]: row g, columns 8i + 2 (lane % 4) + {0,1}; acc[4i +
  // {2,3}]: row g + 8 (rows of the warpgroup's 64)
  const int g = 16 * warp + lane / 4;
  const bool oka = !zero && row0 + g < mv, okb = !zero && row0 + g + 8 < mv;
  // stmatrix.x4 over columns 8i ... 8i + 15: matrix j = lane / 8 is rows
  // 8 (j % 2) of the warp's 16, columns 8 (j / 2) on, and this lane gives
  // the address of its row lane % 8
  const int j = lane / 8, sr = 16 * warp + 8 * (j % 2) + lane % 8;
#pragma unroll
  for (int h = 0; h < PN / HN; ++h) {
    if (tq == 0) bulk_wait_read<0>();  // the buffer's last stores have read it
    warpgroup_sync(cw);
#pragma unroll
    for (int p = 0; p < HN / 16; ++p) {
      const int i = h * (HN / 8) + 2 * p;
      const uint32_t r0 = pack_bf16(oka ? acc[4 * i] : 0.f, oka ? acc[4 * i + 1] : 0.f);
      const uint32_t r1 = pack_bf16(okb ? acc[4 * i + 2] : 0.f, okb ? acc[4 * i + 3] : 0.f);
      const uint32_t r2 = pack_bf16(oka ? acc[4 * i + 4] : 0.f, oka ? acc[4 * i + 5] : 0.f);
      const uint32_t r3 = pack_bf16(okb ? acc[4 * i + 6] : 0.f, okb ? acc[4 * i + 7] : 0.f);
      // the addressed row's first column in this fill: atom cb / 64, its
      // 16-byte chunk (cb % 64) / 8 swizzled by the row
      const int cb = 16 * p + 8 * (j / 2);
      stmatrix_x4(wbuf + (cb / EPI_BOX) * ATOM + sr * 128 + ((((cb % 64) / 8) ^ (sr % 8)) << 4),
                  r0, r1, r2, r3);
    }
    fence_proxy_async();  // the stmatrix writes, visible to the TMA store
    warpgroup_sync(cw);
    if (tq == 0) {
#pragma unroll
      for (int a = 0; a < HN / EPI_BOX; ++a) {
        const int c = n0 + h * HN + EPI_BOX * a;
        if (c < N && row0 < M) tma_store_3d(to, wbuf + a * ATOM, c, row0, e);
      }
      bulk_commit();
    }
  }
}

// The body of a kernel launched with NTH threads, one block an SM and
// Pipe<EPI>::SMEM bytes of dynamic shared memory; ta and tb are its
// __grid_constant__ tensor maps (encode_tiles), out (E, M, N), and `to`
// (the overlapped epilogues) a __grid_constant__ map of out from
// encode_bf16_3d_sw128(out, N, M, E, EPI_BOX).
template <int MODE, int EPI = EPI_REGS>
__device__ __forceinline__ void gmm_tiles(const CUtensorMap& ta, const CUtensorMap& tb,
                                          const int* __restrict__ gs,
                                          __nv_bfloat16* __restrict__ out, int E, int C, int D,
                                          int F, const CUtensorMap* to = nullptr, int group = 0) {
  using P = Pipe<EPI>;
  constexpr bool A_MN = MODE == DW, B_MN = MODE != DX;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t buf = base + PSTAGES * PSTAGE;
  const uint32_t bar = buf + P::BUF;
  auto sA = [&](int s) { return base + s * PSTAGE; };
  auto sB = [&](int s) { return base + s * PSTAGE + PA_BYTES; };
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (PSTAGES + s); };

  const int M = MODE == DW ? D : C, N = MODE == DX ? D : F;
  const int mt = (M + PM - 1) / PM, nt = (N + PN - 1) / PN;
  const int tiles = mt * nt * E;
  // tile t -> (row tile, column tile, expert), in raster groups of G row
  // tiles, then experts
  const int G = group > 0 && group < mt ? group : mt, whole = mt / G;
  auto tile = [&](int t, int& m, int& n, int& e) {
    e = t / (mt * nt);
    const int r = t % (mt * nt);
    if (r < whole * G * nt) {
      n = (r % (G * nt)) / G;
      m = r / (G * nt) * G + r % G;
    } else {  // the last group, of mt % G row tiles
      const int rem = mt - whole * G, rr = r - whole * G * nt;
      n = rr / rem;
      m = whole * G + rr % rem;
    }
  };
  // rows of out that get a sum, and K blocks, of expert e
  auto sum_rows = [&](int nv) { return MODE == DW ? M : nv; };
  auto k_blocks = [&](int nv) {
    return ((MODE == FWD ? D : MODE == DX ? F : nv) + BK - 1) / BK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      if (EPI != EPI_REGS) tma_prefetch_map(to);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m, n, e;
        tile(t, m, n, e);
        const int nv = valid_rows(gs, e, C);
        if (m * PM >= sum_rows(nv)) continue;
        const int kb_n = k_blocks(nv);
        for (int kb = 0; kb < kb_n; ++kb, ++it) {
          const int s = it % PSTAGES;
          mbar_wait(empty(s), ((it / PSTAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), PSTAGE);
          if (A_MN) {
#pragma unroll
            for (int a = 0; a < PM / 64; ++a)
              tma_load_3d(sA(s) + a * ATOM, &ta, full(s), m * PM + 64 * a, kb * BK, e);
          } else {
            tma_load_3d(sA(s), &ta, full(s), kb * BK, m * PM, e);
          }
          if (B_MN) {
#pragma unroll
            for (int a = 0; a < PN / 64; ++a)
              tma_load_3d(sB(s) + a * ATOM, &tb, full(s), n * PN + 64 * a, kb * BK, e);
          } else {
            tma_load_3d(sB(s), &tb, full(s), kb * BK, n * PN, e);
          }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
  const int tq = threadIdx.x % 128, warp = tq / 32, lane = tq % 32;
  float acc[PN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m, n, e;
    tile(t, m, n, e);
    const int nv = valid_rows(gs, e, C);
    const int mv = sum_rows(nv), kb_n = k_blocks(nv);
    const int row0 = m * PM + 64 * cw, n0 = n * PN;
    __nv_bfloat16* ob = out + (int64_t)e * M * N;
    if (m * PM >= mv || kb_n == 0) {  // no valid row or no term: zeros, nothing loaded
      if constexpr (EPI == EPI_REGS) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        for (int i = tq; i < 64 * (PN / 8); i += 128) {
          const int r = row0 + i / (PN / 8), c = n0 + (i % (PN / 8)) * 8;
          if (r < M && c < N) *reinterpret_cast<uint4*>(ob + (int64_t)r * N + c) = z;
        }
      } else {
        store_tile_tma(acc, true, to, buf + cw * (P::BUF / 2), cw, tq, row0, n0, e, mv, M, N);
      }
      continue;
    }
    for (int kb = 0; kb < kb_n; ++kb, ++it) {
      const int s = it % PSTAGES;
      mbar_wait(full(s), (it / PSTAGES) & 1);
      if (MODE == DW && (kb + 1) * BK > nv) {
        // the stage's C rows from nv on: zero them in all six atoms (x's
        // two, dy's four); a row is one 128-byte line of an atom whatever
        // the swizzle
        const int r_lo = nv - kb * BK, n_lines = (BK - r_lo) * 6 * 8;
        const int tc = threadIdx.x - 128;  // 0..255 over both consumer warpgroups
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        for (int i = tc; i < n_lines; i += 256) {
          const int chunk = i % 8, atom = (i / 8) % 6, r = r_lo + i / 48;
          const uint32_t addr = sA(s) + atom * ATOM + r * 128 + chunk * 16;
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(z.x),
                       "r"(z.y), "r"(z.z), "r"(z.w)
                       : "memory");
        }
        fence_proxy_async();
        consumers_sync();
      }
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t da = A_MN ? desc_sw128(sA(s) + cw * ATOM + ks * K16, ATOM, 1024)
                                 : desc_sw128(sA(s) + cw * 64 * 128 + ks * 32, 16, 1024);
        const uint64_t db = B_MN ? desc_sw128(sB(s) + ks * K16, ATOM, 1024)
                                 : desc_sw128(sB(s) + ks * 32, 16, 1024);
        wgmma_ss_t<PN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, kb > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      fence_operands(acc);
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((it - 1) % PSTAGES));
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty((it - 1) % PSTAGES));

    if constexpr (EPI != EPI_REGS) {
      store_tile_tma(acc, false, to, buf + cw * (P::BUF / 2), cw, tq, row0, n0, e, mv, M, N);
      continue;
    }
    // acc[4i + {0,1}]: row ra, columns 8i + 2 (lane % 4) + {0,1}; acc[4i +
    // {2,3}]: row ra + 8; N is a multiple of 8, so a pair is whole or past N
    const int ra = row0 + 16 * warp + lane / 4, rb = ra + 8;
    const bool oka = ra < mv, okb = rb < mv;
#pragma unroll
    for (int i = 0; i < PN / 8; ++i) {
      const int c = n0 + 8 * i + 2 * (lane % 4);
      if (c >= N) continue;
      if (ra < M)
        store_pair(ob + (int64_t)ra * N + c, oka ? acc[4 * i] : 0.f, oka ? acc[4 * i + 1] : 0.f);
      if (rb < M)
        store_pair(ob + (int64_t)rb * N + c, okb ? acc[4 * i + 2] : 0.f,
                   okb ? acc[4 * i + 3] : 0.f);
    }
  }
  // the shared buffer must outlive the last TMA stores' reads
  if (EPI != EPI_REGS && tq == 0) bulk_wait<0>();
}

// The tensor maps of gmm_tiles<MODE>: FWD (a = x, b = w), DX (a = dy, b =
// w), DW (a = x, b = dy); 0 or encode_bf16_3d_sw128's error code.
template <int MODE>
int encode_tiles(CUtensorMap* ta, CUtensorMap* tb, const void* a, const void* b, int E, int C,
                 int D, int F) {
  int rc;
  if (MODE == FWD) {
    rc = encode_bf16_3d_sw128(ta, a, D, C, E, PM);
    if (rc == 0) rc = encode_bf16_3d_sw128(tb, b, F, D, E, BK);
  } else if (MODE == DX) {
    rc = encode_bf16_3d_sw128(ta, a, F, C, E, PM);
    if (rc == 0) rc = encode_bf16_3d_sw128(tb, b, F, D, E, PN);
  } else {
    rc = encode_bf16_3d_sw128(ta, a, D, C, E, BK);
    if (rc == 0) rc = encode_bf16_3d_sw128(tb, b, F, C, E, BK);
  }
  return rc;
}

}  // namespace hop

}  // namespace
