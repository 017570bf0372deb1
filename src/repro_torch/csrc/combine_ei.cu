// Q2: the fused propose step's per-source combine and EI, on Hopper.
//
// No Pallas original: the reference computes this with jnp inside its
// jitted propose program (repro/kernels/forest_eval/propose.py,
// _combine_source and make_portable_kernels' ei), and the port needs it on
// the card as one kernel instead of some 300 elementwise launches. For
// each source s < S and candidate n it combines the source's tps rows of
// the (T, N) leaf stats the way numpy's PackedForest.combine does (rows
// added in tree order from the first, each sum divided by tps, the mean of
// squared deviations, the 1e-10 floor, y_std then y_mean as two
// roundings), then evaluates the portable Cephes EI (exp64 and ndtr64 as
// polynomial ratios with exponent-field powers of two, the denormal flush
// at its four sites) op for op. Every division is __ddiv_rn, the square
// root __dsqrt_rn, and the build's --fmad=false keeps each product its own
// rounding, so the (S_rows, N) EI is bit-identical to the plain version's
// and to the reference's. Columns at or past n_valid get -1 (below any
// real EI, so padding keeps the real rows' ranks), rows at or past S get 0.
// S, tps and n_valid come from `meta` on the device, so a captured CUDA
// graph replays the kernel for any source count up to its rows.
//
// What bounds it on this card: the bytes. It reads the two (T, N) leaf
// stats once (2 x 120 x 131072 x 8 bytes at the tuner's 12 sources of 10
// trees) and writes S x N EI: about 264 MB, 0.079 ms at 3.35 TB/s; the
// float64 work is about 150 operations a (source, candidate).
//
// Design: one thread a candidate, blockIdx.y the source; a warp reads 32
// neighbouring candidates of one tree row (coalesced); the second pass over
// the rows (the deviations) finds them in L1 or L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kVarFloor = 1e-10;        // PackedForest.combine's floor
constexpr double kEiVarFloor = 1e-12;      // acquisition.EI_VAR_FLOOR
constexpr double kMaxLog = 709.782712893383996843;
constexpr double kMinLog = -708.396418532264106224;
constexpr double kLog2e = 1.4426950408889634073599;
constexpr double kExpC1 = 6.93145751953125e-1;
constexpr double kExpC2 = 1.42860682030941723212e-6;
constexpr double kSqrt1_2 = 0.70710678118654752440;
constexpr double kMinNormal = 2.2250738585072014e-308;
// float(np.sqrt(2 * np.pi)), correctly rounded
constexpr double kSqrt2Pi = 2.5066282746310002;

__device__ const double kExpP[] = {1.26177193074810590878e-4, 3.02994407707441961300e-2,
                                   9.99999999999999999910e-1};
__device__ const double kExpQ[] = {3.00198505138664455042e-6, 2.52448340349684104192e-3,
                                   2.27265548208155028766e-1, 2.00000000000000000005e0};
__device__ const double kErfT[] = {9.60497373987051638749e0, 9.00260197203842689217e1,
                                   2.23200534594684319226e3, 7.00332514112805075473e3,
                                   5.55923013010394962768e4};
__device__ const double kErfU[] = {3.35617141647503099647e1, 5.21357949780152679795e2,
                                   4.59432382970980127987e3, 2.26290000613890934246e4,
                                   4.92673942608635921086e4};
__device__ const double kErfcP[] = {2.46196981473530512524e-10, 5.64189564831068821977e-1,
                                    7.46321056442269912687e0, 4.86371970985681366614e1,
                                    1.96520832956077098242e2, 5.26445194995477358631e2,
                                    9.34528527171957607540e2, 1.02755188689515710272e3,
                                    5.57535335369399327526e2};
__device__ const double kErfcQ[] = {1.32281951154744992508e1, 8.67072140885989742329e1,
                                    3.54937778887819891062e2, 9.75708501743205489753e2,
                                    1.82390916687909736289e3, 2.24633760818710981792e3,
                                    1.65666309194161350182e3, 5.57535340817727675546e2};
__device__ const double kErfcR[] = {5.64189583547755073984e-1, 1.27536670759978104416e0,
                                    5.01905042251180477414e0, 6.16021097993053585195e0,
                                    7.40974269950448939160e0, 2.97886665372100240670e0};
__device__ const double kErfcS[] = {2.26052863220117276590e0, 9.39603524938001434673e0,
                                    1.20489539808096656605e1, 3.08326216929483867054e1,
                                    2.81677489524132947867e1, 7.92101509270425732821e0};

// torch.clamp / clamp_min / maximum: NaN passes through
__device__ __forceinline__ double clampd(double x, double lo, double hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}
__device__ __forceinline__ double maxd(double x, double lo) {
  return x != x ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ double ftz(double v) { return fabs(v) < kMinNormal ? 0.0 * v : v; }

template <int K>
__device__ __forceinline__ double polevl(double x, const double (&c)[K]) {
  double r = c[0];
#pragma unroll
  for (int i = 1; i < K; ++i) r = __dadd_rn(__dmul_rn(r, x), c[i]);
  return r;
}

template <int K>
__device__ __forceinline__ double p1evl(double x, const double (&c)[K]) {
  double r = __dadd_rn(x, c[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) r = __dadd_rn(__dmul_rn(r, x), c[i]);
  return r;
}

__device__ __forceinline__ double pow2(double k) {
  return __longlong_as_double(((long long)k + 1023) << 52);
}

__device__ double exp64(double x) {
  const double xs = clampd(x, kMinLog, kMaxLog);
  const double k = floor(__dadd_rn(__dmul_rn(kLog2e, xs), 0.5));
  double r = __dsub_rn(xs, __dmul_rn(k, kExpC1));
  r = __dsub_rn(r, __dmul_rn(k, kExpC2));
  const double xx = __dmul_rn(r, r);
  const double p = __dmul_rn(r, polevl(xx, kExpP));
  double w = __ddiv_rn(p, __dsub_rn(polevl(xx, kExpQ), p));
  w = __dadd_rn(1.0, __dmul_rn(2.0, w));
  const double k1 = floor(__dmul_rn(k, 0.5));
  const double k2 = __dsub_rn(k, k1);
  double out = __dmul_rn(__dmul_rn(w, pow2(k1)), pow2(k2));
  if (x < kMinLog) out = 0.0;
  if (x > kMaxLog) out = __longlong_as_double(0x7ff0000000000000ll);
  return out;
}

__device__ double ndtr64(double z) {
  const double x = __dmul_rn(z, kSqrt1_2);
  const double ax = fabs(x);
  if (ax < 1.0) {
    const double xc = clampd(x, -1.0, 1.0);
    const double zz = __dmul_rn(xc, xc);
    const double erf_small = __ddiv_rn(__dmul_rn(xc, polevl(zz, kErfT)), p1evl(zz, kErfU));
    return __dadd_rn(0.5, __dmul_rn(0.5, erf_small));
  }
  const double a = clampd(ax, 1.0, 100.0);
  const double ez = exp64(__dmul_rn(-a, a));
  const double p = a < 8.0 ? __ddiv_rn(polevl(a, kErfcP), p1evl(a, kErfcQ))
                           : __ddiv_rn(polevl(a, kErfcR), p1evl(a, kErfcS));
  const double ht = ftz(__dmul_rn(0.5, __dmul_rn(ez, p)));
  return x > 0 ? __dsub_rn(1.0, ht) : ht;
}

__device__ double ei(double mean, double var, double best) {
  const double sd = __dsqrt_rn(maxd(var, kEiVarFloor));
  const double diff = __dsub_rn(best, mean);
  const double z = __ddiv_rn(diff, sd);
  const double phi = ftz(__ddiv_rn(exp64(__dmul_rn(-0.5, __dmul_rn(z, z))), kSqrt2Pi));
  const double val = __dadd_rn(ftz(__dmul_rn(diff, ndtr64(z))), ftz(__dmul_rn(sd, phi)));
  return ftz(maxd(val, 0.0));
}

__global__ void combine_ei_kernel(const double* __restrict__ m_leaf,
                                  const double* __restrict__ v_leaf,
                                  const double* __restrict__ ystats,
                                  const double* __restrict__ inc, const int* __restrict__ meta,
                                  double* __restrict__ out, int S_rows, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (n >= N) return;
  const int S = __ldg(meta), tps = __ldg(meta + 1), n_valid = __ldg(meta + 2);
  double r = 0.0;
  if (s < S && n >= n_valid) {
    r = -1.0;
  } else if (s < S) {
    const double* m = m_leaf + (int64_t)s * tps * N + n;
    const double* v = v_leaf + (int64_t)s * tps * N + n;
    const double Td = (double)tps;
    double ms = __ldg(m), vs = __ldg(v);
    for (int t = 1; t < tps; ++t) {
      ms = __dadd_rn(ms, __ldg(m + (int64_t)t * N));
      vs = __dadd_rn(vs, __ldg(v + (int64_t)t * N));
    }
    const double mean = __ddiv_rn(ms, Td);
    const double vmean = __ddiv_rn(vs, Td);
    double dev = __dsub_rn(__ldg(m), mean);
    double acc = __dmul_rn(dev, dev);
    for (int t = 1; t < tps; ++t) {
      dev = __dsub_rn(__ldg(m + (int64_t)t * N), mean);
      acc = __dadd_rn(acc, __dmul_rn(dev, dev));
    }
    const double var = maxd(__dadd_rn(vmean, __ddiv_rn(acc, Td)), kVarFloor);
    const double y_mean = __ldg(ystats + s), y_std = __ldg(ystats + S_rows + s);
    const double y_std2 = __ldg(ystats + 2 * S_rows + s);
    r = ei(__dadd_rn(__dmul_rn(mean, y_std), y_mean), __dmul_rn(var, y_std2), __ldg(inc + s));
  }
  out[(int64_t)s * N + n] = r;
}

}  // namespace

extern "C" int combine_ei_launch(const void* m_leaf, const void* v_leaf, const void* ystats,
                                 const void* inc, const void* meta, void* out, int S_rows, int N,
                                 int T_rows, void* stream) {
  if (S_rows <= 0 || N <= 0) return 0;
  if (S_rows > 65535 || T_rows < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, S_rows);
  combine_ei_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const double*)m_leaf, (const double*)v_leaf, (const double*)ystats, (const double*)inc,
      (const int*)meta, (double*)out, S_rows, N);
  return (int)cudaGetLastError();
}
