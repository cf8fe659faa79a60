// K19 segment_percentile: the exact per-group percentile, after its sort.
//
// Replaces spark_rapids_tpu/exec/rowkeys.py:segment_reduce's "pct:<p>"
// branch (:480-523). The order comes first, from K1: a stable sort of the
// rows by (group id with pads at capacity, then ~valid) and the value's
// float64 order bits, the reference's lax.sort(num_keys=3) (:489-491). So
// each group's valid values sit ascending in one run of sorted positions,
// ahead of its NULLs. Two launches then:
// - a: one thread per sorted position; the first and the last valid
//   position of each group's run write the group's start and end;
// - b: one thread per group slot; cnt = end - start + 1, q = p * (cnt - 1)
//   in float64, k = floor(q), frac = q - floor(q), lo = start + k,
//   hi = lo + (frac > 0), and sv[lo] * (1 - frac) + sv[hi] * frac with
//   sv = data[order]. A group without a valid row is NULL (0).
// Several fractions of one column share the sort: launch b computes one
// output per fraction.
//
// The interpolation is written with __dmul_rn / __dadd_rn / __dsub_rn so
// nvcc cannot contract it into an FMA: the JAX reference and the plain
// PyTorch version round each product, and K19 must match them bit for bit.
// frac == 0 still computes sv[lo] * 1 + sv[lo] * 0, as they do (an
// infinite value gives NaN there, in all three).
//
// Bound: memory. Launch a reads the order and, through it, the group id and
// validity of every row; launch b reads two gathered values a group and
// writes one double and one flag a group and fraction.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kMaxFractions = 16;

struct Fractions {
  double p[kMaxFractions];
  double* out[kMaxFractions];
  uint8_t* out_valid[kMaxFractions];
  int n;
};

__global__ void run_bounds_kernel(const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ gid,
                                  const uint8_t* __restrict__ valid,
                                  long long n, int32_t* __restrict__ starts,
                                  int32_t* __restrict__ ends) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int32_t r = order[i];
    const int32_t g = gid[r];
    if (g < 0 || g >= n || !valid[r]) continue;
    bool first = i == 0, last = i == n - 1;
    if (!first) {
      const int32_t rp = order[i - 1];
      first = gid[rp] != g || !valid[rp];
    }
    if (!last) {
      const int32_t rn = order[i + 1];
      last = gid[rn] != g || !valid[rn];
    }
    if (first) starts[g] = (int32_t)i;
    if (last) ends[g] = (int32_t)i;
  }
}

__global__ void interpolate_kernel(const int32_t* __restrict__ order,
                                   const double* __restrict__ data,
                                   const int32_t* __restrict__ starts,
                                   const int32_t* __restrict__ ends,
                                   long long n, Fractions fr) {
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += (long long)gridDim.x * blockDim.x) {
    const int32_t e = ends[g];
    const long long cnt = e >= 0 ? (long long)e - starts[g] + 1 : 0;
    const bool ok = cnt > 0;
    const long long start = ok ? starts[g] : 0;
    const double c1 = (double)(cnt > 1 ? cnt - 1 : 0);
    for (int f = 0; f < fr.n; ++f) {
      double out = 0.0;
      if (ok) {
        const double q = __dmul_rn(fr.p[f], c1);
        const double fl = floor(q);
        const long long k = (long long)fl;
        const double frac = __dsub_rn(q, fl);
        long long lo = start + k;
        lo = lo < 0 ? 0 : (lo > n - 1 ? n - 1 : lo);
        long long hi = lo + (frac > 0.0 ? 1 : 0);
        hi = hi > n - 1 ? n - 1 : hi;
        const double a = data[order[lo]];
        const double b = data[order[hi]];
        out = __dadd_rn(__dmul_rn(a, __dsub_rn(1.0, frac)),
                        __dmul_rn(b, frac));
      }
      fr.out[f][g] = out;
      fr.out_valid[f][g] = ok ? 1 : 0;
    }
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API int srt_segment_percentile_max_fractions() { return kMaxFractions; }

// order: int32 [n] the K1 permutation over (gid, ~valid, value order bits);
// gid: int32 [n] group id per row (>= n: not in a group); valid: uint8 [n];
// data: float64 [n]; starts / ends: int32 [n] scratch; ps / outs /
// out_valids: n_fracs fractions and their float64 [n] and uint8 [n]
// outputs per group slot.
SRT_API int srt_segment_percentile(const int32_t* order, const int32_t* gid,
                                   const uint8_t* valid, const double* data,
                                   long long n, int32_t* starts,
                                   int32_t* ends, const double* ps,
                                   double* const* outs,
                                   uint8_t* const* out_valids, int n_fracs,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_fracs < 1 || n_fracs > kMaxFractions || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  if (n <= 0) return 0;
  Fractions fr;
  fr.n = n_fracs;
  for (int f = 0; f < n_fracs; ++f) {
    fr.p[f] = ps[f];
    fr.out[f] = outs[f];
    fr.out_valid[f] = out_valids[f];
  }
  SRT_CALL(cudaMemsetAsync(ends, 0xFF, sizeof(int32_t) * (size_t)n, st),
           "memset ends");
  SRT_CALL(cudaMemsetAsync(starts, 0, sizeof(int32_t) * (size_t)n, st),
           "memset starts");
  const unsigned grid =
      (unsigned)std::min<long long>(ceil_div(n, kThreads), 65535LL * 8);
  run_bounds_kernel<<<grid, kThreads, 0, st>>>(order, gid, valid, n, starts,
                                               ends);
  SRT_LAUNCHED("run_bounds_kernel");
  interpolate_kernel<<<grid, kThreads, 0, st>>>(order, data, starts, ends, n,
                                                fr);
  SRT_LAUNCHED("interpolate_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
