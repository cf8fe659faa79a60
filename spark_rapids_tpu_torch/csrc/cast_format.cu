// K41 format_fixed and K42 format_float: the casts to STRING (B16's
// formatting half, columnar/format.py).
//
// - K41 replaces spark_rapids_tpu/columnar/format.py:int_to_string (:395),
//   _bool_to_string (:427), date_to_string (:532) and timestamp_to_string
//   (:476, with _year_field :452): int8-int64 as decimal text (int64 min
//   through its unsigned magnitude), 'true' / 'false', int32 epoch days as
//   'YYYY-MM-DD' and int64 epoch microseconds as 'YYYY-MM-DD HH:MM:SS' and
//   the fraction without its trailing zeros (floored, so times before 1970
//   land on the right day), years outside [0, 9999] with a sign and at
//   least 4 digits. A length launch, a scan of the lengths (NULL rows 0),
//   a write launch: a thread a row writes its bytes straight into place.
//   The reference built a fixed template per row and gathered it a byte at
//   a time through a search of the offsets.
// - K42 replaces float_to_string (:284, with shortest_float_decomposition
//   :126): the shortest decimal that parses back (an f32 source's
//   granularity for FLOAT), in Java's placement (plain for -3 <= e10 < 7,
//   else d.dddE[-]ee), 'NaN', '[-]Infinity', '[-]0.0'. A plan launch
//   normalises each value into [1, 10) as an error-free double pair (at
//   most 15 chunks of 10^22, 4 for FLOAT), tries p = 1, 2, ... and stops at
//   the first that parses back (the reference computes all 17 and keeps the
//   first), and keeps (m, p, e10) and the length in scratch; a scan; a
//   write launch places the digits. The decomposition is never recomputed.
//
// The arithmetic is the reference's operation for operation, over the
// same power table (format.py:_P10F, built with numpy and uploaded once):
// Dekker's products and the compensated sums assume every product and sum
// is rounded on its own, so this file is built with -fmad=false
// (cuda_build.py:SOURCE_FLAGS) and never with fast math: no FMA
// contraction, subnormals kept. The table is read through __ldg (lanes
// read different entries: constant memory would serialise them).
//
// Bound: K41 memory: the input and its validity read, the text and the
// offsets written (plus 4 bytes a lane of lengths, written and read by
// the scan); it takes the 32-bit calendar of common.cuh and 32-bit digit
// loops, since 64-bit integer division costs tens of instructions. K42
// the larger of memory (8 or 4 bytes in, the text out) and FP64: ~25
// double operations a chunk of the pair scaling (|e10| / 22 chunks), ~33
// a candidate p and ~8 around them; chip_smoke.py counts this run's
// operations from each row's (p, e10). At l_extendedprice the two are
// within 15% of each other, the operations the larger.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

enum { kInt = 0, kBool = 1, kDate = 2, kTimestamp = 3 };
constexpr int kP10fOff = 343;
constexpr long long kDay = 86400000000LL;

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

__device__ __forceinline__ long long load_int(const void* in, int bytes,
                                              long long i) {
  switch (bytes) {
    case 1: return static_cast<const int8_t*>(in)[i];
    case 2: return static_cast<const int16_t*>(in)[i];
    case 4: return static_cast<const int32_t*>(in)[i];
    default: return static_cast<const long long*>(in)[i];
  }
}

__device__ __forceinline__ int count_digits(unsigned long long u) {
  int nd = 1;
  unsigned long long p = 10;
  while (nd < 20 && u >= p) {
    ++nd;
    if (nd < 20) p *= 10;
  }
  return nd;
}

// year chars: 4 zero-padded digits inside [0, 9999], a sign and at least
// 4 digits outside (format.py:_year_field)
struct Year {
  long long ay;
  int nd;
  bool sign;
  __device__ explicit Year(long long y) {
    ay = y < 0 ? -y : y;
    nd = 4 + (ay >= 10000) + (ay >= 100000) + (ay >= 1000000) +
         (ay >= 10000000);
    sign = y < 0 || y > 9999;
  }
  __device__ int len() const { return nd + (sign ? 1 : 0); }
};

__device__ __forceinline__ uint8_t* put_year(uint8_t* o, long long y) {
  const Year yr(y);
  if (yr.sign) *o++ = y < 0 ? '-' : '+';
  int a = (int)yr.ay;  // int32 days and int64 microseconds: |y| < 6e6
  for (int k = yr.nd - 1; k >= 0; --k) {
    o[k] = (uint8_t)('0' + a % 10);
    a /= 10;
  }
  return o + yr.nd;
}

__device__ __forceinline__ uint8_t* put2(uint8_t* o, int v) {
  o[0] = (uint8_t)('0' + v / 10);
  o[1] = (uint8_t)('0' + v % 10);
  return o + 2;
}

// the timestamp's day and the microseconds into it, floored: wrapping
// arithmetic, as the reference's int64 (days * kDay passes int64 at the
// type's ends; the difference is the exact remainder)
__device__ __forceinline__ void split_micros(long long us, long long* days,
                                             long long* rem) {
  *days = floor_div(us, kDay);
  *rem = (long long)((unsigned long long)us -
                     (unsigned long long)(*days) * (unsigned long long)kDay);
}

__device__ __forceinline__ int frac_digits(int frac) {
  if (frac == 0) return 0;
  int fd = 6;
  while (frac % 10 == 0) {
    frac /= 10;
    --fd;
  }
  return fd;
}

__device__ int fixed_len(int mode, const void* in, int bytes, long long i) {
  const long long x = load_int(in, bytes, i);
  switch (mode) {
    case kInt: {
      const bool neg = x < 0;
      const unsigned long long u =
          neg ? (unsigned long long)(-(x + 1)) + 1ull
              : (unsigned long long)x;
      return count_digits(u) + (neg ? 1 : 0);
    }
    case kBool: return x != 0 ? 4 : 5;
    case kDate: {
      long long y, m, d;
      civil_from_days(x, &y, &m, &d);
      return Year(y).len() + 6;
    }
    default: {
      long long days, rem, y, m, d;
      split_micros(x, &days, &rem);
      civil_from_days(days, &y, &m, &d);
      const int fd = frac_digits((int)(rem % 1000000));
      return Year(y).len() + 15 + (fd > 0 ? 1 + fd : 0);
    }
  }
}

__device__ void fixed_write(int mode, const void* in, int bytes, long long i,
                            uint8_t* o) {
  const long long x = load_int(in, bytes, i);
  switch (mode) {
    case kInt: {
      const bool neg = x < 0;
      unsigned long long u = neg ? (unsigned long long)(-(x + 1)) + 1ull
                                 : (unsigned long long)x;
      const int nd = count_digits(u);
      if (neg) *o++ = '-';
      int k = nd - 1;
      for (; u > 0xFFFFFFFFull; --k) {  // 64-bit division only above 2^32
        o[k] = (uint8_t)('0' + u % 10);
        u /= 10;
      }
      for (uint32_t v = (uint32_t)u; k >= 0; --k) {
        o[k] = (uint8_t)('0' + v % 10);
        v /= 10;
      }
      return;
    }
    case kBool: {
      const char* w = x != 0 ? "true" : "false";
      for (int k = 0; w[k]; ++k) o[k] = (uint8_t)w[k];
      return;
    }
    case kDate: {
      long long y, m, d;
      civil_from_days(x, &y, &m, &d);
      o = put_year(o, y);
      *o++ = '-';
      o = put2(o, (int)m);
      *o++ = '-';
      put2(o, (int)d);
      return;
    }
    default: {
      long long days, rem, y, m, d;
      split_micros(x, &days, &rem);
      civil_from_days(days, &y, &m, &d);
      const int secs = (int)(rem / 1000000);
      int frac = (int)(rem % 1000000);
      o = put_year(o, y);
      *o++ = '-';
      o = put2(o, (int)m);
      *o++ = '-';
      o = put2(o, (int)d);
      *o++ = ' ';
      o = put2(o, secs / 3600);
      *o++ = ':';
      o = put2(o, secs / 60 % 60);
      *o++ = ':';
      o = put2(o, secs % 60);
      const int fd = frac_digits(frac);
      if (fd > 0) {
        *o++ = '.';
        for (int k = 0; k < 6 - fd; ++k) frac /= 10;
        for (int k = fd - 1; k >= 0; --k) {
          o[k] = (uint8_t)('0' + frac % 10);
          frac /= 10;
        }
      }
      return;
    }
  }
}

__global__ void fixed_len_kernel(int mode, const void* __restrict__ in,
                                 int bytes, const uint8_t* __restrict__ valid,
                                 long long n, uint32_t* __restrict__ lens) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i <= n;
       i += (long long)gridDim.x * blockDim.x) {
    lens[i] = (i < n && valid[i]) ? (uint32_t)fixed_len(mode, in, bytes, i)
                                  : 0u;
  }
}

__global__ void fixed_write_kernel(int mode, const void* __restrict__ in,
                                   int bytes,
                                   const uint8_t* __restrict__ valid,
                                   long long n,
                                   const int32_t* __restrict__ offsets,
                                   uint8_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (valid[i]) fixed_write(mode, in, bytes, i, out + offsets[i]);
  }
}

// ------------------------------------------------------------------- K42
__device__ __forceinline__ double p10(const double* P, long long k) {
  k += kP10fOff;
  k = k < 0 ? 0 : (k > 2 * kP10fOff ? 2 * kP10fOff : k);
  return __ldg(P + k);
}

__device__ __forceinline__ void two_prod(double a, double c, double* p1,
                                         double* err) {
  *p1 = a * c;
  const double split = 134217729.0;  // 2^27 + 1
  double ah = a * split;
  ah = ah - (ah - a);
  const double al = a - ah;
  double ch = c * split;
  ch = ch - (ch - c);
  const double cl = c - ch;
  *err = ((ah * ch - *p1) + ah * cl + al * ch) + al * cl;
}

__device__ __forceinline__ void fast_two_sum(double h, double l, double* s,
                                             double* e) {
  *s = h + l;
  *e = l - (*s - h);
}

// (h, l) times 10^step, step = rem clipped to [-22, 22]; a step of 0 leaves
// a normalised pair as it is, so the caller stops when rem reaches 0
__device__ __forceinline__ void chunk_step(const double* P, double* h,
                                           double* l, long long* rem) {
  const long long step = *rem < -22 ? -22 : (*rem > 22 ? 22 : *rem);
  if (step >= 0) {
    const double cm = p10(P, step);
    double mp1, mperr;
    two_prod(*h, cm, &mp1, &mperr);
    fast_two_sum(mp1, mperr + *l * cm, h, l);
  } else {
    const double cd = p10(P, -step);
    const double q1 = *h / cd;
    double pp1, pperr;
    two_prod(q1, cd, &pp1, &pperr);
    const double qerr = (((*h - pp1) - pperr) + *l) / cd;
    fast_two_sum(q1, qerr, h, l);
  }
  *rem -= step;
}

__constant__ long long kP10I[19] = {
    1LL, 10LL, 100LL, 1000LL, 10000LL, 100000LL, 1000000LL, 10000000LL,
    100000000LL, 1000000000LL, 10000000000LL, 100000000000LL,
    1000000000000LL, 10000000000000LL, 100000000000000LL,
    1000000000000000LL, 10000000000000000LL, 100000000000000000LL,
    1000000000000000000LL};

// shortest_float_decomposition (format.py) of one positive finite a
__device__ void decompose(const double* P, double a, bool is32,
                          long long* m_out, int* p_out, int* e_out) {
  const long long bits = __double_as_longlong(a);
  const bool sub = ((bits >> 52) & 0x7FF) == 0;
  const double a_est = sub ? a * p10(P, 280) : a;
  const long long e2 = ((__double_as_longlong(a_est) >> 52) & 0x7FF) - 1023;
  long long e10 = (e2 * 315653) >> 20;
  e10 += a_est >= p10(P, e10 + 1) ? 1 : 0;
  e10 -= a_est < p10(P, e10) ? 1 : 0;
  if (sub) e10 -= 280;

  const long long e2a = (bits >> 52) - 1023;
  long long ulp_exp;
  long long mant_mask, min_e2;
  if (is32) {
    ulp_exp = (e2a < -126 ? -126 : e2a) - 23 + 1023;
    mant_mask = ((1LL << 52) - 1) - ((1LL << 29) - 1);
    min_e2 = -126;
  } else {
    ulp_exp = e2a - 52 + 1023;
    mant_mask = (1LL << 52) - 1;
    min_e2 = -1022;
  }
  const double ulp =
      ulp_exp > 0 ? __longlong_as_double(ulp_exp << 52)
                  : __longlong_as_double(1LL);  // 5e-324
  const double rel_ulp = ulp / a;
  const bool pow2 = (bits & mant_mask) == 0 && e2a > min_e2;

  const double s2 = a < 1e-100 ? 0x1p+600 : 1.0;
  double h = a * s2;
  double l = 0.0;
  long long rem = -e10;
  const int chunks = is32 ? 4 : 15;
  for (int c = 0; c < chunks && rem != 0; ++c) chunk_step(P, &h, &l, &rem);
  if (s2 != 1.0) {  // x / 1.0 is x: skip the divisions
    h = h / s2;
    l = l / s2;
  }
  if (h >= 10.0) {
    const double q1 = h / 10.0;
    double pp1, pperr;
    two_prod(q1, 10.0, &pp1, &pperr);
    const double qerr = (((h - pp1) - pperr) + l) / 10.0;
    fast_two_sum(q1, qerr, &h, &l);
    e10 += 1;
  }
  if (h < 1.0) {
    double mp1, mperr;
    two_prod(h, 10.0, &mp1, &mperr);
    fast_two_sum(mp1, mperr + l * 10.0, &h, &l);
    e10 -= 1;
  }

  const int maxp = is32 ? 9 : 17;
  const double guard = 1.0 - 0x1p-40;
  for (int p = 1; p <= maxp; ++p) {
    const double c = p10(P, p - 1);
    double w1, werr;
    two_prod(h, c, &w1, &werr);
    const double tail = werr + l * c;
    const double base = rint(w1);
    const double delta = (w1 - base) + tail;
    const double adj = rint(delta);
    long long m = (long long)base + (long long)adj;
    const double resid = delta - adj;
    const double half_gap = rel_ulp * (base + delta) * 0.5 * guard;
    const double down_gap = pow2 ? half_gap * 0.5 : half_gap;
    const bool carry = m >= kP10I[p];
    const double resid_c = (base - p10(P, p)) + delta;
    const double rsel = carry ? resid_c : resid;
    const bool ok = rsel > 0 ? rsel < down_gap : -rsel < half_gap;
    if (ok || p == maxp) {
      *m_out = carry ? kP10I[p - 1] : m;
      *p_out = p;
      *e_out = (int)(e10 + (carry ? 1 : 0));
      return;
    }
  }
}

// kinds: 0 finite nonzero, 1 NaN, 2 Inf, 3 zero
__device__ __forceinline__ void float_parts(const void* in, bool is32,
                                            long long i, double* a, bool* neg,
                                            int* kind) {
  double f;
  if (is32) {
    const uint32_t b = static_cast<const uint32_t*>(in)[i];
    f = (double)__uint_as_float(b);
    *neg = (b >> 31) != 0;
    const uint32_t mant = b & 0x7FFFFFu;
    *a = fabs(f);
    if (((b >> 23) & 0xFFu) == 0 && mant > 0) *a = (double)mant * 0x1p-149;
  } else {
    f = static_cast<const double*>(in)[i];
    *neg = signbit(f) != 0;
    *a = fabs(f);
  }
  *kind = isnan(f) ? 1 : (isinf(f) ? 2 : (*a == 0.0 ? 3 : 0));
}

__device__ __forceinline__ int special_len(int kind, bool neg) {
  return kind == 1 ? 3 : (kind == 2 ? (neg ? 9 : 8) : (neg ? 4 : 3));
}

// the text length of (m, p, e10) in Java's placement (format.py:
// float_layout)
__device__ __forceinline__ int float_len(int p, int e, bool neg) {
  const int negi = neg ? 1 : 0;
  if (e < -3 || e >= 7) {
    const int ae = e < 0 ? -e : e;
    const int elen = 1 + (ae >= 10) + (ae >= 100);
    const int sd = p - 1 > 1 ? p - 1 : 1;
    return negi + 2 + sd + 1 + (e < 0 ? 1 : 0) + elen;
  }
  const int ilen = e >= 0 ? e + 1 : 1;
  const int flen = e >= 0 ? (p - 1 - e > 1 ? p - 1 - e : 1) : p - e - 1;
  return negi + ilen + 1 + flen;
}

// meta: e10 + 512 (10 bits), p (5 bits), kind (2 bits), neg (1 bit)
__device__ __forceinline__ int32_t pack_meta(int e, int p, int kind,
                                             bool neg) {
  return (e + 512) | (p << 10) | (kind << 15) | ((neg ? 1 : 0) << 17);
}

__global__ void float_plan_kernel(const void* __restrict__ in, int is32,
                                  const uint8_t* __restrict__ valid,
                                  long long n, const double* __restrict__ P,
                                  long long* __restrict__ mant,
                                  int32_t* __restrict__ meta,
                                  uint32_t* __restrict__ lens) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i <= n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i == n || !valid[i]) {
      lens[i] = 0;
      continue;
    }
    double a;
    bool neg;
    int kind;
    float_parts(in, is32 != 0, i, &a, &neg, &kind);
    long long m = 0;
    int p = 1, e = 0, len;
    if (kind == 0) {
      decompose(P, a, is32 != 0, &m, &p, &e);
      len = float_len(p, e, neg);
    } else {
      len = special_len(kind, neg);
    }
    mant[i] = m;
    meta[i] = pack_meta(e, p, kind, neg);
    lens[i] = (uint32_t)len;
  }
}

// the digits of m, p of them, left to right (leading zeros where m has
// fewer than p)
struct Digits {
  long long m, div;
  __device__ Digits(long long m_, int p) : m(m_), div(1) {
    for (int k = 1; k < p; ++k) div *= 10;
  }
  __device__ uint8_t next() {
    const long long d = div > 0 ? (m / div) % 10 : 0;
    div /= 10;
    return (uint8_t)('0' + d);
  }
};

__device__ void float_write(long long m, int32_t meta, uint8_t* o) {
  const int e = (meta & 0x3FF) - 512;
  const int p = (meta >> 10) & 0x1F;
  const int kind = (meta >> 15) & 3;
  const bool neg = ((meta >> 17) & 1) != 0;
  if (kind != 0) {
    const char* w = kind == 1   ? "NaN"
                    : kind == 2 ? (neg ? "-Infinity" : "Infinity")
                                : (neg ? "-0.0" : "0.0");
    for (int k = 0; w[k]; ++k) o[k] = (uint8_t)w[k];
    return;
  }
  if (neg) *o++ = '-';
  Digits dg(m, p);
  if (e < -3 || e >= 7) {
    *o++ = dg.next();
    *o++ = '.';
    if (p == 1) {
      *o++ = '0';
    } else {
      for (int q = 1; q < p; ++q) *o++ = dg.next();
    }
    *o++ = 'E';
    if (e < 0) *o++ = '-';
    const int ae = e < 0 ? -e : e;
    if (ae >= 100) *o++ = (uint8_t)('0' + ae / 100);
    if (ae >= 10) *o++ = (uint8_t)('0' + ae / 10 % 10);
    *o++ = (uint8_t)('0' + ae % 10);
  } else if (e >= 0) {
    for (int t = 0; t <= e; ++t) *o++ = t < p ? dg.next() : '0';
    *o++ = '.';
    if (p - 1 - e >= 1) {
      for (int q = e + 1; q < p; ++q) *o++ = dg.next();
    } else {
      *o++ = '0';
    }
  } else {
    *o++ = '0';
    *o++ = '.';
    for (int k = 0; k < -e - 1; ++k) *o++ = '0';
    for (int q = 0; q < p; ++q) *o++ = dg.next();
  }
}

__global__ void float_write_kernel(const uint8_t* __restrict__ valid,
                                   long long n,
                                   const long long* __restrict__ mant,
                                   const int32_t* __restrict__ meta,
                                   const int32_t* __restrict__ offsets,
                                   uint8_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (valid[i]) float_write(mant[i], meta[i], out + offsets[i]);
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch K41 and K42 need over n lanes
SRT_API size_t srt_cast_format_scratch_bytes(long long n) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(n + 1);
  c.take<uint32_t>(scan_scratch_elems(n + 1));
  c.take<long long>(n);
  c.take<int32_t>(n);
  return c.used;
}

// K41. mode 0 int (in: bytes 1, 2, 4 or 8 a value), 1 bool (1 byte), 2
// date (int32 days), 3 timestamp (int64 microseconds); valid: bool [n];
// offsets: int32 [n + 1]; out: uint8 [out_cap], at least the mode's width
// times n.
SRT_API int srt_format_fixed(int mode, const void* in, int bytes,
                             const uint8_t* valid, long long n,
                             int32_t* offsets, uint8_t* out,
                             long long out_cap, void* scratch,
                             size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static const int width[4] = {20, 5, 14, 30};
  if (n < 0 || mode < 0 || mode > 3 || n >= 0x7FFFFFFFLL ||
      out_cap < width[mode] * n ||
      scratch_bytes < srt_cast_format_scratch_bytes(n))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* lens = c.take<uint32_t>(n + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(n + 1));
  fixed_len_kernel<<<grid_for(n + 1), kThreads, 0, st>>>(mode, in, bytes,
                                                         valid, n, lens);
  SRT_LAUNCHED("fixed_len_kernel");
  SRT_TRY(scan_u32(lens, reinterpret_cast<uint32_t*>(offsets), n + 1,
                   scan_scratch, nullptr, false, st));
  if (n == 0) return 0;
  fixed_write_kernel<<<grid_for(n), kThreads, 0, st>>>(mode, in, bytes, valid,
                                                       n, offsets, out);
  SRT_LAUNCHED("fixed_write_kernel");
  return 0;
}

// K42. in: float32 (is32 1) or float64 [n]; valid: bool [n]; p10f: the
// float64 power table [687] (10^-343 .. 10^343); offsets: int32 [n + 1];
// out: uint8 [out_cap], at least 26 n.
SRT_API int srt_format_float(const void* in, int is32, const uint8_t* valid,
                             long long n, const double* p10f,
                             int32_t* offsets, uint8_t* out,
                             long long out_cap, void* scratch,
                             size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n >= 0x7FFFFFFFLL || out_cap < 26 * n ||
      scratch_bytes < srt_cast_format_scratch_bytes(n))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* lens = c.take<uint32_t>(n + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(n + 1));
  long long* mant = c.take<long long>(n);
  int32_t* meta = c.take<int32_t>(n);
  float_plan_kernel<<<grid_for(n + 1), kThreads, 0, st>>>(
      in, is32, valid, n, p10f, mant, meta, lens);
  SRT_LAUNCHED("float_plan_kernel");
  SRT_TRY(scan_u32(lens, reinterpret_cast<uint32_t*>(offsets), n + 1,
                   scan_scratch, nullptr, false, st));
  if (n == 0) return 0;
  float_write_kernel<<<grid_for(n), kThreads, 0, st>>>(valid, n, mant, meta,
                                                       offsets, out);
  SRT_LAUNCHED("float_write_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
