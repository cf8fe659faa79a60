// K43 parse_float and K44 parse_timestamp: the casts from STRING (B16's
// parsing half, columnar/parse.py).
//
// - K43 replaces spark_rapids_tpu/columnar/parse.py:_parse_float_kernel
//   (:79, with _trimmed_window :50) and parse_float_col (:262): each row
//   trimmed of ASCII whitespace (0x20, 0x09-0x0D), then
//   [+-]? (digits [. digits*] | . digits+) ([eE] [+-]? d{1,3})? or
//   [+-]? (inf | infinity | nan) in any case, at most 48 characters; the
//   first 17 significant digits fold into an int64 mantissa m (later
//   integer digits raise the exponent, later fraction digits are
//   dropped), and the value is m * 10^q with one rounding through the
//   shared chain (format.py:f64_scale_int: m split into two exact halves,
//   the pair scaled by chunks of at most 10^22 through Dekker's error-free
//   product behind an exact 2^+-600 prescale, collapsed once). FLOAT rounds
//   the double, then flushes results below 2^-126 to a signed zero.
// - K44 replaces _parse_timestamp_kernel (:173) and parse_timestamp_col
//   (:283): 'YYYY-MM-DD' or 'YYYY-MM-DD[ T]HH:MM:SS[.f{1,6}][Z|+-HH:MM]'
//   after the trim, the date checked by a round trip through the civil
//   calendar, hours < 24 and minutes < 60 in the zone. Like the
//   reference, it looks at the first 32 characters of the trimmed row: a
//   zone character past them reads the 32nd (:226-229).
//
// A row that does not parse, an empty one included, is NULL and flagged
// malformed (an ANSI cast raises on it; the plan rewrite keeps ANSI casts
// on the CPU engine). The reference gathers a [rows, 48] byte matrix and
// runs the grammar as cumulative sums over it, because an unrolled scan
// compiles for minutes under XLA; here a thread walks its own row once.
// These kernels stay apart from the CSV scan's (K33-K35): a CSV field that
// fails goes to the host grammar, a cast that fails gives NULL.
//
// The arithmetic is the reference's operation for operation over the same
// power table (format.py:_P10F, read through __ldg); this file is built
// with -fmad=false (cuda_build.py:SOURCE_FLAGS), never with fast math.
//
// Bound: memory: the offsets, the row bytes and the validity read, the
// value (8 or 4 bytes) and two flag bytes written. A row of the path is
// 6-30 bytes, so neighbouring threads read bytes that far apart.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kP10fOff = 343;
constexpr int kMaxwFloat = 48;
constexpr int kMaxwTs = 32;

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

__device__ __forceinline__ bool is_ws(int b) {
  return b == 32 || (b >= 9 && b <= 13);
}

__device__ __forceinline__ bool is_digit(int c) {
  return c >= '0' && c <= '9';
}

// a row's trimmed span [s, s + len)
__device__ __forceinline__ void trimmed(const uint8_t* bytes, long long a,
                                        long long b, long long* s,
                                        long long* len) {
  while (a < b && is_ws(bytes[a])) ++a;
  while (b > a && is_ws(bytes[b - 1])) --b;
  *s = a;
  *len = b - a;
}

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

// format.py:f64_scale
__device__ double f64_scale(const double* P, double x, long long k) {
  if (k >= -22 && k <= 22) return x * p10(P, k);
  const long long k1 = floor_div(k, 2);
  return (x * p10(P, k1)) * p10(P, k - k1);
}

// format.py:f64_scale_int (0 <= m < 10^18); a chunk of 0 leaves a
// normalised pair as it is, so the chain stops when rem reaches 0
__device__ double f64_scale_int(const double* P, long long m, long long k) {
  const long long mq = floor_div(m, 100000000LL);
  const double hi = (double)mq;
  const double lo = (double)(m - mq * 100000000LL);
  double p1, e1, h, l;
  two_prod(hi, 1e8, &p1, &e1);
  fast_two_sum(p1, e1 + lo, &h, &l);
  const double s2 = k < -250 ? 0x1p+600 : (k > 250 ? 0x1p-600 : 1.0);
  const bool scaled = s2 != 1.0;  // times or over 1.0 changes nothing
  if (scaled) {
    h = h * s2;
    l = l * s2;
  }
  long long rem = k;
  for (int c = 0; c < 19 && rem != 0; ++c) chunk_step(P, &h, &l, &rem);
  if (scaled) {
    h = h / s2;
    l = l / s2;
  }
  const double out = h + l;
  return isnan(out) ? f64_scale(P, (double)m, k) : out;
}

// the reference's grammar over one trimmed row c[0, len) (len <= 48)
__device__ bool parse_float_row(const uint8_t* c, int len, const double* P,
                                double* value) {
  const int c0 = len > 0 ? c[0] : 0;
  const bool neg = c0 == '-';
  const int body0 = (c0 == '-' || c0 == '+') ? 1 : 0;
  // inf / infinity / nan, any case, filling the rest of the row
  const int rest = len - body0;
  auto word = [&](const char* w, int wl) -> bool {
    if (rest != wl) return false;
    for (int j = 0; j < wl; ++j) {
      int ch = c[body0 + j];
      if (ch >= 'A' && ch <= 'Z') ch += 32;
      if (ch != w[j]) return false;
    }
    return true;
  };
  const bool is_inf = word("inf", 3) || word("infinity", 8);
  const bool is_nan = word("nan", 3);

  bool bad = false, in_exp = false, seen_dot = false, started = false,
       exp_neg = false;
  int ndots = 0, ndig = 0, crank = 0, scale = 0, dropped = 0, nde = 0,
      exp_val = 0, e_pos = -1;
  long long m = 0;
  for (int k = body0; k < len; ++k) {
    const int ch = c[k];
    if (!in_exp) {
      if (ch == 'e' || ch == 'E') {
        in_exp = true;
        e_pos = k;
      } else if (is_digit(ch)) {
        const int d = ch - '0';
        ++ndig;
        started = started || d > 0;
        if (started) ++crank;
        if (crank <= 17) {
          m = m * 10 + d;
          if (seen_dot) ++scale;
        } else if (!seen_dot) {
          ++dropped;
        }
      } else if (ch == '.') {
        ++ndots;
        seen_dot = true;
      } else {
        bad = true;
      }
    } else if (k == e_pos + 1 && (ch == '+' || ch == '-')) {
      exp_neg = ch == '-';
    } else if (is_digit(ch)) {
      ++nde;
      if (nde <= 3) exp_val = exp_val * 10 + (ch - '0');
    } else {
      bad = true;
    }
  }
  const bool grammar_ok = !bad && ndots <= 1 && ndig > 0 &&
                          (!in_exp || nde >= 1) && nde <= 3 &&
                          len <= kMaxwFloat && len > body0;
  long long q = (long long)(exp_neg ? -exp_val : exp_val) - scale + dropped;
  q = q < -400 ? -400 : (q > 400 ? 400 : q);
  double v = (is_inf || is_nan) ? 0.0 : f64_scale_int(P, m, q);
  if (is_inf) v = __longlong_as_double(0x7FF0000000000000LL);
  if (is_nan) v = __longlong_as_double(0x7FF8000000000000LL);
  *value = neg ? -v : v;
  return (grammar_ok || is_inf || is_nan) && len > 0;
}

__global__ void parse_float_kernel(const int32_t* __restrict__ offsets,
                                   const uint8_t* __restrict__ bytes,
                                   const uint8_t* __restrict__ valid,
                                   long long n, const double* __restrict__ P,
                                   int to32, void* __restrict__ out,
                                   uint8_t* __restrict__ out_valid,
                                   uint8_t* __restrict__ malformed) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long s, len;
    trimmed(bytes, offsets[i], offsets[i + 1], &s, &len);
    double v = 0.0;
    const bool parsed =
        len > 0 && len <= kMaxwFloat &&
        parse_float_row(bytes + s, (int)len, P, &v);
    const bool ok = parsed && valid[i];
    if (to32) {
      float f = __double2float_rn(v);
      if (fabsf(f) < 0x1p-126f) f = signbit(v) ? -0.0f : 0.0f;
      static_cast<float*>(out)[i] = ok ? f : 0.0f;
    } else {
      static_cast<double*>(out)[i] = ok ? v : 0.0;
    }
    out_valid[i] = ok ? 1 : 0;
    malformed[i] = (!parsed && valid[i]) ? 1 : 0;
  }
}

// ------------------------------------------------------------------- K44
// the trimmed row's first 32 characters, 0 past them or the row
struct Window {
  const uint8_t* c;
  long long len;
  __device__ int at(long long k) const {
    return (k < len && k < kMaxwTs) ? c[k] : 0;
  }
  __device__ int dig(long long k) const { return at(k) - '0'; }
  __device__ bool isd(long long k) const { return is_digit(at(k)); }
};

__device__ bool parse_ts_row(const Window& w, long long* us) {
  const long long len = w.len;
  bool date_ok = len >= 10 && w.at(4) == '-' && w.at(7) == '-';
  const int dpos[8] = {0, 1, 2, 3, 5, 6, 8, 9};
#pragma unroll
  for (int i = 0; i < 8; ++i) date_ok = date_ok && w.isd(dpos[i]);
  const long long y = w.dig(0) * 1000LL + w.dig(1) * 100 + w.dig(2) * 10 +
                      w.dig(3);
  const long long mo = w.dig(5) * 10LL + w.dig(6);
  const long long d = w.dig(8) * 10LL + w.dig(9);
  const long long days = days_from_civil(y, mo, d);
  date_ok = date_ok && civil_round_trip(days, y, mo, d);
  const bool date_only = date_ok && len == 10;
  const bool has_time = date_ok && len >= 19;
  bool time_ok = has_time;
  const int tpos[6] = {11, 12, 14, 15, 17, 18};
#pragma unroll
  for (int i = 0; i < 6; ++i) time_ok = time_ok && w.isd(tpos[i]);
  const int sep = w.at(10);
  time_ok = time_ok && (sep == ' ' || sep == 'T') && w.at(13) == ':' &&
            w.at(16) == ':';
  const long long hh = w.dig(11) * 10LL + w.dig(12);
  const long long mi = w.dig(14) * 10LL + w.dig(15);
  const long long ss = w.dig(17) * 10LL + w.dig(18);
  time_ok = time_ok && hh < 24 && mi < 60 && ss < 60;
  // an optional fraction: '.' and 1-6 digits
  const bool has_dot = time_ok && len > 19 && w.at(19) == '.';
  int fd = 0;
  long long frac = 0;
  if (has_dot) {
    for (int p = 20; p < 26 && p < len && w.isd(p); ++p) {
      frac = frac * 10 + w.dig(p);
      ++fd;
    }
  }
  const bool frac_ok = !has_dot || fd >= 1;
  for (int k = fd; k < 6; ++k) frac *= 10;
  // an optional zone: 'Z' or +-HH:MM; a position past the window reads its
  // last character, as the reference's clipped gather
  const long long zs = has_dot ? 20 + fd : 19;
  const long long zl = has_time ? len - zs : 0;
  auto z = [&](int k) -> int {
    const long long p = zs + k;
    return p < len ? w.at(p < kMaxwTs - 1 ? p : kMaxwTs - 1) : 0;
  };
  auto zd = [&](int k) -> int { return z(k) - '0'; };
  auto zisd = [&](int k) -> bool { return is_digit(z(k)); };
  const int sign = z(0);
  const bool zsigned = sign == '+' || sign == '-';
  const bool z_utc = zl == 1 && sign == 'Z';
  const long long zh = zd(1) * 10LL + zd(2);
  const long long zm = zd(4) * 10LL + zd(5);
  const bool z_off = zl == 6 && zsigned && zisd(1) && zisd(2) &&
                     z(3) == ':' && zisd(4) && zisd(5) && zh < 24 && zm < 60;
  long long off_min = z_off ? zh * 60 + zm : 0;
  if (z_off && sign == '-') off_min = -off_min;
  const bool zone_ok = zl == 0 || z_utc || z_off;
  const bool full_ok = time_ok && frac_ok && zone_ok;
  const bool parsed = (date_only || full_ok) && len > 0;
  long long micros = days * 86400000000LL;
  if (full_ok)
    micros += (hh * 3600 + mi * 60 + ss) * 1000000LL + frac -
              off_min * 60000000LL;
  *us = parsed ? micros : 0;
  return parsed;
}

__global__ void parse_ts_kernel(const int32_t* __restrict__ offsets,
                                const uint8_t* __restrict__ bytes,
                                const uint8_t* __restrict__ valid,
                                long long n, long long* __restrict__ out,
                                uint8_t* __restrict__ out_valid,
                                uint8_t* __restrict__ malformed) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long s, len;
    trimmed(bytes, offsets[i], offsets[i + 1], &s, &len);
    long long us = 0;
    const bool parsed = parse_ts_row(Window{bytes + s, len}, &us);
    const bool ok = parsed && valid[i];
    out[i] = ok ? us : 0;
    out_valid[i] = ok ? 1 : 0;
    malformed[i] = (!parsed && valid[i]) ? 1 : 0;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// K43. offsets: int32 [n + 1] into bytes [n_bytes]; valid: bool [n]; p10f:
// the float64 power table [687]; to32: out float32 (else float64) [n];
// out_valid, malformed: bool [n].
SRT_API int srt_parse_float(const int32_t* offsets, const uint8_t* bytes,
                            long long n_bytes, const uint8_t* valid,
                            long long n, const double* p10f, int to32,
                            void* out, uint8_t* out_valid,
                            uint8_t* malformed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n_bytes < 0) return fail(cudaErrorInvalidValue, "arguments");
  if (n == 0) return 0;
  parse_float_kernel<<<grid_for(n), kThreads, 0, st>>>(
      offsets, bytes, valid, n, p10f, to32, out, out_valid, malformed);
  SRT_LAUNCHED("parse_float_kernel");
  return 0;
}

// K44. out: int64 epoch microseconds [n]; the rest as K43's.
SRT_API int srt_parse_timestamp(const int32_t* offsets, const uint8_t* bytes,
                                long long n_bytes, const uint8_t* valid,
                                long long n, long long* out,
                                uint8_t* out_valid, uint8_t* malformed,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n_bytes < 0) return fail(cudaErrorInvalidValue, "arguments");
  if (n == 0) return 0;
  parse_ts_kernel<<<grid_for(n), kThreads, 0, st>>>(offsets, bytes, valid, n,
                                                    out, out_valid,
                                                    malformed);
  SRT_LAUNCHED("parse_ts_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
