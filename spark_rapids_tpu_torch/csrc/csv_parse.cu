// K33 csv_parse_int, K34 csv_parse_float, K35 csv_parse_datetime and K36
// csv_null_sentinels: the device half of a CSV split's parse
// (io/csv_device.py). The host finds every field's (start, length)
// (native/srt_io.cpp); these kernels read each field's bytes straight from
// the split's raw bytes, one thread a field, and write a value and a
// validity byte a row.
//
// They replace spark_rapids_tpu/io/csv_device.py:_parse_int_kernel (:285,
// with the narrowing of decode_int_column :387), _parse_float_kernel
// (:322), _parse_date_kernel (:417) and _parse_timestamp_kernel (:451),
// and _match_sentinels_kernel (:594). The reference gathered a [rows,
// maxw] byte matrix and folded it column by column; here each thread walks
// its own field. The grammars are the reference's to the byte, so a field
// malformed there is malformed here: a malformed field ORs 1 into one
// device flag a chunk (the host reads it once and sends that chunk to its
// host parser).
//
// K34 divides the mantissa (at most 15 digits, exact in a double) by the
// power of ten (exact to 10^22) with __ddiv_rn: the correctly rounded
// quotient, bit for bit the host parser's double. Nothing here may be
// built with fast math.
//
// Bound: memory. Each kernel reads a field's bytes, its start and length,
// and writes the value and a validity byte.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kMaxInt = 20;    // int64: 19 digits and a sign
constexpr int kMaxFloat = 24;  // float: a sign, 15 digits, a dot, slack
constexpr int kMaxDate = 10;
constexpr int kMaxTs = 32;
constexpr int kSentinelMax = 8;
constexpr int kSentinels = 16;

// The non-empty null spellings of pyarrow's CSV reader (csv_device.py:
// NULL_SENTINELS), NUL-padded, with their lengths.
__constant__ char kSentinel[kSentinels][kSentinelMax + 1] = {
    "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"};
__constant__ int kSentinelLen[kSentinels] = {4, 8, 3, 7, 8, 4, 4,
                                             6, 7, 3, 2, 4, 3, 3, 3, 4};

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 1 << 20));
}

// Byte k of a field, as the reference gathers it: 0 at or past the field's
// length, and a position past the buffer reads its last byte.
struct Field {
  const uint8_t* raw;
  long long n_raw;
  long long start;
  int len;
  __device__ __forceinline__ int at(int k) const {
    if (k >= len) return 0;
    long long p = start + k;
    if (p > n_raw - 1) p = n_raw - 1;
    if (p < 0) p = 0;
    return n_raw > 0 ? (int)raw[p] : 0;
  }
};

__device__ __forceinline__ bool is_digit(int c) {
  return c >= '0' && c <= '9';
}

// (layout ok, epoch days, civil ok) of a field's YYYY-MM-DD prefix
__device__ bool parse_civil(const Field& f, long long* days) {
  int dg[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) dg[k] = f.at(k) - '0';
  bool layout = f.at(4) == '-' && f.at(7) == '-';
  const int pos[8] = {0, 1, 2, 3, 5, 6, 8, 9};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    layout = layout && dg[pos[i]] >= 0 && dg[pos[i]] <= 9;
  const long long y = dg[0] * 1000LL + dg[1] * 100 + dg[2] * 10 + dg[3];
  const long long m = dg[5] * 10LL + dg[6];
  const long long d = dg[8] * 10LL + dg[9];
  *days = days_from_civil(y, m, d);
  return layout && civil_round_trip(*days, y, m, d);
}

__device__ __forceinline__ void mark(int* flag, bool bad) {
  if (bad) atomicOr(flag, 1);
}

template <typename T>
__device__ __forceinline__ void put(void* out, long long i, long long v) {
  static_cast<T*>(out)[i] = (T)v;
}

__global__ void parse_int_kernel(const uint8_t* __restrict__ raw,
                                 long long n_raw,
                                 const int32_t* __restrict__ starts,
                                 const int32_t* __restrict__ lens,
                                 long long n, long long cap, int out_bytes,
                                 void* __restrict__ out,
                                 uint8_t* __restrict__ valid,
                                 int* __restrict__ flag) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    long long v = 0;
    bool ok = false, bad = false;
    if (i < n) {
      const Field f{raw, n_raw, starts[i], lens[i]};
      const bool neg = f.at(0) == '-';
      const int skip = neg ? 1 : 0;
      const unsigned long long imax = 0x7FFFFFFFFFFFFFFFull;
      unsigned long long val = 0;
      bool digits = true, overflow = false;
      for (int k = skip; k < kMaxInt && k < f.len; ++k) {
        const int c = f.at(k);
        const bool dig = is_digit(c);
        const unsigned long long d = dig ? (unsigned long long)(c - '0') : 0;
        digits = digits && dig;
        // caught before val * 10 + d passes int64's maximum
        overflow = overflow || val > (imax - d) / 10;
        val = val * 10 + d;
      }
      ok = digits && f.len - skip > 0 && f.len <= kMaxInt && !overflow;
      bad = f.len > 0 && !ok;
      v = neg ? -(long long)val : (long long)val;
      if (!ok) v = 0;
      if (ok && out_bytes < 8) {
        const long long hi = (1LL << (8 * out_bytes - 1)) - 1;
        if (v < -hi - 1 || v > hi) {  // valid but out of the type's range
          bad = true;
          v = 0;
        }
      }
    }
    switch (out_bytes) {
      case 1: put<int8_t>(out, i, v); break;
      case 2: put<int16_t>(out, i, v); break;
      case 4: put<int32_t>(out, i, v); break;
      default: put<long long>(out, i, v); break;
    }
    valid[i] = ok ? 1 : 0;
    mark(flag, bad);
  }
}

__global__ void parse_float_kernel(const uint8_t* __restrict__ raw,
                                   long long n_raw,
                                   const int32_t* __restrict__ starts,
                                   const int32_t* __restrict__ lens,
                                   long long n, long long cap,
                                   double* __restrict__ out,
                                   uint8_t* __restrict__ valid,
                                   int* __restrict__ flag) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    double v = 0.0;
    bool ok = false, bad = false;
    if (i < n) {
      const Field f{raw, n_raw, starts[i], lens[i]};
      const bool neg = f.at(0) == '-';
      const int skip = neg ? 1 : 0;
      int ndots = 0, dotpos = 0;
      bool chars = true;
      long long m = 0;
      for (int k = skip; k < kMaxFloat && k < f.len; ++k) {
        const int c = f.at(k);
        if (c == '.') {
          if (ndots == 0) dotpos = k;
          ++ndots;
        } else if (is_digit(c)) {
          m = (long long)((unsigned long long)m * 10ull +
                          (unsigned long long)(c - '0'));
        } else {
          chars = false;
        }
      }
      const bool has_dot = ndots == 1;
      const int frac = has_dot ? f.len - 1 - dotpos : 0;
      const int ndig = f.len - skip - (has_dot ? 1 : 0);
      ok = chars && ndots <= 1 && ndig > 0 && ndig <= 15 && frac >= 0 &&
           frac <= 22 && f.len <= kMaxFloat;
      bad = f.len > 0 && !ok;
      if (ok) {
        double p10 = 1.0;
        for (int k = 0; k < frac; ++k) p10 *= 10.0;  // exact to 10^22
        v = __ddiv_rn((double)m, p10);
        if (neg) v = -v;
      }
    }
    out[i] = v;
    valid[i] = ok ? 1 : 0;
    mark(flag, bad);
  }
}

__device__ bool parse_timestamp(const Field& f, long long* us) {
  long long days = 0;
  const bool date_ok = f.len >= 19 && parse_civil(f, &days);
  int dg[19];
#pragma unroll
  for (int k = 11; k < 19; ++k) dg[k] = f.at(k) - '0';
  bool time_ok = true;
  const int tpos[6] = {11, 12, 14, 15, 17, 18};
#pragma unroll
  for (int i = 0; i < 6; ++i)
    time_ok = time_ok && dg[tpos[i]] >= 0 && dg[tpos[i]] <= 9;
  const int sep = f.at(10);
  time_ok = time_ok && (sep == ' ' || sep == 'T') && f.at(13) == ':' &&
            f.at(16) == ':';
  const long long hh = dg[11] * 10 + dg[12];
  const long long mi = dg[14] * 10 + dg[15];
  const long long ss = dg[17] * 10 + dg[18];
  time_ok = time_ok && hh < 24 && mi < 60 && ss < 60;
  // fraction: '.' at 19, then a run of 1-6 digits
  const bool has_dot = f.len > 19 && f.at(19) == '.';
  int fd = 0;
  long long frac = 0;
  if (has_dot) {
    for (int p = 20; p < 26 && p < f.len && is_digit(f.at(p)); ++p) {
      frac = frac * 10 + (f.at(p) - '0');
      ++fd;
    }
  }
  const bool frac_ok = !has_dot || fd >= 1;
  for (int k = fd; k < 6; ++k) frac *= 10;
  // the zone right after the seconds or the fraction
  const int zs = has_dot ? 20 + fd : 19;
  const int zl = f.len - zs;
  auto z = [&](int k) -> int {
    int p = zs + k;
    if (p > kMaxTs - 1) p = kMaxTs - 1;
    return zs + k < f.len ? f.at(p) : 0;
  };
  auto zd = [&](int k) -> bool { return is_digit(z(k)); };
  const int sign = z(0);
  const bool signed_ = sign == '+' || sign == '-';
  const bool z_utc = zl == 1 && sign == 'Z';
  const bool z_hh = zl == 3 && signed_ && zd(1) && zd(2);
  const bool z_hhmm = zl == 5 && signed_ && zd(1) && zd(2) && zd(3) && zd(4);
  const bool z_colon = zl == 6 && signed_ && zd(1) && zd(2) && z(3) == ':' &&
                       zd(4) && zd(5);
  const long long off_h = (z(1) - '0') * 10 + (z(2) - '0');
  const long long off_m = z_hhmm    ? (z(3) - '0') * 10 + (z(4) - '0')
                          : z_colon ? (z(4) - '0') * 10 + (z(5) - '0')
                                    : 0;
  const bool zone_ok =
      z_utc || ((z_hh || z_hhmm || z_colon) && off_h < 24 && off_m < 60);
  long long off_us = z_utc ? 0 : (off_h * 3600 + off_m * 60) * 1000000LL;
  if (sign == '-') off_us = -off_us;
  *us = days * 86400000000LL + (hh * 3600 + mi * 60 + ss) * 1000000LL +
        frac - off_us;
  return date_ok && time_ok && frac_ok && zone_ok;
}

__global__ void parse_datetime_kernel(const uint8_t* __restrict__ raw,
                                      long long n_raw,
                                      const int32_t* __restrict__ starts,
                                      const int32_t* __restrict__ lens,
                                      long long n, long long cap,
                                      int timestamp, void* __restrict__ out,
                                      uint8_t* __restrict__ valid,
                                      int* __restrict__ flag) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    long long v = 0;
    bool ok = false, bad = false;
    if (i < n) {
      const Field f{raw, n_raw, starts[i], lens[i]};
      if (timestamp) {
        ok = parse_timestamp(f, &v);
      } else {
        ok = f.len == kMaxDate && parse_civil(f, &v);
      }
      ok = ok && f.len > 0;
      bad = f.len > 0 && !ok;
      if (!ok) v = 0;
    }
    if (timestamp) {
      put<long long>(out, i, v);
    } else {
      put<int32_t>(out, i, v);
    }
    valid[i] = ok ? 1 : 0;
    mark(flag, bad);
  }
}

__global__ void null_sentinels_kernel(const uint8_t* __restrict__ raw,
                                      long long n_raw,
                                      const int32_t* __restrict__ starts,
                                      const int32_t* __restrict__ lens,
                                      long long n, long long cap,
                                      uint8_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    bool hit = false;
    if (i < n) {
      const Field f{raw, n_raw, starts[i], lens[i]};
      if (f.len >= 2 && f.len <= kSentinelMax) {
        int ch[kSentinelMax];
#pragma unroll
        for (int k = 0; k < kSentinelMax; ++k) ch[k] = f.at(k);
        for (int s = 0; s < kSentinels && !hit; ++s) {
          if (kSentinelLen[s] != f.len) continue;
          bool eq = true;
          for (int k = 0; k < kSentinelMax; ++k)
            eq = eq && ch[k] == (int)(unsigned char)kSentinel[s][k];
          hit = eq;
        }
      }
    }
    out[i] = hit ? 1 : 0;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// K33. raw: the split's bytes (n_raw); starts / lens: int32 spans of n
// fields; out: [cap] of out_bytes (1, 2, 4, 8) a value, valid: uint8
// [cap]; flag: int32, ORed with 1 when a field is malformed.
SRT_API int srt_csv_parse_int(const uint8_t* raw, long long n_raw,
                              const int32_t* starts, const int32_t* lens,
                              long long n, long long cap, int out_bytes,
                              void* out, uint8_t* valid, int* flag,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || cap < n || (out_bytes != 1 && out_bytes != 2 &&
                           out_bytes != 4 && out_bytes != 8))
    return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  parse_int_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      raw, n_raw, starts, lens, n, cap, out_bytes, out, valid, flag);
  SRT_LAUNCHED("parse_int_kernel");
  return 0;
}

// K34. out: double [cap].
SRT_API int srt_csv_parse_float(const uint8_t* raw, long long n_raw,
                                const int32_t* starts, const int32_t* lens,
                                long long n, long long cap, double* out,
                                uint8_t* valid, int* flag, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || cap < n) return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  parse_float_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      raw, n_raw, starts, lens, n, cap, out, valid, flag);
  SRT_LAUNCHED("parse_float_kernel");
  return 0;
}

// K35. timestamp 0: out int32 epoch days [cap]; 1: int64 epoch
// microseconds [cap].
SRT_API int srt_csv_parse_datetime(const uint8_t* raw, long long n_raw,
                                   const int32_t* starts,
                                   const int32_t* lens, long long n,
                                   long long cap, int timestamp, void* out,
                                   uint8_t* valid, int* flag, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || cap < n) return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  parse_datetime_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      raw, n_raw, starts, lens, n, cap, timestamp, out, valid, flag);
  SRT_LAUNCHED("parse_datetime_kernel");
  return 0;
}

// K36. out: uint8 [cap], 1 where the field is a null spelling.
SRT_API int srt_csv_null_sentinels(const uint8_t* raw, long long n_raw,
                                   const int32_t* starts,
                                   const int32_t* lens, long long n,
                                   long long cap, uint8_t* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || cap < n) return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  null_sentinels_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      raw, n_raw, starts, lens, n, cap, out);
  SRT_LAUNCHED("null_sentinels_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
