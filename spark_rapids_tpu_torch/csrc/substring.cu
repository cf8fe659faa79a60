// K13 substring_plan: Spark SUBSTRING(str, pos, len) over UTF-8 code
// points — for each row, the byte span of the result. Kernel K7 then copies
// the spans' bytes under new offsets (TPC-H q22's SUBSTRING(c_phone, 1, 2)).
//
// Replaces the plan half of spark_rapids_tpu/columnar/strings.py:
// substring_utf8 (:284-320), bit for bit:
// - a character starts at every byte with (b & 0xC0) != 0x80;
// - pos > 0 is 1-based, pos 0 acts as 1, a negative pos counts from the
//   end and clamps at 0; a negative length gives the empty string, and so
//   does a pos past the end (the row stays valid);
// - the arithmetic is the reference's int32, which wraps (pos + len past
//   2^31 - 1);
// - a row that starts with a continuation byte (invalid UTF-8) gets the
//   reference's character numbering: its leading continuation bytes are
//   character 0, unless no character starts anywhere before the row, in
//   which case character 0 is the row's first character start.
// Output: spans int32 [2n + 1], row i's bytes at spans[2i]:spans[2i + 1]
// (the odd spans lie between rows and are never taken), and span_valid
// [2n] (the row's validity at 2i, 0 at 2i + 1), so K7 gathers the result
// with indices 0, 2, 4, ...
//
// Bound: memory. It reads the offsets, the validity and each row's bytes
// once (and the position and length, or one value of each), and writes
// the spans and their validity once.
//
// Design: one thread per row counts the row's character starts, then
// walks the row again to the two characters it needs. Rows are short (15
// bytes for c_phone), and neighbouring rows' bytes share cache lines. Only
// a row that starts with a continuation byte looks back, to the nearest
// character start before it.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__device__ __forceinline__ bool char_start(uint8_t b) {
  return (b & 0xC0) != 0x80;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// byte position of the idx-th character start of the row, or its end
__device__ __forceinline__ long long nth_start(const uint8_t* row,
                                               long long s, long long len,
                                               int32_t idx, int32_t m) {
  if (idx >= m) return s + len;
  int32_t c = 0;
  for (long long k = 0; k < len; ++k) {
    if (char_start(row[k])) {
      if (c == idx) return s + k;
      ++c;
    }
  }
  return s + len;
}

__global__ void substring_plan_kernel(
    const int32_t* __restrict__ offsets, const uint8_t* __restrict__ bytes,
    const uint8_t* __restrict__ valid, long long n,
    const int32_t* __restrict__ pos, long long pos_stride,
    const int32_t* __restrict__ length, long long len_stride,
    int32_t* __restrict__ spans, uint8_t* __restrict__ span_valid) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long s = offsets[i];
    const long long len = (long long)offsets[i + 1] - s;
    long long b0 = s, b1 = s;
    if (len > 0) {
      const uint8_t* row = bytes + s;
      int32_t m = 0;
      for (long long k = 0; k < len; ++k) m += char_start(row[k]) ? 1 : 0;
      const bool lead = char_start(row[0]);
      bool none_before = false;
      if (!lead) {
        none_before = true;
        for (long long j = s - 1; j >= 0; --j) {
          if (char_start(bytes[j])) {
            none_before = false;
            break;
          }
        }
      }
      const int32_t p = pos[i * pos_stride];
      const int32_t want = max(length[i * len_stride], 0);
      const int32_t p0 = p < 0 ? max(wrap_add(m, p), 0)
                               : max(wrap_add(p, -1), 0);
      const int32_t lo = min(p0, m);
      const int32_t hi = min(wrap_add(p0, want), m);
      // character k -> byte, in the reference's numbering
      auto to_byte = [&](int32_t k) -> long long {
        if (lead) return k <= 0 ? s : nth_start(row, s, len, k, m);
        if (none_before) {
          const int32_t g = wrap_add(k, -1);  // wraps for k = INT_MIN
          return nth_start(row, s, len, g < 0 ? 0 : g, m);
        }
        return k <= 0 ? s : nth_start(row, s, len, k - 1, m);
      };
      b0 = to_byte(lo);
      b1 = max(to_byte(hi), b0);
    }
    spans[2 * i] = (int32_t)b0;
    spans[2 * i + 1] = (int32_t)b1;
    span_valid[2 * i] = valid[i];
    span_valid[2 * i + 1] = 0;
    if (i == n - 1) spans[2 * n] = offsets[n];
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// offsets: int32 [n + 1]; bytes: the column's uint8 buffer; valid: bool
// [n]; pos, length: int32 with a row stride of 1 (a column) or 0 (one
// value); spans: int32 [2n + 1]; span_valid: bool [2n].
SRT_API int srt_substring_plan(const int32_t* offsets, const uint8_t* bytes,
                               const uint8_t* valid, long long n,
                               const int32_t* pos, long long pos_stride,
                               const int32_t* length, long long len_stride,
                               int32_t* spans, uint8_t* span_valid,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    SRT_CALL(cudaMemsetAsync(spans, 0, sizeof(int32_t), st), "memset spans");
    return 0;
  }
  const long long blocks = std::min<long long>(ceil_div(n, kThreads), 65536);
  substring_plan_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      offsets, bytes, valid, n, pos, pos_stride, length, len_stride, spans,
      span_valid);
  SRT_LAUNCHED("substring_plan_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
