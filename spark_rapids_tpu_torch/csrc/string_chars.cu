// K17 string_chars: per row of a STRING column, its character count, or
// the 1-based character position of a literal needle.
//
// Replaces spark_rapids_tpu/columnar/strings.py:utf8_char_lengths (:260)
// and locate (:542, with _match_starts :484). A character starts at every
// byte that is not a UTF-8 continuation byte (10xxxxxx), so invalid UTF-8
// counts as the reference counts it.
//   LENGTHS: the count of character starts in the row's bytes.
//   LOCATE(needle, start): 0 for every row when start < 1; for an empty
//     needle, start when start <= characters + 1, else 0; otherwise the
//     first byte position p of the row where the needle matches and fits
//     inside the row (p + |needle| <= row end) and whose character
//     position (character starts in [row start, p)) is at least start - 1:
//     that position + 1, or 0 when there is none. Character positions
//     rise with p, so the first such p has the smallest one.
// NULL rows have length 0; their NULL result is the expression layer's.
//
// Bound: memory. It reads the offsets and each row's bytes once (LOCATE
// stops at the first match), and writes one int32 a row.
//
// Design: a warp per row (K12's thread per row scatters a warp's loads over
// 32 rows). The warp walks its row 32 bytes at a time, lane k on byte k:
// a ballot of the character starts gives each lane its character
// position, a ballot of the candidate matches the first one. The needle
// sits in shared memory (read from device memory when it is longer than
// kSharedNeedle).
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

enum { kLengths = 0, kLocate = 1 };
constexpr int kSharedNeedle = 16384;

__global__ void string_chars_kernel(const int32_t* __restrict__ offsets,
                                    const uint8_t* __restrict__ bytes,
                                    long long n,
                                    const uint8_t* __restrict__ needle,
                                    int needle_len, long long start,
                                    int mode, int32_t* __restrict__ out) {
  extern __shared__ uint8_t staged[];
  const uint8_t* nd = needle;
  if (mode == kLocate && needle_len <= kSharedNeedle) {
    for (int k = threadIdx.x; k < needle_len; k += blockDim.x)
      staged[k] = needle[k];
    __syncthreads();
    nd = staged;
  }
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long warps_per_grid = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
       row < n; row += warps_per_grid) {
    const long long s = offsets[row];
    const long long e = offsets[row + 1];
    int32_t result = 0;
    if (mode == kLocate && start < 1) {
      result = 0;
    } else if (mode == kLengths || needle_len == 0) {
      int chars = 0;
      for (long long base = s; base < e; base += 32) {
        const long long p = base + lane;
        const bool st = p < e && (bytes[p] & 0xC0) != 0x80;
        chars += __popc(__ballot_sync(0xFFFFFFFFu, st));
      }
      if (mode == kLengths)
        result = chars;
      else
        result = start <= (long long)chars + 1 ? (int32_t)start : 0;
    } else {
      long long chars_before = 0;  // character starts in [s, base)
      for (long long base = s; base < e; base += 32) {
        const long long p = base + lane;
        const bool in_row = p < e;
        const uint8_t b = in_row ? bytes[p] : 0;
        const unsigned starts =
            __ballot_sync(0xFFFFFFFFu, in_row && (b & 0xC0) != 0x80);
        const long long char_pos = chars_before + __popc(starts & below);
        bool cand = in_row && p + needle_len <= e &&
                    char_pos >= start - 1 && b == nd[0];
        for (int k = 1; cand && k < needle_len; ++k)
          cand = bytes[p + k] == nd[k];
        const unsigned hits = __ballot_sync(0xFFFFFFFFu, cand);
        if (hits != 0u) {
          const int first = __ffs(hits) - 1;
          const long long pos = __shfl_sync(0xFFFFFFFFu, char_pos, first);
          result = (int32_t)(pos + 1);
          break;
        }
        chars_before += __popc(starts);
      }
    }
    if (lane == 0) out[row] = result;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// offsets: int32 [n + 1]; bytes: the column's uint8 buffer; needle: uint8
// [needle_len] in device memory (LOCATE); mode 0 LENGTHS, 1 LOCATE; out:
// int32 [n].
SRT_API int srt_string_chars(const int32_t* offsets, const uint8_t* bytes,
                             long long n,
                             const uint8_t* needle, int needle_len,
                             long long start, int mode, int32_t* out,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (mode < kLengths || mode > kLocate || needle_len < 0)
    return (int)fail(cudaErrorInvalidValue, "string_chars arguments");
  const long long warps_per_block = kThreads / 32;
  const long long blocks =
      std::min<long long>(ceil_div(n, warps_per_block), 65536);
  const size_t shared =
      mode == kLocate && needle_len <= kSharedNeedle ? (size_t)needle_len : 0;
  string_chars_kernel<<<(unsigned)blocks, kThreads, shared, st>>>(
      offsets, bytes, n, needle, needle_len, start, mode, out);
  SRT_LAUNCHED("string_chars_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
