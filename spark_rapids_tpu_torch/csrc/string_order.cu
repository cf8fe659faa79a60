// K6 string_order_words: the order-preserving words of a STRING sort key,
// the operands kernel K1 sorts on.
//
// Replaces the string half of spark_rapids_tpu/exec/rowkeys.py:key_proxy's
// ordering form, string_order_proxy, with _string_chunk_keys and
// columnar/strings.py:_chunk_u64 / _chunk_u32. Per row, word k holds bytes
// [4k, 4k + 4) of the string big-endian, zero past its end (a uint64 chunk
// of the reference is two such words, high first); the last word is the
// byte length, which sorts a string after every proper prefix of it. All
// words are 0 at NULL rows (the null flag is a word of its own). Comparing
// the words lexicographically as unsigned integers is comparing the UTF-8
// bytes, which is comparing code points, as the reference does.
//
// The number of chunk words comes from the column's host-known max_len
// bound (1 word up to 4 bytes, 2 up to 8, else 2 per pow2-bucketed uint64
// chunk), so the sort adds no device sync.
//
// Bound: memory. It reads the offsets, the validity and the bytes a row
// needs once, and writes n_words uint32 words a row.
//
// Design: one thread per row; each word is one 4-byte big-endian load
// assembled from bytes (rows start at any byte offset).
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__global__ void string_order_kernel(const int32_t* __restrict__ offsets,
                                    const uint8_t* __restrict__ bytes,
                                    const uint8_t* __restrict__ valid,
                                    long long n, int n_chunk_words,
                                    uint32_t* __restrict__ words) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const bool v = valid[i] != 0;
    const int32_t s = offsets[i];
    const int32_t len = v ? offsets[i + 1] - s : 0;
    for (int k = 0; k < n_chunk_words; ++k) {
      uint32_t w = 0u;
      const int32_t at = 4 * k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = at + j < len ? (uint32_t)bytes[s + at + j] : 0u;
        w = (w << 8) | b;
      }
      words[(long long)k * n + i] = w;
    }
    words[(long long)n_chunk_words * n + i] = (uint32_t)len;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// offsets: int32 [n + 1]; bytes: uint8; valid: bool [n];
// words: uint32 [n_chunk_words + 1][n].
SRT_API int srt_string_order_words(const int32_t* offsets,
                                   const uint8_t* bytes, const uint8_t* valid,
                                   long long n, int n_chunk_words,
                                   uint32_t* words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n_chunk_words < 1) return fail(cudaErrorInvalidValue, "arguments");
  const long long blocks = std::min<long long>(ceil_div(n, kThreads), 65536);
  string_order_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      offsets, bytes, valid, n, n_chunk_words, words);
  SRT_LAUNCHED("string_order_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
