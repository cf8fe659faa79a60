// K5 string_hash_words: per string row, the two polynomial hash words and
// the byte length that the group-by and the hash exchange use for a STRING
// key.
//
// Replaces spark_rapids_tpu/ops/hashing.py:_string_words_device (with its
// _pow_mod32), as reached through exec/rowkeys.py:key_proxy and
// ops/hashing.py:hash_columns. For row i with bytes b[0..len):
//   h1 = sum_k b[k] * 31^(len-1-k)       mod 2^32  (Horner, x31)
//   h2 = sum_k b[k] * 1000003^(len-1-k)  mod 2^32  (Horner, x1000003)
//   len = the byte length
// all three 0 at NULL rows. uint32 multiply-add wraps exactly mod 2^32, so
// Horner's rule gives the reference's power sums bit for bit, and the CPU
// engine's host words (the plain version over the same bytes) co-partition
// with the card's.
//
// Bound: memory. It reads the offsets, the validity and every byte once,
// and writes three uint32 words a row.
//
// Design: one thread per row walks its bytes. The bytes of neighbouring
// rows are neighbours, so a warp's loads mostly share cache lines. A warp
// per row with a shuffle reduction of b[k] * base^(len-1-k) is the later
// speed step for long strings.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__global__ void string_hash_kernel(const int32_t* __restrict__ offsets,
                                   const uint8_t* __restrict__ bytes,
                                   const uint8_t* __restrict__ valid,
                                   long long n, uint32_t* __restrict__ h1,
                                   uint32_t* __restrict__ h2,
                                   uint32_t* __restrict__ len) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t a1 = 0u, a2 = 0u, l = 0u;
    if (valid[i]) {
      const int32_t s = offsets[i];
      const int32_t e = offsets[i + 1];
      for (int32_t p = s; p < e; ++p) {
        const uint32_t b = bytes[p];
        a1 = a1 * 31u + b;
        a2 = a2 * 1000003u + b;
      }
      l = (uint32_t)(e - s);
    }
    h1[i] = a1;
    h2[i] = a2;
    len[i] = l;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// offsets: int32 [n + 1]; bytes: uint8; valid: bool [n];
// words: uint32 [3][n] (h1 row, h2 row, length row).
SRT_API int srt_string_hash_words(const int32_t* offsets,
                                  const uint8_t* bytes, const uint8_t* valid,
                                  long long n, uint32_t* words,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const long long blocks = std::min<long long>(ceil_div(n, kThreads), 65536);
  string_hash_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      offsets, bytes, valid, n, words, words + n, words + 2 * n);
  SRT_LAUNCHED("string_hash_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
