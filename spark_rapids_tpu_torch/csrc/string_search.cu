// K12 string_search: does each row of a STRING column match a literal
// needle — as a prefix, a suffix, anywhere in the row, or as a prefix and
// a suffix at once (LIKE 'a%b'). The device half of startswith, endswith,
// contains and LIKE (TPC-H q2, q9, q13, q14, q16, q20).
//
// Replaces spark_rapids_tpu/columnar/strings.py:starts_with (:353),
// ends_with (:365), contains (:377) and the searches of like_match (:428).
// Output: one bool a row, as the JAX functions return it: PREFIX / SUFFIX
// are len >= |needle| and the bytes equal; PREFIX_SUFFIX splits the needle
// at `split` and also needs len >= |needle|; CONTAINS is true for every
// row when the needle is empty. NULL rows have length 0, and their NULL
// result is the expression layer's, as in the reference.
//
// Bound: memory. It reads the offsets and, for CONTAINS, the row bytes
// once (for PREFIX / SUFFIX only min(len, |needle|) bytes a row), and
// writes one byte a row.
//
// Design: one thread per row, the needle staged once per block in shared
// memory (read from device memory when it is longer than kSharedNeedle).
// CONTAINS searches the row's own bytes: a match can never cross into the
// next row, and the work is O(len x |needle|) a row at worst, where the
// reference's byte-parallel match over the whole buffer does that for
// every byte plus a row search per byte. Rows here are short (9-35 bytes);
// a warp per row for long rows is later work.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

enum { kPrefix = 0, kSuffix = 1, kContains = 2, kPrefixSuffix = 3 };
constexpr int kSharedNeedle = 16384;

__device__ __forceinline__ bool equal_bytes(const uint8_t* a,
                                            const uint8_t* b, int n) {
  for (int k = 0; k < n; ++k)
    if (a[k] != b[k]) return false;
  return true;
}

__global__ void string_search_kernel(const int32_t* __restrict__ offsets,
                                     const uint8_t* __restrict__ bytes,
                                     long long n,
                                     const uint8_t* __restrict__ needle,
                                     int needle_len, int split, int mode,
                                     uint8_t* __restrict__ out) {
  extern __shared__ uint8_t staged[];
  const uint8_t* nd = needle;
  if (needle_len <= kSharedNeedle) {
    for (int k = threadIdx.x; k < needle_len; k += blockDim.x)
      staged[k] = needle[k];
    __syncthreads();
    nd = staged;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int32_t s = offsets[i];
    const long long len = (long long)offsets[i + 1] - s;
    const uint8_t* row = bytes + s;
    bool hit;
    if (mode == kPrefix) {
      hit = len >= needle_len && equal_bytes(row, nd, needle_len);
    } else if (mode == kSuffix) {
      hit = len >= needle_len &&
            equal_bytes(row + (len - needle_len), nd, needle_len);
    } else if (mode == kPrefixSuffix) {
      const int tail = needle_len - split;
      hit = len >= needle_len && equal_bytes(row, nd, split) &&
            equal_bytes(row + (len - tail), nd + split, tail);
    } else if (needle_len == 0) {
      hit = true;
    } else {
      hit = false;
      const uint8_t first = nd[0];
      for (long long p = 0; p + needle_len <= len; ++p) {
        if (row[p] == first &&
            equal_bytes(row + p + 1, nd + 1, needle_len - 1)) {
          hit = true;
          break;
        }
      }
    }
    out[i] = hit ? 1 : 0;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// offsets: int32 [n + 1]; bytes: the column's uint8 buffer; needle: uint8
// [needle_len] in device memory (split: bytes of the prefix half, for
// PREFIX_SUFFIX); out: bool [n].
SRT_API int srt_string_search(const int32_t* offsets, const uint8_t* bytes,
                              long long n, const uint8_t* needle,
                              int needle_len, int split, int mode,
                              uint8_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (mode < kPrefix || mode > kPrefixSuffix || needle_len < 0 ||
      split < 0 || split > needle_len)
    return (int)fail(cudaErrorInvalidValue, "string_search arguments");
  const long long blocks = std::min<long long>(ceil_div(n, kThreads), 65536);
  const size_t shared = needle_len <= kSharedNeedle ? (size_t)needle_len : 0;
  string_search_kernel<<<(unsigned)blocks, kThreads, shared, st>>>(
      offsets, bytes, n, needle, needle_len, split, mode, out);
  SRT_LAUNCHED("string_search_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
