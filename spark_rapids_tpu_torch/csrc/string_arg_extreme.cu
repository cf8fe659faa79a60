// K47 segment_arg_extreme_string: per group, the row index of the
// lexicographically smallest (or largest) non-null string.
//
// Replaces spark_rapids_tpu/exec/rowkeys.py:segment_arg_extreme_string
// (:177) with _string_chunk_keys (:142), the string min / max of the
// aggregate's update and merge programs (exec/aggregate.py:336-341, :404).
// Semantics, as the reference's: NULL rows and rows outside the groups are
// skipped; strings compare as big-endian 8-byte words zero-padded past
// their end, then by length, which is byte order with a proper prefix
// first (an embedded 0 byte included); ties go to the lowest row index; a
// group without a non-null row, and every slot at or past the group count,
// gives `capacity`. The reference refines one chunk word at a time over
// the column's longest string; comparing whole strings gives the same
// answer.
//
// Design: the groups come from the group-by's sort (K1, K2), so a group's
// rows are contiguous in the sorted order. Grouping sets give few groups of
// many rows (a rollup's grand total holds every row), so one warp a group
// would leave the card idle. Instead, as K3 reduces, each thread takes a
// chunk of kChunk consecutive sorted positions and keeps the best row of
// each run of one group inside it: a run that starts and ends in the chunk
// is the group's answer; the best rows of runs cut by the chunk's edges go
// to per-chunk head / tail slots, and a second kernel reduces each cut
// group's slots with a block (a strided split and a tree), comparing rows
// with the same order and tie rule, so the result does not depend on
// timing.
//
// Bound: memory. Each non-null row's bytes are read once per comparison
// (a thread's current best usually stays in L1), plus the sorted order,
// the group ids and the offsets; one int32 is written a group slot.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kChunk = 32;
constexpr int kCombineThreads = 1024;

// bytes [i, i + 8) of a string as a big-endian word, zero past its end
__device__ __forceinline__ unsigned long long be_word(
    const uint8_t* __restrict__ bytes, long long start, long long len,
    long long i) {
  unsigned long long w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w = (w << 8) | (i + k < len ? (unsigned long long)bytes[start + i + k]
                                : 0ull);
  return w;
}

__device__ __forceinline__ int compare_rows(
    const int32_t* __restrict__ offsets, const uint8_t* __restrict__ bytes,
    int32_t a, int32_t b) {
  const long long sa = offsets[a], la = offsets[a + 1] - sa;
  const long long sb = offsets[b], lb = offsets[b + 1] - sb;
  const long long m = la > lb ? la : lb;
  for (long long i = 0; i < m; i += 8) {
    const unsigned long long wa = be_word(bytes, sa, la, i);
    const unsigned long long wb = be_word(bytes, sb, lb, i);
    if (wa != wb) return wa < wb ? -1 : 1;
  }
  return la < lb ? -1 : (la > lb ? 1 : 0);
}

// row a beats the current best b (b < 0: no best yet)
__device__ __forceinline__ bool beats(const int32_t* __restrict__ offsets,
                                      const uint8_t* __restrict__ bytes,
                                      int32_t a, int32_t b, bool want_min) {
  if (a < 0) return false;
  if (b < 0) return true;
  const int c = compare_rows(offsets, bytes, a, b);
  if (c == 0) return a < b;
  return want_min ? c < 0 : c > 0;
}

__global__ void arg_extreme_chunk_kernel(
    const int32_t* __restrict__ offsets, const uint8_t* __restrict__ bytes,
    const bool* __restrict__ valid, long long n,
    const int32_t* __restrict__ order, const int32_t* __restrict__ gid_sorted,
    bool want_min, int32_t* __restrict__ out, int32_t* __restrict__ head,
    int32_t* __restrict__ tail) {
  const long long chunk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long start = chunk * kChunk;
  if (start >= n) return;
  const long long end = start + kChunk < n ? start + kChunk : n;
  int32_t run_g = -1, best = -1;
  long long rs = start;
  auto flush = [&](long long re) {
    const bool cut_before =
        rs == start && rs > 0 && gid_sorted[rs - 1] == run_g;
    const bool cut_after = re == end && re < n && gid_sorted[re] == run_g;
    if (cut_before) head[chunk] = best;
    else if (cut_after) tail[chunk] = best;
    else out[run_g] = best < 0 ? (int32_t)n : best;
  };
  long long i = start;
  for (; i < end; ++i) {
    const int32_t g = gid_sorted[i];
    if (g >= n) break;  // pads sort last
    if (g != run_g) {
      if (run_g >= 0) flush(i);
      run_g = g;
      rs = i;
      best = -1;
    }
    const int32_t r = order[i];
    if (valid[r] && beats(offsets, bytes, r, best, want_min)) best = r;
  }
  if (run_g >= 0) flush(i);
}

// groups cut by chunk edges: the tail of their first chunk and the heads
// of the chunks after it; every slot at or past the group count: n
__global__ void arg_extreme_combine_kernel(
    const int32_t* __restrict__ offsets, const uint8_t* __restrict__ bytes,
    long long n, const int32_t* __restrict__ seg_ends,
    const int32_t* __restrict__ num_groups, bool want_min,
    int32_t* __restrict__ out, const int32_t* __restrict__ head,
    const int32_t* __restrict__ tail) {
  __shared__ int32_t red[kCombineThreads];
  const int32_t ng = num_groups[0];
  for (long long s = ng + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < n; s += (long long)gridDim.x * blockDim.x)
    out[s] = (int32_t)n;
  for (int32_t g = blockIdx.x; g < ng; g += gridDim.x) {
    const long long gs = g == 0 ? 0 : (long long)seg_ends[g - 1] + 1;
    const long long ge = seg_ends[g];
    const long long cs = gs / kChunk, ce = ge / kChunk;
    if (cs == ce) continue;  // written by the chunk kernel (uniform)
    int32_t best = threadIdx.x == 0 ? tail[cs] : -1;
    for (long long k = cs + 1 + threadIdx.x; k <= ce; k += blockDim.x)
      if (beats(offsets, bytes, head[k], best, want_min)) best = head[k];
    red[threadIdx.x] = best;
    __syncthreads();
    for (int h = blockDim.x / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h &&
          beats(offsets, bytes, red[threadIdx.x + h], red[threadIdx.x],
                want_min))
        red[threadIdx.x] = red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[g] = red[0] < 0 ? (int32_t)n : red[0];
    __syncthreads();
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API int srt_arg_extreme_chunk() { return kChunk; }

// offsets int32 [n + 1], bytes, valid bool [n] (NULL and dead rows false);
// order, gid_sorted, seg_ends int32 [n] and num_groups int32 [1] from the
// group-by; out int32 [n]; head, tail int32 [ceil(n / kChunk)] scratch.
SRT_API int srt_segment_arg_extreme_string(
    const int32_t* offsets, const uint8_t* bytes, const bool* valid,
    long long n, const int32_t* order, const int32_t* gid_sorted,
    const int32_t* seg_ends, const int32_t* num_groups, int want_min,
    int32_t* out, int32_t* head, int32_t* tail, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  if (n == 0) return 0;
  const long long chunks = ceil_div(n, kChunk);
  arg_extreme_chunk_kernel<<<(unsigned)ceil_div(chunks, kThreads), kThreads,
                             0, st>>>(offsets, bytes, valid, n, order,
                                      gid_sorted, want_min != 0, out, head,
                                      tail);
  SRT_LAUNCHED("arg_extreme_chunk_kernel");
  const unsigned grid = (unsigned)std::min<long long>(n, 4096);
  arg_extreme_combine_kernel<<<grid, kCombineThreads, 0, st>>>(
      offsets, bytes, n, seg_ends, num_groups, want_min != 0, out, head,
      tail);
  SRT_LAUNCHED("arg_extreme_combine_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
