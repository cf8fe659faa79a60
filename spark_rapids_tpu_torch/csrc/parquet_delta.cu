// K26 delta_byte_array: DELTA_BYTE_ARRAY strings rebuilt on the card.
//
// Replaces spark_rapids_tpu/io/parquet_device.py:_expand_dba (:548). String
// i of a page is the first plen[i] bytes of string i - 1 followed by its
// suffix, the next slen[i] bytes of the page's suffix stream. K25 has
// expanded both length streams; the reference resolves the recurrence with
// a provider matrix of n x maxlen lanes (a running max over rows, then one
// gather a byte), which costs O(n * maxlen) and stops at 64 MiB. Here:
//
// - a plan launch (one thread a string) writes each string's length,
//   sets a flag for corrupt input (a negative length, a page whose first
//   prefix is not 0, a prefix longer than the string before it) and sums
//   each page's suffix bytes (a warp sum, then one atomic);
// - the wrapper's one host sync reads the byte total (from the exclusive
//   sum of the lengths), the flag and the page sums, and raises on a bad
//   page before any byte moves;
// - a copy launch gives each page one warp, which walks the page's strings
//   in order: its lanes copy the prefix out of the previous output string
//   (which this warp has just written; __syncwarp orders the two) and the
//   suffix out of the chunk, 32 bytes a step. Pages are independent: the
//   first prefix of each is 0.
//
// Bound: memory, the lengths read and the bytes written once, with the
// suffix bytes read once. The copy serialises a page on one warp, so a
// page of millions of strings is far from that bound (PERF.md).
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

// last p with page_lanes[p] <= j, among n_pages pages
__device__ __forceinline__ long long page_of(const long long* page_lanes,
                                             long long n_pages, long long j) {
  long long lo = 0, hi = n_pages;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (page_lanes[mid] <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

__global__ void dba_plan_kernel(const long long* __restrict__ plen,
                                const long long* __restrict__ slen,
                                long long n,
                                const long long* __restrict__ page_lanes,
                                long long n_pages, long long* __restrict__ lens,
                                long long* __restrict__ stats) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  // whole warps walk the lanes together, so the shuffles see every lane
  const long long span = (n + 31) / 32 * 32;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < span; j += stride) {
    const bool live = j < n;
    long long page = -1;
    unsigned long long add = 0;
    if (live) {
      page = page_of(page_lanes, n_pages, j);
      const long long p = plen[j], s = slen[j];
      lens[j] = p + s;
      const bool head = page >= 0 && j == page_lanes[page];
      const long long prev = j > 0 ? plen[j - 1] + slen[j - 1] : 0;
      if (p < 0 || s < 0 || page < 0 || (head && p != 0) ||
          (!head && p > prev))
        stats[0] = 1;
      add = s > 0 ? (unsigned long long)s : 0ull;
    }
    const unsigned full = 0xFFFFFFFFu;
    const long long lead = __shfl_sync(full, page, 0);
    if (__all_sync(full, page == lead)) {
      for (int o = 16; o > 0; o >>= 1) add += __shfl_down_sync(full, add, o);
      if ((threadIdx.x & 31) == 0 && lead >= 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1 + lead),
                  add);
    } else if (page >= 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1 + page),
                add);
    }
  }
}

__global__ void dba_copy_kernel(const uint8_t* __restrict__ chunk,
                                long long nbytes,
                                const long long* __restrict__ plen,
                                const long long* __restrict__ slen,
                                const long long* __restrict__ offsets,
                                const long long* __restrict__ page_lanes,
                                const long long* __restrict__ suffix_base,
                                long long n_pages, uint8_t* out) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= n_pages) return;
  long long spos = suffix_base[warp];
  for (long long i = page_lanes[warp]; i < page_lanes[warp + 1]; ++i) {
    const long long o = offsets[i];
    const long long p = plen[i], s = slen[i];
    if (p > 0) {
      const long long prev = offsets[i - 1];
      for (long long b = lane; b < p; b += 32) out[o + b] = out[prev + b];
    }
    for (long long b = lane; b < s; b += 32) {
      const long long q = spos + b;
      out[o + p + b] = q >= 0 && q < nbytes ? chunk[q] : 0;
    }
    spos += s;
    __syncwarp();
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// plen, slen int64 [n] (K25's output); page p's strings are lanes
// [page_lanes[p], page_lanes[p + 1]). Writes lens int64 [n] and stats
// int64 [1 + n_pages] (cleared by the caller): the corrupt-input flag,
// then each page's suffix bytes.
SRT_API int srt_dba_plan(const long long* plen, const long long* slen,
                         long long n, const long long* page_lanes,
                         long long n_pages, long long* lens, long long* stats,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n_pages <= 0) return fail(cudaErrorInvalidValue, "arguments");
  dba_plan_kernel<<<grid_for(n), kThreads, 0, st>>>(plen, slen, n, page_lanes,
                                                    n_pages, lens, stats);
  SRT_LAUNCHED("dba_plan_kernel");
  return 0;
}

// offsets int64 [n + 1]: the exclusive sum of the lengths, into out; page
// p's suffixes start at byte suffix_base[p] of chunk.
SRT_API int srt_dba_copy(const uint8_t* chunk, long long nbytes,
                         const long long* plen, const long long* slen,
                         const long long* offsets, const long long* page_lanes,
                         const long long* suffix_base, long long n_pages,
                         uint8_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pages <= 0) return 0;
  constexpr int kWarpsPerBlock = 4;
  dba_copy_kernel<<<(unsigned)ceil_div(n_pages, kWarpsPerBlock),
                    32 * kWarpsPerBlock, 0, st>>>(
      chunk, nbytes, plen, slen, offsets, page_lanes, suffix_base, n_pages,
      out);
  SRT_LAUNCHED("dba_copy_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
