// K9 join_build, K10 join_probe, K11 join_expand: one hash equi-join.
//
// Replaces spark_rapids_tpu/exec/join.py:union_key_proxies,
// traced_join_plan and _expand_full. The reference has no hash table (XLA
// has none): for every stream batch it dense-ranks the union of the stream
// and build keys (a sort of s + b rows), sorts the build rows by group and
// probes an interval per stream row. Here the table is built once per
// build side — once per query for a broadcast join, once per partition for
// a shuffled join — and each stream batch only probes it.
//
// A row's key is its tuple of uint32 proxy words (exec/rowkeys.py
// key_proxy over every join key, word-major: word w of row i at
// words[w * n + i]), so equality is the proxies' equality, as in the
// reference: -0.0 equals 0.0, every NaN equals every NaN, and two strings
// whose (h1, h2, length) words collide are equal. Rows with a NULL key and
// dead rows never insert and never match (`ok` is 0 for them).
//
// K9 join_build: an open-addressing table of int32 slots (power-of-two
//   size, at least twice the build rows, -1 = empty). A build row hashes
//   its words, and claims an empty slot with atomicCAS or joins the slot
//   whose representative row has the same words (linear probing). Outputs:
//   the slot of each build row (the table size for rows that do not
//   insert), the rows per slot, and the exclusive scan of those counts
//   (common.cuh's device-wide scan) = each slot's start in the build
//   order. The build order itself is kernel K1 (radix_sort_pairs) over the
//   slot word: a stable sort, so a key's rows stay in ascending row order.
// K10 join_probe: per stream row, look its words up; match count and start
//   of its slot; output rows by join mode exactly as traced_join_plan
//   (inner: count, outer: max(count, 1), semi: count > 0, anti:
//   count == 0; 0 for dead rows); mark the slot matched (the full outer
//   join's build-matched flags, accumulated over stream batches). The
//   output offsets are the device-wide scan of the output counts; the
//   total is also summed in 64 bits, so the caller can refuse a batch whose
//   total passes int32.
// K11 join_expand: each stream row writes its output pairs at its offset:
//   s_idx = the row, b_idx = b_order[start + k], or -1 for an outer or anti
//   row without a match; lanes past the total hold 0 / -1.
//
// The slot ids depend on which thread wins a CAS, but (offsets, s_idx,
// b_idx, build-matched flags) do not: within a key the build order is
// ascending row index (as the reference's stable argsort by group) and
// output rows go in stream-row order, so they equal the reference's
// outputs bit for bit.
//
// Bound: memory. Build reads the key words and flags once and writes the
// table, slots and counts; probe reads the stream words and one table
// entry plus one representative row's words per lookup; expand writes
// 8 bytes per output row. Lookups are random accesses, so the table
// (4 bytes a slot) sits in L2 only while it is under ~50 MB.
//
// Design limits, for later work: one thread per stream row writes all of
// its matches, so a key with very many build rows serialises on one
// thread (a warp per heavy row, or an output-parallel expansion that finds
// its stream row by binary search over the offsets, would spread it).
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

enum { kInner = 0, kOuter = 1, kSemi = 2, kAnti = 3 };

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

__device__ __forceinline__ uint64_t hash_row(const uint32_t* __restrict__ w,
                                             int n_words, long long n,
                                             long long i) {
  uint64_t h = 0x9E3779B97F4A7C15ULL;
  for (int k = 0; k < n_words; ++k)
    h = mix64(h ^ (uint64_t)w[(long long)k * n + i]);
  return h;
}

__device__ __forceinline__ bool rows_equal(const uint32_t* __restrict__ a,
                                           long long na, long long ia,
                                           const uint32_t* __restrict__ b,
                                           long long nb, long long ib,
                                           int n_words) {
  for (int k = 0; k < n_words; ++k)
    if (a[(long long)k * na + ia] != b[(long long)k * nb + ib]) return false;
  return true;
}

__global__ void join_insert_kernel(const uint32_t* __restrict__ words,
                                   int n_words, long long n,
                                   const uint8_t* __restrict__ ok,
                                   int32_t* table, long long table_size,
                                   int32_t* __restrict__ slot_of,
                                   uint32_t* counts) {
  const long long mask = table_size - 1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!ok[i]) {
      slot_of[i] = (int32_t)table_size;
      continue;
    }
    long long s = (long long)(hash_row(words, n_words, n, i) & mask);
    while (true) {
      // a slot goes from -1 to a row index once and never changes again:
      // a stale -1 only sends the row to the CAS, which returns the truth
      int32_t cur = table[s];
      if (cur < 0) {
        cur = atomicCAS(&table[s], -1, (int32_t)i);
        if (cur < 0) break;  // claimed
      }
      if (rows_equal(words, n, cur, words, n, i, n_words)) break;
      s = (s + 1) & mask;
    }
    slot_of[i] = (int32_t)s;
    atomicAdd(&counts[s], 1u);
  }
}

__global__ void join_probe_kernel(
    const uint32_t* __restrict__ s_words, int n_words, long long s_n,
    const uint8_t* __restrict__ s_live, const uint8_t* __restrict__ s_ok,
    const uint32_t* __restrict__ b_words, long long b_n,
    const int32_t* __restrict__ table, long long table_size,
    const uint32_t* __restrict__ counts, const uint32_t* __restrict__ starts,
    int mode, int32_t* __restrict__ match_cnt, int32_t* __restrict__ start,
    uint32_t* __restrict__ out_cnt, uint8_t* slot_matched,
    unsigned long long* total) {
  const long long mask = table_size - 1;
  unsigned long long mine = 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < s_n; j += (long long)gridDim.x * blockDim.x) {
    uint32_t cnt = 0, st = 0;
    if (s_ok[j]) {
      long long s = (long long)(hash_row(s_words, n_words, s_n, j) & mask);
      while (true) {
        const int32_t cur = table[s];
        if (cur < 0) break;  // an empty slot ends the probe: no match
        if (rows_equal(b_words, b_n, cur, s_words, s_n, j, n_words)) {
          cnt = counts[s];
          st = starts[s];
          slot_matched[s] = 1;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    const bool live = s_live[j] != 0;
    uint32_t out = 0;
    if (live) {
      switch (mode) {
        case kInner: out = cnt; break;
        case kOuter: out = cnt > 0 ? cnt : 1u; break;
        case kSemi: out = cnt > 0 ? 1u : 0u; break;
        default: out = cnt == 0 ? 1u : 0u; break;
      }
    }
    match_cnt[j] = (int32_t)cnt;
    start[j] = (int32_t)st;
    out_cnt[j] = out;
    mine += out;
  }
  // warp sum, then one atomic per warp
  for (int d = 16; d > 0; d >>= 1)
    mine += __shfl_down_sync(0xFFFFFFFFu, mine, d);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(total, mine);
}

__global__ void join_expand_kernel(const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ match_cnt,
                                   const int32_t* __restrict__ start,
                                   const int32_t* __restrict__ b_order,
                                   long long s_n, int32_t* __restrict__ s_idx,
                                   int32_t* __restrict__ b_idx,
                                   long long out_cap) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < s_n; j += (long long)gridDim.x * blockDim.x) {
    const long long o = offsets[j];
    const long long e = offsets[j + 1];
    if (e <= o) continue;
    const bool has_match = match_cnt[j] > 0;
    const long long st = start[j];
    for (long long k = 0; k < e - o && o + k < out_cap; ++k) {
      s_idx[o + k] = (int32_t)j;
      b_idx[o + k] = has_match ? b_order[st + k] : -1;
    }
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// ------------------------------------------------------------- K9 build
// scratch bytes of the build's start scan over table_size slots
SRT_API size_t srt_join_build_scratch_bytes(long long table_size) {
  return sizeof(uint32_t) * (size_t)(scan_scratch_elems(table_size) + 1);
}

// words: uint32 [n_words][n]; ok: bool [n]; table_size: a power of two
// above n. Outputs: table int32 [table_size], slot_of int32 [n] (table_size
// where ok is 0), counts and starts uint32 [table_size].
SRT_API int srt_join_build(const uint32_t* words, int n_words, long long n,
                           const uint8_t* ok, long long table_size,
                           int32_t* table, int32_t* slot_of,
                           uint32_t* counts, uint32_t* starts, void* scratch,
                           size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_size <= 0 || (table_size & (table_size - 1)) != 0 ||
      table_size <= n || table_size > (1LL << 31) - 1 ||
      scratch_bytes < srt_join_build_scratch_bytes(table_size))
    return (int)fail(cudaErrorInvalidValue, "join_build arguments");
  SRT_CALL(cudaMemsetAsync(table, 0xFF, sizeof(int32_t) * table_size, st),
           "join_build table memset");
  SRT_CALL(cudaMemsetAsync(counts, 0, sizeof(uint32_t) * table_size, st),
           "join_build counts memset");
  if (n > 0) {
    join_insert_kernel<<<grid_for(n), kThreads, 0, st>>>(
        words, n_words, n, ok, table, table_size, slot_of, counts);
    SRT_LAUNCHED("join_insert_kernel");
  }
  SRT_CALL(scan_u32(counts, starts, table_size,
                    static_cast<uint32_t*>(scratch), nullptr, false, st),
           "join_build start scan");
  return 0;
}

// ------------------------------------------------------------- K10 probe
// scratch bytes of a probe over n stream rows (output counts + their scan)
SRT_API size_t srt_join_probe_scratch_bytes(long long n) {
  return sizeof(uint32_t) * (size_t)(n + scan_scratch_elems(n) + 1);
}

// s_words: uint32 [n_words][s_n]; s_live / s_ok: bool [s_n]; b_words and
// the table, counts and starts of srt_join_build. Outputs: match_cnt and
// start int32 [s_n], offsets int32 [s_n + 1], slot_matched bool
// [table_size] (set, never cleared), total uint64 (the output rows).
SRT_API int srt_join_probe(const uint32_t* s_words, int n_words,
                           long long s_n, const uint8_t* s_live,
                           const uint8_t* s_ok, const uint32_t* b_words,
                           long long b_n, const int32_t* table,
                           long long table_size, const uint32_t* counts,
                           const uint32_t* starts, int mode,
                           int32_t* match_cnt, int32_t* start,
                           int32_t* offsets, uint8_t* slot_matched,
                           unsigned long long* total, void* scratch,
                           size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kInner || mode > kAnti || table_size <= 0 ||
      (table_size & (table_size - 1)) != 0 ||
      scratch_bytes < srt_join_probe_scratch_bytes(s_n))
    return (int)fail(cudaErrorInvalidValue, "join_probe arguments");
  SRT_CALL(cudaMemsetAsync(total, 0, sizeof(unsigned long long), st),
           "join_probe total memset");
  SRT_CALL(cudaMemsetAsync(offsets, 0, sizeof(int32_t), st),
           "join_probe offsets memset");
  if (s_n <= 0) return 0;
  uint32_t* out_cnt = static_cast<uint32_t*>(scratch);
  join_probe_kernel<<<grid_for(s_n), kThreads, 0, st>>>(
      s_words, n_words, s_n, s_live, s_ok, b_words, b_n, table, table_size,
      counts, starts, mode, match_cnt, start, out_cnt, slot_matched, total);
  SRT_LAUNCHED("join_probe_kernel");
  SRT_CALL(scan_u32(out_cnt, reinterpret_cast<uint32_t*>(offsets + 1), s_n,
                    out_cnt + s_n, nullptr, true, st),
           "join_probe offset scan");
  return 0;
}

// ------------------------------------------------------------ K11 expand
// offsets, match_cnt, start: srt_join_probe's; b_order int32 [b_n]: the
// build rows in slot order (K1). Outputs: s_idx, b_idx int32 [out_cap].
SRT_API int srt_join_expand(const int32_t* offsets, const int32_t* match_cnt,
                            const int32_t* start, const int32_t* b_order,
                            long long s_n, int32_t* s_idx, int32_t* b_idx,
                            long long out_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) return 0;
  SRT_CALL(cudaMemsetAsync(s_idx, 0, sizeof(int32_t) * out_cap, st),
           "join_expand s_idx memset");
  SRT_CALL(cudaMemsetAsync(b_idx, 0xFF, sizeof(int32_t) * out_cap, st),
           "join_expand b_idx memset");
  if (s_n <= 0) return 0;
  join_expand_kernel<<<grid_for(s_n), kThreads, 0, st>>>(
      offsets, match_cnt, start, b_order, s_n, s_idx, b_idx, out_cap);
  SRT_LAUNCHED("join_expand_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
