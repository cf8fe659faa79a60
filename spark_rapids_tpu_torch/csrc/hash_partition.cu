// K4 hash_partition: the exchange's row hash, partition ids and routing.
//
// Replaces spark_rapids_tpu/ops/hashing.py:hash_columns + partition_ids
// (reached through shuffle/exchange.py:_build_hash_ids) and
// shuffle/exchange.py:_route_plan + _lazy_masks.
//
// Hash half: a murmur3-style uint32 row hash with seed 42 over each key
// column's words (bool/int8/int16/int32: the sign-extended low word; int64:
// low then high word; float/double: the float32 bit pattern with -0.0 ->
// 0.0 and one canonical NaN; string: the three words of kernel K5,
// string_hash_words), data words zeroed at nulls and one null word per
// column, then fmix32; the partition id is hash % n, and rows outside
// the live mask get id n. It also counts rows per id (n + 1 buckets, pads
// last). Bit-identical to the reference, which co-partitions host and
// device plans on it.
//
// Code mode (kind 8) replaces shuffle/exchange.py:_hash_ids_encoded (:1181)
// and _build_hash_ids_enc (:1222): the column holds int32 codes into a
// dictionary, and the row's words come from the dictionary's table,
// gathered by the code clipped into range: int32 values (a DATE
// dictionary; one word), int64 values (INT64 / TIMESTAMP; two words) or a
// STRING dictionary's K5 words [3][table_n]. The words are those of the
// expanded value, so an encoded key lands in the same partition as the
// same value in a plain column or under another dictionary.
//
// Route half: a stable scatter of row indices into `order`, grouped by id,
// with the per-id counts — the shared stable radix pass over the ids, one
// pass per 8 bits of the largest id (one below 256 buckets, two below
// 65536, three below 2^24).
//
// K45 round_robin_route replaces shuffle/exchange.py:_jit_rr_ids (:1141)
// with the _route_plan that follows it (:1315) for repartition(n): row r
// of a map batch goes to target (r + pidx) % n, a pad lane to n. The stable
// order needs no sort: target t holds the live rows r0_t, r0_t + n, ...
// with r0_t = (t - pidx) mod n, so with q = rows / n and rem = rows % n a
// target counts q + (r0_t < rem) rows and starts at t * q plus the targets
// before it whose r0 < rem (a cyclic interval of rem targets from pidx).
// One launch writes the ids (the lazy slicer's masks), the n + 1 counts
// (pads last) and, in route mode, `order`: a thread an output position,
// which finds its target by a binary search over those closed-form starts,
// so every write is coalesced and nothing is read but the row count.
//
// Counts: up to kSharedBuckets buckets (num_parts + 1) each block keeps its
// histogram in shared memory and adds it to `counts` once; past that the
// launcher picks the variant that adds every row straight into `counts` in
// device memory with atomicAdd, so any partition count works (the
// reference's partition_ids and _route_plan take any n).
//
// Bound: memory. The hash reads each key column once and writes one int32
// id a row; the route reads ids twice and writes one int32 a row; K45
// writes one id and one order entry a row.
#include <algorithm>

#include "common.cuh"

struct SrtHashCol {
  const void* data;
  const uint8_t* valid;
  int32_t kind;  // 0 bool, 1 int8, 2 int16, 3 int32, 4 int64, 5 f32, 6 f64,
                 // 7 uint32 words [3][n] (a string's K5 words),
                 // 8 int32 codes into `table`
  int32_t table_kind;  // code mode: 3 int32 values, 4 int64 values,
                       // 7 uint32 words [3][table_n]
  const void* table;
  long long table_n;
};

namespace srt {
namespace {

constexpr int kMaxHashCols = 16;
constexpr int kSharedBuckets = 4096;  // 16 KB of shared memory a block

struct HashCols {
  SrtHashCol c[kMaxHashCols];
  int n;
};

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed = 42u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h, uint32_t k) {
  k *= kC1;
  k = rotl32(k, 15);
  k *= kC2;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t canonical_f32_bits(float f) {
  if (f == 0.0f) return 0u;
  if (isnan(f)) return 0x7FC00000u;
  return __float_as_uint(f);
}

// kShared: per-block histogram in shared memory (num_parts + 1 <=
// kSharedBuckets), else one global atomicAdd a row.
template <bool kShared>
__global__ void hash_ids_kernel(HashCols cols, long long n,
                                const uint8_t* __restrict__ live,
                                int num_parts, int32_t* __restrict__ ids,
                                uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  if (kShared) {
    for (int b = threadIdx.x; b <= num_parts; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int32_t pid = num_parts;
    if (live[i]) {
      uint32_t h = kSeed;
      for (int k = 0; k < cols.n; ++k) {
        const SrtHashCol& c = cols.c[k];
        const bool v = c.valid[i] != 0;
        uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
        int nw = 1;
        switch (c.kind) {
          case 0: w0 = static_cast<const uint8_t*>(c.data)[i] ? 1u : 0u; break;
          case 1: w0 = (uint32_t)(int32_t)static_cast<const int8_t*>(c.data)[i]; break;
          case 2: w0 = (uint32_t)(int32_t)static_cast<const int16_t*>(c.data)[i]; break;
          case 3: w0 = (uint32_t)static_cast<const int32_t*>(c.data)[i]; break;
          case 4: {
            const unsigned long long x =
                (unsigned long long)static_cast<const long long*>(c.data)[i];
            w0 = (uint32_t)(x & 0xFFFFFFFFull);
            w1 = (uint32_t)(x >> 32);
            nw = 2;
            break;
          }
          case 5: w0 = canonical_f32_bits(static_cast<const float*>(c.data)[i]); break;
          case 7: {
            const uint32_t* w = static_cast<const uint32_t*>(c.data);
            w0 = w[i];
            w1 = w[n + i];
            w2 = w[2 * n + i];
            nw = 3;
            break;
          }
          case 8: {
            if (c.table_n <= 0) break;
            const int32_t code = static_cast<const int32_t*>(c.data)[i];
            const long long t =
                code < 0 ? 0 : (code >= c.table_n ? c.table_n - 1 : code);
            if (c.table_kind == 3) {
              w0 = (uint32_t)static_cast<const int32_t*>(c.table)[t];
            } else if (c.table_kind == 4) {
              const unsigned long long x = (unsigned long long)
                  static_cast<const long long*>(c.table)[t];
              w0 = (uint32_t)(x & 0xFFFFFFFFull);
              w1 = (uint32_t)(x >> 32);
              nw = 2;
            } else {
              const uint32_t* w = static_cast<const uint32_t*>(c.table);
              w0 = w[t];
              w1 = w[c.table_n + t];
              w2 = w[2 * c.table_n + t];
              nw = 3;
            }
            break;
          }
          default:
            w0 = canonical_f32_bits(
                __double2float_rn(static_cast<const double*>(c.data)[i]));
            break;
        }
        h = mix_h1(h, v ? w0 : 0u);
        if (nw >= 2) h = mix_h1(h, v ? w1 : 0u);
        if (nw == 3) h = mix_h1(h, v ? w2 : 0u);
        h = mix_h1(h, v ? 0u : kGolden);
      }
      pid = (int32_t)(fmix32(h) % (uint32_t)num_parts);
    }
    ids[i] = pid;
    atomicAdd(kShared ? &hist[pid] : &counts[pid], 1u);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b <= num_parts; b += blockDim.x)
      if (hist[b]) atomicAdd(&counts[b], hist[b]);
  }
}

template <bool kShared>
__global__ void count_ids_kernel(const int32_t* __restrict__ ids, long long n,
                                 int num_buckets,
                                 uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  if (kShared) {
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    atomicAdd(kShared ? &hist[ids[i]] : &counts[ids[i]], 1u);
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x)
      if (hist[b]) atomicAdd(&counts[b], hist[b]);
  }
}

// 8-bit radix passes that order ids in [0, max_id]
inline int route_passes(uint32_t max_id) {
  int passes = 1;
  while (passes < 4 && (max_id >> (8 * passes)) != 0u) ++passes;
  return passes;
}

// keys / vals: the ping-pong buffers between passes (a second pair only
// from three passes on)
struct RouteScratch {
  uint32_t* keys[2];
  int32_t* vals[2];
  uint32_t* counts;
  uint32_t* offsets;
  uint32_t* scan;
};

size_t carve(void* base, long long n, int passes, RouteScratch* s) {
  Carver c{static_cast<char*>(base), 0};
  const long long hist = (long long)kRadix * radix_pass_tiles(n);
  for (int k = 0; k < 2; ++k) {
    const bool used = passes > 1 + k;
    s->keys[k] = c.take<uint32_t>(used ? n : 0);
    s->vals[k] = c.take<int32_t>(used ? n : 0);
  }
  s->counts = c.take<uint32_t>(hist);
  s->offsets = c.take<uint32_t>(hist);
  s->scan = c.take<uint32_t>(scan_scratch_elems(hist));
  return c.used;
}

// K45: the first position of target t (t in [0, n]) among the live rows
__device__ __forceinline__ long long rr_start(long long t, long long p,
                                              long long q, long long rem,
                                              long long n) {
  long long before;
  if (p + rem <= n)
    before = t - p < 0 ? 0 : (t - p > rem ? rem : t - p);
  else
    before = (t < p + rem - n ? t : p + rem - n) + (t - p > 0 ? t - p : 0);
  return t * q + before;
}

__global__ void round_robin_route_kernel(long long cap, long long p, int n,
                                         long long rows_host,
                                         const int32_t* __restrict__ rows_dev,
                                         int32_t* __restrict__ ids,
                                         int32_t* __restrict__ order,
                                         int32_t* __restrict__ counts) {
  long long rows = rows_dev != nullptr ? (long long)*rows_dev : rows_host;
  rows = rows < 0 ? 0 : (rows > cap ? cap : rows);
  const long long q = rows / n, rem = rows % n;
  const long long end = cap > (long long)n + 1 ? cap : (long long)n + 1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < end; i += (long long)gridDim.x * blockDim.x) {
    if (i < cap) {
      ids[i] = i < rows ? (int32_t)((i + p) % n) : n;
      if (order != nullptr) {
        if (i < rows) {
          long long lo = 0, hi = n - 1;  // the last t with start(t) <= i
          while (lo < hi) {
            const long long mid = (lo + hi + 1) >> 1;
            if (rr_start(mid, p, q, rem, n) <= i) lo = mid; else hi = mid - 1;
          }
          const long long r0 = ((lo - p) % n + n) % n;
          order[i] = (int32_t)(r0 + (i - rr_start(lo, p, q, rem, n)) * n);
        } else {
          order[i] = (int32_t)i;
        }
      }
    }
    if (i <= n) {
      const long long r0 = ((i - p) % n + n) % n;
      counts[i] = i < n ? (int32_t)(q + (r0 < rem ? 1 : 0))
                        : (int32_t)(cap - rows);
    }
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// K45: ids int32 [cap]; order int32 [cap] or null (ids only); counts int32
// [num_parts + 1]. The live row count is *rows_dev when rows_dev is not
// null, else rows_host; pidx >= 0.
SRT_API int srt_round_robin_route(long long cap, long long pidx,
                                  int num_parts, long long rows_host,
                                  const int32_t* rows_dev, int32_t* ids,
                                  int32_t* order, int32_t* counts,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_parts < 1 || num_parts == 0x7FFFFFFF || cap < 0 ||
      cap > 0x7FFFFFFFLL || pidx < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  const long long work = std::max<long long>(cap, (long long)num_parts + 1);
  const unsigned grid =
      (unsigned)std::min<long long>(ceil_div(work, kThreads), 8192);
  round_robin_route_kernel<<<grid, kThreads, 0, st>>>(
      cap, pidx % num_parts, num_parts, rows_host, rows_dev, ids, order,
      counts);
  SRT_LAUNCHED("round_robin_route_kernel");
  return 0;
}

// ids: int32 [n] partition id per row (n = num_parts outside `live`);
// counts: uint32 [num_parts + 1], zeroed here.
SRT_API int srt_hash_partition_ids(const SrtHashCol* cols, int n_cols,
                                   long long n, const uint8_t* live,
                                   int num_parts, int32_t* ids,
                                   uint32_t* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_cols < 1 || n_cols > kMaxHashCols || num_parts < 1 ||
      num_parts == 0x7FFFFFFF || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  SRT_CALL(cudaMemsetAsync(counts, 0, sizeof(uint32_t) * (size_t)(num_parts + 1), st),
           "memset counts");
  if (n <= 0) return 0;
  HashCols hc;
  hc.n = n_cols;
  for (int k = 0; k < n_cols; ++k) hc.c[k] = cols[k];
  const unsigned grid = (unsigned)std::min<long long>(ceil_div(n, kThreads), 4096);
  if (num_parts + 1 <= kSharedBuckets) {
    const size_t shmem = sizeof(uint32_t) * (size_t)(num_parts + 1);
    hash_ids_kernel<true><<<grid, kThreads, shmem, st>>>(
        hc, n, live, num_parts, ids, counts);
  } else {
    hash_ids_kernel<false><<<grid, kThreads, 0, st>>>(
        hc, n, live, num_parts, ids, counts);
  }
  SRT_LAUNCHED("hash_ids_kernel");
  return 0;
}

SRT_API size_t srt_route_plan_scratch_bytes(long long n, int num_parts) {
  RouteScratch s;
  return carve(nullptr, n, route_passes((uint32_t)num_parts), &s);
}

// ids: int32 [n] in [0, num_parts]; order: int32 [n], row indices grouped
// by id in row order; counts: uint32 [num_parts + 1].
SRT_API int srt_route_plan(const int32_t* ids, long long n, int num_parts,
                           int32_t* order, uint32_t* counts, void* scratch,
                           size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_parts < 1 || num_parts == 0x7FFFFFFF || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  const int buckets = num_parts + 1;
  const int passes = route_passes((uint32_t)num_parts);
  RouteScratch s;
  if (carve(scratch, n, passes, &s) > scratch_bytes)
    return fail(cudaErrorInvalidValue, "scratch size");
  SRT_CALL(cudaMemsetAsync(counts, 0, sizeof(uint32_t) * (size_t)buckets, st),
           "memset counts");
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)std::min<long long>(ceil_div(n, kThreads), 4096);
  if (buckets <= kSharedBuckets)
    count_ids_kernel<true><<<grid, kThreads, sizeof(uint32_t) * (size_t)buckets,
                             st>>>(ids, n, buckets, counts);
  else
    count_ids_kernel<false><<<grid, kThreads, 0, st>>>(ids, n, buckets, counts);
  SRT_LAUNCHED("count_ids_kernel");
  // pass p reads the ids (p = 0) or the previous pass's buffers and writes
  // the next pair, the last pass only the row indices into `order`
  for (int p = 0; p < passes; ++p) {
    PingPong pp = {};
    pp.keys_in[0] = p == 0 ? reinterpret_cast<const uint32_t*>(ids)
                           : s.keys[(p - 1) & 1];
    pp.vals_in[0] = p == 0 ? nullptr : s.vals[(p - 1) & 1];
    const bool last = p == passes - 1;
    pp.keys_out[1] = last ? nullptr : s.keys[p & 1];
    pp.vals_out[1] = last ? order : s.vals[p & 1];
    SRT_TRY(radix_pass(pp, n, 8 * p, s.counts, s.offsets, s.scan, nullptr,
                       nullptr, st));
  }
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
