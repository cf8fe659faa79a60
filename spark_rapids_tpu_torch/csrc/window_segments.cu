// K14 window_segments: the sorted-domain structure of one window batch.
//
// Replaces spark_rapids_tpu/exec/window.py:_build_kernel's structure block
// (:241-287, with _run_start :138 and _run_end :148). Input: the window
// sort's key words (uint32 [n_words][cap], input order; the first
// n_part_words belong to the partition keys), K1's permutation and the live
// mask in input order. Output per sorted position i:
//   live_s      the row is live (live rows sort before the pads);
//   pgid        partition id (inclusive count of partition starts - 1);
//   start, end  first and last position of the row's partition;
//   peer_id     peer-group id (partition + order words; dense_rank);
//   peer_start, peer_end  first and last position of its peer group;
// and, for a single integer-kind ORDER BY key (rk_data != null):
//   key_s       the key in sorted order, negated when descending (int64,
//               wrapping), 0 where NULL;
//   kvalid      the key is not NULL;
//   nn_start, nn_end  the partition's first and last non-NULL key
//               position (cap and -1 when it has none).
// Pads get cap everywhere (nn_end -1, key_s 0).
//
// A partition (peer group) starts where any partition (any) word differs
// from the previous sorted row, and at row 0. Non-NULL keys of a partition
// are contiguous (the key's null flag is its most significant word), so
// their span is found by its two ends, without atomics.
//
// Bound: memory. Per row it reads perm, the live flag and every key word of
// two rows (a gather through perm), and writes seven int32 outputs (plus
// the key, its flag and two int32 for a range key). Design: a flag kernel,
// the shared device-wide scan of common.cuh twice (partition and peer
// flags), a kernel that writes the run tables at the run ends, and a gather
// kernel that reads each row's bounds from its run's table entry.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__device__ __forceinline__ bool words_differ(const uint32_t* __restrict__ w,
                                             int from, int to, long long cap,
                                             int32_t r, int32_t p) {
  for (int k = from; k < to; ++k) {
    const uint32_t* word = w + (long long)k * cap;
    if (word[r] != word[p]) return true;
  }
  return false;
}

__global__ void flags_kernel(const uint32_t* __restrict__ words, int n_words,
                             int n_part_words, long long cap,
                             const int32_t* __restrict__ perm,
                             const uint8_t* __restrict__ live,
                             const int64_t* __restrict__ rk_data,
                             const uint8_t* __restrict__ rk_valid, int desc,
                             uint8_t* __restrict__ live_s,
                             uint32_t* __restrict__ pflag,
                             uint32_t* __restrict__ qflag,
                             int64_t* __restrict__ key_s,
                             uint8_t* __restrict__ kvalid) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    const int32_t r = perm[i];
    const bool ls = live[r] != 0;
    bool pf = false, qf = false;
    if (ls) {
      if (i == 0) {
        pf = qf = true;
      } else {
        const int32_t p = perm[i - 1];
        pf = words_differ(words, 0, n_part_words, cap, r, p);
        qf = pf || words_differ(words, n_part_words, n_words, cap, r, p);
      }
    }
    live_s[i] = ls ? 1 : 0;
    pflag[i] = pf ? 1u : 0u;
    qflag[i] = qf ? 1u : 0u;
    if (rk_data != nullptr) {
      const bool kv = ls && rk_valid[r] != 0;
      const uint64_t x = (uint64_t)rk_data[r];
      kvalid[i] = kv ? 1 : 0;
      key_s[i] = kv ? (int64_t)(desc ? 0ull - x : x) : 0;
    }
  }
}

__global__ void init_tables_kernel(long long cap, int32_t* __restrict__ nn_lo,
                                   int32_t* __restrict__ nn_hi) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    nn_lo[i] = (int32_t)cap;
    nn_hi[i] = -1;
  }
}

__global__ void tables_kernel(long long cap,
                              const uint8_t* __restrict__ live_s,
                              const uint32_t* __restrict__ pflag,
                              const uint32_t* __restrict__ qflag,
                              const uint32_t* __restrict__ pinc,
                              const uint32_t* __restrict__ qinc,
                              const uint8_t* __restrict__ kvalid,
                              int32_t* __restrict__ pfirst,
                              int32_t* __restrict__ plast,
                              int32_t* __restrict__ qfirst,
                              int32_t* __restrict__ qlast,
                              int32_t* __restrict__ nn_lo,
                              int32_t* __restrict__ nn_hi) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    if (!live_s[i]) continue;
    const int32_t g = (int32_t)pinc[i] - 1;
    const int32_t q = (int32_t)qinc[i] - 1;
    const bool last = i == cap - 1 || !live_s[i + 1];
    const bool p_end = last || pflag[i + 1];
    const bool q_end = last || qflag[i + 1];
    if (pflag[i]) pfirst[g] = (int32_t)i;
    if (p_end) plast[g] = (int32_t)i;
    if (qflag[i]) qfirst[q] = (int32_t)i;
    if (q_end) qlast[q] = (int32_t)i;
    if (kvalid != nullptr && kvalid[i]) {
      if (pflag[i] || !kvalid[i - 1]) nn_lo[g] = (int32_t)i;
      if (p_end || !kvalid[i + 1]) nn_hi[g] = (int32_t)i;
    }
  }
}

__global__ void gather_kernel(long long cap,
                              const uint8_t* __restrict__ live_s,
                              const uint32_t* __restrict__ pinc,
                              const uint32_t* __restrict__ qinc,
                              const int32_t* __restrict__ pfirst,
                              const int32_t* __restrict__ plast,
                              const int32_t* __restrict__ qfirst,
                              const int32_t* __restrict__ qlast,
                              const int32_t* __restrict__ nn_lo,
                              const int32_t* __restrict__ nn_hi,
                              int32_t* __restrict__ pgid,
                              int32_t* __restrict__ start,
                              int32_t* __restrict__ end,
                              int32_t* __restrict__ peer_start,
                              int32_t* __restrict__ peer_end,
                              int32_t* __restrict__ peer_id,
                              int32_t* __restrict__ nn_start,
                              int32_t* __restrict__ nn_end) {
  const int32_t c = (int32_t)cap;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    if (live_s[i]) {
      const int32_t g = (int32_t)pinc[i] - 1;
      const int32_t q = (int32_t)qinc[i] - 1;
      pgid[i] = g;
      start[i] = pfirst[g];
      end[i] = plast[g];
      peer_id[i] = q;
      peer_start[i] = qfirst[q];
      peer_end[i] = qlast[q];
      if (nn_start != nullptr) {
        nn_start[i] = nn_lo[g];
        nn_end[i] = nn_hi[g];
      }
    } else {
      pgid[i] = start[i] = end[i] = c;
      peer_start[i] = peer_end[i] = peer_id[i] = c;
      if (nn_start != nullptr) {
        nn_start[i] = c;
        nn_end[i] = -1;
      }
    }
  }
}

struct SegScratch {
  uint32_t *pflag, *qflag, *pinc, *qinc, *scan;
  int32_t *pfirst, *plast, *qfirst, *qlast, *nn_lo, *nn_hi;
};

size_t carve(void* base, long long cap, SegScratch* s) {
  Carver c{static_cast<char*>(base), 0};
  s->pflag = c.take<uint32_t>(cap);
  s->qflag = c.take<uint32_t>(cap);
  s->pinc = c.take<uint32_t>(cap);
  s->qinc = c.take<uint32_t>(cap);
  s->scan = c.take<uint32_t>(scan_scratch_elems(cap));
  s->pfirst = c.take<int32_t>(cap);
  s->plast = c.take<int32_t>(cap);
  s->qfirst = c.take<int32_t>(cap);
  s->qlast = c.take<int32_t>(cap);
  s->nn_lo = c.take<int32_t>(cap);
  s->nn_hi = c.take<int32_t>(cap);
  return c.used;
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API size_t srt_window_segments_scratch_bytes(long long cap) {
  SegScratch s;
  return carve(nullptr, cap, &s);
}

// words: uint32 [n_words][cap] in input order; perm: int32 [cap]; live:
// uint8 [cap] in input order; rk_data / rk_valid: the range key in input
// order, or null (then key_s, kvalid, nn_start and nn_end are not written
// and may be null). Every output is [cap] in sorted order.
SRT_API int srt_window_segments(
    const uint32_t* words, int n_words, int n_part_words, long long cap,
    const int32_t* perm, const uint8_t* live, const int64_t* rk_data,
    const uint8_t* rk_valid, int desc, uint8_t* live_s, int32_t* pgid,
    int32_t* start, int32_t* end, int32_t* peer_start, int32_t* peer_end,
    int32_t* peer_id, int64_t* key_s, uint8_t* kvalid, int32_t* nn_start,
    int32_t* nn_end, void* scratch, size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  if (cap > 0x7FFFFFFFLL || n_words < 1 || n_part_words < 0 ||
      n_part_words > n_words || (rk_data != nullptr && rk_valid == nullptr))
    return fail(cudaErrorInvalidValue, "window_segments arguments");
  SegScratch s;
  if (carve(scratch, cap, &s) > scratch_bytes)
    return fail(cudaErrorInvalidValue, "window_segments scratch size");
  const bool range = rk_data != nullptr;
  const long long blocks = std::min<long long>(ceil_div(cap, kThreads), 8192);
  const unsigned grid = (unsigned)blocks;
  flags_kernel<<<grid, kThreads, 0, st>>>(
      words, n_words, n_part_words, cap, perm, live, rk_data, rk_valid, desc,
      live_s, s.pflag, s.qflag, range ? key_s : nullptr,
      range ? kvalid : nullptr);
  SRT_LAUNCHED("window flags_kernel");
  SRT_TRY(scan_u32(s.pflag, s.pinc, cap, s.scan, nullptr, true, st));
  SRT_TRY(scan_u32(s.qflag, s.qinc, cap, s.scan, nullptr, true, st));
  if (range) {
    init_tables_kernel<<<grid, kThreads, 0, st>>>(cap, s.nn_lo, s.nn_hi);
    SRT_LAUNCHED("window init_tables_kernel");
  }
  tables_kernel<<<grid, kThreads, 0, st>>>(
      cap, live_s, s.pflag, s.qflag, s.pinc, s.qinc,
      range ? kvalid : nullptr, s.pfirst, s.plast, s.qfirst, s.qlast,
      s.nn_lo, s.nn_hi);
  SRT_LAUNCHED("window tables_kernel");
  gather_kernel<<<grid, kThreads, 0, st>>>(
      cap, live_s, s.pinc, s.qinc, s.pfirst, s.plast, s.qfirst, s.qlast,
      s.nn_lo, s.nn_hi, pgid, start, end, peer_start, peer_end, peer_id,
      range ? nn_start : nullptr, range ? nn_end : nullptr);
  SRT_LAUNCHED("window gather_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
