// K15 window_rank_offset: the ranking and offset window functions, written
// straight back to input order.
//
// Replaces spark_rapids_tpu/exec/window.py:_eval_window_fn (:413-448) with
// the scatter to input order (:297-306). From K14's sorted-domain bounds,
// per sorted position i of a live row:
//   row_number = i - start + 1;       rank = peer_start - start + 1;
//   dense_rank = peer_id - peer_id[start] + 1;
//   ntile(n)   = (i - start) * n / max(end - start + 1, 1) + 1 (int64);
//   lag / lead (kind SHIFT, offset -k / +k): the value at sorted position
//   j = i + offset when start <= j <= end, else the default; valid is the
//   source row's validity there, else whether a default was given.
// The result lands at out[perm[i]]; a lane that is not valid (a pad, a
// NULL) gets 0. A SHIFT copies values of 1, 2, 4 or 8 bytes as raw bits
// (the default arrives as its bit pattern), so one kernel serves every
// fixed-width type.
//
// Bound: memory. Per row it reads perm, the live flag and two or three
// int32 bounds (plus, for a shift, one gathered value and flag), and
// writes one value and one flag. One thread per sorted position.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

enum { kRowNumber = 0, kRank = 1, kDenseRank = 2, kNtile = 3, kShift = 4 };

template <typename T>
__global__ void shift_kernel(long long cap, const int32_t* __restrict__ perm,
                             const uint8_t* __restrict__ live_s,
                             const int32_t* __restrict__ start,
                             const int32_t* __restrict__ end,
                             long long offset, const T* __restrict__ values,
                             const uint8_t* __restrict__ vvalid,
                             T default_value, int has_default,
                             T* __restrict__ out,
                             uint8_t* __restrict__ outv) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    const long long j = i + offset;
    const bool in_seg = j >= start[i] && j <= end[i];
    const long long safe = j < 0 ? 0 : (j > cap - 1 ? cap - 1 : j);
    const int32_t src = perm[safe];
    T v = default_value;
    bool ok = has_default != 0;
    if (in_seg) {
      v = values[src];
      ok = vvalid[src] != 0;
    }
    ok = ok && live_s[i] != 0;
    const int32_t r = perm[i];
    out[r] = ok ? v : (T)0;
    outv[r] = ok ? 1 : 0;
  }
}

__global__ void rank_kernel(int kind, long long cap,
                            const int32_t* __restrict__ perm,
                            const uint8_t* __restrict__ live_s,
                            const int32_t* __restrict__ start,
                            const int32_t* __restrict__ end,
                            const int32_t* __restrict__ peer_start,
                            const int32_t* __restrict__ peer_id, long long n,
                            int32_t* __restrict__ out,
                            uint8_t* __restrict__ outv) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    const bool ok = live_s[i] != 0;
    int32_t v = 0;
    if (ok) {
      const int32_t s = start[i];
      if (kind == kRowNumber) {
        v = (int32_t)i - s + 1;
      } else if (kind == kRank) {
        v = peer_start[i] - s + 1;
      } else if (kind == kDenseRank) {
        v = peer_id[i] - peer_id[s] + 1;
      } else {
        long long cnt = (long long)end[i] - s + 1;
        if (cnt < 1) cnt = 1;
        v = (int32_t)(((long long)i - s) * n / cnt + 1);
      }
    }
    const int32_t r = perm[i];
    out[r] = v;
    outv[r] = ok ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch_shift(unsigned grid, cudaStream_t st, long long cap,
                         const int32_t* perm, const uint8_t* live_s,
                         const int32_t* start, const int32_t* end,
                         long long offset, const void* values,
                         const uint8_t* vvalid, long long default_bits,
                         int has_default, void* out, uint8_t* outv) {
  const T dv = (T)(unsigned long long)default_bits;
  shift_kernel<T><<<grid, kThreads, 0, st>>>(
      cap, perm, live_s, start, end, offset, static_cast<const T*>(values),
      vvalid, dv, has_default, static_cast<T*>(out), outv);
  SRT_LAUNCHED("window shift_kernel");
  return cudaSuccess;
}

}  // namespace
}  // namespace srt

using namespace srt;

// kind: 0 row_number, 1 rank, 2 dense_rank, 3 ntile, 4 shift. The bounds
// are K14's (sorted order). For a shift: values / vvalid in input order,
// elem_bytes 1, 2, 4 or 8, default_bits the default's bit pattern; out has
// the values' element size. Otherwise out is int32. Both outputs are [cap]
// in input order.
SRT_API int srt_window_rank_offset(
    int kind, long long cap, const int32_t* perm, const uint8_t* live_s,
    const int32_t* start, const int32_t* end, const int32_t* peer_start,
    const int32_t* peer_id, long long n, long long offset,
    const void* values, const uint8_t* vvalid, int elem_bytes,
    long long default_bits, int has_default, void* out, uint8_t* outv,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  if (cap > 0x7FFFFFFFLL || kind < kRowNumber || kind > kShift)
    return fail(cudaErrorInvalidValue, "window_rank_offset arguments");
  const unsigned grid =
      (unsigned)std::min<long long>(ceil_div(cap, kThreads), 8192);
  if (kind != kShift) {
    rank_kernel<<<grid, kThreads, 0, st>>>(
        kind, cap, perm, live_s, start, end, peer_start, peer_id, n,
        static_cast<int32_t*>(out), outv);
    SRT_LAUNCHED("window rank_kernel");
    return 0;
  }
  switch (elem_bytes) {
    case 1:
      return launch_shift<uint8_t>(grid, st, cap, perm, live_s, start, end,
                                   offset, values, vvalid, default_bits,
                                   has_default, out, outv);
    case 2:
      return launch_shift<uint16_t>(grid, st, cap, perm, live_s, start, end,
                                    offset, values, vvalid, default_bits,
                                    has_default, out, outv);
    case 4:
      return launch_shift<uint32_t>(grid, st, cap, perm, live_s, start, end,
                                    offset, values, vvalid, default_bits,
                                    has_default, out, outv);
    case 8:
      return launch_shift<uint64_t>(grid, st, cap, perm, live_s, start, end,
                                    offset, values, vvalid, default_bits,
                                    has_default, out, outv);
    default:
      return fail(cudaErrorInvalidValue, "window_rank_offset element size");
  }
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
