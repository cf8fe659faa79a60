// K16 window_frame_agg: an aggregate over each row's window frame, written
// straight back to input order.
//
// Replaces spark_rapids_tpu/exec/window.py:_frame_bounds (:475), _bsearch
// (:457), _rmq (:523) and _eval_window_agg (:549-624), with the scatter to
// input order (:297-306). From K14's sorted-domain structure, per sorted
// position i:
//   frame [lo, hi]: ROWS offsets clamped to the partition; RANGE with
//     unbounded / current-row sides takes the partition or peer bounds;
//     a bounded RANGE side binary-searches key_s (ascending inside the
//     partition's non-NULL span [nn_start, nn_end]) for key_s[i] + offset
//     (wrapping int64 add, as the reference's); a NULL key frames its
//     peer group. Empty when hi < lo.
//   count = cnt[hi + 1] - cnt[lo] over the prefix count of valid rows;
//   sum / avg = ps[hi + 1] - ps[lo] over the prefix sum of the valid
//     values at the result's storage type (int64 wraps, double rounds in
//     the scan's order); avg divides by max(count, 1); NULL when count 0;
//   min / max over int64 order keys (floats by their order bits, NaN
//     largest): over the whole partition (a segmented scan read at the
//     partition end), running (the scan read at the row, or at its peer
//     end for RANGE), or any other frame (a loop over [lo, hi]);
//   first / last: the value at lo / hi, NULL for an empty frame.
// The result lands at out[perm[i]]; a lane that is not valid gets 0.
//
// Bound: memory. Per row it reads perm, the value and its flag once
// (gathered through perm), K14's int32 bounds and the prefix arrays twice,
// and writes one value and one flag; a bounded RANGE side adds
// log2(partition) key reads, an arbitrary min / max frame its width.
// Design: a gather kernel puts the contributions in sorted order, the
// scans are three-phase (a tile scan with cub::BlockScan, a recursive scan
// of the tile totals, a carry pass), the segmented min / max scan carries
// a head flag beside each value, and one thread a row computes the frame
// and the result.
#include <algorithm>
#include <cfloat>

#include "common.cuh"

namespace srt {
namespace {

enum { kSum = 0, kCount = 1, kAvg = 2, kMin = 3, kMax = 4, kFirst = 5,
       kLast = 6 };
enum { kRows = 0, kRange = 1 };
enum { kWhole = 0, kRunning = 1, kFrame = 2 };
enum { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kI8 = 4, kI16 = 5,
       kBool = 6 };
constexpr long long kNone = -(1LL << 62);
constexpr long long kLow63 = 0x7FFFFFFFFFFFFFFFLL;

// ------------------------------------------------------------- values
__device__ __forceinline__ double load_value(const void* v, int dt,
                                             long long r, long long* iv) {
  switch (dt) {
    case kI32: *iv = static_cast<const int32_t*>(v)[r]; return (double)*iv;
    case kI64: *iv = static_cast<const int64_t*>(v)[r]; return (double)*iv;
    case kI8: *iv = static_cast<const int8_t*>(v)[r]; return (double)*iv;
    case kI16: *iv = static_cast<const int16_t*>(v)[r]; return (double)*iv;
    case kBool: *iv = static_cast<const uint8_t*>(v)[r]; return (double)*iv;
    case kF32: *iv = 0; return (double)static_cast<const float*>(v)[r];
    default: *iv = 0; return static_cast<const double*>(v)[r];
  }
}

// total-order int64 key of a value (rowkeys.py:_float_order_bits for
// floats: -0.0 -> 0.0, every NaN one value above +inf)
__device__ __forceinline__ long long order_key(const void* v, int dt,
                                               long long r) {
  if (dt == kF64) {
    double x = static_cast<const double*>(v)[r];
    long long bits;
    if (x != x)
      bits = 0x7FF8000000000000LL;
    else
      bits = __double_as_longlong(x == 0.0 ? 0.0 : x);
    return bits < 0 ? bits ^ kLow63 : bits;
  }
  if (dt == kF32) {
    float x = static_cast<const float*>(v)[r];
    uint32_t bits;
    if (x != x)
      bits = 0x7FC00000u;
    else
      bits = __float_as_uint(x == 0.0f ? 0.0f : x);
    return bits >= 0x80000000u ? (long long)(~bits) : (long long)(bits | 0x80000000u);
  }
  long long iv;
  load_value(v, dt, r, &iv);
  return iv;
}

__device__ __forceinline__ void store_from_key(void* out, int dt,
                                               long long r, long long k) {
  switch (dt) {
    case kF64: {
      const long long bits = k < 0 ? k ^ kLow63 : k;
      static_cast<double*>(out)[r] = __longlong_as_double(bits);
      return;
    }
    case kF32: {
      const uint32_t key = (uint32_t)k;
      const uint32_t bits = key >= 0x80000000u ? key ^ 0x80000000u : ~key;
      static_cast<float*>(out)[r] = __uint_as_float(bits);
      return;
    }
    case kI32: static_cast<int32_t*>(out)[r] = (int32_t)k; return;
    case kI8: static_cast<int8_t*>(out)[r] = (int8_t)k; return;
    case kI16: static_cast<int16_t*>(out)[r] = (int16_t)k; return;
    case kBool: static_cast<uint8_t*>(out)[r] = (uint8_t)k; return;
    default: static_cast<int64_t*>(out)[r] = k; return;
  }
}

__device__ __forceinline__ void copy_value(void* out, int dt, long long r,
                                           const void* in, long long s) {
  switch (dt) {
    case kF64: case kI64:
      static_cast<int64_t*>(out)[r] = static_cast<const int64_t*>(in)[s];
      return;
    case kF32: case kI32:
      static_cast<int32_t*>(out)[r] = static_cast<const int32_t*>(in)[s];
      return;
    case kI16:
      static_cast<int16_t*>(out)[r] = static_cast<const int16_t*>(in)[s];
      return;
    default:
      static_cast<uint8_t*>(out)[r] = static_cast<const uint8_t*>(in)[s];
      return;
  }
}

__device__ __forceinline__ void store_zero(void* out, int dt, long long r) {
  switch (dt) {
    case kF64: case kI64: static_cast<int64_t*>(out)[r] = 0; return;
    case kF32: case kI32: static_cast<int32_t*>(out)[r] = 0; return;
    case kI16: static_cast<int16_t*>(out)[r] = 0; return;
    default: static_cast<uint8_t*>(out)[r] = 0; return;
  }
}

__device__ __forceinline__ long long worst_key(int dt, bool is_min) {
  switch (dt) {
    case kF64: return is_min ? kLow63 : (long long)(-kLow63 - 1);
    case kF32: return is_min ? 0xFFFFFFFFLL : 0;
    case kI32: return is_min ? 0x7FFFFFFFLL : -0x80000000LL;
    case kI8: return is_min ? 127 : -128;
    case kI16: return is_min ? 32767 : -32768;
    case kBool: return is_min ? 1 : 0;
    default: return is_min ? kLow63 : (long long)(-kLow63 - 1);
  }
}

// ------------------------------------------------------- segmented scan
// Inclusive scan of (head, value) pairs: combine(a, b) = (a.h | b.h,
// b.h ? b.v : op(a.v, b.v)). With no heads it is a plain scan.
template <typename T>
struct Pair {
  T v;
  int h;
};

struct OpSum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct OpMin {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return b < a ? b : a;
  }
};
struct OpMax {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a < b ? b : a;
  }
};

template <typename T, typename Op>
struct PairOp {
  Op op;
  __device__ __forceinline__ Pair<T> operator()(const Pair<T>& a,
                                                const Pair<T>& b) const {
    Pair<T> r;
    r.h = a.h | b.h;
    r.v = b.h ? b.v : op(a.v, b.v);
    return r;
  }
};

// tile scan: out[i] = local inclusive scan inside the tile, with its head
// flag in out_h; tile totals in agg / agg_h
template <typename T, typename Op>
__global__ void seg_scan_tiles(const T* in,  // may alias out (in place)
                               const uint8_t* __restrict__ heads,
                               long long m, T* out,
                               uint8_t* __restrict__ out_h,
                               T* __restrict__ agg,
                               uint8_t* __restrict__ agg_h) {
  using BlockScan = cub::BlockScan<Pair<T>, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  PairOp<T, Op> pop;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  Pair<T> items[kItems];
  Pair<T> run;
  run.v = T(0);
  run.h = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long idx = base + k;
    Pair<T> p;
    if (idx < m) {
      p.v = in[idx];
      p.h = heads != nullptr ? (int)heads[idx] : 0;
    } else {
      p.v = T(0);
      p.h = 1;  // a tail past the end never feeds a real element
    }
    run = k == 0 ? p : pop(run, p);
    items[k] = run;
  }
  Pair<T> prefix, total;
  BlockScan(tmp).ExclusiveScan(run, prefix, pop, total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long idx = base + k;
    const Pair<T> r = threadIdx.x == 0 ? items[k] : pop(prefix, items[k]);
    if (idx < m) {
      out[idx] = r.v;
      out_h[idx] = (uint8_t)r.h;
    }
  }
  if (agg != nullptr && threadIdx.x == 0) {
    agg[blockIdx.x] = total.v;
    agg_h[blockIdx.x] = (uint8_t)total.h;
  }
}

template <typename T, typename Op>
__global__ void seg_scan_carry(T* __restrict__ out,
                               const uint8_t* __restrict__ out_h,
                               long long m, const T* __restrict__ agg) {
  if (blockIdx.x == 0) return;
  Op op;
  const T carry = agg[blockIdx.x - 1];  // inclusive total of tiles before
  const long long base = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long idx = base + i;
    if (idx < m && !out_h[idx]) out[idx] = op(carry, out[idx]);
  }
}

template <typename T>
struct ScanBufs {
  T* agg;
  uint8_t* agg_h;
  uint8_t* tmp_h;  // head flags of the tile-total scan
};

inline long long seg_scan_levels_elems(long long m) {
  const long long nb = ceil_div(m, kTile);
  if (nb <= 1) return 0;
  return nb + seg_scan_levels_elems(nb);
}

// inclusive (segmented) scan of in[0, m) into out; heads may be null.
// agg / agg_h / tmp_h hold seg_scan_levels_elems(m) entries each.
template <typename T, typename Op>
cudaError_t seg_scan(const T* in, const uint8_t* heads, long long m, T* out,
                     uint8_t* out_h, T* agg, uint8_t* agg_h, uint8_t* tmp_h,
                     cudaStream_t s) {
  if (m <= 0) return cudaSuccess;
  const long long nb = ceil_div(m, kTile);
  seg_scan_tiles<T, Op><<<(unsigned)nb, kThreads, 0, s>>>(
      in, heads, m, out, out_h, nb > 1 ? agg : nullptr,
      nb > 1 ? agg_h : nullptr);
  SRT_LAUNCHED("window seg_scan_tiles");
  if (nb > 1) {
    // scan the tile totals in place (their heads: any head in the tile)
    SRT_TRY((seg_scan<T, Op>(agg, agg_h, nb, agg, tmp_h, agg + nb,
                             agg_h + nb, tmp_h + nb, s)));
    seg_scan_carry<T, Op><<<(unsigned)nb, kThreads, 0, s>>>(out, out_h, m,
                                                            agg);
    SRT_LAUNCHED("window seg_scan_carry");
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- kernels
template <typename A>
__global__ void gather_kernel(long long cap, const int32_t* __restrict__ perm,
                              const uint8_t* __restrict__ live_s,
                              const int32_t* __restrict__ start,
                              const void* __restrict__ values, int vdt,
                              const uint8_t* __restrict__ vvalid, int func,
                              uint8_t* __restrict__ valid_s,
                              uint32_t* __restrict__ cnt_flag,
                              A* __restrict__ contrib,
                              long long* __restrict__ keys,
                              uint8_t* __restrict__ heads) {
  const bool is_min = func == kMin;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    const int32_t r = perm[i];
    const bool ok = live_s[i] != 0 && vvalid[r] != 0;
    valid_s[i] = ok ? 1 : 0;
    cnt_flag[i] = ok ? 1u : 0u;
    if (contrib != nullptr) {
      long long iv;
      const double dv = load_value(values, vdt, r, &iv);
      A a;
      if (vdt == kF32 || vdt == kF64)
        a = (A)dv;
      else
        a = (A)iv;
      contrib[i] = ok ? a : A(0);
    }
    if (keys != nullptr) {
      keys[i] = ok ? order_key(values, vdt, r) : worst_key(vdt, is_min);
      heads[i] = (start[i] == (int32_t)i || !live_s[i]) ? 1 : 0;
    }
  }
}

__device__ __forceinline__ long long lower_bound_key(
    const long long* __restrict__ keys, long long lo, long long hi,
    long long target, bool right) {
  // smallest index in [lo, hi] with key >= target (right: > target);
  // hi itself when there is none
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long vm = keys[mid];
    const bool go_right = right ? (vm <= target) : (vm < target);
    if (go_right)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

struct FrameArgs {
  int func, mode, mm_method, vdt, odt;
  long long lower, upper;
};

template <typename A>
__global__ void result_kernel(
    FrameArgs fa, long long cap, const int32_t* __restrict__ perm,
    const uint8_t* __restrict__ live_s, const int32_t* __restrict__ start,
    const int32_t* __restrict__ end, const int32_t* __restrict__ peer_start,
    const int32_t* __restrict__ peer_end, const long long* __restrict__ key_s,
    const uint8_t* __restrict__ kvalid, const int32_t* __restrict__ nn_start,
    const int32_t* __restrict__ nn_end, const void* __restrict__ values,
    const uint8_t* __restrict__ valid_s, const uint32_t* __restrict__ pc,
    const A* __restrict__ ps, const long long* __restrict__ keys,
    const long long* __restrict__ scan, void* __restrict__ out,
    uint8_t* __restrict__ outv) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x) {
    const long long s = start[i], e = end[i];
    long long lo, hi;
    if (fa.mode == kRows) {
      lo = fa.lower == kNone ? s : max(s, i + fa.lower);
      hi = fa.upper == kNone ? e : min(e, i + fa.upper);
    } else {
      const long long ps_ = peer_start[i], pe = peer_end[i];
      const bool simple_lo = fa.lower == kNone || fa.lower == 0;
      const bool simple_hi = fa.upper == kNone || fa.upper == 0;
      if (simple_lo && simple_hi) {
        lo = fa.lower == kNone ? s : ps_;
        hi = fa.upper == kNone ? e : pe;
      } else if (!kvalid[i]) {
        lo = ps_;
        hi = pe;
      } else {
        const long long k = key_s[i];
        const long long a = nn_start[i], b = (long long)nn_end[i] + 1;
        if (fa.lower == kNone)
          lo = s;
        else if (fa.lower == 0)
          lo = ps_;
        else
          lo = lower_bound_key(
              key_s, a, b,
              (long long)((unsigned long long)k + (unsigned long long)fa.lower),
              false);
        if (fa.upper == kNone)
          hi = e;
        else if (fa.upper == 0)
          hi = pe;
        else
          hi = lower_bound_key(
                   key_s, a, b,
                   (long long)((unsigned long long)k +
                               (unsigned long long)fa.upper),
                   true) -
               1;
      }
    }
    const bool empty = hi < lo;
    const long long lo_c = lo < 0 ? 0 : (lo > cap ? cap : lo);
    const long long hi1 = hi + 1;
    const long long hi1_c = hi1 < 0 ? 0 : (hi1 > cap ? cap : hi1);
    const long long cnt =
        empty ? 0
              : (long long)(hi1_c ? pc[hi1_c - 1] : 0u) -
                    (long long)(lo_c ? pc[lo_c - 1] : 0u);
    const int32_t r = perm[i];
    const bool live = live_s[i] != 0;
    bool ok;
    if (fa.func == kCount) {
      ok = live;
      if (ok) static_cast<int64_t*>(out)[r] = cnt;
    } else if (fa.func == kSum || fa.func == kAvg) {
      const A sum = (hi1_c ? ps[hi1_c - 1] : A(0)) - (lo_c ? ps[lo_c - 1] : A(0));
      ok = live && cnt > 0;
      if (ok) {
        if (fa.func == kSum) {
          static_cast<A*>(out)[r] = sum;
        } else if (fa.odt == kF32) {
          static_cast<float*>(out)[r] = (float)sum / (float)cnt;
        } else if (fa.odt == kF64) {
          static_cast<double*>(out)[r] = (double)sum / (double)cnt;
        } else {
          // a decimal average keeps the reference's double, truncated
          static_cast<int64_t*>(out)[r] =
              (long long)((double)sum / (double)cnt);
        }
      }
    } else if (fa.func == kMin || fa.func == kMax) {
      ok = live && cnt > 0;
      if (ok) {
        long long red;
        if (fa.mm_method == kWhole) {
          red = scan[e];
        } else if (fa.mm_method == kRunning) {
          red = scan[fa.mode == kRange ? (long long)peer_end[i] : i];
        } else {
          const bool is_min = fa.func == kMin;
          red = keys[lo];
          for (long long j = lo + 1; j <= hi; ++j) {
            const long long v = keys[j];
            red = is_min ? (v < red ? v : red) : (red < v ? v : red);
          }
        }
        store_from_key(out, fa.odt, r, red);
      }
    } else {
      const long long sel0 = fa.func == kFirst ? lo : hi;
      const long long sel = sel0 < 0 ? 0 : (sel0 > cap - 1 ? cap - 1 : sel0);
      ok = live && valid_s[sel] && !empty;
      if (ok) copy_value(out, fa.odt, r, values, perm[sel]);
    }
    if (!ok) store_zero(out, fa.odt, r);
    outv[r] = ok ? 1 : 0;
  }
}

struct AggScratch {
  uint8_t *valid_s, *heads, *out_h, *agg_h, *tmp_h;
  uint32_t *cnt_flag, *pc, *scan32;
  long long *contrib, *ps, *keys, *scan, *agg;
};

size_t carve(void* base, long long cap, AggScratch* s) {
  Carver c{static_cast<char*>(base), 0};
  const long long lv = seg_scan_levels_elems(cap);
  s->valid_s = c.take<uint8_t>(cap);
  s->heads = c.take<uint8_t>(cap);
  s->out_h = c.take<uint8_t>(cap);
  s->agg_h = c.take<uint8_t>(lv);
  s->tmp_h = c.take<uint8_t>(lv);
  s->cnt_flag = c.take<uint32_t>(cap);
  s->pc = c.take<uint32_t>(cap);
  s->scan32 = c.take<uint32_t>(scan_scratch_elems(cap));
  s->contrib = c.take<long long>(cap);  // 8 bytes: int64, double, float
  s->ps = c.take<long long>(cap);
  s->keys = c.take<long long>(cap);
  s->scan = c.take<long long>(cap);
  s->agg = c.take<long long>(lv);
  return c.used;
}

template <typename A>
cudaError_t run(const FrameArgs& fa, long long cap, const int32_t* perm,
                const uint8_t* live_s, const int32_t* start,
                const int32_t* end, const int32_t* peer_start,
                const int32_t* peer_end, const long long* key_s,
                const uint8_t* kvalid, const int32_t* nn_start,
                const int32_t* nn_end, const void* values,
                const uint8_t* vvalid, void* out, uint8_t* outv,
                const AggScratch& s, cudaStream_t st) {
  const unsigned grid =
      (unsigned)std::min<long long>(ceil_div(cap, kThreads), 8192);
  const bool sums = fa.func == kSum || fa.func == kAvg;
  const bool minmax = fa.func == kMin || fa.func == kMax;
  A* contrib = sums ? reinterpret_cast<A*>(s.contrib) : nullptr;
  A* ps = reinterpret_cast<A*>(s.ps);
  gather_kernel<A><<<grid, kThreads, 0, st>>>(
      cap, perm, live_s, start, values, fa.vdt, vvalid, fa.func, s.valid_s,
      s.cnt_flag, contrib, minmax ? s.keys : nullptr, s.heads);
  SRT_LAUNCHED("window frame gather_kernel");
  SRT_TRY(scan_u32(s.cnt_flag, s.pc, cap, s.scan32, nullptr, true, st));
  if (sums) {
    SRT_TRY((seg_scan<A, OpSum>(contrib, nullptr, cap, ps, s.out_h,
                                reinterpret_cast<A*>(s.agg), s.agg_h,
                                s.tmp_h, st)));
  }
  if (minmax && fa.mm_method != kFrame) {
    if (fa.func == kMin) {
      SRT_TRY((seg_scan<long long, OpMin>(s.keys, s.heads, cap, s.scan,
                                          s.out_h, s.agg, s.agg_h, s.tmp_h,
                                          st)));
    } else {
      SRT_TRY((seg_scan<long long, OpMax>(s.keys, s.heads, cap, s.scan,
                                          s.out_h, s.agg, s.agg_h, s.tmp_h,
                                          st)));
    }
  }
  result_kernel<A><<<grid, kThreads, 0, st>>>(
      fa, cap, perm, live_s, start, end, peer_start, peer_end, key_s, kvalid,
      nn_start, nn_end, values, s.valid_s, s.pc, ps, s.keys, s.scan, out,
      outv);
  SRT_LAUNCHED("window frame result_kernel");
  return cudaSuccess;
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API size_t srt_window_frame_agg_scratch_bytes(long long cap) {
  AggScratch s;
  return carve(nullptr, cap, &s);
}

// func: 0 sum, 1 count, 2 avg, 3 min, 4 max, 5 first, 6 last; mode: 0
// ROWS, 1 RANGE; lower / upper: frame offsets, -2^62 for unbounded;
// mm_method: 0 whole partition, 1 running, 2 any frame. The structure
// arrays are K14's (sorted order; the range key ones may be null unless a
// RANGE side is bounded). values / vvalid in input order with value type
// vdt; out has type odt (the accumulator of a sum); both outputs [cap] in
// input order. Types: 0 int32, 1 int64, 2 float32, 3 float64, 4 int8, 5
// int16, 6 bool.
SRT_API int srt_window_frame_agg(
    int func, int mode, long long lower, long long upper, int mm_method,
    long long cap, const int32_t* perm, const uint8_t* live_s,
    const int32_t* start, const int32_t* end,
    const int32_t* peer_start, const int32_t* peer_end,
    const long long* key_s, const uint8_t* kvalid, const int32_t* nn_start,
    const int32_t* nn_end, const void* values, const uint8_t* vvalid,
    int vdt, int odt, void* out, uint8_t* outv, void* scratch,
    size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  const bool bounded_range =
      mode == kRange && !((lower == kNone || lower == 0) &&
                          (upper == kNone || upper == 0));
  if (cap > 0x7FFFFFFFLL || func < kSum || func > kLast || vdt < kI32 ||
      vdt > kBool || odt < kI32 || odt > kBool ||
      (bounded_range && (key_s == nullptr || kvalid == nullptr ||
                         nn_start == nullptr || nn_end == nullptr)))
    return fail(cudaErrorInvalidValue, "window_frame_agg arguments");
  AggScratch s;
  if (carve(scratch, cap, &s) > scratch_bytes)
    return fail(cudaErrorInvalidValue, "window_frame_agg scratch size");
  FrameArgs fa{func, mode, mm_method, vdt, odt, lower, upper};
  // the accumulator of a sum / avg is the result's storage type
  const bool sums = func == kSum || func == kAvg;
  if (sums && odt == kF64)
    return (int)run<double>(fa, cap, perm, live_s, start, end, peer_start,
                            peer_end, key_s, kvalid, nn_start, nn_end,
                            values, vvalid, out, outv, s, st);
  if (sums && odt == kF32)
    return (int)run<float>(fa, cap, perm, live_s, start, end, peer_start,
                           peer_end, key_s, kvalid, nn_start, nn_end,
                           values, vvalid, out, outv, s, st);
  if (sums && odt != kI64)
    return fail(cudaErrorInvalidValue, "window_frame_agg sum type");
  return (int)run<long long>(fa, cap, perm, live_s, start, end, peer_start,
                             peer_end, key_s, kvalid, nn_start, nn_end,
                             values, vvalid, out, outv, s, st);
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
