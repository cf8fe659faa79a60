// K3 segment_reduce: per-group count, sum, min, max, any, first and last of
// every aggregate column in one launch, over the group-sorted order.
//
// Replaces spark_rapids_tpu/exec/rowkeys.py:segment_reduce with
// _sorted_group_totals / _sorted_counts / _sorted_segment_reduce, and its
// first / last branch (:641-672). SQL null
// semantics: null inputs are skipped, a group without a non-null input is
// NULL (its slot holds 0), count is never NULL; integer sums wrap modulo
// 2^64; float min/max reduce on order bits, so -0.0 equals 0.0 and NaN is
// the largest value. Slots at or above num_groups come out as 0 (NULL, or
// a 0 count).
//
// first / last (and their _ignore_nulls forms) select a row: each run
// flushes the least (first) or greatest (last) original row position with
// atomicMin / atomicMax into an int32 slot per group, over every row of
// the group or, with _ignore_nulls, over its valid rows only, as the
// reference's unsorted branch does (:665-669; its sorted branch's rep_rows
// and seg_ends pick the same rows). The finalize pass copies that row's
// value (1, 2, 4 or 8 bytes: any type) and validity; a group with no such
// row is NULL.
//
// BOOL lanes (dtype kBool) reduce as unsigned bytes into an int32
// accumulator: min is AND, max and `any` (the per-group OR of
// rowkeys.py:552, :586, :613) are OR; the result is a bool lane, NULL for
// a group without a non-null row, as the reference's min / max / any
// branch (:528-616).
//
// Bound: memory. Per row and column it reads order and gid_sorted (once per
// column from L2), the row's value and valid flag through order (a random
// gather), and writes one accumulator per group.
//
// Design: each thread reduces a run of kChunk consecutive sorted positions,
// so one group's rows mostly fall to one thread. Integer sums, counts and
// min/max (floats as order bits) flush each run with one 64- or 32-bit
// atomic, which is order-free and so exact. Float sums must not depend on
// timing: a run that starts and ends inside its chunk is stored directly,
// the partial sums of runs cut by chunk edges go to per-chunk head/tail
// slots, and a second kernel adds them in chunk order (one block per
// group, a fixed strided split and a fixed tree), so the result is the same
// bits on every run.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kChunk = 32;
constexpr int kMaxCols = 16;

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kFirst = 4, kLast = 5,
          kFirstIgnoreNulls = 6, kLastIgnoreNulls = 7, kAny = 8 };
enum Dt { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kBool = 4 };

}  // namespace
}  // namespace srt

// Host-visible column descriptor (mirrored by a ctypes.Structure).
struct SrtSegCol {
  const void* data;     // values in original row order
  const uint8_t* valid; // validity in original row order
  void* acc;            // accumulator per group slot (see the wrapper)
  void* out;            // result data per group slot
  uint8_t* out_valid;   // result validity per group slot
  int32_t* nonnull;     // non-null inputs per group slot (sum/min/max)
  void* head;           // float sums: partial of a chunk's first run
  void* tail;           // float sums: partial of a chunk's last run
  int32_t op;
  int32_t dtype;  // first / last: the value's width in bytes
};

namespace srt {
namespace {

struct SegCols {
  SrtSegCol c[kMaxCols];
  int n;
};

__device__ __forceinline__ uint32_t f32_order_bits(float x) {
  uint32_t bits;
  if (x == 0.0f) bits = 0u;                  // -0.0 == 0.0
  else if (isnan(x)) bits = 0x7FC00000u;     // one canonical NaN
  else bits = __float_as_uint(x);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned long long f64_order_bits(double x) {
  unsigned long long bits;
  if (x == 0.0) bits = 0ull;
  else if (isnan(x)) bits = 0x7FF8000000000000ull;
  else bits = (unsigned long long)__double_as_longlong(x);
  return (bits >> 63) ? ~bits : (bits | 0x8000000000000000ull);
}

__device__ __forceinline__ float f32_from_order_bits(uint32_t f) {
  const uint32_t bits = (f & 0x80000000u) ? (f ^ 0x80000000u) : ~f;
  return __uint_as_float(bits);
}

__device__ __forceinline__ double f64_from_order_bits(unsigned long long f) {
  const unsigned long long bits =
      (f & 0x8000000000000000ull) ? (f ^ 0x8000000000000000ull) : ~f;
  return __longlong_as_double((long long)bits);
}

__device__ void flush_atomic(const SrtSegCol& c, int32_t g, long long acc_i,
                             unsigned long long acc_u, int32_t nn) {
  if (c.op == kCount) {
    if (nn) atomicAdd(static_cast<unsigned long long*>(c.acc) + g,
                      (unsigned long long)nn);
    return;
  }
  if (nn == 0) return;
  atomicAdd(c.nonnull + g, nn);
  if (c.op == kSum) {
    atomicAdd(static_cast<unsigned long long*>(c.acc) + g,
              (unsigned long long)acc_i);
  } else if (c.dtype == kI32 || c.dtype == kBool) {
    int* p = static_cast<int*>(c.acc) + g;
    if (c.op == kMin) atomicMin(p, (int)acc_i);
    else atomicMax(p, (int)acc_i);
  } else if (c.dtype == kI64) {
    long long* p = static_cast<long long*>(c.acc) + g;
    if (c.op == kMin) atomicMin(p, acc_i);
    else atomicMax(p, acc_i);
  } else if (c.dtype == kF32) {
    unsigned int* p = static_cast<unsigned int*>(c.acc) + g;
    if (c.op == kMin) atomicMin(p, (unsigned int)acc_u);
    else atomicMax(p, (unsigned int)acc_u);
  } else {
    unsigned long long* p = static_cast<unsigned long long*>(c.acc) + g;
    if (c.op == kMin) atomicMin(p, acc_u);
    else atomicMax(p, acc_u);
  }
}

__device__ __forceinline__ bool is_select(int op) {
  return op >= kFirst && op <= kLastIgnoreNulls;
}

// first / last: one atomic per run of the chunk with the run's least or
// greatest row position (acc holds int32 positions)
__device__ void select_col(const SrtSegCol& c, long long start, long long end,
                           long long n, const int32_t* __restrict__ order,
                           const int32_t* __restrict__ gid_sorted) {
  const bool last = c.op == kLast || c.op == kLastIgnoreNulls;
  const bool skip_nulls = c.op == kFirstIgnoreNulls || c.op == kLastIgnoreNulls;
  int32_t* acc = static_cast<int32_t*>(c.acc);
  int32_t run_g = -1;
  int32_t sel = -1;
  for (long long i = start; i < end; ++i) {
    const int32_t g = gid_sorted[i];
    if (g >= n) break;  // pads sort last
    if (g != run_g) {
      if (sel >= 0) last ? atomicMax(acc + run_g, sel) : atomicMin(acc + run_g, sel);
      run_g = g;
      sel = -1;
    }
    const int32_t r = order[i];
    if (skip_nulls && !c.valid[r]) continue;
    if (sel < 0) sel = r;
    else sel = last ? (r > sel ? r : sel) : (r < sel ? r : sel);
  }
  if (sel >= 0) last ? atomicMax(acc + run_g, sel) : atomicMin(acc + run_g, sel);
}

__device__ void reduce_atomic_col(const SrtSegCol& c, long long start,
                                  long long end, long long n,
                                  const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ gid_sorted) {
  int32_t run_g = -1;
  long long acc_i = 0;
  unsigned long long acc_u = 0;
  int32_t nn = 0;
  const bool is_min = c.op == kMin;
  for (long long i = start; i < end; ++i) {
    const int32_t g = gid_sorted[i];
    if (g >= n) break;  // pads sort last
    if (g != run_g) {
      if (run_g >= 0) flush_atomic(c, run_g, acc_i, acc_u, nn);
      run_g = g;
      nn = 0;
      acc_i = 0;
      acc_u = 0;
    }
    const int32_t r = order[i];
    if (!c.valid[r]) continue;
    if (c.op == kCount) {
      ++nn;
      continue;
    }
    long long vi = 0;
    unsigned long long vu = 0;
    switch (c.dtype) {
      case kI32: vi = static_cast<const int32_t*>(c.data)[r]; break;
      case kI64: vi = static_cast<const long long*>(c.data)[r]; break;
      case kBool: vi = static_cast<const uint8_t*>(c.data)[r] != 0; break;
      case kF32: vu = f32_order_bits(static_cast<const float*>(c.data)[r]); break;
      default: vu = f64_order_bits(static_cast<const double*>(c.data)[r]); break;
    }
    if (nn == 0) {
      acc_i = vi;
      acc_u = vu;
    } else if (c.op == kSum) {
      acc_i = (long long)((unsigned long long)acc_i + (unsigned long long)vi);
    } else if (c.dtype == kI32 || c.dtype == kI64 || c.dtype == kBool) {
      acc_i = is_min ? (vi < acc_i ? vi : acc_i) : (vi > acc_i ? vi : acc_i);
    } else {
      acc_u = is_min ? (vu < acc_u ? vu : acc_u) : (vu > acc_u ? vu : acc_u);
    }
    ++nn;
  }
  if (run_g >= 0) flush_atomic(c, run_g, acc_i, acc_u, nn);
}

template <typename F>
__device__ void reduce_float_sum_col(const SrtSegCol& c, long long chunk,
                                     long long start, long long end,
                                     long long n,
                                     const int32_t* __restrict__ order,
                                     const int32_t* __restrict__ gid_sorted) {
  F* out = static_cast<F*>(c.out);
  F* head = static_cast<F*>(c.head);
  F* tail = static_cast<F*>(c.tail);
  const F* data = static_cast<const F*>(c.data);
  int32_t run_g = -1;
  long long rs = start;
  F acc = F(0);
  int32_t nn = 0;
  auto flush = [&](long long re) {
    if (nn) atomicAdd(c.nonnull + run_g, nn);
    const bool cut_before = rs == start && rs > 0 && gid_sorted[rs - 1] == run_g;
    const bool cut_after = re == end && re < n && gid_sorted[re] == run_g;
    if (cut_before) head[chunk] = acc;
    else if (cut_after) tail[chunk] = acc;
    else out[run_g] = acc;
  };
  long long i = start;
  for (; i < end; ++i) {
    const int32_t g = gid_sorted[i];
    if (g >= n) break;
    if (g != run_g) {
      if (run_g >= 0) flush(i);
      run_g = g;
      rs = i;
      acc = F(0);
      nn = 0;
    }
    const int32_t r = order[i];
    if (c.valid[r]) {
      acc += data[r];
      ++nn;
    }
  }
  if (run_g >= 0) flush(i);
}

__global__ void reduce_kernel(SegCols cols, long long n,
                              const int32_t* __restrict__ order,
                              const int32_t* __restrict__ gid_sorted) {
  const long long chunk = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long start = chunk * kChunk;
  if (start >= n) return;
  const long long end = start + kChunk < n ? start + kChunk : n;
  for (int k = 0; k < cols.n; ++k) {
    const SrtSegCol& c = cols.c[k];
    if (is_select(c.op))
      select_col(c, start, end, n, order, gid_sorted);
    else if (c.op == kSum && c.dtype == kF32)
      reduce_float_sum_col<float>(c, chunk, start, end, n, order, gid_sorted);
    else if (c.op == kSum && c.dtype == kF64)
      reduce_float_sum_col<double>(c, chunk, start, end, n, order, gid_sorted);
    else
      reduce_atomic_col(c, start, end, n, order, gid_sorted);
  }
}

// Float sums of groups cut by chunk edges: tail of the first chunk plus the
// heads of the following chunks, added in a fixed order.
template <typename F>
__device__ void combine_group(const SrtSegCol& c, int32_t g,
                              const int32_t* __restrict__ seg_ends, F* red) {
  const long long gs = g == 0 ? 0 : (long long)seg_ends[g - 1] + 1;
  const long long ge = seg_ends[g];
  const long long cs = gs / kChunk, ce = ge / kChunk;
  if (cs == ce) return;  // stored directly by reduce_kernel
  const F* head = static_cast<const F*>(c.head);
  F part = F(0);
  for (long long k = cs + 1 + threadIdx.x; k <= ce; k += blockDim.x)
    part += head[k];
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    static_cast<F*>(c.out)[g] = static_cast<const F*>(c.tail)[cs] + red[0];
  __syncthreads();
}

constexpr int kCombineThreads = 128;

__global__ void combine_kernel(SegCols cols,
                               const int32_t* __restrict__ seg_ends,
                               const int32_t* __restrict__ num_groups) {
  __shared__ double red[kCombineThreads];
  const int32_t ng = num_groups[0];
  for (int32_t g = blockIdx.x; g < ng; g += gridDim.x) {
    for (int k = 0; k < cols.n; ++k) {
      const SrtSegCol& c = cols.c[k];
      if (c.op != kSum) continue;
      if (c.dtype == kF32)
        combine_group<float>(c, g, seg_ends, reinterpret_cast<float*>(red));
      else if (c.dtype == kF64)
        combine_group<double>(c, g, seg_ends, red);
    }
  }
}

__global__ void finalize_kernel(SegCols cols, long long n,
                                const int32_t* __restrict__ num_groups) {
  const int32_t ng = num_groups[0];
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    const bool live = s < ng;
    for (int k = 0; k < cols.n; ++k) {
      const SrtSegCol& c = cols.c[k];
      if (c.op == kCount) {
        c.out_valid[s] = 1;
        if (!live) static_cast<long long*>(c.out)[s] = 0;
        continue;
      }
      if (is_select(c.op)) {
        const int32_t r = static_cast<const int32_t*>(c.acc)[s];
        const bool has = live && r >= 0 && r < n;
        c.out_valid[s] = has ? c.valid[r] : 0;
        switch (c.dtype) {
          case 1: static_cast<uint8_t*>(c.out)[s] = has ? static_cast<const uint8_t*>(c.data)[r] : 0; break;
          case 2: static_cast<uint16_t*>(c.out)[s] = has ? static_cast<const uint16_t*>(c.data)[r] : 0; break;
          case 4: static_cast<uint32_t*>(c.out)[s] = has ? static_cast<const uint32_t*>(c.data)[r] : 0u; break;
          default: static_cast<unsigned long long*>(c.out)[s] = has ? static_cast<const unsigned long long*>(c.data)[r] : 0ull; break;
        }
        continue;
      }
      const bool v = live && c.nonnull[s] > 0;
      c.out_valid[s] = v ? 1 : 0;
      if (c.op == kSum) {
        if (c.dtype == kF32) { float* o = static_cast<float*>(c.out); if (!v) o[s] = 0.0f; }
        else if (c.dtype == kF64) { double* o = static_cast<double*>(c.out); if (!v) o[s] = 0.0; }
        else { long long* o = static_cast<long long*>(c.out); if (!v) o[s] = 0; }
        continue;
      }
      switch (c.dtype) {
        case kI32: static_cast<int32_t*>(c.out)[s] = v ? static_cast<const int32_t*>(c.acc)[s] : 0; break;
        case kI64: static_cast<long long*>(c.out)[s] = v ? static_cast<const long long*>(c.acc)[s] : 0; break;
        case kBool: static_cast<uint8_t*>(c.out)[s] = v && static_cast<const int32_t*>(c.acc)[s] != 0; break;
        case kF32: static_cast<float*>(c.out)[s] = v ? f32_from_order_bits(static_cast<const uint32_t*>(c.acc)[s]) : 0.0f; break;
        default: static_cast<double*>(c.out)[s] = v ? f64_from_order_bits(static_cast<const unsigned long long*>(c.acc)[s]) : 0.0; break;
      }
    }
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API int srt_segment_reduce_chunk() { return kChunk; }

SRT_API int srt_segment_reduce_max_cols() { return kMaxCols; }

// cols: host array of n_cols descriptors; n: capacity (rows = group slots).
// The caller initializes acc to each op's identity (first: INT32_MAX,
// last: -1), nonnull to 0, and for float sums out to 0; out may alias acc
// for counts, integer sums and integer min/max.
SRT_API int srt_segment_reduce(const SrtSegCol* cols, int n_cols, long long n,
                               const int32_t* order, const int32_t* gid_sorted,
                               const int32_t* seg_ends,
                               const int32_t* num_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_cols <= 0) return 0;
  if (n_cols > kMaxCols || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  SegCols sc;
  sc.n = n_cols;
  bool float_sum = false;
  for (int k = 0; k < n_cols; ++k) {
    sc.c[k] = cols[k];
    float_sum |= cols[k].op == kSum && (cols[k].dtype == kF32 || cols[k].dtype == kF64);
  }
  const long long chunks = ceil_div(n, kChunk);
  reduce_kernel<<<(unsigned)ceil_div(chunks, kThreads), kThreads, 0, st>>>(
      sc, n, order, gid_sorted);
  SRT_LAUNCHED("reduce_kernel");
  if (float_sum) {
    const unsigned grid = (unsigned)std::min<long long>(n, 2048);
    combine_kernel<<<grid, kCombineThreads, 0, st>>>(sc, seg_ends, num_groups);
    SRT_LAUNCHED("combine_kernel");
  }
  const unsigned fgrid = (unsigned)std::min<long long>(ceil_div(n, kThreads), 8192);
  finalize_kernel<<<fgrid, kThreads, 0, st>>>(sc, n, num_groups);
  SRT_LAUNCHED("finalize_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
