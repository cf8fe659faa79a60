// K18 explode_rows: explode / posexplode of a created array in one launch.
//
// Replaces spark_rapids_tpu/exec/expand.py:_replicate_indices (:257) and
// _interleave_elems (:264), as TpuGenerateExec reaches them: output row
// r = i * k + j holds input row i's child columns and element j of its
// array, in Spark's row order.
//
// One thread per output lane r of the bucketed output capacity, with
// src = r / k and j = r % k in 64-bit index math. Driven by descriptor
// arrays (as K3 and K4 are), one launch writes:
// - every fixed child column (1, 2, 4 or 8 bytes a value) and its validity
//   from row src; a NULL lane's value is 0, as the reference's gather
//   writes it;
// - the element value and validity from element column j at row src;
// - pos = j (posexplode);
// - the int32 replicate index src, which the wrapper hands to K7 for the
//   STRING child columns.
// Lanes at or past n * k (the pads) are invalid and zero everywhere.
//
// Bound: memory. Each output byte is written once; the inputs are read k
// times each, but neighbouring threads read the same source row, so the
// reads hit L1 / L2 and device memory sees each input about once.
#include <algorithm>

#include "common.cuh"

// A child column: its source and output (mirrored by a ctypes.Structure).
struct SrtExplodeCol {
  const void* data;      // source values
  const uint8_t* valid;  // source validity
  void* out;             // output values
  uint8_t* out_valid;    // output validity
  int32_t width;         // bytes a value: 1, 2, 4 or 8
  int32_t pad;
};

// Element j of the array: a column evaluated over the input rows.
struct SrtExplodeElem {
  const void* data;
  const uint8_t* valid;
};

namespace srt {
namespace {

constexpr int kMaxChildCols = 32;
constexpr int kMaxElems = 64;

struct ExplodeArgs {
  SrtExplodeCol child[kMaxChildCols];
  SrtExplodeElem elem[kMaxElems];
  int n_child;
  int k;               // elements a row
  int elem_width;      // 0: no element columns in this launch
  long long n_out;     // n * k live output rows
  void* elem_out;
  uint8_t* elem_out_valid;
  int32_t* pos_out;    // nullable
  int32_t* rep_out;    // nullable
};

__device__ __forceinline__ void copy_value(const void* src, long long si,
                                           void* dst, long long di, int width,
                                           bool keep) {
  switch (width) {
    case 1:
      static_cast<uint8_t*>(dst)[di] =
          keep ? static_cast<const uint8_t*>(src)[si] : (uint8_t)0;
      break;
    case 2:
      static_cast<uint16_t*>(dst)[di] =
          keep ? static_cast<const uint16_t*>(src)[si] : (uint16_t)0;
      break;
    case 4:
      static_cast<uint32_t*>(dst)[di] =
          keep ? static_cast<const uint32_t*>(src)[si] : 0u;
      break;
    default:
      static_cast<unsigned long long*>(dst)[di] =
          keep ? static_cast<const unsigned long long*>(src)[si] : 0ull;
      break;
  }
}

__global__ void explode_kernel(ExplodeArgs a, long long out_cap) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < out_cap; r += (long long)gridDim.x * blockDim.x) {
    const bool live = r < a.n_out;
    const long long src = live ? r / a.k : 0;
    const int j = live ? (int)(r % a.k) : 0;
    for (int c = 0; c < a.n_child; ++c) {
      const SrtExplodeCol& col = a.child[c];
      const bool v = live && col.valid[src] != 0;
      col.out_valid[r] = v ? 1 : 0;
      copy_value(col.data, src, col.out, r, col.width, v);
    }
    if (a.elem_width > 0) {
      const SrtExplodeElem& e = a.elem[j];
      const bool v = live && e.valid[src] != 0;
      a.elem_out_valid[r] = v ? 1 : 0;
      copy_value(e.data, src, a.elem_out, r, a.elem_width, v);
    }
    if (a.pos_out != nullptr) a.pos_out[r] = j;
    if (a.rep_out != nullptr) a.rep_out[r] = (int32_t)src;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API int srt_explode_max_child_cols() { return kMaxChildCols; }

SRT_API int srt_explode_max_elems() { return kMaxElems; }

// n: input rows; k: elements a row; out_cap: output lanes (>= n * k).
// child: n_child descriptors; elems: k descriptors (or none with
// elem_width 0); pos_out and rep_out may be null.
SRT_API int srt_explode_rows(const SrtExplodeCol* child, int n_child,
                             const SrtExplodeElem* elems, int k,
                             int elem_width, long long n, long long out_cap,
                             void* elem_out, uint8_t* elem_out_valid,
                             int32_t* pos_out, int32_t* rep_out,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_child < 0 || n_child > kMaxChildCols || k < 1 || k > kMaxElems ||
      n < 0 || out_cap < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  // row indices are int32 downstream (K7, the replicate index): one batch
  // may not explode past 2^31 - 1 rows
  if (n * (long long)k > 0x7FFFFFFFLL || out_cap < n * (long long)k ||
      out_cap > 0x80000000LL)
    return fail(cudaErrorInvalidValue, "n * k past 2^31 - 1 rows");
  if (out_cap == 0) return 0;
  ExplodeArgs a;
  a.n_child = n_child;
  for (int c = 0; c < n_child; ++c) a.child[c] = child[c];
  a.k = k;
  a.elem_width = elem_width;
  if (elem_width > 0)
    for (int j = 0; j < k; ++j) a.elem[j] = elems[j];
  a.n_out = n * (long long)k;
  a.elem_out = elem_out;
  a.elem_out_valid = elem_out_valid;
  a.pos_out = pos_out;
  a.rep_out = rep_out;
  const unsigned grid =
      (unsigned)std::min<long long>(ceil_div(out_cap, kThreads), 65535LL * 8);
  explode_kernel<<<grid, kThreads, 0, st>>>(a, out_cap);
  SRT_LAUNCHED("explode_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
