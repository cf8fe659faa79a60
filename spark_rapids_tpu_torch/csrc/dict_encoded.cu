// K23 dict_materialize and K24 remap_codes: the row-level kernels of the
// encoded (dictionary) columns of columnar/encoded.py. An encoded column is
// int32 codes [cap] plus validity into one shared dictionary; these kernels
// are the gathers through that dictionary.
//
// K23, fixed mode, replaces spark_rapids_tpu/columnar/encoded.py:
// _materialize_fixed_kernel (:602): out[j] = vals[clip(code[j])] for a
// valid row, 0 under NULL; the value table holds 4- or 8-byte values (DATE,
// INT64, TIMESTAMP dictionaries).
//
// K23, string mode, replaces _materialize_total (:608) and
// _materialize_kernel (:614): this kernel writes each row's (start, length)
// in the dictionary's byte table by code (length 0 under NULL); the caller
// sizes the output (one total read only when the host bound is too loose)
// and K7's span entry (string_gather.cu) scans the lengths into offsets and
// copies the bytes.
//
// K24 replaces _remap_kernel (:707) and _remap_join_kernel (:841): out[j] =
// remap[clip(code[j])] for a valid row and `fill` under NULL (0 for a
// re-encode, which keeps the zeros-under-null rule; -1 for a join key,
// which matches no build code).
//
// Codes are clipped into [0, ndv - 1] as the reference clips them, so a
// corrupt code past the table reads its last entry, never past it. An empty
// table gives 0 (K23) or `fill` (K24).
//
// Bound: memory. One thread a row reads a code, a validity byte and one
// table entry (the table is small and stays in L2) and writes the value:
// K23 fixed 5 + w bytes a row, K23 spans 17, K24 9.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__device__ __forceinline__ long long clip_code(int32_t c, long long n) {
  return c < 0 ? 0 : (c >= n ? n - 1 : (long long)c);
}

template <typename T>
__global__ void materialize_fixed_kernel(const int32_t* __restrict__ codes,
                                         const uint8_t* __restrict__ valid,
                                         long long n,
                                         const T* __restrict__ vals,
                                         long long ndv, T* __restrict__ out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x)
    out[j] = valid[j] && ndv > 0 ? vals[clip_code(codes[j], ndv)] : T(0);
}

__global__ void materialize_spans_kernel(const int32_t* __restrict__ codes,
                                         const uint8_t* __restrict__ valid,
                                         long long n,
                                         const int32_t* __restrict__ offs,
                                         long long ndv,
                                         long long* __restrict__ starts,
                                         int32_t* __restrict__ lens) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    long long s = 0;
    int32_t len = 0;
    if (valid[j] && ndv > 0) {
      const long long c = clip_code(codes[j], ndv);
      s = offs[c];
      len = offs[c + 1] - offs[c];
    }
    starts[j] = s;
    lens[j] = len;
  }
}

__global__ void remap_codes_kernel(const int32_t* __restrict__ codes,
                                   const uint8_t* __restrict__ valid,
                                   long long n,
                                   const int32_t* __restrict__ remap,
                                   long long n_remap, int32_t fill,
                                   int32_t* __restrict__ out) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x)
    out[j] = valid[j] && n_remap > 0 ? remap[clip_code(codes[j], n_remap)]
                                     : fill;
}

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// codes int32 [n], valid bool [n]; vals: ndv values of `width` bytes (4 or
// 8); out: n values of `width` bytes.
SRT_API int srt_dict_materialize_fixed(const int32_t* codes,
                                       const uint8_t* valid, long long n,
                                       const void* vals, long long ndv,
                                       int width, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (ndv < 0 || (width != 4 && width != 8))
    return fail(cudaErrorInvalidValue, "arguments");
  if (width == 8)
    materialize_fixed_kernel<long long><<<grid_for(n), kThreads, 0, st>>>(
        codes, valid, n, static_cast<const long long*>(vals), ndv,
        static_cast<long long*>(out));
  else
    materialize_fixed_kernel<int32_t><<<grid_for(n), kThreads, 0, st>>>(
        codes, valid, n, static_cast<const int32_t*>(vals), ndv,
        static_cast<int32_t*>(out));
  SRT_LAUNCHED("materialize_fixed_kernel");
  return 0;
}

// offs: int32 [ndv + 1], the dictionary's byte offsets; starts int64 [n],
// lens int32 [n].
SRT_API int srt_dict_materialize_spans(const int32_t* codes,
                                       const uint8_t* valid, long long n,
                                       const int32_t* offs, long long ndv,
                                       long long* starts, int32_t* lens,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (ndv < 0) return fail(cudaErrorInvalidValue, "arguments");
  materialize_spans_kernel<<<grid_for(n), kThreads, 0, st>>>(
      codes, valid, n, offs, ndv, starts, lens);
  SRT_LAUNCHED("materialize_spans_kernel");
  return 0;
}

// remap int32 [n_remap]; out int32 [n].
SRT_API int srt_remap_codes(const int32_t* codes, const uint8_t* valid,
                            long long n, const int32_t* remap,
                            long long n_remap, int fill, int32_t* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n_remap < 0) return fail(cudaErrorInvalidValue, "arguments");
  remap_codes_kernel<<<grid_for(n), kThreads, 0, st>>>(
      codes, valid, n, remap, n_remap, (int32_t)fill, out);
  SRT_LAUNCHED("remap_codes_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
