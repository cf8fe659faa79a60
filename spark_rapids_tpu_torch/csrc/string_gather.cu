// K7 gather_strings: rows of a STRING column by index — the string half of
// every gather (sort output, group keys at their representative rows,
// routed exchange pieces, concat and compaction).
//
// Replaces spark_rapids_tpu/columnar/batch.py:_gather_string_plan_cap /
// _gather_string_plan_traced (the plan) and _gather_string_bytes (the byte
// copy), and with them shuffle/exchange.py:_routed_string_plan and
// _routed_string_bytes. Output lane j takes source row idx[j] when j is
// below out_rows, idx_valid[j] holds (when given) and idx[j] is a source
// row; any other lane is NULL with length 0. Lengths come from the source
// offsets, validity from the source validity, as in the reference.
//
// Two launches:
// - plan: one thread per output lane writes its length, then the shared
//   device-wide exclusive scan of common.cuh turns lengths into the new
//   offsets [out_cap + 1] (the last one is the byte total);
// - copy: one warp per output row copies its bytes, lanes of the warp on
//   neighbouring bytes.
// The caller sizes the output byte buffer from a host-known bound (or reads
// the total back once); the copy never writes past byte_cap.
//
// Bound: memory. It reads the indices, two offsets and one validity flag a
// lane and the gathered bytes once, and writes the new offsets, validity
// and bytes once.
//
// The span entry (srt_gather_spans_plan / _copy) takes each row's (start,
// length) into one source buffer directly: the rows of a PLAIN BYTE_ARRAY
// Parquet page, whose values lie length-prefixed in the chunk and are not
// laid out by offsets (it replaces the reference's build_from_plan call of
// io/parquet_device.py:decode_chunk_device :1397). Starts are 64-bit: a
// chunk may pass 2 GiB of bit offsets and approach it in bytes.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__global__ void gather_plan_kernel(const int32_t* __restrict__ src_offsets,
                                   const uint8_t* __restrict__ src_valid,
                                   long long n_src,
                                   const int32_t* __restrict__ idx,
                                   const uint8_t* __restrict__ idx_valid,
                                   long long out_rows, long long out_cap,
                                   uint32_t* __restrict__ lens,
                                   uint8_t* __restrict__ out_valid) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j <= out_cap; j += (long long)gridDim.x * blockDim.x) {
    if (j == out_cap) {
      lens[j] = 0u;
      continue;
    }
    const int32_t r = idx[j];
    const bool ok = j < out_rows && r >= 0 && r < n_src &&
                    (idx_valid == nullptr || idx_valid[j] != 0);
    lens[j] = ok ? (uint32_t)(src_offsets[r + 1] - src_offsets[r]) : 0u;
    out_valid[j] = ok && src_valid[r] != 0 ? 1 : 0;
  }
}

__global__ void gather_copy_kernel(const int32_t* __restrict__ src_offsets,
                                   const uint8_t* __restrict__ src_bytes,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ out_offsets,
                                   long long out_cap,
                                   uint8_t* __restrict__ out_bytes,
                                   long long byte_cap) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       j < out_cap; j += warps) {
    const long long dst = out_offsets[j];
    const long long len = (long long)out_offsets[j + 1] - dst;
    if (len <= 0) continue;
    const long long src = src_offsets[idx[j]];
    for (long long k = lane; k < len && dst + k < byte_cap; k += 32)
      out_bytes[dst + k] = src_bytes[src + k];
  }
}

__global__ void spans_plan_kernel(const int32_t* __restrict__ lens,
                                  const uint8_t* __restrict__ valid,
                                  long long out_rows, long long out_cap,
                                  uint32_t* __restrict__ out_lens,
                                  uint8_t* __restrict__ out_valid) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j <= out_cap; j += (long long)gridDim.x * blockDim.x) {
    if (j == out_cap) {
      out_lens[j] = 0u;
      continue;
    }
    const bool ok = j < out_rows && valid[j] != 0 && lens[j] >= 0;
    out_lens[j] = ok ? (uint32_t)lens[j] : 0u;
    out_valid[j] = ok ? 1 : 0;
  }
}

__global__ void spans_copy_kernel(const uint8_t* __restrict__ src_bytes,
                                  long long n_src,
                                  const long long* __restrict__ starts,
                                  const int32_t* __restrict__ out_offsets,
                                  long long out_cap,
                                  uint8_t* __restrict__ out_bytes,
                                  long long byte_cap) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       j < out_cap; j += warps) {
    const long long dst = out_offsets[j];
    const long long len = (long long)out_offsets[j + 1] - dst;
    if (len <= 0) continue;
    const long long src = starts[j];
    for (long long k = lane; k < len && dst + k < byte_cap; k += 32)
      out_bytes[dst + k] =
          src + k >= 0 && src + k < n_src ? src_bytes[src + k] : 0;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch the plan over out_cap lanes needs
SRT_API size_t srt_gather_strings_scratch_bytes(long long out_cap) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(out_cap + 1);
  c.take<uint32_t>(scan_scratch_elems(out_cap + 1));
  return c.used;
}

// src_offsets: int32 [n_src + 1]; src_valid: bool [n_src]; idx: int32
// [out_cap]; idx_valid: bool [out_cap] or null; out_offsets: int32
// [out_cap + 1]; out_valid: bool [out_cap].
SRT_API int srt_gather_strings_plan(const int32_t* src_offsets,
                                    const uint8_t* src_valid, long long n_src,
                                    const int32_t* idx,
                                    const uint8_t* idx_valid,
                                    long long out_rows, long long out_cap,
                                    int32_t* out_offsets, uint8_t* out_valid,
                                    void* scratch, size_t scratch_bytes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) {
    SRT_CALL(cudaMemsetAsync(out_offsets, 0, sizeof(int32_t), st),
             "memset offsets");
    return 0;
  }
  if (out_cap >= 0x7FFFFFFFLL ||
      scratch_bytes < srt_gather_strings_scratch_bytes(out_cap))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* lens = c.take<uint32_t>(out_cap + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(out_cap + 1));
  const long long blocks =
      std::min<long long>(ceil_div(out_cap + 1, kThreads), 65536);
  gather_plan_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      src_offsets, src_valid, n_src, idx, idx_valid, out_rows, out_cap, lens,
      out_valid);
  SRT_LAUNCHED("gather_plan_kernel");
  SRT_TRY(scan_u32(lens, reinterpret_cast<uint32_t*>(out_offsets),
                   out_cap + 1, scan_scratch, nullptr, false, st));
  return 0;
}

// out_offsets from srt_gather_strings_plan; out_bytes: uint8 [byte_cap].
SRT_API int srt_gather_strings_copy(const int32_t* src_offsets,
                                    const uint8_t* src_bytes,
                                    const int32_t* idx,
                                    const int32_t* out_offsets,
                                    long long out_cap, uint8_t* out_bytes,
                                    long long byte_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) return 0;
  const long long blocks =
      std::min<long long>(ceil_div(out_cap * 32, kThreads), 65536);
  gather_copy_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      src_offsets, src_bytes, idx, out_offsets, out_cap, out_bytes, byte_cap);
  SRT_LAUNCHED("gather_copy_kernel");
  return 0;
}

// Span entry, plan: lens int32 [out_cap] and valid bool [out_cap] of the
// rows; a row at or past out_rows, not valid or of negative length is NULL
// with length 0. out_offsets int32 [out_cap + 1], out_valid bool [out_cap];
// scratch as srt_gather_strings_scratch_bytes(out_cap).
SRT_API int srt_gather_spans_plan(const int32_t* lens, const uint8_t* valid,
                                  long long out_rows, long long out_cap,
                                  int32_t* out_offsets, uint8_t* out_valid,
                                  void* scratch, size_t scratch_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) {
    SRT_CALL(cudaMemsetAsync(out_offsets, 0, sizeof(int32_t), st),
             "memset offsets");
    return 0;
  }
  if (out_cap >= 0x7FFFFFFFLL ||
      scratch_bytes < srt_gather_strings_scratch_bytes(out_cap))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* row_lens = c.take<uint32_t>(out_cap + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(out_cap + 1));
  const long long blocks =
      std::min<long long>(ceil_div(out_cap + 1, kThreads), 65536);
  spans_plan_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      lens, valid, out_rows, out_cap, row_lens, out_valid);
  SRT_LAUNCHED("spans_plan_kernel");
  SRT_TRY(scan_u32(row_lens, reinterpret_cast<uint32_t*>(out_offsets),
                   out_cap + 1, scan_scratch, nullptr, false, st));
  return 0;
}

// Span entry, copy: src uint8 [n_src]; starts int64 [out_cap] (a row's
// first byte in src); out_offsets from srt_gather_spans_plan; out_bytes
// uint8 [byte_cap]. Bytes past the source read as 0.
SRT_API int srt_gather_spans_copy(const uint8_t* src, long long n_src,
                                  const long long* starts,
                                  const int32_t* out_offsets,
                                  long long out_cap, uint8_t* out_bytes,
                                  long long byte_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_cap <= 0) return 0;
  const long long blocks =
      std::min<long long>(ceil_div(out_cap * 32, kThreads), 65536);
  spans_copy_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      src, n_src, starts, out_offsets, out_cap, out_bytes, byte_cap);
  SRT_LAUNCHED("spans_copy_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
