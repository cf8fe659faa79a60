// K22 encode_plain_page: the device half of a Parquet write. One call per
// column of a batch turns the column into the payload of one PLAIN v1 data
// page; the host only wraps payloads in page headers, block-compresses them
// and writes the footer (io/parquet_encode_device.py).
//
// Replaces spark_rapids_tpu/io/parquet_encode_device.py:_encode_fixed
// (:116), _pack_validity_bits (:229), _encode_string_plan (:133) and
// _encode_string_bytes (:153). A row is live when it is below num_rows and
// valid. Every entry writes:
// - the live rows' values, compacted stably to the front: w bytes each for
//   fixed-width columns; bit-packed LSB-first for BOOLEAN (PLAIN booleans);
//   for STRING a 4-byte little-endian length and the bytes of each live
//   row, in a plan pass (piece lengths, the shared exclusive scan of
//   common.cuh) and a copy pass (one warp a row);
// - the live flags packed LSB-first, 8 rows a byte (the v1 definition
//   levels' one bit-packed run);
// - counts[0] = live rows, counts[1] = bytes of values written.
// The reference compacts with a stable argsort of ~live; a flag scan gives
// the same order in linear work.
//
// ORC mode (orc = 1; io/orc_encode_device.py, counted as orc_pack_present):
// the same compaction with ORC's layouts, replacing the reference's
// orc_encode_device.py:_pack_present (:162) and _compact_fixed (:225):
// bits pack MSB first (PRESENT bytes, BOOLEAN values) and STRING values
// carry no length prefix (the DATA stream; their lengths go to K29).
//
// Bound: memory. Each row's flag and value are read once and the compacted
// values and packed bits written once; the scan adds 8 bytes a row.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

__global__ void live_flags_kernel(const uint8_t* __restrict__ validity,
                                  long long num_rows, long long cap,
                                  const int32_t* __restrict__ offsets,
                                  uint32_t* __restrict__ flags,
                                  uint32_t* __restrict__ pieces,
                                  uint32_t prefix) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j <= cap; j += (long long)gridDim.x * blockDim.x) {
    const bool live = j < cap && j < num_rows && validity[j] != 0;
    if (j < cap) flags[j] = live ? 1u : 0u;
    if (pieces != nullptr)
      pieces[j] =
          live ? (uint32_t)(offsets[j + 1] - offsets[j]) + prefix : 0u;
  }
}

__global__ void scatter_fixed_kernel(const uint8_t* __restrict__ data,
                                     const uint32_t* __restrict__ flags,
                                     const uint32_t* __restrict__ slots,
                                     long long cap, int w, int as_bool,
                                     uint8_t* __restrict__ dense) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x) {
    if (!flags[j]) continue;
    const long long s = slots[j];
    if (as_bool) {
      dense[s] = data[j] != 0 ? 1 : 0;
    } else {
      const uint8_t* src = data + j * w;
      uint8_t* dst = dense + s * w;
      for (int k = 0; k < w; ++k) dst[k] = src[k];
    }
  }
}

// byte b of out: bit k (bit 7 - k when msb) is in[8b + k] != 0, for
// 8b + k below n (n read from n_dev when given)
__global__ void pack_bits_u32_kernel(const uint32_t* __restrict__ in,
                                     long long n, long long n_bytes,
                                     uint8_t* __restrict__ out, int msb) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < n_bytes; b += (long long)gridDim.x * blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 8; ++k) {
      const long long i = 8 * b + k;
      if (i < n && in[i]) v |= 1u << (msb ? 7 - k : k);
    }
    out[b] = (uint8_t)v;
  }
}

__global__ void pack_bits_u8_kernel(const uint8_t* __restrict__ in,
                                    const long long* __restrict__ n_dev,
                                    long long n_bytes,
                                    uint8_t* __restrict__ out, int msb) {
  const long long n = *n_dev;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < n_bytes; b += (long long)gridDim.x * blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 8; ++k) {
      const long long i = 8 * b + k;
      if (i < n && in[i]) v |= 1u << (msb ? 7 - k : k);
    }
    out[b] = (uint8_t)v;
  }
}

__global__ void counts_kernel(const uint32_t* __restrict__ flags,
                              const uint32_t* __restrict__ slots,
                              long long cap, int w, int as_bool,
                              const uint32_t* __restrict__ byte_total,
                              long long* __restrict__ counts) {
  const long long n = cap > 0 ? (long long)slots[cap - 1] + flags[cap - 1] : 0;
  counts[0] = n;
  if (byte_total != nullptr)
    counts[1] = (long long)*byte_total;
  else
    counts[1] = as_bool ? (n + 7) / 8 : n * w;
}

__global__ void string_copy_kernel(const int32_t* __restrict__ offsets,
                                   const uint8_t* __restrict__ data,
                                   const uint32_t* __restrict__ flags,
                                   const uint32_t* __restrict__ out_off,
                                   long long cap, uint8_t* __restrict__ out,
                                   long long byte_cap, int prefix) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       j < cap; j += warps) {
    if (!flags[j]) continue;
    const long long dst = out_off[j];
    const long long src = offsets[j];
    const long long len = (long long)offsets[j + 1] - src;
    if (lane < prefix && dst + lane < byte_cap)
      out[dst + lane] = (uint8_t)((uint32_t)len >> (8 * lane));
    for (long long k = lane; k < len && dst + prefix + k < byte_cap; k += 32)
      out[dst + prefix + k] = data[src + k];
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch an encode of cap rows needs (either entry)
SRT_API size_t srt_encode_scratch_bytes(long long cap) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(cap + 1);
  c.take<uint32_t>(cap + 1);
  c.take<uint32_t>(cap + 1);
  c.take<uint32_t>(scan_scratch_elems(cap + 1));
  c.take<uint8_t>(cap);
  return c.used;
}

// Fixed-width and BOOLEAN columns. data: cap values of w bytes (BOOLEAN:
// one byte each, as_bool = 1); validity: bool [cap]; dense: uint8 [cap * w]
// (BOOLEAN: [cap / 8] packed value bits); packed_valid: uint8 [cap / 8];
// counts: int64 [2]. cap is a multiple of 8. orc: MSB-first bits.
SRT_API int srt_encode_plain_page(const uint8_t* data, const uint8_t* validity,
                                  long long num_rows, long long cap, int w,
                                  int as_bool, int orc, uint8_t* dense,
                                  uint8_t* packed_valid, long long* counts,
                                  void* scratch, size_t scratch_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap % 8 != 0 || cap >= 0xFFFFFFFFLL || w < 1 || w > 8 ||
      scratch_bytes < srt_encode_scratch_bytes(cap))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* flags = c.take<uint32_t>(cap + 1);
  uint32_t* slots = c.take<uint32_t>(cap + 1);
  c.take<uint32_t>(cap + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(cap + 1));
  uint8_t* bool_dense = c.take<uint8_t>(cap);
  live_flags_kernel<<<grid_for(cap + 1), kThreads, 0, st>>>(
      validity, num_rows, cap, nullptr, flags, nullptr, 0u);
  SRT_LAUNCHED("live_flags_kernel");
  SRT_TRY(scan_u32(flags, slots, cap, scan_scratch, nullptr, false, st));
  scatter_fixed_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      data, flags, slots, cap, w, as_bool, as_bool ? bool_dense : dense);
  SRT_LAUNCHED("scatter_fixed_kernel");
  pack_bits_u32_kernel<<<grid_for(cap / 8), kThreads, 0, st>>>(
      flags, cap, cap / 8, packed_valid, orc);
  SRT_LAUNCHED("pack_bits_u32_kernel");
  counts_kernel<<<1, 1, 0, st>>>(flags, slots, cap, w, as_bool, nullptr,
                                 counts);
  SRT_LAUNCHED("counts_kernel");
  if (as_bool) {
    pack_bits_u8_kernel<<<grid_for(cap / 8), kThreads, 0, st>>>(
        bool_dense, counts, cap / 8, dense, orc);
    SRT_LAUNCHED("pack_bits_u8_kernel");
  }
  return 0;
}

// STRING columns. offsets int32 [cap + 1], data uint8, validity bool [cap];
// out: uint8 [byte_cap] (at least the live bytes plus 4 a live row);
// packed_valid: uint8 [cap / 8]; counts: int64 [2]. orc: no length
// prefixes, MSB-first bits.
SRT_API int srt_encode_string_page(const int32_t* offsets, const uint8_t* data,
                                   const uint8_t* validity,
                                   long long num_rows, long long cap, int orc,
                                   uint8_t* out, long long byte_cap,
                                   uint8_t* packed_valid, long long* counts,
                                   void* scratch, size_t scratch_bytes,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap % 8 != 0 || cap >= 0x7FFFFFFFLL ||
      scratch_bytes < srt_encode_scratch_bytes(cap))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* flags = c.take<uint32_t>(cap + 1);
  uint32_t* slots = c.take<uint32_t>(cap + 1);
  uint32_t* pieces = c.take<uint32_t>(cap + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(cap + 1));
  uint32_t* out_off = slots;  // the piece scan; row counts use flags
  live_flags_kernel<<<grid_for(cap + 1), kThreads, 0, st>>>(
      validity, num_rows, cap, offsets, flags, pieces, orc ? 0u : 4u);
  SRT_LAUNCHED("live_flags_kernel");
  SRT_TRY(scan_u32(pieces, out_off, cap + 1, scan_scratch, nullptr, false,
                   st));
  const long long blocks =
      std::min<long long>(ceil_div(cap * 32, kThreads), 65536);
  string_copy_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      offsets, data, flags, out_off, cap, out, byte_cap, orc ? 0 : 4);
  SRT_LAUNCHED("string_copy_kernel");
  pack_bits_u32_kernel<<<grid_for(cap / 8), kThreads, 0, st>>>(
      flags, cap, cap / 8, packed_valid, orc);
  SRT_LAUNCHED("pack_bits_u32_kernel");
  // live rows: the flags scanned into `pieces` (free after the copy)
  SRT_TRY(scan_u32(flags, pieces, cap, scan_scratch, nullptr, false, st));
  counts_kernel<<<1, 1, 0, st>>>(flags, pieces, cap, 0, 0, out_off + cap,
                                 counts);
  SRT_LAUNCHED("counts_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
