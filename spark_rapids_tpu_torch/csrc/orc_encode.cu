// K29 orc_encode_direct: the device half of an ORC write's integer
// streams (io/orc_encode_device.py). One call turns a column into its
// whole RLEv2 DATA (or LENGTH) stream, run headers included, and its
// PRESENT bits; the host only frames the PRESENT bytes, block-compresses
// streams and writes the protobuf metadata.
//
// Replaces spark_rapids_tpu/io/orc_encode_device.py:_compact_zigzag
// (:130), _bitpack_be (:146) and _lens_u64 (:234), and the host loop of
// _direct_stream (:185) that interleaved a 2-byte DIRECT header with every
// 512-value run (some 117k runs a lineitem column at SF 10). A row is live
// when it is below num_rows and valid; live values are compacted stably
// (a flag scan, as K22), zigzag-encoded when signed, and their largest
// value picks one width for the column from the reference's set (1, 2,
// 4, 8, 16, 24, 32, 40, 48, 56, 64). Since those widths make every full
// run the same size (2 + 64 * width bytes), each output byte knows its run
// and its place in it: one thread a byte, which also keeps widths below 8
// (several values to a byte) free of races. counts: live rows, width,
// stream bytes. The bytes equal the reference's.
//
// Bound: memory. Each row's flag and value are read once, the compacted
// values written and read once, the stream written once.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

constexpr int kRun = 512;

__device__ __forceinline__ int pick_width(unsigned long long max_u, int* code) {
  const int need = max_u ? 64 - __clzll((long long)max_u) : 1;
  const int widths[11] = {1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64};
  const int codes[11] = {0, 1, 3, 7, 15, 23, 27, 28, 29, 30, 31};
  for (int i = 0; i < 11; ++i)
    if (widths[i] >= need) {
      *code = codes[i];
      return widths[i];
    }
  *code = 31;
  return 64;
}

__global__ void direct_flags_kernel(const uint8_t* __restrict__ validity,
                                    long long num_rows, long long cap,
                                    uint32_t* __restrict__ flags) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x)
    flags[j] = j < num_rows && (validity == nullptr || validity[j]) ? 1u : 0u;
}

__global__ void compact_kernel(const uint8_t* __restrict__ data, int w_in,
                               int is_signed,
                               const uint32_t* __restrict__ flags,
                               const uint32_t* __restrict__ slots,
                               long long cap,
                               unsigned long long* __restrict__ dense,
                               unsigned long long* __restrict__ max_u) {
  unsigned long long local = 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x) {
    if (!flags[j]) continue;
    long long v;
    if (w_in == 8)
      v = reinterpret_cast<const long long*>(data)[j];
    else if (w_in == 4)
      v = reinterpret_cast<const int32_t*>(data)[j];
    else
      v = reinterpret_cast<const int16_t*>(data)[j];
    const unsigned long long u =
        is_signed ? ((unsigned long long)v << 1) ^ (unsigned long long)(v >> 63)
                  : (unsigned long long)v;
    dense[slots[j]] = u;
    local = u > local ? u : local;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, local, off);
    local = o > local ? o : local;
  }
  if ((threadIdx.x & 31) == 0 && local) atomicMax(max_u, local);
}

// PRESENT bytes: bit 7 - k of byte b is flags[8b + k]
__global__ void present_bits_kernel(const uint32_t* __restrict__ flags,
                                    long long cap, uint8_t* __restrict__ out) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < cap / 8; b += (long long)gridDim.x * blockDim.x) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (flags[8 * b + k]) v |= 1u << (7 - k);
    out[b] = (uint8_t)v;
  }
}

__global__ void direct_counts_kernel(const uint32_t* __restrict__ flags,
                                     const uint32_t* __restrict__ slots,
                                     long long cap,
                                     const unsigned long long* __restrict__ mx,
                                     long long* __restrict__ counts) {
  const long long n = (long long)slots[cap - 1] + flags[cap - 1];
  int code = 0;
  const int w = pick_width(*mx, &code);
  const long long full = n / kRun, rem = n % kRun;
  counts[0] = n;
  counts[1] = w;
  counts[2] = full * (2 + kRun / 8 * (long long)w) +
              (rem ? 2 + (rem * w + 7) / 8 : 0);
}

__global__ void direct_pack_kernel(const unsigned long long* __restrict__ dense,
                                   const long long* __restrict__ counts,
                                   uint8_t* __restrict__ out) {
  const long long n = counts[0];
  const int w = (int)counts[1];
  const long long total = counts[2];
  int code = 0;
  pick_width(w == 64 ? ~0ull : (1ull << w) - 1, &code);
  const long long run_bytes = 2 + kRun / 8 * (long long)w;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / run_bytes;
    const long long off = i - r * run_bytes;
    const long long len = min((long long)kRun, n - r * kRun);
    const unsigned long long* u = dense + r * kRun;
    uint32_t byte;
    if (off == 0) {
      byte = 0x40u | ((uint32_t)code << 1) | (uint32_t)((len - 1) >> 8);
    } else if (off == 1) {
      byte = (uint32_t)((len - 1) & 0xFF);
    } else {
      const long long p = off - 2;
      if (w >= 8) {
        const long long k = p * 8 / w;
        const int bi = (int)((p * 8 % w) / 8);
        byte = (uint32_t)((u[k] >> (w - 8 - 8 * bi)) & 0xFF);
      } else {
        const int per = 8 / w;
        const unsigned long long mask = (1ull << w) - 1;
        byte = 0;
        for (int t = 0; t < per; ++t) {
          const long long k = p * per + t;
          if (k < len) byte |= (uint32_t)(u[k] & mask) << (8 - w * (t + 1));
        }
      }
    }
    out[i] = (uint8_t)byte;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch an encode of cap rows needs
SRT_API size_t srt_orc_direct_scratch_bytes(long long cap) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(cap);
  c.take<uint32_t>(cap);
  c.take<uint32_t>(scan_scratch_elems(cap));
  c.take<unsigned long long>(cap);
  c.take<unsigned long long>(1);
  return c.used;
}

// data: cap values of w_in (2, 4, 8) bytes, sign-extended; validity: bool
// [cap] or null (every row valid); is_signed: zigzag (DATA) or not
// (LENGTH); out: uint8 [out_cap] (8 * cap + 2 * ceil(cap / 512) bytes
// always suffice); present: uint8 [cap / 8]; counts: int64 [3]. cap is a
// positive multiple of 8.
SRT_API int srt_orc_encode_direct(const uint8_t* data, int w_in,
                                  int is_signed, const uint8_t* validity,
                                  long long num_rows, long long cap,
                                  uint8_t* out, long long out_cap,
                                  uint8_t* present, long long* counts,
                                  void* scratch, size_t scratch_bytes,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap % 8 != 0 || cap >= 0xFFFFFFFFLL ||
      (w_in != 2 && w_in != 4 && w_in != 8) ||
      out_cap < 8 * cap + 2 * ceil_div(cap, kRun) ||
      scratch_bytes < srt_orc_direct_scratch_bytes(cap))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* flags = c.take<uint32_t>(cap);
  uint32_t* slots = c.take<uint32_t>(cap);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(cap));
  auto* dense = c.take<unsigned long long>(cap);
  auto* max_u = c.take<unsigned long long>(1);
  SRT_CALL(cudaMemsetAsync(max_u, 0, sizeof(unsigned long long), st),
           "memset");
  direct_flags_kernel<<<grid_for(cap), kThreads, 0, st>>>(validity, num_rows,
                                                          cap, flags);
  SRT_LAUNCHED("direct_flags_kernel");
  SRT_TRY(scan_u32(flags, slots, cap, scan_scratch, nullptr, false, st));
  compact_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      data, w_in, is_signed, flags, slots, cap, dense, max_u);
  SRT_LAUNCHED("compact_kernel");
  present_bits_kernel<<<grid_for(cap / 8), kThreads, 0, st>>>(flags, cap,
                                                              present);
  SRT_LAUNCHED("present_bits_kernel");
  direct_counts_kernel<<<1, 1, 0, st>>>(flags, slots, cap, max_u, counts);
  SRT_LAUNCHED("direct_counts_kernel");
  direct_pack_kernel<<<grid_for(out_cap), kThreads, 0, st>>>(dense, counts,
                                                             out);
  SRT_LAUNCHED("direct_pack_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
