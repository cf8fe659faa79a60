// K27 rlev2_expand and K28 present_expand: the device half of an ORC
// stripe's decode (io/orc_device.py). The host walks each stream's run
// headers (native/srt_io.cpp); these kernels produce every value from the
// stripe's bytes.
//
// K27 replaces spark_rapids_tpu/io/orc_device.py:_expand_rlev2 (:665),
// _extract_be_bits (:645) and the patch scatter-add of _expand_rt_dense
// (:983-986). The reference found each slot's run by a binary search over
// the whole [cap], took DELTA's within-run sums from a global cumsum, and
// ran the whole expansion once per distinct bit width, merging on the
// host. Here one launch takes every run of a stream: one warp a run (a
// run holds at most 512 values), each lane a value, whatever the run's
// kind and width (SHORT_REPEAT, DIRECT, DELTA, PATCHED_BASE; widths to 64
// from a 9-byte big-endian window). DELTA's packed deltas are summed by a
// warp scan inside the run, 32 at a time with a carry. A second launch
// adds PATCHED_BASE's patches (each to its own slot, no atomics).
//
// K28 replaces _expand_present (:714): one warp a byte-RLE run (at most
// 130 bytes), each lane a decoded byte, whose 8 bits it writes MSB first.
//
// Bound: memory. K27 reads each run's table entry and its packed bytes and
// writes 8 bytes a value; K28 reads its runs and literal bytes and writes
// a byte a bit. Short runs leave most of a warp idle (a SHORT_REPEAT run
// keeps 3-10 lanes busy), which a later version could pack.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

constexpr int kRunRepeat = 0, kRunDirect = 1, kRunDelta = 2,
              kRunPatched = 3;

inline unsigned warp_grid(long long items) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(items * 32, kThreads), 1 << 20));
}

// `w` bits (0-64; 0 reads 0) at absolute bit `pos` of buf, most
// significant first; bytes past n read as 0.
__device__ __forceinline__ uint64_t be_bits(const uint8_t* __restrict__ buf,
                                            long long n, long long pos,
                                            int w) {
  if (w == 0) return 0;
  const long long byte = pos >> 3;
  const int s = (int)(pos & 7);
  uint64_t hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long b = byte + i;
    hi = (hi << 8) | (b < n ? (uint64_t)buf[b] : 0ull);
  }
  const uint64_t lo = byte + 8 < n ? (uint64_t)buf[byte + 8] : 0ull;
  const uint64_t win = s ? (hi << s) | (lo >> (8 - s)) : hi;
  return w == 64 ? win : win >> (64 - w);
}

__global__ void rlev2_expand_kernel(
    const uint8_t* __restrict__ buf, long long n_buf,
    const int8_t* __restrict__ kind, const long long* __restrict__ out_start,
    const int32_t* __restrict__ count, const long long* __restrict__ base,
    const long long* __restrict__ delta0,
    const long long* __restrict__ bit_off, const int8_t* __restrict__ width,
    long long n_runs, int is_signed, unsigned long long* __restrict__ out,
    long long cap) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       r < n_runs; r += warps) {
    const long long first = out_start[r];
    const int n = count[r];
    const int kd = kind[r];
    const int w = width[r];
    const unsigned long long b = (unsigned long long)base[r];
    const long long boff = bit_off[r];
    if (kd == kRunDelta) {
      const unsigned long long d0 = (unsigned long long)delta0[r];
      if (w == 0) {
        for (int k = lane; k < n; k += 32)
          if (first + k < cap) out[first + k] = b + (unsigned long long)k * d0;
        continue;
      }
      const bool neg = delta0[r] < 0;
      unsigned long long carry = 0;
      for (int k0 = 0; k0 < n; k0 += 32) {
        const int k = k0 + lane;
        unsigned long long d =
            (k >= 2 && k < n) ? be_bits(buf, n_buf, boff + (long long)(k - 2) * w,
                                        w)
                              : 0ull;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, d, off);
          if (lane >= off) d += up;
        }
        const unsigned long long total = __shfl_sync(0xFFFFFFFFu, d, 31);
        const unsigned long long seg = carry + d;
        unsigned long long v = b;
        if (k >= 1) v += d0;
        if (k >= 2) v += neg ? (0ull - seg) : seg;
        if (k < n && first + k < cap) out[first + k] = v;
        carry += total;
      }
      continue;
    }
    for (int k = lane; k < n; k += 32) {
      if (first + k >= cap) break;
      unsigned long long v = b;
      if (kd == kRunDirect || kd == kRunPatched) {
        const unsigned long long u =
            be_bits(buf, n_buf, boff + (long long)k * w, w);
        if (kd == kRunPatched)
          v = b + u;
        else
          v = is_signed ? (u >> 1) ^ (0ull - (u & 1)) : u;
      }
      out[first + k] = v;
    }
  }
}

__global__ void zero_kernel(unsigned long long* __restrict__ out,
                            long long cap) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x)
    out[j] = 0;
}

__global__ void add_patches_kernel(const long long* __restrict__ pos,
                                   const long long* __restrict__ add,
                                   long long n, unsigned long long* out,
                                   long long cap) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = pos[i];
    if (p >= 0 && p < cap) out[p] += (unsigned long long)add[i];
  }
}

__global__ void present_expand_kernel(
    const uint8_t* __restrict__ buf, long long n_buf,
    const long long* __restrict__ out_start,
    const int32_t* __restrict__ count, const uint8_t* __restrict__ is_run,
    const uint8_t* __restrict__ value, const long long* __restrict__ lit_off,
    long long n_runs, uint8_t* __restrict__ out, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       r < n_runs; r += warps) {
    const long long first = out_start[r];
    const int n = count[r];
    for (int k = lane; k < n; k += 32) {
      const long long j0 = (first + k) * 8;
      if (j0 >= cap) break;
      uint32_t byte;
      if (is_run[r]) {
        byte = value[r];
      } else {
        const long long at = lit_off[r] + k;
        byte = at >= 0 && at < n_buf ? buf[at] : 0u;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (j0 + t < cap) out[j0 + t] = (uint8_t)((byte >> (7 - t)) & 1u);
    }
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// K27. buf uint8 [n_buf]: the stripe's uncompressed streams; the run
// table (n_runs entries, as native/srt_io.cpp:srt_parse_rlev2 gives it):
// kind int8, out_start int64, count int32, base int64, delta0 int64,
// bit_off int64 (absolute, into buf), width int8; patches: n_patches
// (slot int64, addend int64). out: int64 [cap]; slots no run covers are 0.
SRT_API int srt_rlev2_expand(const uint8_t* buf, long long n_buf,
                             const int8_t* kind, const long long* out_start,
                             const int32_t* count, const long long* base,
                             const long long* delta0,
                             const long long* bit_off, const int8_t* width,
                             long long n_runs, int is_signed,
                             const long long* patch_pos,
                             const long long* patch_add, long long n_patches,
                             long long* out, long long cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap < 0 || n_runs < 0 || n_patches < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  auto* o = reinterpret_cast<unsigned long long*>(out);
  zero_kernel<<<(unsigned)std::min<long long>(ceil_div(cap, kThreads), 65536),
                kThreads, 0, st>>>(o, cap);
  SRT_LAUNCHED("zero_kernel");
  if (n_runs > 0) {
    rlev2_expand_kernel<<<warp_grid(n_runs), kThreads, 0, st>>>(
        buf, n_buf, kind, out_start, count, base, delta0, bit_off, width,
        n_runs, is_signed, o, cap);
    SRT_LAUNCHED("rlev2_expand_kernel");
  }
  if (n_patches > 0) {
    add_patches_kernel<<<(unsigned)std::min<long long>(
                             ceil_div(n_patches, kThreads), 65536),
                         kThreads, 0, st>>>(patch_pos, patch_add, n_patches,
                                            o, cap);
    SRT_LAUNCHED("add_patches_kernel");
  }
  return 0;
}

// K28. The byte-RLE run table (n_runs entries): out_start int64 (in
// bytes), count int32, is_run uint8, value uint8, lit_off int64 (into buf).
// out: bool [cap], bit j = bit 7 - j % 8 of decoded byte j / 8; False past
// the runs.
SRT_API int srt_present_expand(const uint8_t* buf, long long n_buf,
                               const long long* out_start,
                               const int32_t* count, const uint8_t* is_run,
                               const uint8_t* value, const long long* lit_off,
                               long long n_runs, uint8_t* out, long long cap,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap < 0 || n_runs < 0) return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0) return 0;
  SRT_CALL(cudaMemsetAsync(out, 0, (size_t)cap, st), "memset");
  if (n_runs > 0) {
    present_expand_kernel<<<warp_grid(n_runs), kThreads, 0, st>>>(
        buf, n_buf, out_start, count, is_run, value, lit_off, n_runs, out,
        cap);
    SRT_LAUNCHED("present_expand_kernel");
  }
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
