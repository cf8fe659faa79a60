// K37-K40: the string transforms of a cleaning stage (B15's rest).
//
// - K37 string_case_map: ASCII upper / lower / initcap of every row byte.
//   Replaces spark_rapids_tpu/columnar/strings.py:upper_ascii (:270),
//   lower_ascii (:277) and initcap_ascii (:620).
// - K38 string_span_plan: each row's result span for TRIM / LTRIM / RTRIM
//   of 0x20 and for substring_index(delim, count), in K13's layout (row i
//   at spans[2i]:spans[2i + 1]); K7's span entry copies them. Replaces
//   the plans of trim_spaces (:397) and substring_index (:571).
// - K39 string_replace: every match of a literal needle replaced, left to
//   right (a count launch, a scan, a write launch). Replaces replace_literal
//   (:499, with _match_starts :484) and RegExpReplace's literal patterns
//   (ops/stringops.py:404).
// - K40 string_concat: concat (NULL when any piece is) and concat_ws
//   (never NULL; a separator before every non-NULL piece with a non-NULL
//   piece before it) over J sources given as a small device table, so no J
//   is compiled in (a plan launch, a scan, a copy launch). Replaces concat2
//   (:323) and concat_ws (:642).
//
// What each computes is the reference function's, not its XLA
// formulation: the reference compares every byte of the buffer with every
// needle byte and searches the offsets for every byte. Here a thread owns
// a row and walks its own bytes. The needles are one
// byte or borderless (the plan rewrite keeps the others on the CPU engine),
// so their matches never overlap and a scan that skips past each match
// finds the reference's matches and byte-order ranks; substring_index with
// count < 0 scans backward.
//
// Bound: memory on this card. K37 reads and writes each byte once
// (16 bytes a thread as one uint4 when both buffers are 16-byte aligned;
// initcap finds its first row by a binary search of the offsets, then
// walks forward). K38 reads the offsets and the row bytes and writes 9
// bytes a row; K39 reads the row bytes twice (count, write) and writes the
// output and 4 bytes a row; K40 reads the pieces and writes the output,
// its offsets and validity (the source table staged in shared memory).
// Rows of this path are short (4-25 bytes), so a thread a row keeps
// neighbouring threads on neighbouring bytes; a long row is walked by one
// thread, which is later work. A warp a row (K40's first copy) left 31
// lanes idle on 1-4 byte pieces: 8.76 ms for a 0.17 ms bound.
//
// K39 sizes its output from the exact total, so the wrapper reads one
// 64-bit total back a call (the reference's static bound is 5.3x the input
// for 'COD' -> 'CASH ON DELIVERY'). K40's output bound is the operands'
// (no host read).
#include <algorithm>

#include <cub/block/block_reduce.cuh>

#include "common.cuh"

namespace srt {
namespace {

enum { kUpper = 0, kLower = 1, kInitcap = 2 };
enum { kTrimBoth = 0, kTrimLeft = 1, kTrimRight = 2, kIndex = 3 };

__device__ __forceinline__ bool is_lower(uint8_t b) {
  return b >= 'a' && b <= 'z';
}
__device__ __forceinline__ bool is_upper(uint8_t b) {
  return b >= 'A' && b <= 'Z';
}

__device__ __forceinline__ uint8_t case_byte(uint8_t b, int mode,
                                             bool word_start) {
  const bool up = mode == kUpper || (mode == kInitcap && word_start);
  if (up) return is_lower(b) ? (uint8_t)(b - 32) : b;
  return is_upper(b) ? (uint8_t)(b + 32) : b;
}

__device__ __forceinline__ bool match_at(const uint8_t* bytes, long long p,
                                         const uint8_t* needle, int n) {
  for (int k = 0; k < n; ++k)
    if (bytes[p + k] != needle[k]) return false;
  return true;
}

// first j in [0, n] with offsets[j] > x (n + 1 if none)
__device__ __forceinline__ long long upper_bound(const int32_t* offsets,
                                                 long long n, long long x) {
  long long lo = 0, hi = n + 1;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)offsets[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------------------ K37
// 16 bytes a thread, held as four 32-bit words (registers, no stack)
__device__ __forceinline__ uint8_t byte_of(const uint32_t (&w)[4], int k) {
  return (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

__device__ __forceinline__ void set_byte(uint32_t (&w)[4], int k, uint8_t b) {
  const int sh = 8 * (k & 3);
  w[k >> 2] = (w[k >> 2] & ~(0xFFu << sh)) | ((uint32_t)b << sh);
}

__global__ void case_map_kernel(const int32_t* __restrict__ offsets,
                                long long n_rows,
                                const uint8_t* __restrict__ in,
                                uint8_t* __restrict__ out, long long byte_cap,
                                int mode, int vec) {
  const long long total = offsets[n_rows];
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t * 16 < byte_cap; t += (long long)gridDim.x * blockDim.x) {
    const long long b0 = t * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (vec && b0 + 16 <= total) {
      const uint4 v = *reinterpret_cast<const uint4*>(in + b0);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (b0 + k < total) set_byte(w, k, in[b0 + k]);
    }
    if (b0 < total) {
      long long j = 0;  // first offset index past the current byte
      uint8_t prev = ' ';
      if (mode == kInitcap) {
        j = upper_bound(offsets, n_rows, b0);
        prev = b0 > 0 ? in[b0 - 1] : (uint8_t)' ';
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long i = b0 + k;
        if (i < total) {
          const uint8_t orig = byte_of(w, k);
          bool word_start = false;
          if (mode == kInitcap) {
            while (j <= n_rows && (long long)offsets[j] <= i) ++j;
            word_start = prev == ' ' || (j > 0 && offsets[j - 1] == i);
            prev = orig;
          }
          set_byte(w, k, case_byte(orig, mode, word_start));
        }
      }
    }
    if (vec && b0 + 16 <= byte_cap) {
      *reinterpret_cast<uint4*>(out + b0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (b0 + k < byte_cap) out[b0 + k] = byte_of(w, k);
    }
  }
}

// ------------------------------------------------------------------ K38
__global__ void span_plan_kernel(const int32_t* __restrict__ offsets,
                                 const uint8_t* __restrict__ bytes,
                                 const uint8_t* __restrict__ valid,
                                 long long n, int mode,
                                 const uint8_t* __restrict__ delim, int dlen,
                                 int count, int32_t* __restrict__ spans,
                                 uint8_t* __restrict__ span_valid) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long s = offsets[i];
    const long long e = offsets[i + 1];
    long long a = s, b = e;
    if (mode == kIndex) {
      if (count == 0 || dlen == 0) {
        b = s;
      } else if (count > 0) {
        int found = 0;
        for (long long p = s; p + dlen <= e;) {
          if (match_at(bytes, p, delim, dlen)) {
            if (++found == count) {
              b = p;
              break;
            }
            p += dlen;
          } else {
            ++p;
          }
        }
      } else {
        const long long k = -(long long)count;
        long long found = 0;
        for (long long p = e - dlen; p >= s;) {
          if (match_at(bytes, p, delim, dlen)) {
            if (++found == k) {
              a = p + dlen;
              break;
            }
            p -= dlen;
          } else {
            --p;
          }
        }
      }
    } else {
      if (mode != kTrimRight)
        while (a < e && bytes[a] == ' ') ++a;
      if (mode != kTrimLeft)
        while (b > a && bytes[b - 1] == ' ') --b;
    }
    spans[2 * i] = (int32_t)a;
    spans[2 * i + 1] = (int32_t)b;
    span_valid[2 * i] = valid[i];
    span_valid[2 * i + 1] = 0;
    if (i == n - 1) spans[2 * n] = offsets[n];
  }
}

// ------------------------------------------------------------------ K39
__global__ void replace_count_kernel(const int32_t* __restrict__ offsets,
                                     const uint8_t* __restrict__ bytes,
                                     const uint8_t* __restrict__ valid,
                                     long long n,
                                     const uint8_t* __restrict__ find,
                                     int f, int r,
                                     uint32_t* __restrict__ lens,
                                     unsigned long long* __restrict__ total) {
  using BlockReduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  unsigned long long sum = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i <= n; i += (long long)gridDim.x * blockDim.x) {
    long long len = 0;
    if (i < n && valid[i]) {
      const long long s = offsets[i];
      const long long e = offsets[i + 1];
      long long hits = 0;
      for (long long p = s; p + f <= e;) {
        if (match_at(bytes, p, find, f)) {
          ++hits;
          p += f;
        } else {
          ++p;
        }
      }
      len = (e - s) + hits * (long long)(r - f);
    }
    lens[i] = (uint32_t)len;
    sum += (unsigned long long)len;
  }
  const unsigned long long block_sum = BlockReduce(tmp).Sum(sum);
  if (threadIdx.x == 0) atomicAdd(total, block_sum);
}

__global__ void replace_write_kernel(const int32_t* __restrict__ offsets,
                                     const uint8_t* __restrict__ bytes,
                                     const uint8_t* __restrict__ valid,
                                     long long n,
                                     const uint8_t* __restrict__ find, int f,
                                     const uint8_t* __restrict__ repl, int r,
                                     const int32_t* __restrict__ out_offsets,
                                     uint8_t* __restrict__ out,
                                     long long out_cap) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!valid[i]) continue;
    const long long e = offsets[i + 1];
    long long q = out_offsets[i];
    for (long long p = offsets[i]; p < e;) {
      if (p + f <= e && match_at(bytes, p, find, f)) {
        for (int k = 0; k < r && q + k < out_cap; ++k) out[q + k] = repl[k];
        q += r;
        p += f;
      } else {
        if (q < out_cap) out[q] = bytes[p];
        ++q;
        ++p;
      }
    }
  }
}

// ------------------------------------------------------------------ K40
// One source of K40: a column (stride 1) or a scalar's one-row column that
// every lane reads (stride 0). The wrapper passes them as int64 [J, 4]:
// bytes, offsets, validity, stride.
struct Source {
  const uint8_t* bytes;
  const int32_t* offsets;
  const uint8_t* valid;
  long long stride;
};

// the table, staged once a block in shared memory (J * 32 bytes)
__device__ __forceinline__ const long long* stage_sources(
    const long long* desc, int J) {
  extern __shared__ long long staged[];
  for (int k = threadIdx.x; k < 4 * J; k += blockDim.x) staged[k] = desc[k];
  __syncthreads();
  return staged;
}

__device__ __forceinline__ Source source_at(const long long* desc, int j) {
  Source s;
  s.bytes = reinterpret_cast<const uint8_t*>(desc[4 * j]);
  s.offsets = reinterpret_cast<const int32_t*>(desc[4 * j + 1]);
  s.valid = reinterpret_cast<const uint8_t*>(desc[4 * j + 2]);
  s.stride = desc[4 * j + 3];
  return s;
}

__global__ void concat_plan_kernel(const long long* __restrict__ table,
                                   int J, long long n, int sep_len,
                                   uint32_t* __restrict__ lens,
                                   uint8_t* __restrict__ out_valid) {
  const long long* desc = stage_sources(table, J);
  const bool ws = sep_len >= 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i <= n; i += (long long)gridDim.x * blockDim.x) {
    if (i == n) {
      lens[n] = 0;
      continue;
    }
    bool ok = true;
    long long len = 0;
    int pieces = 0;
    for (int j = 0; j < J; ++j) {
      const Source src = source_at(desc, j);
      const long long r = i * src.stride;
      const bool v = src.valid[r] != 0;
      const long long l = (long long)src.offsets[r + 1] - src.offsets[r];
      if (!ws) {
        ok = ok && v;
        len += l;
      } else if (v) {
        len += (pieces > 0 ? sep_len : 0) + l;
        ++pieces;
      }
    }
    lens[i] = ok ? (uint32_t)len : 0u;
    out_valid[i] = ok ? 1 : 0;
  }
}

__device__ __forceinline__ void copy_bytes(uint8_t* out, long long at,
                                           const uint8_t* src, long long len,
                                           long long out_cap) {
  for (long long k = 0; k < len && at + k < out_cap; ++k) out[at + k] = src[k];
}

// a thread a lane of the output: the pieces in order, separators between
__global__ void concat_copy_kernel(const long long* __restrict__ table,
                                   int J, long long n,
                                   const uint8_t* __restrict__ sep,
                                   int sep_len,
                                   const int32_t* __restrict__ out_offsets,
                                   const uint8_t* __restrict__ out_valid,
                                   uint8_t* __restrict__ out,
                                   long long out_cap) {
  const long long* desc = stage_sources(table, J);
  const bool ws = sep_len >= 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!out_valid[i]) continue;
    long long at = out_offsets[i];
    bool any = false;
    for (int j = 0; j < J; ++j) {
      const Source src = source_at(desc, j);
      const long long r = i * src.stride;
      if (ws && !src.valid[r]) continue;
      const long long s = src.offsets[r];
      const long long l = (long long)src.offsets[r + 1] - s;
      if (ws && any) {
        copy_bytes(out, at, sep, sep_len, out_cap);
        at += sep_len;
      }
      copy_bytes(out, at, src.bytes + s, l, out_cap);
      at += l;
      any = true;
    }
  }
}

inline unsigned grid_for(long long threads) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(threads, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch K39's and K40's length scans need over n lanes
SRT_API size_t srt_string_transform_scratch_bytes(long long n) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(n + 1);
  c.take<uint32_t>(scan_scratch_elems(n + 1));
  return c.used;
}

// K37. offsets: int32 [n_rows + 1]; in, out: uint8 [byte_cap]; mode 0
// upper, 1 lower, 2 initcap; vec: both buffers are 16-byte aligned. Bytes
// at or past offsets[n_rows] are written 0.
SRT_API int srt_string_case_map(const int32_t* offsets, long long n_rows,
                                const uint8_t* in, uint8_t* out,
                                long long byte_cap, int mode, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (byte_cap <= 0) return 0;
  case_map_kernel<<<grid_for(ceil_div(byte_cap, 16)), kThreads, 0, st>>>(
      offsets, n_rows, in, out, byte_cap, mode, vec);
  SRT_LAUNCHED("case_map_kernel");
  return 0;
}

// K38. offsets: int32 [n + 1]; valid: bool [n]; mode 0 trim both, 1 left,
// 2 right, 3 substring_index(delim [dlen], count); spans: int32 [2n + 1];
// span_valid: bool [2n].
SRT_API int srt_string_span_plan(const int32_t* offsets, const uint8_t* bytes,
                                 const uint8_t* valid, long long n, int mode,
                                 const uint8_t* delim, int dlen, int count,
                                 int32_t* spans, uint8_t* span_valid,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    SRT_CALL(cudaMemcpyAsync(spans, offsets, sizeof(int32_t),
                             cudaMemcpyDeviceToDevice, st),
             "copy the total");
    return 0;
  }
  span_plan_kernel<<<grid_for(n), kThreads, 0, st>>>(
      offsets, bytes, valid, n, mode, delim, dlen, count, spans, span_valid);
  SRT_LAUNCHED("span_plan_kernel");
  return 0;
}

// K39, count: needles = find [f] then repl [r]; out_offsets: int32 [n + 1]
// (exclusive scan of each row's output length); total: the output's bytes
// as uint64 (the wrapper reads it back to size the write).
SRT_API int srt_string_replace_count(const int32_t* offsets,
                                     const uint8_t* bytes,
                                     const uint8_t* valid, long long n,
                                     const uint8_t* needles, int f, int r,
                                     int32_t* out_offsets,
                                     unsigned long long* total,
                                     void* scratch, size_t scratch_bytes,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || f <= 0 || n >= 0x7FFFFFFFLL ||
      scratch_bytes < srt_string_transform_scratch_bytes(n))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* lens = c.take<uint32_t>(n + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(n + 1));
  SRT_CALL(cudaMemsetAsync(total, 0, sizeof(unsigned long long), st),
           "memset total");
  replace_count_kernel<<<grid_for(n + 1), kThreads, 0, st>>>(
      offsets, bytes, valid, n, needles, f, r, lens, total);
  SRT_LAUNCHED("replace_count_kernel");
  SRT_TRY(scan_u32(lens, reinterpret_cast<uint32_t*>(out_offsets), n + 1,
                   scan_scratch, nullptr, false, st));
  return 0;
}

// K39, write: out: uint8 [out_cap], out_cap >= the count's total.
SRT_API int srt_string_replace_write(const int32_t* offsets,
                                     const uint8_t* bytes,
                                     const uint8_t* valid, long long n,
                                     const uint8_t* needles, int f, int r,
                                     const int32_t* out_offsets, uint8_t* out,
                                     long long out_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  replace_write_kernel<<<grid_for(n), kThreads, 0, st>>>(
      offsets, bytes, valid, n, needles, f, needles + f, r, out_offsets, out,
      out_cap);
  SRT_LAUNCHED("replace_write_kernel");
  return 0;
}

// K40. desc: int64 [J, 4] in device memory (bytes, offsets, validity,
// stride of each source); sep: uint8 [sep_len], sep_len -1 for concat;
// offsets: int32 [n + 1]; out_valid: bool [n]; out: uint8 [out_cap].
SRT_API int srt_string_concat(const long long* desc, int J, long long n,
                              const uint8_t* sep, int sep_len,
                              int32_t* offsets, uint8_t* out_valid,
                              uint8_t* out, long long out_cap, void* scratch,
                              size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || J <= 0 || n >= 0x7FFFFFFFLL ||
      scratch_bytes < srt_string_transform_scratch_bytes(n))
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* lens = c.take<uint32_t>(n + 1);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(n + 1));
  const size_t smem = sizeof(long long) * 4 * (size_t)J;
  if (smem > 48 * 1024) return fail(cudaErrorInvalidValue, "too many sources");
  concat_plan_kernel<<<grid_for(n + 1), kThreads, smem, st>>>(
      desc, J, n, sep_len, lens, out_valid);
  SRT_LAUNCHED("concat_plan_kernel");
  SRT_TRY(scan_u32(lens, reinterpret_cast<uint32_t*>(offsets), n + 1,
                   scan_scratch, nullptr, false, st));
  if (n == 0) return 0;
  concat_copy_kernel<<<grid_for(n), kThreads, smem, st>>>(
      desc, J, n, sep, sep_len, offsets, out_valid, out, out_cap);
  SRT_LAUNCHED("concat_copy_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
