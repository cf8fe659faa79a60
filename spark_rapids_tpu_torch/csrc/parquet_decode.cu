// K20 hybrid_expand and K21 page_decode_fixed: the device half of a Parquet
// column chunk's decode. The host (io/parquet_device.py, native/srt_io.cpp)
// walks page headers and the RLE / bit-packed run structure only; every
// value is produced here, from the chunk's bytes on the card.
//
// K20 replaces spark_rapids_tpu/io/parquet_device.py:_expand_hybrid (:443)
// and, with a synthetic bit-packed run of width 1, _extract_bits_lsb
// (:615). One thread per output lane binary-searches the run table for the
// last run starting at or before its lane, then writes the run's repeated
// value (RLE) or its bit window (bit-packed), read through an 8-byte
// little-endian window so widths up to 32 are exact at any bit offset. Bit
// positions are 64-bit: a 400 MB chunk has bit offsets past 2^31. The
// width is per run, so pages of one chunk may use different index widths
// (a writer's dictionary grows between pages). Lanes at or past `total`,
// before the first run, in a run of width 0, and bytes past the chunk read
// as 0.
//
// K21 replaces _flat_plain_kernel (:865), _flat_dict_kernel's gather
// (:810), _bitcast_values (:624), _assemble (:634) and _flat_finish (:892):
// one call per column chunk. A flag pass marks the rows that hold a value
// (row < num_rows and its definition level is 1), the shared exclusive scan
// of common.cuh gives each such row its dense slot, and a gather pass
// writes the row's value: from the dictionary (idx[slot] into dict, the
// index clipped into range as the reference clips it) or from PLAIN pages
// (a binary search of the page table by dense slot, then the page's byte
// position plus the slot's offset in it). Values are in_w little-endian
// bytes, sign-extended when the output is wider (INT32 decimals), written
// as the low out_w bytes; rows without a value are zero. A required column
// (no definition levels) needs no scan: its slot is its row.
//
// Bound: memory. K20 reads one run entry a lane (the binary search stays
// in cache) and the bits it extracts, and writes 4 bytes a lane. K21 reads
// a level and a value a row and writes out_w + 1 bytes a row; the scan adds
// 8 bytes a row.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

// last r with out_start[r] <= j, or -1
__device__ __forceinline__ long long find_run(const long long* out_start,
                                              long long n_runs, long long j) {
  long long lo = 0, hi = n_runs;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (out_start[mid] <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

__device__ __forceinline__ unsigned long long load_le(const uint8_t* buf,
                                                      long long nbytes,
                                                      long long at, int w) {
  unsigned long long v = 0;
  for (int k = 0; k < w; ++k) {
    const long long p = at + k;
    if (p >= 0 && p < nbytes) v |= (unsigned long long)buf[p] << (8 * k);
  }
  return v;
}

__global__ void hybrid_expand_kernel(const uint8_t* __restrict__ chunk,
                                     long long nbytes,
                                     const long long* __restrict__ out_start,
                                     const uint8_t* __restrict__ is_rle,
                                     const int32_t* __restrict__ value,
                                     const long long* __restrict__ bit_off,
                                     const int32_t* __restrict__ width,
                                     long long n_runs, long long total,
                                     int32_t* __restrict__ out,
                                     long long cap) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x) {
    uint32_t v = 0;
    const long long r = j < total ? find_run(out_start, n_runs, j) : -1;
    if (r >= 0) {
      const int w = width[r];
      if (is_rle[r]) {
        v = (uint32_t)value[r];
      } else if (w > 0) {
        const long long bitpos = bit_off[r] + (j - out_start[r]) * w;
        const unsigned long long word =
            load_le(chunk, nbytes, bitpos >> 3, 8);
        const unsigned long long mask =
            w >= 32 ? 0xFFFFFFFFull : ((1ull << w) - 1ull);
        v = (uint32_t)((word >> (bitpos & 7)) & mask);
      }
    }
    out[j] = (int32_t)v;
  }
}

__global__ void present_flags_kernel(const int32_t* __restrict__ def,
                                     long long num_rows, long long cap,
                                     uint32_t* __restrict__ flags) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x)
    flags[j] = j < num_rows && def[j] != 0 ? 1u : 0u;
}

struct DecodeArgs {
  const int32_t* def;        // null: a required column
  const uint32_t* slots;     // exclusive scan of the flags (with def)
  long long num_rows, cap;
  int dict_mode;  // 0 PLAIN pages, 1 through the dictionary, 2 codes
  const int32_t* idx;
  long long n_idx;
  const uint8_t* dict;
  long long n_dict;
  const uint8_t* src;
  long long n_src;
  const long long* dense_end;
  const long long* byte_pos;
  long long n_pages;
  int in_w, out_w, sign_extend;
  uint8_t* out;
  uint8_t* out_valid;
};

__global__ void decode_fixed_kernel(DecodeArgs a) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < a.cap; j += (long long)gridDim.x * blockDim.x) {
    const bool ok = j < a.num_rows && (a.def == nullptr || a.def[j] != 0);
    unsigned long long v = 0;
    if (ok) {
      const long long slot = a.def == nullptr ? j : (long long)a.slots[j];
      if (a.dict_mode == 2) {
        if (a.n_idx > 0)
          v = (uint32_t)a.idx[slot < a.n_idx ? slot : a.n_idx - 1];
      } else if (a.dict_mode) {
        if (a.n_idx > 0 && a.n_dict > 0) {
          long long ix = a.idx[slot < a.n_idx ? slot : a.n_idx - 1];
          ix = ix < 0 ? 0 : (ix >= a.n_dict ? a.n_dict - 1 : ix);
          v = load_le(a.dict, a.n_dict * a.in_w, ix * a.in_w, a.in_w);
        }
      } else if (a.n_pages > 0) {
        long long lo = 0, hi = a.n_pages;  // first page ending past slot
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (a.dense_end[mid] <= slot)
            lo = mid + 1;
          else
            hi = mid;
        }
        const long long page = lo < a.n_pages ? lo : a.n_pages - 1;
        const long long first = page > 0 ? a.dense_end[page - 1] : 0;
        v = load_le(a.src, a.n_src,
                    a.byte_pos[page] + (slot - first) * a.in_w, a.in_w);
      }
      if (a.sign_extend && a.in_w < 8) {
        const int sh = 64 - 8 * a.in_w;
        v = (unsigned long long)((long long)(v << sh) >> sh);
      }
    }
    uint8_t* o = a.out + j * a.out_w;
    for (int k = 0; k < a.out_w; ++k) o[k] = (uint8_t)(v >> (8 * k));
    a.out_valid[j] = ok ? 1 : 0;
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// chunk: uint8 [nbytes]; the run table (n_runs entries): out_start int64,
// is_rle uint8, value int32, bit_off int64 (absolute bits into chunk),
// width int32; out: int32 [cap].
SRT_API int srt_hybrid_expand(const uint8_t* chunk, long long nbytes,
                              const long long* out_start,
                              const uint8_t* is_rle, const int32_t* value,
                              const long long* bit_off, const int32_t* width,
                              long long n_runs, long long total, int32_t* out,
                              long long cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  if (n_runs < 0 || total < 0) return fail(cudaErrorInvalidValue, "arguments");
  hybrid_expand_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      chunk, nbytes, out_start, is_rle, value, bit_off, width, n_runs,
      n_runs > 0 ? total : 0, out, cap);
  SRT_LAUNCHED("hybrid_expand_kernel");
  return 0;
}

// bytes of scratch K21 needs for cap rows with definition levels
SRT_API size_t srt_page_decode_scratch_bytes(long long cap) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(cap);
  c.take<uint32_t>(cap);
  c.take<uint32_t>(scan_scratch_elems(cap));
  return c.used;
}

// def: int32 [cap] definition levels (K20's output) or null for a required
// column. Dictionary mode (1): idx int32 [n_idx] dense dictionary indices,
// dict: n_dict values of in_w bytes. Codes mode (2): idx only, written as
// they are (in_w = out_w = 4). PLAIN mode: src uint8 [n_src], the
// page table dense_end / byte_pos int64 [n_pages] (a page's dense values
// end at dense_end and start at byte_pos of src). out: uint8 [cap * out_w];
// out_valid: bool [cap].
SRT_API int srt_page_decode_fixed(
    const int32_t* def, long long num_rows, long long cap, int dict_mode,
    const int32_t* idx, long long n_idx, const uint8_t* dict, long long n_dict,
    const uint8_t* src, long long n_src, const long long* dense_end,
    const long long* byte_pos, long long n_pages, int in_w, int out_w,
    int sign_extend, uint8_t* out, uint8_t* out_valid, void* scratch,
    size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  if (in_w < 1 || in_w > 8 || out_w < 1 || out_w > 8 || cap >= 0xFFFFFFFFLL ||
      dict_mode < 0 || dict_mode > 2 ||
      (dict_mode == 2 && (in_w != 4 || out_w != 4)))
    return fail(cudaErrorInvalidValue, "arguments");
  DecodeArgs a{def, nullptr, num_rows, cap, dict_mode, idx, n_idx, dict,
               n_dict, src, n_src, dense_end, byte_pos, n_pages, in_w, out_w,
               sign_extend, out, out_valid};
  if (def != nullptr) {
    if (scratch_bytes < srt_page_decode_scratch_bytes(cap))
      return fail(cudaErrorInvalidValue, "scratch");
    Carver c{static_cast<char*>(scratch), 0};
    uint32_t* flags = c.take<uint32_t>(cap);
    uint32_t* slots = c.take<uint32_t>(cap);
    uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(cap));
    present_flags_kernel<<<grid_for(cap), kThreads, 0, st>>>(def, num_rows,
                                                            cap, flags);
    SRT_LAUNCHED("present_flags_kernel");
    SRT_TRY(scan_u32(flags, slots, cap, scan_scratch, nullptr, false, st));
    a.slots = slots;
  }
  decode_fixed_kernel<<<grid_for(cap), kThreads, 0, st>>>(a);
  SRT_LAUNCHED("decode_fixed_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
