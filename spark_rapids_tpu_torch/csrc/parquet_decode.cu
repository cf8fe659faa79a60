// K20 hybrid_expand, K21 page_decode_pages and K25 delta_expand: the device
// half of a Parquet column chunk's decode. The host (io/parquet_device.py, native/srt_io.cpp)
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
// (:810), _flat_dict_codes_kernel (:824), _bitcast_values (:624),
// _assemble (:634), _flat_finish (:892), _decode_bss (:600),
// _fold_flba_be (:581) and the generic page loop's _concat_logical +
// _assemble (:1327-1455): one call per column chunk. A flag pass marks
// the rows that hold a value (row < num_rows and its definition level is
// 1), the shared exclusive scan of common.cuh gives each such row its
// dense slot, and one thread a row binary-searches the page table by
// dense slot. The page's kind says where the value is: PLAIN (in_w
// little-endian bytes at the page's byte position plus the slot's offset
// in it), dictionary (idx[slot] into a table of dict_w-byte entries, the
// index clipped into range as the reference clips it), BYTE_STREAM_SPLIT
// (byte k of the page's i-th value at pos + k * n + i: neighbouring rows
// read neighbouring bytes of each plane), FLBA (in_w <= 16 big-endian
// bytes folded into int64, sign-extended below 8 bytes, the low 8 above:
// precision <= 18 fits) or dense (K25's value for the slot). Values are
// sign-extended when asked (INT32 decimals) and written as the low out_w
// bytes; rows without a value are zero. A required column (no definition
// levels) needs no scan: its slot is its row. So a chunk that mixes kinds
// (a writer's dictionary fallback) decodes in one launch, an FLBA chunk's
// dictionary page folds once through the same call, and the codes of an
// encoded chunk spread as one PLAIN page of int32 indices.
//
// K25 delta_expand replaces _expand_delta (:520). One launch covers every
// DELTA_BINARY_PACKED stream of a chunk (a page's values, or the length
// streams of DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY pages). Lane k of
// a stream is its first value (k = 0) or delta k - 1: w bits (0-64) at the
// miniblock's bit offset + (k - 1) % vpm * w, read through an 8-byte
// window and the byte after it, plus the block's min delta in uint64, so
// sums wrap modulo 2^64 as the format requires. A segmented inclusive scan
// (cub::BlockScan over tiles of 4096 lanes, one block scanning the tile
// totals, a pass adding each tile's carry to the stream that crosses into
// it) turns the deltas into values and writes each at its stream's dense
// offset.
//
// Bound: memory. K20 reads one run entry a lane (the binary search stays
// in cache) and the bits it extracts, and writes 4 bytes a lane. K21 reads
// a level and a value a row and writes out_w + 1 bytes a row; the scan adds
// 8 bytes a row. K25 reads the delta bytes and its miniblock table once
// and writes 8 bytes a value.
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

__device__ __forceinline__ unsigned long long sign_extend_from(
    unsigned long long v, int w) {
  if (w >= 8) return v;
  const int sh = 64 - 8 * w;
  return (unsigned long long)((long long)(v << sh) >> sh);
}

enum PageKind { kPlain = 0, kDict = 1, kBss = 2, kFlba = 3, kDense = 4 };

struct PageArgs {
  const int32_t* def;     // null: a required column
  const uint32_t* slots;  // exclusive scan of the flags (with def)
  long long num_rows, cap;
  const uint8_t* src;
  long long n_src;
  const long long* dense_end;
  const long long* byte_pos;
  const int32_t* kind;
  long long n_pages;
  const int32_t* idx;  // dictionary indices by dense slot
  long long n_idx;
  const uint8_t* dict;  // n_dict entries of dict_w bytes
  long long n_dict;
  int dict_w;
  const long long* dense;  // K25's values by dense slot
  long long n_dense;
  int in_w, out_w, sign_extend;
  uint8_t* out;
  uint8_t* out_valid;
};

// One thread a row: its dense slot, its page (binary search of the page
// table), then the value by the page's kind.
__global__ void decode_pages_kernel(PageArgs a) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < a.cap; j += (long long)gridDim.x * blockDim.x) {
    const bool ok = j < a.num_rows && (a.def == nullptr || a.def[j] != 0);
    unsigned long long v = 0;
    if (ok && a.n_pages > 0) {
      const long long slot = a.def == nullptr ? j : (long long)a.slots[j];
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
      const long long i = slot - first;
      const long long n_p = a.dense_end[page] - first;
      const long long bp = a.byte_pos[page];
      switch (a.kind[page]) {
        case kPlain: {
          const int w = a.in_w < 8 ? a.in_w : 8;
          v = load_le(a.src, a.n_src, bp + i * a.in_w, w);
          if (a.sign_extend) v = sign_extend_from(v, a.in_w);
          break;
        }
        case kBss:  // byte k of value i in plane k: neighbours coalesce
          for (int k = 0; k < a.in_w && k < 8; ++k) {
            const long long p = bp + k * n_p + i;
            if (p >= 0 && p < a.n_src)
              v |= (unsigned long long)a.src[p] << (8 * k);
          }
          break;
        case kFlba: {  // big-endian two's complement; the low 8 bytes
          const long long base = bp + i * a.in_w;
          for (int k = 0; k < a.in_w && k < 8; ++k) {
            const long long p = base + (a.in_w - 1 - k);
            if (p >= 0 && p < a.n_src)
              v |= (unsigned long long)a.src[p] << (8 * k);
          }
          v = sign_extend_from(v, a.in_w);
          break;
        }
        case kDict:
          if (a.idx != nullptr && a.n_idx > 0 && a.n_dict > 0) {
            long long ix = a.idx[slot < a.n_idx ? slot : a.n_idx - 1];
            ix = ix < 0 ? 0 : (ix >= a.n_dict ? a.n_dict - 1 : ix);
            v = load_le(a.dict, a.n_dict * a.dict_w, ix * a.dict_w,
                        a.dict_w);
            if (a.sign_extend) v = sign_extend_from(v, a.dict_w);
          }
          break;
        case kDense:
          if (a.dense != nullptr && a.n_dense > 0) {
            v = (unsigned long long)
                a.dense[slot < a.n_dense ? slot : a.n_dense - 1];
            if (a.sign_extend) v = sign_extend_from(v, a.in_w);
          }
          break;
        default:
          break;
      }
    }
    uint8_t* o = a.out + j * a.out_w;
    for (int k = 0; k < a.out_w; ++k) o[k] = (uint8_t)(v >> (8 * k));
    a.out_valid[j] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------- K25
// A segmented sum: the head of a stream (f = 1) restarts the sum.
struct SegPair {
  unsigned long long v;
  int f;
};

struct SegSum {
  __device__ __forceinline__ SegPair operator()(const SegPair& a,
                                                const SegPair& b) const {
    SegPair r;
    r.v = b.f ? b.v : a.v + b.v;
    r.f = a.f | b.f;
    return r;
  }
};

struct DeltaArgs {
  const uint8_t* chunk;
  long long nbytes;
  const long long* lane_start;  // [n_streams + 1]
  const long long* dest;
  const long long* first;
  const int32_t* vpm;
  const long long* mb_first;  // [n_streams + 1]
  long long n_streams;
  const long long* mb_bit_off;
  const int32_t* mb_width;
  const long long* mb_min;
  long long lanes;
  long long* out;
  long long out_len;
};

// Lane j's element: its stream's first value (a head), or delta k - 1 of
// its stream: w bits (0-64) at bit_off + (k - 1) % vpm * w, read through
// an 8-byte window and the byte after it, plus the min delta, in uint64.
__device__ __forceinline__ SegPair delta_element(const DeltaArgs& a,
                                                 long long j,
                                                 long long* dst) {
  const long long s = find_run(a.lane_start, a.n_streams, j);
  const long long k = j - a.lane_start[s];
  *dst = a.dest[s] + k;
  if (k == 0) return SegPair{(unsigned long long)a.first[s], 1};
  const long long d = k - 1;
  const long long vp = a.vpm[s];
  const long long m = a.mb_first[s] + d / vp;
  if (m >= a.mb_first[s + 1]) return SegPair{0ull, 0};
  const int w = a.mb_width[m];
  unsigned long long bits = 0;
  if (w > 0) {
    const long long bitpos = a.mb_bit_off[m] + (d % vp) * w;
    const long long byte = bitpos >> 3;
    const int sh = (int)(bitpos & 7);
    const unsigned long long lo = load_le(a.chunk, a.nbytes, byte, 8);
    const unsigned long long hi = load_le(a.chunk, a.nbytes, byte + 8, 1);
    bits = (lo >> sh) | (sh ? hi << (64 - sh) : 0ull);
    if (w < 64) bits &= (1ull << w) - 1ull;
  }
  return SegPair{bits + (unsigned long long)a.mb_min[m], 0};
}

// Pass 1: each tile of kTile lanes unpacks its elements, scans them
// (segmented) and writes the tile-local sums; its aggregate goes to
// tile_agg.
__global__ void delta_tiles_kernel(DeltaArgs a, SegPair* tile_agg) {
  using BlockScan = cub::BlockScan<SegPair, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  SegPair e[kItems];
  long long dst[kItems];
  const SegSum op{};
  SegPair agg{0ull, 0};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + i;
    if (j < a.lanes) {
      e[i] = delta_element(a, j, &dst[i]);
    } else {
      e[i] = SegPair{0ull, 0};
      dst[i] = -1;
    }
    agg = op(agg, e[i]);
  }
  SegPair run, block_agg;
  BlockScan(tmp).ExclusiveScan(agg, run, SegPair{0ull, 0}, op, block_agg);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = op(run, e[i]);
    if (dst[i] >= 0 && dst[i] < a.out_len) a.out[dst[i]] = (long long)run.v;
  }
  if (threadIdx.x == 0) tile_agg[blockIdx.x] = block_agg;
}

// Pass 2, one block: tile_agg[t] becomes the segmented sum of tiles < t.
__global__ void delta_carry_kernel(SegPair* tile_agg, long long n_tiles) {
  using BlockScan = cub::BlockScan<SegPair, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  __shared__ SegPair carry;
  const SegSum op{};
  if (threadIdx.x == 0) carry = SegPair{0ull, 0};
  __syncthreads();
  for (long long base = 0; base < n_tiles; base += kThreads) {
    const long long t = base + threadIdx.x;
    const SegPair x = t < n_tiles ? tile_agg[t] : SegPair{0ull, 0};
    SegPair ex, agg;
    BlockScan(tmp).ExclusiveScan(x, ex, SegPair{0ull, 0}, op, agg);
    const SegPair c = carry;
    __syncthreads();
    if (t < n_tiles) tile_agg[t] = op(c, ex);
    if (threadIdx.x == 0) carry = op(c, agg);
    __syncthreads();
  }
}

// Pass 3: tile t (t >= 1) adds its carry to the lanes of the stream that
// began in an earlier tile.
__global__ void delta_fix_kernel(DeltaArgs a, const SegPair* prefix) {
  const long long t = (long long)blockIdx.x + 1;
  const unsigned long long add = prefix[t].v;
  if (add == 0) return;
  const long long lo = t * kTile;
  const long long hi = lo + kTile < a.lanes ? lo + kTile : a.lanes;
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const long long s = find_run(a.lane_start, a.n_streams, j);
    if (a.lane_start[s] >= lo) continue;
    const long long dst = a.dest[s] + (j - a.lane_start[s]);
    if (dst >= 0 && dst < a.out_len)
      a.out[dst] = (long long)((unsigned long long)a.out[dst] + add);
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

// K21: def int32 [cap] definition levels (K20's output) or null for a
// required column, with srt_page_decode_scratch_bytes(cap) of scratch;
// pages: dense_end / byte_pos int64 and kind int32 [n_pages] (0 PLAIN, 1
// dictionary, 2 BYTE_STREAM_SPLIT, 3 FLBA, 4 dense) over src uint8
// [n_src]; idx int32 [n_idx] dictionary indices by dense slot into n_dict
// entries of dict_w bytes; dense int64 [n_dense] values by dense slot.
// PLAIN / BSS pages read in_w (<= 8) bytes, FLBA pages in_w (<= 16).
// out: uint8 [cap * out_w]; out_valid: bool [cap].
SRT_API int srt_page_decode_pages(
    const int32_t* def, long long num_rows, long long cap, const uint8_t* src,
    long long n_src, const long long* dense_end, const long long* byte_pos,
    const int32_t* kind, long long n_pages, const int32_t* idx,
    long long n_idx, const uint8_t* dict, long long n_dict, int dict_w,
    const long long* dense, long long n_dense, int in_w, int out_w,
    int sign_extend, uint8_t* out, uint8_t* out_valid, void* scratch,
    size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return 0;
  if (in_w < 1 || in_w > 16 || out_w < 1 || out_w > 8 || dict_w < 1 ||
      dict_w > 8 || cap >= 0xFFFFFFFFLL || n_pages < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  PageArgs a{def,    nullptr, num_rows, cap,     src,   n_src,   dense_end,
             byte_pos, kind,  n_pages,  idx,     n_idx, dict,    n_dict,
             dict_w, dense,   n_dense,  in_w,    out_w, sign_extend, out,
             out_valid};
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
  decode_pages_kernel<<<grid_for(cap), kThreads, 0, st>>>(a);
  SRT_LAUNCHED("decode_pages_kernel");
  return 0;
}

// bytes of scratch K25 needs for `lanes` lanes
SRT_API size_t srt_delta_expand_scratch_bytes(long long lanes) {
  Carver c{nullptr, 0};
  c.take<SegPair>(ceil_div(lanes, kTile));
  return c.used;
}

// K25: every DELTA_BINARY_PACKED stream of a chunk. Stream s covers lanes
// [lane_start[s], lane_start[s + 1]) and writes out[dest[s] + k] for its
// k-th value; first int64, vpm int32, mb_first int64 [n_streams + 1] into
// the miniblock table (bit offset int64, width int32, min delta int64).
// Sums wrap modulo 2^64. out is not cleared here.
SRT_API int srt_delta_expand(
    const uint8_t* chunk, long long nbytes, const long long* lane_start,
    const long long* dest, const long long* first, const int32_t* vpm,
    const long long* mb_first, long long n_streams,
    const long long* mb_bit_off, const int32_t* mb_width,
    const long long* mb_min, long long n_mbs, long long lanes,
    long long* out, long long out_len, void* scratch, size_t scratch_bytes,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes <= 0) return 0;
  if (n_streams <= 0 || n_mbs < 0 || out_len < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  if (scratch_bytes < srt_delta_expand_scratch_bytes(lanes))
    return fail(cudaErrorInvalidValue, "scratch");
  const long long n_tiles = ceil_div(lanes, kTile);
  SegPair* tile_agg = static_cast<SegPair*>(scratch);
  DeltaArgs a{chunk,    nbytes,     lane_start, dest,   first,
              vpm,      mb_first,   n_streams,  mb_bit_off, mb_width,
              mb_min,   lanes,      out,        out_len};
  delta_tiles_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(a, tile_agg);
  SRT_LAUNCHED("delta_tiles_kernel");
  if (n_tiles > 1) {
    delta_carry_kernel<<<1, kThreads, 0, st>>>(tile_agg, n_tiles);
    SRT_LAUNCHED("delta_carry_kernel");
    delta_fix_kernel<<<(unsigned)(n_tiles - 1), kThreads, 0, st>>>(
        a, tile_agg);
    SRT_LAUNCHED("delta_fix_kernel");
  }
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
