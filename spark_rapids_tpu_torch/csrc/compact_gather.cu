// K31 compact_fixed, K32 gather_fixed and K46 assemble_routed_fixed: the
// fixed-width row movement of columnar/batch.py (filter compaction, masked
// concat, gathers by index) and of the exchange's routed tier.
//
// K31 replaces spark_rapids_tpu/columnar/batch.py:_compact_plan (:1623) and
// the fixed-column half of compact_batch / _gather_batch_traced (:1630,
// :1651): the live lanes of one or more pieces move stably to the front of
// cap_out output lanes, every fixed column (data and validity) in the same
// launch, and the kept-row count stays on the card as an int32. Lanes at or
// past the count come out zeroed and invalid. The reference sorts the keep
// mask (a stable argsort) and gathers by the order; here it is one flagged
// select in three launches:
//   1. count: a block a tile of 4096 lanes counts its kept lanes;
//   2. scan: the shared device-wide scan (common.cuh) of the tile counts;
//   3. scatter: each block ranks its kept lanes (a thread owns 16
//      consecutive lanes; one BlockScan of the per-thread counts), keeps
//      the destinations in shared memory, then copies column after column,
//      so reads and writes of a column are coalesced; every block also
//      zeroes a share of the lanes past the count.
// Pieces are laid end to end through a table of piece bases, so a masked
// concat compacts its sources where they lie (no torch.cat of sources).
// Tiles never straddle two pieces: a tile's piece is found once per block
// by a binary search over the pieces' first tiles.
//
// K32 replaces _gather_fixed_cols / _gather_fixed_body (:1425, :1434) and
// gather_batch's fixed columns (:1501): one launch gathers every fixed
// column by one index vector. A lane is NULL (validity false, data 0) when
// it lies at or past out_rows, past the index vector, when its index is
// negative or past the source capacity, when indices_valid masks it off, or
// when the source row is NULL. Indices are int32 or int64.
//
// K46 assemble_routed_fixed replaces shuffle/exchange.py:_slice_indices
// (:1324) and the fixed columns of _assemble_routed (:1433): the rows of
// several routed slices, each order[start : start + count] of its own map
// batch's route order, laid end to end in one output of cap_out lanes, for
// every fixed column (an encoded column's codes too) in one launch. A
// thread an output lane finds its slice by a binary search over the
// slices' output offsets; the row's validity is copied and its data too,
// or 0 where the row is NULL; lanes past the rows are zero and invalid, as
// the reference zeroes them.
//
// Columns come through a table in device memory (int64 words: pointers and
// element widths of 1, 2, 4 or 8 bytes), so any number of columns and
// pieces takes one launch of each stage.
//
// Bound: memory. K46 reads each slice's order entries and one element and
// one validity byte of every column a row, and writes cap_out lanes of
// every column. K31 reads each live mask once and the kept lanes of every
// column once, and writes cap_out lanes of every column; K32 reads the
// indices, and one element and one validity byte of every column a lane,
// and writes cap lanes of every column.
#include <algorithm>

#include <cub/block/block_reduce.cuh>

#include "common.cuh"

namespace srt {
namespace {

__device__ __forceinline__ void copy_elem(const void* src, long long si,
                                          void* dst, long long di, int w) {
  switch (w) {
    case 1:
      static_cast<uint8_t*>(dst)[di] = static_cast<const uint8_t*>(src)[si];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[di] = static_cast<const uint16_t*>(src)[si];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[di] = static_cast<const uint32_t*>(src)[si];
      break;
    default:
      static_cast<uint64_t*>(dst)[di] = static_cast<const uint64_t*>(src)[si];
      break;
  }
}

__device__ __forceinline__ void zero_elem(void* dst, long long di, int w) {
  switch (w) {
    case 1: static_cast<uint8_t*>(dst)[di] = 0; break;
    case 2: static_cast<uint16_t*>(dst)[di] = 0; break;
    case 4: static_cast<uint32_t*>(dst)[di] = 0; break;
    default: static_cast<uint64_t*>(dst)[di] = 0; break;
  }
}

// K31's table, int64 words:
//   tile_base [P + 1]  first tile of each piece (the last word: all tiles)
//   caps      [P]      lanes of each piece
//   live      [P]      bool* live mask of each piece
//   src       [P * C]  source pointer of column c of piece p at p * C + c
//   dst       [C]      output pointer of each column (cap_out lanes)
//   width     [C]      element bytes of each column
struct CompactTable {
  const long long* tile_base;
  const long long* caps;
  const long long* live;
  const long long* src;
  const long long* dst;
  const long long* width;
};

__device__ __forceinline__ CompactTable compact_table(const long long* t,
                                                      int P, int C) {
  CompactTable ct;
  ct.tile_base = t;
  ct.caps = t + P + 1;
  ct.live = ct.caps + P;
  ct.src = ct.live + P;
  ct.dst = ct.src + (long long)P * C;
  ct.width = ct.dst + C;
  return ct;
}

// the piece holding tile t: the last p with tile_base[p] <= t
__device__ __forceinline__ int piece_of(const long long* tile_base, int P,
                                        long long t) {
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_base[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void compact_count_kernel(const long long* __restrict__ table,
                                     int P, int C,
                                     uint32_t* __restrict__ counts) {
  const CompactTable ct = compact_table(table, P, C);
  const long long t = blockIdx.x;
  const int p = piece_of(ct.tile_base, P, t);
  const long long lane0 = (t - ct.tile_base[p]) * kTile;
  const long long cap = ct.caps[p];
  const bool* live = reinterpret_cast<const bool*>(ct.live[p]);
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long lane = lane0 + (long long)k * kThreads + threadIdx.x;
    if (lane < cap && live[lane]) ++c;
  }
  using BlockReduce = cub::BlockReduce<uint32_t, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  const uint32_t total = BlockReduce(tmp).Sum(c);
  if (threadIdx.x == 0) counts[t] = total;
}

__global__ void compact_scatter_kernel(const long long* __restrict__ table,
                                       int P, int C, long long ntiles,
                                       const uint32_t* __restrict__ incl,
                                       long long cap_out,
                                       int32_t* __restrict__ count_out) {
  const CompactTable ct = compact_table(table, P, C);
  const long long total = ntiles > 0 ? (long long)incl[ntiles - 1] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = (int32_t)total;
  if ((long long)blockIdx.x < ntiles) {
    using BlockScan = cub::BlockScan<uint32_t, kThreads>;
    __shared__ typename BlockScan::TempStorage tmp;
    __shared__ int32_t dest[kTile];  // output lane of a kept lane, else -1
    const long long t = blockIdx.x;
    const int p = piece_of(ct.tile_base, P, t);
    const long long lane0 = (t - ct.tile_base[p]) * kTile;
    const long long cap = ct.caps[p];
    const int n_here = cap - lane0 < kTile ? (int)(cap - lane0) : kTile;
    const bool* live = reinterpret_cast<const bool*>(ct.live[p]);
    const long long out0 = t > 0 ? (long long)incl[t - 1] : 0;
    const int first = threadIdx.x * kItems;
    bool keep[kItems];
    uint32_t mine = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = first + i;
      keep[i] = j < n_here && live[lane0 + j];
      mine += keep[i] ? 1u : 0u;
    }
    uint32_t before = 0;
    BlockScan(tmp).ExclusiveSum(mine, before);
    long long pos = out0 + before;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      dest[first + i] = keep[i] ? (int32_t)(pos - out0) : -1;
      if (keep[i]) ++pos;
    }
    __syncthreads();
    for (int c = 0; c < C; ++c) {
      const void* src = reinterpret_cast<const void*>(
          ct.src[(long long)p * C + c]);
      void* dst = reinterpret_cast<void*>(ct.dst[c]);
      const int w = (int)ct.width[c];
      for (int j = threadIdx.x; j < n_here; j += kThreads) {
        const int d = dest[j];
        if (d >= 0 && out0 + d < cap_out)
          copy_elem(src, lane0 + j, dst, out0 + d, w);
      }
    }
  }
  // lanes [total, cap_out): zero and invalid (validity is a width-1 column)
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int c = 0; c < C; ++c) {
    void* dst = reinterpret_cast<void*>(ct.dst[c]);
    const int w = (int)ct.width[c];
    for (long long j = total + (long long)blockIdx.x * blockDim.x +
                       threadIdx.x;
         j < cap_out; j += stride)
      zero_elem(dst, j, w);
  }
}

// K32's table, int64 words: src_data [C], src_valid [C], dst_data [C],
// dst_valid [C], width [C].
__global__ void gather_fixed_kernel(const long long* __restrict__ table,
                                    int C, const void* __restrict__ idx,
                                    int idx_bytes, long long n_idx,
                                    const bool* __restrict__ ivalid,
                                    long long n_ivalid, long long out_rows,
                                    long long src_cap, long long cap) {
  const long long* src_data = table;
  const long long* src_valid = table + C;
  const long long* dst_data = table + 2 * C;
  const long long* dst_valid = table + 3 * C;
  const long long* width = table + 4 * C;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += (long long)gridDim.x * blockDim.x) {
    bool ok = j < out_rows && j < n_idx;
    long long i = 0;
    if (ok) {
      i = idx_bytes == 8 ? static_cast<const long long*>(idx)[j]
                         : (long long)static_cast<const int32_t*>(idx)[j];
      ok = i >= 0 && i < src_cap;
      if (ivalid != nullptr) ok = ok && j < n_ivalid && ivalid[j];
    }
    for (int c = 0; c < C; ++c) {
      const bool v = ok && reinterpret_cast<const bool*>(src_valid[c])[i];
      reinterpret_cast<bool*>(dst_valid[c])[j] = v;
      void* dst = reinterpret_cast<void*>(dst_data[c]);
      const int w = (int)width[c];
      if (v)
        copy_elem(reinterpret_cast<const void*>(src_data[c]), i, dst, j, w);
      else
        zero_elem(dst, j, w);
    }
  }
}

// K46's table, int64 words, for P slices and C columns:
//   out   [P + 1]  first output lane of each slice (the last word: rows)
//   order [P]      int32* route order of each slice's map batch
//   start [P]      the slice's first position in its order
//   src_data [P * C], src_valid [P * C]  column c of slice p at p * C + c
//   dst_data [C], dst_valid [C], width [C]
__global__ void assemble_routed_kernel(const long long* __restrict__ table,
                                       int P, int C, long long cap_out) {
  const long long* out = table;
  const long long* order = out + P + 1;
  const long long* start = order + P;
  const long long* src_data = start + P;
  const long long* src_valid = src_data + (long long)P * C;
  const long long* dst_data = src_valid + (long long)P * C;
  const long long* dst_valid = dst_data + C;
  const long long* width = dst_valid + C;
  const long long total = out[P];
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap_out; j += (long long)gridDim.x * blockDim.x) {
    if (j >= total) {
      for (int c = 0; c < C; ++c) {
        reinterpret_cast<bool*>(dst_valid[c])[j] = false;
        zero_elem(reinterpret_cast<void*>(dst_data[c]), j, (int)width[c]);
      }
      continue;
    }
    int lo = 0, hi = P - 1;  // the last slice with out[p] <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (out[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const long long r = reinterpret_cast<const int32_t*>(order[lo])
        [start[lo] + (j - out[lo])];
    for (int c = 0; c < C; ++c) {
      const long long k = (long long)lo * C + c;
      const bool v = reinterpret_cast<const bool*>(src_valid[k])[r];
      reinterpret_cast<bool*>(dst_valid[c])[j] = v;
      void* dst = reinterpret_cast<void*>(dst_data[c]);
      const int w = (int)width[c];
      if (v)
        copy_elem(reinterpret_cast<const void*>(src_data[k]), r, dst, j, w);
      else
        zero_elem(dst, j, w);
    }
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)std::max<long long>(
      1, std::min<long long>(ceil_div(n, kThreads), 65536));
}

}  // namespace
}  // namespace srt

using namespace srt;

// bytes of scratch K31 needs for `ntiles` tiles
SRT_API size_t srt_compact_scratch_bytes(long long ntiles) {
  Carver c{nullptr, 0};
  c.take<uint32_t>(ntiles);
  c.take<uint32_t>(ntiles);
  c.take<uint32_t>(scan_scratch_elems(ntiles));
  return c.used;
}

// table: K31's table on the card (see CompactTable) for P pieces and C
// columns; ntiles = table's tile_base[P]; out columns of cap_out lanes;
// count_out int32 [1].
SRT_API int srt_compact_fixed(const long long* table, int P, int C,
                              long long ntiles, long long cap_out,
                              int32_t* count_out, void* scratch,
                              size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || C < 0 || ntiles < 0 || cap_out < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  Carver c{static_cast<char*>(scratch), 0};
  uint32_t* counts = c.take<uint32_t>(ntiles);
  uint32_t* incl = c.take<uint32_t>(ntiles);
  uint32_t* scan_scratch = c.take<uint32_t>(scan_scratch_elems(ntiles));
  if (c.used > scratch_bytes) return fail(cudaErrorInvalidValue, "scratch");
  if (ntiles > 0) {
    compact_count_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(table, P, C,
                                                                counts);
    SRT_LAUNCHED("compact_count_kernel");
    SRT_TRY(scan_u32(counts, incl, ntiles, scan_scratch, nullptr, true, st));
  }
  const long long blocks = std::max<long long>(
      std::max<long long>(ntiles, 1),
      std::min<long long>(ceil_div(cap_out, kThreads), 1024));
  compact_scatter_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      table, P, C, ntiles, incl, cap_out, count_out);
  SRT_LAUNCHED("compact_scatter_kernel");
  return 0;
}

// table: K32's table on the card for C columns; idx: n_idx int32 or int64
// (idx_bytes 4 or 8) indices; ivalid: n_ivalid bools or null; outputs of
// cap lanes.
SRT_API int srt_gather_fixed(const long long* table, int C, const void* idx,
                             int idx_bytes, long long n_idx,
                             const bool* ivalid, long long n_ivalid,
                             long long out_rows, long long src_cap,
                             long long cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 0 || (idx_bytes != 4 && idx_bytes != 8) || cap < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  if (cap == 0 || C == 0) return 0;
  gather_fixed_kernel<<<grid_for(cap), kThreads, 0, st>>>(
      table, C, idx, idx_bytes, n_idx, ivalid, n_ivalid, out_rows, src_cap,
      cap);
  SRT_LAUNCHED("gather_fixed_kernel");
  return 0;
}

// K46: table as assemble_routed_kernel reads it for P slices and C fixed
// columns; outputs of cap_out lanes.
SRT_API int srt_assemble_routed_fixed(const long long* table, int P, int C,
                                      long long cap_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || C < 0 || cap_out < 0)
    return fail(cudaErrorInvalidValue, "arguments");
  if (cap_out == 0 || C == 0) return 0;
  assemble_routed_kernel<<<grid_for(cap_out), kThreads, 0, st>>>(
      table, P, C, cap_out);
  SRT_LAUNCHED("assemble_routed_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
