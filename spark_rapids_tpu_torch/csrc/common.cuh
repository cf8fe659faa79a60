// Shared building blocks of the port's hand-written kernels (sm_90a).
//
// - a device-wide uint32 scan (tile scan with cub::BlockScan, a recursive
//   scan of the tile totals, then an add of the tile offsets);
// - one stable 8-bit radix pass: a per-tile digit histogram, an exclusive
//   scan of the histogram in digit-major order (digit d of tile t lands at
//   d * num_tiles + t, which keeps equal digits in tile order), and a
//   scatter that ranks equal digits inside a tile with __match_any_sync.
//
// Errors: every launch (and every async memset) is followed by
// SRT_LAUNCHED("stage"), which reads cudaGetLastError and on an error
// records the stage and returns the code from the enclosing function, so
// srt_error_string names the launch that failed. A helper that launches
// returns cudaError_t and its caller passes an error on with SRT_TRY.
//
// Civil dates (`days_from_civil`, `civil_from_days`, `civil_round_trip`):
// the proleptic Gregorian calendar in epoch days with floor divisions, as
// ops/datetimeops.py computes it; shared by the CSV date parse (K35), the
// date / timestamp formats (K41) and the timestamp cast parse (K44).
//
// Every kernel takes an optional `active` flag in device memory: when it
// holds 0 the kernel returns at once. The radix sort computes those flags
// on the card, so a pass whose digit is the same for every row costs a few
// empty launches and no host round trip.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#define SRT_API extern "C" __attribute__((visibility("default")))

#define SRT_CALL(call, stage)                              \
  do {                                                     \
    const cudaError_t srt_err_ = (call);                   \
    if (srt_err_ != cudaSuccess)                           \
      return ::srt::fail(srt_err_, stage);                 \
  } while (0)
#define SRT_LAUNCHED(stage) SRT_CALL(cudaGetLastError(), stage)
#define SRT_TRY(call)                                      \
  do {                                                     \
    const cudaError_t srt_err_ = (call);                   \
    if (srt_err_ != cudaSuccess) return srt_err_;          \
  } while (0)

namespace srt {

// The stage of the last failed call on this thread.
inline const char*& failed_stage() {
  static thread_local const char* stage = "";
  return stage;
}

inline cudaError_t fail(cudaError_t code, const char* stage) {
  failed_stage() = stage;
  return code;
}

// "stage: CUDA's message" for the code an entry point returned.
inline const char* error_string(int code) {
  static thread_local char buf[256];
  snprintf(buf, sizeof buf, "%s: %s", failed_stage(),
           cudaGetErrorString(static_cast<cudaError_t>(code)));
  return buf;
}

constexpr int kThreads = 256;            // threads per block
constexpr int kItems = 16;               // rows per thread in a tile
constexpr int kTile = kThreads * kItems; // 4096 rows per block tile
constexpr int kRadix = 256;              // 8-bit digits
constexpr int kWarps = kThreads / 32;

static_assert(kThreads == kRadix, "the scatter gives one digit per thread");

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

inline size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// Carves aligned sub-buffers out of one scratch allocation.
struct Carver {
  char* base;
  size_t used;
  template <typename T>
  T* take(long long count) {
    T* p = reinterpret_cast<T*>(base == nullptr ? nullptr : base + used);
    used = align_up(used + sizeof(T) * (size_t)(count > 0 ? count : 1));
    return p;
  }
};

__device__ __forceinline__ bool inactive(const int* active) {
  return active != nullptr && *active == 0;
}

// ---------------------------------------------------------- civil dates
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// the same in 32 bits: the card divides 32-bit integers by a constant in
// a few instructions and 64-bit ones in tens, so the calendar takes the
// 32-bit form wherever its values fit (the results are the same)
template <typename T>
__device__ __forceinline__ T floor_div_t(T a, T b) {
  T q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename T>
__device__ __forceinline__ T days_from_civil_t(T y, T m, T d) {
  y -= m <= 2 ? 1 : 0;
  const T era = floor_div_t<T>(y, 400);
  const T yoe = y - era * 400;
  const T mp = m > 2 ? m - 3 : m + 9;
  const T doy = floor_div_t<T>(153 * mp + 2, 5) + d - 1;
  const T doe =
      yoe * 365 + floor_div_t<T>(yoe, 4) - floor_div_t<T>(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

template <typename T>
__device__ __forceinline__ void civil_from_days_t(T days, T* y, T* m,
                                                  T* d) {
  const T z = days + 719468;
  const T era = floor_div_t<T>(z, 146097);
  const T doe = z - era * 146097;
  const T yoe = floor_div_t<T>(doe - floor_div_t<T>(doe, 1460) +
                                   floor_div_t<T>(doe, 36524) -
                                   floor_div_t<T>(doe, 146096),
                               365);
  const T doy =
      doe - (365 * yoe + floor_div_t<T>(yoe, 4) - floor_div_t<T>(yoe, 100));
  const T mp = floor_div_t<T>(5 * doy + 2, 153);
  *d = doy - floor_div_t<T>(153 * mp + 2, 5) + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}

// 32 bits hold every value of the calendar while |days| <= 2e9 (z, era *
// 146097 and the year stay inside int32), and of its inverse while the
// year, month and day are within 2^20 (as digits parsed from text are)
__device__ __forceinline__ long long days_from_civil(long long y,
                                                     long long m,
                                                     long long d) {
  const long long lim = 1LL << 20;
  if (y > -lim && y < lim && m > -lim && m < lim && d > -lim && d < lim)
    return days_from_civil_t<int>((int)y, (int)m, (int)d);
  return days_from_civil_t<long long>(y, m, d);
}

__device__ __forceinline__ void civil_from_days(long long days, long long* y,
                                                long long* m, long long* d) {
  if (days >= -2000000000LL && days <= 2000000000LL) {
    int yi, mi, di;
    civil_from_days_t<int>((int)days, &yi, &mi, &di);
    *y = yi;
    *m = mi;
    *d = di;
    return;
  }
  civil_from_days_t<long long>(days, y, m, d);
}

// the date (y, m, d) is a real one: its epoch days map back to it
__device__ __forceinline__ bool civil_round_trip(long long days, long long y,
                                                 long long m, long long d) {
  long long ry, rm, rd;
  civil_from_days(days, &ry, &rm, &rd);
  return ry == y && rm == m && rd == d;
}

// ---------------------------------------------------------------- scan
__global__ void scan_tiles_kernel(const uint32_t* __restrict__ in,
                                  uint32_t* __restrict__ out, long long m,
                                  uint32_t* __restrict__ tile_sums,
                                  const int* __restrict__ active,
                                  int inclusive) {
  if (inactive(active)) return;
  using BlockScan = cub::BlockScan<uint32_t, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  uint32_t v[kItems];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    v[i] = idx < m ? in[idx] : 0u;
    sum += v[i];
  }
  uint32_t prefix = 0, total = 0;
  BlockScan(tmp).ExclusiveSum(sum, prefix, total);
  uint32_t run = prefix;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = base + i;
    if (inclusive) run += v[i];
    if (idx < m) out[idx] = run;
    if (!inclusive) run += v[i];
  }
  if (tile_sums != nullptr && threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void add_tile_offsets_kernel(uint32_t* __restrict__ out,
                                        long long m,
                                        const uint32_t* __restrict__ offs,
                                        const int* __restrict__ active) {
  if (inactive(active)) return;
  const uint32_t add = offs[blockIdx.x];
  const long long base = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long idx = base + i;
    if (idx < m) out[idx] += add;
  }
}

// uint32 elements of scratch that scan_u32 needs for m inputs
inline long long scan_scratch_elems(long long m) {
  const long long nb = ceil_div(m, kTile);
  if (nb <= 1) return 0;
  return 2 * nb + scan_scratch_elems(nb);
}

// out = exclusive (or inclusive) prefix sum of in[0, m); in and out must not
// alias. Launch-only: nothing here waits for the card.
inline cudaError_t scan_u32(const uint32_t* in, uint32_t* out, long long m,
                            uint32_t* scratch, const int* active,
                            bool inclusive, cudaStream_t s) {
  if (m <= 0) return cudaSuccess;
  const long long nb = ceil_div(m, kTile);
  scan_tiles_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
      in, out, m, nb > 1 ? scratch : nullptr, active, inclusive ? 1 : 0);
  SRT_LAUNCHED("scan_tiles_kernel");
  if (nb > 1) {
    SRT_TRY(scan_u32(scratch, scratch + nb, nb, scratch + 2 * nb, active,
                     false, s));
    add_tile_offsets_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
        out, m, scratch + nb, active);
    SRT_LAUNCHED("add_tile_offsets_kernel");
  }
  return cudaSuccess;
}

// ---------------------------------------------------------- radix pass
// Source/destination of one pass. With a `state` flag in device memory the
// kernels pick side state[0] as the source and the other as destination,
// so a pass can be skipped on the card without the host knowing.
struct PingPong {
  const uint32_t* keys_in[2];
  const int32_t* vals_in[2];   // nullptr: the payload is the row index
  uint32_t* keys_out[2];       // nullptr: keys are not written
  int32_t* vals_out[2];
};

__device__ __forceinline__ int src_side(const int* state) {
  return state == nullptr ? 0 : state[0];
}

__global__ void radix_hist_kernel(PingPong pp, long long n, int shift,
                                  uint32_t* __restrict__ counts,
                                  long long num_tiles,
                                  const int* __restrict__ active,
                                  const int* __restrict__ state) {
  if (inactive(active)) return;
  const uint32_t* keys = pp.keys_in[src_side(state)];
  __shared__ uint32_t h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
    const long long idx = base + (long long)k * kThreads + threadIdx.x;
    if (idx < n) atomicAdd(&h[(keys[idx] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  counts[(long long)threadIdx.x * num_tiles + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter of one tile: rows are taken 256 at a time in index order;
// inside a warp equal digits are ranked by lane (__match_any_sync), across
// the warps of a round by a per-digit prefix over warps, across rounds by a
// running per-digit count, across tiles by the digit-major offsets.
__global__ void radix_scatter_kernel(PingPong pp, long long n, int shift,
                                     const uint32_t* __restrict__ offsets,
                                     long long num_tiles,
                                     const int* __restrict__ active,
                                     const int* __restrict__ state) {
  if (inactive(active)) return;
  const int src = src_side(state);
  const int dst = 1 - src;
  const uint32_t* keys_in = pp.keys_in[src];
  const int32_t* vals_in = pp.vals_in[src];
  uint32_t* keys_out = pp.keys_out[dst];
  int32_t* vals_out = pp.vals_out[dst];

  __shared__ uint32_t wcnt[kWarps][kRadix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t run = offsets[(long long)tid * num_tiles + blockIdx.x];
  const long long base = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
    __syncthreads();
    const long long idx = base + (long long)k * kThreads + tid;
    const bool ok = idx < n;
    uint32_t key = 0;
    int32_t val = 0;
    uint32_t d = 0x100u;  // never equal to a real digit
    if (ok) {
      key = keys_in[idx];
      val = vals_in != nullptr ? vals_in[idx] : (int32_t)idx;
      d = (key >> shift) & 0xFFu;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ok && rank == 0) wcnt[warp][d] = (uint32_t)__popc(peers);
    __syncthreads();
    // thread tid owns digit tid: exclusive prefix over the warps of this
    // round, starting from the digit's running offset
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = wcnt[w][tid];
      wcnt[w][tid] = run;
      run += c;
    }
    __syncthreads();
    if (ok) {
      const uint32_t pos = wcnt[warp][d] + (uint32_t)rank;
      if (keys_out != nullptr) keys_out[pos] = key;
      vals_out[pos] = val;
    }
    __syncthreads();
  }
}

// bytes of scratch one radix pass over n keys needs (histogram + offsets +
// their scan)
inline long long radix_pass_tiles(long long n) { return ceil_div(n, kTile); }

// One stable pass: histogram, digit-major exclusive scan, scatter.
inline cudaError_t radix_pass(const PingPong& pp, long long n, int shift,
                              uint32_t* counts, uint32_t* offsets,
                              uint32_t* scan_scratch, const int* active,
                              const int* state, cudaStream_t s) {
  const long long tiles = radix_pass_tiles(n);
  radix_hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      pp, n, shift, counts, tiles, active, state);
  SRT_LAUNCHED("radix_hist_kernel");
  SRT_TRY(scan_u32(counts, offsets, (long long)kRadix * tiles, scan_scratch,
                   active, false, s));
  radix_scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      pp, n, shift, offsets, tiles, active, state);
  SRT_LAUNCHED("radix_scatter_kernel");
  return cudaSuccess;
}

}  // namespace srt
