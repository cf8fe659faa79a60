// K2 group_ids: dense group ids from the group-sort permutation.
//
// Replaces spark_rapids_tpu/exec/rowkeys.py:group_ids_masked with
// _neighbor_differs: a sorted position starts a group where any key word
// (null flags included) differs from the previous sorted row; an inclusive
// scan of those flags numbers the groups; the results are gid (per original
// row, pads -> capacity), gid_sorted (per sorted position), rep_rows (first
// member of each group), seg_ends (last sorted position of each group) and
// num_groups. Slots at or above num_groups of rep_rows/seg_ends are 0.
//
// Bound: memory. Per row it reads order, the valid flag and every key word
// of two rows (a random gather through order), and writes four int32
// outputs.
//
// Design: one kernel writes the boundary flags, the shared device-wide scan
// numbers them (a per-tile count, a scan of the tile counts, the add), and
// one kernel writes all outputs. Valid rows sort before pads, so the
// previous row of a valid row is always valid.
#include "common.cuh"

namespace srt {
namespace {

__global__ void boundary_kernel(const uint32_t* __restrict__ words,
                                int n_words, long long n,
                                const int32_t* __restrict__ order,
                                const uint8_t* __restrict__ valid,
                                uint32_t* __restrict__ flags) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int32_t r = order[i];
    uint32_t b = 0u;
    if (valid[r]) {
      if (i == 0) {
        b = 1u;
      } else {
        const int32_t p = order[i - 1];
        for (int w = 0; w < n_words; ++w) {
          const uint32_t* word = words + (long long)w * n;
          if (word[r] != word[p]) {
            b = 1u;
            break;
          }
        }
      }
    }
    flags[i] = b;
  }
}

__global__ void write_kernel(long long n, const int32_t* __restrict__ order,
                             const uint8_t* __restrict__ valid,
                             const uint32_t* __restrict__ flags,
                             const uint32_t* __restrict__ incl,
                             int32_t* __restrict__ gid,
                             int32_t* __restrict__ gid_sorted,
                             int32_t* __restrict__ rep_rows,
                             int32_t* __restrict__ seg_ends,
                             int32_t* __restrict__ num_groups) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int32_t r = order[i];
    const bool v = valid[r] != 0;
    const int32_t g = v ? (int32_t)incl[i] - 1 : (int32_t)n;
    gid_sorted[i] = g;
    gid[r] = g;
    if (v) {
      if (flags[i]) rep_rows[g] = r;
      const bool end = (i == n - 1) || !valid[order[i + 1]] || flags[i + 1];
      if (end) seg_ends[g] = (int32_t)i;
    }
    if (i == n - 1) num_groups[0] = (int32_t)incl[i];
  }
}

struct GidScratch {
  uint32_t* flags;
  uint32_t* incl;
  uint32_t* scan;
};

size_t carve(void* base, long long n, GidScratch* s) {
  Carver c{static_cast<char*>(base), 0};
  s->flags = c.take<uint32_t>(n);
  s->incl = c.take<uint32_t>(n);
  s->scan = c.take<uint32_t>(scan_scratch_elems(n));
  return c.used;
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API size_t srt_group_ids_scratch_bytes(long long n) {
  GidScratch s;
  return carve(nullptr, n, &s);
}

// words: [n_words][n] uint32 key words (the sort's input); order: the sort
// permutation; valid: uint8 [n] row-validity mask in original row order.
SRT_API int srt_group_ids(const uint32_t* words, int n_words, long long n,
                          const int32_t* order, const uint8_t* valid,
                          int32_t* gid, int32_t* gid_sorted,
                          int32_t* rep_rows, int32_t* seg_ends,
                          int32_t* num_groups, void* scratch,
                          size_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n > 0x7FFFFFFFLL) return fail(cudaErrorInvalidValue, "arguments");
  GidScratch s;
  if (carve(scratch, n, &s) > scratch_bytes)
    return fail(cudaErrorInvalidValue, "scratch size");
  const long long blocks = ceil_div(n, kThreads);
  const unsigned grid = (unsigned)(blocks < 8192 ? blocks : 8192);
  SRT_CALL(cudaMemsetAsync(rep_rows, 0, sizeof(int32_t) * (size_t)n, st),
           "memset rep_rows");
  SRT_CALL(cudaMemsetAsync(seg_ends, 0, sizeof(int32_t) * (size_t)n, st),
           "memset seg_ends");
  boundary_kernel<<<grid, kThreads, 0, st>>>(words, n_words, n, order, valid,
                                             s.flags);
  SRT_LAUNCHED("boundary_kernel");
  SRT_TRY(scan_u32(s.flags, s.incl, n, s.scan, nullptr, true, st));
  write_kernel<<<grid, kThreads, 0, st>>>(n, order, valid, s.flags, s.incl,
                                          gid, gid_sorted, rep_rows, seg_ends,
                                          num_groups);
  SRT_LAUNCHED("write_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
