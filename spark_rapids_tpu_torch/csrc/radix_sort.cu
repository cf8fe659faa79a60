// K1 radix_sort_pairs: the stable lexicographic row permutation of the
// group-by sort.
//
// Replaces spark_rapids_tpu/exec/rowkeys.py:_multi_key_sort (one stable
// lax.sort over [pad flag, null flag, key proxy...] with a row-index
// payload, reached via group_sort_permutation_masked). The key proxies
// arrive as n_words uint32 words per row, most significant word first
// (exec/rowkeys.py:sort_words builds them).
//
// Bound: memory. Each active 8-bit pass reads every key and payload once
// for the histogram and once for the scatter and writes both once, 20
// bytes a row; the scatter's writes land in 256 runs per tile, so they
// coalesce poorly.
//
// Design: LSD radix sort, least significant word and digit first. A word's
// keys are gathered into sort order once (keys[i] = word[perm[i]]) and then
// carried along its four digit passes. Before the first pass one reduction
// ORs and ANDs every word over all rows; a digit whose bits agree in the OR
// and the AND is the same in every row, and its pass is skipped on the
// card (the active flags and the ping-pong side live in device memory), so
// an int64 key whose values fit a few bytes costs a few passes and no host
// round trip.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

__global__ void init_kernel(uint32_t* orand, int n_words, int* state) {
  const int w = threadIdx.x;
  if (w < n_words) {
    orand[2 * w] = 0u;             // OR accumulator
    orand[2 * w + 1] = 0xFFFFFFFFu;  // AND accumulator
  }
  if (w == 0) state[0] = 0;
}

__global__ void word_bits_kernel(const uint32_t* __restrict__ words,
                                 int n_words, long long n,
                                 uint32_t* __restrict__ orand) {
  for (int w = 0; w < n_words; ++w) {
    uint32_t o = 0u, a = 0xFFFFFFFFu;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
      const uint32_t x = words[(long long)w * n + i];
      o |= x;
      a &= x;
    }
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, off);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, off);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&orand[2 * w], o);
      atomicAnd(&orand[2 * w + 1], a);
    }
  }
}

// active[4 * w + b]: does byte b of word w differ between rows?
// word_active[w]: does any byte of word w?
__global__ void active_kernel(const uint32_t* __restrict__ orand, int n_words,
                              int* __restrict__ active,
                              int* __restrict__ word_active) {
  const int w = threadIdx.x;
  if (w >= n_words) return;
  const uint32_t diff = orand[2 * w] ^ orand[2 * w + 1];
  for (int b = 0; b < 4; ++b) active[4 * w + b] = ((diff >> (8 * b)) & 0xFFu) != 0;
  word_active[w] = diff != 0u;
}

__global__ void iota_kernel(int32_t* __restrict__ vals, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    vals[i] = (int32_t)i;
}

// keys[side][i] = word[vals[side][i]]: the next word in the current order
__global__ void gather_word_kernel(const uint32_t* __restrict__ word,
                                   PingPong pp, long long n,
                                   const int* __restrict__ word_active,
                                   const int* __restrict__ state) {
  if (*word_active == 0) return;
  const int side = state[0];
  const int32_t* vals = pp.vals_in[side];
  uint32_t* keys = const_cast<uint32_t*>(pp.keys_in[side]);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    keys[i] = word[vals[i]];
}

__global__ void flip_kernel(int* state, const int* active) {
  if (*active) state[0] ^= 1;
}

__global__ void copy_out_kernel(PingPong pp, long long n,
                                int32_t* __restrict__ perm,
                                const int* __restrict__ state) {
  const int32_t* vals = pp.vals_in[state[0]];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    perm[i] = vals[i];
}

struct SortScratch {
  uint32_t* keys[2];
  int32_t* vals[2];
  uint32_t* counts;
  uint32_t* offsets;
  uint32_t* scan;
  uint32_t* orand;
  int* active;
  int* word_active;
  int* state;
};

size_t carve(void* base, int n_words, long long n, SortScratch* s) {
  Carver c{static_cast<char*>(base), 0};
  const long long hist = (long long)kRadix * radix_pass_tiles(n);
  s->keys[0] = c.take<uint32_t>(n);
  s->keys[1] = c.take<uint32_t>(n);
  s->vals[0] = c.take<int32_t>(n);
  s->vals[1] = c.take<int32_t>(n);
  s->counts = c.take<uint32_t>(hist);
  s->offsets = c.take<uint32_t>(hist);
  s->scan = c.take<uint32_t>(scan_scratch_elems(hist));
  s->orand = c.take<uint32_t>(2 * n_words);
  s->active = c.take<int>(4 * n_words);
  s->word_active = c.take<int>(n_words);
  s->state = c.take<int>(1);
  return c.used;
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API size_t srt_radix_sort_scratch_bytes(int n_words, long long n) {
  SortScratch s;
  return carve(nullptr, n_words, n, &s);
}

// words: [n_words][n] uint32, most significant word first.
// perm_out: int32 [n], the stable lexicographic order of the rows.
SRT_API int srt_radix_sort_pairs(const uint32_t* words, int n_words,
                                 long long n, int32_t* perm_out,
                                 void* scratch, size_t scratch_bytes,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (n_words < 1 || n_words > 32 || n > 0x7FFFFFFFLL)
    return fail(cudaErrorInvalidValue, "arguments");
  SortScratch s;
  if (carve(scratch, n_words, n, &s) > scratch_bytes)
    return fail(cudaErrorInvalidValue, "scratch size");
  PingPong pp;
  for (int i = 0; i < 2; ++i) {
    pp.keys_in[i] = s.keys[i];
    pp.keys_out[i] = s.keys[i];
    pp.vals_in[i] = s.vals[i];
    pp.vals_out[i] = s.vals[i];
  }
  const unsigned grid = (unsigned)std::min<long long>(ceil_div(n, kThreads), 4096);
  init_kernel<<<1, 32, 0, st>>>(s.orand, n_words, s.state);
  SRT_LAUNCHED("init_kernel");
  word_bits_kernel<<<grid, kThreads, 0, st>>>(words, n_words, n, s.orand);
  SRT_LAUNCHED("word_bits_kernel");
  active_kernel<<<1, 32, 0, st>>>(s.orand, n_words, s.active, s.word_active);
  SRT_LAUNCHED("active_kernel");
  iota_kernel<<<grid, kThreads, 0, st>>>(s.vals[0], n);
  SRT_LAUNCHED("iota_kernel");
  for (int w = n_words - 1; w >= 0; --w) {
    gather_word_kernel<<<grid, kThreads, 0, st>>>(
        words + (long long)w * n, pp, n, s.word_active + w, s.state);
    SRT_LAUNCHED("gather_word_kernel");
    for (int b = 0; b < 4; ++b) {
      const int* act = s.active + 4 * w + b;
      SRT_TRY(radix_pass(pp, n, 8 * b, s.counts, s.offsets, s.scan, act,
                         s.state, st));
      flip_kernel<<<1, 1, 0, st>>>(s.state, act);
      SRT_LAUNCHED("flip_kernel");
    }
  }
  copy_out_kernel<<<grid, kThreads, 0, st>>>(pp, n, perm_out, s.state);
  SRT_LAUNCHED("copy_out_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
