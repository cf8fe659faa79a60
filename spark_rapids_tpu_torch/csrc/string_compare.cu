// K8 string_compare: `l op r` for two string operands, row by row, with
// op one of =, <, <=, >, >= — the device string comparison behind
// c_mktsegment = 'BUILDING' and r_name = 'ASIA'.
//
// Replaces spark_rapids_tpu/columnar/strings.py:string_cmp3 (its
// lax.while_loop over 8-byte big-endian chunks), string_equal and
// string_compare. An operand is a view: a byte buffer plus per-row start
// and length (and validity); a literal is one span that every row aliases,
// passed with stride 0 so no per-row copy exists. Bytes compare unsigned,
// a prefix sorts before the longer string, and an empty string before any
// other. The result is false where either side is NULL (the expression's
// null propagation then marks the row NULL).
//
// Bound: memory. It reads each row's start, length and validity and the
// bytes up to the first difference once, and writes one byte a row.
//
// Design: one thread per row compares bytes until the first difference,
// then the lengths; equality stops at once when the lengths differ. This
// computes what the reference's chunk loop computes without carrying a
// result from chunk to chunk over the whole column. Neighbouring rows'
// bytes are neighbours in memory (or, for a literal, one cached line), so
// a warp's loads mostly share lines. A warp per row is the later step for
// long strings.
#include <algorithm>

#include "common.cuh"

namespace srt {
namespace {

struct View {
  const uint8_t* data;
  const int32_t* starts;
  long long s_stride;  // 0: one span aliased by every row
  const int32_t* lens;
  long long l_stride;
  const uint8_t* valid;
  long long v_stride;
};

enum { kEq = 0, kLt = 1, kLe = 2, kGt = 3, kGe = 4 };

__global__ void string_compare_kernel(View l, View r, long long n, int op,
                                      uint8_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!l.valid[i * l.v_stride] || !r.valid[i * r.v_stride]) {
      out[i] = 0;
      continue;
    }
    const int32_t ll = l.lens[i * l.l_stride];
    const int32_t rl = r.lens[i * r.l_stride];
    if (op == kEq && ll != rl) {
      out[i] = 0;
      continue;
    }
    const uint8_t* a = l.data + l.starts[i * l.s_stride];
    const uint8_t* b = r.data + r.starts[i * r.s_stride];
    const int32_t m = ll < rl ? ll : rl;
    int c = 0;
    for (int32_t k = 0; k < m; ++k) {
      const uint8_t x = a[k], y = b[k];
      if (x != y) {
        c = x < y ? -1 : 1;
        break;
      }
    }
    if (c == 0) c = ll < rl ? -1 : (ll > rl ? 1 : 0);
    bool res;
    switch (op) {
      case kEq: res = c == 0; break;
      case kLt: res = c < 0; break;
      case kLe: res = c <= 0; break;
      case kGt: res = c > 0; break;
      default: res = c >= 0; break;
    }
    out[i] = res ? 1 : 0;
  }
}

}  // namespace
}  // namespace srt

using namespace srt;

// Each side: bytes, starts (int32), lens (int32), validity (bool), each of
// the last three with a row stride of 1 (a column) or 0 (a literal).
// out: bool [n].
SRT_API int srt_string_compare(
    const uint8_t* l_data, const int32_t* l_starts, long long l_ss,
    const int32_t* l_lens, long long l_ls, const uint8_t* l_valid,
    long long l_vs, const uint8_t* r_data, const int32_t* r_starts,
    long long r_ss, const int32_t* r_lens, long long r_ls,
    const uint8_t* r_valid, long long r_vs, long long n, int op,
    uint8_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (op < kEq || op > kGe)
    return (int)fail(cudaErrorInvalidValue, "string_compare op");
  const View l{l_data, l_starts, l_ss, l_lens, l_ls, l_valid, l_vs};
  const View r{r_data, r_starts, r_ss, r_lens, r_ls, r_valid, r_vs};
  const long long blocks = std::min<long long>(ceil_div(n, kThreads), 65536);
  string_compare_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(l, r, n, op,
                                                                out);
  SRT_LAUNCHED("string_compare_kernel");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
