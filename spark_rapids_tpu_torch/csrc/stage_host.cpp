// Host harness of K48's op semantics: csrc/stage_ops.cuh built by g++
// (-ffp-contract=off, no CUDA), running a stage program row by row over
// host columns exactly as the kernel runs it over device columns. The CPU
// tests (tests/test_torch_stage_program.py) hold it bit for bit against
// the plain interpreter of ops/program.py; that test module builds it
// into build/stage_host/.
#include <vector>

#include "stage_ops.cuh"

extern "C" int srt_stage_program_host(
    const long long* prog, int n_instr, int n_regs, const long long* in_data,
    const long long* in_valid, const long long* in_kind,
    const long long* out_data, const long long* out_valid,
    const long long* out_kind, long long capacity, long long n_rows,
    unsigned char* keep) {
  std::vector<uint64_t> v(n_regs > 0 ? n_regs : 1);
  std::vector<uint8_t> ok(n_regs > 0 ? n_regs : 1);
  srt_stage::Regs R{v.data(), ok.data(), 1};
  const srt_stage::Cols in{in_data, in_valid, in_kind};
  const srt_stage::Cols out{out_data, out_valid, out_kind};
  for (long long row = 0; row < capacity; ++row)
    srt_stage::run_row(prog, n_instr, R, row, row < n_rows, in, out, keep);
  return 0;
}
