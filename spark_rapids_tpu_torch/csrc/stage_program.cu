// K48 stage_program: one batch through a whole stage program in one
// launch (replaces B6, spark_rapids_tpu/ops/eval.py:DeviceProjector :130
// and DeviceFilter :282, and exec/fused.py:TpuFusedStageExec's program
// :298-359, which the reference traces into one jitted XLA program per
// expression list or fused stage).
//
// ops/program.py compiles a stage (a filter's condition, a projection
// list, the folded filters / keys / inputs of an aggregate's update, or a
// Filter / Project / Expand chain) into a flat list of typed register
// instructions; csrc/stage_ops.cuh holds the per-op semantics. One
// precompiled kernel interprets every program, so a new stage costs no
// build: literals are immediates in the program, never in the kernel.
//
// A thread runs the program for one row. Its registers live in shared
// memory, value words at regs[r * kTileRows + tid] and validity bytes
// after them, so threads never share a register and no __syncthreads is
// needed inside the program. Every row runs the same program, so the op
// dispatch (a switch on the instruction's op) is warp-uniform. The
// program sits in global memory, read by every thread of a warp at one
// address (a broadcast through L1).
//
// Columns come in by value (device pointers and element types, at most
// kMaxCols inputs and kMaxCols outputs) and are copied to shared memory at
// block start. A program holds at most kMaxRegs registers; ops/program.py
// splits a stage into programs within both limits. The row count is a
// host value or an int32 / int64 on the card (a filter's count that was
// never synced).
//
// Bound: memory. A launch reads each input column's data and validity
// once and writes each output column and the keep mask once; the
// register traffic stays in shared memory.
#include <mutex>

#include "common.cuh"
#include "stage_ops.cuh"

namespace srt {
namespace {

constexpr int kTileRows = 128;  // rows (threads) a block
constexpr int kMaxCols = 64;  // keeps the by-value table under 4 KiB
// a register takes 9 bytes of shared memory for each of a block's rows;
// 192 of them (216 KiB) and the 3 KiB column table stay under the
// 227 KiB a block may opt in to on sm_90
constexpr int kMaxRegs = 192;
constexpr int kMaxDevices = 64;

struct LaunchCols {
  long long in_data[kMaxCols];
  long long in_valid[kMaxCols];
  long long in_kind[kMaxCols];
  long long out_data[kMaxCols];
  long long out_valid[kMaxCols];
  long long out_kind[kMaxCols];
};

__global__ void stage_program_kernel(const long long* __restrict__ prog,
                                     int n_instr, int n_regs, int n_in,
                                     int n_out, const LaunchCols cols,
                                     long long capacity,
                                     const void* rows_dev, int rows_dev_i64,
                                     long long rows_host,
                                     uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_cols[6 * kMaxCols];
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    s_cols[i] = cols.in_data[i];
    s_cols[kMaxCols + i] = cols.in_valid[i];
    s_cols[2 * kMaxCols + i] = cols.in_kind[i];
  }
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    s_cols[3 * kMaxCols + i] = cols.out_data[i];
    s_cols[4 * kMaxCols + i] = cols.out_valid[i];
    s_cols[5 * kMaxCols + i] = cols.out_kind[i];
  }
  __syncthreads();
  const long long row = (long long)blockIdx.x * kTileRows + threadIdx.x;
  if (row >= capacity) return;
  long long n_rows = rows_host;
  if (rows_dev != nullptr)
    n_rows = rows_dev_i64 ? *(const long long*)rows_dev
                          : (long long)*(const int*)rows_dev;
  srt_stage::Regs R;
  R.v = reinterpret_cast<uint64_t*>(smem) + threadIdx.x;
  R.n = smem + sizeof(uint64_t) * (size_t)n_regs * kTileRows + threadIdx.x;
  R.stride = kTileRows;
  const srt_stage::Cols in{s_cols, s_cols + kMaxCols, s_cols + 2 * kMaxCols};
  const srt_stage::Cols out{s_cols + 3 * kMaxCols, s_cols + 4 * kMaxCols,
                            s_cols + 5 * kMaxCols};
  srt_stage::run_row(prog, n_instr, R, row, row < n_rows, in, out, keep);
}

}  // namespace
}  // namespace srt

using namespace srt;

SRT_API int srt_stage_program_max_cols() { return kMaxCols; }
SRT_API int srt_stage_program_max_regs() { return kMaxRegs; }


// prog: n_instr x 7 int64 words on the card. in_* / out_*: host arrays of
// n_in / n_out device pointers and type codes (a null validity pointer
// reads as all valid). keep: a bool [capacity] on the card, or null when
// the program keeps nothing.
SRT_API int srt_stage_program(const long long* prog, int n_instr,
                              int n_regs, const long long* in_data,
                              const long long* in_valid,
                              const long long* in_kind, int n_in,
                              const long long* out_data,
                              const long long* out_valid,
                              const long long* out_kind, int n_out,
                              long long capacity, const void* rows_dev,
                              int rows_dev_i64, long long rows_host,
                              void* keep, void* stream) {
  if (n_in > kMaxCols || n_out > kMaxCols || n_regs > kMaxRegs)
    return (int)cudaErrorInvalidValue;
  if (capacity <= 0) return 0;
  LaunchCols cols;
  for (int i = 0; i < n_in; ++i) {
    cols.in_data[i] = in_data[i];
    cols.in_valid[i] = in_valid[i];
    cols.in_kind[i] = in_kind[i];
  }
  for (int i = 0; i < n_out; ++i) {
    cols.out_data[i] = out_data[i];
    cols.out_valid[i] = out_valid[i];
    cols.out_kind[i] = out_kind[i];
  }
  // a register a thread: its value word and its validity byte
  const size_t smem =
      (sizeof(uint64_t) + 1) * (size_t)(n_regs > 0 ? n_regs : 1) * kTileRows;
  if (smem > 48 * 1024) {
    // the opt-in is an attribute of the kernel on each device: raise it
    // on this one when a program needs more than it was given
    int dev = 0;
    SRT_CALL(cudaGetDevice(&dev), "stage_program device");
    static std::mutex mu;
    static size_t smem_set[kMaxDevices] = {};
    std::lock_guard<std::mutex> lock(mu);
    if (dev >= kMaxDevices || smem > smem_set[dev]) {
      SRT_CALL(cudaFuncSetAttribute(
                   stage_program_kernel,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem),
               "stage_program smem");
      if (dev < kMaxDevices) smem_set[dev] = smem;
    }
  }
  const long long blocks = ceil_div(capacity, kTileRows);
  stage_program_kernel<<<(unsigned)blocks, kTileRows, smem,
                         (cudaStream_t)stream>>>(
      prog, n_instr, n_regs, n_in, n_out, cols, capacity, rows_dev,
      rows_dev_i64, rows_host, (uint8_t*)keep);
  SRT_LAUNCHED("stage_program");
  return 0;
}

SRT_API const char* srt_error_string(int code) { return error_string(code); }
