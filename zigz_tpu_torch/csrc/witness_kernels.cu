// Kernel W1: the eleven non-register rows of the v1 witness, with the
// reduced write value and write index that the register forward fill reads,
// built on the card from the native VM's trace columns as they lie, bound to
// Python through ctypes (ops/witness_dev.py ``witness_rows``).
//
// W1 stands for the non-register rows of zigz_tpu/ops/witness_dev.py
// ``_build_witness_jit`` (jnp, no pl.pallas_call), and makes the JAX
// package's host ``pack_trace_columns`` unnecessary: the host no longer pads,
// splits into u32 halves, masks or casts the columns; it copies them as the
// VM wrote them, num_steps entries each, and W1 does all of that in one pass.
//
// Bound by bytes: 48 bytes read a step (5 u64 and 8 u8 columns) and 49 (u32
// words: 11 rows, the write value, the write index) or 97 (u64 words)
// written a step of the padded trace, against a handful of integer
// operations a value (field64.cuh ``from_u64``, or Barrett's reduction for a
// field below 2^31; witness.cuh).  Each thread takes 4 neighbouring steps,
// so every load and store of a warp is whole 16-byte (u64 columns and the
// rows) or 4-byte (u8 columns) words at neighbouring addresses.
//
// The launcher takes two host arrays of device pointers (the 5 u64 columns
// pc, imm, reg_write_val, mem_addr, mem_val; the 8 u8 columns opcode, rd,
// rs1, rs2, funct3, funct7, reg_write_idx, mem_flag), the real steps, the
// padded width n, the trace's last pc, the modulus, the outputs and the CUDA
// stream.  It launches on that stream without synchronising, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// modulus that is not a field's, n_real outside [0, n], a grid past
// grid.x's limit, or a column or output that is not aligned for the vector
// loads and stores) so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "witness.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int64_t kMaxBlocksX = 2147483647;  // gridDim.x limit

template <class R>
__global__ void __launch_bounds__(kThreadsPerBlock)
witness_rows_kernel(const zigz_witness::Columns c, const zigz_witness::Outputs<typename R::Word> o, const R f,
                    int64_t n_real, int64_t n, uint64_t last_pc) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g * zigz_witness::kSteps >= n) return;
  zigz_witness::witness_steps(c, o, f, g, n_real, n, last_pc);
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

int zigz_witness_rows(const void* const* u64_cols, const void* const* u8_cols, int64_t n_real, int64_t n,
                      uint64_t last_pc, uint64_t p, void* rows, void* wr_val, void* wr_idx, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + zigz_witness::kSteps * kThreadsPerBlock - 1) / (zigz_witness::kSteps * kThreadsPerBlock);
  bool ok = n_real >= 0 && n_real <= n && blocks <= kMaxBlocksX && aligned(rows, 16) && aligned(wr_val, 16) &&
            aligned(wr_idx, 4);
  for (int j = 0; j < zigz_witness::kU64Columns; ++j) ok = ok && aligned(u64_cols[j], 16);
  for (int j = 0; j < zigz_witness::kU8Columns; ++j) ok = ok && aligned(u8_cols[j], 4);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const zigz_witness::Columns c = zigz_witness::make_columns(u64_cols, u8_cols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = zigz_witness::with_field(p, [&](auto f) {
    using R = decltype(f);
    using W = typename R::Word;
    const zigz_witness::Outputs<W> o{static_cast<W*>(rows), static_cast<W*>(wr_val), static_cast<uint8_t*>(wr_idx)};
    witness_rows_kernel<R><<<static_cast<unsigned int>(blocks), kThreadsPerBlock, 0, s>>>(c, o, f, n_real, n,
                                                                                           last_pc);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
