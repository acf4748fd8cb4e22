// Kernel E1: the LSB fold of a batch of multilinear extensions over a
// 64-bit field, bound to Python through ctypes (ops/field64.py).
//
// E1 -- no TPU kernel to replace: zigz_tpu evaluates the v1 openings of a
// field of 2^31 and above with object-dtype integers on the host
// (zigz_tpu/poly/multilinear.py:45,53), and below 2^31 with the jnp
// _batch_eval_lsb_jit (zigz_tpu/ops/mle.py:98), no pl.pallas_call.
//
// One thread an output, one launch a variable: row b of a (B, 2 n_out)
// canonical u64 matrix folds by its challenge r[b] into row b of
// (B, n_out), out[b, k] = e[b, 2k] + r[b] (e[b, 2k+1] - e[b, 2k]) mod p,
// the field picked by the launcher (one instantiation each, field64.cuh).
// The pair (2k, 2k+1) is one 16-byte load; grid.y is the row, so no
// thread divides.
//
// Bound by bytes: 16 read and 8 written an output against one 64 x 64-bit
// product and its reduction (a few dozen instructions).  Folding the last
// levels of a row inside one block, in shared memory, is later work.
//
// The launcher takes device pointers, the shape, the modulus and the CUDA
// stream, launches on that stream without synchronising, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a modulus
// that is neither field's, a row count past grid.y's limit or a misaligned
// input) so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "field64.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int64_t kMaxRows = 65535;          // gridDim.y limit
constexpr int64_t kMaxBlocksX = 2147483647;  // gridDim.x limit

template <class F>
__global__ void __launch_bounds__(kThreadsPerBlock)
mle_fold_u64_kernel(const ulonglong2* __restrict__ in, const uint64_t* __restrict__ r,
                    uint64_t* __restrict__ out, int64_t n_out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n_out) return;  // ragged tail of the row's last block
  const int64_t i = static_cast<int64_t>(blockIdx.y) * n_out + k;
  const ulonglong2 e = in[i];  // e[b, 2k], e[b, 2k + 1]
  out[i] = zigz64::fold_value<F>(e.x, e.y, r[blockIdx.y]);
}

template <class F>
void launch(const void* in, const void* r, void* out, int64_t rows, int64_t n_out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((n_out + kThreadsPerBlock - 1) / kThreadsPerBlock),
                  static_cast<unsigned int>(rows));
  mle_fold_u64_kernel<F><<<grid, kThreadsPerBlock, 0, stream>>>(
      static_cast<const ulonglong2*>(in), static_cast<const uint64_t*>(r), static_cast<uint64_t*>(out), n_out);
}

}  // namespace

extern "C" {

int zigz_mle_fold_u64(const void* in, const void* r, void* out, int64_t rows, int64_t n_out, uint64_t p,
                      void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (rows > kMaxRows || (n_out + kThreadsPerBlock - 1) / kThreadsPerBlock > kMaxBlocksX ||
      reinterpret_cast<uintptr_t>(in) % alignof(ulonglong2) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == zigz64::Goldilocks::kP) {
    launch<zigz64::Goldilocks>(in, r, out, rows, n_out, s);
  } else if (p == zigz64::Mersenne61::kP) {
    launch<zigz64::Mersenne61>(in, r, out, rows, n_out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
