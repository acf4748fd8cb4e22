// BabyBear multiply chain of the bench headline (bench_torch.py): eight
// dependent field multiplies per element, out[i] = x[i] * y[i]^8 mod p, one
// thread per element, bound to Python through ctypes.
//
// No TPU kernel: the JAX bench (bench.py:61) times an XLA-fused jnp chain of
// eight zigz_tpu/ops/babybear.py mont_mul, which splits each 32 x 32 product
// into 16-bit limbs because the TPU vector unit has no 64-bit multiply.
// Hopper has the 32 x 32 -> 64 multiply (IMAD.WIDE.U32), so each multiply
// here is one wide product and a Montgomery reduction in u32 registers.
//
// Montgomery without converting out: y is taken into Montgomery form once
// (REDC(y * R^2) = y * R), and REDC(v * yR) = v * y mod p leaves v
// canonical, so x never enters Montgomery form and the result needs no
// conversion back.
//
// Bound by integer instructions, not bytes: 12 bytes an element (x and y
// read, out written) against nine wide products and reductions.  The
// design keeps the chain in registers and adds nothing else; no tensor
// cores, no TMA.
//
// The launcher takes device pointers, the element count and the CUDA
// stream, launches on that stream without synchronising, allocates nothing,
// and returns cudaGetLastError() so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using zigz::kR2;
using zigz::redc;

constexpr int kThreadsPerBlock = 256;
constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x limit; past it the loop strides
constexpr int kChain = 8;

__global__ void __launch_bounds__(kThreadsPerBlock)
field_mul_chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                       uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t y_mont = redc(static_cast<uint64_t>(y[i]) * kR2);
    uint32_t v = x[i];
#pragma unroll
    for (int k = 0; k < kChain; ++k) v = redc(static_cast<uint64_t>(v) * y_mont);
    out[i] = v;
  }
}

}  // namespace

extern "C" {

int zigz_field_mul_chain(const void* x, const void* y, int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  const unsigned int grid = static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  field_mul_chain_kernel<<<grid, kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
