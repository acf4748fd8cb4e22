// Poseidon2 of the protocol-v3 commitments: P1 (Merkle leaves), P2 (Merkle
// merges) and P3 (the Ligero column sponge's absorb), one thread a hash or
// a column over the permutation P0 of poseidon2.cuh, bound to Python
// through ctypes (ops/poseidon2.py).
//
// P1 replaces zigz_tpu/ops/poseidon2.py:130 _p2_leaves_jit, P2 :141
// _p2_merge_jit (adjacent pairing 2i, 2i + 1), P3 the port's torch-op
// p2_absorb (the JAX package hashes those columns on the host:
// zigz_tpu/commitments/ligero.py:386-392).  All three are bound by the
// permutation's integer operations (poseidon2.cuh), whose round loops stay
// rolled.  Loads and stores are coalesced across neighbouring threads: limb
// k of hashes i, i + 1, ... are neighbouring words, P2 reads each child
// pair as one 8-byte word (twice: the left child before the first
// permutation, the right one after it), and P3 reads row r of neighbouring
// columns.  One thread a hash or column beat a column's state split over 2
// or 4 threads of a warp, which added shuffles and duplicated S-boxes, and
// register caps moved the rolled kernels by about 1% (PERF.md §6).
//
// Each launcher takes device pointers, sizes, the constants (a host array
// of 157 u32, Montgomery form, copied into the launch's parameters) and the
// CUDA stream; it launches on that stream without synchronising, allocates
// nothing, and returns cudaGetLastError() so that a refused launch reaches
// the caller.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

using zigz_p2::Consts;

constexpr int kThreadsPerBlock = 128;

__global__ void __launch_bounds__(kThreadsPerBlock)
p2_leaves_kernel(const uint32_t* __restrict__ values, uint32_t* __restrict__ out, int64_t n,
                 const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) zigz_p2::leaf_body(values, out, n, i, c);
}

__global__ void __launch_bounds__(kThreadsPerBlock)
p2_merge_kernel(const uint32_t* __restrict__ level, uint32_t* __restrict__ out, int64_t n_out,
                const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_out) zigz_p2::merge_body(level, out, n_out, i, c);
}

__global__ void __launch_bounds__(kThreadsPerBlock)
p2_absorb_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ msg, int64_t rows, int64_t n,
                 const __grid_constant__ Consts c) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < n) zigz_p2::absorb_body(state, msg, rows, n, j, c);
}

// Blocks for n threads, or 0 where the grid would be too large.
unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  return blocks > 2147483647 ? 0u : static_cast<unsigned int>(blocks);
}

Consts consts_of(const void* consts) {
  Consts c;
  std::memcpy(&c, consts, sizeof(c));
  return c;
}

}  // namespace

extern "C" {

// values (n,) canonical u32 -> out (8, n) digest limbs.
int zigz_p2_leaves(const void* values, void* out, int64_t n, const void* consts, void* stream) {
  const unsigned int blocks = blocks_for(n);
  if (n < 1 || blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  p2_leaves_kernel<<<blocks, kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<uint32_t*>(out), n, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

// level (8, 2 n_out) digest limbs, 8-byte aligned -> out (8, n_out).
int zigz_p2_merge(const void* level, void* out, int64_t n_out, const void* consts, void* stream) {
  const unsigned int blocks = blocks_for(n_out);
  if (n_out < 1 || blocks == 0 || reinterpret_cast<uintptr_t>(level) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p2_merge_kernel<<<blocks, kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(level), static_cast<uint32_t*>(out), n_out, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of P3 that an SM holds at once, into *blocks: P3's resident wave
// is that x SMs x the block's threads (chip_smoke.py times P3 at it).
int zigz_p2_absorb_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, p2_absorb_kernel, kThreadsPerBlock, 0));
}

// state (16, n) canonical, in place; msg (rows, n) canonical, rows >= 0.
int zigz_p2_absorb(void* state, const void* msg, int64_t rows, int64_t n, const void* consts, void* stream) {
  const unsigned int blocks = blocks_for(n);
  if (n < 1 || rows < 0 || blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  p2_absorb_kernel<<<blocks, kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), static_cast<const uint32_t*>(msg), rows, n, consts_of(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
