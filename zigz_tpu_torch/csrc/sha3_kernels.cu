// SHA3-256 kernels of the v1 Merkle forest: leaf hashing (K1) and node
// merging (K2), one thread per hash, bound to Python through ctypes.
//
// Each launcher takes device pointers, a hash count and the CUDA stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;

// K1 -- replaces zigz_tpu/ops/keccak_pallas.py::_leaves_kernel.
//
// Message: one little-endian u64 value (8 bytes) absorbed into lane 0, padded
// with 0x06 in lane 1 and 0x80 in the top byte of lane 16 (rate 136 bytes).
// Output: the 32-byte digest as 4 u64 lanes, digests[4 i .. 4 i + 3].
//
// Bound by integer ALU work, not bytes: about 24 x ~100 64-bit operations per
// hash against 8 bytes read and 32 written.  Making it fast (16-byte coalesced
// stores, several hashes per thread) is later work.
__global__ void __launch_bounds__(kThreadsPerBlock)
sha3_leaves_kernel(const uint64_t* __restrict__ values, uint64_t* __restrict__ digests,
                   int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail of the last block
  uint64_t s[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) s[k] = 0;
  s[0] = values[i];
  s[1] = 0x06ull;
  s[16] = 0x8000000000000000ull;
  zigz_keccak_f1600(s);
  uint64_t* out = digests + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = s[k];
}

// K2 -- replaces zigz_tpu/ops/keccak_pallas.py::_merge_kernel.
//
// Message: 8 u64 lanes (64 bytes), two child digests left || right, taken
// from msg[8 i .. 8 i + 7]; padded with 0x06 in lane 8 and 0x80 in the top
// byte of lane 16.  Output: 4 u64 digest lanes at digests[4 i .. 4 i + 3].
//
// Bound by integer ALU work like K1 (64 bytes read, 32 written per hash).
// Coalesced 16-byte loads and several hashes per thread are later work.
__global__ void __launch_bounds__(kThreadsPerBlock)
sha3_merge_kernel(const uint64_t* __restrict__ msg, uint64_t* __restrict__ digests,
                  int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail of the last block
  uint64_t s[25];
  const uint64_t* in = msg + 8 * i;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = in[k];
#pragma unroll
  for (int k = 8; k < 25; ++k) s[k] = 0;
  s[8] = 0x06ull;
  s[16] = 0x8000000000000000ull;
  zigz_keccak_f1600(s);
  uint64_t* out = digests + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = s[k];
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreadsPerBlock - 1) / kThreadsPerBlock);
}

}  // namespace

extern "C" {

int zigz_sha3_leaves(const void* values, void* digests, int64_t n, void* stream) {
  if (n <= 0) return 0;
  sha3_leaves_kernel<<<blocks_for(n), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(values), static_cast<uint64_t*>(digests), n);
  return static_cast<int>(cudaGetLastError());
}

int zigz_sha3_merge(const void* msg, void* digests, int64_t n, void* stream) {
  if (n <= 0) return 0;
  sha3_merge_kernel<<<blocks_for(n), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(msg), static_cast<uint64_t*>(digests), n);
  return static_cast<int>(cudaGetLastError());
}

const char* zigz_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
