// Kernels that exist only to be counted: chip_smoke.py builds this unit into
// a cubin (bound_chain_counts), reads its SASS and takes the instructions
// one unit of work needs from the difference of two lengths of a chain, so
// that code a thread runs once (its index, its loads and stores of the
// state) is not billed to every unit.  Nothing launches these kernels and
// the kernels' library does not hold them (ops/_build.py builds csrc/*.cu
// only).  Each template is instantiated explicitly, so that it stays in the
// cubin.
//
// ntt_butterfly_chain_kernel<kChain>: kChain butterflies of N1/N2
//   (ntt.cuh butterfly_values) in a chain on one pair of values, their
//   twiddles from parameter space, which an instruction reads as an
//   operand.  The chains of 64 and of 32 differ by 32 butterflies'
//   arithmetic and nothing else.
// sha3_block_chain_kernel<kBlocks, kCarried>: the column sponge of K4
//   (kCarried false: the state starts at zero, lanes 0..3 are stored) or K5
//   (kCarried true: 25 lanes loaded and stored, lane-major) over kBlocks rate
//   blocks of one column of an (r, n) matrix of u32 words: a block is 34
//   row-strided word loads, their 17 lanes XORed into the state, and one
//   Keccak-f (keccak.cuh).  Three blocks less two is what a block after the
//   first costs; two blocks less twice that is the column's own code, which
//   for K4 is below zero: from the zero state the first block's zero lanes
//   fold away.  K4 and K5 also test every word for
//   the message's end and its pad bits (ligero_kernels.cu word_at); the
//   function needs that once a column, so the chain leaves it out.
#include <cstdint>

#include <cuda_runtime.h>

#include "keccak.cuh"
#include "ntt.cuh"

struct ChainTwiddles {
  uint32_t tw[64];
};

template <int kChain>
__global__ void ntt_butterfly_chain_kernel(uint32_t* __restrict__ x, ChainTwiddles t) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t a = x[2 * i], b = x[2 * i + 1];
#pragma unroll
  for (int c = 0; c < kChain; ++c) zigz_ntt::butterfly_values(a, b, t.tw[c]);
  x[2 * i] = a;
  x[2 * i + 1] = b;
}

template __global__ void ntt_butterfly_chain_kernel<32>(uint32_t*, ChainTwiddles);
template __global__ void ntt_butterfly_chain_kernel<64>(uint32_t*, ChainTwiddles);

template <int kBlocks, bool kCarried>
__global__ void sha3_block_chain_kernel(uint64_t* __restrict__ state, const uint32_t* __restrict__ msg,
                                        int64_t n) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint64_t s[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) s[k] = kCarried ? state[k * n + col] : 0;
  const uint32_t* w = msg + col;
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      s[k] ^= static_cast<uint64_t>(w[(34 * b + 2 * k) * n]) |
              (static_cast<uint64_t>(w[(34 * b + 2 * k + 1) * n]) << 32);
    }
    zigz_keccak_f1600(s);
  }
  if (kCarried) {
#pragma unroll
    for (int k = 0; k < 25; ++k) state[k * n + col] = s[k];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) state[4 * col + k] = s[k];
  }
}

template __global__ void sha3_block_chain_kernel<2, false>(uint64_t*, const uint32_t*, int64_t);
template __global__ void sha3_block_chain_kernel<3, false>(uint64_t*, const uint32_t*, int64_t);
template __global__ void sha3_block_chain_kernel<2, true>(uint64_t*, const uint32_t*, int64_t);
template __global__ void sha3_block_chain_kernel<3, true>(uint64_t*, const uint32_t*, int64_t);
