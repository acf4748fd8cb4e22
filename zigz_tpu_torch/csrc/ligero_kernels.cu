// Column sponges of the Ligero commitments: K4 (a whole SHA3-256 per column)
// and K5 (rate blocks absorbed into a carried state), one thread per column,
// bound to Python through ctypes.
//
// Every column j of an (r, n) matrix of u32 words is one message: its r
// words little-endian, word r = 0x06 (SHA3 domain bits), zeros, and
// 0x80 << 24 in the last word of the last 136-byte (34-word) rate block.
// There are pw = ((4 r) / 136 + 1) * 34 padded words.  Lane k of a rate
// block is word[2k] | word[2k + 1] << 32.  The pad words are applied in
// registers as the block is absorbed: no padded message is built.
//
// Each launcher takes device pointers, sizes and the CUDA stream, launches on
// that stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

constexpr int kThreadsPerBlock = 128;
constexpr int64_t kRateWords = 34;

int64_t padded_words(int64_t r) { return ((4 * r) / 136 + 1) * kRateWords; }

// Words [k0, k0 + 34 nb) of the padded message stream of every column.  Rows
// [k0, k0 + live) of the message are msg[0 .. live) (row-major, n columns);
// words past them are zero unless they carry a pad bit.
struct Stream {
  const uint32_t* msg;
  int64_t n;
  int64_t k0;
  int64_t live;
  int64_t r;
  int64_t pw;
};

__device__ __forceinline__ uint64_t word_at(const Stream& st, int64_t w, int64_t col) {
  const int64_t row = w - st.k0;
  uint32_t v = row < st.live ? st.msg[row * st.n + col] : 0u;
  if (w == st.r) v |= 0x06u;            // pad start; 0x06 and 0x80 << 24 are in
  if (w == st.pw - 1) v |= 0x80000000u;  // different bytes, so both may meet
  return v;
}

// Absorbs nb rate blocks of the stream into the state of column col.  The
// branches depend on the word index only, so a warp never diverges on them.
__device__ __forceinline__ void absorb(uint64_t s[25], const Stream& st, int64_t nb, int64_t col) {
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t w0 = st.k0 + b * kRateWords;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      s[k] ^= word_at(st, w0 + 2 * k, col) | (word_at(st, w0 + 2 * k + 1, col) << 32);
    }
    zigz_keccak_f1600(s);
  }
}

// K4 -- replaces zigz_tpu/ops/ligero_dev.py::_kernel(nb).
//
// (r, n) u32 -> (n, 4) u64 digests, one SHA3-256 per column from the zero
// state.  The TPU kernel carries the state in VMEM scratch from one grid
// step (rate block) to the next; here the sponge stays in the thread's
// registers across all pw / 34 blocks.  Adjacent threads read adjacent
// columns of one row, so every 4-byte load of a warp is one 128-byte
// segment.  Bound by integer ALU work (one Keccak-f per 136 bytes read),
// not by bytes.
__global__ void __launch_bounds__(kThreadsPerBlock)
sha3_columns_kernel(const uint32_t* __restrict__ mat, uint64_t* __restrict__ digests,
                    int64_t n, int64_t r, int64_t pw) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;  // ragged tail of the last block
  uint64_t s[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) s[k] = 0;
  const Stream st{mat, n, 0, r, r, pw};
  absorb(s, st, pw / kRateWords, col);
  uint64_t* out = digests + 4 * col;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = s[k];
}

// K5 -- replaces zigz_tpu/ops/ligero_dev.py::_absorb_kernel(nb).
//
// state (25, n) u64, lane-major, updated in place: nb rate blocks starting at
// stream word k0 (a multiple of 34), whose message rows are msg (live, n).
// Lane-major state makes the 25 loads and stores of a warp coalesce too.
// The final call's lanes 0..3 are the digests.  Bound like K4.
__global__ void __launch_bounds__(kThreadsPerBlock)
sha3_absorb_kernel(uint64_t* __restrict__ state, const uint32_t* __restrict__ msg,
                   int64_t n, int64_t k0, int64_t live, int64_t nb, int64_t r, int64_t pw) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint64_t s[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) s[k] = state[k * n + col];
  const Stream st{msg, n, k0, live, r, pw};
  absorb(s, st, nb, col);
#pragma unroll
  for (int k = 0; k < 25; ++k) state[k * n + col] = s[k];
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreadsPerBlock - 1) / kThreadsPerBlock);
}

}  // namespace

extern "C" {

int zigz_sha3_columns(const void* mat, void* digests, int64_t n, int64_t r, void* stream) {
  if (n <= 0) return 0;
  sha3_columns_kernel<<<blocks_for(n), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mat), static_cast<uint64_t*>(digests), n, r, padded_words(r));
  return static_cast<int>(cudaGetLastError());
}

int zigz_sha3_absorb(void* state, const void* msg, int64_t n, int64_t k0, int64_t live,
                     int64_t nb, int64_t r, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  sha3_absorb_kernel<<<blocks_for(n), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(state), static_cast<const uint32_t*>(msg), n, k0, live, nb, r,
      padded_words(r));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
