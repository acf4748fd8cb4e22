// Poseidon2 over BabyBear, width 16, as one thread's permutation in
// registers (P0, zigz_p2_permute) and the three bodies built on it: a leaf
// hash (P1), a merge of two child digests (P2) and the rate-block absorb
// of a column sponge (P3).  poseidon2_kernels.cu launches the bodies, one
// thread a hash or a column; under a host compiler the same bodies run in
// the extern "C" host entries at the end of this file, the CPU tests'
// entry (tests/test_torch_poseidon2_kernels.py,
// tests/test_torch_poseidon2_shapes.py).
//
// What it replaces: zigz_tpu/ops/poseidon2.py:116 permute_device (jnp over
// Montgomery lanes, jitted as :130 _p2_leaves_jit and :141 _p2_merge_jit;
// no Pallas kernel), and the port's torch ops in its place, about 320
// launches a permutation over a (16, N) int64 state.  The column sponge has
// no device counterpart in the JAX package: zigz_tpu hashes the v3 Ligero
// columns on the host (runtime/sha3.cpp zigz_p2_matrix_columns); the bytes
// are the same.
//
// What bounds it: integer operations.  A permutation is the initial
// external layer, 4 full rounds, 13 partial rounds and 4 full rounds: 564
// S-box products and 208 diagonal products (Montgomery) and nine external
// layers of small-constant sums: 9,266 integer instructions of the 9,480
// of a fully unrolled permutation in P1's SASS for sm_90a (PERF.md §6).
// A leaf reads 4 bytes and writes 32 for all of that, a column of the
// sponge reads 32 bytes a permutation.
//
// What the design does about it: the 16 lanes live in registers as
// canonical Montgomery u32 (babybear.cuh), the round loops stay rolled
// (zigz_p2_permute), and the round constants come as one struct by value
// (Consts, 157 u32 in Montgomery form, filled by the wrapper from
// core/poseidon2.py), so a warp reads each from parameter space at the
// same address.  The external
// layer's M4 has entries 1 to 7: each output is one u64 sum of products by
// those constants, below 16 p < 2^35, reduced once (reduce35; no u64 %,
// which is a software routine on the card).  The partial round's lane sum
// is reduced the same way.  Values are converted to Montgomery form at the
// load and back by one REDC at the store.
#pragma once

#include <cstdint>
#include <cstring>

#include "babybear.cuh"

namespace zigz_p2 {

using zigz::add_mod;
using zigz::kP;
using zigz::mont_mul;
using zigz::redc;
using zigz::to_mont;

constexpr int kT = 16;        // state width
constexpr int kRate = 8;      // rate; the capacity holds the message length
constexpr int kRoundsF = 8;   // full rounds, 4 + 4
constexpr int kRoundsP = 13;  // partial rounds

// The permutation's constants in Montgomery form (x 2^32 mod p), in the
// order of core/poseidon2.py: _RC_EXTERNAL, _RC_INTERNAL, _MU.
struct Consts {
  uint32_t rc_ext[kRoundsF][kT];
  uint32_t rc_int[kRoundsP];
  uint32_t mu[kT];
};
static_assert(sizeof(Consts) == 157 * sizeof(uint32_t), "157 u32, as the wrapper builds them");

// t mod p for t < 2^35, canonical: 2^31 = 2^27 - 1 mod p, so
// t = lo + hi 2^31 with hi < 16 gives lo + hi (2^27 - 1) < 2^31 + p < 3 p.
ZIGZ_HD uint32_t reduce35(uint64_t t) {
  uint32_t r = static_cast<uint32_t>(t & 0x7fffffffu) + static_cast<uint32_t>(t >> 31) * 0x07ffffffu;
  r = r >= kP ? r - kP : r;
  return r >= kP ? r - kP : r;
}

// x^7.
ZIGZ_HD uint32_t sbox(uint32_t x) {
  const uint32_t x2 = mont_mul(x, x);
  const uint32_t x4 = mont_mul(x2, x2);
  return mont_mul(mont_mul(x4, x2), x);
}

// M4 = ((5 7 1 3) (4 6 1 1) (1 3 5 7) (1 1 4 6)) within each block of four
// lanes, then the column sums of the four blocks added to every block
// (core/poseidon2.py _external_linear).  Linear, so Montgomery form passes
// through it.
ZIGZ_HD void external_linear(uint32_t s[kT]) {
  uint32_t y[kT];
#pragma unroll
  for (int b = 0; b < kT; b += 4) {
    const uint64_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
    y[b] = reduce35(5 * x0 + 7 * x1 + x2 + 3 * x3);
    y[b + 1] = reduce35(4 * x0 + 6 * x1 + x2 + x3);
    y[b + 2] = reduce35(x0 + 3 * x1 + 5 * x2 + 7 * x3);
    y[b + 3] = reduce35(x0 + x1 + 4 * x2 + 6 * x3);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t col = add_mod(add_mod(y[i], y[4 + i]), add_mod(y[8 + i], y[12 + i]));
#pragma unroll
    for (int b = 0; b < kT; b += 4) s[b + i] = add_mod(y[b + i], col);
  }
}

ZIGZ_HD void full_round(uint32_t s[kT], const uint32_t rc[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) s[i] = sbox(add_mod(s[i], rc[i]));
  external_linear(s);
}

// The S-box on lane 0, then x -> diag(mu) x + sum(x).
ZIGZ_HD void partial_round(uint32_t s[kT], uint32_t rc, const uint32_t mu[kT]) {
  s[0] = sbox(add_mod(s[0], rc));
  uint64_t sum = 0;
#pragma unroll
  for (int i = 0; i < kT; ++i) sum += s[i];
  const uint32_t total = reduce35(sum);
#pragma unroll
  for (int i = 0; i < kT; ++i) s[i] = add_mod(total, mont_mul(mu[i], s[i]));
}

// The round loops' unrolling: rolled, unless ZIGZ_P2_UNROLLED_ROUNDS is
// defined.  chip_smoke.py builds the unrolled variant only to count the
// instructions of one whole permutation in its SASS, the kernels' bound;
// nothing launches it.
#ifdef ZIGZ_P2_UNROLLED_ROUNDS
#define ZIGZ_P2_ROUND_LOOP _Pragma("unroll")
#else
#define ZIGZ_P2_ROUND_LOOP _Pragma("unroll 1")
#endif

// P0: the permutation of one state of canonical Montgomery lanes, in place:
// the initial external layer, then the eight full rounds with the thirteen
// partial rounds between the fourth and the fifth.  Both round loops stay
// rolled (a round's constants read at a run-time index), so that the code
// holds one full round and one partial round: P1 is 1,264 instructions.
// Unrolled, a permutation is 9,480 instructions (148 KiB of code, 312 KiB
// in P2's two), and P1, P2 and P3 took 11%, 32% and 25% longer than they
// do rolled, with the same registers or more (PERF.md §6).
ZIGZ_HD void zigz_p2_permute(uint32_t s[kT], const Consts& c) {
  external_linear(s);
  ZIGZ_P2_ROUND_LOOP
  for (int r = 0; r < kRoundsF; ++r) {
    if (r == kRoundsF / 2) {
      ZIGZ_P2_ROUND_LOOP
      for (int p = 0; p < kRoundsP; ++p) partial_round(s, c.rc_int[p], c.mu);
    }
    full_round(s, c.rc_ext[r]);
  }
}

// Children 2i and 2i + 1 of one limb row: one 8-byte word, the left child
// in its low half (little-endian).  A load the compiler may not merge with
// an earlier one of the same word: the merges read each word twice, the
// left child before the first permutation and the right one after it (from
// L1 or L2), so that no child is held in registers across a permutation.
// Held (one __ldg a word), P2 took 52 registers against 40 and ran 1.2-1.7%
// longer (PERF.md §6).
ZIGZ_HD uint64_t load_pair(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  uint64_t w;
  asm volatile("ld.global.nc.u64 %0, [%1];" : "=l"(w) : "l"(p));
  return w;
#else
  uint64_t w;
  std::memcpy(&w, p, sizeof(w));
  return w;
#endif
}

// P1, hash i: the one-element message values[i] (canonical) in lane 0, its
// length 1 in lane 8; digest limbs k = 0..7 to out[k n + i], canonical.
ZIGZ_HD void leaf_body(const uint32_t* __restrict__ values, uint32_t* __restrict__ out, int64_t n, int64_t i,
                       const Consts& c) {
  uint32_t s[kT] = {};  // 0 is 0 in Montgomery form
  s[0] = to_mont(values[i]);
  s[kRate] = to_mont(1u);
  zigz_p2_permute(s, c);
#pragma unroll
  for (int k = 0; k < kRate; ++k) out[k * n + i] = redc(s[k]);
}

// P2, parent i of the level (8, 2 n_out) of digest limbs: the 16-limb
// message left || right (children 2i and 2i + 1), two rate blocks, its
// length 16 in lane 8; parent limbs to out[k n_out + i].
ZIGZ_HD void merge_body(const uint32_t* __restrict__ level, uint32_t* __restrict__ out, int64_t n_out, int64_t i,
                        const Consts& c) {
  uint32_t s[kT] = {};
  const uint32_t* pairs = level + 2 * i;  // limb k of both children: pairs[k * 2 n_out]
#pragma unroll
  for (int k = 0; k < kRate; ++k) s[k] = to_mont(static_cast<uint32_t>(load_pair(pairs + k * 2 * n_out)));
  s[kRate] = to_mont(16u);
  zigz_p2_permute(s, c);
#pragma unroll
  for (int k = 0; k < kRate; ++k) {
    s[k] = add_mod(s[k], to_mont(static_cast<uint32_t>(load_pair(pairs + k * 2 * n_out) >> 32)));
  }
  zigz_p2_permute(s, c);
#pragma unroll
  for (int k = 0; k < kRate; ++k) out[k * n_out + i] = redc(s[k]);
}

// P3, column j of the carried sponge state (16, n), canonical, updated in
// place: rows 0..rows - 1 of msg (rows, n), canonical, added kRate at a
// time into lanes 0..7, a permutation after each block; a short last block
// adds to its first lanes only.  No rows: the bare state is permuted once,
// as the sponge of an empty message does.
ZIGZ_HD void absorb_body(uint32_t* __restrict__ state, const uint32_t* __restrict__ msg, int64_t rows, int64_t n,
                         int64_t j, const Consts& c) {
  uint32_t s[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) s[k] = to_mont(state[k * n + j]);
  const int64_t blocks = rows > 0 ? (rows + kRate - 1) / kRate : 1;
  for (int64_t b = 0; b < blocks; ++b) {
    const uint32_t* row = msg + b * kRate * n + j;
    const int64_t live = rows - b * kRate;
    // Unrolled with a predicate, the same for every thread: a loop to
    // `live` would index s at run time and put the state in local memory.
#pragma unroll
    for (int k = 0; k < kRate; ++k) {
      if (k < live) s[k] = add_mod(s[k], to_mont(row[k * n]));
    }
    zigz_p2_permute(s, c);
  }
#pragma unroll
  for (int k = 0; k < kT; ++k) state[k * n + j] = redc(s[k]);
}

}  // namespace zigz_p2

#ifndef __CUDACC__

// The CPU tests' entries: each body over every hash or column, in order,
// with the constants as the 157 u32 that the wrapper passes to the kernels.
// Defined here, not inline, so that the one host unit that includes the
// header (the tests' build) exports them.
extern "C" {

// states (16, n) canonical, permuted in place.
void zigz_p2_permute_host(uint32_t* states, int64_t n, const uint32_t* consts) {
  zigz_p2::Consts c;
  std::memcpy(&c, consts, sizeof(c));
  for (int64_t i = 0; i < n; ++i) {
    uint32_t s[zigz_p2::kT];
    for (int k = 0; k < zigz_p2::kT; ++k) s[k] = zigz::to_mont(states[k * n + i]);
    zigz_p2::zigz_p2_permute(s, c);
    for (int k = 0; k < zigz_p2::kT; ++k) states[k * n + i] = zigz::redc(s[k]);
  }
}

void zigz_p2_leaves_host(const uint32_t* values, uint32_t* out, int64_t n, const uint32_t* consts) {
  zigz_p2::Consts c;
  std::memcpy(&c, consts, sizeof(c));
  for (int64_t i = 0; i < n; ++i) zigz_p2::leaf_body(values, out, n, i, c);
}

void zigz_p2_merge_host(const uint32_t* level, uint32_t* out, int64_t n_out, const uint32_t* consts) {
  zigz_p2::Consts c;
  std::memcpy(&c, consts, sizeof(c));
  for (int64_t i = 0; i < n_out; ++i) zigz_p2::merge_body(level, out, n_out, i, c);
}

void zigz_p2_absorb_host(uint32_t* state, const uint32_t* msg, int64_t rows, int64_t n,
                                const uint32_t* consts) {
  zigz_p2::Consts c;
  std::memcpy(&c, consts, sizeof(c));
  for (int64_t j = 0; j < n; ++j) zigz_p2::absorb_body(state, msg, rows, n, j, c);
}

}  // extern "C"

#endif  // __CUDACC__
