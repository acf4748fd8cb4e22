// The Reed-Solomon row encode of the Ligero commitments over BabyBear: the
// plan of an encode, the butterfly and the per-element steps of its two
// passes, shared by the kernels of ntt_kernels.cu (N1 ntt_tile_kernel, N2
// ntt_stage_kernel) and by the extern "C" host entry at the end of this file,
// which runs the same passes in the same order and which the CPU tests build
// with g++ (tests/test_torch_ntt_kernel.py).  ZIGZ_HD as in babybear.cuh.
//
// Every row's n values are coefficients, zero-padded to n_out and evaluated
// over the size-n_out subgroup: the bit-reversed-input radix-2 DIT of
// zigz_tpu/commitments/ligero.py _ntt_pow2_numpy.  Stage s pairs positions
// (g 2^(s+1) + i, g 2^(s+1) + 2^s + i) with the twiddle w_{2^(s+1)}^i,
// _twiddles(n_out)[s][i]; the tables of every stage lie end to end, stage s
// at offset 2^s - 1, in Montgomery form (x 2^32 mod p), so a canonical value
// times a twiddle stays canonical (babybear.cuh).
//
// The skip rule: with k = n_out / n, the bit-reversed zero-padded row holds
// its values at the multiples of k, and the first log2(k) stages only copy
// each into its group of k.  So position j holds mat[br_n(j / k)] after
// them; both passes start from that broadcast and run no such stage.
#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace zigz_ntt {

using zigz::add_mod;
using zigz::redc;
using zigz::sub_mod;

constexpr int kLogTile = 13;
constexpr int64_t kTile = int64_t{1} << kLogTile;  // outputs an N1 block holds in shared memory (32 KiB)
constexpr int kLogMaxOut = 27;                      // BabyBear's two-adicity: the largest subgroup

// Which stages each pass of one encode runs.  N1 runs stages log_k ..
// log_tile - 1 inside each tile of 2^log_tile consecutive outputs; N2 runs
// one global stage a launch, first_stage .. log_out - 1.
struct Plan {
  int64_t rows;
  int log_n;
  int log_k;
  int log_out;
  int log_tile;     // min(log2 tile, log_out)
  int first_stage;  // max(log_tile, log_k)
  int64_t tiles;    // tiles a row
};

ZIGZ_HD bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

ZIGZ_HD int log2_of(int64_t x) {  // x a power of two
  int b = 0;
  while ((int64_t{1} << b) < x) ++b;
  return b;
}

// The low ``bits`` bits of x reversed.
ZIGZ_HD uint32_t bit_reverse(uint32_t x, int bits) {
#ifdef __CUDA_ARCH__
  return bits ? __brev(x) >> (32 - bits) : 0u;
#else
  uint32_t r = 0;
  for (int b = 0; b < bits; ++b) r |= ((x >> b) & 1u) << (bits - 1 - b);
  return r;
#endif
}

// 0 and the plan of an encode of (rows, n) -> (rows, n_out) in tiles of
// ``tile`` outputs, or 1 for a shape it refuses: n and n_out powers of two
// with n <= n_out, 2 <= n_out <= 2^27, rows >= 0, tile a power of two from 2
// to kTile, and at most max_blocks blocks a launch for ``threads`` threads a
// butterfly block of N2 (grid.x).
inline int make_plan(int64_t rows, int64_t n, int64_t n_out, int64_t tile, int64_t max_blocks, int64_t threads,
                     Plan* plan) {
  if (rows < 0 || !is_pow2(n) || !is_pow2(n_out) || n > n_out || n_out < 2 ||
      n_out > (int64_t{1} << kLogMaxOut) || !is_pow2(tile) || tile < 2 || tile > kTile) {
    return 1;
  }
  Plan p;
  p.rows = rows;
  p.log_n = log2_of(n);
  p.log_out = log2_of(n_out);
  p.log_k = p.log_out - p.log_n;
  const int log_tile = log2_of(tile);
  p.log_tile = log_tile < p.log_out ? log_tile : p.log_out;
  p.first_stage = p.log_tile > p.log_k ? p.log_tile : p.log_k;
  p.tiles = n_out >> p.log_tile;
  if (rows > max_blocks / p.tiles || rows * (n_out / 2) > max_blocks * threads) return 1;
  *plan = p;
  return 0;
}

// N2 launches of a plan.
ZIGZ_HD int stage_passes(const Plan& p) { return p.log_out - p.first_stage; }

// Values of the row each tile gathers, and the copies of each it holds
// after the skipped stages: 2^log_head consecutive positions.
ZIGZ_HD int log_head(const Plan& p) { return p.log_k < p.log_tile ? p.log_k : p.log_tile; }

// N1, gather: head m of tile t of a row, mat[br_n(j / k)] at tile position
// j = m 2^log_head.
ZIGZ_HD void tile_gather(const uint32_t* row_in, uint32_t* tile_x, int64_t t, int64_t m, const Plan& p) {
  const int64_t j = m << log_head(p);
  const int64_t pos = (t << p.log_tile) + j;
  tile_x[j] = row_in[bit_reverse(static_cast<uint32_t>(pos >> p.log_k), p.log_n)];
}

// N1, broadcast: position j, not a head, takes its head's value.
ZIGZ_HD void tile_fill(uint32_t* tile_x, int64_t j, const Plan& p) {
  const int64_t mask = (int64_t{1} << log_head(p)) - 1;
  if (j & mask) tile_x[j] = tile_x[j & ~mask];
}

// The butterfly on two values: b' = b tw (tw in Montgomery form, one REDC),
// then (a + b', a - b') mod p.
ZIGZ_HD void butterfly_values(uint32_t& a, uint32_t& b, uint32_t tw) {
  const uint32_t h = redc(static_cast<uint64_t>(b) * tw);
  b = sub_mod(a, h);
  a = add_mod(a, h);
}

// Butterfly q of stage s on x (a tile or a whole row): q = g 2^s + i pairs
// x[g 2^(s+1) + i] and the value 2^s past it, twiddle tw[2^s - 1 + i].  A
// row holds at most 2^27 values, so the indices are u32.
ZIGZ_HD void butterfly(uint32_t* x, const uint32_t* tw, uint32_t q, int s) {
  const uint32_t half = 1u << s;
  const uint32_t i = q & (half - 1);
  const uint32_t lo = ((q >> s) << (s + 1)) + i;
  uint32_t a = x[lo], b = x[lo + half];
  butterfly_values(a, b, tw[half - 1 + i]);
  x[lo] = a;
  x[lo + half] = b;
}

}  // namespace zigz_ntt

extern "C" {

// N2's stages of an (R, n) -> (R, n_out) encode, [*first, *end), one launch
// each; N1 runs the stages below *first that the skip rule keeps.  The split
// is the plan's alone: the wrapper (ops/ntt_dev.py n2_stages) and
// chip_smoke.py read it from here.  Returns 0, or 1 (cudaErrorInvalidValue)
// for n, n_out that make_plan refuses.  Defined in the header for the one
// unit of each library that includes it (ntt_kernels.cu; the CPU tests'
// host build).
int zigz_ntt_stages(int64_t n, int64_t n_out, int64_t* first, int64_t* end) {
  zigz_ntt::Plan p;
  if (zigz_ntt::make_plan(0, n, n_out, zigz_ntt::kTile, INT64_MAX / 2, 1, &p)) return 1;
  *first = p.first_stage;
  *end = p.log_out;
  return 0;
}

}  // extern "C"

#ifndef __CUDACC__

extern "C" {

// The encode on the host, for the CPU tests: the passes of the card in their
// order, N1 on every (row, tile) then each N2 stage over every row, with
// tiles of ``tile`` outputs.  ``in`` (rows, n), ``out`` (rows, n_out),
// ``tw`` the n_out - 1 twiddles in Montgomery form; *stage_launches gets
// N2's launches.  Returns 0, or 1 for a shape the card refuses too.
int zigz_ntt_encode_host(const uint32_t* in, const uint32_t* tw, uint32_t* out, int64_t rows, int64_t n,
                         int64_t n_out, int64_t tile, int64_t* stage_launches) {
  zigz_ntt::Plan p;
  if (zigz_ntt::make_plan(rows, n, n_out, tile, INT64_MAX / 2, 1, &p)) return 1;
  const int64_t t_len = int64_t{1} << p.log_tile;
  for (int64_t row = 0; row < rows; ++row) {
    for (int64_t t = 0; t < p.tiles; ++t) {
      uint32_t* tile_x = out + row * n_out + t * t_len;  // the tile's own outputs hold its values
      for (int64_t m = 0; m < (t_len >> zigz_ntt::log_head(p)); ++m) {
        zigz_ntt::tile_gather(in + row * n, tile_x, t, m, p);
      }
      for (int64_t j = 0; j < t_len; ++j) zigz_ntt::tile_fill(tile_x, j, p);
      for (int s = zigz_ntt::log_head(p); s < p.log_tile; ++s) {
        for (int64_t q = 0; q < t_len / 2; ++q) zigz_ntt::butterfly(tile_x, tw, q, s);
      }
    }
  }
  for (int s = p.first_stage; s < p.log_out; ++s) {
    for (int64_t row = 0; row < rows; ++row) {
      for (int64_t q = 0; q < n_out / 2; ++q) zigz_ntt::butterfly(out + row * n_out, tw, q, s);
    }
  }
  *stage_launches = zigz_ntt::stage_passes(p);
  return 0;
}

int64_t zigz_ntt_tile_host() { return zigz_ntt::kTile; }

}  // extern "C"

#endif  // __CUDACC__
