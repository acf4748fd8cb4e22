// The Reed-Solomon row encode of the Ligero commitments over BabyBear: the
// plan of an encode, the butterfly and the per-thread steps of its two
// kernels, shared by ntt_kernels.cu (N1 ntt_tile_kernel, N2
// ntt_pass_kernel) and by the extern "C" host entry at the end of this file,
// which runs the same blocks, passes and threads in the same order and which
// the CPU tests build with g++ (tests/test_torch_ntt_kernel.py,
// tests/test_torch_ntt_passes.py).  ZIGZ_HD as in babybear.cuh.
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
// them; N1 loads that broadcast and no kernel runs such a stage.
//
// A block of either kernel holds 2^bits values of one row, local index u.
// The low col_bits bits of u pick a column, on which no stage of the block
// acts; bit col_bits + q is stage stage0 + q.  N1's block is a tile of
// 2^log_tile consecutive outputs, its columns the copies of the skip rule;
// N2's block is 2^g values l + j 2^first (j < 2^g) of each of 32
// consecutive positions l of a row, its columns those l.  Either block runs
// its stages in register passes: a thread holds 2^LOG_R values whose local
// indices differ in a window of LOG_R bits and runs the pass's stages, at
// most LOG_R, on them in registers; the block exchanges values through
// shared memory between passes only.  So every butterfly pairs the same
// two positions with the same twiddle as the radix-2 stage does.
#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace zigz_ntt {

using zigz::add_mod;
using zigz::redc;
using zigz::sub_mod;

constexpr int kLogTile = 13;
constexpr int64_t kTile = int64_t{1} << kLogTile;  // outputs of an N1 block (32 KiB of shared memory)
constexpr int kLogMaxOut = 27;                      // BabyBear's two-adicity: the largest subgroup
// log2 of the values an N1 and an N2 thread holds (32 and 16), and so of
// the stages a register pass runs at most.
constexpr int kTileLogRadix = 5;
constexpr int kPassLogRadix = 4;
constexpr int kLogColumns = 5;                      // an N2 block's positions l: 32 words, 128 B a row of it
constexpr int kMaxPassStages = 8;                   // an N2 block: 32 x 2^8 values, 32 KiB of shared memory

// How one encode is split.  N1 runs stages log_k .. log_tile - 1 inside each
// tile of 2^log_tile consecutive outputs; N2 runs the global stages
// first_stage .. log_out - 1 in `passes` launches of at most max_pass
// stages each (pass_first).
struct Plan {
  int64_t rows;
  int log_n;
  int log_k;
  int log_out;
  int log_tile;     // min(log2 tile, log_out)
  int first_stage;  // max(log_tile, log_k)
  int64_t tiles;    // tiles a row
  int passes;       // N2's launches
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

// The first stage of N2's pass i; pass_first(p, p.passes) is log_out.  The
// global stages are split as evenly as the passes allow, the longer passes
// first.
ZIGZ_HD int pass_first(const Plan& p, int i) {
  const int global = p.log_out - p.first_stage;
  const int each = p.passes ? global / p.passes : 0;
  const int longer = p.passes ? global % p.passes : 0;
  return p.first_stage + i * each + (i < longer ? i : longer);
}

// Column bits of an N2 block whose pass starts at stage ``first``: the
// positions l it takes, 32 of them or all 2^first.
ZIGZ_HD int pass_col_bits(int first) { return first < kLogColumns ? first : kLogColumns; }

// N2 blocks a row for the pass [first, end).
ZIGZ_HD int64_t pass_blocks_a_row(int log_out, int first, int end) {
  return int64_t{1} << (log_out - (end - first) - pass_col_bits(first));
}

// 0 and the plan of an encode of (rows, n) -> (rows, n_out) in tiles of
// ``tile`` outputs and N2 passes of at most ``max_pass`` stages, or 1 for a
// shape it refuses: n and n_out powers of two with n <= n_out, 2 <= n_out <=
// 2^27, rows >= 0, tile a power of two from 2 to kTile, max_pass from 1 to
// kMaxPassStages, and at most max_blocks blocks a launch (grid.x).
inline int make_plan(int64_t rows, int64_t n, int64_t n_out, int64_t tile, int64_t max_pass, int64_t max_blocks,
                     Plan* plan) {
  if (rows < 0 || !is_pow2(n) || !is_pow2(n_out) || n > n_out || n_out < 2 ||
      n_out > (int64_t{1} << kLogMaxOut) || !is_pow2(tile) || tile < 2 || tile > kTile || max_pass < 1 ||
      max_pass > kMaxPassStages) {
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
  p.passes = static_cast<int>((p.log_out - p.first_stage + max_pass - 1) / max_pass);
  if (rows > max_blocks / p.tiles) return 1;
  for (int i = 0; i < p.passes; ++i) {
    if (rows > max_blocks / pass_blocks_a_row(p.log_out, pass_first(p, i), pass_first(p, i + 1))) return 1;
  }
  *plan = p;
  return 0;
}

// The values a block holds (see the head of this file).  log_k and log_n
// serve N1's gather.
struct Block {
  int bits;
  int col_bits;
  int stage0;
  uint32_t origin;  // the row position of u = 0
  int log_k;
  int log_n;
};

// N1's block: tile t of a row.  Its positions below 2^log_head are copies of
// one value of the row, and its stages are log_head .. log_tile - 1.
ZIGZ_HD Block tile_block(const Plan& p, int64_t t) {
  const int log_head = p.log_k < p.log_tile ? p.log_k : p.log_tile;
  return Block{p.log_tile, log_head, log_head, static_cast<uint32_t>(t << p.log_tile), p.log_k, p.log_n};
}

// N2's block r of a row for the pass [first, end): positions l = c0 + c
// (c < 2^col_bits) with c0 = (r mod 2^(first - col_bits)) 2^col_bits, of
// the high group h = r / 2^(first - col_bits), at h 2^end + j 2^first + l.
ZIGZ_HD Block pass_block(int first, int end, int64_t r) {
  const int col_bits = pass_col_bits(first);
  const int64_t groups = int64_t{1} << (first - col_bits);
  const auto origin = static_cast<uint32_t>(((r / groups) << end) | ((r % groups) << col_bits));
  return Block{col_bits + end - first, col_bits, first, origin, 0, 0};
}

// Row position of local index u.
ZIGZ_HD uint32_t row_offset(const Block& b, uint32_t u) {
  return b.origin + (u & ((1u << b.col_bits) - 1)) + ((u >> b.col_bits) << b.stage0);
}

// log2 of the values a thread holds: the kernel's radix, or all of a
// smaller block.
ZIGZ_HD int block_log_r(const Block& b, int log_radix) { return b.bits < log_radix ? b.bits : log_radix; }

// Register passes of a block (1 when it runs no stage: N1 then only
// broadcasts), and threads a block.
ZIGZ_HD int block_passes(const Block& b, int log_r) {
  const int stages = b.bits - b.col_bits;
  return stages ? (stages + log_r - 1) / log_r : 1;
}

ZIGZ_HD int block_threads(const Block& b, int log_r) { return 1 << (b.bits - log_r); }

// Pass ``pass`` runs the stages of local bits [col_bits + log_r pass, ...)
// (at most log_r of them, up to bits); a thread holds the values whose
// local indices differ in the window of bits [w, w + log_r) that starts
// there, or that ends at the top of the block.
ZIGZ_HD int pass_window(const Block& b, int log_r, int pass) {
  const int w = b.col_bits + log_r * pass;
  return w < b.bits - log_r ? w : b.bits - log_r;
}

// Thread tau's local index with the window's bits zero.
ZIGZ_HD uint32_t thread_base(uint32_t tau, int w, int log_r) {
  return (tau & ((1u << w) - 1)) | ((tau >> w) << (w + log_r));
}

// The butterfly on two values: b' = b tw (tw in Montgomery form, one REDC),
// then (a + b', a - b') mod p.
ZIGZ_HD void butterfly_values(uint32_t& a, uint32_t& b, uint32_t tw) {
  const uint32_t h = redc(static_cast<uint64_t>(b) * tw);
  b = sub_mod(a, h);
  a = add_mod(a, h);
}

// Where a pass reads or writes a thread's values: N1's gather of the row's
// coefficients with the skip rule's broadcast, the row in device memory, or
// the block's shared memory.
enum Where { kGather, kRow, kShared };

// Offsets of a thread's slots from its slot 0 (base, at row position
// pos0): slot i lies base + (i << w) in shared memory and pos0 + rel(i) in
// the row, rel(i) the sum of the row offsets of the window bits set in i.
// Neither base nor pos0 has a bit where a slot's offset has one, so each
// address is a pointer at slot 0 plus an offset that is a constant in a
// kernel of fixed shape, and so is each twiddle's (pos mod 2^s of a slot
// is pos0 mod 2^s plus its offset).
template <int LOG_R>
struct Slots {
  uint32_t step[LOG_R];

  ZIGZ_HD Slots(const Block& b, int w) {
#pragma unroll
    for (int j = 0; j < LOG_R; ++j) step[j] = row_offset(b, 1u << (w + j)) - b.origin;
  }

  ZIGZ_HD uint32_t rel(int i) const {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < LOG_R; ++j) {
      if ((i >> j) & 1) x += step[j];
    }
    return x;
  }
};

// One thread's part of one register pass: load its 2^LOG_R values and the
// 2^LOG_R - 1 twiddles of the pass's stages (register bit d is stage
// stage0 + w + d - col_bits; its butterflies with equal low d bits share
// one twiddle, at t[2^d - 1 + those bits]), run the stages, store the
// values.
template <int LOG_R, Where FROM, Where TO>
ZIGZ_HD void thread_pass(const Block& b, int pass, uint32_t tau, const uint32_t* row_in, uint32_t* row,
                         uint32_t* xs, const uint32_t* tw) {
  constexpr int kR = 1 << LOG_R;
  const int w = pass_window(b, LOG_R, pass);
  const uint32_t base = thread_base(tau, w, LOG_R);
  const uint32_t pos0 = row_offset(b, base);
  const Slots<LOG_R> at(b, w);
  const int lo = b.col_bits + LOG_R * pass;  // the pass's stages: local bits [lo, hi)
  const int hi = lo + LOG_R < b.bits ? lo + LOG_R : b.bits;
  uint32_t v[kR], t[kR - 1];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (FROM == kShared) {
      v[i] = (xs + base)[i << w];
    } else if (FROM == kRow) {
      v[i] = (row + pos0)[at.rel(i)];
    } else {  // (pos0 + rel) >> log_k reversed: the sum of the two parts' reverses
      v[i] = (row_in + bit_reverse(pos0 >> b.log_k, b.log_n))[bit_reverse(at.rel(i) >> b.log_k, b.log_n)];
    }
  }
#pragma unroll
  for (int d = 0; d < LOG_R; ++d) {
    if (w + d < lo || w + d >= hi) continue;
    const uint32_t mask = (1u << (b.stage0 + w + d - b.col_bits)) - 1;  // 2^s - 1
    const uint32_t* tw_s = tw + mask + (pos0 & mask);
#pragma unroll
    for (int m = 0; m < (kR >> 1); ++m) {
      if (m < (1 << d)) t[(1 << d) - 1 + m] = tw_s[at.rel(m)];
    }
  }
#pragma unroll
  for (int d = 0; d < LOG_R; ++d) {
    if (w + d < lo || w + d >= hi) continue;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (!(i & (1 << d))) butterfly_values(v[i], v[i | (1 << d)], t[(1 << d) - 1 + (i & ((1 << d) - 1))]);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (TO == kShared) {
      (xs + base)[i << w] = v[i];
    } else {
      (row + pos0)[at.rel(i)] = v[i];
    }
  }
}

// Thread tau's part of pass ``pass`` of ``passes``: the first reads from
// FIRST, the last writes the row, the others go through shared memory.
template <int LOG_R, Where FIRST>
ZIGZ_HD void block_thread_pass(const Block& b, int pass, int passes, uint32_t tau, const uint32_t* row_in,
                               uint32_t* row, uint32_t* xs, const uint32_t* tw) {
  if (passes == 1) {
    thread_pass<LOG_R, FIRST, kRow>(b, pass, tau, row_in, row, xs, tw);
  } else if (pass == 0) {
    thread_pass<LOG_R, FIRST, kShared>(b, pass, tau, row_in, row, xs, tw);
  } else if (pass + 1 < passes) {
    thread_pass<LOG_R, kShared, kShared>(b, pass, tau, row_in, row, xs, tw);
  } else {
    thread_pass<LOG_R, kShared, kRow>(b, pass, tau, row_in, row, xs, tw);
  }
}

// A kernel's instance: the values a thread holds (LOG_R) and, for the main
// path's blocks, the block's shape fixed at compile time (FX), so that every
// window, step and address offset of its register passes is a constant.
template <int BITS, int COL_BITS, int STAGE0>
struct Fixed {
  static constexpr bool kFixed = BITS >= 0;
  ZIGZ_HD static Block apply(Block b) {
    if (kFixed) {
      b.bits = BITS;
      b.col_bits = COL_BITS;
      b.stage0 = STAGE0;
      if (STAGE0 == COL_BITS && COL_BITS < BITS) b.log_k = COL_BITS;  // a tile's copies: k = 2^log_head
    }
    return b;
  }
};
using Generic = Fixed<-1, -1, -1>;
// N1 of a rate-1/8 encode (k = 8) of a full tile: stages 3 .. 12.
using TileK8 = Fixed<kLogTile, 3, 3>;
// N2's one pass of stages 13 .. 18 (n_out = 2^19) and 13 .. 19 (2^20).
using PassG6 = Fixed<kLogColumns + 6, kLogColumns, kLogTile>;
using PassG7 = Fixed<kLogColumns + 7, kLogColumns, kLogTile>;

// f.template run<log_r, Generic>() for log_r <= LOG_R.
template <int LOG_R, class F>
inline void with_generic(int log_r, F& f) {
  if constexpr (LOG_R > 1) {
    if (log_r < LOG_R) {
      with_generic<LOG_R - 1>(log_r, f);
      return;
    }
  }
  f.template run<LOG_R, Generic>();
}

// Calls f.template run<LOG_R, FX>() with block b's instance: the card's
// launchers and the host entry choose through this one function.  TILE:
// b is N1's block (else N2's); each kernel is built in its own instances
// only.
template <bool TILE, class F>
inline void with_instance(const Block& b, F& f) {
  constexpr int kR = TILE ? kTileLogRadix : kPassLogRadix;
  if (b.bits >= kR) {
    if constexpr (TILE) {
      if (b.bits == kLogTile && b.col_bits == 3 && b.stage0 == 3) {
        f.template run<kR, TileK8>();
        return;
      }
    } else {
      if (b.col_bits == kLogColumns && b.stage0 == kLogTile && b.bits == kLogColumns + 6) {
        f.template run<kR, PassG6>();
        return;
      }
      if (b.col_bits == kLogColumns && b.stage0 == kLogTile && b.bits == kLogColumns + 7) {
        f.template run<kR, PassG7>();
        return;
      }
    }
  }
  with_generic<kR>(block_log_r(b, kR), f);
}

}  // namespace zigz_ntt

extern "C" {

// N2's passes of an (R, n) -> (R, n_out) encode: *count passes, pass i the
// stages [bounds[i], bounds[i + 1]), one launch each (bounds holds
// kLogMaxOut + 1 entries); N1 runs the stages below bounds[0] that the skip
// rule keeps.  The split is the plan's alone: the wrapper (ops/ntt_dev.py
// n2_passes) and chip_smoke.py read it from here.  Returns 0, or 1
// (cudaErrorInvalidValue) for n, n_out that make_plan refuses.  Defined in
// the header for the one unit of each library that includes it
// (ntt_kernels.cu; the CPU tests' host build).
int zigz_ntt_passes(int64_t n, int64_t n_out, int64_t* bounds, int64_t* count) {
  zigz_ntt::Plan p;
  if (zigz_ntt::make_plan(0, n, n_out, zigz_ntt::kTile, zigz_ntt::kMaxPassStages, INT64_MAX / 2, &p)) return 1;
  for (int i = 0; i <= p.passes; ++i) bounds[i] = zigz_ntt::pass_first(p, i);
  *count = p.passes;
  return 0;
}

}  // extern "C"

#ifndef __CUDACC__

#include <cstddef>
#include <vector>

namespace zigz_ntt {

// One block on the host: every pass, every thread of it in turn, through
// the steps the card's block runs, in the instance the card's launcher
// takes (a pass's threads touch disjoint values, so running them in turn
// computes what the card's block computes between two barriers).
template <Where FIRST>
struct HostBlock {
  const Block& b;
  const uint32_t* row_in;
  uint32_t* row;
  const uint32_t* tw;
  std::vector<uint32_t>& xs;

  template <int LOG_R, class FX>
  void run() {
    const Block fb = FX::apply(b);
    xs.assign(std::size_t{1} << fb.bits, 0);
    const int passes = block_passes(fb, LOG_R);
    for (int pass = 0; pass < passes; ++pass) {
      for (int tau = 0; tau < block_threads(fb, LOG_R); ++tau) {
        block_thread_pass<LOG_R, FIRST>(fb, pass, passes, static_cast<uint32_t>(tau), row_in, row, xs.data(), tw);
      }
    }
  }
};

template <Where FIRST>
void block_host(const Block& b, const uint32_t* row_in, uint32_t* row, const uint32_t* tw,
                std::vector<uint32_t>& xs) {
  HostBlock<FIRST> f{b, row_in, row, tw, xs};
  with_instance<FIRST == kGather>(b, f);
}

}  // namespace zigz_ntt

extern "C" {

// The encode on the host, for the CPU tests: the launches of the card in
// their order, N1 on every (row, tile), then each N2 pass over every (row,
// block), with tiles of ``tile`` outputs and passes of at most ``max_pass``
// stages.  ``in`` (rows, n), ``out`` (rows, n_out), ``tw`` the n_out - 1
// twiddles in Montgomery form; *pass_launches gets N2's launches.  Returns
// 0, or 1 for a shape the card refuses too.
int zigz_ntt_encode_host(const uint32_t* in, const uint32_t* tw, uint32_t* out, int64_t rows, int64_t n,
                         int64_t n_out, int64_t tile, int64_t max_pass, int64_t* pass_launches) {
  zigz_ntt::Plan p;
  if (zigz_ntt::make_plan(rows, n, n_out, tile, max_pass, INT64_MAX / 2, &p)) return 1;
  std::vector<uint32_t> xs;
  for (int64_t row = 0; row < rows; ++row) {
    for (int64_t t = 0; t < p.tiles; ++t) {
      zigz_ntt::block_host<zigz_ntt::kGather>(zigz_ntt::tile_block(p, t), in + row * n, out + row * n_out, tw, xs);
    }
  }
  for (int i = 0; i < p.passes; ++i) {
    const int first = zigz_ntt::pass_first(p, i), end = zigz_ntt::pass_first(p, i + 1);
    for (int64_t row = 0; row < rows; ++row) {
      for (int64_t r = 0; r < zigz_ntt::pass_blocks_a_row(p.log_out, first, end); ++r) {
        zigz_ntt::block_host<zigz_ntt::kRow>(zigz_ntt::pass_block(first, end, r), nullptr, out + row * n_out, tw,
                                             xs);
      }
    }
  }
  *pass_launches = p.passes;
  return 0;
}

int64_t zigz_ntt_tile_host() { return zigz_ntt::kTile; }

int64_t zigz_ntt_max_pass_host() { return zigz_ntt::kMaxPassStages; }

}  // extern "C"

#endif  // __CUDACC__
