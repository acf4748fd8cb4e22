// The steps of kernel W1 (witness_kernels.cu): the eleven non-register rows
// of the v1 witness, and the reduced write value and write index that the
// register forward fill reads, from the native VM's trace columns as the VM
// wrote them.  Shared by the kernel and by the host entry at the end of this
// file, which the CPU tests build with g++ and hold to the plain PyTorch
// version (ops/witness_dev.py ``_witness_rows_plain``).
//
// The columns: pc, imm (int64 bits), reg_write_val, mem_addr and mem_val
// (u64); opcode, rd, rs1, rs2, funct3, funct7, reg_write_idx and mem_flag
// (u8), n_real entries each.  The output: rows 0 and 33-42 of the (43, n)
// witness, row-major, n >= n_real; steps t >= n_real are padding: pc
// repeats the trace's last pc (``last_pc``), every other row and the write
// index are zero.  Row 0 pc, 33-38 the u8 fields, 39 imm (its u64 bits
// reduced as unsigned), 40-41 mem_addr and mem_val (zero where mem_flag is
// 0), 42 mem_flag == 1 (a load).
//
// The reduction of an unsigned u64 mod p comes from the field's type,
// chosen by the launcher: ``Narrow`` for every p below 2^31 (u32 words),
// ``Wide<Goldilocks>`` and ``Wide<Mersenne61>`` (u64 words; field64.cuh
// ``from_u64``).  Each thread takes kSteps neighbouring steps: one 4-byte
// load of each u8 column, two 16-byte loads of each u64 one, and one
// 16-byte store (u32 words) or two (u64 words) a row, so a warp reads and
// writes whole contiguous lines.
#pragma once

#include <cstdint>

#include "field64.cuh"

namespace zigz_witness {

constexpr int kSteps = 4;      // steps a thread
constexpr int kSmallRow = 33; // the first u8 field's row
constexpr int kU64Columns = 5;
constexpr int kU8Columns = 8;

// Device (or host) pointers of the trace's columns.
struct Columns {
  const uint64_t* pc;
  const uint64_t* imm;
  const uint64_t* wr_val;
  const uint64_t* mem_addr;
  const uint64_t* mem_val;
  const uint8_t* small[6];  // opcode, rd, rs1, rs2, funct3, funct7: rows 33-38
  const uint8_t* wr_idx;
  const uint8_t* mem_flag;
};

// The columns in the order of the launcher's two arrays of pointers.
inline Columns make_columns(const void* const* u64_cols, const void* const* u8_cols) {
  Columns c;
  c.pc = static_cast<const uint64_t*>(u64_cols[0]);
  c.imm = static_cast<const uint64_t*>(u64_cols[1]);
  c.wr_val = static_cast<const uint64_t*>(u64_cols[2]);
  c.mem_addr = static_cast<const uint64_t*>(u64_cols[3]);
  c.mem_val = static_cast<const uint64_t*>(u64_cols[4]);
  for (int j = 0; j < 6; ++j) c.small[j] = static_cast<const uint8_t*>(u8_cols[j]);
  c.wr_idx = static_cast<const uint8_t*>(u8_cols[6]);
  c.mem_flag = static_cast<const uint8_t*>(u8_cols[7]);
  return c;
}

template <class W>
struct Outputs {
  W* rows;          // (43, n): rows 0 and 33-42 written
  W* wr_val;        // (n,): the write value reduced, 0 past n_real
  uint8_t* wr_idx;  // (n,): the write index, 0 past n_real
};

// A field below 2^31: Barrett's reduction with m = floor((2^64 - 1) / p)
// = (2^64 - 1 - s) / p, s < p.  v m / 2^64 = v / p - v (1 + s) / (p 2^64)
// lies within 1 below v / p, so q = floor(v m / 2^64) is floor(v / p) or
// one less, v - q p < 2p, and one conditional subtract finishes it.
struct Narrow {
  using Word = uint32_t;
  uint64_t p, m;
  ZIGZ_HD uint64_t reduce(uint64_t v) const {
    uint64_t lo, q;
    zigz64::mul_wide(v, m, lo, q);
    const uint64_t r = v - q * p;
    return r >= p ? r - p : r;
  }
};

template <class F>
struct Wide {
  using Word = uint64_t;
  ZIGZ_HD uint64_t reduce(uint64_t v) const { return F::from_u64(v); }
};

ZIGZ_HD void load4(const uint64_t* p, uint64_t (&v)[kSteps]) {
#ifdef __CUDA_ARCH__
  const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(p));
  const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
#else
  for (int k = 0; k < kSteps; ++k) v[k] = p[k];
#endif
}

ZIGZ_HD void load4(const uint8_t* p, uint8_t (&v)[kSteps]) {
#ifdef __CUDA_ARCH__
  const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));
  for (int k = 0; k < kSteps; ++k) v[k] = static_cast<uint8_t>(w >> (8 * k));
#else
  for (int k = 0; k < kSteps; ++k) v[k] = p[k];
#endif
}

ZIGZ_HD void store4(uint32_t* p, const uint32_t (&v)[kSteps]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int k = 0; k < kSteps; ++k) p[k] = v[k];
#endif
}

ZIGZ_HD void store4(uint64_t* p, const uint64_t (&v)[kSteps]) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<ulonglong2*>(p)[0] = make_ulonglong2(v[0], v[1]);
  reinterpret_cast<ulonglong2*>(p)[1] = make_ulonglong2(v[2], v[3]);
#else
  for (int k = 0; k < kSteps; ++k) p[k] = v[k];
#endif
}

ZIGZ_HD void store4(uint8_t* p, const uint8_t (&v)[kSteps]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<unsigned int*>(p) = v[0] | v[1] << 8 | v[2] << 16 | static_cast<unsigned int>(v[3]) << 24;
#else
  for (int k = 0; k < kSteps; ++k) p[k] = v[k];
#endif
}

// Steps t0 .. t0 + kSteps - 1 of a column, ``fill`` past n_real.  A whole
// group is one vector load (a column's start is aligned: the launcher checks).
template <class T>
ZIGZ_HD void load_steps(const T* col, int64_t t0, int64_t n_real, T fill, T (&v)[kSteps]) {
  if (t0 + kSteps <= n_real) {
    load4(col, v);
    return;
  }
  for (int k = 0; k < kSteps; ++k) v[k] = t0 + k < n_real ? col[k] : fill;
}

// The group's values into a row at t0; vector stores when n is a multiple
// of kSteps (then every row's start is aligned too), else only t < n.
template <class T>
ZIGZ_HD void store_steps(T* row, int64_t t0, int64_t n, const T (&v)[kSteps]) {
  if (n % kSteps == 0) {
    store4(row + t0, v);
    return;
  }
  for (int k = 0; k < kSteps; ++k) {
    if (t0 + k < n) row[t0 + k] = v[k];
  }
}

// Group g of the output: steps g kSteps .. g kSteps + kSteps - 1.
template <class R>
ZIGZ_HD void witness_steps(const Columns& c, const Outputs<typename R::Word>& o, const R& f, int64_t g,
                           int64_t n_real, int64_t n, uint64_t last_pc) {
  using W = typename R::Word;
  const int64_t t0 = g * kSteps;
  W out[kSteps];
  uint64_t u[kSteps];
  uint8_t b[kSteps], flag[kSteps];

  load_steps(c.pc + t0, t0, n_real, last_pc, u);
  for (int k = 0; k < kSteps; ++k) out[k] = static_cast<W>(f.reduce(u[k]));
  store_steps(o.rows, t0, n, out);

  for (int j = 0; j < 6; ++j) {
    load_steps(c.small[j] + t0, t0, n_real, uint8_t{0}, b);
    for (int k = 0; k < kSteps; ++k) out[k] = static_cast<W>(f.reduce(b[k]));
    store_steps(o.rows + (kSmallRow + j) * n, t0, n, out);
  }

  load_steps(c.imm + t0, t0, n_real, uint64_t{0}, u);
  for (int k = 0; k < kSteps; ++k) out[k] = static_cast<W>(f.reduce(u[k]));
  store_steps(o.rows + 39 * n, t0, n, out);

  load_steps(c.mem_flag + t0, t0, n_real, uint8_t{0}, flag);
  load_steps(c.mem_addr + t0, t0, n_real, uint64_t{0}, u);
  for (int k = 0; k < kSteps; ++k) out[k] = flag[k] != 0 ? static_cast<W>(f.reduce(u[k])) : W{0};
  store_steps(o.rows + 40 * n, t0, n, out);
  load_steps(c.mem_val + t0, t0, n_real, uint64_t{0}, u);
  for (int k = 0; k < kSteps; ++k) out[k] = flag[k] != 0 ? static_cast<W>(f.reduce(u[k])) : W{0};
  store_steps(o.rows + 41 * n, t0, n, out);
  for (int k = 0; k < kSteps; ++k) out[k] = flag[k] == 1 ? W{1} : W{0};
  store_steps(o.rows + 42 * n, t0, n, out);

  load_steps(c.wr_val + t0, t0, n_real, uint64_t{0}, u);
  for (int k = 0; k < kSteps; ++k) out[k] = static_cast<W>(f.reduce(u[k]));
  store_steps(o.wr_val, t0, n, out);
  load_steps(c.wr_idx + t0, t0, n_real, uint8_t{0}, b);
  store_steps(o.wr_idx, t0, n, b);
}

// Runs ``Fn(field)`` with the field's type for modulus p; false for a p that
// is neither below 2^31 nor one of the two 64-bit fields.
template <class Fn>
bool with_field(uint64_t p, Fn&& fn) {
  if (p == zigz64::Goldilocks::kP) {
    fn(Wide<zigz64::Goldilocks>{});
  } else if (p == zigz64::Mersenne61::kP) {
    fn(Wide<zigz64::Mersenne61>{});
  } else if (p >= 2 && p < (uint64_t{1} << 31)) {
    fn(Narrow{p, UINT64_MAX / p});
  } else {
    return false;
  }
  return true;
}

}  // namespace zigz_witness

#ifndef __CUDACC__

// The CPU tests' entry: W1's groups in order, with the launcher's arguments
// (`rows` (43, n), `wr_val` (n,) of the field's word, `wr_idx` (n,)).
// Returns 0, or 1 for a modulus the launcher refuses.  Defined here, not
// inline, so that the one host unit that includes the header (the tests'
// build) exports it.
extern "C" {

int zigz_witness_rows_host(const void* const* u64_cols, const void* const* u8_cols, int64_t n_real, int64_t n,
                           uint64_t last_pc, uint64_t p, void* rows, void* wr_val, void* wr_idx) {
  if (n_real < 0 || n_real > n) return 1;
  const zigz_witness::Columns c = zigz_witness::make_columns(u64_cols, u8_cols);
  const bool ok = zigz_witness::with_field(p, [&](auto f) {
    using W = typename decltype(f)::Word;
    const zigz_witness::Outputs<W> o{static_cast<W*>(rows), static_cast<W*>(wr_val), static_cast<uint8_t*>(wr_idx)};
    for (int64_t g = 0; g * zigz_witness::kSteps < n; ++g) zigz_witness::witness_steps(c, o, f, g, n_real, n, last_pc);
  });
  return ok ? 0 : 1;
}

}  // extern "C"

#endif  // __CUDACC__
