// Threaded evaluator for traced zerocheck combiner DAGs (ops/symtrace.py).
//
// The host ZerocheckProver sweeps its combiner degree+1 times per round as
// dozens of full-width numpy temporaries; this executor runs the same DAG
// chunk-at-a-time so every intermediate stays L1/L2-resident, across all
// cores.  Node opcodes match symtrace: 0 COL, 1 CONST, 2 ZERO, 3 ADD,
// 4 SUB, 5 MUL.  BabyBear-only; all matrix values canonical < p.
//
// Arithmetic domain (round 4): DAG slots hold MONTGOMERY-form values
// (x*R mod P, R = 2^32).  COL loads convert on entry (one REDC by R2),
// CONST values are pre-converted by the entry points, ADD/SUB are
// domain-agnostic, and MUL is a single REDC — which, unlike the previous
// (u64)a*b % P, vectorizes to AVX-512 vpmuludq chains (bb_simd.h).  The
// output sums convert back with one REDC, so every number handed to
// Python is bit-identical to the old canonical evaluator.
//
// zigz_dag_round computes one zerocheck round's evaluations with the host
// prover's exact schedule: g(0) from the lo halves, g(2..d) from
// incremental +delta sweeps (g(1) is derived from the claim by the
// caller).  zigz_dag_fold folds all rows in place: lo + r*(hi - lo) —
// exact canonical products via the fixed-operand Montgomery trick
// (mont_mul(r*R, d) = r*d).

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "bb_simd.h"

static constexpr uint64_t P = bb::P;

using bb::addm32;
using bb::mont_mul;
using bb::subm32;
using bb::to_mont;

namespace {

constexpr size_t CHUNK = 1024;

struct DagSpec {
  const int32_t* ops;
  const int32_t* arga;
  const int32_t* argb;
  const int32_t* slot;
  const int32_t* colrow;  // row index for COL nodes, -1 otherwise
  size_t num_nodes;
  const uint32_t* consts;  // MONTGOMERY form (converted by entry points)
};

// Evaluate the DAG over one chunk. cols[r] points at the current CANONICAL
// value of row r for this chunk; slots is (num_slots, CHUNK) scratch in
// Montgomery form.
void eval_dag(const DagSpec& d, const uint32_t* const* cols, uint32_t* slots,
              size_t len) {
  for (size_t i = 0; i < d.num_nodes; ++i) {
    uint32_t* out = slots + (size_t)d.slot[i] * CHUNK;
    switch (d.ops[i]) {
      case 0: {  // COL: canonical -> Montgomery (x * R2 * R^-1 = x * R)
        const uint32_t* src = cols[d.colrow[i]];
        size_t k = 0;
#ifdef __AVX512F__
        const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
        for (; k + 8 <= len; k += 8)
          bb::mm_store_u32x8(out + k,
                             bb::mm_mont_mul(bb::mm_load_u32x8(src + k), r2));
#endif
        for (; k < len; ++k)
          out[k] = (uint32_t)mont_mul(src[k], bb::R2);
        break;
      }
      case 1: {  // CONST (already Montgomery form)
        uint32_t v = d.consts[d.arga[i]];
        for (size_t k = 0; k < len; ++k) out[k] = v;
        break;
      }
      case 2:  // ZERO
        std::memset(out, 0, len * sizeof(uint32_t));
        break;
      case 3: {  // ADD
        const uint32_t* x = slots + (size_t)d.slot[d.arga[i]] * CHUNK;
        const uint32_t* y = slots + (size_t)d.slot[d.argb[i]] * CHUNK;
        for (size_t k = 0; k < len; ++k) out[k] = addm32(x[k], y[k]);
        break;
      }
      case 4: {  // SUB
        const uint32_t* x = slots + (size_t)d.slot[d.arga[i]] * CHUNK;
        const uint32_t* y = slots + (size_t)d.slot[d.argb[i]] * CHUNK;
        for (size_t k = 0; k < len; ++k) out[k] = subm32(x[k], y[k]);
        break;
      }
      default: {  // MUL: Montgomery REDC (domain-closed)
        const uint32_t* x = slots + (size_t)d.slot[d.arga[i]] * CHUNK;
        const uint32_t* y = slots + (size_t)d.slot[d.argb[i]] * CHUNK;
        size_t k = 0;
#ifdef __AVX512F__
        for (; k + 8 <= len; k += 8)
          bb::mm_store_u32x8(
              out + k,
              bb::mm_mont_mul(bb::mm_load_u32x8(x + k), bb::mm_load_u32x8(y + k)));
#endif
        for (; k < len; ++k) out[k] = (uint32_t)mont_mul(x[k], y[k]);
        break;
      }
    }
  }
}

// Split [0, n) into chunk-aligned thread ranges.
void run_parallel(size_t n, int num_threads,
                  const std::function<void(size_t, size_t, int)>& fn) {
  size_t want = num_threads > 0 ? (size_t)num_threads : 1;
  size_t nchunks = (n + CHUNK - 1) / CHUNK;
  size_t nthreads = nchunks < want ? (nchunks ? nchunks : 1) : want;
  if (nthreads <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> threads;
  size_t per = ((nchunks + nthreads - 1) / nthreads) * CHUNK;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t lo = t * per;
    size_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi, (int)t);
  }
  for (auto& th : threads) th.join();
}

std::vector<uint32_t> consts_to_mont(const uint32_t* consts, size_t num_nodes,
                                     const int32_t* ops, const int32_t* arga) {
  // Convert only referenced const slots; sizes are tiny.
  size_t max_idx = 0;
  for (size_t i = 0; i < num_nodes; ++i)
    if (ops[i] == 1 && (size_t)arga[i] + 1 > max_idx) max_idx = (size_t)arga[i] + 1;
  std::vector<uint32_t> out(max_idx);
  for (size_t i = 0; i < max_idx; ++i) out[i] = (uint32_t)to_mont(consts[i]);
  return out;
}

}  // namespace

// stacked: (nrows, stride) row-major canonical uint32; the current table
// width n <= stride occupies the first n entries of each row.  eq_row is
// the eq-table row index; the DAG reads rows via its colrow mapping.
// out receives `degree` values: g(0), g(2), ..., g(degree).
extern "C" void zigz_dag_round(
    const uint32_t* stacked, size_t stride, size_t nrows, size_t n,
    const int32_t* ops, const int32_t* arga, const int32_t* argb,
    const int32_t* slot, const int32_t* colrow, size_t num_nodes,
    size_t num_slots, const uint32_t* consts, int32_t out_slot,
    int32_t eq_row, int degree, uint64_t* out, int num_threads) {
  size_t half = n / 2;
  int nt = num_threads > 0 ? num_threads : 1;
  std::vector<std::vector<uint64_t>> accs((size_t)nt,
                                          std::vector<uint64_t>((size_t)degree, 0));
  std::vector<uint32_t> cm = consts_to_mont(consts, num_nodes, ops, arga);
  DagSpec d{ops, arga, argb, slot, colrow, num_nodes, cm.data()};

  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int tid) {
    std::vector<uint32_t> slots(num_slots * CHUNK);
    std::vector<uint32_t> cur(nrows * CHUNK);
    std::vector<uint32_t> delta(nrows * CHUNK);
    std::vector<const uint32_t*> cols(nrows);
    uint64_t* acc = accs[(size_t)tid].data();

    for (size_t s = lo; s < hi; s += CHUNK) {
      size_t len = (s + CHUNK < hi) ? CHUNK : hi - s;

      // t = 0: columns read the lo halves in place.
      for (size_t r = 0; r < nrows; ++r) cols[r] = stacked + r * stride + s;
      eval_dag(d, cols.data(), slots.data(), len);
      {
        const uint32_t* eq = stacked + (size_t)eq_row * stride + s;
        const uint32_t* v = slots.data() + (size_t)out_slot * CHUNK;
        uint64_t a = 0;
        // v is Montgomery, eq canonical: REDC(v~ * eq) = v * eq canonical.
        for (size_t k = 0; k < len; ++k) a += mont_mul(v[k], eq[k]);
        acc[0] += a % P;
      }

      if (degree >= 2) {
        // cur = hi halves (t = 1), delta = hi - lo.
        for (size_t r = 0; r < nrows; ++r) {
          const uint32_t* plo = stacked + r * stride + s;
          const uint32_t* phi = plo + half;
          uint32_t* c = cur.data() + r * CHUNK;
          uint32_t* dl = delta.data() + r * CHUNK;
          for (size_t k = 0; k < len; ++k) {
            c[k] = phi[k];
            dl[k] = subm32(phi[k], plo[k]);
          }
          cols[r] = c;
        }
        for (int t = 2; t <= degree; ++t) {
          for (size_t r = 0; r < nrows; ++r) {
            uint32_t* c = cur.data() + r * CHUNK;
            const uint32_t* dl = delta.data() + r * CHUNK;
            for (size_t k = 0; k < len; ++k) c[k] = addm32(c[k], dl[k]);
          }
          eval_dag(d, cols.data(), slots.data(), len);
          const uint32_t* eq = cur.data() + (size_t)eq_row * CHUNK;
          const uint32_t* v = slots.data() + (size_t)out_slot * CHUNK;
          uint64_t a = 0;
          for (size_t k = 0; k < len; ++k) a += mont_mul(v[k], eq[k]);
          acc[t - 1] += a % P;
        }
      }
    }
  });

  for (int j = 0; j < degree; ++j) {
    uint64_t total = 0;
    for (auto& a : accs) total = (total + a[(size_t)j]) % P;
    out[j] = total;
  }
}

// Multi-output round for the EXTENSION zerocheck (BabyBear^4, X^4 = 11):
// the traced DAG already contains the eq*C product, its 4 coordinate
// outputs are plain base rows, so this is zigz_dag_round minus the eq
// multiplication, accumulating `num_out` slot sums per t.  out receives
// degree * num_out values laid out [t][coord]: g(0), g(2), ..., g(degree)
// (g(1) is derived from the running claim by the caller).
extern "C" void zigz_dag_round_multi(
    const uint32_t* stacked, size_t stride, size_t nrows, size_t n,
    const int32_t* ops, const int32_t* arga, const int32_t* argb,
    const int32_t* slot, const int32_t* colrow, size_t num_nodes,
    size_t num_slots, const uint32_t* consts, const int32_t* out_slots,
    int num_out, int degree, uint64_t* out, int num_threads) {
  size_t half = n / 2;
  int nt = num_threads > 0 ? num_threads : 1;
  size_t cells = (size_t)degree * (size_t)num_out;
  std::vector<std::vector<uint64_t>> accs((size_t)nt,
                                          std::vector<uint64_t>(cells, 0));
  std::vector<uint32_t> cm = consts_to_mont(consts, num_nodes, ops, arga);
  DagSpec d{ops, arga, argb, slot, colrow, num_nodes, cm.data()};

  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int tid) {
    std::vector<uint32_t> slots(num_slots * CHUNK);
    std::vector<uint32_t> cur(nrows * CHUNK);
    std::vector<uint32_t> delta(nrows * CHUNK);
    std::vector<const uint32_t*> cols(nrows);
    uint64_t* acc = accs[(size_t)tid].data();

    for (size_t s = lo; s < hi; s += CHUNK) {
      size_t len = (s + CHUNK < hi) ? CHUNK : hi - s;

      for (size_t r = 0; r < nrows; ++r) cols[r] = stacked + r * stride + s;
      eval_dag(d, cols.data(), slots.data(), len);
      for (int e = 0; e < num_out; ++e) {
        const uint32_t* v = slots.data() + (size_t)out_slots[e] * CHUNK;
        uint64_t a = 0;
        for (size_t k = 0; k < len; ++k) a += v[k];
        acc[e] = (acc[e] + a) % P;
      }

      if (degree >= 2) {
        for (size_t r = 0; r < nrows; ++r) {
          const uint32_t* plo = stacked + r * stride + s;
          const uint32_t* phi = plo + half;
          uint32_t* c = cur.data() + r * CHUNK;
          uint32_t* dl = delta.data() + r * CHUNK;
          for (size_t k = 0; k < len; ++k) {
            c[k] = phi[k];
            dl[k] = subm32(phi[k], plo[k]);
          }
          cols[r] = c;
        }
        for (int t = 2; t <= degree; ++t) {
          for (size_t r = 0; r < nrows; ++r) {
            uint32_t* c = cur.data() + r * CHUNK;
            const uint32_t* dl = delta.data() + r * CHUNK;
            for (size_t k = 0; k < len; ++k) c[k] = addm32(c[k], dl[k]);
          }
          eval_dag(d, cols.data(), slots.data(), len);
          for (int e = 0; e < num_out; ++e) {
            const uint32_t* v = slots.data() + (size_t)out_slots[e] * CHUNK;
            uint64_t a = 0;
            for (size_t k = 0; k < len; ++k) a += v[k];
            size_t cell = (size_t)(t - 1) * num_out + e;
            acc[cell] = (acc[cell] + a) % P;
          }
        }
      }
    }
  });

  for (size_t c = 0; c < cells; ++c) {
    uint64_t total = 0;
    for (auto& a : accs) total = (total + a[c]) % P;
    // Slot sums are Montgomery-form; one REDC restores the canonical
    // value the numpy prover would have produced.
    out[c] = bb::from_mont(total);
  }
}

namespace {

// Vectorized ext4 fold core: given canonical d0..d3 lanes and Montgomery
// forms of the challenge coordinates, produce the canonical X^4 = 11
// product lanes p0..p3 (each partial reduced, matching core/ext4.py).
#ifdef __AVX512F__
struct ExtR {
  __m512i r0, r1, r2, r3, elevenR;
};
static inline ExtR ext_r_load(const uint64_t* r4) {
  ExtR e;
  e.r0 = _mm512_set1_epi64((long long)to_mont(r4[0] % P));
  e.r1 = _mm512_set1_epi64((long long)to_mont(r4[1] % P));
  e.r2 = _mm512_set1_epi64((long long)to_mont(r4[2] % P));
  e.r3 = _mm512_set1_epi64((long long)to_mont(r4[3] % P));
  e.elevenR = _mm512_set1_epi64((long long)to_mont(11));
  return e;
}
static inline void ext_mul_r(const ExtR& e, __m512i d0, __m512i d1, __m512i d2,
                             __m512i d3, __m512i* p0, __m512i* p1, __m512i* p2,
                             __m512i* p3) {
  using bb::mm_addm;
  using bb::mm_mont_mul;
  *p0 = mm_addm(mm_mont_mul(e.r0, d0),
                mm_mont_mul(e.elevenR,
                            mm_addm(mm_addm(mm_mont_mul(e.r1, d3),
                                            mm_mont_mul(e.r2, d2)),
                                    mm_mont_mul(e.r3, d1))));
  *p1 = mm_addm(mm_addm(mm_mont_mul(e.r0, d1), mm_mont_mul(e.r1, d0)),
                mm_mont_mul(e.elevenR, mm_addm(mm_mont_mul(e.r2, d3),
                                               mm_mont_mul(e.r3, d2))));
  *p2 = mm_addm(mm_addm(mm_mont_mul(e.r0, d2), mm_mont_mul(e.r1, d1)),
                mm_addm(mm_mont_mul(e.r2, d0),
                        mm_mont_mul(e.elevenR, mm_mont_mul(e.r3, d3))));
  *p3 = mm_addm(mm_addm(mm_mont_mul(e.r0, d3), mm_mont_mul(e.r1, d2)),
                mm_addm(mm_mont_mul(e.r2, d1), mm_mont_mul(e.r3, d0)));
}
#endif

// Scalar ext4 * fixed-r product via the Montgomery fixed-operand trick;
// rm[e] = to_mont(r_e), elevenR = to_mont(11).  Canonical in/out, residues
// identical to the previous mulm-based expressions.
inline void ext_mul_r_scalar(const uint64_t rm[4], uint64_t elevenR,
                             uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3,
                             uint32_t* p0, uint32_t* p1, uint32_t* p2,
                             uint32_t* p3) {
  uint32_t m00 = (uint32_t)mont_mul(rm[0], d0), m01 = (uint32_t)mont_mul(rm[0], d1),
           m02 = (uint32_t)mont_mul(rm[0], d2), m03 = (uint32_t)mont_mul(rm[0], d3);
  uint32_t m10 = (uint32_t)mont_mul(rm[1], d0), m11 = (uint32_t)mont_mul(rm[1], d1),
           m12 = (uint32_t)mont_mul(rm[1], d2), m13 = (uint32_t)mont_mul(rm[1], d3);
  uint32_t m20 = (uint32_t)mont_mul(rm[2], d0), m21 = (uint32_t)mont_mul(rm[2], d1),
           m22 = (uint32_t)mont_mul(rm[2], d2), m23 = (uint32_t)mont_mul(rm[2], d3);
  uint32_t m30 = (uint32_t)mont_mul(rm[3], d0), m31 = (uint32_t)mont_mul(rm[3], d1),
           m32 = (uint32_t)mont_mul(rm[3], d2), m33 = (uint32_t)mont_mul(rm[3], d3);
  *p0 = addm32(m00, (uint32_t)mont_mul(elevenR, addm32(addm32(m13, m22), m31)));
  *p1 = addm32(addm32(m01, m10), (uint32_t)mont_mul(elevenR, addm32(m23, m32)));
  *p2 = addm32(addm32(m02, m11), addm32(m20, (uint32_t)mont_mul(elevenR, m33)));
  *p3 = addm32(addm32(m03, m12), addm32(m21, m30));
}

}  // namespace

// In-place MSB fold with an EXTENSION challenge r (4 canonical coords,
// X^4 = 11): rows come in 4-row coordinate groups; for each group
// new = lo + r*(hi - lo) as BabyBear^4 elements.
extern "C" void zigz_dag_fold_ext(uint32_t* stacked, size_t stride,
                                  size_t ngroups, size_t n,
                                  const uint64_t* r4, int num_threads) {
  size_t half = n / 2;
  uint64_t rm[4] = {to_mont(r4[0] % P), to_mont(r4[1] % P), to_mont(r4[2] % P),
                    to_mont(r4[3] % P)};
  uint64_t elevenR = to_mont(11);
#ifdef __AVX512F__
  ExtR er = ext_r_load(r4);
#endif
  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int) {
    for (size_t g = 0; g < ngroups; ++g) {
      uint32_t* b0 = stacked + (g * 4 + 0) * stride;
      uint32_t* b1 = stacked + (g * 4 + 1) * stride;
      uint32_t* b2 = stacked + (g * 4 + 2) * stride;
      uint32_t* b3 = stacked + (g * 4 + 3) * stride;
      size_t i = lo;
#ifdef __AVX512F__
      for (; i + 8 <= hi; i += 8) {
        __m512i l0 = bb::mm_load_u32x8(b0 + i), h0 = bb::mm_load_u32x8(b0 + half + i);
        __m512i l1 = bb::mm_load_u32x8(b1 + i), h1 = bb::mm_load_u32x8(b1 + half + i);
        __m512i l2 = bb::mm_load_u32x8(b2 + i), h2 = bb::mm_load_u32x8(b2 + half + i);
        __m512i l3 = bb::mm_load_u32x8(b3 + i), h3 = bb::mm_load_u32x8(b3 + half + i);
        __m512i p0, p1, p2, p3;
        ext_mul_r(er, bb::mm_subm(h0, l0), bb::mm_subm(h1, l1),
                  bb::mm_subm(h2, l2), bb::mm_subm(h3, l3), &p0, &p1, &p2, &p3);
        bb::mm_store_u32x8(b0 + i, bb::mm_addm(l0, p0));
        bb::mm_store_u32x8(b1 + i, bb::mm_addm(l1, p1));
        bb::mm_store_u32x8(b2 + i, bb::mm_addm(l2, p2));
        bb::mm_store_u32x8(b3 + i, bb::mm_addm(l3, p3));
      }
#endif
      for (; i < hi; ++i) {
        uint32_t d0 = subm32(b0[half + i], b0[i]);
        uint32_t d1 = subm32(b1[half + i], b1[i]);
        uint32_t d2 = subm32(b2[half + i], b2[i]);
        uint32_t d3 = subm32(b3[half + i], b3[i]);
        uint32_t p0, p1, p2, p3;
        ext_mul_r_scalar(rm, elevenR, d0, d1, d2, d3, &p0, &p1, &p2, &p3);
        b0[i] = addm32(b0[i], p0);
        b1[i] = addm32(b1[i], p1);
        b2[i] = addm32(b2[i], p2);
        b3[i] = addm32(b3[i], p3);
      }
    }
  });
}

// In-place MSB fold of every row: row[i] = row[i] + r*(row[half+i] -
// row[i]) mod P for i < n/2.  Row stride stays fixed; the caller tracks
// the shrinking width.
extern "C" void zigz_dag_fold(uint32_t* stacked, size_t stride, size_t nrows,
                              size_t n, uint64_t r, int num_threads) {
  size_t half = n / 2;
  uint64_t rm = to_mont(r % P);
  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int) {
    for (size_t row = 0; row < nrows; ++row) {
      uint32_t* base = stacked + row * stride;
      size_t i = lo;
#ifdef __AVX512F__
      const __m512i rmv = _mm512_set1_epi64((long long)rm);
      for (; i + 8 <= hi; i += 8) {
        __m512i l = bb::mm_load_u32x8(base + i);
        __m512i h = bb::mm_load_u32x8(base + half + i);
        __m512i p = bb::mm_mont_mul(rmv, bb::mm_subm(h, l));
        bb::mm_store_u32x8(base + i, bb::mm_addm(l, p));
      }
#endif
      for (; i < hi; ++i) {
        uint32_t lo32 = base[i];
        uint32_t hi32 = base[half + i];
        base[i] = addm32(lo32, (uint32_t)mont_mul(rm, subm32(hi32, lo32)));
      }
    }
  });
}

// Round-1 -> rounds-2+ layout transition for the hybrid ext zerocheck:
// fold BASE rows (single coordinate row each) with an extension r into
// 4-row coordinate groups of a fresh matrix.  new = lo + r*(hi - lo)
// where lo/hi are base: coordinate e of the result is lo*[e==0] + r_e*d.
extern "C" void zigz_dag_fold_base_to_ext(
    const uint32_t* in, size_t in_stride, size_t nrows, size_t n,
    uint32_t* out, size_t out_stride, const uint64_t* r4, int num_threads) {
  size_t half = n / 2;
  uint64_t rm[4] = {to_mont(r4[0] % P), to_mont(r4[1] % P), to_mont(r4[2] % P),
                    to_mont(r4[3] % P)};
  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int) {
    for (size_t row = 0; row < nrows; ++row) {
      const uint32_t* src = in + row * in_stride;
      uint32_t* o0 = out + (row * 4 + 0) * out_stride;
      uint32_t* o1 = out + (row * 4 + 1) * out_stride;
      uint32_t* o2 = out + (row * 4 + 2) * out_stride;
      uint32_t* o3 = out + (row * 4 + 3) * out_stride;
      size_t i = lo;
#ifdef __AVX512F__
      const __m512i r0 = _mm512_set1_epi64((long long)rm[0]);
      const __m512i r1 = _mm512_set1_epi64((long long)rm[1]);
      const __m512i r2 = _mm512_set1_epi64((long long)rm[2]);
      const __m512i r3 = _mm512_set1_epi64((long long)rm[3]);
      for (; i + 8 <= hi; i += 8) {
        __m512i l = bb::mm_load_u32x8(src + i);
        __m512i d = bb::mm_subm(bb::mm_load_u32x8(src + half + i), l);
        bb::mm_store_u32x8(o0 + i, bb::mm_addm(l, bb::mm_mont_mul(r0, d)));
        bb::mm_store_u32x8(o1 + i, bb::mm_mont_mul(r1, d));
        bb::mm_store_u32x8(o2 + i, bb::mm_mont_mul(r2, d));
        bb::mm_store_u32x8(o3 + i, bb::mm_mont_mul(r3, d));
      }
#endif
      for (; i < hi; ++i) {
        uint32_t l = src[i];
        uint32_t d = subm32(src[half + i], l);
        o0[i] = addm32(l, (uint32_t)mont_mul(rm[0], d));
        o1[i] = (uint32_t)mont_mul(rm[1], d);
        o2[i] = (uint32_t)mont_mul(rm[2], d);
        o3[i] = (uint32_t)mont_mul(rm[3], d);
      }
    }
  });
}

// Out-of-place variant of zigz_dag_fold_ext: fold 4-row coordinate
// groups of ``in`` into the corresponding groups of ``out``.
extern "C" void zigz_dag_fold_ext_to(
    const uint32_t* in, size_t in_stride, size_t ngroups, size_t n,
    uint32_t* out, size_t out_stride, const uint64_t* r4, int num_threads) {
  size_t half = n / 2;
  uint64_t rm[4] = {to_mont(r4[0] % P), to_mont(r4[1] % P), to_mont(r4[2] % P),
                    to_mont(r4[3] % P)};
  uint64_t elevenR = to_mont(11);
#ifdef __AVX512F__
  ExtR er = ext_r_load(r4);
#endif
  run_parallel(half, num_threads, [&](size_t lo, size_t hi, int) {
    for (size_t g = 0; g < ngroups; ++g) {
      const uint32_t* s0 = in + (g * 4 + 0) * in_stride;
      const uint32_t* s1 = in + (g * 4 + 1) * in_stride;
      const uint32_t* s2 = in + (g * 4 + 2) * in_stride;
      const uint32_t* s3 = in + (g * 4 + 3) * in_stride;
      uint32_t* o0 = out + (g * 4 + 0) * out_stride;
      uint32_t* o1 = out + (g * 4 + 1) * out_stride;
      uint32_t* o2 = out + (g * 4 + 2) * out_stride;
      uint32_t* o3 = out + (g * 4 + 3) * out_stride;
      size_t i = lo;
#ifdef __AVX512F__
      for (; i + 8 <= hi; i += 8) {
        __m512i l0 = bb::mm_load_u32x8(s0 + i), h0 = bb::mm_load_u32x8(s0 + half + i);
        __m512i l1 = bb::mm_load_u32x8(s1 + i), h1 = bb::mm_load_u32x8(s1 + half + i);
        __m512i l2 = bb::mm_load_u32x8(s2 + i), h2 = bb::mm_load_u32x8(s2 + half + i);
        __m512i l3 = bb::mm_load_u32x8(s3 + i), h3 = bb::mm_load_u32x8(s3 + half + i);
        __m512i p0, p1, p2, p3;
        ext_mul_r(er, bb::mm_subm(h0, l0), bb::mm_subm(h1, l1),
                  bb::mm_subm(h2, l2), bb::mm_subm(h3, l3), &p0, &p1, &p2, &p3);
        bb::mm_store_u32x8(o0 + i, bb::mm_addm(l0, p0));
        bb::mm_store_u32x8(o1 + i, bb::mm_addm(l1, p1));
        bb::mm_store_u32x8(o2 + i, bb::mm_addm(l2, p2));
        bb::mm_store_u32x8(o3 + i, bb::mm_addm(l3, p3));
      }
#endif
      for (; i < hi; ++i) {
        uint32_t d0 = subm32(s0[half + i], s0[i]);
        uint32_t d1 = subm32(s1[half + i], s1[i]);
        uint32_t d2 = subm32(s2[half + i], s2[i]);
        uint32_t d3 = subm32(s3[half + i], s3[i]);
        uint32_t p0, p1, p2, p3;
        ext_mul_r_scalar(rm, elevenR, d0, d1, d2, d3, &p0, &p1, &p2, &p3);
        o0[i] = addm32(s0[i], p0);
        o1[i] = addm32(s1[i], p1);
        o2[i] = addm32(s2[i], p2);
        o3[i] = addm32(s3[i], p3);
      }
    }
  });
}
