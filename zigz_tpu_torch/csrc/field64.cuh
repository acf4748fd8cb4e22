// Arithmetic mod the two 64-bit primes of the port, Goldilocks
// (p = 2^64 - 2^32 + 1) and Mersenne61 (p = 2^61 - 1), on canonical u64
// values, shared by kernel E1 (field64_kernels.cu) and by the host entries
// at the end of this file, which the CPU tests build with g++.  ZIGZ_HD
// makes every function host and device under nvcc and a plain inline
// function under a host compiler, as in babybear.cuh.
//
// A field is a type with kP and reduce(lo, hi), the canonical value of the
// 128-bit hi * 2^64 + lo; code is instantiated per field, so no run-time
// branch picks the field per element.  The 64 x 64 -> 128-bit product is
// a * b and __umul64hi(a, b) on the device, unsigned __int128 on the host.
//
// The JAX package has no such kernel: zigz_tpu evaluates a field of 2^31
// and above with object-dtype Python integers on the host
// (zigz_tpu/poly/multilinear.py:45,53).
#pragma once

#include <cstdint>

#ifndef ZIGZ_HD
#ifdef __CUDACC__
#define ZIGZ_HD __host__ __device__ __forceinline__
#else
#define ZIGZ_HD inline
#endif
#endif

namespace zigz64 {

// hi * 2^64 + lo = a * b.
ZIGZ_HD void mul_wide(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  const unsigned __int128 t = static_cast<unsigned __int128>(a) * b;
  lo = static_cast<uint64_t>(t);
  hi = static_cast<uint64_t>(t >> 64);
#endif
}

struct Goldilocks {
  static constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
  static constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p = 2^32 - 1

  // hi * 2^64 + lo mod p for any 128-bit value.  With hi = hh * 2^32 + hl:
  // 2^64 = 2^32 - 1 and 2^96 = -1 mod p, so the value is lo - hh + hl * kEps.
  static ZIGZ_HD uint64_t reduce(uint64_t lo, uint64_t hi) {
    const uint64_t hh = hi >> 32;
    const uint64_t hl = hi & kEps;
    uint64_t t0 = lo - hh;
    // A borrow wrapped in 2^64 = kEps mod p too many; t0 >= 2^64 - 2^32 then,
    // so taking kEps off cannot wrap again.
    if (lo < hh) t0 -= kEps;
    const uint64_t t1 = hl * kEps;  // < 2^64
    uint64_t t2 = t0 + t1;
    // A carry dropped 2^64 = kEps mod p; t2 < t1 < 2^64 - 2^32 then, so
    // adding kEps back cannot carry again.
    if (t2 < t1) t2 += kEps;
    return t2 >= kP ? t2 - kP : t2;
  }

  // Any u64 mod p: v < 2^64 < 2p, so one conditional subtract.
  static ZIGZ_HD uint64_t from_u64(uint64_t v) { return v >= kP ? v - kP : v; }

  static ZIGZ_HD uint64_t add(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    // a + b < 2p: past 2^64 the true sum less p is s + kEps (< p).
    if (s < a) return s + kEps;
    return s >= kP ? s - kP : s;
  }

  static ZIGZ_HD uint64_t sub(uint64_t a, uint64_t b) {
    // a - b + p = (a - b + 2^64) - kEps when a < b.
    return a >= b ? a - b : a - b - kEps;
  }
};

struct Mersenne61 {
  static constexpr uint64_t kP = 0x1FFFFFFFFFFFFFFFull;  // 2^61 - 1

  // hi * 2^64 + lo mod p for a value below 2^122 (a product of two values
  // below p): 2^61 = 1 mod p, so x = (x mod 2^61) + (x >> 61), twice.
  static ZIGZ_HD uint64_t reduce(uint64_t lo, uint64_t hi) {
    uint64_t s = (lo & kP) + ((lo >> 61) | (hi << 3));  // < 2^62
    s = (s & kP) + (s >> 61);                           // <= p (s >> 61 is 1 only when s & kP < p)
    return s >= kP ? s - kP : s;
  }

  // Any u64 mod p: (v mod 2^61) + (v >> 61) < 2^61 + 8, then one
  // conditional subtract.
  static ZIGZ_HD uint64_t from_u64(uint64_t v) {
    const uint64_t s = (v & kP) + (v >> 61);
    return s >= kP ? s - kP : s;
  }

  static ZIGZ_HD uint64_t add(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;  // < 2^62
    return s >= kP ? s - kP : s;
  }

  static ZIGZ_HD uint64_t sub(uint64_t a, uint64_t b) {
    return a >= b ? a - b : a + kP - b;
  }
};

template <class F>
ZIGZ_HD uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  return F::reduce(lo, hi);
}

// One output of the LSB fold: e0 + r (e1 - e0), which is (1 - r) e0 + r e1
// with one product instead of two; every value canonical.
template <class F>
ZIGZ_HD uint64_t fold_value(uint64_t e0, uint64_t e1, uint64_t r) {
  return F::add(e0, mul<F>(r, F::sub(e1, e0)));
}

}  // namespace zigz64

#ifndef __CUDACC__

// The CPU tests' entry: E1 over every output in order, `in` (rows,
// 2 n_out), `out` (rows, n_out), `r` one challenge a row.  Returns 0, or 1
// for a modulus that is neither field's.  Defined here, not inline, so that
// the one host unit that includes the header (the tests' build) exports it.
extern "C" {

int zigz_mle_fold_u64_host(const uint64_t* in, const uint64_t* r, uint64_t* out, int64_t rows, int64_t n_out,
                           uint64_t p) {
  if (p != zigz64::Goldilocks::kP && p != zigz64::Mersenne61::kP) return 1;
  for (int64_t i = 0; i < rows * n_out; ++i) {
    const uint64_t e0 = in[2 * i], e1 = in[2 * i + 1], ri = r[i / n_out];
    out[i] = p == zigz64::Goldilocks::kP ? zigz64::fold_value<zigz64::Goldilocks>(e0, e1, ri)
                                         : zigz64::fold_value<zigz64::Mersenne61>(e0, e1, ri);
  }
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
