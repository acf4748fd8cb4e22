// Shared BabyBear SIMD helpers for the native runtime kernels.
//
// Scalar Montgomery (R = 2^32) plus AVX-512 8-lane variants.  Two usage
// patterns, both producing CANONICAL results so callers' byte-exactness
// is untouched:
//
//   1. Fixed-operand exact product: for a constant c, precompute
//      c_m = c * R mod P once; then mont_mul(c_m, x) = c * x mod P for
//      canonical x.  (One operand in Montgomery form cancels the R^-1.)
//      Used by folds (challenge r fixed per call), scale-by-coefficient,
//      and the R2 constant itself (mont_mul(R2, x) = x * R = to-Montgomery).
//
//   2. Montgomery-domain pipelines: convert inputs via mont_mul(R2, x),
//      compute with mont_mul (closed over the domain), convert sums back
//      with mont_mul(acc, 1).  Used by the DAG evaluator where both MUL
//      operands vary.
//
// All helpers assume inputs < 2^32 and P = 2013265921 (BabyBear).

#pragma once

#include <cstdint>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace bb {

static constexpr uint64_t P = 2013265921ull;
static constexpr uint64_t PINV_NEG = 0x77ffffffull;  // -P^{-1} mod 2^32
static constexpr uint64_t R2 = 1172168163ull;        // (2^32)^2 mod P
static constexpr uint64_t R1 = 268435454ull;         // 2^32 mod P

// REDC(a * b): for a, b < 2^32 with a*b < 2^62 returns a*b*R^{-1} mod P,
// canonical.  (a*b < 2^62 always holds when either operand < 2^30 or both
// are < 2^31; all call sites keep operands < P or < 2^32 with the other
// < P, giving t < 2^63 which is still exact: t + m*P < 2^63 + 2^63.)
static inline uint64_t mont_mul(uint64_t a, uint64_t b) {
  uint64_t t = a * b;
  uint64_t m = ((t & 0xffffffffull) * PINV_NEG) & 0xffffffffull;
  uint64_t r = (t + m * P) >> 32;
  return r >= P ? r - P : r;
}

// to-Montgomery: x * R mod P.
static inline uint64_t to_mont(uint64_t x) { return mont_mul(x, R2); }
// from-Montgomery: x * R^{-1} mod P.
static inline uint64_t from_mont(uint64_t x) { return mont_mul(x, 1); }

static inline uint32_t addm32(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= (uint32_t)P ? s - (uint32_t)P : s;
}
static inline uint32_t subm32(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (uint32_t)P - b;
}

#ifdef __AVX512F__

// 8 u64 lanes; operands < 2^32 held in the low halves of each lane.
static inline __m512i mm_mont_mul(__m512i a, __m512i b) {
  const __m512i Pv = _mm512_set1_epi64((long long)P);
  const __m512i PINVv = _mm512_set1_epi64((long long)PINV_NEG);
  const __m512i lo32 = _mm512_set1_epi64(0xffffffffll);
  __m512i t = _mm512_mul_epu32(a, b);
  __m512i m = _mm512_and_epi64(_mm512_mul_epu32(t, PINVv), lo32);
  __m512i r = _mm512_srli_epi64(_mm512_add_epi64(t, _mm512_mul_epu32(m, Pv)), 32);
  return _mm512_min_epu64(r, _mm512_sub_epi64(r, Pv));
}

// canonical add/sub on 8 u64 lanes (values < P).
static inline __m512i mm_addm(__m512i a, __m512i b) {
  const __m512i Pv = _mm512_set1_epi64((long long)P);
  __m512i s = _mm512_add_epi64(a, b);
  return _mm512_min_epu64(s, _mm512_sub_epi64(s, Pv));
}
static inline __m512i mm_subm(__m512i a, __m512i b) {
  const __m512i Pv = _mm512_set1_epi64((long long)P);
  __m512i d = _mm512_sub_epi64(_mm512_add_epi64(a, Pv), b);
  return _mm512_min_epu64(d, _mm512_sub_epi64(d, Pv));
}

// Load 8 u32 -> 8 u64 lanes; store 8 u64 lanes -> 8 u32.
static inline __m512i mm_load_u32x8(const uint32_t* p) {
  return _mm512_cvtepu32_epi64(_mm256_loadu_si256((const __m256i*)p));
}
static inline void mm_store_u32x8(uint32_t* p, __m512i v) {
  _mm256_storeu_si256((__m256i*)p, _mm512_cvtepi64_epi32(v));
}

#endif  // __AVX512F__

}  // namespace bb
