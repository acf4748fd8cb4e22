// Threaded BabyBear^4 vector kernels (X^4 = 11), wired into core/ext4.py.
//
// The v2+ protocol draws every challenge from the degree-4 extension, so
// the prover's hot host loops (logUp advice construction, batch-eval
// combined-column builds, Ligero extension rows, zerocheck fallback) are
// elementwise Ext4 algebra.  numpy pays a u64 integer division per mod
// and 16 full-array temporaries per product; these kernels run the same
// canonical arithmetic chunk-resident across all cores with constexpr-
// modulus reduction (the compiler lowers % P to multiply-shift).
//
// Layout: an Ext4 array is (4, n) row-major uint64, coordinates first,
// all values canonical < p — exactly core/ext4.py's Ext4.c.  All outputs
// are canonical.  Functions are exact twins of the numpy expressions
// they replace (same mod-p residues), so proof bytes are unchanged.

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "bb_simd.h"

static constexpr uint64_t P = 2013265921ull;
static constexpr uint64_t W = 11ull;

static inline uint64_t addm(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  return s >= P ? s - P : s;
}
static inline uint64_t subm(uint64_t a, uint64_t b) {
  return a >= b ? a - b : a + P - b;
}
static inline uint64_t mulm(uint64_t a, uint64_t b) { return (a * b) % P; }

namespace {

void run_parallel(size_t n, int num_threads,
                  const std::function<void(size_t, size_t, int)>& fn) {
  size_t want = num_threads > 0 ? (size_t)num_threads : 1;
  constexpr size_t MIN_PER_THREAD = 4096;
  size_t nthreads = want;
  if (n < MIN_PER_THREAD * want) nthreads = n / MIN_PER_THREAD ? n / MIN_PER_THREAD : 1;
  if (nthreads <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> threads;
  size_t per = (n + nthreads - 1) / nthreads;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t lo = t * per;
    size_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi, (int)t);
  }
  for (auto& th : threads) th.join();
}

// out = x * y for one lane (schoolbook, partials reduced — matches
// core/ext4.py _ext_mul's residues).
inline void ext_mul_one(const uint64_t x[4], const uint64_t y[4],
                        uint64_t out[4]) {
  uint64_t t00 = mulm(x[0], y[0]), t01 = mulm(x[0], y[1]),
           t02 = mulm(x[0], y[2]), t03 = mulm(x[0], y[3]);
  uint64_t t10 = mulm(x[1], y[0]), t11 = mulm(x[1], y[1]),
           t12 = mulm(x[1], y[2]), t13 = mulm(x[1], y[3]);
  uint64_t t20 = mulm(x[2], y[0]), t21 = mulm(x[2], y[1]),
           t22 = mulm(x[2], y[2]), t23 = mulm(x[2], y[3]);
  uint64_t t30 = mulm(x[3], y[0]), t31 = mulm(x[3], y[1]),
           t32 = mulm(x[3], y[2]), t33 = mulm(x[3], y[3]);
  out[0] = addm(t00, mulm(W, addm(addm(t13, t22), t31)));
  out[1] = addm(addm(t01, t10), mulm(W, addm(t23, t32)));
  out[2] = addm(addm(t02, t11), addm(t20, mulm(W, t33)));
  out[3] = addm(addm(t03, t12), addm(t21, t30));
}

}  // namespace

#ifdef __AVX512F__
// Vectorized schoolbook ext4 product over 8 lanes: xm (Montgomery form)
// times y (canonical) -> canonical coordinates, partials reduced exactly
// like core/ext4.py _ext_mul.
static inline void ext_mul8(const __m512i xm[4], const __m512i y[4],
                            __m512i o[4], __m512i elevenR) {
  using bb::mm_addm;
  using bb::mm_mont_mul;
  __m512i t00 = mm_mont_mul(xm[0], y[0]), t01 = mm_mont_mul(xm[0], y[1]),
          t02 = mm_mont_mul(xm[0], y[2]), t03 = mm_mont_mul(xm[0], y[3]);
  __m512i t10 = mm_mont_mul(xm[1], y[0]), t11 = mm_mont_mul(xm[1], y[1]),
          t12 = mm_mont_mul(xm[1], y[2]), t13 = mm_mont_mul(xm[1], y[3]);
  __m512i t20 = mm_mont_mul(xm[2], y[0]), t21 = mm_mont_mul(xm[2], y[1]),
          t22 = mm_mont_mul(xm[2], y[2]), t23 = mm_mont_mul(xm[2], y[3]);
  __m512i t30 = mm_mont_mul(xm[3], y[0]), t31 = mm_mont_mul(xm[3], y[1]),
          t32 = mm_mont_mul(xm[3], y[2]), t33 = mm_mont_mul(xm[3], y[3]);
  o[0] = mm_addm(t00, mm_mont_mul(elevenR,
                                  mm_addm(mm_addm(t13, t22), t31)));
  o[1] = mm_addm(mm_addm(t01, t10), mm_mont_mul(elevenR, mm_addm(t23, t32)));
  o[2] = mm_addm(mm_addm(t02, t11), mm_addm(t20, mm_mont_mul(elevenR, t33)));
  o[3] = mm_addm(mm_addm(t03, t12), mm_addm(t21, t30));
}
#endif

// out = a * b elementwise; a is (4, n); b is (4, n) when b_scalar == 0,
// else a single (4,) element broadcast over n.
extern "C" void zigz_ext4_mul(const uint64_t* a, const uint64_t* b,
                              int b_scalar, uint64_t* out, size_t n,
                              int num_threads) {
  uint64_t ym[4];
  if (b_scalar)
    for (int e = 0; e < 4; ++e) ym[e] = bb::to_mont(b[e] % P);
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    size_t i = lo;
#ifdef __AVX512F__
    const __m512i elevenR = _mm512_set1_epi64((long long)bb::to_mont(11));
    const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
    __m512i yv[4];
    if (b_scalar)
      for (int e = 0; e < 4; ++e) yv[e] = _mm512_set1_epi64((long long)ym[e]);
    for (; i + 8 <= hi; i += 8) {
      __m512i xv[4], o[4];
      for (int e = 0; e < 4; ++e)
        xv[e] = _mm512_loadu_si512((const void*)(a + (size_t)e * n + i));
      if (b_scalar) {
        // y fixed in Montgomery form: mont_mul(y~, x) = x*y canonical.
        ext_mul8(yv, xv, o, elevenR);
      } else {
        __m512i xm[4];
        for (int e = 0; e < 4; ++e) xm[e] = bb::mm_mont_mul(xv[e], r2);
        __m512i bv[4];
        for (int e = 0; e < 4; ++e)
          bv[e] = _mm512_loadu_si512((const void*)(b + (size_t)e * n + i));
        ext_mul8(xm, bv, o, elevenR);
      }
      for (int e = 0; e < 4; ++e)
        _mm512_storeu_si512((void*)(out + (size_t)e * n + i), o[e]);
    }
#endif
    uint64_t x[4], y[4], o[4];
    if (b_scalar) {
      y[0] = b[0]; y[1] = b[1]; y[2] = b[2]; y[3] = b[3];
    }
    for (; i < hi; ++i) {
      x[0] = a[i]; x[1] = a[n + i]; x[2] = a[2 * n + i]; x[3] = a[3 * n + i];
      if (!b_scalar) {
        y[0] = b[i]; y[1] = b[n + i]; y[2] = b[2 * n + i]; y[3] = b[3 * n + i];
      }
      ext_mul_one(x, y, o);
      out[i] = o[0]; out[n + i] = o[1]; out[2 * n + i] = o[2];
      out[3 * n + i] = o[3];
    }
  });
}

// out = coeff (4,) * col (n,) — the ext-scalar x base-vector product; when
// accumulate != 0, out += coeff * col instead.  col values must be < 2^32
// (canonical callers always satisfy this); results are canonical mod P via
// the fixed-operand Montgomery trick (bb_simd.h), identical residues to
// the previous (c * (col % P)) % P expressions.
extern "C" void zigz_ext4_scale_base(const uint64_t* coeff, const uint64_t* col,
                                     uint64_t* out, size_t n, int accumulate,
                                     int num_threads) {
  uint64_t cm[4] = {bb::to_mont(coeff[0] % P), bb::to_mont(coeff[1] % P),
                    bb::to_mont(coeff[2] % P), bb::to_mont(coeff[3] % P)};
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    size_t i = lo;
#ifdef __AVX512F__
    const __m512i c0 = _mm512_set1_epi64((long long)cm[0]);
    const __m512i c1 = _mm512_set1_epi64((long long)cm[1]);
    const __m512i c2 = _mm512_set1_epi64((long long)cm[2]);
    const __m512i c3 = _mm512_set1_epi64((long long)cm[3]);
    for (; i + 8 <= hi; i += 8) {
      __m512i v = _mm512_loadu_si512((const void*)(col + i));
      __m512i p0 = bb::mm_mont_mul(c0, v), p1 = bb::mm_mont_mul(c1, v);
      __m512i p2 = bb::mm_mont_mul(c2, v), p3 = bb::mm_mont_mul(c3, v);
      if (accumulate) {
        p0 = bb::mm_addm(_mm512_loadu_si512((const void*)(out + i)), p0);
        p1 = bb::mm_addm(_mm512_loadu_si512((const void*)(out + n + i)), p1);
        p2 = bb::mm_addm(_mm512_loadu_si512((const void*)(out + 2 * n + i)), p2);
        p3 = bb::mm_addm(_mm512_loadu_si512((const void*)(out + 3 * n + i)), p3);
      }
      _mm512_storeu_si512((void*)(out + i), p0);
      _mm512_storeu_si512((void*)(out + n + i), p1);
      _mm512_storeu_si512((void*)(out + 2 * n + i), p2);
      _mm512_storeu_si512((void*)(out + 3 * n + i), p3);
    }
#endif
    for (; i < hi; ++i) {
      uint64_t v = col[i];
      uint64_t p0 = bb::mont_mul(cm[0], v), p1 = bb::mont_mul(cm[1], v),
               p2 = bb::mont_mul(cm[2], v), p3 = bb::mont_mul(cm[3], v);
      if (accumulate) {
        out[i] = addm(out[i], p0);
        out[n + i] = addm(out[n + i], p1);
        out[2 * n + i] = addm(out[2 * n + i], p2);
        out[3 * n + i] = addm(out[3 * n + i], p3);
      } else {
        out[i] = p0; out[n + i] = p1; out[2 * n + i] = p2; out[3 * n + i] = p3;
      }
    }
  });
}

// Fused multi-column variant: out (4, n) = sum_k coeffs[k] * cols[k] with
// one pass over ``out`` — the batch-evaluation group combiner
// (proofs/batch_eval.py builds F_g = sum_i delta^i f_i from hundreds of
// committed base columns; per-claim scale_base calls paid out-traffic and
// thread spawns per column).  cols is an array of k row pointers, each n
// long with values < 2^32.
extern "C" void zigz_ext4_scale_base_multi(const uint64_t* coeffs,
                                           const uint64_t* const* cols,
                                           size_t k, uint64_t* out, size_t n,
                                           int accumulate, int num_threads) {
  std::vector<uint64_t> cm(4 * k);
  for (size_t j = 0; j < k; ++j)
    for (int e = 0; e < 4; ++e)
      cm[4 * j + e] = bb::to_mont(coeffs[4 * j + e] % P);
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    constexpr size_t TILE = 2048;
    std::vector<uint64_t> acc(4 * TILE);
    for (size_t s = lo; s < hi; s += TILE) {
      size_t len = (s + TILE < hi) ? TILE : hi - s;
      if (accumulate) {
        for (int e = 0; e < 4; ++e)
          std::memcpy(acc.data() + e * TILE, out + e * n + s,
                      len * sizeof(uint64_t));
      } else {
        std::memset(acc.data(), 0, 4 * TILE * sizeof(uint64_t));
      }
      for (size_t j = 0; j < k; ++j) {
        const uint64_t* col = cols[j] + s;
        const uint64_t* c = cm.data() + 4 * j;
        size_t i = 0;
#ifdef __AVX512F__
        const __m512i c0 = _mm512_set1_epi64((long long)c[0]);
        const __m512i c1 = _mm512_set1_epi64((long long)c[1]);
        const __m512i c2 = _mm512_set1_epi64((long long)c[2]);
        const __m512i c3 = _mm512_set1_epi64((long long)c[3]);
        for (; i + 8 <= len; i += 8) {
          __m512i v = _mm512_loadu_si512((const void*)(col + i));
          uint64_t* a0 = acc.data() + i;
          _mm512_storeu_si512(
              (void*)a0, bb::mm_addm(_mm512_loadu_si512((const void*)a0),
                                     bb::mm_mont_mul(c0, v)));
          uint64_t* a1 = acc.data() + TILE + i;
          _mm512_storeu_si512(
              (void*)a1, bb::mm_addm(_mm512_loadu_si512((const void*)a1),
                                     bb::mm_mont_mul(c1, v)));
          uint64_t* a2 = acc.data() + 2 * TILE + i;
          _mm512_storeu_si512(
              (void*)a2, bb::mm_addm(_mm512_loadu_si512((const void*)a2),
                                     bb::mm_mont_mul(c2, v)));
          uint64_t* a3 = acc.data() + 3 * TILE + i;
          _mm512_storeu_si512(
              (void*)a3, bb::mm_addm(_mm512_loadu_si512((const void*)a3),
                                     bb::mm_mont_mul(c3, v)));
        }
#endif
        for (; i < len; ++i) {
          uint64_t v = col[i];
          for (int e = 0; e < 4; ++e) {
            uint64_t* a = acc.data() + (size_t)e * TILE + i;
            *a = addm(*a, bb::mont_mul(c[e], v));
          }
        }
      }
      for (int e = 0; e < 4; ++e)
        std::memcpy(out + e * n + s, acc.data() + (size_t)e * TILE,
                    len * sizeof(uint64_t));
    }
  });
}

// Fused multi-column dot: out[j] (4,) = sum_i eq[., i] * cols[j][i] for k
// base columns sharing one extension weight table (the batch-eval terminal
// column evaluations: hundreds of columns of the same width evaluated at
// one eq table).  Column values < 2^32.
extern "C" void zigz_ext4_dot_base_multi(const uint64_t* eq,
                                         const uint64_t* const* cols, size_t k,
                                         uint64_t* out, size_t n,
                                         int num_threads) {
  int nt = num_threads > 0 ? num_threads : 1;
  std::vector<std::vector<uint64_t>> accs((size_t)nt,
                                          std::vector<uint64_t>(4 * k, 0));
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int tid) {
    constexpr size_t TILE = 2048;
    std::vector<uint64_t> eqm(4 * TILE);
    uint64_t* acc = accs[(size_t)tid].data();
    for (size_t s = lo; s < hi; s += TILE) {
      size_t len = (s + TILE < hi) ? TILE : hi - s;
      // Montgomery-form eq tile (shared by every column).
      for (int e = 0; e < 4; ++e) {
        const uint64_t* src = eq + (size_t)e * n + s;
        uint64_t* dst = eqm.data() + (size_t)e * TILE;
        size_t i = 0;
#ifdef __AVX512F__
        const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
        for (; i + 8 <= len; i += 8)
          _mm512_storeu_si512(
              (void*)(dst + i),
              bb::mm_mont_mul(_mm512_loadu_si512((const void*)(src + i)), r2));
#endif
        for (; i < len; ++i) dst[i] = bb::to_mont(src[i] % P);
      }
      for (size_t j = 0; j < k; ++j) {
        const uint64_t* col = cols[j] + s;
        uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
        size_t i = 0;
#ifdef __AVX512F__
        __m512i v0 = _mm512_setzero_si512(), v1 = _mm512_setzero_si512();
        __m512i v2 = _mm512_setzero_si512(), v3 = _mm512_setzero_si512();
        for (; i + 8 <= len; i += 8) {
          __m512i v = _mm512_loadu_si512((const void*)(col + i));
          v0 = _mm512_add_epi64(v0, bb::mm_mont_mul(
              _mm512_loadu_si512((const void*)(eqm.data() + i)), v));
          v1 = _mm512_add_epi64(v1, bb::mm_mont_mul(
              _mm512_loadu_si512((const void*)(eqm.data() + TILE + i)), v));
          v2 = _mm512_add_epi64(v2, bb::mm_mont_mul(
              _mm512_loadu_si512((const void*)(eqm.data() + 2 * TILE + i)), v));
          v3 = _mm512_add_epi64(v3, bb::mm_mont_mul(
              _mm512_loadu_si512((const void*)(eqm.data() + 3 * TILE + i)), v));
        }
        s0 = _mm512_reduce_add_epi64(v0) % P;
        s1 = _mm512_reduce_add_epi64(v1) % P;
        s2 = _mm512_reduce_add_epi64(v2) % P;
        s3 = _mm512_reduce_add_epi64(v3) % P;
#endif
        for (; i < len; ++i) {
          uint64_t v = col[i];
          s0 = addm(s0, bb::mont_mul(eqm[i], v));
          s1 = addm(s1, bb::mont_mul(eqm[TILE + i], v));
          s2 = addm(s2, bb::mont_mul(eqm[2 * TILE + i], v));
          s3 = addm(s3, bb::mont_mul(eqm[3 * TILE + i], v));
        }
        uint64_t* a = acc + 4 * j;
        a[0] = addm(a[0], s0 % P); a[1] = addm(a[1], s1 % P);
        a[2] = addm(a[2], s2 % P); a[3] = addm(a[3], s3 % P);
      }
    }
  });
  for (size_t j = 0; j < 4 * k; ++j) {
    uint64_t total = 0;
    for (auto& a : accs) total = addm(total, a[j]);
    out[j] = total;
  }
}

// out (4,) = sum_i a[., i] * col[i] — ext-vector x base-vector dot.
extern "C" void zigz_ext4_dot_base(const uint64_t* a, const uint64_t* col,
                                   uint64_t* out, size_t n, int num_threads) {
  int nt = num_threads > 0 ? num_threads : 1;
  std::vector<std::vector<uint64_t>> accs((size_t)nt,
                                          std::vector<uint64_t>(4, 0));
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int tid) {
    uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    for (size_t i = lo; i < hi; ++i) {
      uint64_t v = col[i] % P;
      s0 = addm(s0, mulm(a[i] % P, v));
      s1 = addm(s1, mulm(a[n + i] % P, v));
      s2 = addm(s2, mulm(a[2 * n + i] % P, v));
      s3 = addm(s3, mulm(a[3 * n + i] % P, v));
    }
    auto& acc = accs[(size_t)tid];
    acc[0] = s0; acc[1] = s1; acc[2] = s2; acc[3] = s3;
  });
  for (int e = 0; e < 4; ++e) {
    uint64_t total = 0;
    for (auto& a2 : accs) total = addm(total, a2[(size_t)e]);
    out[e] = total;
  }
}

// Batched inversion via Frobenius/norm (core/ext4.py Ext4.inv):
// b = phi(a) phi^2(a) phi^3(a) with phi scaling coordinate i by sigma^i;
// N(a) = (a b)_0; a^-1 = b / N(a).  Base norms invert with the Montgomery
// batch trick (one Fermat pow per call).  Zero maps to zero.
extern "C" void zigz_ext4_inv(const uint64_t* a, uint64_t* out, size_t n,
                              uint64_t sigma, int num_threads) {
  // sigma powers for phi^k: coordinate i of phi^k(a) = a_i * sigma^(k*i).
  uint64_t s1[4], s2[4], s3[4];
  for (int i = 0; i < 4; ++i) {
    s1[i] = 1; s2[i] = 1; s3[i] = 1;
    for (int k = 0; k < i; ++k) s1[i] = mulm(s1[i], sigma);
    s2[i] = mulm(s1[i], s1[i]);
    s3[i] = mulm(s2[i], s1[i]);
  }
  std::vector<uint64_t> b(4 * n);
  std::vector<uint64_t> norm(n);
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    size_t i = lo;
#ifdef __AVX512F__
    {
      const __m512i elevenR = _mm512_set1_epi64((long long)bb::to_mont(11));
      const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
      __m512i s1m[4], s2m[4], s3m[4];
      for (int e = 0; e < 4; ++e) {
        s1m[e] = _mm512_set1_epi64((long long)bb::to_mont(s1[e]));
        s2m[e] = _mm512_set1_epi64((long long)bb::to_mont(s2[e]));
        s3m[e] = _mm512_set1_epi64((long long)bb::to_mont(s3[e]));
      }
      for (; i + 8 <= hi; i += 8) {
        __m512i x[4], f1[4], f2m[4], f3[4], t[4], tm[4], bbv[4], xm[4];
        for (int e = 0; e < 4; ++e) {
          x[e] = _mm512_loadu_si512((const void*)(a + (size_t)e * n + i));
          f1[e] = bb::mm_mont_mul(s1m[e], x[e]);      // canonical x*s1
          __m512i f2 = bb::mm_mont_mul(s2m[e], x[e]);
          f2m[e] = bb::mm_mont_mul(f2, r2);           // Montgomery form
          f3[e] = bb::mm_mont_mul(s3m[e], x[e]);
          xm[e] = bb::mm_mont_mul(x[e], r2);
        }
        ext_mul8(f2m, f1, t, elevenR);                // t = f1*f2 canonical
        for (int e = 0; e < 4; ++e) tm[e] = bb::mm_mont_mul(t[e], r2);
        ext_mul8(tm, f3, bbv, elevenR);               // bb = t*f3 canonical
        __m512i prod[4];
        ext_mul8(xm, bbv, prod, elevenR);             // prod = x*bb
        _mm512_storeu_si512((void*)(norm.data() + i), prod[0]);
        for (int e = 0; e < 4; ++e)
          _mm512_storeu_si512((void*)(b.data() + (size_t)e * n + i), bbv[e]);
      }
    }
#endif
    uint64_t x[4], f1[4], f2[4], f3[4], t[4], bbv[4], prod[4];
    for (; i < hi; ++i) {
      x[0] = a[i] % P; x[1] = a[n + i] % P; x[2] = a[2 * n + i] % P;
      x[3] = a[3 * n + i] % P;
      for (int e = 0; e < 4; ++e) {
        f1[e] = mulm(x[e], s1[e]);
        f2[e] = mulm(x[e], s2[e]);
        f3[e] = mulm(x[e], s3[e]);
      }
      ext_mul_one(f1, f2, t);
      ext_mul_one(t, f3, bbv);
      ext_mul_one(x, bbv, prod);
      norm[i] = prod[0];
      b[i] = bbv[0]; b[n + i] = bbv[1]; b[2 * n + i] = bbv[2];
      b[3 * n + i] = bbv[3];
    }
  });
  // Montgomery batch inversion of the norms (serial prefix; zeros skipped
  // by substituting 1 and zeroing afterwards).
  std::vector<uint64_t> prefix(n);
  uint64_t run = 1;
  for (size_t i = 0; i < n; ++i) {
    prefix[i] = run;
    uint64_t v = norm[i] ? norm[i] : 1;
    run = mulm(run, v);
  }
  // run^(P-2) by square-and-multiply.
  uint64_t inv_run = 1, base = run, e = P - 2;
  while (e) {
    if (e & 1) inv_run = mulm(inv_run, base);
    base = mulm(base, base);
    e >>= 1;
  }
  std::vector<uint64_t> ninv(n);
  for (size_t i = n; i-- > 0;) {
    uint64_t v = norm[i] ? norm[i] : 1;
    ninv[i] = mulm(inv_run, prefix[i]);
    inv_run = mulm(inv_run, v);
    if (!norm[i]) ninv[i] = 0;
  }
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    size_t i = lo;
#ifdef __AVX512F__
    const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
    for (; i + 8 <= hi; i += 8) {
      __m512i nm = bb::mm_mont_mul(
          _mm512_loadu_si512((const void*)(ninv.data() + i)), r2);
      for (int e = 0; e < 4; ++e)
        _mm512_storeu_si512(
            (void*)(out + (size_t)e * n + i),
            bb::mm_mont_mul(nm, _mm512_loadu_si512(
                                    (const void*)(b.data() + (size_t)e * n + i))));
    }
#endif
    for (; i < hi; ++i) {
      uint64_t ni = ninv[i];
      out[i] = mulm(b[i], ni);
      out[n + i] = mulm(b[n + i], ni);
      out[2 * n + i] = mulm(b[2 * n + i], ni);
      out[3 * n + i] = mulm(b[3 * n + i], ni);
    }
  });
}

// u (4, n) = rowvec a (4, rows) x base matrix M (rows, n) — the Ligero
// extension query/proximity row product.  Row-major matrix traversal with
// the coefficient quad fixed per row (Montgomery fixed-operand products),
// j-tiled so the (4, TILE) accumulator stays cache-resident; threads
// split the column axis.  Skips all-zero coefficient quads (the mixed
// claims' row weights are zero outside each column's block).
extern "C" void zigz_ext4_vecmat(const uint64_t* a, const uint64_t* mat,
                                 uint64_t* out, size_t rows, size_t n,
                                 int num_threads) {
  std::vector<uint64_t> am(4 * rows);
  for (size_t r = 0; r < rows; ++r)
    for (int e = 0; e < 4; ++e)
      am[4 * r + e] = bb::to_mont(a[(size_t)e * rows + r] % P);
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    constexpr size_t TILE = 4096;
    std::vector<uint64_t> acc(4 * TILE);
    for (size_t s = lo; s < hi; s += TILE) {
      size_t len = (s + TILE < hi) ? TILE : hi - s;
      std::memset(acc.data(), 0, 4 * TILE * sizeof(uint64_t));
      for (size_t r = 0; r < rows; ++r) {
        const uint64_t* c = am.data() + 4 * r;
        if ((c[0] | c[1] | c[2] | c[3]) == 0) continue;
        const uint64_t* row = mat + r * n + s;
        size_t j = 0;
#ifdef __AVX512F__
        const __m512i c0 = _mm512_set1_epi64((long long)c[0]);
        const __m512i c1 = _mm512_set1_epi64((long long)c[1]);
        const __m512i c2 = _mm512_set1_epi64((long long)c[2]);
        const __m512i c3 = _mm512_set1_epi64((long long)c[3]);
        for (; j + 8 <= len; j += 8) {
          __m512i v = _mm512_loadu_si512((const void*)(row + j));
          uint64_t* a0 = acc.data() + j;
          _mm512_storeu_si512((void*)a0,
                              bb::mm_addm(_mm512_loadu_si512((const void*)a0),
                                          bb::mm_mont_mul(c0, v)));
          uint64_t* a1 = acc.data() + TILE + j;
          _mm512_storeu_si512((void*)a1,
                              bb::mm_addm(_mm512_loadu_si512((const void*)a1),
                                          bb::mm_mont_mul(c1, v)));
          uint64_t* a2 = acc.data() + 2 * TILE + j;
          _mm512_storeu_si512((void*)a2,
                              bb::mm_addm(_mm512_loadu_si512((const void*)a2),
                                          bb::mm_mont_mul(c2, v)));
          uint64_t* a3 = acc.data() + 3 * TILE + j;
          _mm512_storeu_si512((void*)a3,
                              bb::mm_addm(_mm512_loadu_si512((const void*)a3),
                                          bb::mm_mont_mul(c3, v)));
        }
#endif
        for (; j < len; ++j) {
          uint64_t v = row[j];
          acc[j] = addm(acc[j], bb::mont_mul(c[0], v));
          acc[TILE + j] = addm(acc[TILE + j], bb::mont_mul(c[1], v));
          acc[2 * TILE + j] = addm(acc[2 * TILE + j], bb::mont_mul(c[2], v));
          acc[3 * TILE + j] = addm(acc[3 * TILE + j], bb::mont_mul(c[3], v));
        }
      }
      for (int e = 0; e < 4; ++e)
        std::memcpy(out + (size_t)e * n + s, acc.data() + (size_t)e * TILE,
                    len * sizeof(uint64_t));
    }
  });
}

// out = a (4, n) * col (n,) elementwise — ext-array x base-vector.
extern "C" void zigz_ext4_mul_base(const uint64_t* a, const uint64_t* col,
                                   uint64_t* out, size_t n, int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    size_t i = lo;
#ifdef __AVX512F__
    const __m512i r2 = _mm512_set1_epi64((long long)bb::R2);
    for (; i + 8 <= hi; i += 8) {
      // One to-Montgomery on the shared base value, four exact products.
      __m512i vm = bb::mm_mont_mul(
          _mm512_loadu_si512((const void*)(col + i)), r2);
      for (int e = 0; e < 4; ++e)
        _mm512_storeu_si512(
            (void*)(out + (size_t)e * n + i),
            bb::mm_mont_mul(
                vm, _mm512_loadu_si512((const void*)(a + (size_t)e * n + i))));
    }
#endif
    for (; i < hi; ++i) {
      uint64_t v = col[i] % P;
      out[i] = mulm(a[i] % P, v);
      out[n + i] = mulm(a[n + i] % P, v);
      out[2 * n + i] = mulm(a[2 * n + i] % P, v);
      out[3 * n + i] = mulm(a[3 * n + i] % P, v);
    }
  });
}

// out = a +/- b elementwise; a (4, n); b (4, n) or scalar (4,) broadcast.
extern "C" void zigz_ext4_addsub(const uint64_t* a, const uint64_t* b,
                                 int b_scalar, int is_sub, uint64_t* out,
                                 size_t n, int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi, int) {
    for (int e = 0; e < 4; ++e) {
      const uint64_t* ae = a + (size_t)e * n;
      const uint64_t* be = b_scalar ? b + e : b + (size_t)e * n;
      uint64_t* oe = out + (size_t)e * n;
      if (is_sub == 2) {  // reversed: out = b - a (b scalar, a array)
        uint64_t bv = be[0] % P;
        for (size_t i = lo; i < hi; ++i) oe[i] = subm(bv, ae[i] % P);
      } else if (is_sub) {
        if (b_scalar) {
          uint64_t bv = be[0] % P;
          for (size_t i = lo; i < hi; ++i) oe[i] = subm(ae[i] % P, bv);
        } else {
          for (size_t i = lo; i < hi; ++i) oe[i] = subm(ae[i] % P, be[i] % P);
        }
      } else {
        if (b_scalar) {
          uint64_t bv = be[0] % P;
          for (size_t i = lo; i < hi; ++i) oe[i] = addm(ae[i] % P, bv);
        } else {
          for (size_t i = lo; i < hi; ++i) oe[i] = addm(ae[i] % P, be[i] % P);
        }
      }
    }
  });
}
