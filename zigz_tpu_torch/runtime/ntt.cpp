// Threaded iterative DIT NTT over BabyBear coefficient rows.
//
// Replaces the numpy hot loop in commitments/ligero.py:ntt_pow2 (the
// Reed-Solomon row encoding behind every Ligero commitment).  The Python
// side passes the cached bit-reversal permutation and per-stage twiddle
// tables so both backends share one source of truth; results are
// byte-identical (exact uint64 arithmetic, products < 2^62) and the
// loader self-tests against the numpy path before installing.
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "bb_simd.h"

static const uint64_t P = 2013265921ull;  // BabyBear

// Shoup modular multiplication: for canonical b, w < P and
// w' = floor(w * 2^64 / P), returns b*w mod P with two multiplies and a
// conditional subtract — no hardware division in the butterfly.  Exact:
// q = floor(b*w'/2^64) is floor(b*w/P) or one less, so r = b*w - q*P is
// in [0, 2P) and one subtract canonicalizes.  Byte-identical to the
// previous `%`-based butterflies (and to the numpy twin).
static inline uint64_t shoup_mul(uint64_t b, uint64_t w, uint64_t wshoup) {
    uint64_t q = static_cast<uint64_t>(
        (static_cast<__uint128_t>(b) * wshoup) >> 64);
    uint64_t r = b * w - q * P;  // wraps harmlessly: result < 2P
    return r >= P ? r - P : r;
}

static void ntt_row_range(const uint64_t* in, size_t n_in, uint64_t* out,
                          size_t n_out, const uint64_t* twiddles,
                          const uint64_t* tw_shoup, const int64_t* bitrev,
                          size_t row_begin, size_t row_end) {
    for (size_t r = row_begin; r < row_end; ++r) {
        const uint64_t* src = in + r * n_in;
        uint64_t* x = out + r * n_out;
        for (size_t j = 0; j < n_out; ++j) {
            int64_t s = bitrev[j];
            x[j] = (static_cast<size_t>(s) < n_in) ? src[s] : 0;
        }
        const uint64_t* tw = twiddles;
        const uint64_t* tws = tw_shoup;
        for (size_t half = 1; half < n_out; half *= 2) {
            const size_t len = half * 2;
            for (size_t base = 0; base < n_out; base += len) {
                uint64_t* lo = x + base;
                uint64_t* hi = x + base + half;
                for (size_t i = 0; i < half; ++i) {
                    uint64_t a = lo[i];
                    uint64_t b = shoup_mul(hi[i], tw[i], tws[i]);
                    uint64_t s = a + b;
                    if (s >= P) s -= P;
                    uint64_t d = a + P - b;
                    if (d >= P) d -= P;
                    lo[i] = s;
                    hi[i] = d;
                }
            }
            tw += half;
            tws += half;
        }
    }
}

// 32-bit Montgomery arithmetic: unlike the Shoup butterfly's 128-bit
// high multiply, every operation here is a u64 low-multiply / shift /
// compare, so the butterfly loop autovectorizes (AVX-512: vpmullq).
// Values stay < P in Montgomery form; converting in and out preserves
// the canonical residues exactly, so results remain byte-identical to
// the numpy twin.
static const uint64_t PINV_NEG = 0x77ffffffull;  // -P^{-1} mod 2^32
static const uint64_t R2 = 1172168163ull;        // (2^32)^2 mod P

static inline uint64_t mont_mul32(uint64_t a, uint64_t b) {
    uint64_t t = a * b;                                  // < 2^62
    uint64_t m = ((t & 0xffffffffull) * PINV_NEG) & 0xffffffffull;
    uint64_t r = (t + m * P) >> 32;
    return r >= P ? r - P : r;
}

// uint32-output variant: identical arithmetic, but the (4x-rate) encoded
// output is stored as uint32 (canonical values < 2^31 always fit) so the
// caller's dominant memory term halves.  A stage-local u64 scratch row
// keeps the butterflies exact; rows are encoded in Montgomery form with
// vectorizable butterflies (tw_mont = caller-side canonical twiddles
// converted once per call by zigz_ntt_rows32).
static void ntt_row_range32(const uint64_t* in, size_t n_in, uint32_t* out,
                            size_t n_out, const uint64_t* tw_mont,
                            const int64_t* bitrev,
                            size_t row_begin, size_t row_end) {
    std::vector<uint64_t> scratch(n_out);
    for (size_t r = row_begin; r < row_end; ++r) {
        const uint64_t* src = in + r * n_in;
        uint64_t* x = scratch.data();
        for (size_t j = 0; j < n_out; ++j) {
            int64_t s = bitrev[j];
            x[j] = (static_cast<size_t>(s) < n_in) ? mont_mul32(src[s], R2) : 0;
        }
        const uint64_t* tw = tw_mont;
        for (size_t half = 1; half < n_out; half *= 2) {
            const size_t len = half * 2;
            for (size_t base = 0; base < n_out; base += len) {
                uint64_t* lo = x + base;
                uint64_t* hi = x + base + half;
                size_t i = 0;
#ifdef __AVX512F__
                // Explicit vpmuludq Montgomery (bb_simd.h): the
                // autovectorized mont_mul32 lowers to vpmullq (3 uops per
                // multiply); the 32x32 unsigned form is one.
                for (; i + 8 <= half; i += 8) {
                    __m512i a = _mm512_loadu_si512((const void*)(lo + i));
                    __m512i b = bb::mm_mont_mul(
                        _mm512_loadu_si512((const void*)(hi + i)),
                        _mm512_loadu_si512((const void*)(tw + i)));
                    _mm512_storeu_si512((void*)(lo + i), bb::mm_addm(a, b));
                    _mm512_storeu_si512((void*)(hi + i), bb::mm_subm(a, b));
                }
#endif
                for (; i < half; ++i) {
                    uint64_t a = lo[i];
                    uint64_t b = mont_mul32(hi[i], tw[i]);
                    uint64_t s = a + b;
                    if (s >= P) s -= P;
                    uint64_t d = a + P - b;
                    if (d >= P) d -= P;
                    lo[i] = s;
                    hi[i] = d;
                }
            }
            tw += half;
        }
        uint32_t* dst = out + r * n_out;
        size_t j = 0;
#ifdef __AVX512F__
        const __m512i onev = _mm512_set1_epi64(1);
        for (; j + 8 <= n_out; j += 8)
            bb::mm_store_u32x8(dst + j,
                               bb::mm_mont_mul(
                                   _mm512_loadu_si512((const void*)(x + j)),
                                   onev));
#endif
        for (; j < n_out; ++j)
            dst[j] = static_cast<uint32_t>(mont_mul32(x[j], 1));
    }
}

extern "C" void zigz_ntt_rows32(const uint64_t* in, size_t rows, size_t n_in,
                                uint32_t* out, size_t n_out,
                                const uint64_t* twiddles,
                                const int64_t* bitrev, int num_threads) {
    if (rows == 0 || n_out == 0) return;
    // Montgomery-form twiddles: one pass per call, shared by every
    // row/thread (n_out-1 entries; negligible vs the NTT).
    std::vector<uint64_t> tw_mont(n_out > 1 ? n_out - 1 : 0);
    for (size_t i = 0; i + 1 < n_out; ++i)
        tw_mont[i] = mont_mul32(twiddles[i], R2);
    const uint64_t* twm = tw_mont.data();
    size_t want = static_cast<size_t>(num_threads > 0 ? num_threads : 1);
    size_t nthreads = rows < want ? rows : want;
    if (nthreads <= 1) {
        ntt_row_range32(in, n_in, out, n_out, twm, bitrev, 0, rows);
        return;
    }
    std::vector<std::thread> threads;
    size_t chunk = (rows + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
        size_t begin = t * chunk;
        if (begin >= rows) break;
        size_t end = begin + chunk < rows ? begin + chunk : rows;
        threads.emplace_back(ntt_row_range32, in, n_in, out, n_out, twm,
                             bitrev, begin, end);
    }
    for (auto& th : threads) th.join();
}

extern "C" void zigz_ntt_rows(const uint64_t* in, size_t rows, size_t n_in,
                              uint64_t* out, size_t n_out,
                              const uint64_t* twiddles, const int64_t* bitrev,
                              int num_threads) {
    if (rows == 0 || n_out == 0) return;
    // Shoup companions for the twiddle tables: one pass per call, shared
    // by every row/thread (total n_out-1 entries; negligible vs the NTT).
    std::vector<uint64_t> tw_shoup(n_out > 1 ? n_out - 1 : 0);
    for (size_t i = 0; i + 1 < n_out; ++i)
        tw_shoup[i] = static_cast<uint64_t>(
            (static_cast<__uint128_t>(twiddles[i]) << 64) / P);
    const uint64_t* tws = tw_shoup.data();
    size_t want = static_cast<size_t>(num_threads > 0 ? num_threads : 1);
    size_t nthreads = rows < want ? rows : want;
    if (nthreads <= 1) {
        ntt_row_range(in, n_in, out, n_out, twiddles, tws, bitrev, 0, rows);
        return;
    }
    std::vector<std::thread> threads;
    size_t chunk = (rows + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
        size_t begin = t * chunk;
        if (begin >= rows) break;
        size_t end = begin + chunk < rows ? begin + chunk : rows;
        threads.emplace_back(ntt_row_range, in, n_in, out, n_out, twiddles,
                             tws, bitrev, begin, end);
    }
    for (auto& th : threads) th.join();
}

// v1 Lasso phase byte stream: count records of "LASSO_TABLE" + LE64(i % p)
// (prover.zig:292-363's absorption schedule).  The numpy strided-byte
// assembly of the same stream costs ~0.7 s at 2^22 rows; this is memcpy
// speed.
extern "C" void zigz_lasso_id_stream(uint64_t count, uint64_t p,
                                     uint8_t* out, int num_threads) {
    static const char tag[11] = {'L', 'A', 'S', 'S', 'O', '_',
                                 'T', 'A', 'B', 'L', 'E'};
    size_t want = static_cast<size_t>(num_threads > 0 ? num_threads : 1);
    size_t nthreads = count < 4096 ? 1 : want;
    auto fill = [out, p](uint64_t begin, uint64_t end) {
        uint8_t* dst = out + begin * 19;
        for (uint64_t i = begin; i < end; ++i) {
            std::memcpy(dst, tag, 11);
            uint64_t v = i % p;
            std::memcpy(dst + 11, &v, 8);  // little-endian host assumed (x86)
            dst += 19;
        }
    };
    if (nthreads <= 1) {
        fill(0, count);
        return;
    }
    std::vector<std::thread> threads;
    uint64_t chunk = (count + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
        uint64_t begin = t * chunk;
        if (begin >= count) break;
        uint64_t end = begin + chunk < count ? begin + chunk : count;
        threads.emplace_back(fill, begin, end);
    }
    for (auto& th : threads) th.join();
}

static uint64_t modpow(uint64_t base, uint64_t exp, uint64_t p) {
    uint64_t result = 1, acc = base % p;
    while (exp) {
        if (exp & 1) result = result * acc % p;
        acc = acc * acc % p;
        exp >>= 1;
    }
    return result;
}

// Montgomery batch inversion (one modpow + 3n mults); zeros map to zero,
// matching poly/public_mles.py:np_inv.  Exact for p < 2^31.
static void batch_inv_range(const uint64_t* in, size_t lo, size_t hi,
                            uint64_t p, uint64_t* out) {
    // Montgomery batch inversion over [lo, hi): one modpow per segment.
    // BabyBear (the only field the v2 pipeline feeds here) takes the
    // constexpr-modulus path: `% P` compiles to a multiply-shift instead
    // of a hardware division per element.
    std::vector<uint64_t> prefix(hi - lo);
    uint64_t acc = 1;
    const bool bb = (p == P);
    for (size_t i = lo; i < hi; ++i) {
        uint64_t v = bb ? in[i] % P : in[i] % p;
        prefix[i - lo] = acc;
        if (v) acc = bb ? acc * v % P : acc * v % p;
    }
    uint64_t inv = modpow(acc, p - 2, p);
    for (size_t i = hi; i-- > lo;) {
        uint64_t v = bb ? in[i] % P : in[i] % p;
        if (v) {
            out[i] = bb ? inv * prefix[i - lo] % P : inv * prefix[i - lo] % p;
            inv = bb ? inv * v % P : inv * v % p;
        } else {
            out[i] = 0;
        }
    }
}

extern "C" void zigz_batch_inv_mt(const uint64_t* in, size_t n, uint64_t p,
                                  uint64_t* out, int num_threads) {
    if (n == 0) return;
    size_t want = num_threads > 0 ? static_cast<size_t>(num_threads) : 1;
    if (want <= 1 || n < (1u << 16)) {
        batch_inv_range(in, 0, n, p, out);
        return;
    }
    std::vector<std::thread> threads;
    size_t chunk = (n + want - 1) / want;
    for (size_t t = 0; t < want; ++t) {
        size_t lo = t * chunk;
        if (lo >= n) break;
        size_t hi = lo + chunk < n ? lo + chunk : n;
        threads.emplace_back(batch_inv_range, in, lo, hi, p, out);
    }
    for (auto& th : threads) th.join();
}

extern "C" void zigz_batch_inv(const uint64_t* in, size_t n, uint64_t p,
                               uint64_t* out) {
    zigz_batch_inv_mt(in, n, p, out, 1);
}

// out[j] = sum_i a[i] * M[i*n + j] mod p  (p < 2^31; products < 2^62,
// accumulated in 128-bit so any K is exact).  Threads split the rows;
// per-thread 128-bit partials combine at the end.
extern "C" void zigz_mod_vecmat(const uint64_t* a, const uint64_t* M,
                                size_t K, size_t n, uint64_t p,
                                uint64_t* out, int num_threads) {
    size_t nthreads = (num_threads > 0 && K * n >= (1u << 18))
                          ? static_cast<size_t>(num_threads) : 1;
    if (nthreads > K) nthreads = K ? K : 1;
    std::vector<std::vector<unsigned __int128>> partials(
        nthreads, std::vector<unsigned __int128>(n, 0));
    auto work = [&](size_t t, size_t begin, size_t end) {
        auto& acc = partials[t];
        for (size_t i = begin; i < end; ++i) {
            uint64_t ai = a[i] % p;
            if (ai == 0) continue;
            const uint64_t* row = M + i * n;
            for (size_t j = 0; j < n; ++j) acc[j] += ai * row[j];
        }
    };
    if (nthreads <= 1) {
        work(0, 0, K);
    } else {
        std::vector<std::thread> threads;
        size_t chunk = (K + nthreads - 1) / nthreads;
        for (size_t t = 0; t < nthreads; ++t) {
            size_t begin = t * chunk;
            if (begin >= K) break;
            size_t end = begin + chunk < K ? begin + chunk : K;
            threads.emplace_back(work, t, begin, end);
        }
        for (auto& th : threads) th.join();
    }
    for (size_t j = 0; j < n; ++j) {
        unsigned __int128 s = 0;
        for (size_t t = 0; t < nthreads; ++t) s += partials[t][j];
        out[j] = static_cast<uint64_t>(s % p);
    }
}
