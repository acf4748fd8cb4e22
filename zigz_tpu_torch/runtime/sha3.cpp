// Native batch SHA3-256 hashing for Merkle tree construction.
//
// The proving pipeline hashes 43 * 2^(v+1) small messages per proof
// (leaf = 8-byte LE field value, node = 64-byte digest pair,
// merkle_tree.zig:246-262).  Python's hashlib tops out around 1M hashes/s;
// this library does batched single-block Keccak-f[1600] permutations across
// std::thread workers and is exposed to Python via a C ABI + ctypes
// (zigz_tpu/runtime/__init__.py).
//
// Implementation: Keccak-f[1600] per FIPS 202 (24 rounds of
// theta/rho-pi/chi/iota); SHA3-256 = rate 136, pad 0x06 ... 0x80.  All our
// messages are <= 64 bytes, i.e. exactly one absorb block -> one
// permutation per hash.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread sha3.cpp -o libzigz_sha3.so

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#include <algorithm>
#include <atomic>

namespace {

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rotl64(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

// Keccak-f[1600] permutation on a 25-lane state.
void keccakf(uint64_t st[25]) {
  for (int round = 0; round < 24; ++round) {
    // Theta
    uint64_t bc[5];
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // Rho + Pi
    uint64_t t = st[1];
    static constexpr int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                     8,  21, 24, 4,  15, 23, 19, 13,
                                     12, 2,  20, 14, 22, 9,  6,  1};
    static constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                     45, 55, 2,  14, 27, 41, 56, 8,
                                     25, 43, 62, 18, 39, 61, 20, 44};
    for (int i = 0; i < 24; ++i) {
      int j = piln[i];
      uint64_t tmp = st[j];
      st[j] = rotl64(t, rotc[i]);
      t = tmp;
    }
    // Chi
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5];
      for (int i = 0; i < 5; ++i) row[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    // Iota
    st[0] ^= RC[round];
  }
}

// SHA3-256 of a message that fits in one rate block (len <= 135).
inline void sha3_256_small(const uint8_t* msg, size_t len, uint8_t out[32]) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, msg, len);
  block[len] = 0x06;
  block[135] |= 0x80;
  for (int i = 0; i < 17; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + i * 8, 8);
    st[i] ^= lane;
  }
  keccakf(st);
  std::memcpy(out, st, 32);
}

// SHA3-256 of an arbitrary-length message (multi-block absorb).
inline void sha3_256_long(const uint8_t* msg, size_t len, uint8_t out[32]) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  const size_t rate = 136;
  while (len >= rate) {
    for (int i = 0; i < 17; ++i) {
      uint64_t lane;
      std::memcpy(&lane, msg + i * 8, 8);
      st[i] ^= lane;
    }
    keccakf(st);
    msg += rate;
    len -= rate;
  }
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, msg, len);
  block[len] = 0x06;
  block[135] |= 0x80;
  for (int i = 0; i < 17; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + i * 8, 8);
    st[i] ^= lane;
  }
  keccakf(st);
  std::memcpy(out, st, 32);
}

// W-way interleaved Keccak-f[1600]: state[lane][w] hashes W independent
// messages at once; the fixed-size inner loops over w vectorize (W=8 is
// one AVX-512 register per lane).
template <int W>
void keccakf_w(uint64_t st[25][W]) {
  static constexpr int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                   8,  21, 24, 4,  15, 23, 19, 13,
                                   12, 2,  20, 14, 22, 9,  6,  1};
  static constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                   45, 55, 2,  14, 27, 41, 56, 8,
                                   25, 43, 62, 18, 39, 61, 20, 44};
  for (int round = 0; round < 24; ++round) {
    uint64_t bc[5][W];
    for (int i = 0; i < 5; ++i)
      for (int w = 0; w < W; ++w)
        bc[i][w] = st[i][w] ^ st[i + 5][w] ^ st[i + 10][w] ^ st[i + 15][w] ^
                   st[i + 20][w];
    for (int i = 0; i < 5; ++i) {
      uint64_t t[W];
      for (int w = 0; w < W; ++w)
        t[w] = bc[(i + 4) % 5][w] ^ rotl64(bc[(i + 1) % 5][w], 1);
      for (int j = 0; j < 25; j += 5)
        for (int w = 0; w < W; ++w) st[j + i][w] ^= t[w];
    }
    uint64_t t[W];
    for (int w = 0; w < W; ++w) t[w] = st[1][w];
    for (int i = 0; i < 24; ++i) {
      int j = piln[i];
      uint64_t tmp[W];
      for (int w = 0; w < W; ++w) tmp[w] = st[j][w];
      for (int w = 0; w < W; ++w) st[j][w] = rotl64(t[w], rotc[i]);
      for (int w = 0; w < W; ++w) t[w] = tmp[w];
    }
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5][W];
      for (int i = 0; i < 5; ++i)
        for (int w = 0; w < W; ++w) row[i][w] = st[j + i][w];
      for (int i = 0; i < 5; ++i)
        for (int w = 0; w < W; ++w)
          st[j + i][w] =
              row[i][w] ^ ((~row[(i + 1) % 5][w]) & row[(i + 2) % 5][w]);
    }
    for (int w = 0; w < W; ++w) st[0][w] ^= RC[round];
  }
}

void run_parallel(size_t n, int num_threads, const std::function<void(size_t, size_t)>& fn) {
  if (num_threads <= 1 || n < 4096) {
    fn(0, n);
    return;
  }
  size_t chunk = (n + num_threads - 1) / num_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) {
    size_t lo = t * chunk;
    size_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// SHA3-256 over n 8-byte little-endian values -> n 32-byte digests,
// eight per permutation (one AVX-512 register per Keccak lane; scalar
// tail).
void zigz_sha3_leaves_u64(const uint64_t* values, size_t n, uint8_t* out,
                          int num_threads) {
  constexpr int W = 8;
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    size_t i = lo;
    for (; i + W <= hi; i += W) {
      uint64_t st[25][W];
      std::memset(st, 0, sizeof(st));
      for (int w = 0; w < W; ++w) {
        st[0][w] = values[i + w];
        st[1][w] = 0x06;
        st[16][w] = 0x8000000000000000ULL;
      }
      keccakf_w<W>(st);
      for (int w = 0; w < W; ++w) {
        uint64_t digest[4] = {st[0][w], st[1][w], st[2][w], st[3][w]};
        std::memcpy(out + (i + w) * 32, digest, 32);
      }
    }
    for (; i < hi; ++i)
      sha3_256_small(reinterpret_cast<const uint8_t*>(values + i), 8,
                     out + i * 32);
  });
}

// SHA3-256 over n 64-byte messages (digest pairs) -> n 32-byte digests.
void zigz_sha3_merge(const uint8_t* pairs, size_t n, uint8_t* out,
                     int num_threads) {
  constexpr int W = 8;
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    size_t i = lo;
    for (; i + W <= hi; i += W) {
      uint64_t st[25][W];
      std::memset(st, 0, sizeof(st));
      for (int w = 0; w < W; ++w) {
        uint64_t lanes[8];
        std::memcpy(lanes, pairs + (i + w) * 64, 64);
        for (int k = 0; k < 8; ++k) st[k][w] = lanes[k];
        st[8][w] = 0x06;
        st[16][w] = 0x8000000000000000ULL;
      }
      keccakf_w<W>(st);
      for (int w = 0; w < W; ++w) {
        uint64_t digest[4] = {st[0][w], st[1][w], st[2][w], st[3][w]};
        std::memcpy(out + (i + w) * 32, digest, 32);
      }
    }
    for (; i < hi; ++i) sha3_256_small(pairs + i * 64, 64, out + i * 32);
  });
}

// General batch: n messages of uniform length len (<=135 bytes).
void zigz_sha3_batch(const uint8_t* msgs, size_t len, size_t n, uint8_t* out,
                     int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      sha3_256_small(msgs + i * len, len, out + i * 32);
    }
  });
}

// Build a full binary Merkle level structure in one call: given n leaf
// digests (32B each, n a power of two), writes all internal levels
// concatenated (n/2 + n/4 + ... + 1 digests) into out.
// SHA3-256 over n equal-length messages of ANY length (Ligero column
// leaves: rows*8 bytes each) -> n 32-byte digests.
void zigz_sha3_long_batch(const uint8_t* msgs, size_t len, size_t n,
                          uint8_t* out, int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      sha3_256_long(msgs + i * len, len, out + i * 32);
    }
  });
}

// Hash the COLUMNS of a row-major (rows, n) u64 matrix: digest j =
// SHA3-256(col_j as LE u64s).  Saves the host-side transpose copy for
// Ligero leaf hashing; each thread gathers its column into a local
// buffer and absorbs it.
void zigz_sha3_matrix_columns(const uint64_t* matrix, size_t rows, size_t n,
                              uint8_t* out, int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    std::vector<uint64_t> buf(rows);
    for (size_t j = lo; j < hi; ++j) {
      for (size_t i = 0; i < rows; ++i) buf[i] = matrix[i * n + j];
      sha3_256_long(reinterpret_cast<const uint8_t*>(buf.data()), rows * 8,
                    out + j * 32);
    }
  });
}

// u32 storage variant: the matrix holds canonical BabyBear values (< 2^31)
// as uint32; each is widened to the SAME LE u64 preimage bytes before
// absorption, so digests are byte-identical to the u64 path while the
// caller keeps the (dominant) encoded matrix at half the memory.
void zigz_sha3_matrix_columns_u32(const uint32_t* matrix, size_t rows,
                                  size_t n, uint8_t* out, int num_threads) {
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    std::vector<uint64_t> buf(rows);
    for (size_t j = lo; j < hi; ++j) {
      for (size_t i = 0; i < rows; ++i)
        buf[i] = static_cast<uint64_t>(matrix[i * n + j]);
      sha3_256_long(reinterpret_cast<const uint8_t*>(buf.data()), rows * 8,
                    out + j * 32);
    }
  });
}

// Narrow-preimage variant: canonical BabyBear values (< 2^31) absorbed as
// 4-byte LE words — half the preimage bytes (and half the Keccak blocks)
// of the u64 encoding.  This is the Ligero column-leaf encoding from
// protocol v2 on (commitments/ligero.py _hash_columns); the wide u64
// variants above remain for the v1-parity Merkle leaves.  Columns are
// hashed 8 at a time through the interleaved permutation (one AVX-512
// register per Keccak lane).
void zigz_sha3_matrix_columns_u32le(const uint32_t* matrix, size_t rows,
                                    size_t n, uint8_t* out, int num_threads) {
  // Padded u32 word count: full 34-word (136-byte) blocks + pad block.
  const size_t wp = ((rows * 4) / 136 + 1) * 34;
  const size_t nb = wp / 34;
  run_parallel(n, num_threads, [&](size_t lo, size_t hi) {
    constexpr int W = 8;
    size_t j = lo;
    auto word = [&](size_t idx, size_t col) -> uint32_t {
      uint32_t v = idx < rows ? matrix[idx * n + col] : 0u;
      if (idx == rows) v |= 0x06u;
      if (idx == wp - 1) v |= 0x80000000u;
      return v;
    };
    for (; j + W <= hi; j += W) {
      uint64_t st[25][W];
      std::memset(st, 0, sizeof(st));
      for (size_t b = 0; b < nb; ++b) {
        for (int k = 0; k < 17; ++k) {
          size_t i0 = b * 34 + 2 * (size_t)k;
          for (int w = 0; w < W; ++w) {
            uint64_t lane = (uint64_t)word(i0, j + w) |
                            ((uint64_t)word(i0 + 1, j + w) << 32);
            st[k][w] ^= lane;
          }
        }
        keccakf_w<W>(st);
      }
      for (int w = 0; w < W; ++w) {
        uint64_t digest[4] = {st[0][w], st[1][w], st[2][w], st[3][w]};
        std::memcpy(out + (j + w) * 32, digest, 32);
      }
    }
    std::vector<uint32_t> buf(rows);
    for (; j < hi; ++j) {
      for (size_t i = 0; i < rows; ++i) buf[i] = matrix[i * n + j];
      sha3_256_long(reinterpret_cast<const uint8_t*>(buf.data()), rows * 4,
                    out + j * 32);
    }
  });
}

void zigz_sha3_tree(const uint8_t* leaves, size_t n, uint8_t* out,
                    int num_threads) {
  const uint8_t* cur = leaves;
  size_t level_n = n / 2;
  uint8_t* dst = out;
  while (level_n >= 1) {
    zigz_sha3_merge(cur, level_n, dst, num_threads);
    cur = dst;
    dst += level_n * 32;
    if (level_n == 1) break;
    level_n /= 2;
  }
}

}  // extern "C"

extern "C" {

// Whole-forest build: num_trees trees of n u64 leaf VALUES each (n a power
// of two), laid out tree-major.  For each tree writes, contiguously:
// [n leaf digests][n/2][n/4]...[1 root], i.e. (2n-1) digests of 32 bytes.
// Parallelized across trees (each tree's levels are sequential anyway).
void zigz_sha3_forest(const uint64_t* values, size_t num_trees, size_t n,
                      uint8_t* out, int num_threads) {
  size_t per_tree = (2 * n - 1) * 32;
  auto build_tree = [&](size_t t) {
    const uint64_t* vals = values + t * n;
    uint8_t* base = out + t * per_tree;
    // Leaf digests + internal levels, 8 per permutation via the
    // interleaved kernels (trees are parallelized across threads, so the
    // inner calls run single-threaded).
    zigz_sha3_leaves_u64(vals, n, base, 1);
    const uint8_t* cur = base;
    uint8_t* dst = base + n * 32;
    size_t level_n = n / 2;
    while (level_n >= 1) {
      zigz_sha3_merge(cur, level_n, dst, 1);
      cur = dst;
      dst += level_n * 32;
      if (level_n == 1) break;
      level_n /= 2;
    }
  };
  if (num_threads <= 1 || num_trees == 1) {
    for (size_t t = 0; t < num_trees; ++t) build_tree(t);
    return;
  }
  std::vector<std::thread> threads;
  std::atomic<size_t> next{0};
  int workers = std::min<size_t>(num_threads, num_trees);
  for (int w = 0; w < workers; ++w) {
    threads.emplace_back([&]() {
      for (;;) {
        size_t t = next.fetch_add(1);
        if (t >= num_trees) return;
        build_tree(t);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Poseidon2-over-BabyBear column sponge (core/poseidon2.py twin).
//
// Hashes the COLUMNS of a row-major matrix with the rate-8/capacity-8
// sponge: state[8] = rows mod p, absorb 8 rows per permutation, digest =
// first 8 lanes as 4-byte LE each.  Round constants / internal diagonal
// are PASSED IN from the Python generator (one source of truth).  Scalar
// permutation, threaded across columns — replaces the numpy sponge that
// made protocol v3's Ligero commitments ~60x slower than SHA3's.
// ---------------------------------------------------------------------------

namespace p2 {

static const uint64_t BB = 2013265921ull;

struct Params {
  const uint64_t* rc_ext;  // 8 rounds x 16 lanes
  const uint64_t* rc_int;  // 13
  const uint64_t* mu;      // 16
};

static inline uint64_t addp(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  return s >= BB ? s - BB : s;
}

static inline uint64_t mulp(uint64_t a, uint64_t b) { return a * b % BB; }

static inline uint64_t sbox7(uint64_t x) {
  uint64_t x2 = mulp(x, x);
  uint64_t x4 = mulp(x2, x2);
  return mulp(mulp(x4, x2), x);
}

// External layer: M4 within each 4-block (entries 1..7: accumulate raw,
// one reduction), then add cross-block column sums.
static inline void external_linear(uint64_t* s) {
  static const uint64_t M4[4][4] = {
      {5, 7, 1, 3}, {4, 6, 1, 1}, {1, 3, 5, 7}, {1, 1, 4, 6}};
  uint64_t tmp[16];
  for (int b = 0; b < 16; b += 4) {
    for (int i = 0; i < 4; ++i) {
      uint64_t acc = 0;
      for (int j = 0; j < 4; ++j) acc += M4[i][j] * s[b + j];
      tmp[b + i] = acc % BB;
    }
  }
  uint64_t col[4];
  for (int i = 0; i < 4; ++i)
    col[i] = (tmp[i] + tmp[4 + i] + tmp[8 + i] + tmp[12 + i]) % BB;
  for (int b = 0; b < 16; b += 4)
    for (int i = 0; i < 4; ++i) s[b + i] = addp(tmp[b + i], col[i]);
}

static inline void internal_linear(uint64_t* s, const uint64_t* mu) {
  uint64_t total = 0;
  for (int i = 0; i < 16; ++i) total += s[i];
  total %= BB;
  for (int i = 0; i < 16; ++i) s[i] = (total + mu[i] * s[i]) % BB;
}

static void permute(uint64_t* s, const Params& pr) {
  external_linear(s);
  int rc = 0;
  for (int r = 0; r < 4; ++r) {
    for (int i = 0; i < 16; ++i) s[i] = sbox7(addp(s[i], pr.rc_ext[rc + i]));
    rc += 16;
    external_linear(s);
  }
  for (int r = 0; r < 13; ++r) {
    s[0] = sbox7(addp(s[0], pr.rc_int[r]));
    internal_linear(s, pr.mu);
  }
  for (int r = 0; r < 4; ++r) {
    for (int i = 0; i < 16; ++i) s[i] = sbox7(addp(s[i], pr.rc_ext[rc + i]));
    rc += 16;
    external_linear(s);
  }
}

template <typename T>
static void columns_range(const T* matrix, size_t rows, size_t n,
                          const Params& pr, uint8_t* out, size_t lo,
                          size_t hi) {
  for (size_t j = lo; j < hi; ++j) {
    uint64_t st[16] = {0};
    st[8] = rows % BB;
    size_t steps = rows ? (rows + 7) / 8 : 1;
    for (size_t blk = 0; blk < steps; ++blk) {
      size_t base = blk * 8;
      size_t bs = rows > base ? (rows - base < 8 ? rows - base : 8) : 0;
      for (size_t i = 0; i < bs; ++i)
        st[i] = addp(st[i],
                     static_cast<uint64_t>(matrix[(base + i) * n + j]) % BB);
      permute(st, pr);
    }
    uint8_t* dst = out + j * 32;
    for (int i = 0; i < 8; ++i) {
      uint32_t v = static_cast<uint32_t>(st[i]);
      std::memcpy(dst + i * 4, &v, 4);
    }
  }
}

template <typename T>
static void columns_threaded(const T* matrix, size_t rows, size_t n,
                             const Params& pr, uint8_t* out,
                             int num_threads) {
  size_t want = static_cast<size_t>(num_threads > 0 ? num_threads : 1);
  size_t nthreads = n < want ? (n ? n : 1) : want;
  if (nthreads <= 1) {
    columns_range(matrix, rows, n, pr, out, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t lo = t * chunk;
    if (lo >= n) break;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    threads.emplace_back(columns_range<T>, matrix, rows, n, std::cref(pr),
                         out, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace p2

extern "C" {

void zigz_p2_matrix_columns(const uint64_t* matrix, size_t rows, size_t n,
                            const uint64_t* rc_ext, const uint64_t* rc_int,
                            const uint64_t* mu, uint8_t* out,
                            int num_threads) {
  p2::Params pr{rc_ext, rc_int, mu};
  p2::columns_threaded(matrix, rows, n, pr, out, num_threads);
}

void zigz_p2_matrix_columns_u32(const uint32_t* matrix, size_t rows, size_t n,
                                const uint64_t* rc_ext, const uint64_t* rc_int,
                                const uint64_t* mu, uint8_t* out,
                                int num_threads) {
  p2::Params pr{rc_ext, rc_int, mu};
  p2::columns_threaded(matrix, rows, n, pr, out, num_threads);
}

// Batch Poseidon2 sponge hashes over pairs of 32-byte digests (internal
// Merkle nodes): in = 2k digests (64 bytes per pair), out = k digests.
// Each digest is 8 BabyBear limbs (4-byte LE); a pair absorbs as 16 field
// values = two rate-8 blocks (matching core/poseidon2.hash_two_digests).
void zigz_p2_merge(const uint8_t* in, size_t k, const uint64_t* rc_ext,
                   const uint64_t* rc_int, const uint64_t* mu, uint8_t* out,
                   int num_threads) {
  p2::Params pr{rc_ext, rc_int, mu};
  auto run = [&](size_t lo, size_t hi) {
    for (size_t idx = lo; idx < hi; ++idx) {
      const uint8_t* src = in + idx * 64;
      uint64_t st[16] = {0};
      st[8] = 16;  // length domain separation: 16 absorbed values
      for (int blk = 0; blk < 2; ++blk) {
        for (int i = 0; i < 8; ++i) {
          uint32_t v;
          std::memcpy(&v, src + blk * 32 + i * 4, 4);
          st[i] = p2::addp(st[i], v % p2::BB);
        }
        p2::permute(st, pr);
      }
      uint8_t* dst = out + idx * 32;
      for (int i = 0; i < 8; ++i) {
        uint32_t v = static_cast<uint32_t>(st[i]);
        std::memcpy(dst + i * 4, &v, 4);
      }
    }
  };
  size_t want = static_cast<size_t>(num_threads > 0 ? num_threads : 1);
  size_t nthreads = k < want ? (k ? k : 1) : want;
  if (nthreads <= 1) {
    run(0, k);
    return;
  }
  std::vector<std::thread> threads;
  size_t chunk = (k + nthreads - 1) / nthreads;
  for (size_t t = 0; t < nthreads; ++t) {
    size_t lo = t * chunk;
    if (lo >= k) break;
    size_t hi = lo + chunk < k ? lo + chunk : k;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
