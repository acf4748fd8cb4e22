// Batch XXH3 query-hash chains for the pipeline Lasso phase.
//
// Python-side per-row hashing (3 xxhash calls through the C extension per
// query) costs ~10s for a 2^20-step trace; this native batch runs the
// exact same chain (h ^= v; h = XXH3_64(le64(h), seed=0) per value,
// inputs then outputs — lasso_prover.zig:208-239) at memory speed.
//
// Uses the system-vendored canonical xxhash implementation (header-only,
// XXH_INLINE_ALL) — found under pyarrow's installed includes; the build
// script passes its directory via -I.
//
// Build: g++ -O3 -march=native -shared -fPIC -I<xxhash dir> lasso_hash.cpp \
//            -o libzigz_lasso.so

#define XXH_INLINE_ALL
#include "xxhash.h"

#include <cstdint>
#include <cstring>

extern "C" {

// rows of (num_inputs inputs, num_outputs outputs), all u64; writes
// (chain mod modulus) per row into out.
void zigz_lasso_hash_rows(const uint64_t* inputs, const uint64_t* outputs,
                          size_t n, size_t num_inputs, size_t num_outputs,
                          uint64_t modulus, uint64_t* out) {
  for (size_t i = 0; i < n; ++i) {
    uint64_t h = 0;
    const uint64_t* in_row = inputs + i * num_inputs;
    for (size_t j = 0; j < num_inputs; ++j) {
      h ^= in_row[j];
      uint64_t le = h;  // little-endian byte view of the u64
      h = XXH3_64bits_withSeed(&le, 8, 0);
    }
    const uint64_t* out_row = outputs + i * num_outputs;
    for (size_t j = 0; j < num_outputs; ++j) {
      h ^= out_row[j];
      uint64_t le = h;
      h = XXH3_64bits_withSeed(&le, 8, 0);
    }
    out[i] = h % modulus;
  }
}

}  // extern "C"

extern "C" {

// Single O(n) replay of the register write log: for each step i fills the
// values of rs1/rs2 BEFORE the step and rd AFTER it (x0 reads as 0).
// Replaces a (32, n) forward-fill matrix + binary-search gathers that cost
// seconds at 2^22 on the host.
void zigz_operand_values(const uint8_t* write_idx, const uint64_t* write_val,
                         const uint64_t* initial_regs,
                         const uint8_t* rs1, const uint8_t* rs2,
                         const uint8_t* rd, size_t n,
                         uint64_t* rs1_val, uint64_t* rs2_val,
                         uint64_t* rd_after) {
  uint64_t regs[32];
  for (int r = 0; r < 32; ++r) regs[r] = initial_regs[r];
  regs[0] = 0;
  for (size_t i = 0; i < n; ++i) {
    rs1_val[i] = regs[rs1[i] & 31];
    rs2_val[i] = regs[rs2[i] & 31];
    uint8_t w = write_idx[i] & 31;
    if (w != 0) regs[w] = write_val[i];
    rd_after[i] = regs[rd[i] & 31];
  }
}

}  // extern "C"
