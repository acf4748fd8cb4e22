// Keccak-f[1600] on 25 64-bit lanes, shared by the SHA3 kernels.
//
// Replaces zigz_tpu/ops/keccak_pallas.py::_permute (K3), which the TPU kernels
// inline on (lo, hi) pairs of uint32 tiles because the TPU vector unit has no
// 64-bit integer lanes.  Hopper does, so the state here is 25 uint64_t kept in
// registers, the 24 rounds are unrolled, and every rotation is written as
// (x << s) | (x >> (64 - s)), which nvcc lowers to a pair of funnel shifts.
//
// The round constants are those of keccak_pallas.py::_RC; the rho/pi walk
// below is keccak_pallas.py::_PILN / _ROTC written out as 24 explicit steps,
// so that every lane index is a compile-time constant and no lane spills to
// local memory.
//
// The header also compiles as plain C++ (no __CUDACC__), so the permutation
// can be checked against hashlib with a host compiler.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define ZIGZ_KECCAK_FN __device__ __forceinline__
#define ZIGZ_KECCAK_CONST static __constant__
#else
#define ZIGZ_KECCAK_FN static inline
#define ZIGZ_KECCAK_CONST static const
#endif

ZIGZ_KECCAK_CONST uint64_t kZigzKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// s is a compile-time constant in 1..63 at every call site.
ZIGZ_KECCAK_FN uint64_t zigz_rotl64(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

ZIGZ_KECCAK_FN void zigz_keccak_f1600(uint64_t s[25]) {
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int round = 0; round < 24; ++round) {
    // Theta.
    uint64_t bc[5];
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int i = 0; i < 5; ++i) {
      bc[i] = s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20];
    }
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ zigz_rotl64(bc[(i + 1) % 5], 1);
#if defined(__CUDACC__)
#pragma unroll
#endif
      for (int j = 0; j < 25; j += 5) {
        s[j + i] ^= t;
      }
    }

    // Rho and pi: _PILN = [10, 7, 11, ...], _ROTC = [1, 3, 6, ...].
    uint64_t t = s[1];
    uint64_t u;
    u = s[10]; s[10] = zigz_rotl64(t, 1);  t = u;
    u = s[7];  s[7]  = zigz_rotl64(t, 3);  t = u;
    u = s[11]; s[11] = zigz_rotl64(t, 6);  t = u;
    u = s[17]; s[17] = zigz_rotl64(t, 10); t = u;
    u = s[18]; s[18] = zigz_rotl64(t, 15); t = u;
    u = s[3];  s[3]  = zigz_rotl64(t, 21); t = u;
    u = s[5];  s[5]  = zigz_rotl64(t, 28); t = u;
    u = s[16]; s[16] = zigz_rotl64(t, 36); t = u;
    u = s[8];  s[8]  = zigz_rotl64(t, 45); t = u;
    u = s[21]; s[21] = zigz_rotl64(t, 55); t = u;
    u = s[24]; s[24] = zigz_rotl64(t, 2);  t = u;
    u = s[4];  s[4]  = zigz_rotl64(t, 14); t = u;
    u = s[15]; s[15] = zigz_rotl64(t, 27); t = u;
    u = s[23]; s[23] = zigz_rotl64(t, 41); t = u;
    u = s[19]; s[19] = zigz_rotl64(t, 56); t = u;
    u = s[13]; s[13] = zigz_rotl64(t, 8);  t = u;
    u = s[12]; s[12] = zigz_rotl64(t, 25); t = u;
    u = s[2];  s[2]  = zigz_rotl64(t, 43); t = u;
    u = s[20]; s[20] = zigz_rotl64(t, 62); t = u;
    u = s[14]; s[14] = zigz_rotl64(t, 18); t = u;
    u = s[22]; s[22] = zigz_rotl64(t, 39); t = u;
    u = s[9];  s[9]  = zigz_rotl64(t, 61); t = u;
    u = s[6];  s[6]  = zigz_rotl64(t, 20); t = u;
    s[1] = zigz_rotl64(t, 44);

    // Chi.
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int j = 0; j < 25; j += 5) {
      const uint64_t a0 = s[j], a1 = s[j + 1], a2 = s[j + 2], a3 = s[j + 3], a4 = s[j + 4];
      s[j]     = a0 ^ (~a1 & a2);
      s[j + 1] = a1 ^ (~a2 & a3);
      s[j + 2] = a2 ^ (~a3 & a4);
      s[j + 3] = a3 ^ (~a4 & a0);
      s[j + 4] = a4 ^ (~a0 & a1);
    }

    // Iota.
    s[0] ^= kZigzKeccakRC[round];
  }
}
