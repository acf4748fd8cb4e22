// BabyBear field arithmetic on u32 lanes, shared by the kernels of
// field_kernels.cu and zerocheck_kernels.cu and by the generated round-sum
// kernels (dag_round.cuh).  ZIGZ_HD makes every function host and device
// under nvcc and a plain inline function under a host compiler, so the same
// generated body also builds as C++ for the CPU tests.
//
// p = 15 * 2^27 + 1 < 2^31, so a sum of two canonical values fits a u32 and
// a product of two fits a u64.  A Montgomery product redc(a * b) is one
// IMAD.WIDE.U32 and a reduction in u32 registers (the TPU's jnp version,
// zigz_tpu/ops/babybear.py mont_mul, splits it into 16-bit limbs).
// redc(v * yR) = v * y mod p when y is in Montgomery form and v is not, so a
// canonical value times a Montgomery scalar stays canonical.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define ZIGZ_HD __host__ __device__ __forceinline__
#else
#define ZIGZ_HD inline
#endif

namespace zigz {

constexpr uint32_t kP = 2013265921u;        // 15 * 2^27 + 1
constexpr uint32_t kNegPInv = 0x77ffffffu;  // -p^-1 mod 2^32
constexpr uint32_t kR2 = 1172168163u;       // 2^64 mod p

// t * 2^-32 mod p for t < p * 2^32; the result is canonical.
ZIGZ_HD uint32_t redc(uint64_t t) {
  const uint32_t m = static_cast<uint32_t>(t) * kNegPInv;
  // t + m * p < 2^33 * p < 2^64, and its low 32 bits are zero.
  const uint32_t u = static_cast<uint32_t>((t + static_cast<uint64_t>(m) * kP) >> 32);
  return u >= kP ? u - kP : u;  // u < 2p
}

ZIGZ_HD uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return s >= kP ? s - kP : s;
}

ZIGZ_HD uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + kP - b;
}

ZIGZ_HD uint32_t mont_mul(uint32_t a, uint32_t b) {
  return redc(static_cast<uint64_t>(a) * b);
}

// Canonical -> Montgomery form: redc(a * R^2) = a R mod p.
ZIGZ_HD uint32_t to_mont(uint32_t a) {
  return redc(static_cast<uint64_t>(a) * kR2);
}

}  // namespace zigz
