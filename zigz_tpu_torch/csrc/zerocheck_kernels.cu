// Z2 of the zerocheck round on the card, bound to Python through ctypes.
// Z1, the round sums, is generated for each DAG program (csrc/dag_round.cuh,
// ops/dag_codegen.py).
//
// Z2 ext_fold_kernel: the fold of every table by one BabyBear^4 challenge r,
//    out = lo + r (hi - lo) with X^4 = 11, from either plane layout into the
//    all-extension one.  Counterpart of the fold half of _hybrid_step_fn and
//    _ext_step_fn (zigz_tpu/ops/ext4_dev.py:132 ext_fold_dev, :144
//    ext_fold_base_dev).
//
// Planes are (rows, width) int64 canonical values, as the port's torch ops
// keep them; only their low 32 bits are read.
//
// Z2 gives one thread per (lane j, output group g): a base row becomes the
// 4 coordinates (1 - r)_e lo + r_e hi; an extension table the schoolbook
// product, two canonical-times-Montgomery products per REDC.  It is bound by
// bytes: each input read once, each output written once.
//
// The launcher takes device pointers, sizes and the CUDA stream, launches
// on that stream without synchronising, allocates nothing, and returns the
// first CUDA error so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using zigz::add_mod;
using zigz::redc;
using zigz::sub_mod;

constexpr int kFoldThreads = 256;
constexpr int kGroupWords = 5;  // kind, s0, s1, s2, s3

// r and W r as Montgomery scalars, r_m[e] = r_e R mod p.
struct FoldScalar {
  uint32_t r[4];
  uint32_t wr[4];
};

__global__ void __launch_bounds__(kFoldThreads)
ext_fold_kernel(const int64_t* __restrict__ in, int64_t width, const int* __restrict__ groups, int n_groups,
                FoldScalar s, int64_t* __restrict__ out) {
  const int64_t half = width >> 1;
  const int g = blockIdx.y;
  const int kind = __ldg(groups + g * kGroupWords);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < half; j += stride) {
    uint32_t o[4];
    if (kind == 0) {
      const int64_t* src = in + static_cast<int64_t>(__ldg(groups + g * kGroupWords + 1)) * width + j;
      const uint32_t lo = static_cast<uint32_t>(src[0]);
      const uint32_t d = sub_mod(static_cast<uint32_t>(src[half]), lo);
      o[0] = add_mod(lo, redc(static_cast<uint64_t>(d) * s.r[0]));
#pragma unroll
      for (int e = 1; e < 4; ++e) o[e] = redc(static_cast<uint64_t>(d) * s.r[e]);
    } else {
      uint32_t lo[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t* src = in + static_cast<int64_t>(__ldg(groups + g * kGroupWords + 1 + e)) * width + j;
        lo[e] = static_cast<uint32_t>(src[0]);
        d[e] = sub_mod(static_cast<uint32_t>(src[half]), lo[e]);
      }
      // (r d)_k = sum_i M[k][i] d_i, M[k][i] = r_{k-i} for i <= k, W r_{k-i+4} above;
      // two products < 2 p^2 < p 2^32 go into one REDC.
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = i <= k ? s.r[k - i] : s.wr[k - i + 4];
        const uint32_t a = redc(static_cast<uint64_t>(d[0]) * m[0] + static_cast<uint64_t>(d[1]) * m[1]);
        const uint32_t b = redc(static_cast<uint64_t>(d[2]) * m[2] + static_cast<uint64_t>(d[3]) * m[3]);
        o[k] = add_mod(lo[k], add_mod(a, b));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[(static_cast<int64_t>(e) * n_groups + g) * half + j] = o[e];
  }
}

}  // namespace

extern "C" {

// out (4 n_groups, width / 2); `scalar` a host array of r_m[4] then (W r)_m[4].
int zigz_ext_fold(const void* in, int64_t width, const void* groups, int n_groups, const uint32_t* scalar,
                  void* out, void* stream) {
  const int64_t half = width / 2;
  if (half < 1 || n_groups < 1) return 0;
  FoldScalar s{};
  for (int e = 0; e < 4; ++e) {
    s.r[e] = scalar[e];
    s.wr[e] = scalar[4 + e];
  }
  const int64_t blocks = (half + kFoldThreads - 1) / kFoldThreads;
  const dim3 grid(static_cast<unsigned int>(blocks < 65536 ? blocks : 65536), static_cast<unsigned int>(n_groups));
  ext_fold_kernel<<<grid, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), width, static_cast<const int*>(groups), n_groups, s,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
