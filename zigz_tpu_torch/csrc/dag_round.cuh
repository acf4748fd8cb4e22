// Z1, the zerocheck round sums, as a kernel generated for each DAG program:
// g(0), g(2..degree) of a traced combiner DAG over the half-split plane
// stack, summed over every lane of the width in one launch.
//
// What it replaces: the interpreter that was Z1 before it (a kernel that
// staged a program's instructions through shared memory, decoded each one
// and kept its values in shared-memory slots, now removed); and in the JAX
// package the jitted round of zigz_tpu/ops/symtrace.py:260 compile_device
// under zigz_tpu/ops/zerocheck_dev_ext.py:113 _round_sums
// (zerocheck_gen.py:302 _round_fn for the base field), which XLA compiles
// once per DAG signature.  No Pallas kernel: the TPU ran XLA's code.
//
// What bounds it: the DAG's field operations, 11,738 a lane-point for the
// largest program (6,194 Montgomery products of about ten integer
// instructions each).  The planes' bytes, read once, are a few percent of
// that.
//
// What the design does about it: ops/dag_codegen.py writes the program's
// body as straight-line C++ over SSA values (`const auto v7 = mul(v3, c[12]);`)
// and includes this header, which holds everything else.  So there is no
// decode and no slot traffic: values live in registers, which ptxas
// allocates.  The generator cuts the body into __noinline__ segments of
// 250 instructions; a value that a later segment reads crosses the cut
// through a per-thread array in local memory (L1), at the program's own
// slot.  Whole bodies of thousands of instructions took ptxas tens of
// minutes and spilled; cut, the largest program builds in about a minute.
// __launch_bounds__ asks for five blocks of 128 threads an SM (at most 96
// registers a thread), so 20 warps hide the latency of the loads and of
// the spills; on an H100 that beat 255 registers a thread, at most 128,
// six blocks and 256 threads a block (PERF.md, PR 9).
//
// A plane row is read where the program (or a segment) first uses it and
// formed once per lane-point, lo R + t (hi - lo) R, as
// REDC(lo R^2 + (hi - lo) t R^2): two products below 2 p^2 < p 2^32 in one
// REDC.  Its loads depend on nothing, so the compiler issues them early.
// The constants of this prove are a __grid_constant__ parameter (up to
// 8,000 of them; 1,977 for the largest program), copied from the host
// table at launch: the program depends on the DAG alone, no table is
// uploaded, and a warp reads a constant from parameter space, the same
// address for every thread, rather than through a pointer to device
// memory.  One thread takes one lane at one point, and the point is the
// fastest block index, so the `degree` blocks of one lane tile run side by
// side and read the same plane lines, which L2 keeps.  (All of a lane's
// points in one thread, at `degree` times the live values, ran 14-27%
// slower on an H100: PERF.md.)
//
// The epilogue is the interpreter's: the eq row's product for a base-field
// program, then each output summed over the warp in u64 and added
// atomically to the (degree, n_out) u64 buffer that the launcher zeroes.
// Values are Montgomery u32 below p, so 2^32 lanes sum below 2^63; the
// sums stay in Montgomery form and the wrapper converts them once (the sum
// is linear).
//
// A generated unit defines ZIGZ_DAG_N_OUT (1 to 4) and ZIGZ_DAG_N_CONSTS,
// includes this header, and defines zigz_dag::body.  Under nvcc it is a
// kernel and its extern "C" launcher, zigz_dag_round_sums; under a host
// compiler the same body runs in zigz_dag_host, the CPU tests' entry, with
// the same point formation and the same u64 sums.
#pragma once

#include <cstdint>
#include <cstring>

#include "babybear.cuh"

#if !defined(ZIGZ_DAG_N_OUT) || !defined(ZIGZ_DAG_N_CONSTS)
#error "dag_round.cuh is included by a generated program, after its ZIGZ_DAG_* definitions"
#endif

// The generated body and its segments: device code alone under nvcc (its
// host pass would otherwise compile every segment with the host compiler
// too), host code under a host compiler.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ZIGZ_DAG_SEGMENT __device__ __noinline__
#define ZIGZ_DAG_BODY __device__ __forceinline__
#else
#define ZIGZ_DAG_SEGMENT __attribute__((noinline))
#define ZIGZ_DAG_BODY inline
#endif
#ifdef __CUDA_ARCH__
#define ZIGZ_DAG_LOAD(p) __ldg(p)
#else
#define ZIGZ_DAG_LOAD(p) (*(p))
#endif

namespace zigz_dag {

using zigz::add_mod;
using zigz::kP;
using zigz::kR2;
using zigz::mont_mul;
using zigz::redc;
using zigz::sub_mod;

constexpr int kOut = ZIGZ_DAG_N_OUT;
constexpr int kConsts = ZIGZ_DAG_N_CONSTS;
constexpr int kThreads = 128;  // a block
constexpr int kMinBlocks = 5;  // an SM (__launch_bounds__): at most 96 registers a thread
constexpr int kMaxDegree = 16;
static_assert(kOut >= 1 && kOut <= 4, "1 to 4 outputs");

// The program's three operations.
ZIGZ_HD uint32_t add(uint32_t a, uint32_t b) { return add_mod(a, b); }
ZIGZ_HD uint32_t sub(uint32_t a, uint32_t b) { return sub_mod(a, b); }
ZIGZ_HD uint32_t mul(uint32_t a, uint32_t b) { return mont_mul(a, b); }

// The point of index k among (0, 2, 3, .., degree), as t R^2 mod p.
ZIGZ_HD uint32_t point_r2(int k) {
  const uint64_t t = k == 0 ? 0u : static_cast<uint64_t>(k) + 1u;
  return static_cast<uint32_t>(t * kR2 % kP);
}

// Plane row r at one point, in Montgomery form.  Planes are canonical
// int64; the low word of each is read.
struct PointRows {
  const uint32_t* lo;  // the lane's word in row 0
  int64_t row_words;   // 2 * width
  int64_t hi_words;    // 2 * (width / 2); 0 at t = 0, where hi is lo and no other line is read
  uint32_t t_r2;
  ZIGZ_HD uint32_t operator()(int r) const {
    const uint32_t* p = lo + r * row_words;
    const uint32_t a = ZIGZ_DAG_LOAD(p);
    const uint32_t d = sub_mod(ZIGZ_DAG_LOAD(p + hi_words), a);
    return redc(static_cast<uint64_t>(a) * kR2 + static_cast<uint64_t>(d) * t_r2);
  }
};

// The generated program: out[o] of the lane-point that `row` reads, with
// the constant table c (Montgomery u32).
ZIGZ_DAG_BODY void body(const PointRows& row, const uint32_t* __restrict__ c, uint32_t* __restrict__ out);

struct Consts {
  uint32_t v[kConsts > 0 ? kConsts : 1];
};

// The launch's checks, shared by both entries: 0 or a reason.
inline int bad_launch(int64_t width, int degree, int eq_row, int n_consts) {
  if (n_consts != kConsts || degree < 1 || degree > kMaxDegree || width < 0) return 1;
  if (eq_row >= 0 && kOut != 1) return 1;
  return 0;
}

}  // namespace zigz_dag

#ifdef __CUDACC__

namespace {

using namespace zigz_dag;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
zigz_dag_round_sums_kernel(const int64_t* __restrict__ planes, int64_t width, int degree, int eq_row,
                           unsigned long long* __restrict__ sums, const __grid_constant__ Consts consts) {
  const int64_t half = width >> 1;
  const int k = static_cast<int>(blockIdx.x % static_cast<unsigned int>(degree));
  int64_t j = static_cast<int64_t>(blockIdx.x / static_cast<unsigned int>(degree)) * kThreads + threadIdx.x;
  const bool active = j < half;
  if (!active) j = half - 1;  // computes a valid lane and adds nothing
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(planes + j);
  const bool lead = (threadIdx.x & 31) == 0;
  const PointRows rows{lo, 2 * width, k == 0 ? 0 : 2 * half, point_r2(k)};
  uint32_t out[kOut];
  body(rows, consts.v, out);
  const uint32_t eq = eq_row >= 0 ? rows(eq_row) : 0u;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const uint32_t v = eq_row >= 0 ? mont_mul(out[o], eq) : out[o];
    const unsigned long long s = warp_sum(active ? v : 0ull);
    if (lead) atomicAdd(sums + k * kOut + o, s);
  }
}

}  // namespace

extern "C" {

// sums (degree, n_out) u64, zeroed here; consts a host array of n_consts
// Montgomery u32, copied into the launch's parameters.  Launches on
// `stream` without synchronising and returns the first CUDA error.
int zigz_dag_round_sums(const void* planes, int64_t width, int degree, int eq_row, const uint32_t* consts,
                        int n_consts, void* sums, void* stream) {
  if (bad_launch(width, degree, eq_row, n_consts)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * degree * kOut, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t half = width / 2;
  if (half < 1) return 0;
  Consts cs{};
  if (kConsts > 0) std::memcpy(cs.v, consts, sizeof(uint32_t) * kConsts);
  const int64_t tiles = (half + kThreads - 1) / kThreads;
  const int64_t blocks = tiles * degree;
  if (blocks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  zigz_dag_round_sums_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
      static_cast<const int64_t*>(planes), width, degree, eq_row, static_cast<unsigned long long*>(sums), cs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#else  // a host compiler: the CPU tests' entry

// lanes (degree, n_out, width / 2) Montgomery u32 of every lane-point, and
// sums (degree, n_out) u64 as the kernel adds them.  Returns 0, or 1 where
// the kernel's launcher would refuse the arguments.
extern "C" int zigz_dag_host(const int64_t* planes, int64_t width, int degree, int eq_row, const uint32_t* consts,
                             int n_consts, uint32_t* lanes, uint64_t* sums) {
  using namespace zigz_dag;
  if (bad_launch(width, degree, eq_row, n_consts)) return 1;
  const int64_t half = width / 2;
  for (int i = 0; i < degree * kOut; ++i) sums[i] = 0;
  for (int64_t j = 0; j < half; ++j) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(planes + j);
    for (int k = 0; k < degree; ++k) {
      const PointRows rows{lo, 2 * width, k == 0 ? 0 : 2 * half, point_r2(k)};
      uint32_t out[kOut];
      body(rows, consts, out);
      const uint32_t eq = eq_row >= 0 ? rows(eq_row) : 0u;
      for (int o = 0; o < kOut; ++o) {
        const uint32_t v = eq_row >= 0 ? mont_mul(out[o], eq) : out[o];
        lanes[(static_cast<int64_t>(k) * kOut + o) * half + j] = v;
        sums[k * kOut + o] += v;
      }
    }
  }
  return 0;
}

#endif  // __CUDACC__
