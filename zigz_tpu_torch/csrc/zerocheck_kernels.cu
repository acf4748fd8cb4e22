// The zerocheck round on the card, as two kernels bound to Python through
// ctypes:
//
// Z1 dag_round_sums_kernel: the round sums g(0), g(2..degree) of a traced
//    combiner DAG over the half-split plane stack.  Counterpart of the jitted
//    round of the JAX package: zigz_tpu/ops/symtrace.py:260 compile_device
//    with zigz_tpu/ops/zerocheck_dev_ext.py:113 _round_sums (and
//    zigz_tpu/ops/zerocheck_gen.py:302 _round_fn for the base field), which
//    XLA fuses into a few kernels.  No Pallas kernel: the TPU ran XLA's code.
// Z2 ext_fold_kernel: the fold of every table by one BabyBear^4 challenge r,
//    out = lo + r (hi - lo) with X^4 = 11, from either plane layout into the
//    all-extension one.  Counterpart of the fold half of _hybrid_step_fn and
//    _ext_step_fn (zigz_tpu/ops/ext4_dev.py:132 ext_fold_dev, :144
//    ext_fold_base_dev).
//
// Planes are (rows, width) int64 canonical values, as the port's torch ops
// keep them; only their low 32 bits are read.
//
// Z1 interprets a program (ops/symtrace.py compile_device): instructions
// (op, dst, a, b) of 4 int32, an operand being index << 2 | kind (a slot,
// a plane row, a constant).  One thread takes one lane j < width / 2 at one
// point t of (0, 2, .., degree) (blockIdx.y): a row operand is the column at
// t, lo + t (hi - lo) mod p, formed where it is read; slots hold Montgomery
// u32 values in dynamic shared memory, slot-major (slot * blockDim + tid: a
// warp's 32 accesses fall in 32 banks), and the block size is chosen by the
// wrapper so that the slots fit.  Every thread of the block runs the same
// instruction, so the program is staged through shared memory in chunks
// and read there as a broadcast.  Each output (times the eq row's value for
// a base-field DAG) is summed over the warp in u64 and added atomically to
// a (degree, n_out) u64 buffer that the launcher zeroes first: at most 2^21
// values below 2^31 sum below 2^52.  The sums stay in Montgomery form; the
// wrapper converts them once (the sum is linear).  What bounds it: the
// DAG's field operations, several thousand a lane-point for the largest
// program, and the interpreter's decode and shared-memory traffic around
// each; the planes' bytes are read once per point and are no limit.  Code
// generated for each DAG signature would drop the decode: later work.
//
// Z2 gives one thread per (lane j, output group g): a base row becomes the
// 4 coordinates (1 - r)_e lo + r_e hi; an extension table the schoolbook
// product, two canonical-times-Montgomery products per REDC.  It is bound by
// bytes: each input read once, each output written once.
//
// Each launcher takes device pointers, sizes and the CUDA stream, launches
// on that stream without synchronising, allocates nothing, and returns the
// first CUDA error so that a refused launch reaches the caller.
#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using zigz::add_mod;
using zigz::kP;
using zigz::kR2;
using zigz::mont_mul;
using zigz::redc;
using zigz::sub_mod;

constexpr int kChunk = 256;  // instructions staged in shared memory at a time
constexpr int kMaxOut = 4;
constexpr int kMaxThreads = 256;  // the wrapper's largest block
constexpr int kKindSlot = 0;
constexpr int kKindRow = 1;
constexpr int kOpAdd = 0;
constexpr int kOpMul = 2;
constexpr int kFoldThreads = 256;
constexpr int kGroupWords = 5;  // kind, s0, s1, s2, s3

struct Outs {
  int op[kMaxOut];
};

// The column at `p` (the lane's lo entry; hi lies `half` further) at point
// t, in Montgomery form: lo R + t (hi - lo) R, with t_r2 = t R^2 mod p.
__device__ __forceinline__ uint32_t point_value(const int64_t* __restrict__ p, int64_t half, uint32_t t_r2) {
  const uint32_t lo = static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(p)));
  const uint32_t lo_m = redc(static_cast<uint64_t>(lo) * kR2);
  if (t_r2 == 0) return lo_m;
  const uint32_t d = sub_mod(static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(p + half))), lo);
  return add_mod(lo_m, redc(static_cast<uint64_t>(d) * t_r2));
}

__global__ void __launch_bounds__(kMaxThreads)
dag_round_sums_kernel(const int64_t* __restrict__ planes, int64_t width, const int4* __restrict__ code,
                      int n_code, const uint32_t* __restrict__ consts, int n_consts, Outs outs, int n_out,
                      int eq_row, unsigned long long* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_code = reinterpret_cast<int4*>(smem);
  uint32_t* s_consts = reinterpret_cast<uint32_t*>(s_code + kChunk);
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  uint32_t* my = s_consts + n_consts + tid;  // slot s of this thread: my[s * bd]

  const int64_t half = width >> 1;
  int64_t j = static_cast<int64_t>(blockIdx.x) * bd + tid;
  const bool active = j < half;
  if (!active) j = half - 1;  // computes a valid lane and adds nothing
  const uint32_t t = blockIdx.y == 0 ? 0u : blockIdx.y + 1u;
  const uint32_t t_r2 = static_cast<uint32_t>((static_cast<uint64_t>(t) * kR2) % kP);
  const int64_t* col = planes + j;

  auto fetch = [&](int opd) -> uint32_t {
    const int idx = opd >> 2;
    const int kind = opd & 3;
    if (kind == kKindSlot) return my[idx * bd];
    if (kind == kKindRow) return point_value(col + static_cast<int64_t>(idx) * width, half, t_r2);
    return s_consts[idx];
  };

  for (int i = tid; i < n_consts; i += bd) s_consts[i] = __ldg(consts + i);
#pragma unroll 1
  for (int base = 0; base < n_code; base += kChunk) {
    const int m = min(kChunk, n_code - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < m; i += bd) s_code[i] = __ldg(code + base + i);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const int4 ins = s_code[k];
      const uint32_t x = fetch(ins.z);
      const uint32_t y = fetch(ins.w);
      uint32_t r;
      if (ins.x == kOpMul) {
        r = mont_mul(x, y);
      } else if (ins.x == kOpAdd) {
        r = add_mod(x, y);
      } else {
        r = sub_mod(x, y);
      }
      my[ins.y * bd] = r;
    }
  }
  __syncthreads();  // the constants, where no chunk ran

  const uint32_t eq = eq_row >= 0 ? point_value(col + static_cast<int64_t>(eq_row) * width, half, t_r2) : 0u;
  for (int o = 0; o < n_out; ++o) {
    uint32_t v = fetch(outs.op[o]);
    if (eq_row >= 0) v = mont_mul(v, eq);
    unsigned long long s = active ? v : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((tid & 31) == 0) atomicAdd(sums + blockIdx.y * n_out + o, s);
  }
}

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

// sums (degree, n_out) u64, zeroed here.  `outs` is a host array of n_out
// operands, `threads` the block size the wrapper chose for n_slots slots.
int zigz_dag_round_sums(const void* planes, int64_t width, const void* code, int n_code, const void* consts,
                        int n_consts, const int* outs, int n_out, int eq_row, int n_slots, int degree,
                        int threads, void* sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_out < 1 || n_out > kMaxOut || degree < 1 || threads < 32 || threads > kMaxThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * degree * n_out, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t half = width / 2;
  if (half < 1) return 0;
  Outs o{};
  for (int k = 0; k < n_out; ++k) o.op[k] = outs[k];
  const size_t smem = sizeof(int4) * kChunk + sizeof(uint32_t) * (static_cast<size_t>(n_consts)
                                                                   + static_cast<size_t>(n_slots) * threads);
  err = cudaFuncSetAttribute(dag_round_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((half + threads - 1) / threads), static_cast<unsigned int>(degree));
  dag_round_sums_kernel<<<grid, threads, smem, st>>>(
      static_cast<const int64_t*>(planes), width, static_cast<const int4*>(code), n_code,
      static_cast<const uint32_t*>(consts), n_consts, o, n_out, eq_row, static_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}

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
