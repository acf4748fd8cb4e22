// The Reed-Solomon row encode of the Ligero commitments, (R, n) -> (R, n_out)
// canonical u32 over BabyBear, as two kernels bound to Python through ctypes
// (ops/ntt_dev.py encode_rows), over the blocks and register passes of
// ntt.cuh:
//
// N1 ntt_tile_kernel<LOG_R, FX>: one block a (row, tile of kTile
//   consecutive outputs), rows x tiles on grid.x, 256 threads at a full
//   tile.  Each thread gathers its 32 values of the row with the skip
//   rule's broadcast (mat[br_n(j / k)]) and runs the first 5 stages on them
//   in registers; each later register pass reads 32 values from shared
//   memory, runs up to 5 stages and writes them back (the last, to the
//   output): stages log2(k) .. 12 in 2 passes and 1 barrier at k = 8.  When
//   n_out <= kTile the whole encode is this one launch.
// N2 ntt_pass_kernel<LOG_R, FX>: one launch a pass of up to kMaxPassStages
//   global stages [first, end), in place on the output.  A block takes 32
//   consecutive positions l (mod 2^first) of one row and the 2^(end - first)
//   values l + j 2^first of each, a column that no other block touches:
//   every stage of the pass acts inside such columns.  Its threads read 16
//   values of one l each, a warp 32 neighbouring words (128 B) a load, and
//   run the pass's stages in register passes through shared memory as N1's
//   do.  One pass at the main shapes (6 or 7 global stages), two from n_out
//   = 2^22 (9 global stages: 5 + 4) to 2^27 (7 + 7).
// FX fixes the block's shape at compile time for the main path's blocks
// (ntt.cuh TileK8, PassG6, PassG7; Generic otherwise), so that every window,
// address offset and twiddle offset of a pass is a constant; LOG_R < 4 only
// for blocks smaller than a thread's values.
//
// What it replaces: zigz_tpu/ops/ntt_dev.py:107 _encode_jit, the four-step
// NTT in jitted jnp over Montgomery lanes (no pl.pallas_call), behind
// :124 encode_rows_device; in the port, 234 int64 torch-op launches for one
// 544-row block at n_out = 2^19 (the plain version, _encode_rows_plain).
//
// What bounds each kernel, and what the design does about it.  A 544-row
// block at 2^16 -> 2^19 has 16 live stages of 2^18 butterflies a row,
// 2.28e9 butterflies, each a Montgomery product, an add and a sub mod p, 14
// instructions issued; 0.14 GB of coefficients read, 1.14 GB written.
// N1 (10 of the 16 stages, 1.43e9 butterflies, writes the 1.14 GB once) is
// bound by operations: so a thread keeps its 32 values in registers across
// 5 stages, loads the 2^d twiddles of register bit d once for its 2^(5 -
// d - 1) butterflies of it (31 loads for 80 butterflies, issued with the
// values), gathers straight into registers (no broadcast sweep), meets the
// block at a barrier once between its 2 passes, and addresses every slot,
// twiddle and word of shared memory as a pointer plus a constant; at most
// 80 registers (3 blocks an SM), so that the barrier and loads of one
// block overlap the others' butterflies.  N2 (the 6 global stages, 0.86e9 butterflies,
// reading and writing the 1.14 GB) is bound by bytes: so all of a block's
// global stages run in one read and one write of the block (one launch,
// not one a stage), its loads and stores are whole 128-byte lines, and its
// twiddles of stage s (index pos mod 2^s, consecutive over l) are whole
// lines too.  Shared memory is at most 32 KiB a block (kTile words; 32 x
// 2^8 words), under the 48 KiB a launch takes without an attribute, so no
// attribute is set.
//
// Each launcher (zigz_ntt_tile: N1; zigz_ntt_pass: one pass of N2; the
// wrapper calls N1's once and N2's for each pass of zigz_ntt_passes) takes
// device pointers, the shape and the CUDA stream, launches on that stream
// without synchronising, allocates nothing, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or pass it refuses.
#include <cstdint>

#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

// Threads of the largest block of each kernel: a full tile (256), N2's
// widest pass (512).
constexpr int kMaxTileThreads = 1 << (zigz_ntt::kLogTile - zigz_ntt::kTileLogRadix);
constexpr int kMaxPassThreads = 1 << (zigz_ntt::kLogColumns + zigz_ntt::kMaxPassStages - zigz_ntt::kPassLogRadix);
constexpr int64_t kMaxBlocksX = 2147483647;                                    // gridDim.x limit
// Blocks an SM each kernel is built for (__launch_bounds__), which caps its
// registers: N1 3 x 256 threads at 80, N2 2 x 512 at 64.
constexpr int kTileMinBlocks = 3;
constexpr int kPassMinBlocks = 2;
// The largest block's dynamic shared memory stays under the 48 KiB a launch
// takes without cudaFuncSetAttribute (the head of this file).
static_assert((sizeof(uint32_t) << zigz_ntt::kLogTile) <= 48 * 1024 &&
                  (sizeof(uint32_t) << (zigz_ntt::kLogColumns + zigz_ntt::kMaxPassStages)) <= 48 * 1024,
              "a block's shared memory needs cudaFuncSetAttribute");

using zigz_ntt::Block;
using zigz_ntt::Plan;

// Every register pass of block b, a barrier between two passes; with a
// fixed shape the passes are unrolled, each with its own constants.
template <int LOG_R, zigz_ntt::Where FIRST, class FX>
__device__ __forceinline__ void run_block(const Block& block, const uint32_t* row_in, uint32_t* row,
                                          const uint32_t* tw) {
  extern __shared__ uint32_t block_values[];  // 2^bits words when the block runs two passes or more
  const Block b = FX::apply(block);
  const int passes = zigz_ntt::block_passes(b, LOG_R);
  if (FX::kFixed) {
#pragma unroll
    for (int pass = 0; pass < passes; ++pass) {
      if (pass) __syncthreads();
      zigz_ntt::block_thread_pass<LOG_R, FIRST>(b, pass, passes, threadIdx.x, row_in, row, block_values, tw);
    }
  } else {
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      if (pass) __syncthreads();
      zigz_ntt::block_thread_pass<LOG_R, FIRST>(b, pass, passes, threadIdx.x, row_in, row, block_values, tw);
    }
  }
}

template <int LOG_R, class FX>
__global__ void __launch_bounds__(kMaxTileThreads, kTileMinBlocks)
ntt_tile_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ tw, uint32_t* __restrict__ out,
                Plan p) {
  const int64_t row = blockIdx.x / p.tiles;
  const int64_t t = blockIdx.x - row * p.tiles;
  run_block<LOG_R, zigz_ntt::kGather, FX>(zigz_ntt::tile_block(p, t), in + (row << p.log_n),
                                          out + (row << p.log_out), tw);
}

template <int LOG_R, class FX>
__global__ void __launch_bounds__(kMaxPassThreads, kPassMinBlocks)
ntt_pass_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw, int log_out, int first, int end,
                int64_t blocks_a_row) {
  const int64_t row = blockIdx.x / blocks_a_row;
  const int64_t r = blockIdx.x - row * blocks_a_row;
  run_block<LOG_R, zigz_ntt::kRow, FX>(zigz_ntt::pass_block(first, end, r), nullptr, x + (row << log_out), tw);
}

// Launch shape of block b at LOG_R: threads, and dynamic shared memory
// (none for a block of one pass).
template <int LOG_R>
dim3 threads_of(const Block& b) { return dim3(static_cast<unsigned int>(zigz_ntt::block_threads(b, LOG_R))); }

template <int LOG_R>
size_t smem_of(const Block& b) {
  return zigz_ntt::block_passes(b, LOG_R) > 1 ? sizeof(uint32_t) << b.bits : 0;
}

struct TileLaunch {
  const Block& b;
  unsigned int blocks;
  cudaStream_t stream;
  const uint32_t* in;
  const uint32_t* tw;
  uint32_t* out;
  const Plan& p;

  template <int LOG_R, class FX>
  void run() {
    ntt_tile_kernel<LOG_R, FX><<<blocks, threads_of<LOG_R>(b), smem_of<LOG_R>(b), stream>>>(in, tw, out, p);
  }
};

struct PassLaunch {
  const Block& b;
  unsigned int blocks;
  cudaStream_t stream;
  uint32_t* x;
  const uint32_t* tw;
  int log_out, first, end;
  int64_t blocks_a_row;

  template <int LOG_R, class FX>
  void run() {
    ntt_pass_kernel<LOG_R, FX><<<blocks, threads_of<LOG_R>(b), smem_of<LOG_R>(b), stream>>>(
        x, tw, log_out, first, end, blocks_a_row);
  }
};

}  // namespace

extern "C" {

// N1 on (rows, n) -> (rows, n_out): the stages inside each tile.
int zigz_ntt_tile(const void* in, const void* tw, void* out, int64_t rows, int64_t n, int64_t n_out, void* stream) {
  Plan p;
  if (zigz_ntt::make_plan(rows, n, n_out, zigz_ntt::kTile, zigz_ntt::kMaxPassStages, kMaxBlocksX, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Block b = zigz_ntt::tile_block(p, 0);
  TileLaunch f{b, static_cast<unsigned int>(rows * p.tiles), static_cast<cudaStream_t>(stream),
               static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(tw), static_cast<uint32_t*>(out), p};
  zigz_ntt::with_instance<true>(b, f);
  return static_cast<int>(cudaGetLastError());
}

// N2: the global stages [first, end) of every row of the (rows, n_out)
// output, in place, one launch; at most kMaxPassStages of them.
int zigz_ntt_pass(void* x, const void* tw, int64_t rows, int64_t n_out, int64_t first, int64_t end, void* stream) {
  Plan p;
  if (zigz_ntt::make_plan(rows, 1, n_out, zigz_ntt::kTile, zigz_ntt::kMaxPassStages, kMaxBlocksX, &p) ||
      first < 0 || end <= first || end > p.log_out || end - first > zigz_ntt::kMaxPassStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks_a_row =
      zigz_ntt::pass_blocks_a_row(p.log_out, static_cast<int>(first), static_cast<int>(end));
  if (rows > kMaxBlocksX / blocks_a_row) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const Block b = zigz_ntt::pass_block(static_cast<int>(first), static_cast<int>(end), 0);
  PassLaunch f{b, static_cast<unsigned int>(rows * blocks_a_row), static_cast<cudaStream_t>(stream),
               static_cast<uint32_t*>(x), static_cast<const uint32_t*>(tw), static_cast<int>(p.log_out),
               static_cast<int>(first), static_cast<int>(end), blocks_a_row};
  zigz_ntt::with_instance<false>(b, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
