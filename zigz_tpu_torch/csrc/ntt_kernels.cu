// The Reed-Solomon row encode of the Ligero commitments, (R, n) -> (R, n_out)
// canonical u32 over BabyBear, as two kernels bound to Python through ctypes
// (ops/ntt_dev.py encode_rows), over the steps of ntt.cuh:
//
// N1 ntt_tile_kernel: one block a (row, tile of kTile consecutive outputs),
//   rows x tiles on grid.x.  The block gathers the tile's kTile / k values of
//   the row (one when k >= kTile), broadcasts each over its k positions in
//   shared memory, runs stages log2(k) .. log2(kTile) - 1 there with a
//   __syncthreads between stages, and writes its outputs.  When n_out <=
//   kTile the whole encode is this one launch.
// N2 ntt_stage_kernel: one global radix-2 stage in place on the output, one
//   thread a butterfly, one launch a stage, for the stages max(log2 kTile,
//   log2 k) .. log2(n_out) - 1.
//
// What it replaces: zigz_tpu/ops/ntt_dev.py:107 _encode_jit, the four-step
// NTT in jitted jnp over Montgomery lanes (no pl.pallas_call), behind
// :124 encode_rows_device; in the port, 234 int64 torch-op launches for one
// 544-row block at n_out = 2^19 (the plain version, _encode_rows_plain).
//
// What bounds it: operations.  A 544-row block at 2^16 -> 2^19 has 16 live
// stages of 2^18 butterflies a row, 2.28e9 butterflies, each a Montgomery
// product, an add and a sub mod p and its indexing, against 0.14 GB read and
// 1.14 GB written.  What the design does: values stay canonical u32 (the
// twiddles are in Montgomery form, one REDC a product), the first log2(k)
// stages are never run, and 13 stages run in shared memory.  Each of the
// global stages reads and writes the whole output once more: merging them
// (radix-4/8 strided tiles) and fusing the encode into the column sponges
// are later work.
//
// Each launcher (zigz_ntt_tile: N1; zigz_ntt_stage: one stage of N2; the
// wrapper calls N1's once and N2's for each of its stages) takes device
// pointers, the shape and the CUDA stream, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or stage it refuses.
#include <cstdint>

#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

constexpr int kTileThreads = 512;   // 8 butterflies a thread a stage of a full tile
constexpr int kStageThreads = 256;
constexpr int64_t kMaxBlocksX = 2147483647;  // gridDim.x limit

using zigz_ntt::Plan;

__global__ void __launch_bounds__(kTileThreads)
ntt_tile_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ tw, uint32_t* __restrict__ out,
                Plan p) {
  __shared__ uint32_t tile_x[zigz_ntt::kTile];
  const int64_t row = blockIdx.x / p.tiles;
  const int64_t t = blockIdx.x - row * p.tiles;
  const int t_len = 1 << p.log_tile;
  const int log_head = zigz_ntt::log_head(p);
  const uint32_t* row_in = in + (row << p.log_n);
  for (int m = threadIdx.x; m < (t_len >> log_head); m += blockDim.x) zigz_ntt::tile_gather(row_in, tile_x, t, m, p);
  __syncthreads();
  if (log_head) {
    for (int j = threadIdx.x; j < t_len; j += blockDim.x) zigz_ntt::tile_fill(tile_x, j, p);
    __syncthreads();
  }
  for (int s = log_head; s < p.log_tile; ++s) {
    for (int q = threadIdx.x; q < t_len / 2; q += blockDim.x) zigz_ntt::butterfly(tile_x, tw, q, s);
    __syncthreads();
  }
  uint32_t* tile_out = out + (row << p.log_out) + (t << p.log_tile);
  for (int j = threadIdx.x; j < t_len; j += blockDim.x) tile_out[j] = tile_x[j];
}

__global__ void __launch_bounds__(kStageThreads)
ntt_stage_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw, int64_t butterflies, int log_out,
                 int s) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kStageThreads + threadIdx.x;
  if (b >= butterflies) return;  // ragged tail of the last block
  const int64_t row = b >> (log_out - 1);
  zigz_ntt::butterfly(x + (row << log_out), tw, static_cast<uint32_t>(b & ((int64_t{1} << (log_out - 1)) - 1)), s);
}

}  // namespace

extern "C" {

// N1 on (rows, n) -> (rows, n_out): the stages inside each tile.
int zigz_ntt_tile(const void* in, const void* tw, void* out, int64_t rows, int64_t n, int64_t n_out, void* stream) {
  Plan p;
  if (zigz_ntt::make_plan(rows, n, n_out, zigz_ntt::kTile, kMaxBlocksX, kStageThreads, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int half_tile = 1 << (p.log_tile - 1);
  const int threads = half_tile < kTileThreads ? (half_tile < 32 ? 32 : half_tile) : kTileThreads;
  ntt_tile_kernel<<<static_cast<unsigned int>(rows * p.tiles), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(tw), static_cast<uint32_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// N2: stage ``stage`` of every row of the (rows, n_out) output, in place.
int zigz_ntt_stage(void* x, const void* tw, int64_t rows, int64_t n_out, int64_t stage, void* stream) {
  Plan p;
  if (zigz_ntt::make_plan(rows, 1, n_out, zigz_ntt::kTile, kMaxBlocksX, kStageThreads, &p) || stage < 0 ||
      stage >= p.log_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int64_t butterflies = rows * (n_out / 2);
  const auto blocks = static_cast<unsigned int>((butterflies + kStageThreads - 1) / kStageThreads);
  ntt_stage_kernel<<<blocks, kStageThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(tw), butterflies, p.log_out, static_cast<int>(stage));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
