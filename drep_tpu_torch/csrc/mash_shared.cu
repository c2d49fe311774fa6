// Union-bottom-s Mash shared counts per genome pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_mash.py::_mash_shared_kernel
// (:96; grids _mash_shared_grid :155, rectangular, and
// _mash_shared_grid_symmetric :177, the wrapped half-grid). For each pair
// of ascending PAD_ID-padded int32 id rows (A_i, B_j) it counts the ids
// present in BOTH rows among the bottom-s_use distinct ids of their union,
// s_use = min(|A_i|, |B_j|, s_orig) — bit-identical to
// ops/mash.py::mash_shared_plain (sort the concatenated pair, flag
// duplicates, cumsum the distinct rank, count).
//
// What bounds it here: operations, not bytes. The inputs are N rows of W
// ids (40 MB at N = 10 000, W = 1000) against N^2/2 pair walks of ~s_use
// to 2 s_use compare-and-advance steps each, with no tensor-core form. The
// TPU kernel's bitonic merge and lane prefix sum exist because the TPU has
// no cheap gathers; here a merge walk is O(s_use) a pair and stops once
// the distinct rank passes s_use. What held the walk back when one thread
// walked one pair: each lane streamed its own B row from L2, a
// serial chain of dependent loads, the warp split by its lanes' branches
// and uneven walk lengths, and too few warps at 2048 rows.
//
// Design: a warp-cooperative merge-path walk (merge_path.cuh) over rows
// staged in shared memory, or per-warp windows of rows too wide to stage
// (the block body, csrc/pair_block.cuh, shared with the ring step): each
// round of 32 x MASH_E merged ids splits evenly over the 32 lanes by a
// binary search on the merge path, each lane merges its share with selects
// from shared memory (~11 instructions an id), a warp scan gives each lane
// its starting distinct rank, and the warp stops after the round that
// passes s_use. Each staged row serves SUB pairs. What bounds it now
// (PERF.md): instruction issue and the latency of each step's dependent
// shared-memory load; the searches are about a third of a round's
// instructions. MASH_E and PAIR_WARPS were chosen on the card: 8 or 32
// ids a lane and 8 warps a block were slower (PERF.md).
//
// Layouts (`symmetric`), in output tiles of TILE x TILE pairs:
//   0  rectangular: A [rows_a, W], B [rows_b, W]; tile (i, j) of
//      out [rows_a, rows_b].
//   1  wrapped symmetric self-comparison: A == B, rows_a == rows_b = n,
//      t = n / TILE tiles, th = t / 2 + 1; tile column jj of tile row i
//      holds tile (i, (i + jj) % t) in out[i*TILE.., jj*TILE..] of
//      [n, th*TILE]. Shared counts are symmetric, so these t*th tiles cover
//      every unordered tile pair; the host unwraps and mirrors them.
// Each output tile is cut into (TILE / SUB)^2 blocks. Rows are padded to
// TILE multiples by the caller (PAD_ID rows, count 0).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pair_block.cuh"

#define TILE 128

struct MashArgs {
  const int32_t* a;
  const int32_t* na;
  const int32_t* b;
  const int32_t* nb;
  int32_t* out;
  int width, stride, s_orig, symmetric, n_tiles, out_cols, sub, grid_x, vec;
};

template <bool STAGED>
__global__ void __launch_bounds__(PAIR_WARPS * 32) mash_shared_kernel(MashArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int sub = p.sub;
  const int per_tile = TILE / sub;
  const int bx = blockIdx.x % p.grid_x, by = blockIdx.x / p.grid_x;
  const int i_tile = by / per_tile, jj = bx / per_tile;
  const int b_tile = p.symmetric ? (i_tile + jj) % p.n_tiles : jj;
  const int64_t a0 = (int64_t)i_tile * TILE + (by % per_tile) * sub;
  const int64_t b0 = (int64_t)b_tile * TILE + (bx % per_tile) * sub;
  const int64_t col0 = (int64_t)jj * TILE + (bx % per_tile) * sub;
  PairBlock blk;
  blk.a = p.a + a0 * p.width;
  blk.na = p.na + a0;
  blk.b = p.b + b0 * p.width;
  blk.nb = p.nb + b0;
  blk.out = p.out + a0 * p.out_cols + col0;
  blk.out_cols = p.out_cols;
  blk.valid_a = blk.valid_b = sub;  // rows are padded to TILE multiples
  blk.width = p.width;
  blk.stride = p.stride;
  blk.sub = sub;
  blk.vec = p.vec;
  blk.s_orig = p.s_orig;
  pair_block<KIND_MASH, STAGED>(blk, smem);
}

extern "C" int mash_shared_launch(const int32_t* a, const int32_t* na, const int32_t* b,
                                  const int32_t* nb, int32_t* out, int rows_a, int rows_b,
                                  int width, int s_orig, int symmetric, void* stream) {
  MashArgs p;
  p.a = a;
  p.na = na;
  p.b = b;
  p.nb = nb;
  p.out = out;
  p.width = width;
  p.stride = staged_pitch(width);
  p.s_orig = s_orig;
  p.symmetric = symmetric;
  p.vec = width % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  size_t smem;
  bool staged;
  pair_block_plan(width, &p.sub, &smem, &staged);
  const void* fn = staged ? (const void*)mash_shared_kernel<true> : (const void*)mash_shared_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ta = rows_a / TILE;
  const int tb = rows_b / TILE;
  const int per_tile = TILE / p.sub;
  p.n_tiles = ta;
  p.out_cols = symmetric ? (ta / 2 + 1) * TILE : rows_b;
  p.grid_x = (symmetric ? ta / 2 + 1 : tb) * per_tile;
  const int64_t blocks = (int64_t)p.grid_x * ta * per_tile;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    if (staged) {
      mash_shared_kernel<true><<<(int)blocks, PAIR_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
    } else {
      mash_shared_kernel<false><<<(int)blocks, PAIR_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
    }
  }
  return (int)cudaGetLastError();
}
