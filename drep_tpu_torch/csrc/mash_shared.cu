// Union-bottom-s Mash shared counts per genome pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_mash.py::_mash_shared_kernel
// (grids _mash_shared_grid, rectangular, and _mash_shared_grid_symmetric,
// the wrapped half-grid). For each pair of ascending PAD_ID-padded int32
// id rows (A_i, B_j) it counts the ids present in BOTH rows among the
// bottom-s_use distinct ids of their union, s_use = min(|A_i|, |B_j|,
// s_orig) — bit-identical to ops/mash.py::mash_shared_plain (sort the
// concatenated pair, flag duplicates, cumsum the distinct rank, count).
//
// What bounds it here: operations, not bytes. The inputs are N rows of
// W ids (40 MB at N = 10 000, W = 1000) against N^2/2 pair walks of up to
// ~2 s_use compare-and-advance steps each; the steps are data-dependent
// branches with no tensor-core form. The TPU kernel's bitonic merge and
// lane prefix sum exist because the TPU has no cheap gathers; on Hopper a
// two-pointer walk is O(s_use) per pair instead of O(W log W), and it
// stops as soon as the distinct rank passes s_use.
//
// Design: one block per (A tile x B tile) of TILE x TILE pairs, TILE
// threads, thread c owns B row c of the tile. The block walks the A tile
// one row at a time: the row is staged in shared memory (coalesced), then
// every thread merges it against its own B row (merge_walk.cuh), read
// through L1 (each thread streams its row sequentially, so the active
// lines are few and cached). The output row of TILE counts is written
// coalesced.
//
// Layouts (`symmetric`):
//   0  rectangular: A [rows_a, W], B [rows_b, W]; block (bx, by) computes
//      tile (by, bx); out [rows_a, rows_b].
//   1  wrapped symmetric self-comparison: A == B, rows_a == rows_b = n,
//      t = n / TILE tiles, th = t / 2 + 1; block (jj, i) computes tile
//      (i, (i + jj) % t) into out[i*TILE.., jj*TILE..] of [n, th*TILE].
//      Shared counts are symmetric, so these t*th tiles cover every
//      unordered tile pair; the host unwraps and mirrors them.
// Rows are padded to TILE multiples by the caller (PAD_ID rows, count 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_walk.cuh"

#define TILE 128

__global__ void mash_shared_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ na,
                                   const int32_t* __restrict__ b, const int32_t* __restrict__ nb,
                                   int32_t* __restrict__ out, int width, int s_orig,
                                   int symmetric, int n_tiles, int out_cols) {
  extern __shared__ int32_t a_row[];
  const int tid = threadIdx.x;
  const int a_tile = blockIdx.y;
  const int b_tile = symmetric ? (blockIdx.y + blockIdx.x) % n_tiles : blockIdx.x;
  const int out_col0 = blockIdx.x * TILE;
  const int64_t b_row = (int64_t)b_tile * TILE + tid;
  const int32_t* __restrict__ brow = b + b_row * width;
  const int nb_j = nb[b_row];

  for (int r = 0; r < TILE; ++r) {
    const int64_t a_row_idx = (int64_t)a_tile * TILE + r;
    const int32_t* __restrict__ arow = a + a_row_idx * width;
    __syncthreads();  // the previous row's walks are done with a_row
    for (int c = tid; c < width; c += TILE) a_row[c] = arow[c];
    __syncthreads();

    const int na_i = na[a_row_idx];
    int s_use = na_i < nb_j ? na_i : nb_j;
    s_use = s_use < s_orig ? s_use : s_orig;
    const int shared = s_use > 0 ? mash_shared_walk(a_row, brow, width, s_use) : 0;
    out[a_row_idx * (int64_t)out_cols + out_col0 + tid] = shared;
  }
}

extern "C" int mash_shared_launch(const int32_t* a, const int32_t* na, const int32_t* b,
                                  const int32_t* nb, int32_t* out, int rows_a, int rows_b,
                                  int width, int s_orig, int symmetric, void* stream) {
  const size_t smem = (size_t)width * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      mash_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ta = rows_a / TILE;
  const int tb = rows_b / TILE;
  dim3 grid;
  int out_cols;
  if (symmetric) {
    const int th = ta / 2 + 1;
    grid = dim3(th, ta);
    out_cols = th * TILE;
  } else {
    grid = dim3(tb, ta);
    out_cols = rows_b;
  }
  if (ta > 0 && tb > 0) {
    mash_shared_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
        a, na, b, nb, out, width, s_orig, symmetric, ta, out_cols);
  }
  return (int)cudaGetLastError();
}
