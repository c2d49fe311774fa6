// Merge-intersect counts per pair of sorted id rows, summed over stacked
// id-range buckets, for Hopper (sm_90a).
//
// Replaces both TPU kernels of drep_tpu/ops/pallas_merge.py:
//   _intersect_kernel          (:79; grids _intersect_grid :149,
//                              _intersect_grid_symmetric :183) — here
//                              n_buckets == 1;
//   _intersect_kernel_stacked  (:102; grids _intersect_grid_rect_stacked
//                              :231, _intersect_grid_symmetric_stacked
//                              :251) — n_buckets >= 1.
// For each pair (A_i, B_j) it returns
//   Σ_r  #{ adjacent equal non-PAD elements of sort(A_r,i ++ B_r,j) }
// the JAX definition (roll, compare, mask PAD, sum). For rows of distinct
// ids that is |A_i ∩ B_j|; a run of p copies in A and q in B counts p+q-1.
// Bit-identical to ops/intersect.py::intersect_stacked_plain.
//
// What bounds it here: operations. Each pair and bucket is a merge of
// cnt_a + cnt_b compare-and-advance steps with no tensor-core form; the
// inputs are read once from device memory. The TPU kernel merges a
// reversed A row into 128 B rows with a bitonic roll/min/max network —
// O(W log W) a pair, because the TPU has no cheap data-dependent loads.
// Here a merge costs O(cnt_a + cnt_b) and skips the padding. What held it
// back when one thread walked one pair: each lane streamed its
// own B row from L1/L2 (32 lines a load instruction), the 16 blocks of a
// tile each re-read its B rows, and a warp waited for its longest walk.
//
// Design: a warp-cooperative merge-path walk (merge_path.cuh). A block
// stages SUB A rows and SUB B rows of one output tile for one bucket in
// shared memory with 16-byte loads (at W = 2048, SUB = 4: 64 KB; 16 warps
// a block, three blocks an SM), finds each row's real length by a binary
// search, and its ISECT_WARPS warps take the SUB x SUB pairs, one warp a
// pair: the pair's cnt_a + cnt_b merged ids split into 32 equal shares by
// a binary search on the merge path, each lane merges its share with
// selects from shared memory (~11 instructions an id), and the count of
// adjacent equal ids, with the lane boundaries joined by a shuffle, is
// summed over the warp. The pair counts add up over the buckets in shared
// memory: one store a pair. What bounds it now (PERF.md):
// instruction issue and the latency of each step's dependent
// shared-memory load, and the three barriers a bucket; 8 warps a block
// were slower.
//
// Layouts (`symmetric`), in output tiles of TILE x TILE pairs:
//   0  rectangular: A [R, rows_a, W], B [R, rows_b, W]; tile (i, j) of
//      out [rows_a, rows_b].
//   1  wrapped symmetric self-comparison: A == B, rows_a == rows_b = n,
//      t = n / TILE, th = t / 2 + 1; tile column jj of tile row i holds
//      tile (i, (i + jj) % t) in out[i*TILE.., jj*TILE..] of [n, th*TILE].
//      For even t the last column covers its tile pairs twice; the host
//      unwrap writes both copies (equal: the counts are symmetric).
// Each output tile is cut into (TILE / SUB)^2 blocks. Rows are padded to
// TILE multiples by the caller (PAD_ID rows); W is a multiple of 4 and
// every row starts 16-byte aligned.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "merge_path.cuh"

#define TILE 128
#define ISECT_WARPS 16
#define STAGE_BYTES (96 * 1024)  // a block's staged rows: two or more blocks an SM
#define MAX_SUB 16
#define HEAD_INTS (2 * MAX_SUB + MAX_SUB * MAX_SUB)  // row lengths, then pair counts
#define MAX_SMEM 232448  // the shared memory a block may opt in to

struct IsectArgs {
  const int32_t* a;
  const int32_t* b;
  int32_t* out;
  int n_buckets, rows_a, rows_b, width, stride, symmetric, n_tiles, out_cols, sub, grid_x;
};

__global__ void __launch_bounds__(ISECT_WARPS * 32) intersect_kernel(IsectArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  int* lens = smem;                 // [2 sub]: real ids of the A rows, then B rows
  int* counts = smem + 2 * MAX_SUB;  // [sub * sub]
  int32_t* rows = smem + HEAD_INTS;
  const int sub = p.sub;
  const int per_tile = TILE / sub;
  const int bx = blockIdx.x % p.grid_x, by = blockIdx.x / p.grid_x;
  const int i_tile = by / per_tile, jj = bx / per_tile;
  const int b_tile = p.symmetric ? (i_tile + jj) % p.n_tiles : jj;
  const int64_t a0 = (int64_t)i_tile * TILE + (by % per_tile) * sub;
  const int64_t b0 = (int64_t)b_tile * TILE + (bx % per_tile) * sub;
  const int64_t col0 = (int64_t)jj * TILE + (bx % per_tile) * sub;
  const int width = p.width;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int32_t* b_rows = rows + (int64_t)sub * p.stride;

  for (int q = tid; q < sub * sub; q += blockDim.x) counts[q] = 0;
  for (int r = 0; r < p.n_buckets; ++r) {
    __syncthreads();  // the last bucket's walks are done with the rows
    stage_rows(rows, p.a + ((int64_t)r * p.rows_a + a0) * width, sub, width, p.stride, true);
    stage_rows(b_rows, p.b + ((int64_t)r * p.rows_b + b0) * width, sub, width, p.stride, true);
    __syncthreads();
    if (tid < 2 * sub) lens[tid] = real_len(rows + (int64_t)tid * p.stride, width);
    __syncthreads();
    for (int pq = warp; pq < sub * sub; pq += ISECT_WARPS) {
      const int ra = pq / sub, cb = pq - (pq / sub) * sub;
      const int dups = warp_merge_dups(shared_addr(rows + ra * p.stride), lens[ra],
                                       shared_addr(b_rows + cb * p.stride), lens[sub + cb], lane);
      if (lane == 0) counts[pq] += dups;  // one warp owns each pair
    }
  }
  __syncthreads();
  for (int q = tid; q < sub * sub; q += blockDim.x) {
    const int ra = q / sub, cb = q - (q / sub) * sub;
    p.out[(a0 + ra) * p.out_cols + col0 + cb] = counts[q];
  }
}

// The rows of A (and of B) a block stages for rows of `width` ids — the
// most that fit in STAGE_BYTES, or one of each in all a block may have —
// and its dynamic shared memory.
static void plan(int width, int* sub, size_t* smem) {
  const int stride = staged_pitch(width);
  int s = MAX_SUB;
  while (s > 1 && (size_t)2 * s * stride * 4 + HEAD_INTS * 4 > STAGE_BYTES) s >>= 1;
  *sub = s;
  *smem = HEAD_INTS * 4 + (size_t)2 * s * stride * 4;
}

extern "C" int intersect_launch(const int32_t* a, const int32_t* b, int32_t* out,
                                int n_buckets, int rows_a, int rows_b, int width,
                                int symmetric, void* stream) {
  IsectArgs p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.n_buckets = n_buckets;
  p.rows_a = rows_a;
  p.rows_b = rows_b;
  p.width = width;
  p.stride = staged_pitch(width);
  p.symmetric = symmetric;
  size_t smem;
  plan(width, &p.sub, &smem);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ta = rows_a / TILE;
  const int tb = rows_b / TILE;
  const int per_tile = TILE / p.sub;
  p.n_tiles = ta;
  p.out_cols = symmetric ? (ta / 2 + 1) * TILE : rows_b;
  p.grid_x = (symmetric ? ta / 2 + 1 : tb) * per_tile;
  const int64_t blocks = (int64_t)p.grid_x * ta * per_tile;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0 && n_buckets > 0 && width > 0) {
    intersect_kernel<<<(int)blocks, ISECT_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
