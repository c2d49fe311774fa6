// Merge-intersect counts per pair of sorted id rows, summed over stacked
// id-range buckets, for Hopper (sm_90a).
//
// Replaces both TPU kernels of drep_tpu/ops/pallas_merge.py:
//   _intersect_kernel          (grids _intersect_grid, _intersect_grid_symmetric)
//                              — here n_buckets == 1;
//   _intersect_kernel_stacked  (grids _intersect_grid_rect_stacked,
//                              _intersect_grid_symmetric_stacked) — n_buckets >= 1.
// For each pair (A_i, B_j) it returns
//   Σ_r  #{ adjacent equal non-PAD elements of sort(A_r,i ++ B_r,j) }
// the JAX definition (roll, compare, mask PAD, sum). For rows of distinct
// ids that is |A_i ∩ B_j|; a run of p copies in A and q in B counts p+q-1.
// Bit-identical to ops/intersect.py::intersect_stacked_plain.
//
// What bounds it here: operations. Each pair and bucket is a walk of
// cnt_a + cnt_b compare-and-advance steps (data-dependent branches, no
// tensor-core form); the inputs are read once from device memory and then
// re-read from L1/L2 once per pair. The TPU kernel merges a reversed A row
// into 128 B rows with a bitonic roll/min/max network — O(W log W) per pair,
// because the TPU has no cheap data-dependent loads. On Hopper a two-pointer
// walk costs O(cnt_a + cnt_b) and stops at the first PAD, so padding is free
// and the cost per pair does not depend on the vocabulary.
//
// Design: one thread per pair. A block of TILE x GROUPS threads covers
// GROUPS A rows against the TILE B rows of one B tile: thread (c, g) owns
// B row c of the tile and A row g of the block. For each bucket the group
// stages its A row in shared memory (coalesced, followed by one PAD_ID so
// the walk needs no bound check on A), then every thread merges it against
// its B row, which it streams through a 16-byte register window (one
// vector load per four B steps, read through L1). The count stays in a
// register across buckets: one store per pair, no read-modify-write of the
// output.
//
// Layouts (`symmetric`):
//   0  rectangular: A [R, rows_a, W], B [R, rows_b, W]; block (bx, by, bz)
//      computes rows by*TILE + bz*GROUPS.. of tile (by, bx) into
//      out [rows_a, rows_b].
//   1  wrapped symmetric self-comparison: A == B, rows_a == rows_b = n,
//      t = n / TILE, th = t / 2 + 1; block (jj, i, bz) computes its rows of
//      tile (i, (i + jj) % t) into out[i*TILE.., jj*TILE..] of [n, th*TILE].
//      For even t the last column covers its tile pairs twice; the host
//      unwrap writes both copies (equal: the counts are symmetric).
// Rows are padded to TILE multiples by the caller (PAD_ID rows); W is a
// multiple of 4 and every row starts 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128
#define GROUPS 8
#define PAD_ID 0x7FFFFFFF

__device__ __forceinline__ int lane_of(int4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// adjacent equal non-PAD elements in the merge of two ascending rows;
// a_sh holds PAD_ID at a_sh[width]
__device__ __forceinline__ int merge_dups(const int32_t* a_sh, const int32_t* __restrict__ brow,
                                          int width) {
  int i = 0, j = 0;
  int va = a_sh[0];
  int4 win = __ldg(reinterpret_cast<const int4*>(brow));
  int vb = win.x;
  int prev = ~(va < vb ? va : vb);  // never equals the first merged element
  int dups = 0;
  while (true) {
    const bool take_a = va <= vb;
    const int v = take_a ? va : vb;
    if (v == PAD_ID) break;  // both rows exhausted: PAD sorts last
    dups += v == prev;
    prev = v;
    if (take_a) {
      va = a_sh[++i];  // stops at the first PAD: past it take_a means v == PAD
    } else {
      ++j;  // vb was real, so j <= width
      if ((j & 3) == 0) {
        win = j < width ? __ldg(reinterpret_cast<const int4*>(brow + j))
                        : make_int4(PAD_ID, PAD_ID, PAD_ID, PAD_ID);
      }
      vb = lane_of(win, j & 3);
    }
  }
  return dups;
}

__global__ void __launch_bounds__(TILE * GROUPS)
intersect_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int n_buckets, int rows_a, int rows_b,
                 int width, int symmetric, int n_tiles, int out_cols) {
  extern __shared__ int32_t a_rows[];
  const int tid = threadIdx.x;
  const int g = threadIdx.y;
  const int b_tile = symmetric ? (blockIdx.y + blockIdx.x) % n_tiles : blockIdx.x;
  const int64_t a_row = (int64_t)blockIdx.y * TILE + blockIdx.z * GROUPS + g;
  const int64_t b_row = (int64_t)b_tile * TILE + tid;
  const int64_t a_plane = (int64_t)rows_a * width;
  const int64_t b_plane = (int64_t)rows_b * width;
  int32_t* my_a = a_rows + g * (width + 1);

  int count = 0;
  for (int r = 0; r < n_buckets; ++r) {
    const int32_t* arow = a + r * a_plane + a_row * width;
    __syncthreads();  // the previous bucket's walks are done with my_a
    for (int c = tid; c < width; c += TILE) my_a[c] = arow[c];
    if (tid == 0) my_a[width] = PAD_ID;
    __syncthreads();
    count += merge_dups(my_a, b + r * b_plane + b_row * width, width);
  }
  out[a_row * out_cols + (int64_t)blockIdx.x * TILE + tid] = count;
}

extern "C" int intersect_launch(const int32_t* a, const int32_t* b, int32_t* out,
                                int n_buckets, int rows_a, int rows_b, int width,
                                int symmetric, void* stream) {
  const size_t smem = (size_t)GROUPS * (width + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ta = rows_a / TILE;
  const int tb = rows_b / TILE;
  dim3 grid;
  int out_cols;
  if (symmetric) {
    const int th = ta / 2 + 1;
    grid = dim3(th, ta, TILE / GROUPS);
    out_cols = th * TILE;
  } else {
    grid = dim3(tb, ta, TILE / GROUPS);
    out_cols = rows_b;
  }
  if (ta > 0 && tb > 0 && n_buckets > 0 && width > 0) {
    intersect_kernel<<<grid, dim3(TILE, GROUPS), smem, (cudaStream_t)stream>>>(
        a, b, out, n_buckets, rows_a, rows_b, width, symmetric, ta, out_cols);
  }
  return (int)cudaGetLastError();
}
