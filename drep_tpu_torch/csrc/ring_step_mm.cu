// One step of the dense all-pairs ring, fused with the rotation of its B
// operand, by an indicator product on the int8 tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_ring.py::_fused_step_kernel,
// indicator-matmul variant (its _matmul_intersection_tile and
// _scatter_indicator_chunk; launched from fused_ring_step_fn with
// variant="matmul"). A position of the ring holds an A block and the
// current B block, each n_local ascending PAD_ID-padded int32 rows of
// `width` dense ranks (a scaled pack's ids, all >= 0). One launch
//   1. copies B's ids and counts byte for byte into dst / dst_n, the ring
//      neighbour's receive buffers (ring_copy.cuh; dst == nullptr skips
//      the copy);
//   2. writes the [n_local, n_local] int32 tile |set(A_i) ∩ set(B_j)| over
//      the ids below v_pad: the sum over vocabulary chunks of the product
//      of 0/1 indicator rows. An id repeated in a row counts once, as the
//      JAX indicator counts it; ids >= v_pad (PAD_ID included) never
//      count. 0/1 int8 products summed in int32 are exact.
//
// What bounds it: operations. The product does 2 * n_local^2 * v_pad int8
// operations whatever the rows hold (less here, since a chunk that one
// side of a tile does not touch is skipped); the bytes are the two blocks,
// the tile and the copy.
//
// Design. The TPU body scatters a whole vocabulary chunk of every row of a
// grid cell into VMEM, then runs one bf16 dot_general on the MXU, chunk
// after chunk in a sequential loop. Here:
//   - a block owns a TM x TM output tile (TM A rows against TM B rows) and
//     a contiguous range of vocabulary chunks; the blocks of one tile split
//     the vocabulary between them and add their partial counts into the
//     tile with integer atomics (exact, in any order), so even a 128-row
//     block fills the card;
//   - thread t < TM owns A row t of the tile, thread TM + t B row t: it
//     keeps a cursor into its sorted row, so a row's ids are read once per
//     tile, and stages the ids of the current chunk as 1 bytes in its own
//     shared-memory row (KC bytes, padded to LDM so that the fragment loads
//     below hit 32 distinct banks);
//   - the block jumps from chunk to chunk by a block-wide minimum of the
//     rows' next ids: it goes straight to the next chunk that both the A
//     side and the B side of the tile touch, and advances the other
//     side's cursors past the ids in between (they meet nothing);
//   - each of the 4 warps multiplies a 32 x 32 piece of the tile over the
//     chunk with mma.sync m16n8k32 s8 x s8 -> s32 (the staged B rows are
//     exactly the column-major B operand of A * B^T), keeping its counts in
//     registers across all its chunks;
//   - after the product each thread clears only the bytes it set, so the
//     staging is zeroed once a block, not once a chunk.
// wgmma, TMA and a pipelined chunk loop are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ring_copy.cuh"

#define TM 64             // A rows and B rows of a block's output tile
#define THREADS (2 * TM)  // one thread a staged row: A rows, then B rows
#define KC 256            // vocabulary ids a chunk
#define LDM (KC + 16)     // bytes a staged row
#define TARGET_BLOCKS 2048

// this row's id at position c, INT_MAX past its end
__device__ __forceinline__ int id_at(const int32_t* __restrict__ row, int c, int width) {
  return c < width ? row[c] : INT_MAX;
}

// the first position of an ascending row holding an id >= x (width if none)
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ row, int width, int x) {
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// c += a * b on a 16 x 8 tile, depth 32, int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid (B tiles, A tiles, vocabulary splits); `tile` zeroed before launch
__global__ void __launch_bounds__(THREADS)
ring_step_mm_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    const int32_t* __restrict__ nb, int32_t* __restrict__ tile,
                    int32_t* __restrict__ dst, int32_t* __restrict__ dst_n,
                    int n_local, int width, int v_pad, int chunks_per_split) {
  __shared__ __align__(16) int8_t ind[THREADS * LDM];  // staged rows: A rows 0..TM-1, B rows TM..
  __shared__ int warp_min[2][THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (dst != nullptr) {
    const int64_t block = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const int64_t n_threads = (int64_t)gridDim.x * gridDim.y * gridDim.z * THREADS;
    ring_copy_share(b, nb, dst, dst_n, n_local, width, block * THREADS + tid, n_threads);
  }

  int4* ind16 = reinterpret_cast<int4*>(ind);
  for (int i = tid; i < THREADS * LDM / 16; i += THREADS) ind16[i] = make_int4(0, 0, 0, 0);

  // this thread's row, its cursor and its next id in the block's vocabulary range
  const bool is_a = tid < TM;
  const int r = (is_a ? blockIdx.y : blockIdx.x) * TM + (tid & (TM - 1));
  const bool row_ok = r < n_local;
  const int32_t* __restrict__ row = (is_a ? a : b) + (int64_t)(row_ok ? r : 0) * width;
  int8_t* my_ind = ind + tid * LDM;
  const int lo_id = blockIdx.z * chunks_per_split * KC;
  const int hi_id = min(lo_id + chunks_per_split * KC, v_pad);
  int cur = row_ok ? lower_bound(row, width, lo_id) : width;
  int nxt = id_at(row, cur, width);

  // warp w multiplies tile rows 32 * (w / 2) .. +32 by tile columns 32 * (w % 2) .. +32
  const int g = lane >> 2, t4 = lane & 3;
  const int8_t* sa = ind + (32 * (warp >> 1) + g) * LDM + 4 * t4;
  const int8_t* sb = ind + (TM + 32 * (warp & 1) + g) * LDM + 4 * t4;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int it = 0;; ++it) {
    // the smallest next id of the A rows and of the B rows (one barrier an
    // iteration; the double buffer keeps the next write off this read)
    const int m = __reduce_min_sync(0xffffffffu, nxt);
    if (lane == 0) warp_min[it & 1][warp] = m;
    __syncthreads();
    const int next_a = min(warp_min[it & 1][0], warp_min[it & 1][1]);
    const int next_b = min(warp_min[it & 1][2], warp_min[it & 1][3]);
    const int lo = max(next_a, next_b);
    if (lo >= hi_id) break;
    const int base = lo - lo % KC;
    const int end = min(base + KC, hi_id);
    if (next_a < base || next_b < base) {
      // the ids of one side below this chunk meet none of the other side's
      while (nxt < base) nxt = id_at(row, ++cur, width);
      continue;
    }
    // both sides touch [base, end): stage the chunk
    const int first = cur;
    while (nxt < end) {
      my_ind[nxt - base] = 1;
      nxt = id_at(row, ++cur, width);
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 32) {
      int af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = sa + 16 * i * LDM + k0;
        af[i][0] = *reinterpret_cast<const int*>(p);
        af[i][1] = *reinterpret_cast<const int*>(p + 8 * LDM);
        af[i][2] = *reinterpret_cast<const int*>(p + 16);
        af[i][3] = *reinterpret_cast<const int*>(p + 8 * LDM + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sb + 8 * j * LDM + k0;
        bf[j][0] = *reinterpret_cast<const int*>(p);
        bf[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
    for (int c = first; c < cur; ++c) my_ind[row[c] - base] = 0;
  }

  // this warp's counts into the tile, summed over the vocabulary splits
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ri = blockIdx.y * TM + 32 * (warp >> 1) + 16 * i + g + (q >= 2 ? 8 : 0);
        const int cj = blockIdx.x * TM + 32 * (warp & 1) + 8 * j + 2 * t4 + (q & 1);
        if (ri < n_local && cj < n_local && acc[i][j][q] != 0) {
          atomicAdd(tile + (int64_t)ri * n_local + cj, acc[i][j][q]);
        }
      }
    }
  }
}

// v_pad: a positive multiple of 128, at most 2^30 (the wrapper checks).
extern "C" int ring_step_mm_launch(const int32_t* a, const int32_t* b, const int32_t* nb,
                                   int32_t* tile, int32_t* dst, int32_t* dst_n,
                                   int n_local, int width, int v_pad, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_local > 0) {
    const cudaError_t err = cudaMemsetAsync(tile, 0, (size_t)n_local * n_local * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n_local + TM - 1) / TM;
    const int n_chunks = (v_pad + KC - 1) / KC;
    int splits = (TARGET_BLOCKS + tiles * tiles - 1) / (tiles * tiles);
    splits = splits < n_chunks ? splits : n_chunks;
    const int chunks_per_split = (n_chunks + splits - 1) / splits;
    splits = (n_chunks + chunks_per_split - 1) / chunks_per_split;
    const dim3 grid(tiles, tiles, splits);
    ring_step_mm_kernel<<<grid, THREADS, 0, s>>>(a, b, nb, tile, dst, dst_n, n_local, width, v_pad,
                                                 chunks_per_split);
  }
  return (int)cudaGetLastError();
}
