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
// Design: a warp-cooperative merge-path walk (merge_path.cuh). A block
// stages SUB A rows and SUB B rows of one output tile in shared memory
// with 16-byte loads, with their real lengths and counts (at W = 1000,
// SUB = 8: 64 KB; 16 warps a block, three blocks an SM), and its
// MASH_WARPS warps take the SUB x SUB pairs, one warp a pair: each round
// of 32 x MASH_E merged ids splits evenly over the 32 lanes by a binary
// search on the merge path, each lane merges its share with selects from
// shared memory (~11 instructions an id), a warp scan gives each lane its
// starting distinct rank, and the warp stops after the round that passes
// s_use. Each staged row serves SUB pairs. Rows too wide for SUB >=
// MIN_SUB to fit in STAGE_BYTES are not staged whole: each warp copies,
// per round, the 32 x MASH_E + 1 ids of each row that the round can reach
// into its own window in shared memory (coalesced), so any width runs.
// What bounds it now (PERF.md): instruction issue and the latency
// of each step's dependent shared-memory load; the searches are about a
// third of a round's instructions. MASH_E and MASH_WARPS were chosen on
// the card: 8 or 32 ids a lane and 8 warps a block were slower (PERF.md).
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

#include "merge_path.cuh"

#define TILE 128
#define MASH_E 16  // merged ids a lane a round
#define MASH_WARPS 16
#define STAGE_BYTES (96 * 1024)  // a block's staged rows: two or more blocks an SM
#define MAX_SUB 16  // A rows (and B rows) a block stages at most
#define MIN_SUB 4   // fewer staged rows leave warps idle: take the windows instead
#define WINDOW_SUB 8
#define WINDOW (32 * MASH_E + 1)  // ids of one row a round can reach
#define HEAD_INTS 64               // the rows' real lengths and counts, ahead of the rows

struct MashArgs {
  const int32_t* a;
  const int32_t* na;
  const int32_t* b;
  const int32_t* nb;
  int32_t* out;
  int width, stride, s_orig, symmetric, n_tiles, out_cols, sub, grid_x, vec;
};

template <bool STAGED>
__global__ void __launch_bounds__(MASH_WARPS * 32) mash_shared_kernel(MashArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  int* lens = smem;         // [2 sub]: real ids of the block's A rows, then B rows
  int* counts = smem + 32;  // [2 sub]: their counts
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
  const int32_t* ga = p.a + a0 * width;
  const int32_t* gb = p.b + b0 * width;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (STAGED) {
    stage_rows(rows, ga, sub, width, p.stride, p.vec);
    stage_rows(rows + (int64_t)sub * p.stride, gb, sub, width, p.stride, p.vec);
    __syncthreads();
  }
  if (tid < 2 * sub) {
    const bool is_a = tid < sub;
    const int r = is_a ? tid : tid - sub;
    counts[tid] = is_a ? p.na[a0 + r] : p.nb[b0 + r];
    lens[tid] = real_len(STAGED ? rows + (int64_t)tid * p.stride : (is_a ? ga : gb) + (int64_t)r * width, width);
  }
  __syncthreads();

  for (int pq = warp; pq < sub * sub; pq += MASH_WARPS) {
    const int r = pq / sub, c = pq - (pq / sub) * sub;
    const int s_use = min(min(counts[r], counts[sub + c]), p.s_orig);
    int shared = 0;
    if (s_use > 0) {
      const int la = lens[r], lb = lens[sub + c];
      if (STAGED) {
        const uint32_t ar = shared_addr(rows + r * p.stride);
        const uint32_t br = shared_addr(rows + (sub + c) * p.stride);
        shared = warp_mash_shared<MASH_E>(la, lb, s_use, lane,
                                          [&](int i0, int j0, int, int, uint32_t& a, uint32_t& b) {
                                            a = ar + 4u * i0;
                                            b = br + 4u * j0;
                                          });
      } else {
        const int32_t* ar = ga + (int64_t)r * width;
        const int32_t* br = gb + (int64_t)c * width;
        int32_t* wa = rows + warp * 2 * WINDOW;
        int32_t* wb = wa + WINDOW;
        shared = warp_mash_shared<MASH_E>(la, lb, s_use, lane,
                                          [&](int i0, int j0, int ra, int rb, uint32_t& a, uint32_t& b) {
                                            __syncwarp();  // the last round's reads of the windows are done
                                            for (int q = lane; q < WINDOW; q += 32) {
                                              wa[q] = q < ra ? ar[i0 + q] : PAD_ID;
                                              wb[q] = q < rb ? br[j0 + q] : PAD_ID;
                                            }
                                            __syncwarp();
                                            a = shared_addr(wa);
                                            b = shared_addr(wb);
                                          });
      }
    }
    if (lane == 0) p.out[(a0 + r) * p.out_cols + col0 + c] = shared;
  }
}

// The launch plan for rows of `width` ids: the rows of A (and of B) a
// block takes, its dynamic shared memory, and whether it stages the rows
// whole (else per-warp windows).
static void plan(int width, int* sub, size_t* smem, bool* staged) {
  const int stride = staged_pitch(width);
  int s = MAX_SUB;
  while (s >= MIN_SUB && (size_t)2 * s * stride * 4 + HEAD_INTS * 4 > STAGE_BYTES) s >>= 1;
  *staged = s >= MIN_SUB;
  *sub = *staged ? s : WINDOW_SUB;
  *smem = HEAD_INTS * 4 + (*staged ? (size_t)2 * s * stride * 4 : (size_t)MASH_WARPS * 2 * WINDOW * 4);
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
  plan(width, &p.sub, &smem, &staged);
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
      mash_shared_kernel<true><<<(int)blocks, MASH_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
    } else {
      mash_shared_kernel<false><<<(int)blocks, MASH_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
    }
  }
  return (int)cudaGetLastError();
}
