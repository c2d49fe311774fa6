// The block body shared by csrc/mash_shared.cu and csrc/ring_step.cu: SUB
// A rows against SUB B rows of an output tile, one warp a pair, walked by
// the merge-path schedules of merge_path.cuh.
//
// A block stages its SUB A rows and SUB B rows in shared memory with
// 16-byte loads, with their real lengths and counts (at W = 1000, SUB = 8:
// 64 KB; 16 warps a block, three blocks an SM), and its PAIR_WARPS warps
// take the SUB x SUB pairs. Rows too wide for SUB >= MIN_SUB to fit in
// STAGE_BYTES are not staged whole: each warp copies, per round, the
// 32 x MASH_E + 1 ids of each row that the round can reach into its own
// window in shared memory (coalesced), so any width runs. Two kinds:
//   KIND_MASH       union-bottom-s shared counts, s_use = min(n_a, n_b,
//                   s_orig) (merge_path.cuh::warp_mash_shared): the rows'
//                   counts are staged beside their lengths;
//   KIND_CONTAINED  per pair, the A ids (each copy) that occur in B
//                   (merge_path.cuh::warp_contained): the walk ends after
//                   A's last real id, so B is cut at its first id >= it,
//                   found by a warp search.
// Rows past valid_a / valid_b (a block at the end of a block of n_local
// rows that is not a multiple of SUB) read as PAD rows with count 0, and
// their outputs are not written.

#pragma once

#include <stdint.h>

#include "merge_path.cuh"

#define MASH_E 16  // merged ids a lane a round
#define PAIR_WARPS 16
#define STAGE_BYTES (96 * 1024)  // a block's staged rows: two or more blocks an SM
#define MAX_SUB 16  // A rows (and B rows) a block stages at most
#define MIN_SUB 4   // fewer staged rows leave warps idle: take the windows instead
#define WINDOW_SUB 8
#define WINDOW (32 * MASH_E + 1)  // ids of one row a round can reach
#define HEAD_INTS 64               // the rows' real lengths and counts, ahead of the rows

#define KIND_MASH 0
#define KIND_CONTAINED 1

// One block's rows and outputs.
struct PairBlock {
  const int32_t* a;   // the block's first A row (pitch width) and its count
  const int32_t* na;
  const int32_t* b;
  const int32_t* nb;
  int32_t* out;       // the output of its first pair (pitch out_cols)
  int64_t out_cols;
  int valid_a, valid_b;  // rows that exist, at most sub
  int width, stride, sub, vec, s_orig;
};

// The launch plan for rows of `width` ids: the rows of A (and of B) a
// block takes, its dynamic shared memory, and whether it stages the rows
// whole (else per-warp windows).
static void pair_block_plan(int width, int* sub, size_t* smem, bool* staged) {
  const int stride = staged_pitch(width);
  int s = MAX_SUB;
  while (s >= MIN_SUB && (size_t)2 * s * stride * 4 + HEAD_INTS * 4 > STAGE_BYTES) s >>= 1;
  *staged = s >= MIN_SUB;
  *sub = *staged ? s : WINDOW_SUB;
  *smem = HEAD_INTS * 4 + (*staged ? (size_t)2 * s * stride * 4 : (size_t)PAIR_WARPS * 2 * WINDOW * 4);
}

template <int KIND, bool STAGED>
__device__ __forceinline__ void pair_block(const PairBlock& p, int32_t* smem) {
  int* lens = smem;         // [2 sub]: real ids of the block's A rows, then B rows
  int* counts = smem + 32;  // [2 sub]: their counts
  int32_t* rows = smem + HEAD_INTS;
  const int sub = p.sub;
  const int width = p.width;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool full = p.valid_a == sub && p.valid_b == sub;

  if (STAGED) {
    if (full) {
      stage_rows(rows, p.a, sub, width, p.stride, p.vec);
      stage_rows(rows + (int64_t)sub * p.stride, p.b, sub, width, p.stride, p.vec);
    } else {
      stage_rows(rows, p.a, p.valid_a, width, p.stride, p.vec);
      stage_rows(rows + (int64_t)sub * p.stride, p.b, p.valid_b, width, p.stride, p.vec);
      // the rows past the valid ones: PAD
      for (int idx = tid; idx < 2 * sub * p.stride; idx += blockDim.x) {
        const int r = idx / p.stride;
        if (r < sub ? r >= p.valid_a : r - sub >= p.valid_b) rows[idx] = PAD_ID;
      }
    }
    __syncthreads();
  }
  if (tid < 2 * sub) {
    const bool is_a = tid < sub;
    const int r = is_a ? tid : tid - sub;
    const bool ok = r < (is_a ? p.valid_a : p.valid_b);
    if (KIND == KIND_MASH) counts[tid] = ok ? (is_a ? p.na[r] : p.nb[r]) : 0;
    lens[tid] = !ok ? 0 : real_len(STAGED ? rows + (int64_t)tid * p.stride : (is_a ? p.a : p.b) + (int64_t)r * width,
                                   width);
  }
  __syncthreads();

  for (int pq = warp; pq < sub * sub; pq += PAIR_WARPS) {
    const int r = pq / sub, c = pq - (pq / sub) * sub;
    const int la = lens[r], lb = lens[sub + c];
    int value = 0;
    if (KIND == KIND_MASH) {
      const int s_use = min(min(counts[r], counts[sub + c]), p.s_orig);
      if (s_use > 0) {
        if (STAGED) {
          const uint32_t ar = shared_addr(rows + r * p.stride);
          const uint32_t br = shared_addr(rows + (sub + c) * p.stride);
          value = warp_mash_shared<MASH_E>(la, lb, s_use, lane,
                                           [&](int i0, int j0, int, int, uint32_t& a, uint32_t& b) {
                                             a = ar + 4u * i0;
                                             b = br + 4u * j0;
                                           });
        } else {
          const int32_t* ar = p.a + (int64_t)r * width;
          const int32_t* br = p.b + (int64_t)c * width;
          int32_t* wa = rows + warp * 2 * WINDOW;
          int32_t* wb = wa + WINDOW;
          value = warp_mash_shared<MASH_E>(la, lb, s_use, lane,
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
    } else if (la > 0 && lb > 0) {
      const int32_t* ar = STAGED ? rows + r * p.stride : p.a + (int64_t)r * width;
      const int32_t* br = STAGED ? rows + (sub + c) * p.stride : p.b + (int64_t)c * width;
      // B's ids below A's last real id: past them B meets nothing
      const int cut = warp_lower_bound(br, lb, ar[la - 1], lane);
      if (STAGED) {
        value = warp_contained(shared_addr(ar), la, shared_addr(br), cut, lane);
      } else {
        int32_t* wa = rows + warp * 2 * WINDOW;
        int32_t* wb = wa + WINDOW;
        value = warp_contained_rounds<MASH_E>(la, cut, lane, [&](int i0, int j0, uint32_t& a, uint32_t& b) {
          __syncwarp();  // the last round's reads of the windows are done
          for (int q = lane; q < WINDOW; q += 32) {
            wa[q] = q < la - i0 ? ar[i0 + q] : PAD_ID;
            wb[q] = q < lb - j0 ? br[j0 + q] : PAD_ID;
          }
          __syncwarp();
          a = shared_addr(wa);
          b = shared_addr(wb);
        });
      }
    }
    if (lane == 0 && r < p.valid_a && c < p.valid_b) p.out[r * p.out_cols + c] = value;
  }
}
