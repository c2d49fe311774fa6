// The ring's copy of the B operand into the neighbour's receive buffers,
// shared by csrc/ring_step.cu and csrc/ring_step_mm.cu. Every thread of
// the step's grid copies its grid-stride share byte for byte, with 16-byte
// stores where both buffers allow them, before it computes its part of the
// tile: the copy's HBM (or NVLink) traffic runs while other blocks compute,
// and the end of the launch is the wait. The receive buffers may sit on a
// peer card whose memory this one may access.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// B's n_local x width ids and n_local counts into dst / dst_n: the share of
// thread `gtid` of the `n_threads` in the grid.
__device__ __forceinline__ void ring_copy_share(const int32_t* __restrict__ b, const int32_t* __restrict__ nb,
                                                int32_t* __restrict__ dst, int32_t* __restrict__ dst_n,
                                                int n_local, int width, int64_t gtid, int64_t n_threads) {
  const int64_t n_ids = (int64_t)n_local * width;
  const bool aligned = ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int64_t n_vec = aligned ? n_ids / 4 : 0;
  const int4* __restrict__ src4 = reinterpret_cast<const int4*>(b);
  int4* __restrict__ dst4 = reinterpret_cast<int4*>(dst);
  for (int64_t v = gtid; v < n_vec; v += n_threads) dst4[v] = src4[v];
  for (int64_t e = n_vec * 4 + gtid; e < n_ids; e += n_threads) dst[e] = b[e];
  for (int64_t r = gtid; r < n_local; r += n_threads) dst_n[r] = nb[r];
}
