// One step of the dense all-pairs ring, fused with the rotation of its B
// operand, for Hopper (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_ring.py::_fused_step_kernel
// (merge variant; launched from fused_ring_step_fn). A position of the ring
// holds an A block and the current B block, each n_local sorted PAD_ID-padded
// int32 rows of `width` ids with their counts. One launch
//   1. copies B's ids and counts byte for byte into dst / dst_n, the ring
//      neighbour's receive buffers (on this card, or on a peer card whose
//      memory this one may access);
//   2. writes the [n_local, n_local] int32 tile of the step:
//      kind 0  Mash: union-bottom-s shared counts, s_use = min(n_a, n_b,
//              width) (merge_walk.cuh::mash_walk_piece; the host turns
//              them into distances as for the single-device matrix);
//      kind 1  containment: per pair, the non-PAD A elements found in B
//              (merge_walk.cuh::contained_walk_piece, the JAX
//              _pair_intersection).
// dst == nullptr skips the copy (the last step of a schedule).
//
// The TPU kernel starts the remote DMA in its first grid cell and waits for
// it in the last, so the ICI transfer overlaps the whole tile sweep. Here
// every block first copies a grid-stride share of B with 16-byte stores
// (ring_copy.cuh) and then walks its pairs: the copy's HBM (or NVLink)
// traffic runs while other blocks walk, and the end of the launch is the
// wait.
//
// What bounds it: operations. The walks are data-dependent compare-and-
// advance steps with no tensor-core form (~2 s_use a Mash pair, up to
// n_a + n_b a containment pair); the bytes are the two blocks, the tile and
// the copy, read or written once. Design, as csrc/mash_shared.cu: a block
// is one A row against a TILE-row B tile, thread c owns B row c and streams
// it through L1. The A row is staged in shared memory (coalesced) CHUNK ids
// at a time; every thread walks its pair over the piece, keeping its state
// (merge_walk.cuh), and the block stages the next piece when a thread still
// needs one. So any width runs, and a block holds at most 16 KB of shared
// memory: many blocks share an SM, which hides the walks' L1/L2 latency.
// One A row a block gives n_local x ceil(n_local / TILE) blocks (2000 for a
// 500-row block). n_local need not be a multiple of TILE: rows past it are
// masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_walk.cuh"
#include "ring_copy.cuh"

#define TILE 128
#define CHUNK 4096  // A ids staged at a time (16 KB)

__global__ void __launch_bounds__(TILE)
ring_step_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ na,
                 const int32_t* __restrict__ b, const int32_t* __restrict__ nb,
                 int32_t* __restrict__ tile, int32_t* __restrict__ dst,
                 int32_t* __restrict__ dst_n, int n_local, int width, int kind) {
  extern __shared__ int32_t a_piece[];  // min(width, CHUNK) ids
  const int tid = threadIdx.x;

  if (dst != nullptr) {
    const int64_t n_threads = (int64_t)gridDim.x * gridDim.y * TILE;
    const int64_t gtid = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE + tid;
    ring_copy_share(b, nb, dst, dst_n, n_local, width, gtid, n_threads);
  }

  const int a_idx = blockIdx.x;
  const int b_row = blockIdx.y * TILE + tid;
  const bool b_ok = b_row < n_local;
  const int32_t* __restrict__ arow = a + (int64_t)a_idx * width;
  const int32_t* __restrict__ brow = b + (int64_t)(b_ok ? b_row : 0) * width;
  int s_use = 0;
  if (kind == 0 && b_ok) {
    s_use = na[a_idx] < nb[b_row] ? na[a_idx] : nb[b_row];
    s_use = s_use < width ? s_use : width;
  }
  MashWalk mash;
  ContainedWalk contained;
  if (kind != 0 && b_ok) contained_walk_start(contained, brow, width);
  bool done = !b_ok || (kind == 0 && s_use <= 0);
  // every thread runs every iteration: the loop's exit is block-wide
  for (int c0 = 0; c0 < width; c0 += CHUNK) {
    const int len = width - c0 < CHUNK ? width - c0 : CHUNK;
    for (int c = tid; c < len; c += TILE) a_piece[c] = arow[c0 + c];
    __syncthreads();
    if (!done) {
      done = kind == 0 ? mash_walk_piece(mash, a_piece, c0, len, brow, width, s_use)
                       : contained_walk_piece(contained, a_piece, len, brow, width);
    }
    // also the barrier before the next piece overwrites this one
    if (!__syncthreads_or(!done)) break;
  }
  if (b_ok) tile[(int64_t)a_idx * n_local + b_row] = kind == 0 ? mash.shared : contained.count;
}

extern "C" int ring_step_launch(const int32_t* a, const int32_t* na, const int32_t* b,
                                const int32_t* nb, int32_t* tile, int32_t* dst, int32_t* dst_n,
                                int n_local, int width, int kind, void* stream) {
  if (n_local > 0 && width > 0) {
    const dim3 grid(n_local, (n_local + TILE - 1) / TILE);
    const size_t smem = (size_t)(width < CHUNK ? width : CHUNK) * sizeof(int32_t);
    ring_step_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
        a, na, b, nb, tile, dst, dst_n, n_local, width, kind);
  }
  return (int)cudaGetLastError();
}

// Let kernels running on card `dev` read and write the memory of card
// `peer` (the ring's copy into a neighbour on another card). Restores the
// calling thread's current card. 0, or the cudaError_t.
extern "C" int ring_enable_peer(int dev, int peer) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it recorded: the next launch check reads it
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(cur);
  return (int)(err != cudaSuccess ? err : restore);
}
