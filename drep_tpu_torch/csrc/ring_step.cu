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
//              width) (the host turns them into distances as for the
//              single-device matrix);
//      kind 1  containment: per pair, the non-PAD A elements found in B
//              (the JAX _pair_intersection), each copy counted.
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
// the copy, read or written once. What held it back when one thread walked
// one pair (one A row a block against 128 B rows): each lane streamed its
// own B row through L1 (32 lines a load instruction) and re-read it once
// per A row, a warp waited for its longest walk, and the A row was staged
// 4 096 ids at a time with two barriers a piece.
//
// Design: the block body of csrc/mash_shared.cu (pair_block.cuh) on the
// step's blocks, one warp a pair walked by merge_path.cuh's schedules. A
// block takes SUB A rows against SUB B rows: the Mash tile is
// mash_shared.cu's rectangular layout with s_orig = width, the containment
// tile merge_path.cuh::warp_contained (each lane's step counts the A id it
// takes when it equals the B head), whose walk ends after A's last real
// id. Rows too wide to stage whole (32 768 and 65 536 ids) take per-warp
// windows. n_local need not be a multiple of SUB: rows past it read as PAD
// rows with count 0, and their outputs are not written.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pair_block.cuh"
#include "ring_copy.cuh"

struct RingArgs {
  const int32_t* a;
  const int32_t* na;
  const int32_t* b;
  const int32_t* nb;
  int32_t* tile;
  int32_t* dst;
  int32_t* dst_n;
  int n_local, width, stride, sub, grid_x, vec;
};

template <int KIND, bool STAGED>
__global__ void __launch_bounds__(PAIR_WARPS * 32) ring_step_kernel(RingArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  if (p.dst != nullptr) {
    const int64_t n_threads = (int64_t)gridDim.x * blockDim.x;
    ring_copy_share(p.b, p.nb, p.dst, p.dst_n, p.n_local, p.width,
                    (int64_t)blockIdx.x * blockDim.x + threadIdx.x, n_threads);
  }
  const int64_t a0 = (int64_t)(blockIdx.x / p.grid_x) * p.sub;
  const int64_t b0 = (int64_t)(blockIdx.x % p.grid_x) * p.sub;
  PairBlock blk;
  blk.a = p.a + a0 * p.width;
  blk.na = p.na + a0;
  blk.b = p.b + b0 * p.width;
  blk.nb = p.nb + b0;
  blk.out = p.tile + a0 * p.n_local + b0;
  blk.out_cols = p.n_local;
  blk.valid_a = (int)min((int64_t)p.sub, p.n_local - a0);
  blk.valid_b = (int)min((int64_t)p.sub, p.n_local - b0);
  blk.width = p.width;
  blk.stride = p.stride;
  blk.sub = p.sub;
  blk.vec = p.vec;
  blk.s_orig = p.width;
  pair_block<KIND, STAGED>(blk, smem);
}

template <int KIND, bool STAGED>
static cudaError_t launch(const RingArgs& p, int64_t blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(ring_step_kernel<KIND, STAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ring_step_kernel<KIND, STAGED><<<(int)blocks, PAIR_WARPS * 32, smem, stream>>>(p);
  return cudaSuccess;
}

extern "C" int ring_step_launch(const int32_t* a, const int32_t* na, const int32_t* b,
                                const int32_t* nb, int32_t* tile, int32_t* dst, int32_t* dst_n,
                                int n_local, int width, int kind, void* stream) {
  if (n_local > 0 && width > 0) {
    RingArgs p;
    p.a = a;
    p.na = na;
    p.b = b;
    p.nb = nb;
    p.tile = tile;
    p.dst = dst;
    p.dst_n = dst_n;
    p.n_local = n_local;
    p.width = width;
    p.stride = staged_pitch(width);
    p.vec = width % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
    size_t smem;
    bool staged;
    pair_block_plan(width, &p.sub, &smem, &staged);
    p.grid_x = (n_local + p.sub - 1) / p.sub;
    const int64_t blocks = (int64_t)p.grid_x * p.grid_x;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = kind == 0 ? (staged ? launch<KIND_MASH, true>(p, blocks, smem, s)
                                                : launch<KIND_MASH, false>(p, blocks, smem, s))
                                      : (staged ? launch<KIND_CONTAINED, true>(p, blocks, smem, s)
                                                : launch<KIND_CONTAINED, false>(p, blocks, smem, s));
    if (err != cudaSuccess) return (int)err;
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
