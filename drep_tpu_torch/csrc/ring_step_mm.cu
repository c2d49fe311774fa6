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
// after chunk in a sequential loop. Here a block owns a TM x TM output tile
// and a contiguous range of vocabulary chunks, so even one tile fills the
// card: mm_block.cuh's block body, its producers on the sparse walk (one
// row a thread, a jump past the chunks one side of the tile does not
// touch; the ring's rows hold 0.1 to 10 ids a chunk), its consumers on
// int8 wgmma. What bounds it now (PERF.md): the producers' walk, ~1.5
// times the products' time a chunk on cluster A's rows.

#include "mm_block.cuh"
#include "ring_copy.cuh"

#define TARGET_BLOCKS 2048
#define MIN_CHUNKS 32  // chunks a block takes at least: its start (a search a row) is not free

// grid (B tiles, A tiles, vocabulary splits); `tile` zeroed before launch
__global__ void __launch_bounds__(THREADS, 1)
ring_step_mm_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    const int32_t* __restrict__ nb, int32_t* __restrict__ tile,
                    int32_t* __restrict__ dst, int32_t* __restrict__ dst_n,
                    int n_local, int width, int v_pad, int chunks_per_split) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ MmShared sh;
  const int tid = threadIdx.x;

  if (dst != nullptr) {
    const int64_t block = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const int64_t n_threads = (int64_t)gridDim.x * gridDim.y * gridDim.z * THREADS;
    ring_copy_share(b, nb, dst, dst_n, n_local, width, block * THREADS + tid, n_threads);
  }

  const uint32_t stages = mm_setup(smem_raw, sh);

  const int lo_id = blockIdx.z * chunks_per_split * KC;
  const int hi_id = min(lo_id + chunks_per_split * KC, v_pad);

  if (tid < 128 * PRODUCERS) {
    mm_sparse_producer(sh, stages, a, blockIdx.y * TM, n_local, b, blockIdx.x * TM, n_local, width, lo_id, hi_id);
  } else {
    int d[64];
    mm_consumer(sh, stages, SIDE_BYTES, d);
    mm_epilogue(d, tile, n_local, n_local, n_local, blockIdx.y * TM, blockIdx.x * TM, false);
  }
}

// v_pad: a positive multiple of 128, at most 2^30 (the wrapper checks).
extern "C" int ring_step_mm_launch(const int32_t* a, const int32_t* b, const int32_t* nb,
                                   int32_t* tile, int32_t* dst, int32_t* dst_n,
                                   int n_local, int width, int v_pad, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_local > 0) {
    cudaError_t err = cudaMemsetAsync(tile, 0, (size_t)n_local * n_local * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ring_step_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n_local + TM - 1) / TM;
    int chunks_per_split;
    const int splits = mm_splits((TARGET_BLOCKS + tiles * tiles - 1) / (tiles * tiles), (v_pad + KC - 1) / KC,
                                 MIN_CHUNKS, &chunks_per_split);
    const dim3 grid(tiles, tiles, splits);
    ring_step_mm_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(a, b, nb, tile, dst, dst_n, n_local, width, v_pad,
                                                          chunks_per_split);
  }
  return (int)cudaGetLastError();
}
