// Exact intersection counts of a pack's rows by an indicator product on
// the int8 tensor cores, fused with the indicator's build, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_indicator.py::_indicator_kernel
// together with the XLA int8 dot that reads its rows: the function of
// drep_tpu/ops/containment.py::_intersect_matmul_tri_jit (one indicator
// build, the upper block triangle of its int8 product) followed by the
// host's mirror_lower_blocks. The operand is n ascending PAD_ID-padded
// int32 rows of `width` ids; out[i][j] += |set(row_i) ∩ set(row_j)| over
// the ids below v_pad, for every i and j: the full symmetric [n, n]
// matrix, added into what `out` holds (the chunked route adds its chunks
// into one accumulator). An id repeated in a row counts once; ids >= v_pad
// (PAD_ID included) and ids < 0 never count. 0/1 int8 products summed in
// int32 are exact. The [n, v_pad] indicator never reaches device memory.
// The rectangular entry (indicator_mm_rect_launch) computes the function
// of containment.py::_intersect_matmul_rect_jit, which the greedy
// secondary's block-versus-representatives comparisons read on a TPU: two
// packs a [na, width] and b [nb, width], out[i][j] += |set(a_i) ∩
// set(b_j)| over the ids below v_pad into [na, nb] (row-major).
//
// What bounds it: bytes, the ids read once and the [n, n] (or [na, nb])
// counts written once; its tensor-core formulation does 2 x 128^2 x v_pad
// int8 operations for each computed 128 x 128 tile.
//
// Design. A block owns an upper output tile (bi <= bj; the grid's x) and a
// share of the vocabulary (the grid's y: as many splits as fill the card's
// SMs in one wave, so even a pack of few tiles fills it), runs
// mm_block.cuh's block body, and adds each sum at (i, j) and, off the
// diagonal tile, at (j, i). The rectangular entry's blocks own every
// output tile of [na, nb] (no mirror, no diagonal), with the same splits.
// On a diagonal tile the A rows are the B rows: the dense walk stages them
// once, and both wgmma operands read that side. The producers walk one of
// two ways, picked by the wrapper from the pack's width against v_pad (a
// template parameter):
//   - sparse (few ids a row a chunk): mm_block.cuh's, one row a thread;
//   - dense (a few to hundreds of ids a row a chunk: the one-shot
//     secondary's cluster-local packs, the chunked route's chunks): a
//     row's ids inside one chunk are a contiguous run of the sorted row,
//     so ROW_LANES lanes of a warp read it together, ROW_PIECES 16-byte
//     pieces a lane at once (ROW_LANES x ROW_PIECES x 4 ids of the row a
//     round, coalesced), and each lane walks ROWS_A_LANE rows, so a warp
//     has all its rows' loads in flight at once; the lanes store each id
//     of the chunk as a 1 byte, sum what they stored by shuffles to move
//     the row's cursor, and go on while the row's last id read is inside
//     the chunk. A warp first clears its rows' lines in the stage. Every
//     chunk of the block's share is staged (no jumps).
//     What holds it back (PERF.md): the producers' byte stores, most of
//     a chunk's ~10 000 cycles on phase 3's rows, ~8 times the products'.

#include "mm_block.cuh"

#define MIN_CHUNKS 8  // chunks a block takes at least: its start (a search a row) and its epilogue are not free

#define ROW_LANES 2    // lanes of a dense producer warp on one row
#define GROUPS (32 / ROW_LANES)  // rows a warp instruction reads
#define ROWS_A_LANE 2  // rows a lane walks at once: all 32 of the warp's
#define ROW_PIECES 4   // 16-byte pieces a lane loads from each of its rows at once
#define ROWS_AT_ONCE (GROUPS * ROWS_A_LANE)

// store id v of the row at `line` as a 1 byte where it lies in the chunk
// of `span` ids from `base`: swizzled(t, k), the atom k / 128, the 16-byte
// piece XOR t % 8 (xr); 1 where it does
__device__ __forceinline__ int put(int v, int base, uint32_t span, uint32_t line, uint32_t xr) {
  const uint32_t k = (uint32_t)v - (uint32_t)base;
  if (k < span) st_shared_u8(line + (k >> 7) * ATOM_BYTES + ((k & 127) ^ xr), 1);
  return k < span;
}

// The dense walk of a producer warp over ids [lo_id, hi_id): the staged
// rows are A rows a_row0 .. a_row0 + TM - 1 of `a` (na rows), then (off
// the diagonal) B rows b_row0 .. of `b` (nb rows); warp w takes per_warp
// consecutive ones. Rows at or past their side's row count read as empty;
// `width` is a multiple of 4 and each row 16-byte aligned.
__device__ __forceinline__ void dense_producer(MmShared& sh, uint32_t stages, const int32_t* __restrict__ a, int na,
                                               const int32_t* __restrict__ b, int nb, int width, int a_row0,
                                               int b_row0, bool diag, int lo_id, int hi_id) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = (diag ? TM : 2 * TM) / (4 * PRODUCERS);  // 16 or 32
  const int first = warp * per_warp;                            // the warp's first staged row
  // the row in its side's pack of staged row r (A rows, then B rows), and
  // whether that pack holds it
  auto pack_row = [&](int r) { return (r < TM ? a_row0 : b_row0) + (r & (TM - 1)); };
  auto held = [&](int r) { return pack_row(r) < (r < TM ? na : nb); };
  auto row_of = [&](int r) { return (r < TM ? a : b) + (int64_t)(held(r) ? pack_row(r) : 0) * width; };
  int cursor = width;  // lane j: the position in the warp's row j of its first id >= the chunk's start
  if (lane < per_warp && held(first + lane)) cursor = lower_bound(row_of(first + lane), width, lo_id);
  const int grp = lane / ROW_LANES, gl = lane % ROW_LANES;
  int stage = 0, phase = 0;
  for (int base = lo_id;; base += KC) {
    const bool live = base < hi_id;
    const uint32_t st = stages + stage * STAGE_SIZE;
    mbar_wait(bar_addr(&sh.empty_bar[stage]), phase ^ 1);
    // clear the warp's rows: 16 pieces of 16 bytes a row, a row's 8
    // pieces of one line in one store phase
    for (int i = lane; i < per_warp * 16; i += 32) {
      const int r = first + (i >> 4), piece = i & 15;
      st_shared_zero16(st + (r >> 7) * SIDE_BYTES + (piece >> 3) * ATOM_BYTES + row_line(r & (TM - 1)) +
                       (piece & 7) * 16);
    }
    __syncwarp();
    if (live) {
      const int end = min(base + KC, hi_id);
      const uint32_t span = (uint32_t)(end - base);
      // ROWS_AT_ONCE of the warp's rows at a time: the group's ROWS_A_LANE
      // rows, GROUPS rows apart
      for (int pass = 0; pass * ROWS_AT_ONCE < per_warp; ++pass) {
        const int32_t* row[ROWS_A_LANE];
        uint32_t line[ROWS_A_LANE], xr[ROWS_A_LANE], on[ROWS_A_LANE];
        int cur[ROWS_A_LANE];
#pragma unroll
        for (int ri = 0; ri < ROWS_A_LANE; ++ri) {
          const int j = ROWS_AT_ONCE * pass + GROUPS * ri + grp;  // the row of the warp's (none past per_warp)
          const int r = first + j;
          row[ri] = row_of(r);
          line[ri] = st + (r >> 7) * SIDE_BYTES + row_line(r & (TM - 1));
          xr[ri] = (uint32_t)(r & 7) << 4;
          cur[ri] = __shfl_sync(0xffffffffu, cursor, j & 31);
          on[ri] = j < per_warp ? span : 0;  // the span while the row's run goes on, then 0
        }
        // a row's run goes on past the ids its group has read until one of
        // them is past the chunk; the warp walks while a run goes on
        while (true) {
          uint32_t going = 0;
#pragma unroll
          for (int ri = 0; ri < ROWS_A_LANE; ++ri) going |= on[ri];
          if (!__any_sync(0xffffffffu, going != 0)) break;
          // each row's ids from the 16-byte piece holding its cursor, a
          // lane's pieces ROW_LANES pieces apart, every load issued before
          // any is read (ids before the cursor lie before the chunk and
          // store nothing)
          int4 v[ROWS_A_LANE][ROW_PIECES];
#pragma unroll
          for (int ri = 0; ri < ROWS_A_LANE; ++ri)
#pragma unroll
            for (int u = 0; u < ROW_PIECES; ++u) {
              const int p = (cur[ri] & ~3) + 4 * (gl + ROW_LANES * u);
              v[ri][u] = p < width ? __ldg(reinterpret_cast<const int4*>(row[ri] + p))
                                   : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
            }
#pragma unroll
          for (int ri = 0; ri < ROWS_A_LANE; ++ri) {
            int taken = 0;
#pragma unroll
            for (int u = 0; u < ROW_PIECES; ++u)
              taken += put(v[ri][u].x, base, on[ri], line[ri], xr[ri]) + put(v[ri][u].y, base, on[ri], line[ri], xr[ri]) +
                       put(v[ri][u].z, base, on[ri], line[ri], xr[ri]) + put(v[ri][u].w, base, on[ri], line[ri], xr[ri]);
            // (summed by shuffles: a redux.sync with a group's mask runs
            // once for each group of the warp)
#pragma unroll
            for (int o = 1; o < ROW_LANES; o <<= 1) taken += __shfl_xor_sync(0xffffffffu, taken, o);
            cur[ri] += taken;
            // the group's last id: still before the chunk's end?
            const uint32_t last_in = __ballot_sync(0xffffffffu, v[ri][ROW_PIECES - 1].w < end);
            if (!((last_in >> (ROW_LANES * grp + ROW_LANES - 1)) & 1)) on[ri] = 0;
          }
        }
        // lane j of the pass's rows takes back its row's cursor
#pragma unroll
        for (int ri = 0; ri < ROWS_A_LANE; ++ri) {
          const int moved = __shfl_sync(0xffffffffu, cur[ri], ROW_LANES * (lane % GROUPS));
          if (lane / ROWS_AT_ONCE == pass && (lane % ROWS_AT_ONCE) / GROUPS == ri) cursor = moved;
        }
      }
    }
    if (threadIdx.x == 0) sh.chunk_live[stage] = live;
    mm_hand_over(sh, stage);
    if (!live) break;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// grid (upper tiles, vocabulary splits); `out` holds what the counts add to
template <bool DENSE>
__global__ void __launch_bounds__(THREADS, 1)
indicator_mm_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ out, int n, int width, int v_pad,
                    int tiles, int chunks_per_split) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ MmShared sh;
  // the upper tile (bi, bj), bi <= bj, of blockIdx.x, row by row
  int u = blockIdx.x, bi = 0;
  while (u >= tiles - bi) {
    u -= tiles - bi;
    ++bi;
  }
  const int bj = bi + u;
  const bool diag = bi == bj;
  const uint32_t stages = mm_setup(smem_raw, sh);
  const int lo_id = blockIdx.y * chunks_per_split * KC;
  const int hi_id = min(lo_id + chunks_per_split * KC, v_pad);
  if (threadIdx.x < 128 * PRODUCERS) {
    if (DENSE)
      dense_producer(sh, stages, ids, n, ids, n, width, bi * TM, bj * TM, diag, lo_id, hi_id);
    else
      mm_sparse_producer(sh, stages, ids, bi * TM, n, ids, bj * TM, n, width, lo_id, hi_id);
  } else {
    int d[64];
    mm_consumer(sh, stages, DENSE && diag ? 0 : SIDE_BYTES, d);
    mm_epilogue(d, out, n, n, n, bi * TM, bj * TM, !diag);
  }
}

// The rectangular entry: grid (every output tile, row-major over B's
// tiles, times the vocabulary splits); out [na, nb] row-major holds what
// the counts |A_i ∩ B_j| add to. No tile is mirrored or staged once.
template <bool DENSE>
__global__ void __launch_bounds__(THREADS, 1)
indicator_mm_rect_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ out,
                         int na, int nb, int width, int v_pad, int tiles_b, int chunks_per_split) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ MmShared sh;
  const int bi = blockIdx.x / tiles_b, bj = blockIdx.x % tiles_b;
  const uint32_t stages = mm_setup(smem_raw, sh);
  const int lo_id = blockIdx.y * chunks_per_split * KC;
  const int hi_id = min(lo_id + chunks_per_split * KC, v_pad);
  if (threadIdx.x < 128 * PRODUCERS) {
    if (DENSE)
      dense_producer(sh, stages, a, na, b, nb, width, bi * TM, bj * TM, false, lo_id, hi_id);
    else
      mm_sparse_producer(sh, stages, a, bi * TM, na, b, bj * TM, nb, width, lo_id, hi_id);
  } else {
    int d[64];
    mm_consumer(sh, stages, SIDE_BYTES, d);
    mm_epilogue(d, out, na, nb, nb, bi * TM, bj * TM, false);
  }
}

// The kernel's shared memory granted, and the card's SMs in *sms.
template <typename Kernel>
static int prepare(Kernel kernel, int* sms) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int dev;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <bool DENSE>
static int launch(const int32_t* ids, int32_t* out, int n, int width, int v_pad, cudaStream_t s) {
  int sms;
  const int rc = prepare(indicator_mm_kernel<DENSE>, &sms);
  if (rc != 0) return rc;
  const int tiles = (n + TM - 1) / TM, upper = tiles * (tiles + 1) / 2;
  // one wave: as many splits of each upper tile as fill the SMs once
  int chunks_per_split;
  const int splits = mm_splits(sms / upper, (v_pad + KC - 1) / KC, MIN_CHUNKS, &chunks_per_split);
  const dim3 grid(upper, splits);
  indicator_mm_kernel<DENSE><<<grid, THREADS, SMEM_BYTES, s>>>(ids, out, n, width, v_pad, tiles, chunks_per_split);
  return 0;
}

template <bool DENSE>
static int launch_rect(const int32_t* a, const int32_t* b, int32_t* out, int na, int nb, int width, int v_pad,
                       cudaStream_t s) {
  int sms;
  const int rc = prepare(indicator_mm_rect_kernel<DENSE>, &sms);
  if (rc != 0) return rc;
  const int tiles_b = (nb + TM - 1) / TM, tiles = (na + TM - 1) / TM * tiles_b;
  // one wave, as the symmetric entry
  int chunks_per_split;
  const int splits = mm_splits(sms / tiles, (v_pad + KC - 1) / KC, MIN_CHUNKS, &chunks_per_split);
  const dim3 grid(tiles, splits);
  indicator_mm_rect_kernel<DENSE><<<grid, THREADS, SMEM_BYTES, s>>>(a, b, out, na, nb, width, v_pad, tiles_b,
                                                                   chunks_per_split);
  return 0;
}

// out: [n, n] int32, added to; v_pad positive, at most 2^30 (the wrapper
// checks); dense: the walk (0 sparse, 1 dense).
extern "C" int indicator_mm_launch(const int32_t* ids, int32_t* out, int n, int width, int v_pad, int dense,
                                   void* stream) {
  if (n > 0 && width > 0) {
    const int rc = dense ? launch<true>(ids, out, n, width, v_pad, (cudaStream_t)stream)
                         : launch<false>(ids, out, n, width, v_pad, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

// a [na, width], b [nb, width]; out: [na, nb] int32, added to; v_pad and
// dense as indicator_mm_launch's.
extern "C" int indicator_mm_rect_launch(const int32_t* a, const int32_t* b, int32_t* out, int na, int nb, int width,
                                        int v_pad, int dense, void* stream) {
  if (na > 0 && nb > 0 && width > 0) {
    const int rc = dense ? launch_rect<true>(a, b, out, na, nb, width, v_pad, (cudaStream_t)stream)
                         : launch_rect<false>(a, b, out, na, nb, width, v_pad, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
