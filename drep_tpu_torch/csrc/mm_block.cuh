// The block body of the port's indicator products on the int8 tensor
// cores, for Hopper (sm_90a): ring_step_mm.cu (one step of the matmul
// ring) and indicator_mm.cu (a pack's intersection counts, or two packs'
// rectangle) include it.
//
// A block owns a TM x TM output tile (TM A rows against TM B rows) and a
// contiguous range of 256-id vocabulary chunks; the blocks of one tile
// split the vocabulary between them and add their partial counts into the
// output with integer atomics (exact, in any order). Its warpgroups
// specialise:
//   - two producer warpgroups stage each chunk the tile touches as 0/1
//     bytes of both sides' rows, each byte at its place in wgmma's
//     canonical 128-byte-swizzled K-major layout (each 16-byte piece of a
//     128-byte row segment stored at its index XOR the row's index mod 8),
//     into the next free of STAGES stages. The including kernel picks the
//     walk: the sparse one here (one row a thread; mm_sparse_producer) or
//     its own. The stages are handed over by mbarriers: full (each
//     producer thread's fence.proxy.async, then one arrival a warp) and
//     empty (one arrival a consumer warp); the stage the producers hand
//     over last says that no chunk is left (chunk_live 0) and is all 0;
//   - two consumer warpgroups each multiply 64 A rows by the 128 B rows
//     over the chunk with KC / 32 wgmma.mma_async m64n128k32 s32.s8.s8
//     from shared memory (the staged 0/1 rows are K-major on both sides,
//     the one layout 8-bit wgmma takes: tile = A * B^T), keeping 64 int32
//     sums a thread in registers across all the block's chunks
//     (mm_consumer), then add them into the output (mm_epilogue).
// So the staging of the next chunk overlaps the product of this one.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TM 128           // A rows and B rows of a block's output tile
#define KC 256           // vocabulary ids a chunk: two 128-byte swizzle atoms
#define STAGES 2         // 128 KB: the rest of the SM's 256 KB is L1, which holds the producers' rows
#define PRODUCERS 2      // warpgroups staging rows
#define CONSUMERS 2      // warpgroups multiplying, 64 A rows each
#define THREADS ((PRODUCERS + CONSUMERS) * 128)
#define ATOM_BYTES (TM * 128)  // one side's 128-byte-wide column of a chunk
#define SIDE_BYTES (TM * KC)
#define STAGE_SIZE (2 * SIDE_BYTES)              // A rows, then B rows
#define SMEM_BYTES (1024 + STAGES * STAGE_SIZE)  // 1024: room to align the stages
#define LOG_IDS 4        // ids a sparse producer logs a row and stage (in a register), to clear just their bytes

// the byte of (row, k) in one side of a stage: K-major, 128-byte swizzle
__device__ __forceinline__ uint32_t swizzled(int row, int k) {
  return (uint32_t)((k >> 7) * ATOM_BYTES + (row >> 3) * 1024 + (row & 7) * 128 +
                    ((((k >> 4) & 7) ^ (row & 7)) << 4) + (k & 15));
}

// the first byte of row `row`'s 128-byte line in one side's first atom
__device__ __forceinline__ uint32_t row_line(int row) {
  return (uint32_t)((row >> 3) * 1024 + (row & 7) * 128);
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(addr), "r"(0) : "memory");
}

// clear row t's two 128-byte lines of one side of a stage, piece q ^ t % 8
// of each line at step q: the 8 lanes of a store phase (rows t .. t + 7
// of one warp) then write 8 different bank groups, not one
__device__ __forceinline__ void clear_row(uint32_t side, int t) {
#pragma unroll
  for (int h = 0; h < KC / 128; ++h) {
    const uint32_t line = side + h * ATOM_BYTES + row_line(t);
#pragma unroll
    for (int q = 0; q < 8; ++q) st_shared_zero16(line + 16 * (q ^ (t & 7)));
  }
}

// wgmma's shared-memory descriptor of a K-major 128-byte-swizzled operand
// at shared address `addr`: 8-row groups 1024 bytes apart (the stride
// byte offset), the leading byte offset unused (1) for this layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ void st_shared_u8(uint32_t addr, int v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait for the phase of parity `parity` of the barrier to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the generic-proxy writes of this thread, visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The block's shared state besides the stages.
struct MmShared {
  uint64_t full_bar[STAGES], empty_bar[STAGES];
  int chunk_live[STAGES];  // 1: the stage holds a chunk; 0: none is left (the stage is all 0)
  int warp_min[2][2][4];   // the sparse walk's [jump parity][side][producer warp]
};

__device__ __forceinline__ uint32_t bar_addr(const uint64_t* bar) {
  return (uint32_t)__cvta_generic_to_shared(bar);
}

// Zero the stages and set up the barriers; returns the stages' shared
// address (1024-aligned: the swizzle pattern repeats every 1024 bytes).
__device__ __forceinline__ uint32_t mm_setup(uint8_t* smem_raw, MmShared& sh) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t stages = (raw + 1023) & ~1023u;
  int4* zero16 = reinterpret_cast<int4*>(smem_raw + (stages - raw));
  for (int i = threadIdx.x; i < STAGES * STAGE_SIZE / 16; i += THREADS) zero16[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_addr(&sh.full_bar[s]), 4 * PRODUCERS);
      mbar_init(bar_addr(&sh.empty_bar[s]), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async_shared();
  __syncthreads();
  return stages;
}

// A producer warp hands stage S over: its threads' writes made visible to
// wgmma, then one arrival a warp (the arrivals on one barrier are
// serialised).
__device__ __forceinline__ void mm_hand_over(MmShared& sh, int s) {
  fence_async_shared();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar_addr(&sh.full_bar[s]));
}

// ---- the sparse walk: one row a producer thread ----------------------
// Thread t of the first producer warpgroup owns A row t of the tile, of
// the second B row t, each with a cursor into its sorted row (read through
// L1, the line ahead prefetched), so a row's ids are read once per tile.
// The walk stands at one chunk at a time: where both sides have ids in it
// (an OR over the producers, one barrier a side) each thread clears in the
// next free stage the bytes it set there STAGES chunks ago (up to LOG_IDS
// logged in a register, else its row's whole lines) and scatters the
// chunk's ids as 1 bytes; where a side has none, the walk jumps to the
// chunk of the larger of the two sides' next ids, past the other side's
// ids in between (they meet nothing). What bounds it: each cursor step is
// a dependent load, and a warp waits on it for all its lanes.

// A producer thread's row, read at its cursor through L1: each load is a
// dependent one (the cursor moves on what it reads), so the line 32 ids
// ahead is prefetched into L1 when the cursor enters a new 32 ids.
struct RowStream {
  const int32_t* row;
  int cur;  // the cursor
  int nxt;  // the id at the cursor, INT_MAX past the row's end
};

__device__ __forceinline__ void prefetch_l1(const int32_t* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__device__ __forceinline__ void stream_start(RowStream& s, const int32_t* __restrict__ row, int cur, int width) {
  s.row = row;
  s.cur = cur;
  if (cur + 32 < width) prefetch_l1(row + cur + 32);
  s.nxt = cur < width ? __ldg(row + cur) : INT_MAX;
}

__device__ __forceinline__ void stream_advance(RowStream& s, int width) {
  const int c = ++s.cur;
  if ((c & 31) == 0 && c + 32 < width) prefetch_l1(s.row + c + 32);
  s.nxt = c < width ? __ldg(s.row + c) : INT_MAX;
}

// (bar.sync and bar.red are .aligned: each warp must reach them
// converged, which its lanes' walks may have undone)
__device__ __forceinline__ void producer_sync() {
  __syncwarp();
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// whether v holds on any producer thread (a barrier of the producers' 256 threads)
__device__ __forceinline__ bool producer_any(bool v) {
  uint32_t r;
  __syncwarp();
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, 256, q;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(r)
      : "r"((uint32_t)v)
      : "memory");
  return r != 0;
}

// The producer thread's state: its row (A row t, or B row t, of the tile),
// the chunk the walk stands at (the same on every producer thread), and
// what it set in each stage: up to LOG_IDS byte offsets, or a count past
// them (then it clears the row's whole lines).
struct Producer {
  RowStream rs;
  uint32_t log[STAGES];
  int n_set[STAGES];
  int base, phase, jumps;
  int side, t, lane, warp, width, hi_id;
  uint32_t stages;
};

// the smallest next id of the A rows and of the B rows: one barrier
__device__ __forceinline__ void producer_min(const Producer& p, int (&slot)[2][4], int& next_a, int& next_b) {
  const int m = __reduce_min_sync(0xffffffffu, p.rs.nxt);
  if (p.lane == 0) slot[p.side][p.warp & 3] = m;
  producer_sync();
  next_a = min(min(slot[0][0], slot[0][1]), min(slot[0][2], slot[0][3]));
  next_b = min(min(slot[1][0], slot[1][1]), min(slot[1][2], slot[1][3]));
}

// clear the bytes this thread set in stage S's last chunk
template <int S>
__device__ __forceinline__ void clear_stage(const Producer& p, uint32_t rows) {
  const int n = p.n_set[S];
  if (n > LOG_IDS) {
    clear_row(rows, p.t);
  } else {
#pragma unroll
    for (int k = 0; k < LOG_IDS; ++k)
      if (k < n) st_shared_u8(rows + swizzled(p.t, (p.log[S] >> (8 * k)) & 255), 0);
  }
}

// Produce the next chunk both sides of the tile touch into stage S; false
// (after handing the consumers stage S, cleared, marked empty) when none
// is left.
template <int S>
__device__ __forceinline__ bool produce(Producer& p, MmShared& sh) {
  const uint32_t rows = p.stages + S * STAGE_SIZE + p.side * SIDE_BYTES;
  int end = 0;
  bool live = false;
  while (p.base < p.hi_id) {
    end = min(p.base + KC, p.hi_id);
    // the common case: both sides have ids in the chunk the walk stands at
    const bool here = p.rs.nxt < end;
    if (producer_any(here && p.side == 0) && producer_any(here && p.side == 1)) {
      live = true;
      break;
    }
    // else jump to the chunk of the larger of the two sides' next ids: the
    // ids of the other side below it meet nothing
    int next_a, next_b;
    producer_min(p, sh.warp_min[p.jumps++ & 1], next_a, next_b);
    const int lo = max(next_a, next_b);
    if (lo >= p.hi_id) break;
    p.base = lo - lo % KC;
    while (p.rs.nxt < p.base) stream_advance(p.rs, p.width);
  }
  mbar_wait(bar_addr(&sh.empty_bar[S]), p.phase ^ 1);
  clear_stage<S>(p, rows);
  int n = 0;
  uint32_t log = 0;
  if (live) {
    while (p.rs.nxt < end) {
      const int k = p.rs.nxt - p.base;
      st_shared_u8(rows + swizzled(p.t, k), 1);
      if (n < LOG_IDS) log |= (uint32_t)k << (8 * n);
      ++n;
      stream_advance(p.rs, p.width);
    }
    p.base += KC;
  }
  p.n_set[S] = min(n, LOG_IDS + 1);
  p.log[S] = log;
  if (p.side == 0 && p.t == 0) sh.chunk_live[S] = live;
  mm_hand_over(sh, S);
  return live;
}

// The sparse walk of a producer thread (warps 0 .. 4 PRODUCERS - 1) over
// ids [lo_id, hi_id): A rows a_row0 .. a_row0 + TM - 1 of `a` (a_rows
// rows), B rows b_row0 .. of `b` (b_rows rows), both `width` ids a row;
// rows at or past a side's row count read as empty.
__device__ __forceinline__ void mm_sparse_producer(MmShared& sh, uint32_t stages, const int32_t* __restrict__ a,
                                                   int a_row0, int a_rows, const int32_t* __restrict__ b,
                                                   int b_row0, int b_rows, int width, int lo_id, int hi_id) {
  static_assert(STAGES == 2, "the producers' loop below names each stage");
  Producer p;
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  p.side = p.warp >> 2;
  p.t = threadIdx.x & 127;
  p.width = width;
  p.hi_id = hi_id;
  p.stages = stages;
  p.base = lo_id;
  p.phase = 0;
  p.jumps = 0;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    p.log[s] = 0;
    p.n_set[s] = 0;
  }
  const int r = (p.side == 0 ? a_row0 : b_row0) + p.t;
  const bool held = r < (p.side == 0 ? a_rows : b_rows);
  const int32_t* row = (p.side == 0 ? a : b) + (int64_t)(held ? r : 0) * width;
  stream_start(p.rs, row, held ? lower_bound(row, width, lo_id) : width, width);
  while (produce<0>(p, sh) && produce<1>(p, sh)) {
    p.phase ^= 1;
  }
}

// ---- the consumers ----------------------------------------------------

#define ACC8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] += A (64 x 32, desc_a) * B (128 x 32, desc_b)^T, int8 in, int32 sums
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: add to the sums
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// keep the compiler from moving register accesses across the async products
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A consumer warpgroup g (warps 4 PRODUCERS + 4 g ..): A rows 64 g .. 64 g
// + 63 of the tile against its 128 B rows, summed into d over every chunk
// handed over, until the stage that says none is left. The B rows are
// `b_off` bytes into a stage: SIDE_BYTES, or 0 where both operands are the
// staged A rows (a diagonal tile).
__device__ __forceinline__ void mm_consumer(MmShared& sh, uint32_t stages, uint32_t b_off, int (&d)[64]) {
  const int g = (int)(threadIdx.x >> 7) - PRODUCERS;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  int stage = 0, phase = 0;
  while (true) {
    mbar_wait(bar_addr(&sh.full_bar[stage]), phase);
    const uint32_t st = stages + stage * STAGE_SIZE;
    // the products start before the stage's flag is read (the stage that
    // says no chunk is left is all 0, so its products add nothing)
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < KC / 32; ++s) {
      // k = 32 s: the swizzle atom s / 4, 32 (s % 4) bytes into its rows
      const uint32_t k_off = (s >> 2) * ATOM_BYTES + (s & 3) * 32;
      wgmma_m64n128k32(d, gmma_desc(st + g * 8 * 1024 + k_off), gmma_desc(st + b_off + k_off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    const int live = sh.chunk_live[stage];
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(bar_addr(&sh.empty_bar[stage]));
    if (!live) break;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The sums into out [rows, cols] (row-major, `ld` ints a row), added over
// the vocabulary splits: value v of a consumer thread is row 16 w + lane /
// 4 + 8 ((v >> 1) & 1) of its 64, column 8 (v >> 2) + 2 (lane % 4) + (v &
// 1); the tile's rows start at row0, its columns at col0. With `mirror`
// (a square out, rows == cols == ld), each sum is also added at the
// transposed place.
__device__ __forceinline__ void mm_epilogue(const int (&d)[64], int32_t* __restrict__ out, int rows, int cols,
                                            int ld, int row0, int col0, bool mirror) {
  const int g = (int)(threadIdx.x >> 7) - PRODUCERS;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 64; ++v) {
    const int ri = row0 + 64 * g + 16 * w + (lane >> 2) + 8 * ((v >> 1) & 1);
    const int cj = col0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    if (ri < rows && cj < cols && d[v] != 0) {
      atomicAdd(out + (int64_t)ri * ld + cj, d[v]);
      if (mirror) atomicAdd(out + (int64_t)cj * ld + ri, d[v]);
    }
  }
}

// The vocabulary splits of each output tile over n_chunks chunks: `want`
// of them (at least 1), each at least min_chunks chunks where there are
// that many; every split non-empty. Returns the splits, and the chunks a
// split in *per_split.
static inline int mm_splits(int want, int n_chunks, int min_chunks, int* per_split) {
  const int most = n_chunks / min_chunks > 1 ? n_chunks / min_chunks : 1;
  const int splits = want < 1 ? 1 : want < most ? want : most;
  *per_split = (n_chunks + splits - 1) / splits;
  return (n_chunks + *per_split - 1) / *per_split;
}
