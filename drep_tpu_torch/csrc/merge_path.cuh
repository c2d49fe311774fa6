// Warp-cooperative merge-path walks over two ascending PAD_ID-padded int32
// id rows, shared by csrc/mash_shared.cu, csrc/intersect.cu and
// csrc/ring_step.cu (through csrc/pair_block.cuh).
//
// One warp takes one pair. The merged sequence of the pair's real ids
// (a[0, la) ++ b[0, lb), la and lb counting the non-PAD ids) is cut into
// equal shares, one per lane: each lane finds where its share starts by a
// binary search along its diagonal of the merge path (merge_path_split),
// then merges its share serially with selects, one shared-memory load a
// step. A lane compares its first element with the previous lane's last
// (__shfl_up_sync), so a run of equal ids that straddles a split is counted
// whole. Equal ids are adjacent in the merge whichever side a tie takes,
// so no count depends on how ties split; the search and the merge still
// use one rule (A first on ties), so the shares tile the sequence exactly.
//
// The rows are read at 32-bit shared-space addresses: a block's staged
// rows, or a warp's window of them (mash_shared.cu's wide rows). A walk
// keeps only its A position and the sum of both (which grows by one id a
// step), so a step is a compare, a select of the address and one load.
// a[la] and b[lb] must be readable (PAD_ID or a sentinel slot).

#pragma once

#include <stdint.h>

#ifndef PAD_ID
#define PAD_ID 0x7FFFFFFF
#endif
#define FULL_MASK 0xffffffffu

// Copy `rows` rows of `width` ids (global pitch `width`) into shared rows
// of pitch `stride` (a multiple of 4, > width), PAD_ID in [width, stride);
// the block's threads take consecutive 16-byte pieces, with one 16-byte
// load each where `vec` (width % 4 == 0 and src 16-byte aligned).
__device__ __forceinline__ void stage_rows(int32_t* dst, const int32_t* __restrict__ src, int rows,
                                           int width, int stride, bool vec) {
  const int q = stride >> 2;
  for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
    const int r = idx / q;
    const int c = (idx - r * q) << 2;
    const int32_t* s = src + (int64_t)r * width + c;
    int4 v;
    if (vec && c + 4 <= width) {
      v = __ldg(reinterpret_cast<const int4*>(s));
    } else {
      v.x = c < width ? __ldg(s) : PAD_ID;
      v.y = c + 1 < width ? __ldg(s + 1) : PAD_ID;
      v.z = c + 2 < width ? __ldg(s + 2) : PAD_ID;
      v.w = c + 3 < width ? __ldg(s + 3) : PAD_ID;
    }
    *reinterpret_cast<int4*>(dst + (int64_t)r * stride + c) = v;
  }
}

// The real (non-PAD) ids of an ascending PAD_ID-padded row: the index of
// its first PAD_ID, by binary search.
__device__ __forceinline__ int real_len(const int32_t* row, int width) {
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool pad = row[mid] == PAD_ID;
    lo = pad ? lo : mid + 1;
    hi = pad ? mid : hi;
  }
  return lo;
}

// The shared-memory pitch of a staged row of `width` ids: a multiple of 4
// (16-byte stores) with at least one PAD_ID slot after the row, so a[la]
// is readable when la == width.
__host__ __device__ __forceinline__ int staged_pitch(int width) { return (width + 4) & ~3; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// One id from shared memory at a 32-bit shared-space byte address (the
// walks keep their positions as such addresses, so a step's load needs
// no base added).
__device__ __forceinline__ int lds(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t shared_addr(const int32_t* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The A ids among the first d merged elements (A first on ties) of the
// rows at shared addresses a and b, searched in [lo, hi]: the largest i
// there with a[i - 1] <= b[d - i]. Callers pass lo >= max(0, d - lb) and
// hi <= min(d, la), so every probe is in range.
__device__ __forceinline__ int merge_path_split(uint32_t a, uint32_t b, int d, int lo, int hi) {
  b += 4u * (d - 1);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool more = lds(a + 4u * mid) <= lds(b - 4u * mid);
    lo = more ? mid + 1 : lo;
    hi = more ? hi : mid;
  }
  return lo;
}

// One merge step from the heads va (at address pa) and vb (at pb), where
// pa + pb == sum before the step: returns the smaller and advances past
// it, loading the next head of that side (one load, its address chosen by
// a select). Only pa is kept: pb follows from the sum, which grows by 4
// a step.
__device__ __forceinline__ int merge_step(uint32_t& pa, uint32_t sum, int& va, int& vb) {
  const bool ta = va <= vb;
  const int v = min(va, vb);
  if (ta) pa += 4u;
  const uint32_t pb = sum + 4u - pa;
  const int nx = lds(ta ? pa : pb);
  va = ta ? nx : va;
  vb = ta ? vb : nx;
  return v;
}

// Merge-intersect count of one pair by one warp: the adjacent equal ids of
// the merge of the rows at shared addresses a (la real ids) and b (lb) —
// for rows of distinct ids |A ∩ B|; a run of p copies in A and q in B
// counts p + q - 1. Every lane returns it.
__device__ __forceinline__ int warp_merge_dups(uint32_t a, int la, uint32_t b, int lb, int lane) {
  const int len = la + lb;
  const int share = (len + 31) >> 5;
  const int d = min(lane * share, len);
  const int n = min(share, len - d);
  const int i = merge_path_split(a, b, d, max(0, d - lb), min(d, la));
  uint32_t pa = a + 4u * i;
  uint32_t sum = pa + b + 4u * (d - i);
  int va = lds(pa), vb = lds(sum - pa);
  int first = 0, last = 0, dups = 0;
  if (n > 0) {
    first = merge_step(pa, sum, va, vb);
    sum += 4u;
    last = first;
#pragma unroll 4
    for (int k = 1; k < n; ++k) {
      const int v = merge_step(pa, sum, va, vb);
      sum += 4u;
      dups += v == last;
      last = v;
    }
  }
  // the previous lane's last element; a lane with a share has a full
  // previous lane
  const int before = __shfl_up_sync(FULL_MASK, last, 1);
  dups += lane > 0 && n > 0 && first == before;
  return warp_sum(dups);
}

// n <= E merge steps from the heads at pa and sum - pa: bit k of `dup`
// (k >= 1) set where the k-th merged id equals the one before; the first
// and last ids. FULL (n == E, every lane but the last round's tail) walks
// without a bound check on k.
template <int E, bool FULL>
__device__ __forceinline__ void merge_share(uint32_t& pa, uint32_t sum, int n, unsigned& dup, int& first,
                                            int& last) {
  int va = lds(pa), vb = lds(sum - pa);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (FULL || k < n) {
      const int v = merge_step(pa, sum + 4u * k, va, vb);
      if (k == 0) {
        first = v;
      } else if (v == last) {
        dup |= 1u << k;
      }
      last = v;
    }
  }
}

// Union-bottom-s Mash shared count of one pair by one warp: the duplicates
// of the merge whose distinct rank is <= s_use (s_use > 0) — the ids
// present in both rows among the bottom-s_use distinct ids of the union.
// The merge is walked in rounds of 32 x E elements, each lane merging E of
// them; a warp scan of the lanes' distinct counts gives each lane its
// starting rank, and the walk stops after the round whose end passes
// s_use (every later duplicate ranks past it). Rounds, not one split at
// 2 s_use, keep the count exact for in-row repeats.
//
// window(i0, j0, ra, rb, a, b) sets the shared addresses a and b of A id
// i0 and B id j0, where a round starts with ra and rb real ids left; each
// must read 32 E + 1 ids from there (PAD_ID past the real ones).
template <int E, typename Window>
__device__ __forceinline__ int warp_mash_shared(int la, int lb, int s_use, int lane, Window window) {
  static_assert(E >= 1 && E <= 32, "E elements a lane a round, one bit each");
  constexpr int R = 32 * E;
  const int len = la + lb;
  int round0 = 0, i0 = 0;  // the round's first merged position and its A ids before it
  int rank = 0;            // distinct ids before round0
  int carry = 0;           // the element at round0 - 1 (round0 > 0)
  int shared = 0;
  while (round0 < len && rank <= s_use) {
    const int j0 = round0 - i0;
    const int ra = la - i0, rb = lb - j0;
    uint32_t a, b;
    window(i0, j0, ra, rb, a, b);
    const int rlen = min(R, ra + rb);
    const int d = min(lane * E, rlen);
    const int n = min(E, rlen - d);
    const int i = merge_path_split(a, b, d, max(0, d - rb), min(d, ra));
    uint32_t pa = a + 4u * i;
    const uint32_t sum = pa + b + 4u * (d - i);
    unsigned dup = 0;
    int first = 0, last = 0;
    if (n == E) {
      merge_share<E, true>(pa, sum, n, dup, first, last);
    } else {
      merge_share<E, false>(pa, sum, n, dup, first, last);
    }
    int before = __shfl_up_sync(FULL_MASK, last, 1);
    if (lane == 0) before = carry;
    if (n > 0 && (lane > 0 || round0 > 0) && first == before) dup |= 1u;
    const unsigned live = n >= 32 ? FULL_MASK : (1u << n) - 1u;
    const unsigned distinct = live & ~dup;
    const int cnt = __popc(distinct);
    int incl = cnt;  // inclusive warp scan of the lanes' distinct counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    const int base = rank + incl - cnt;  // distinct ids before this lane's share
    if (base + cnt <= s_use) {
      shared += __popc(dup);  // every duplicate here ranks within s_use
    } else if (base <= s_use) {
      int cum = base;  // the lane where the rank crosses s_use
#pragma unroll
      for (int k = 0; k < E; ++k) {
        cum += (distinct >> k) & 1u;
        shared += ((dup >> k) & 1u) && cum <= s_use;
      }
    }
    rank += __shfl_sync(FULL_MASK, incl, 31);
    carry = __shfl_sync(FULL_MASK, last, 31);  // lane 31 merged a full share unless this was the last round
    i0 += __shfl_sync(FULL_MASK, (int)(pa - a) >> 2, 31);
    round0 += R;
  }
  return warp_sum(shared);
}

// The first position of an ascending row of n ids (generic address, in
// shared or global memory) holding an id >= x, found by the whole warp:
// each pass, the 32 lanes probe 32 evenly spaced positions, so a pass
// cuts the range 32-fold. Every lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int32_t* row, int n, int x, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned below = __ballot_sync(FULL_MASK, row[pos] < x);
    const int c = __popc(below);  // the lanes whose probe is below x: a prefix
    const int new_lo = c == 0 ? lo : min(lo + c * step, hi);
    hi = c == 32 ? hi : min(lo + (c + 1) * step - 1, hi - 1);
    lo = new_lo;
  }
  return lo;
}

// Contained count of one pair by one warp: the A ids (each copy) that
// occur in B — the JAX _pair_intersection. With A first on ties, the B
// head when a step takes an A id va is the first B id >= va, so the step
// counts va == vb: a test local to the step (no join across lanes), exact
// for repeats on either side. The merge ends after A's last real id: B is
// cut at lb, the B ids below it, and b[lb] — the real next B id or PAD —
// is read only as a head. a[la] must be readable. Every lane returns it.
__device__ __forceinline__ int warp_contained(uint32_t a, int la, uint32_t b, int lb, int lane) {
  const int len = la + lb;
  const int share = (len + 31) >> 5;
  const int d = min(lane * share, len);
  const int n = min(share, len - d);
  const int i = merge_path_split(a, b, d, max(0, d - lb), min(d, la));
  uint32_t pa = a + 4u * i;
  uint32_t sum = pa + b + 4u * (d - i);
  int va = lds(pa), vb = lds(sum - pa);
  int hits = 0;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    hits += va == vb;
    merge_step(pa, sum, va, vb);
    sum += 4u;
  }
  return warp_sum(hits);
}

// n <= E contained steps from the heads at pa and sum - pa; FULL walks
// without a bound check on k.
template <int E, bool FULL>
__device__ __forceinline__ int contained_share(uint32_t& pa, uint32_t sum, int n) {
  int va = lds(pa), vb = lds(sum - pa);
  int hits = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (FULL || k < n) {
      hits += va == vb;
      merge_step(pa, sum + 4u * k, va, vb);
    }
  }
  return hits;
}

// warp_contained in rounds of 32 x E merged ids, for rows read through
// per-warp windows: window(i0, j0, a, b) sets the shared addresses a and
// b of A id i0 and B id j0, each reading 32 E + 1 ids from there (for B
// the row's real ids past lb, then PAD; for A PAD past la).
template <int E, typename Window>
__device__ __forceinline__ int warp_contained_rounds(int la, int lb, int lane, Window window) {
  constexpr int R = 32 * E;
  const int len = la + lb;
  int round0 = 0, i0 = 0, hits = 0;
  while (round0 < len) {
    const int j0 = round0 - i0;
    const int ra = la - i0, rb = lb - j0;
    uint32_t a, b;
    window(i0, j0, a, b);
    const int rlen = min(R, ra + rb);
    const int d = min(lane * E, rlen);
    const int n = min(E, rlen - d);
    const int i = merge_path_split(a, b, d, max(0, d - rb), min(d, ra));
    uint32_t pa = a + 4u * i;
    const uint32_t sum = pa + b + 4u * (d - i);
    hits += n == E ? contained_share<E, true>(pa, sum, n) : contained_share<E, false>(pa, sum, n);
    i0 += __shfl_sync(FULL_MASK, (int)(pa - a) >> 2, 31);  // lane 31 ends the round unless it is the last
    round0 += R;
  }
  return warp_sum(hits);
}
