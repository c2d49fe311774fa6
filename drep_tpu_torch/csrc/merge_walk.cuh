// Per-pair walks over two ascending PAD_ID-padded int32 id rows, used by
// csrc/ring_step.cu. One thread walks one pair; the
// A row is read from shared memory, the B row through L1 (__ldg). The A
// row may arrive in pieces (ring_step.cu stages it a piece at a time): each
// walk keeps its state between pieces and says when it is done.

#pragma once

#include <stdint.h>

#define PAD_ID 0x7FFFFFFF

// Union-bottom-s Mash shared count: the ids present in BOTH rows among the
// bottom-s_use distinct ids of their union (s_use > 0). Bit-identical to
// ops/mash.py::mash_shared_plain (sort the concatenated pair, flag
// duplicates, cumsum the distinct rank, count the duplicates within s_use).
struct MashWalk {
  int i = 0, j = 0, rank = 0, shared = 0, prev = 0;
  bool started = false;
};

// Walk on with A ids [c0, c0 + len) staged in a_piece. True when the walk
// is done; false when it needs the next piece.
__device__ __forceinline__ bool mash_walk_piece(MashWalk& w, const int32_t* a_piece, int c0, int len,
                                                const int32_t* __restrict__ brow, int width, int s_use) {
  const int end = c0 + len;
  while (true) {
    int va;
    if (w.i < end) {
      va = a_piece[w.i - c0];
    } else if (w.i >= width) {
      va = PAD_ID;
    } else {
      return false;
    }
    const int vb = w.j < width ? __ldg(brow + w.j) : PAD_ID;
    int v;
    if (va <= vb) {
      v = va;
      ++w.i;
    } else {
      v = vb;
      ++w.j;
    }
    if (v == PAD_ID) return true;  // both rows exhausted (pads sort last)
    if (w.started && v == w.prev) {
      // a duplicate shares the distinct rank of its first occurrence
      if (w.rank <= s_use) ++w.shared;
    } else {
      ++w.rank;
      if (w.rank > s_use) return true;  // later duplicates all rank past s_use
      w.prev = v;
      w.started = true;
    }
  }
}

// The non-PAD positions of the A row whose value occurs in the B row — the
// definition of drep_tpu/ops/containment.py::_pair_intersection (a
// searchsorted of every A element into B). A repeated A element counts once
// per copy; for the unique dense ranks of a scaled pack it is |A ∩ B|.
struct ContainedWalk {
  int j = 0, vb = PAD_ID, count = 0;
};

__device__ __forceinline__ void contained_walk_start(ContainedWalk& w, const int32_t* __restrict__ brow,
                                                     int width) {
  w.vb = width > 0 ? __ldg(brow) : PAD_ID;
}

// Walk on with the next len A ids staged in a_piece. True when the walk is
// done: A reached its padding, or B is exhausted and nothing more matches.
__device__ __forceinline__ bool contained_walk_piece(ContainedWalk& w, const int32_t* a_piece, int len,
                                                     const int32_t* __restrict__ brow, int width) {
  for (int i = 0; i < len; ++i) {
    const int va = a_piece[i];
    if (va == PAD_ID) return true;
    while (w.vb < va) {  // stops at the first PAD: PAD_ID is the largest int32
      ++w.j;
      w.vb = w.j < width ? __ldg(brow + w.j) : PAD_ID;
    }
    if (w.vb == PAD_ID) return true;
    w.count += w.vb == va;
  }
  return false;
}
