"""Host-side range partitioning of sorted sketch-id rows.

Counterpart of drep_tpu/ops/rangepart.py. Intersection counts are
additive over disjoint id ranges:

    |A ∩ B| = Σ_r |A ∩ [b_r, b_{r+1}) ∩ B|

so a row too wide for one kernel call splits into narrow buckets whose
counts sum. Two callers:

- the merge-intersect kernel (ops/intersect.py) caps the row width at
  PALLAS_MAX_WIDTH: :func:`stacked_range_buckets` repacks every row into
  R shared id-range buckets of one common width, one [R, N, W] tensor;
- the vocabulary-chunked matmul (ops/containment.py) caps the indicator
  width: its chunks reuse :func:`bucket_starts` and :func:`repack_bucket`;
- the federated index's boundary join (index/federation.py) bands the
  raw uint64 bottom hashes into a shared code space
  (:func:`hash_code_matrix`) and range-shards it with
  :func:`partition_by_range`; every federated publish writes one routing
  bitmap a partition (:func:`code_summary_bitmap`), which the serving
  resident and the fleet router consult (:func:`bitmap_contains_any`).

Rows hold distinct sorted ids (sketches are sets), so a bucket covering
`w` consecutive ids holds at most `w` entries a row and the adaptive
splitter terminates. All of it is numpy on the host; the layouts (dtype,
bucket set, width) are byte-identical to the JAX package's.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, next_pow2, pad_sentinel

MIN_BUCKET_WIDTH = 128  # never repack below one 128-wide row

# raw uint64 sketch hashes -> int32 band codes: drop 34 low bits, so the
# code space is 2^30 (< PAD_ID: the pad can never collide with a code).
# The map is monotone and many-to-one: two sketches sharing a hash share
# its code (the boundary join's recall), distinct hashes may share one
# (paid in candidates only).
HASH_CODE_SHIFT = 34

# the routing summary's coarse code space: the top 16 bits of a raw hash
# (a further coarsening of the band code), one 8 KiB bitmap a partition
ROUTE_SUMMARY_BITS = 16


def hash_code_matrix(hash_rows: list[np.ndarray], shift: int = HASH_CODE_SHIFT) -> np.ndarray:
    """Sorted uint64 hash rows (raw bottom sketches) -> one [N, W] int32
    PAD-padded matrix of each row's distinct sorted band codes: the
    layout :func:`partition_by_range` shards. Packed ids are ranks local
    to one pack, so two partitions can only be joined on raw hashes."""
    n = len(hash_rows)
    codes = [np.unique((np.asarray(r, np.uint64) >> np.uint64(shift)).astype(np.int32)) for r in hash_rows]
    width = max((len(c) for c in codes), default=0)
    out = np.full((n, max(1, width)), PAD_ID, dtype=np.int32)
    for i, c in enumerate(codes):
        out[i, : len(c)] = c
    return out


def coarse_codes(hash_row: np.ndarray, bits: int = ROUTE_SUMMARY_BITS) -> np.ndarray:
    """The distinct sorted coarse codes (top `bits` bits) of one raw
    uint64 hash row."""
    return np.unique((np.asarray(hash_row, np.uint64) >> np.uint64(64 - bits)).astype(np.int64))


def code_summary_bitmap(hash_rows: list[np.ndarray], bits: int = ROUTE_SUMMARY_BITS) -> np.ndarray:
    """A packed uint64 bitmap over the 2^bits coarse codes with a bit set
    for every code present in any of `hash_rows`: a partition's routing
    summary, exact (a superset test, no false negatives)."""
    bm = np.zeros((1 << bits) >> 6, np.uint64)
    for r in hash_rows:
        c = coarse_codes(r, bits)
        np.bitwise_or.at(bm, c >> 6, np.left_shift(np.uint64(1), (c & 63).astype(np.uint64)))
    return bm


def bitmap_contains_any(bitmap: np.ndarray, codes: np.ndarray) -> bool:
    """Does the summary bitmap hold any of the (distinct int64) coarse
    codes? The per-(query, partition) consult decision of the serving
    resident and the fleet router."""
    if not len(codes):
        return False
    codes = np.asarray(codes, np.int64)
    hits = bitmap[codes >> 6] & np.left_shift(np.uint64(1), (codes & 63).astype(np.uint64))
    return bool(np.any(hits != 0))


def vocab_extent(ids: np.ndarray) -> int:
    """1 + the largest real id in a packed matrix (0 when all padding). A
    uint16 pack uses its own pad sentinel."""
    valid = ids != pad_sentinel(ids.dtype)
    return int(ids[valid].max()) + 1 if valid.any() else 0


def _vocab_extent(mats: list[np.ndarray]) -> int:
    return max((vocab_extent(m) for m in mats), default=0)


def bucket_starts(ids: np.ndarray, chunk: int, n_buckets: int) -> np.ndarray:
    """int64 [N, n_buckets+1]: starts[i, r] is the index of row i's first
    element >= r*chunk, so bucket r spans starts[:, r]..starts[:, r+1].
    Rows are sorted with PAD_ID (>= every boundary) at the tail, so one
    searchsorted per row over the few boundaries does it."""
    bounds = np.minimum(np.arange(1, n_buckets + 1, dtype=np.int64) * chunk, PAD_ID)
    starts = np.empty((ids.shape[0], n_buckets + 1), dtype=np.int64)
    starts[:, 0] = 0
    for i in range(ids.shape[0]):
        starts[i, 1:] = np.searchsorted(ids[i], bounds, side="left")
    return starts


def bucket_histogram(ids: np.ndarray, chunk: int, n_buckets: int) -> np.ndarray:
    """Per-row element counts for equal-width id ranges."""
    return np.diff(bucket_starts(ids, chunk, n_buckets), axis=1)


def repack_bucket(
    ids: np.ndarray, starts: np.ndarray, cnt: np.ndarray, width: int, rebase: int = 0
) -> np.ndarray:
    """One range bucket as a fresh [N, width] PAD-padded int32 matrix:
    row i's contiguous slice starts[i]..starts[i]+cnt[i], minus `rebase`."""
    n = ids.shape[0]
    out = np.full((n, width), PAD_ID, dtype=np.int32)
    total = int(cnt.sum())
    if total == 0:
        return out
    rows = np.repeat(np.arange(n), cnt)
    offs = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    local = np.arange(total) - np.repeat(offs, cnt)
    src_col = np.repeat(starts, cnt) + local
    out[rows, local] = ids[rows, src_col] - rebase
    return out


def _check_max_count(max_count: int) -> None:
    if max_count < MIN_BUCKET_WIDTH:
        raise ValueError(f"max_count {max_count} below the minimum bucket width {MIN_BUCKET_WIDTH}")
    if max_count & (max_count - 1):
        # widths are pow2-bucketed, so a non-pow2 bound would be exceeded
        raise ValueError(f"max_count {max_count} must be a power of two")


def partition_by_range(
    mats: list[np.ndarray], max_count: int, rebase: bool = False
) -> Iterator[tuple[int, list[np.ndarray]]]:
    """Split sorted PAD-padded id matrices into shared disjoint id-range
    buckets, each repacked to a pow2 width <= max_count. Yields
    (chunk_origin, [bucket matrix per input]) for every non-empty bucket."""
    _check_max_count(max_count)
    vocab = _vocab_extent(mats)
    if vocab == 0:
        return
    chunk, starts, hists, keep, _width = _stacked_plan(mats, max_count, vocab=vocab)
    for r in keep:
        counts_r = [h[:, r] for h in hists]
        width = max(MIN_BUCKET_WIDTH, next_pow2(max(int(c.max()) for c in counts_r)))
        yield (
            r * chunk,
            [
                repack_bucket(m, s[:, r], c, width, rebase=r * chunk if rebase else 0)
                for m, s, c in zip(mats, starts, counts_r)
            ],
        )


def _stacked_plan(
    mats: list[np.ndarray],
    max_count: int,
    min_buckets: int = 1,
    vocab: int | None = None,
    longest: int | None = None,
):
    """Bucket plan (chunk, starts, hists, kept bucket ids, common width)
    without materializing it, so plans can be compared by bytes. The
    bucket count starts at longest/max_count and doubles until every
    row's bucket count fits."""
    if longest is None:
        longest = max(int((m != PAD_ID).sum(axis=1).max()) for m in mats)
    if vocab is None:
        vocab = _vocab_extent(mats)
    n_buckets = max(min_buckets, next_pow2(-(-longest // max_count)), 1)
    while True:
        chunk = -(-vocab // n_buckets)
        starts = [bucket_starts(m, chunk, n_buckets) for m in mats]
        hists = [np.diff(s, axis=1) for s in starts]
        worst = max(int(h.max()) for h in hists)
        if worst <= max_count or chunk <= max_count:
            break
        n_buckets *= 2
    keep = [r for r in range(n_buckets) if any(int(h[:, r].max()) > 0 for h in hists)]
    width = max(MIN_BUCKET_WIDTH, next_pow2(worst))
    return chunk, starts, hists, keep, width


def _materialize_stacked(mats, chunk, starts, hists, keep, width, dtype):
    out = []
    rebase = dtype == np.uint16  # uint16 holds per-bucket local values
    pad = pad_sentinel(dtype)
    for m, s, h in zip(mats, starts, hists):
        stacked = np.full((len(keep), m.shape[0], width), pad, dtype)
        for o, r in enumerate(keep):
            b = repack_bucket(m, s[:, r], h[:, r], width, rebase=r * chunk if rebase else 0)
            if rebase:
                stacked[o] = np.where(b == PAD_ID, U16_PAD, b).astype(np.uint16)
            else:
                stacked[o] = b
        out.append(stacked)
    return out


def stacked_range_buckets(mats: list[np.ndarray], max_count: int) -> list[np.ndarray]:
    """The range partition as ONE [R, N_i, W] tensor per input at a common
    pow2 width W <= max_count: all buckets cross to the device in one copy
    and run in one kernel launch. Buckets empty in every input are dropped.

    Two plans are compared by bytes and the smaller ships: int32 with
    global ids, or uint16 with per-bucket rebased ids and a 0xFFFF pad
    (chunks forced below 2^16 — more, narrower buckets). The kernel
    wrapper widens uint16 on the device.
    """
    _check_max_count(max_count)
    vocab = _vocab_extent(mats)
    if vocab == 0:
        return [np.full((0, m.shape[0], MIN_BUCKET_WIDTH), PAD_ID, np.int32) for m in mats]
    longest = max(int((m != PAD_ID).sum(axis=1).max()) for m in mats)
    plan32 = _stacked_plan(mats, max_count, vocab=vocab, longest=longest)
    # when plan32's chunk already fits 16 bits the uint16 plan IS plan32
    min_b = max(1, next_pow2(-(-vocab // 0xFFFF)))
    plan16 = (
        plan32
        if plan32[0] <= 0xFFFF
        else _stacked_plan(mats, max_count, min_buckets=min_b, vocab=vocab, longest=longest)
    )
    if plan16[0] <= 0xFFFF and len(plan16[3]) * plan16[4] * 2 < len(plan32[3]) * plan32[4] * 4:
        return _materialize_stacked(mats, *plan16, np.uint16)
    return _materialize_stacked(mats, *plan32, np.int32)
