"""LSH-banded candidate pruning for the streaming primary.

Counterpart of drep_tpu/ops/lsh.py. A banding pass over the packed
sketch matrix (the int32 rank layout of ops/minhash.pack_sketches) plus
a host-side bucket join produce the CANDIDATE pairs — every pair that
could survive the streaming primary's retention bound — and the stripe
walk (parallel/streaming.py) then computes only the column tiles that
hold a candidate. The band keys are a numpy floor-divide; the join stays
on the host, as in the JAX package.

Recall 1.0 by construction (the JAX package's derivation, which
tests/test_lsh_prune.py property-tests there):

1. The streaming primary retains a pair iff its Mash distance
   ``d = -ln(2j/(1+j))/k`` is <= ``keep`` (parallel/streaming.py
   ``retention_bound``). d is strictly decreasing in j, so retention is
   exactly ``j >= j_min(keep, k) = e^(-k*keep) / (2 - e^(-k*keep))``.
2. The estimator (ops/mash.py::mash_shared) computes
   ``j = shared / s_use`` with ``s_use = min(|A|, |B|, s)`` and
   ``shared`` = distinct hashes present in BOTH sketches among the
   bottom-``s_use`` of the union. Every such hash has union-rank
   <= s_use, hence per-sketch rank <= s_use — it sits inside both
   PACKED rows. The number of ids the two packed rows share is
   therefore >= shared >= ceil(j_min * s_use) for any retained pair.
3. Band keys are a monotone many-to-one map of ids (``id // width``;
   width 1 = the ids themselves), so shared ids imply shared band keys.
   A retained pair shares >= T distinct band keys, where
   T = ceil(j_min * s_use) when width == 1 (distinct ids -> distinct
   keys) and T = 1 for any wider band (shared ids may merge into one
   key, but at least one shared key always exists because j_min > 0
   for every keep < 1).

The bucket join emits exactly the pairs sharing >= T band keys, so no
retained pair is ever pruned — the pruned edge set is BIT-IDENTICAL to
the dense walk's, and skipped tiles are exactly tiles whose every pair
the dense walk would have discarded anyway.

Knobs: ``bands`` (0 = one band per id, the tightest and the only mode
where the derived count threshold applies; B > 0 = the id space split
into B equal ranges — coarser keys, smaller join, threshold pinned to
1), ``min_shared`` (conservative floor: an explicit value CLAMPS the
derived threshold from below-or-equal — 1 is the most conservative;
values above the derivation would break the recall proof and are
clamped down with a warning, never honored), and ``join_chunk``
(memory bound on the bucket join's host expansion — the candidate set
is identical for every value; see :func:`build_candidates`).

Why this is exact where classic banded MinHash-LSH is probabilistic:
the textbook scheme bands r-row signature GROUPS and only collides when
an entire band matches (recall 1-(1-j^r)^b < 1). Here the sketches are
bottom-s of ONE hash function, so sharing is per-value, and keying
individual (banded) values makes collision a certainty for any pair the
gate can retain — the false-positive cost is paid in candidate count,
not in recall, and the dense-oracle equivalence suite can pin it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from drep_tpu_torch.ops.minhash import PAD_ID, PackedSketches
from drep_tpu_torch.utils.logger import get_logger

# relative safety margin on the derived Jaccard floor: the keep test
# thresholds float32 distances, this derivation runs in float64 — the
# margin absorbs the cross-precision ulp at the boundary (a pair at
# exactly d == keep must never be pruned by a rounding disagreement)
_JMIN_SAFETY = 1e-6


def jaccard_floor(keep: float, k: int) -> float:
    """The minimum Jaccard any retained pair can have: the Mash distance
    ``d = -ln(2j/(1+j))/k`` inverted at ``d = keep`` (monotone), with a
    small downward safety margin. keep >= 1 means nothing is pruned
    (every pair retained) -> floor 0."""
    if keep >= 1.0:
        return 0.0
    e = math.exp(-float(k) * float(keep))
    return max(0.0, e / (2.0 - e) * (1.0 - _JMIN_SAFETY))


def derive_min_shared(keep: float, k: int, s_use) -> np.ndarray:
    """Minimum distinct shared sketch ids a retained pair must exhibit
    (the recall-1.0 threshold, valid for bands == 0 only). Vectorized
    over ``s_use = min(|A|, |B|, s)``; always >= 1."""
    jm = jaccard_floor(keep, k)
    su = np.asarray(s_use, dtype=np.float64)
    return np.maximum(1, np.ceil(jm * su - 1e-9)).astype(np.int64)


def band_signatures(ids: np.ndarray, bands: int) -> np.ndarray:
    """Per-genome band-key rows of the packed id matrix: ``bands == 0``
    returns the ids themselves (one band per id, the exact inverted
    index); ``bands > 0`` splits the dense rank space [0, extent) into
    that many equal ranges (``id // width``, an int32 floor-divide). Rows
    stay sorted (the map is monotone); pads map to -1."""
    if bands <= 0:
        return ids
    real = ids[ids != PAD_ID]
    extent = int(real.max()) + 1 if real.size else 1
    width = max(1, -(-extent // int(bands)))
    return np.where(ids == PAD_ID, np.int32(-1), ids // np.int32(width)).astype(np.int32)


@dataclass
class CandidateSet:
    """The bucket join's output: candidate pairs (i < j, genome indices)
    plus the banding parameters that produced them — pinned into the
    streaming checkpoint meta so shards from different banding configs
    can never silently mix."""

    ii: np.ndarray
    jj: np.ndarray
    n: int
    params: dict = field(default_factory=dict)

    @property
    def n_candidates(self) -> int:
        return len(self.ii)

    def restrict_min_col(self, min_col: int) -> "CandidateSet":
        """Only pairs the rectangular (K x N) schedule computes: j >=
        min_col (the incremental index's new-genome tail). i-side pairs
        below min_col are already stored edges."""
        if min_col <= 0:
            return self
        sel = self.jj >= min_col
        return CandidateSet(
            ii=self.ii[sel], jj=self.jj[sel], n=self.n, params=dict(self.params)
        )

    def occupancy(self, block: int, n_blocks: int) -> np.ndarray:
        """Block-level tile-occupancy bitmap for the stripe scheduler:
        occ[bi, bj] is True iff some candidate pair lands in tile
        (bi, bj) of the upper-triangle walk (ii < jj => bi <= bj, so
        only the scheduled half is ever set)."""
        occ = np.zeros((n_blocks, n_blocks), dtype=bool)
        if len(self.ii):
            occ[self.ii // block, self.jj // block] = True
        return occ


def _codes(pa, pb, n: int) -> np.ndarray:
    """int64 pair code ``min*n + max`` — the explicit widening matters:
    member indices are intp, and on a 32-bit-intp platform ``lo * n``
    would silently overflow past ~46k genomes (colliding codes = a wrong
    candidate set, breaking recall without a sound)."""
    lo = np.minimum(pa, pb).astype(np.int64)
    hi = np.maximum(pa, pb).astype(np.int64)
    return lo * np.int64(n) + hi


def _iter_pair_codes(starts, sizes, g_sorted, n: int, chunk: int):
    """Yield int64 pair-code batches (``lo * n + hi`` per within-bucket
    pair, lo < hi) for the bucket join. ``chunk <= 0`` yields one batch
    per distinct bucket size (the original expansion); ``chunk > 0``
    bounds every batch to ~``chunk`` codes: size groups are sliced over
    buckets, and a HEAVY-HITTER bucket whose own c*(c-1)/2 expansion
    exceeds the bound is walked row-by-row (anchor x tail, no
    triu_indices — the index arrays would be as large as the expansion
    itself), so even one hot band key shared by 100k genomes never
    materializes more than ~chunk + c codes at once. Batch boundaries
    never change the multiset of codes, only how much is resident."""
    for c in np.unique(sizes):
        if c < 2:
            continue
        c = int(c)
        bucket_starts = starts[sizes == c]
        pairs_per_bucket = c * (c - 1) // 2
        if chunk > 0 and pairs_per_bucket > int(chunk):
            # heavy-hitter buckets: row-wise expansion, flushed at the bound
            for bs in bucket_starts:
                members = g_sorted[bs + np.arange(c)]
                buf: list[np.ndarray] = []
                held = 0
                for a_i in range(c - 1):
                    buf.append(_codes(members[a_i], members[a_i + 1 :], n))
                    held += c - 1 - a_i
                    if held >= int(chunk):
                        yield np.concatenate(buf)
                        buf, held = [], 0
                if buf:
                    yield np.concatenate(buf)
            continue
        ai, bi = np.triu_indices(c, 1)
        step = (
            len(bucket_starts)
            if chunk <= 0
            else max(1, int(chunk) // pairs_per_bucket)
        )
        for o in range(0, len(bucket_starts), step):
            bs = bucket_starts[o : o + step]
            members = g_sorted[bs[:, None] + np.arange(c)[None, :]]
            yield _codes(members[:, ai].ravel(), members[:, bi].ravel(), n)


def merge_code_counts(code_batches) -> tuple[np.ndarray, np.ndarray]:
    """Fold pair-code batches into (unique codes, per-code counts)
    WITHOUT concatenating the duplicate-heavy expansion: each batch is
    uniqued locally and two-way SORTED-MERGED into the running
    accumulator (searchsorted hit/miss + one np.insert — O(output +
    batch log output) per batch, never a re-sort of the accumulator), so
    peak memory is O(output + one batch) instead of O(total expanded
    pairs). Identical output to ``np.unique(concat,
    return_counts=True)`` (counts are additive over any partition of the
    multiset)."""
    codes = np.empty(0, np.int64)
    counts = np.empty(0, np.int64)
    for batch in code_batches:
        u, ct = np.unique(batch, return_counts=True)
        if not len(codes):
            codes, counts = u, ct.astype(np.int64)
            continue
        idx = np.searchsorted(codes, u)
        hit = (idx < len(codes)) & (codes[np.minimum(idx, len(codes) - 1)] == u)
        np.add.at(counts, idx[hit], ct[hit])
        if not hit.all():
            new_u = u[~hit]
            pos = np.searchsorted(codes, new_u)
            codes = np.insert(codes, pos, new_u)
            counts = np.insert(counts, pos, ct[~hit])
    return codes, counts


def build_candidates(
    packed: PackedSketches,
    keep: float,
    k: int,
    bands: int = 0,
    min_shared: int = 0,
    min_col: int = 0,
    join_chunk: int = 0,
) -> CandidateSet:
    """Banding + bucket join: every pair that can survive the retention
    bound ``keep`` (and, with ``min_col``, reach the rectangular
    schedule's computed columns).

    ``bands``: 0 -> one band per sketch id (exact; the derived count
    threshold applies). B > 0 -> B id-space ranges (smaller join;
    threshold pinned to 1). ``min_shared``: 0 -> auto-derive from the
    retention bound; an explicit value is a conservative floor, clamped
    UP-never (values above the derivation are reduced to it with a
    warning — honoring them would break the recall-1.0 contract).
    ``join_chunk``: 0 (default) materializes the whole candidate-code
    expansion and runs ONE ``np.unique`` over it — fine to ~1M genomes
    on a fat host; > 0 bounds the join's working set to ~that many codes
    at a time (chunked expansion + incremental sorted-merge fold,
    :func:`merge_code_counts`) so thin hosts survive beyond-1M runs. A pure
    execution knob: the candidate set is IDENTICAL for every value
    (property-tested), so it is deliberately NOT pinned into the
    checkpoint meta params — resuming under a different chunk size is
    always safe.
    """
    logger = get_logger()
    n, s = packed.n, packed.sketch_size
    counts = np.asarray(packed.counts, dtype=np.int64)
    if n < 2:
        return CandidateSet(
            ii=np.empty(0, np.int64), jj=np.empty(0, np.int64), n=n,
            params=_params(keep, bands, min_shared),
        )
    keys = band_signatures(packed.ids, bands)

    # one (key, genome) entry per REAL slot, deduped within each row for
    # banded keys (rows are sorted and the band map is monotone, so
    # duplicates are adjacent); bands == 0 rows are strictly increasing
    # already (pack_sketches packs sorted-unique sketches)
    cols = np.arange(s)[None, :]
    valid = cols < counts[:, None]
    if bands > 0:
        valid[:, 1:] &= keys[:, 1:] != keys[:, :-1]
    flat_keys = keys[valid]
    flat_rows = np.broadcast_to(np.arange(n)[:, None], (n, s))[valid]

    # bucket join: group by key, emit all within-bucket pairs. Buckets
    # are processed grouped BY SIZE so the combination expansion stays
    # fully vectorized (one triu_indices per distinct size).
    order = np.argsort(flat_keys, kind="stable")
    k_sorted = flat_keys[order]
    g_sorted = flat_rows[order]
    starts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
    sizes = np.diff(np.r_[starts, len(k_sorted)])

    # shared-band count per pair: one np.unique over the full expansion
    # (default), or the memory-bounded chunked fold (join_chunk > 0) —
    # identical (codes, counts) either way
    if join_chunk > 0:
        uniq, shared = merge_code_counts(
            _iter_pair_codes(starts, sizes, g_sorted, n, join_chunk)
        )
    else:
        batches = list(_iter_pair_codes(starts, sizes, g_sorted, n, 0))
        if batches:
            uniq, shared = np.unique(np.concatenate(batches), return_counts=True)
        else:
            uniq = shared = np.empty(0, np.int64)
    if not len(uniq):
        return CandidateSet(
            ii=np.empty(0, np.int64), jj=np.empty(0, np.int64), n=n,
            params=_params(keep, bands, min_shared),
        )
    lo, hi = uniq // n, uniq % n
    if bands > 0:
        # distinct shared ids can merge into one wide band — only >= 1
        # is guaranteed, so the count threshold is pinned there
        thresh = np.ones(len(uniq), np.int64)
        derived_max = 1
    else:
        s_use = np.minimum(np.minimum(counts[lo], counts[hi]), s)
        thresh = derive_min_shared(keep, k, s_use)
        derived_max = int(thresh.max()) if len(thresh) else 1
    if min_shared > 0:
        if min_shared > derived_max:
            logger.warning(
                "lsh pruning: --prune_min_shared %d exceeds the derived "
                "recall-1.0 threshold (max %d at this retention bound) — "
                "clamping down; honoring it would drop retained edges",
                min_shared, derived_max,
            )
        thresh = np.minimum(thresh, min_shared)
    sel = shared >= thresh
    ii, jj = lo[sel], hi[sel]
    out = CandidateSet(ii=ii, jj=jj, n=n, params=_params(keep, bands, min_shared))
    if min_col > 0:
        out = out.restrict_min_col(min_col)
    dense = n * (n - 1) // 2
    logger.info(
        "lsh pruning: %d candidate pairs of %d dense (%.2f%%), bands=%s, "
        "derived min shared <= %d",
        out.n_candidates, dense, 100.0 * out.n_candidates / max(dense, 1),
        bands if bands > 0 else "per-id", derived_max,
    )
    return out


def _params(keep: float, bands: int, min_shared: int) -> dict:
    """The banding parameters a checkpoint meta pins — shards computed
    under one parameter set must never resume under another (the tile
    skip pattern, and therefore the honesty accounting, would differ
    even though retained edges would not)."""
    return {
        "prune_scheme": "lsh",
        "prune_bands": int(bands),
        "prune_min_shared": int(min_shared),
        "prune_keep": round(float(keep), 12),
    }
