"""The port's LSH candidate pruning (drep_tpu_torch/ops/lsh.py) against
the JAX package's drep_tpu/ops/lsh.py on the same packs: band keys,
derived thresholds, the bucket join's pair codes and counts, candidate
sets and their tile occupancy must be equal exactly."""

import numpy as np
import pytest

from drep_tpu.ops import lsh as jl
from drep_tpu.ops.minhash import PackedSketches as JaxPacked
from drep_tpu.utils.synth import planted_group_sketches
from drep_tpu_torch.ops import lsh as tl
from drep_tpu_torch.ops.minhash import PAD_ID, PackedSketches


def _packs(n=160, s=48, groups=10, seed=0, contiguous=True, ragged=False):
    """(port pack, JAX pack) of one group-pool planting (numpy seed);
    `ragged` cuts some rows short (PAD tail, smaller count)."""
    p = planted_group_sketches(n=n, s=s, groups=groups, seed=seed, contiguous=contiguous)
    ids, counts = p.ids.copy(), p.counts.copy()
    if ragged:
        rng = np.random.default_rng(seed + 100)
        for r in rng.choice(n, size=n // 4, replace=False):
            c = int(rng.integers(1, s))
            ids[r, c:] = PAD_ID
            counts[r] = c
    return (PackedSketches(ids=ids, counts=counts, names=list(p.names)),
            JaxPacked(ids=ids, counts=counts, names=list(p.names)))


@pytest.mark.parametrize("bands", [0, 1, 4, 16, 1000])
def test_band_signatures_equal_jax(bands):
    tp, jp = _packs(ragged=True)
    got = tl.band_signatures(tp.ids, bands)
    want = np.asarray(jl.band_signatures(jp.ids, bands))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep", [0.05, 0.1, 0.25, 0.6, 1.0])
def test_thresholds_equal_jax(keep):
    assert tl.jaccard_floor(keep, 21) == jl.jaccard_floor(keep, 21)
    s_use = np.arange(0, 1001)
    np.testing.assert_array_equal(tl.derive_min_shared(keep, 21, s_use), jl.derive_min_shared(keep, 21, s_use))


@pytest.mark.parametrize("chunk", [0, 1, 7, 50, 10_000])
def test_pair_codes_and_fold_equal_jax(chunk):
    """The bucket join's code batches (one per bucket size, or chunked,
    heavy hitters row by row) and their fold into (codes, counts)."""
    rng = np.random.default_rng(chunk)
    sizes = rng.integers(1, 12, size=40)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    g_sorted = rng.integers(0, 90, size=int(sizes.sum()))
    got = list(tl._iter_pair_codes(starts, sizes, g_sorted, 90, chunk))
    want = list(jl._iter_pair_codes(starts, sizes, g_sorted, 90, chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tl.merge_code_counts(iter(got)), jl.merge_code_counts(iter(want))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tl._codes(np.arange(5), np.arange(5)[::-1], 7),
                                  jl._codes(np.arange(5), np.arange(5)[::-1], 7))


@pytest.mark.parametrize("bands,min_shared,join_chunk,min_col", [
    (0, 0, 0, 0), (0, 1, 0, 0), (0, 2, 0, 0), (4, 0, 0, 0), (16, 0, 64, 0),
    (0, 0, 100, 0), (0, 0, 0, 90), (4, 1, 0, 130),
])
@pytest.mark.parametrize("contiguous", [True, False])
def test_build_candidates_equal_jax(bands, min_shared, join_chunk, min_col, contiguous):
    """Candidate pairs (i < j, in the JAX package's order), their banding
    parameters and the tile occupancy at the streaming block are equal."""
    tp, jp = _packs(contiguous=contiguous, ragged=True, seed=bands + min_shared)
    kw = dict(keep=0.25, k=21, bands=bands, min_shared=min_shared, min_col=min_col, join_chunk=join_chunk)
    got, want = tl.build_candidates(tp, **kw), jl.build_candidates(jp, **kw)
    np.testing.assert_array_equal(got.ii, want.ii)
    np.testing.assert_array_equal(got.jj, want.jj)
    assert got.n == want.n and got.params == want.params and got.n_candidates == want.n_candidates
    for block in (8, 128):
        n_blocks = -(-tp.n // block)
        np.testing.assert_array_equal(got.occupancy(block, n_blocks), want.occupancy(block, n_blocks))


def test_candidate_edge_cases_equal_jax():
    """Fewer than two genomes, and packs whose rows share nothing, give
    empty candidate sets; restrict_min_col keeps the pairs with j >= it."""
    tp, jp = _packs(n=1)
    assert tl.build_candidates(tp, keep=0.25, k=21).n_candidates == 0 == jl.build_candidates(jp, keep=0.25, k=21).n_candidates
    ids = (np.arange(40, dtype=np.int32).reshape(4, 10))
    tp = PackedSketches(ids=ids, counts=np.full(4, 10, np.int32), names=list("abcd"))
    got = tl.build_candidates(tp, keep=0.25, k=21)
    assert got.n_candidates == 0 and got.params == jl._params(0.25, 0, 0)
    tp, jp = _packs(contiguous=False)
    got = tl.build_candidates(tp, keep=0.25, k=21).restrict_min_col(70)
    want = jl.build_candidates(jp, keep=0.25, k=21).restrict_min_col(70)
    np.testing.assert_array_equal(got.jj, want.jj)
    assert got.jj.min() >= 70
