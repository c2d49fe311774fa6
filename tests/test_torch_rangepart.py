"""The port's range partitioning, vocabulary-chunk plans, chunked matmul
and beyond-budget routing rule against the JAX package: layouts
byte-identical (dtype, bucket set, width), counts and (ani, cov) exact.
"""

import numpy as np
import pytest
import torch

import drep_tpu.ops.containment as jc
from drep_tpu.cluster import engines as jengines
from drep_tpu.ops import rangepart as jr
from drep_tpu_torch.cluster import engines as tengines
from drep_tpu_torch.ops import containment as tc
from drep_tpu_torch.ops.intersect import intersect_counts_self
from drep_tpu_torch.ops import rangepart as tr
from drep_tpu_torch.ops.minhash import PAD_ID

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, n, max_len, vocab):
    """Sorted unique PAD-padded int32 rows, row 0 full, row 1 empty."""
    lens = rng.integers(0, max_len + 1, size=n)
    lens[0], lens[1] = max_len, 0
    ids = np.full((n, max_len), PAD_ID, np.int32)
    for i, m in enumerate(lens):
        ids[i, :m] = np.sort(rng.choice(vocab, size=m, replace=False))
    return ids


def _same_arrays(got: list[np.ndarray], want: list[np.ndarray]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize(
    "vocab,want_dtype",
    [(6000, np.uint16), (1 << 24, np.int32), (1 << 22, np.int32), (200_000, np.uint16)],
    ids=["u16", "i32-sparse", "i32-tie", "u16-finer"],
)
def test_stacked_range_buckets_equal_jax(rng, vocab, want_dtype):
    a = _rows(rng, 7, 2600, vocab)
    b = _rows(rng, 5, 1900, vocab)
    got = tr.stacked_range_buckets([a, b], 2048)
    _same_arrays(got, jr.stacked_range_buckets([a, b], 2048))
    assert got[0].dtype == want_dtype


def test_stacked_range_buckets_all_padding():
    pad = np.full((3, 300), PAD_ID, np.int32)
    _same_arrays(tr.stacked_range_buckets([pad], 256), jr.stacked_range_buckets([pad], 256))
    with pytest.raises(ValueError, match="power of two"):
        tr.stacked_range_buckets([pad], 1000)
    with pytest.raises(ValueError, match="minimum bucket width"):
        tr.stacked_range_buckets([pad], 64)


def test_partition_by_range_and_helpers_equal_jax(rng):
    a = _rows(rng, 6, 900, 20_000)
    b = _rows(rng, 4, 700, 20_000)
    got = list(tr.partition_by_range([a, b], 256, rebase=True))
    want = list(jr.partition_by_range([a, b], 256, rebase=True))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _same_arrays(g, w)
    assert tr.vocab_extent(a) == jr.vocab_extent(a)
    np.testing.assert_array_equal(tr.bucket_starts(a, 1500, 14), jr.bucket_starts(a, 1500, 14))
    np.testing.assert_array_equal(tr.bucket_histogram(b, 999, 21), jr.bucket_histogram(b, 999, 21))


@pytest.mark.parametrize("v_chunk", [8192, 1 << 16])
def test_vocab_chunk_plan_and_stacking_equal_jax(rng, v_chunk):
    ids = _rows(rng, 9, 600, 150_000)
    extent = tr.vocab_extent(ids)
    got_plan = tc._chunk_plan(ids, v_chunk, extent)
    want_plan = jc._chunk_plan(ids, v_chunk, extent)
    assert got_plan[0] == want_plan[0] and got_plan[3] == want_plan[3]
    np.testing.assert_array_equal(got_plan[1], want_plan[1])
    got = tc._stacked_vocab_chunks(ids, v_chunk, m_pad=16, plan=got_plan)
    _same_arrays([got], [jc._stacked_vocab_chunks(ids, v_chunk, m_pad=16)])
    assert got.dtype == (np.uint16 if v_chunk < (1 << 16) else np.int32)
    for m_pad in (64, 128, 2048, 1 << 16):
        assert tc.matmul_vocab_chunk(m_pad) == jc.matmul_vocab_chunk(m_pad)


def _sketches(rng, n, lo, hi):
    return [
        np.unique(rng.integers(0, 1 << 40, size=int(rng.integers(lo, hi))).astype(np.uint64))
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "budget,n,lo,hi",
    [(1 << 15, 33, 50, 800), (1 << 23, 40, 1500, 3000), (1 << 25, 60, 3900, 4000)],
    ids=["u16-floor-chunks", "u16-plan-wins", "i32-plan-wins"],
)
def test_chunked_matmul_equals_jax(rng, monkeypatch, budget, n, lo, hi):
    """Both modules' budgets monkeypatched as tests/test_rangepart.py does:
    8192-wide chunks, the uint16-vs-int32 plan comparison picking uint16,
    and (equal bytes: 2^18-wide int32 chunks against 2^15-wide uint16
    chunks of twice the width) keeping int32."""
    sketches = _sketches(rng, n, lo, hi)
    names = [f"g{i}" for i in range(n)]
    packed = tc.pack_scaled_sketches(sketches, names)
    monkeypatch.setattr(jc, "MATMUL_BUDGET_ELEMS", budget)
    monkeypatch.setattr(tc, "MATMUL_BUDGET_ELEMS", budget)
    want_ani, want_cov = jc.all_vs_all_containment_matmul_chunked(jc.pack_scaled_sketches(sketches, names), k=21)
    got_ani, got_cov = tc.all_vs_all_containment_matmul_chunked(packed, k=21, device=CPU)
    assert got_ani.tobytes() == want_ani.tobytes()
    assert got_cov.tobytes() == want_cov.tobytes()
    # the chunked counts equal the merge route's on the same pack
    np.testing.assert_array_equal(tc.intersections_chunked(packed, CPU), intersect_counts_self(packed.ids, CPU))


def test_beyond_budget_rule_equals_jax():
    widths = [1, 100, 128, 129, 1000, 2048, 2049, 20_000, 32_768, 40_000]
    v_pads = [1 << p for p in range(13, 28)]
    for w in widths:
        for v in v_pads:
            assert tengines.beyond_budget_secondary_path(w, v) == jengines.beyond_budget_secondary_path(w, v)
    assert tengines.MERGE_VS_MATMUL_ELEM_COST == jengines.MERGE_VS_MATMUL_ELEM_COST
    # the slice's planted clusters: diverse and wide, diverse and narrow, overlapping
    assert tengines.beyond_budget_secondary_path(32_768, 1 << 26) == "pallas_range"
    assert tengines.beyond_budget_secondary_path(2048, 1 << 22) == "pallas_range"
    assert tengines.beyond_budget_secondary_path(32_768, 1 << 20) == "matmul_chunked"
