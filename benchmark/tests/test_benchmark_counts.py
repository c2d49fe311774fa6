"""The yardstick's arithmetic against hand counts: the reference's shared
counts and distances, the merge steps and bytes of the roofline."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from benchmark.reference import mash
from benchmark.reference.primary import canonical, upgma_flat
from benchmark.roofline.mash import TILE, dense_job_cost, mash_grid_cost, mash_ops, sum_pair_min


def _shared_by_hand(a: list[int], b: list[int], s: int) -> int:
    s_use = min(len(a), len(b), s)
    union = sorted(set(a) | set(b))[:s_use]
    return len(set(union) & set(a) & set(b))


def _rows(sets: list[list[int]], w: int):
    hashes = np.zeros((len(sets), w), dtype=np.uint64)
    counts = np.array([len(x) for x in sets], dtype=np.int32)
    for i, x in enumerate(sets):
        hashes[i, : len(x)] = np.array(sorted(x), dtype=np.uint64)
    return torch.from_numpy(mash.signed_rows(hashes, counts)), torch.from_numpy(counts.astype(np.int64))


def test_shared_counts_match_the_definition():
    rng = np.random.default_rng(0)
    w = 12
    sets = []
    for _ in range(40):
        m = int(rng.integers(0, w + 1))
        # small values (ties across rows) and values past 2**63 (the top bit)
        pool = np.concatenate([np.arange(30, dtype=np.uint64), np.uint64(1 << 63) + np.arange(10, dtype=np.uint64)])
        sets.append([int(v) for v in rng.choice(pool, size=m, replace=False)])
    rows, counts = _rows(sets, w)
    pairs = list(itertools.product(range(len(sets)), repeat=2))
    ii = torch.tensor([p[0] for p in pairs])
    jj = torch.tensor([p[1] for p in pairs])
    for s in (w, 7):
        got = mash.pair_shared(rows, counts, ii, jj, s, chunk=64).numpy()
        want = [_shared_by_hand(sets[i], sets[j], s) for i, j in pairs]
        assert got.tolist() == want


def test_distance_formula_and_its_control():
    shared = np.array([0, 1, 500, 1000])
    s_use = np.array([1000, 1000, 1000, 1000])
    d = mash.distance(shared, s_use, 21)
    j = shared / 1000.0
    with np.errstate(divide="ignore"):
        want = np.where(j > 0, -np.log(2 * j / (1 + j)) / 21, 1.0)
    assert d.dtype == np.float32 and np.allclose(d, np.clip(want, 0, 1), rtol=1e-6)
    assert d[0] == 1.0 and d[3] == 0.0
    low = mash.distance(shared, s_use, 21, "bfloat16")
    assert low.dtype == np.float32 and np.abs(low - d).max() > 0


def test_mash_ops_by_hand():
    shared = np.array([[3, 0], [1, 2]])
    na, nb = np.array([5, 2]), np.array([4, 9])
    # s_use: [[4, 5], [2, 2]] with s_orig 5 -> 13, plus shared 6
    assert mash_ops(shared, na, nb, 5) == 19


def test_grid_cost_counts_every_tile_of_the_wrapped_grid():
    rng = np.random.default_rng(1)
    n, width = 2 * TILE, 16
    counts = rng.integers(0, width + 1, size=n)
    shared = rng.integers(0, 4, size=(n, n))
    steps, nbytes = mash_grid_cost(shared, counts, width)
    # t = 2 row tiles: the wrapped grid computes all four tiles
    s_use = np.minimum(np.minimum(counts[:, None], counts[None, :]), width)
    assert steps == int(s_use.sum() + shared.sum())
    assert nbytes == n * width * 4 + n * 4 + n * 2 * TILE * 4


def test_dense_job_cost_counts_each_pair_once():
    rng = np.random.default_rng(2)
    n, width = 37, 20
    counts = rng.integers(0, 30, size=n)
    brute = sum(min(counts[i], counts[j], width) for i in range(n) for j in range(i + 1, n))
    assert sum_pair_min(counts, width) == brute
    steps, nbytes = dense_job_cost(counts, width, shared_sum=11)
    assert steps == brute + 11
    assert nbytes == n * width * 4 + n * 4 + n * (n - 1) // 2 * 4


def test_canonical_names_a_partition():
    a = canonical(np.array([5, 5, 2, 9, 2]))
    b = canonical(np.array([1, 1, 3, 4, 3]))
    c = canonical(np.array([1, 2, 3, 4, 3]))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.tolist() == [[0, 2], [0, 2], [2, 2], [3, 1], [2, 2]]


def test_upgma_equals_scipy_where_no_averages_tie():
    import scipy.cluster.hierarchy as sch
    import scipy.spatial.distance as ssd

    rng = np.random.default_rng(3)
    for _ in range(60):
        m = int(rng.integers(2, 30))
        pts = rng.random((m, 3)) * rng.choice([0.1, 0.3])
        dist = ssd.squareform(ssd.pdist(pts)).astype(np.float32).astype(np.float64)
        members = np.sort(rng.choice(500, m, replace=False))
        got, tied = upgma_flat(dist, members, 500, 0.1)
        want = sch.fcluster(sch.linkage(ssd.squareform(dist, checks=False), "average"), t=0.1, criterion="distance")
        assert tied == 0 and np.array_equal(canonical(got), canonical(want))


def test_upgma_ties_go_to_the_least_pair_of_names():
    """The stated tie rule, on distances whose sums are exact, is the
    order in which the program's sparse UPGMA takes equal averages."""
    from drep_tpu_torch.ops.linkage import sparse_average_linkage_python

    def both(dist):
        m = dist.shape[0]
        labels, tied = upgma_flat(dist, np.arange(m), m, 0.1)
        iu, ju = np.triu_indices(m, 1)
        port, _ = sparse_average_linkage_python(m, iu, ju, dist[iu, ju], 0.1, 0.25)
        assert np.array_equal(canonical(labels), canonical(port))
        return labels.tolist(), tied

    # genome 0 is as near to 1 as to 2; 1 and 2 lie 0.2 apart, so the
    # first merge decides which of them joins 0: the pair (0, 1) goes first
    assert both(np.array([[0, 0.0625, 0.0625], [0.0625, 0, 0.2], [0.0625, 0.2, 0]])) == ([0, 0, 2], 1)
    # (1, 2) merges first; then 3 lies 0.0625 from genome 0 and, on
    # average, from {1, 2}: two genomes' pair goes before a new cluster's
    dist = np.full((4, 4), 0.3)
    np.fill_diagonal(dist, 0)
    for (a, b), v in {(1, 2): 0.03125, (0, 3): 0.0625, (1, 3): 0.046875, (2, 3): 0.078125, (0, 1): 0.2,
                      (0, 2): 0.2}.items():
        dist[a, b] = dist[b, a] = v
    assert both(dist) == ([0, 1, 1, 0], 1)
