"""The port's common-threshold MinHash estimator (`--primary_estimator
matmul`, drep_tpu_torch/ops/minhash_matmul.py) against the JAX package's
on the same seeded sketches: `dist` and `jac` bit for bit, on ragged,
empty and identical rows, across more than one of the JAX package's
256-row quanta and the port's 128-row pads; the engines' resolution of the
estimator; the intersection counts its chunked route computes, against
the merge-intersect route's.
"""

import numpy as np
import pytest
import torch

from drep_tpu.ops import minhash_matmul as jm
from drep_tpu.ops.minhash import pack_sketches as jax_pack_sketches
from drep_tpu_torch.cluster import engines
from drep_tpu_torch.ops import containment as tc
from drep_tpu_torch.ops import intersect as ti
from drep_tpu_torch.ops import minhash_matmul as tm
from drep_tpu_torch.ops.minhash import pack_sketches

CPU = torch.device("cpu")
K = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sketches(rng, n: int, s: int) -> list[np.ndarray]:
    """n bottom sketches of up to s hashes: groups sharing part of a pool,
    ragged rows (some far below s), empty rows and identical pairs."""
    pool = np.unique(rng.integers(0, 2**63, size=6 * s, dtype=np.uint64))
    out = []
    for i in range(n):
        kind = i % 9
        if kind == 0:
            sk = np.zeros(0, np.uint64)
        elif kind == 2:
            sk = out[-1].copy()  # identical to the row before
        else:
            group = pool[(i % 4) * s : (i % 4) * s + 2 * s]
            keep = group[rng.random(len(group)) < rng.uniform(0.2, 0.9)]
            own = rng.integers(0, 2**63, size=int(rng.integers(0, s // 4 + 1)), dtype=np.uint64)
            sk = np.unique(np.concatenate([keep, own]))[: int(rng.integers(1, s + 1)) if kind == 3 else s]
        out.append(np.sort(sk))
    return out


@pytest.mark.parametrize("n,s,seed", [(300, 64, 1), (7, 48, 2), (130, 32, 3)])
def test_dist_and_jac_bit_identical_to_jax(n, s, seed):
    """300 rows cross the JAX package's 256-row quantum and two of the
    port's 128-row pads; 130 cross one pad."""
    sketches = _sketches(np.random.default_rng(seed), n, s)
    names = [f"g{i}" for i in range(n)]
    packed = pack_sketches(sketches, names, s)
    dist, jac = tm.all_vs_all_mash_matmul(packed, K, CPU)
    want_d, want_j = jm.all_vs_all_mash_matmul(jax_pack_sketches(sketches, names, s), k=K)
    assert dist.dtype == want_d.dtype == np.float32 and jac.dtype == want_j.dtype
    assert dist.tobytes() == want_d.tobytes()
    assert jac.tobytes() == want_j.tobytes()
    assert (packed.counts == 0).any() and (packed.counts < s).any()
    # row 2 is a copy of row 1: distance 0, Jaccard 1
    assert packed.counts[2] > 0 and dist[1, 2] == 0.0 and jac[1, 2] == 1.0


def test_all_empty_and_no_rows_equal_jax():
    s = 16
    names = ["a", "b", "c"]
    empty = [np.zeros(0, np.uint64)] * 3
    got = tm.all_vs_all_mash_matmul(pack_sketches(empty, names, s), K, CPU)
    want = jm.all_vs_all_mash_matmul(jax_pack_sketches(empty, names, s), k=K)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    none = tm.all_vs_all_mash_matmul(pack_sketches([], [], s), K, CPU)
    assert none[0].shape == none[1].shape == (0, 0)


def test_host_parts_equal_jax():
    """_below_counts and _jaccard_host, copied, give the JAX package's
    arrays on the same sorted rows and thresholds."""
    rng = np.random.default_rng(5)
    packed = pack_sketches(_sketches(rng, 40, 32), [f"g{i}" for i in range(40)], 32)
    ids, counts = packed.ids, packed.counts
    t = np.where(counts > 0, ids[np.arange(40), np.maximum(counts - 1, 0)], -1).astype(np.int32)
    below = tm._below_counts(ids, counts, t)
    assert below.tobytes() == jm._below_counts(ids, counts, t).tobytes()
    inter = rng.integers(0, 20, size=(40, 40)).astype(np.int32)
    got, want = tm._jaccard_host(inter, below, counts, t, K), jm._jaccard_host(inter, below, counts, t, K)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def test_chunked_counts_equal_merge_route(monkeypatch):
    """The estimator's intersection counts (the chunked indicator route at
    the 128-row pad, several vocabulary chunks) equal the merge-intersect
    route's on the same pack."""
    monkeypatch.setattr(tc, "MATMUL_BUDGET_ELEMS", 256 * 8200)
    rng = np.random.default_rng(6)
    pool = np.unique(rng.integers(0, 2**63, size=40_000, dtype=np.uint64))
    sketches = [np.sort(rng.choice(pool, size=int(rng.integers(0, 129)), replace=False)) for _ in range(200)]
    packed = pack_sketches(sketches, [f"g{i}" for i in range(200)], 128)
    chunks, _ = tc.vocab_chunks(packed, m_pad=256)
    assert chunks.shape[:2] == (2, 256)
    got = tc.intersections_chunked(packed, CPU, m_pad=256)
    np.testing.assert_array_equal(got, ti.intersect_counts_self(packed.ids, CPU))


@pytest.mark.parametrize("estimator,mesh_shape,want", [
    ("matmul", None, "matmul"), ("auto", None, "sort"), ("sort", None, "sort"), ("matmul", 4, "ring_sort"),
])
def test_engine_resolves_the_estimator(estimator, mesh_shape, want):
    """matmul where it is asked for; auto stays the sort estimator (as the
    JAX package resolves it on a TPU); a mesh takes the ring."""
    assert engines.resolve_primary_estimator(100, mesh_shape, estimator, CPU) == want


def test_mesh_overrides_matmul_with_the_jax_warning(monkeypatch):
    """On a mesh, matmul warns and runs the ring (the sort estimator)."""
    sketches = _sketches(np.random.default_rng(7), 64, 32)
    packed = pack_sketches(sketches, [f"g{i}" for i in range(64)], 32)
    warned = []
    monkeypatch.setattr(engines.get_logger(), "warning", lambda msg, *a: warned.append(msg % a))
    dist = engines.mash_distance_matrix(packed, K, CPU, mesh_shape=4, estimator="matmul")
    assert len(warned) == 1 and "single-chip only" in warned[0] and "4-position mesh" in warned[0]
    want = engines.mash_distance_matrix(packed, K, CPU, estimator="sort")
    np.testing.assert_array_equal(dist, want)
    mm = engines.mash_distance_matrix(packed, K, CPU, estimator="matmul")
    assert mm.tobytes() == tm.all_vs_all_mash_matmul(packed, K, CPU)[0].tobytes()
