"""The port's greedy secondary (drep_tpu_torch/cluster/greedy.py) and its
working set (ops/containment.py::VocabChunkGeometry, rect_from_chunks,
self_from_chunks; ops/indicator.py's rectangular product) against the JAX
package on the same seeded sketches.

The JAX package computes the greedy's counts by gather tiles off a TPU
and by rectangular indicator products on one (its matmul route, which the
port takes); both divide exact integer counts in float32, so the port is
held against both. Every table is compared as bytes, every label and
count exactly.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.cluster import greedy as jg
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ops import containment as jc
from drep_tpu.utils import envknobs
from drep_tpu_torch.cluster import greedy as tg
from drep_tpu_torch.ops import containment as tc
from drep_tpu_torch.ops import indicator as ti
from drep_tpu_torch.ops.minhash import PAD_ID
from drep_tpu_torch.utils.synth import planted_sketches

CPU = torch.device("cpu")
PAD = int(PAD_ID)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    """One primary cluster of 90 genomes in ~30 planted groups (each group
    one secondary cluster at S_ani, no two groups sharing a hash), with
    n_kmers from each scaled sketch's length, so the greedy visits them in
    a mixed order and makes ~30 representatives."""
    gs, planted = planted_sketches(90, seed=11, s_bottom=100, s_scaled=500)
    gs.gdb["n_kmers"] = [len(s) * gs.scale for s in gs.scaled]
    return gs, planted


def _jax_gs(gs):
    return JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
                             k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale)


def _kw(**extra):
    return {"S_ani": 0.95, "cov_thresh": 0.1, "mesh_shape": None, "device": CPU, **extra}


def _ndb_bytes(ndb: pd.DataFrame) -> bytes:
    return ndb.to_csv(index=False).encode()


def _cut_budget(monkeypatch, elems: int) -> None:
    monkeypatch.setattr(tc, "MATMUL_BUDGET_ELEMS", elems)
    monkeypatch.setattr(jc, "MATMUL_BUDGET_ELEMS", elems)


@pytest.mark.parametrize("max_rows", [16, 512])
def test_geometry_rows_chunks_equal_jax(cluster, monkeypatch, max_rows):
    """Chunk width, per-chunk widths, bounds and every subset's rebased
    chunk tensors equal the JAX package's (several chunks under a cut
    budget)."""
    gs, _ = cluster
    _cut_budget(monkeypatch, 1 << 20)
    ids = tc.pack_scaled_sketches(gs.scaled, gs.names).ids
    got, want = tc.VocabChunkGeometry(ids, max_rows), jc.VocabChunkGeometry(ids, max_rows)
    assert got.n_chunks == want.n_chunks > 1 and got.v_chunk == want.v_chunk
    assert got.widths == want.widths
    np.testing.assert_array_equal(got.starts, want.starts)
    for rows in (np.arange(90), np.array([5, 3, 88, 40]), np.array([], np.int64)):
        for g, w in zip(got.rows_chunks(rows), want.rows_chunks(rows), strict=True):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_rect_plain_equals_jax_rect(cluster):
    """indicator_rect_intersections (on CPU tensors, its plain version)
    equals the JAX package's _intersect_matmul_rect on two packs of one id
    space, each padded with PAD rows, at two vocabulary pads."""
    gs, _ = cluster
    ids = tc.pack_scaled_sketches(gs.scaled, gs.names).ids
    a, b = ids[:40], np.concatenate([ids[30:90], np.full((4, ids.shape[1]), PAD, np.int32)])
    for v_pad in (tc.matmul_vocab_pad(tc.pack_scaled_sketches(gs.scaled, gs.names)), 8192):
        got = ti.indicator_rect_intersections(torch.from_numpy(a), torch.from_numpy(b), v_pad).numpy()
        want = np.asarray(jc._intersect_matmul_rect(jnp.asarray(a), jnp.asarray(b), v_pad=v_pad))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_rect_and_self_from_chunks_equal_jax(cluster, monkeypatch):
    """Summed over the vocabulary chunks of one geometry, the rectangular
    and the self counts equal the JAX package's, and the whole-vocabulary
    counts."""
    gs, _ = cluster
    _cut_budget(monkeypatch, 1 << 20)
    ids = tc.pack_scaled_sketches(gs.scaled, gs.names).ids
    geom = tc.VocabChunkGeometry(ids, 64)
    a_rows, b_rows = np.arange(0, 50), np.arange(20, 90)
    a_c, b_c = geom.rows_chunks(a_rows), geom.rows_chunks(b_rows)
    got = tc.rect_from_chunks([torch.from_numpy(c) for c in a_c], [torch.from_numpy(c) for c in b_c], geom.v_chunk)
    want = jc.rect_from_chunks(a_c, b_c, geom.v_chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    full = jc.intersect_counts_matmul_rect(ids[a_rows], ids[b_rows])
    np.testing.assert_array_equal(got.numpy(), full)
    got_self = tc.self_from_chunks([torch.from_numpy(c) for c in a_c], geom.v_chunk)
    np.testing.assert_array_equal(got_self.numpy(), jc.self_from_chunks(a_c, geom.v_chunk))


@pytest.mark.parametrize("jax_route", ["gather", "matmul"])
@pytest.mark.parametrize("block", [4, 16])
def test_greedy_cluster_equals_jax(cluster, monkeypatch, block, jax_route):
    """Ndb and labels of greedy_secondary_cluster equal the JAX package's at
    two block sizes (block 4: 23 blocks and rep tiles of 16, so ~30
    representatives span two tiles; block 16: 6 blocks), over several
    vocabulary chunks, against both JAX routes."""
    gs, planted = cluster
    _cut_budget(monkeypatch, 1 << 20)
    if jax_route == "matmul":  # the JAX package's TPU route, forced on the CPU
        monkeypatch.setattr(envknobs, "env_bool", lambda name, default=None: name.endswith("GREEDY_MATMUL"))
    indices = list(range(90))
    ndb, labels = tg.greedy_secondary_cluster(gs, None, indices, 3, _kw(), block=block)
    jndb, jlabels = jg.greedy_secondary_cluster(_jax_gs(gs), None, indices, 3, _kw(), block=block)
    assert _ndb_bytes(ndb) == _ndb_bytes(jndb)
    np.testing.assert_array_equal(labels, jlabels)
    n_reps = int(labels.max())
    assert 4 * block < n_reps or block == 16
    # every planted group is one secondary cluster, no two groups share one
    assert len(set(zip(planted, labels))) == len(set(planted)) == n_reps


def test_greedy_cluster_on_mesh_positions_equals_one_device(cluster, monkeypatch):
    """Under --mesh_shape 2 (two CPU positions; 90 genomes >= the mesh's
    64) the block doubles and its rows split over the positions, each on
    the rectangular product: the same Ndb and labels as one device and as
    the JAX package."""
    gs, _ = cluster
    _cut_budget(monkeypatch, 1 << 20)
    calls = []
    rect = tc.indicator_rect_intersections
    monkeypatch.setattr(tc, "indicator_rect_intersections", lambda a, b, v, out=None: calls.append(a.shape[0])
                        or rect(a, b, v, out=out))
    ndb, labels = tg.greedy_secondary_cluster(gs, None, list(range(90)), 1, _kw(mesh_shape=2), block=8)
    assert set(calls) == {8}  # each position's rows of a 16-row block
    one, one_labels = tg.greedy_secondary_cluster(gs, None, list(range(90)), 1, _kw(), block=8)
    jndb, jlabels = jg.greedy_secondary_cluster(_jax_gs(gs), None, list(range(90)), 1, _kw(), block=8)
    assert _ndb_bytes(ndb) == _ndb_bytes(one) == _ndb_bytes(jndb)
    np.testing.assert_array_equal(labels, one_labels)
    np.testing.assert_array_equal(labels, jlabels)


def test_greedy_timings_count_device_passes(cluster):
    gs, _ = cluster
    before = tg.GREEDY_TIMINGS.get("device_calls", 0)
    tg.greedy_secondary_cluster(gs, None, list(range(30)), 1, _kw(), block=8)
    assert tg.GREEDY_TIMINGS["device_calls"] - before == 4  # ceil(30 / 8) blocks
    assert {"host_repack_s", "device_compare_s", "assign_s", "ship_reps_s"} <= set(tg.GREEDY_TIMINGS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_assign_from_matrices_equals_jax(cluster, seed):
    """The small-cluster route: the assignment over given (ani, cov)
    matrices gives the JAX package's Ndb and labels, on matrices where some
    genomes clear the gate only in one coverage direction."""
    gs, _ = cluster
    rng = np.random.default_rng(seed)
    m = 12
    indices = sorted(rng.choice(90, size=m, replace=False).tolist())
    cov = rng.uniform(0.0, 1.0, size=(m, m)).astype(np.float32)
    cov[rng.random((m, m)) < 0.3] = 0.05  # below cov_thresh
    ani = tc.max_containment_ani(cov, gs.k) ** np.float32(0.01)  # spread around S_ani
    ani = ani.astype(np.float32)
    ndb, labels = tg.greedy_assign_from_matrices(gs, indices, 7, _kw(), ani, cov)
    jndb, jlabels = jg.greedy_assign_from_matrices(_jax_gs(gs), indices, 7, _kw(), ani, cov)
    assert _ndb_bytes(ndb) == _ndb_bytes(jndb)
    np.testing.assert_array_equal(labels, jlabels)
    assert 1 < labels.max() < m
