"""The port's streaming primary (drep_tpu_torch/parallel/streaming.py)
against the JAX package's drep_tpu/parallel/streaming.py on the same
packs, and against the port's own dense Mash matrix.

- retained edges: (ii, jj) equal and in the same order, dist within the
  JAX streaming test's rtol=1e-6 (tests/test_streaming.py), pairs computed
  equal — on the dense walk, the pruned walk and the min_col rectangle;
- against the port's dense all_vs_all_mash thresholded at the same keep:
  the same pairs and bit-identical distances;
- shard stores resume across the two packages with no pair recomputed;
- sparse UPGMA (native, Python, the JAX package's) label for label;
- d_cluster_wrapper on both packages: Cdb/Ndb bytes equal, Mdb within
  tests/test_torch_e2e.py's atol=1e-7.

Blocks and sizes are picked where both packages' block rules give the
same tiles (128 rows at widths up to 256, or one tile), so the edge order
and the store metas agree.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.cluster.controller import d_cluster_wrapper as jax_d_cluster_wrapper
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.ops import linkage as jax_linkage
from drep_tpu.ops import lsh as jax_lsh
from drep_tpu.ops.minhash import PackedSketches as JaxPacked
from drep_tpu.parallel import streaming as jax_streaming
from drep_tpu.utils.synth import planted_group_sketches
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.cluster.controller import d_cluster_wrapper
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.ingest import save_sketch_cache
from drep_tpu_torch.ops import linkage, lsh, mash
from drep_tpu_torch.ops.minhash import PackedSketches
from drep_tpu_torch.parallel import streaming
from drep_tpu_torch.utils.synth import planted_sketches
from drep_tpu_torch.workdir import WorkDirectory

CPU = torch.device("cpu")
KEEP = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packs(n=300, s=64, groups=6, seed=0, contiguous=True):
    """(port pack, JAX pack) of one group-pool planting: genomes of a
    group share most ids, groups share almost none."""
    p = planted_group_sketches(n=n, s=s, groups=groups, seed=seed, contiguous=contiguous)
    return (PackedSketches(ids=p.ids, counts=p.counts, names=list(p.names)),
            JaxPacked(ids=p.ids, counts=p.counts, names=list(p.names)))


def _assert_edges_equal_jax(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2].dtype == want[2].dtype
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert got[3] == want[3]


def _assert_edges_identical(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


WALKS = {
    "dense": {},
    "pruned_bands0": {"prune": 0},
    "pruned_bands4": {"prune": 4},
    "min_col": {"min_col": 150},
    "min_col_pruned": {"min_col": 150, "prune": 0},
}


def _walk_kwargs(walk: str, tp, jp):
    """(port kwargs, JAX kwargs) of one walk: the candidate sets are
    built by each package from its own pack."""
    spec = WALKS[walk]
    tk, jk = {"min_col": spec.get("min_col", 0)}, {"min_col": spec.get("min_col", 0)}
    if "prune" in spec:
        tk["prune"] = lsh.build_candidates(tp, keep=KEEP, k=21, bands=spec["prune"])
        jk["prune"] = jax_lsh.build_candidates(jp, keep=KEEP, k=21, bands=spec["prune"])
    return tk, jk


@pytest.mark.parametrize("walk", list(WALKS))
def test_streaming_edges_equal_jax(walk):
    tp, jp = _packs()
    tk, jk = _walk_kwargs(walk, tp, jp)
    got = streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, device=CPU, **tk)
    stats = dict(streaming.STATS)
    want = jax_streaming.streaming_mash_edges(jp, k=21, cutoff=KEEP, block=128, **jk)
    _assert_edges_equal_jax(got, want)
    assert len(got[0]) > 300
    # one launch a stripe; the contiguous groups leave the far corner tile
    # without a candidate at bands 0
    assert stats["launches"] == stats["stripes"] == 3
    assert (stats["tiles_skipped"] > 0) == (WALKS[walk].get("prune") == 0)


@pytest.mark.parametrize("block,keep,pruned", [(128, 0.1, False), (128, KEEP, True), (256, KEEP, False),
                                               (1024, 0.6, False)])
def test_streaming_edges_bit_identical_to_dense(block, keep, pruned):
    """The keep test reads the dense transform's own table: the pairs are
    the dense matrix's at keep, and their distances its entries, bit for
    bit (ragged rows included)."""
    tp, _ = _packs(n=290, s=96, groups=5, seed=block, contiguous=False)
    rng = np.random.default_rng(block)
    for r in rng.choice(tp.n, size=60, replace=False):  # ragged rows
        c = int(rng.integers(1, tp.ids.shape[1]))
        tp.ids[r, c:] = 2**31 - 1
        tp.counts[r] = c
    prune = lsh.build_candidates(tp, keep=keep, k=21) if pruned else None
    ii, jj, dd, pairs = streaming.streaming_mash_edges(tp, k=21, cutoff=keep, block=block, prune=prune, device=CPU)
    dist, _ = mash.all_vs_all_mash(tp, k=21, device=CPU)
    wi, wj = np.nonzero(np.triu(dist <= keep, 1))
    order = np.lexsort((jj, ii))
    np.testing.assert_array_equal(ii[order], wi)
    np.testing.assert_array_equal(jj[order], wj)
    assert dd[order].tobytes() == dist[wi, wj].tobytes()
    if not pruned:
        assert pairs == tp.n * (tp.n - 1) // 2


@pytest.mark.parametrize("alg", ["average", "single"])
@pytest.mark.parametrize("prune", ["off", "lsh"])
def test_streaming_primary_clusters_equal_jax(alg, prune):
    tp, jp = _packs(n=240, groups=12, seed=5)
    kw = dict(k=21, p_ani=0.9, block=128, keep_dist=0.25 if alg == "average" else 0.0,
              cluster_alg=alg, primary_prune=prune)
    labels, edges, pairs = streaming.streaming_primary_clusters(tp, device=CPU, **kw)
    jlabels, jedges, jpairs = jax_streaming.streaming_primary_clusters(jp, **kw)
    np.testing.assert_array_equal(labels, jlabels)
    _assert_edges_equal_jax((*edges, pairs), (*jedges, jpairs))
    assert labels.max() == 12


def test_streaming_rejects_other_linkage_before_computing(monkeypatch):
    tp, _ = _packs(n=20)
    monkeypatch.setattr(streaming, "streaming_mash_edges", None)
    with pytest.raises(ValueError, match="average or single"):
        streaming.streaming_primary_clusters(tp, k=21, p_ani=0.9, cluster_alg="complete", device=CPU)
    with pytest.raises(ValueError, match="off or lsh"):
        streaming.streaming_primary_clusters(tp, k=21, p_ani=0.9, primary_prune="minhash", device=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sparse_average_linkage_native_python_jax(seed):
    """Random edge sets (duplicates and self-pairs included): the native
    replica, the Python heap and the JAX package give one partition and
    one count of approximate merges."""
    rng = np.random.default_rng(seed)
    n = 120
    groups = rng.integers(0, 15, size=n)
    m = 900
    ii, jj = rng.integers(0, n, m), rng.integers(0, n, m)
    same = groups[ii] == groups[jj]
    dd = np.where(same, rng.uniform(0.0, 0.04, m), rng.uniform(0.08, 0.3, m)).astype(np.float32)
    kept = dd <= 0.12
    ii, jj, dd = ii[kept], jj[kept], dd[kept]
    native = linkage.sparse_average_linkage(n, ii, jj, dd, 0.1, 0.12)
    python = linkage.sparse_average_linkage_python(n, ii, jj, dd, 0.1, 0.12)
    want = jax_linkage.sparse_average_linkage(n, ii, jj, dd, 0.1, 0.12)
    for got in (native, python):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert native[0].max() < n and native[1] > 0  # some merges averaged over unobserved pairs
    assert linkage.sparse_average_linkage(0, ii[:0], jj[:0], dd[:0], 0.1, 0.12)[0].size == 0


def test_connected_components_and_owner_equal_jax():
    rng = np.random.default_rng(7)
    ii, jj = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    np.testing.assert_array_equal(streaming.connected_components(50, ii, jj),
                                  jax_streaming.connected_components(50, ii, jj))
    for n_blocks in (1, 6, 7):
        for pc in (1, 2, 3):
            assert [streaming.stripe_owner(b, n_blocks, pc) for b in range(n_blocks)] == \
                [jax_streaming.stripe_owner(b, n_blocks, pc) for b in range(n_blocks)]
    for alg in ("average", "single"):
        for cutoff, kd in ((0.1, 0.25), (0.1, 0.0), (0.5, 0.3)):
            assert streaming.retention_bound(cutoff, kd, alg) == jax_streaming.retention_bound(cutoff, kd, alg)


def _shards(ck: str) -> list[str]:
    return sorted(glob.glob(os.path.join(ck, "row_*.npz")))


def test_resume_recomputes_only_missing_and_corrupt_shards(tmp_path):
    tp, _ = _packs(n=400)
    ck = str(tmp_path / "ck")
    want = streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, device=CPU)
    shards = _shards(ck)
    assert [os.path.basename(p) for p in shards] == [f"row_{b:05d}.npz" for b in range(4)]
    again = streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, device=CPU)
    _assert_edges_identical(again, want[:3])
    assert again[3] == 0 and streaming.STATS["launches"] == 0
    os.remove(shards[0])
    with open(shards[2], "r+b") as f:  # a torn shard reads corrupt
        f.truncate(40)
    got = streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, device=CPU)
    _assert_edges_identical(got, want[:3])
    redone = sum(streaming._real_pairs_in_tile(bi * 128, bj * 128, 128, tp.n)
                 for bi in (0, 2) for bj in range(bi, 4))
    assert got[3] == redone and streaming.STATS["stripes_resumed"] == 2
    # a store under another cutoff is cleared and recomputed whole
    other = streaming.streaming_mash_edges(tp, k=21, cutoff=0.1, block=128, checkpoint_dir=ck, device=CPU)
    assert other[3] == tp.n * (tp.n - 1) // 2


def test_prune_param_change_refuses_resume(tmp_path):
    """A store written under one banding config refuses a resume under
    another (and pruning on -> off), and keeps its shards."""
    tp, _ = _packs()
    ck = str(tmp_path / "ck")
    cand = lsh.build_candidates(tp, keep=KEEP, k=21)
    streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, prune=cand, device=CPU)
    before = _shards(ck)
    for prune in (lsh.build_candidates(tp, keep=KEEP, k=21, bands=4), None):
        with pytest.raises(UserInputError, match="pruning parameters"):
            streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, prune=prune,
                                           device=CPU)
    assert _shards(ck) == before
    assert streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, prune=cand,
                                          device=CPU)[3] == 0


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_resumes_across_packages(tmp_path, writer, pruned):
    """A store written by one package resumes in the other with no pair
    recomputed and the same edges; the metas are equal key for key."""
    tp, jp = _packs()
    ck = str(tmp_path / "ck")
    tk, jk = _walk_kwargs("pruned_bands0" if pruned else "dense", tp, jp)

    def port():
        return streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, device=CPU, **tk)

    def jax():
        return jax_streaming.streaming_mash_edges(jp, k=21, cutoff=KEEP, block=128, checkpoint_dir=ck, **jk)

    first, second = (jax, port) if writer == "jax" else (port, jax)
    want = first()
    with open(os.path.join(ck, "meta.json"), "rb") as f:
        meta = f.read()
    got = second()
    assert got[3] == 0 and want[3] > 0
    _assert_edges_identical(got, want[:3])
    with open(os.path.join(ck, "meta.json"), "rb") as f:
        assert f.read() == meta  # the second package found its meta there
    port_fresh = streaming.streaming_mash_edges(tp, k=21, cutoff=KEEP, block=128, device=CPU, **tk)
    _assert_edges_equal_jax(port_fresh[:3] + (want[3],), want)


def _planted_workdirs(root, gs):
    """(Bdb, port workdir, JAX workdir), both holding `gs` as their
    sketch cache."""
    bdb = pd.DataFrame({"genome": gs.names, "location": [f"/nonexistent/{g}" for g in gs.names]})
    wd = WorkDirectory(str(root / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(root / "jax"))
    jax_save(jwd, JaxGenomeSketches(
        names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
        k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale,
    ))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    return bdb, wd, jwd


def _table(wd: str, name: str) -> bytes:
    with open(os.path.join(wd, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kwargs", [
    {"streaming_primary": True},
    {"streaming_primary": True, "primary_prune": "lsh"},
    {"streaming_threshold": 150},
    {"streaming_threshold": 150, "clusterAlg": "single"},
    {"streaming_primary": True, "primary_prune": "lsh", "prune_bands": 4, "prune_min_shared": 1,
     "prune_join_chunk": 500, "clusterAlg": "single"},
], ids=["streaming", "lsh", "threshold", "threshold_single", "lsh_knobs_single"])
def test_d_cluster_wrapper_streaming_equals_jax(tmp_path, kwargs):
    """Planted genomes through both d_cluster_wrappers on the streaming
    primary: the port takes the streaming route (one Mash launch a
    stripe), and Cdb/Ndb are byte-identical to the JAX package's."""
    gs, planted = planted_sketches(200, seed=6, s_bottom=200, s_scaled=300)
    bdb, wd, jwd = _planted_workdirs(tmp_path, gs)
    kw = {"MASH_sketch": gs.sketch_size, "processes": 1, "streaming_block": 128, **kwargs}
    cdb = d_cluster_wrapper(wd, bdb, device="cpu", **kw)
    assert wd.get_arguments("cluster")["primary_estimator_resolved"] == "streaming_sort"
    assert streaming.STATS["launches"] == streaming.STATS["stripes"] - streaming.STATS["stripes_resumed"] > 0
    assert sorted(os.listdir(os.path.join(wd.location, "data", "streaming_primary"))) == \
        ["meta.json", "row_00000.npz", "row_00001.npz"]
    jax_d_cluster_wrapper(jwd, bdb, **kw)
    for table in ("Cdb", "Ndb"):
        assert _table(wd.location, table) == _table(jwd.location, table)
    got = pd.read_csv(os.path.join(wd.location, "data_tables", "Mdb.csv"))
    want = pd.read_csv(os.path.join(jwd.location, "data_tables", "Mdb.csv"))
    assert got[["genome1", "genome2"]].equals(want[["genome1", "genome2"]])
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-7)
    np.testing.assert_allclose(got["similarity"], want["similarity"], atol=1e-7)
    sec = cdb.set_index("genome").loc[gs.names, "secondary_cluster"].to_numpy()
    assert len(set(zip(planted, sec))) == len(set(planted)) == len(set(sec))
