"""The port's multiround primary (cluster/multiround.py) and tertiary
clustering (cluster/tertiary.py) through d_cluster_wrapper, against the
JAX package's on the same planted sketch cache: labels, and Cdb and Ndb
as bytes. Both packages run on one device (mesh_shape 1) with chunks
below 512 genomes, where the JAX package's CPU `auto` stays on the sort
estimator as the port's does. Also the resume warning where the primary
estimator would resolve otherwise than the stored run's.
"""

import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.cluster.controller import d_cluster_wrapper as jax_d_cluster_wrapper
from drep_tpu.cluster.multiround import multiround_primary_clustering as jax_multiround
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.cluster.controller import CLUSTER_DEFAULTS, STAGE_PAIRS, d_cluster_wrapper
from drep_tpu_torch.cluster.multiround import multiround_primary_clustering
from drep_tpu_torch.ingest import save_sketch_cache
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.synth import planted_sketches
from drep_tpu_torch.workdir import WorkDirectory

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_gs(gs):
    return JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
                             k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale)


def _workdirs(root, gs):
    """(Bdb, port workdir, JAX workdir), both holding `gs` as their sketch
    cache."""
    bdb = pd.DataFrame({"genome": gs.names, "location": [f"/nonexistent/{g}" for g in gs.names]})
    wd = WorkDirectory(str(root / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(root / "jax"))
    jax_save(jwd, _jax_gs(gs))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    return bdb, wd, jwd


def _table(wd, name: str) -> bytes:
    with open(os.path.join(wd.location, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


def _cross_primary_duplicate(n: int, seed: int):
    """Planted sketches whose last genome Y keeps its own bottom sketch
    (its planted primary cluster) but takes genome 0's scaled sketch less
    2% of it: Y and genome 0 lie in two primary clusters at ANI ~0.999, a
    pair only tertiary clustering compares."""
    gs, planted = planted_sketches(n, seed=seed, s_bottom=200, s_scaled=300)
    assert planted[-1] != planted[0]
    x = gs.scaled[0]
    gs.scaled[-1] = np.sort(x[np.random.default_rng(seed).random(len(x)) >= 0.02])
    return gs


@pytest.mark.parametrize("estimator", ["auto", "matmul"])
@pytest.mark.parametrize("chunk", [50, 90])
def test_multiround_equals_jax(tmp_path, chunk, estimator):
    """200 planted genomes in chunks of 50 or 90 (planted clusters cut by
    the chunk bounds, merged in round 2): the labels and pairs of
    multiround_primary_clustering, and Cdb and Ndb of d_cluster_wrapper,
    equal the JAX package's; neither writes an Mdb."""
    gs, planted = planted_sketches(200, seed=5, s_bottom=200, s_scaled=300)
    kw = {**CLUSTER_DEFAULTS, "primary_chunksize": chunk, "primary_estimator": estimator, "mesh_shape": 1,
          "device": CPU}
    labels, pairs = multiround_primary_clustering(gs, None, kw)
    jlabels, jpairs = jax_multiround(_jax_gs(gs), None, kw)
    np.testing.assert_array_equal(labels, jlabels)
    assert pairs == jpairs
    assert len(set(zip(planted, labels))) == len(set(planted)) == labels.max()

    bdb, wd, jwd = _workdirs(tmp_path, gs)
    args = {"MASH_sketch": gs.sketch_size, "processes": 1, "mesh_shape": 1, "primary_estimator": estimator,
            "multiround_primary_clustering": True, "primary_chunksize": chunk}
    d_cluster_wrapper(wd, bdb, device="cpu", **args)
    assert STAGE_PAIRS["primary_compare"] == pairs
    jax_d_cluster_wrapper(jwd, bdb, **args)
    for table in ("Cdb", "Ndb"):
        assert _table(wd, table) == _table(jwd, table)
    assert not wd.hasDb("Mdb") and not jwd.hasDb("Mdb")
    resolved = "multiround_" + ("sort" if estimator == "auto" else "matmul")
    assert wd.get_arguments("cluster")["primary_estimator_resolved"] == resolved


@pytest.mark.parametrize("greedy", [False, True])
def test_tertiary_merges_cross_primary_duplicate_equal_jax(tmp_path, greedy):
    """Tertiary clustering (alone, and after the greedy secondary) merges
    the planted cross-primary duplicate's secondary cluster into genome
    0's, with Cdb and Ndb (the tertiary rows: cross-primary pairs, primary
    cluster 0) byte-identical to the JAX package's."""
    gs = _cross_primary_duplicate(120, seed=3)
    bdb, wd, jwd = _workdirs(tmp_path, gs)
    args = {"MASH_sketch": gs.sketch_size, "processes": 1, "mesh_shape": 1, "run_tertiary_clustering": True,
            "greedy_secondary_clustering": greedy}
    cdb = d_cluster_wrapper(wd, bdb, device="cpu", **args)
    jax_d_cluster_wrapper(jwd, bdb, **args)
    for table in ("Cdb", "Ndb"):
        assert _table(wd, table) == _table(jwd, table)
    by = cdb.set_index("genome")
    y, x = gs.names[-1], gs.names[0]
    assert by.loc[y, "primary_cluster"] != by.loc[x, "primary_cluster"]
    assert by.loc[y, "secondary_cluster"] == by.loc[x, "secondary_cluster"]
    ndb = pd.read_csv(os.path.join(wd.location, "data_tables", "Ndb.csv"))
    assert (ndb["primary_cluster"] == 0).any()

    # without tertiary the two stay apart; the merge moves exactly Y's
    # secondary cluster, into genome 0's
    other = WorkDirectory(str(tmp_path / "plain"))
    save_sketch_cache(other, gs)
    plain = d_cluster_wrapper(other, bdb, device="cpu", **{**args, "run_tertiary_clustering": False})
    before = plain.set_index("genome")["secondary_cluster"]
    assert before[y] != before[x]
    moved = set(before.index[before != by["secondary_cluster"].loc[before.index]])
    assert moved == set(before.index[before == before[y]])


def test_tertiary_without_a_duplicate_leaves_cdb(tmp_path):
    """Planted clusters far apart: tertiary merges nothing and Cdb equals
    the run without it, byte for byte; its Ndb rows are all cross-primary."""
    gs, _ = planted_sketches(80, seed=6, s_bottom=200, s_scaled=300)
    bdb, wd, _ = _workdirs(tmp_path, gs)
    args = {"MASH_sketch": gs.sketch_size, "processes": 1, "mesh_shape": 1}
    d_cluster_wrapper(wd, bdb, device="cpu", run_tertiary_clustering=True, **args)
    other = WorkDirectory(str(tmp_path / "plain"))
    save_sketch_cache(other, gs)
    d_cluster_wrapper(other, bdb, device="cpu", **args)
    assert _table(wd, "Cdb") == _table(other, "Cdb")
    ndb, plain_ndb = (pd.read_csv(os.path.join(w.location, "data_tables", "Ndb.csv")) for w in (wd, other))
    tert = ndb.iloc[len(plain_ndb):]
    assert len(tert) > 0 and (tert["primary_cluster"] == 0).all()


def test_resume_warns_where_the_estimator_resolves_otherwise(tmp_path):
    """A workdir whose primary ran the ring (--mesh_shape 4) resumed on one
    position: the estimator now resolves to `sort`, not `ring_sort`; the
    run warns as the JAX package does and keeps the stored tables."""
    gs, _ = planted_sketches(80, seed=7, s_bottom=200, s_scaled=300)
    bdb, wd, _ = _workdirs(tmp_path, gs)
    args = {"MASH_sketch": gs.sketch_size, "processes": 1}
    d_cluster_wrapper(wd, bdb, device="cpu", mesh_shape=4, **args)
    assert wd.get_arguments("cluster")["primary_estimator_resolved"] == "ring_sort"
    cdb = _table(wd, "Cdb")

    seen: list[logging.LogRecord] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = seen.append
    get_logger().addHandler(handler)
    try:
        d_cluster_wrapper(wd, bdb, device="cpu", mesh_shape=4, **args)
        assert not seen  # the same resolution: no warning
        d_cluster_wrapper(wd, bdb, device="cpu", mesh_shape=None, **args)
    finally:
        get_logger().removeHandler(handler)
    msgs = [r.getMessage() for r in seen]
    assert len(msgs) == 1 and "'ring_sort'" in msgs[0] and "'sort'" in msgs[0] and "boundary" in msgs[0]
    assert _table(wd, "Cdb") == cdb
