"""The Mash distance transform at the cutoff (ROADMAP.md queue 3, F4).

The port takes the sort estimator's float32 log in numpy
(`ops/mash.py::shared_counts_to_distance`), as the JAX package's own
kernel path does on the host (`drep_tpu/ops/pallas_mash.py`, xp=np). The
JAX package's CPU path takes XLA's log instead, 1-2 ulps away on some
entries, so a pair whose distance lies at the cutoff can cluster
differently there. These tests hold the port to the numpy transform:

- (a) `distance_table(w, k)` equals the JAX package's numpy transform bit
  for bit at every (s_use, shared) entry;
- (b) a pair that straddles P_ani 0.806 at width 2000 ((s_use, shared) =
  (1399, 12)) clusters as the JAX package's kernel path clusters it, with
  Cdb.csv and Mdb.csv byte-identical. The JAX package takes that path only
  on a TPU, so the test patches its support check and the kernel runs in
  interpret mode on the CPU.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.cluster.controller import d_cluster_wrapper as jax_d_cluster_wrapper
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.ops import pallas_mash as jax_pallas_mash
from drep_tpu.ops.merge import next_pow2 as jax_next_pow2
from drep_tpu.ops.pallas_merge import PALLAS_MAX_WIDTH
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.cluster.controller import d_cluster_wrapper
from drep_tpu_torch.ingest import GenomeSketches, save_sketch_cache
from drep_tpu_torch.ops import mash
from drep_tpu_torch.workdir import WorkDirectory

WIDTH, P_ANI, S_USE, SHARED = 2000, 0.806, 1399, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [16, 21, 31])
@pytest.mark.parametrize("width", [256, 1000, 1024, 2000, 2048])
def test_distance_table_equals_jax_numpy_transform(width, k):
    s = np.arange(width + 1, dtype=np.int32)
    shared = np.broadcast_to(s[None, :], (width + 1, width + 1))
    want, _ = jax_pallas_mash.shared_counts_to_distance(
        shared, s, np.full(width + 1, width, np.int32), width, k, xp=np
    )
    got = mash.distance_table(width, k)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _straddle_sketches() -> GenomeSketches:
    """g0 and g1: bottom sketches of S_USE and WIDTH hashes sharing their
    SHARED smallest (so (s_use, shared) = (S_USE, SHARED)), g2 unrelated;
    unrelated scaled sketches, so no secondary cluster merges."""
    rng = np.random.default_rng(4)

    def fresh(n, lo):
        return np.unique(rng.integers(lo, 2**63, size=2 * n, dtype=np.uint64))[:n]

    common = np.arange(1, SHARED + 1, dtype=np.uint64)  # below every fresh hash
    bottom = [np.concatenate([common, fresh(S_USE - SHARED, 2**20)]),
              np.concatenate([common, fresh(WIDTH - SHARED, 2**20)]),
              fresh(WIDTH, 2**20)]
    scaled = [fresh(400, 2**20) for _ in range(3)]
    names = [f"g{i}.fasta" for i in range(3)]
    gdb = pd.DataFrame({"genome": names, "length": np.full(3, 4_000_000, np.int64),
                        "N50": np.full(3, 50_000, np.int64), "contigs": np.full(3, 100, np.int64),
                        "n_kmers": np.full(3, 3_900_000, np.int64)})
    return GenomeSketches(names=names, gdb=gdb, bottom=bottom, scaled=scaled, k=21,
                          sketch_size=WIDTH, scale=200)


def _table(loc: str, name: str) -> bytes:
    with open(os.path.join(loc, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("cluster_alg", ["average", "single"])
def test_width_2000_straddle_equals_jax_kernel_path(tmp_path, monkeypatch, cluster_alg):
    gs = _straddle_sketches()
    d = mash.distance_table(WIDTH, gs.k)[S_USE, SHARED]
    assert abs(float(d) - (1.0 - P_ANI)) < 1e-7  # the pair lies at the cutoff
    bdb = pd.DataFrame({"genome": gs.names, "location": [f"/nonexistent/{g}" for g in gs.names]})
    wd = WorkDirectory(str(tmp_path / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(tmp_path / "jax"))
    jax_save(jwd, JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
                                    k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale,
                                                           "splitmix64"))
    args = {"MASH_sketch": WIDTH, "P_ani": P_ANI, "clusterAlg": cluster_alg, "processes": 1, "mesh_shape": 1}
    d_cluster_wrapper(wd, bdb, device="cpu", **args)
    monkeypatch.setattr(jax_pallas_mash, "pallas_mash_supported",
                        lambda w: max(128, jax_next_pow2(w)) <= PALLAS_MAX_WIDTH)
    jax_d_cluster_wrapper(jwd, bdb, **args)
    mdb = pd.read_csv(os.path.join(wd.location, "data_tables", "Mdb.csv"))
    pair = mdb[(mdb["genome1"] == "g0.fasta") & (mdb["genome2"] == "g1.fasta")]
    assert np.float32(pair["dist"].iloc[0]) == d
    for table in ("Cdb", "Mdb"):
        assert _table(wd.location, table) == _table(jwd.location, table)


@pytest.mark.parametrize("op", ["compare", "dereplicate"])
def test_primary_estimator_help_describes_matmul(op):
    """F5: --primary_estimator matmul runs (since item 9a), and its help
    says what it runs."""
    from drep_tpu_torch.argparser import build_parser

    sub = next(a for a in build_parser()._subparsers._group_actions if a.dest == "operation")
    action = next(a for a in sub.choices[op]._actions if a.dest == "primary_estimator")
    assert "not ported" not in action.help
    assert "matmul=common-threshold" in action.help and "indicator_mm.cu" in action.help
