"""The port's ingest against the JAX package's: the same sketches from the
fixture FASTAs, and one workdir sketch cache readable by both."""

import numpy as np
import pandas as pd
import pytest

import drep_tpu.ingest as jingest
import drep_tpu_torch.ingest as tingest
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.ops import kmers
from drep_tpu_torch.sketch_worker import sketch_one
from drep_tpu_torch.workdir import WorkDirectory


def _assert_same_sketches(got, want):
    assert list(got.names) == list(want.names)
    assert (got.k, got.sketch_size, got.scale) == (want.k, want.sketch_size, want.scale)
    for a, b in zip(got.bottom, want.bottom):
        assert a.dtype == np.uint64 and np.array_equal(a, b)
    for a, b in zip(got.scaled, want.scaled):
        assert a.dtype == np.uint64 and np.array_equal(a, b)
    pd.testing.assert_frame_equal(
        got.gdb.reset_index(drop=True), want.gdb.reset_index(drop=True), check_dtype=False
    )


@pytest.mark.parametrize("hash_name", ["splitmix64", "murmur3"])
def test_fixture_sketches_equal_jax(genome_paths, hash_name):
    bdb = tingest.make_bdb(genome_paths)
    got = tingest.sketch_genomes(bdb, sketch_size=500, scale=100, hash_name=hash_name)
    want = jingest.sketch_genomes(bdb, sketch_size=500, scale=100, hash_name=hash_name)
    _assert_same_sketches(got, want)
    assert all(len(b) == 500 for b in got.bottom)


def test_numpy_path_equals_native(genome_paths):
    """The port's native C++ ingest and its numpy path agree byte for byte."""
    from drep_tpu_torch.ops.kmers import hash_kmers, packed_kmers, sketches_from_raw
    from drep_tpu_torch.utils.fasta import read_fasta_contigs

    path = genome_paths[0]
    _, native = sketch_one(("g", path, 21, 300, 50, "splitmix64"))
    raw = np.concatenate([hash_kmers(packed_kmers(c, 21), 21) for c in read_fasta_contigs(path)])
    bottom, scaled, n_kmers = sketches_from_raw(raw, 300, 50)
    assert np.array_equal(native["bottom"], bottom)
    assert np.array_equal(native["scaled"], scaled)
    assert native["n_kmers"] == n_kmers
    assert kmers.DEFAULT_K == 21


def _poison(monkeypatch, module):
    def boom(*a, **k):
        raise AssertionError("the sketch cache should have been loaded, not recomputed")

    monkeypatch.setattr(module, "_sketch_one", boom)


def test_jax_written_cache_loads_in_port(tmp_path, genome_paths, monkeypatch):
    bdb = tingest.make_bdb(genome_paths)
    want = jingest.sketch_genomes(bdb, wd=JaxWorkDirectory(str(tmp_path)))
    _poison(monkeypatch, tingest)
    got = tingest.sketch_genomes(bdb, wd=WorkDirectory(str(tmp_path)))
    _assert_same_sketches(got, want)


def test_port_written_cache_loads_in_jax(tmp_path, genome_paths, monkeypatch):
    bdb = tingest.make_bdb(genome_paths)
    want = tingest.sketch_genomes(bdb, wd=WorkDirectory(str(tmp_path)))
    _poison(monkeypatch, jingest)
    got = jingest.sketch_genomes(bdb, wd=JaxWorkDirectory(str(tmp_path)))
    _assert_same_sketches(got, want)


def test_sketches_from_arrays_carries_jax_state(genome_paths):
    bdb = tingest.make_bdb(genome_paths[:2])
    jgs = jingest.sketch_genomes(bdb, sketch_size=200)
    gs = tingest.sketches_from_arrays(
        jgs.names, jgs.bottom, jgs.scaled, jgs.gdb, jgs.k, jgs.sketch_size, jgs.scale
    )
    assert isinstance(gs, tingest.GenomeSketches)
    _assert_same_sketches(gs, jgs)


def test_make_bdb_rejects_missing_files(tmp_path):
    from drep_tpu_torch.errors import UserInputError

    with pytest.raises(UserInputError, match="do not exist"):
        tingest.make_bdb([str(tmp_path / "nope.fasta")])
