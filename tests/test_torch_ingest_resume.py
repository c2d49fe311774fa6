"""The port's ingest shard store (drep_tpu_torch/ingest.py) against the
JAX package's (drep_tpu/ingest.py), the single-process cases of
tests/test_ingest_resume.py:

- a killed ingest resumes from its shards and sketches only the rest,
  with results identical to an uninterrupted run, and the shards go once
  the whole-run cache is written;
- changed sketch arguments clear the shards;
- sketch_cache_will_hit counts a shard store that covers every genome,
  and refuses a whole-run cache holding a zero-kmer genome;
- shards written by a killed ingest of either package resume in the
  other.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest

import drep_tpu.ingest as jax_ingest
import drep_tpu_torch.ingest as ingest_mod
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.ingest import make_bdb, sketch_cache_will_hit, sketch_genomes
from drep_tpu_torch.ops.kmers import DEFAULT_K
from drep_tpu_torch.utils.profiling import counters
from drep_tpu_torch.workdir import WorkDirectory

KEY = (DEFAULT_K, ingest_mod.DEFAULT_SKETCH_SIZE, ingest_mod.DEFAULT_SCALE, "splitmix64")


def _counting(monkeypatch, mod):
    """Wrap `mod`'s sketcher with a call counter and a kill switch."""
    calls = {"n": 0, "die_after": None}
    real = mod._sketch_one

    def wrapped(job):
        if calls["die_after"] is not None and calls["n"] >= calls["die_after"]:
            raise RuntimeError("simulated kill")
        calls["n"] += 1
        return real(job)

    monkeypatch.setattr(mod, "_sketch_one", wrapped)
    monkeypatch.setattr(mod, "INGEST_SHARD", 2)  # flush every 2 genomes
    return calls


def _assert_same_sketches(got, want):
    assert got.names == want.names
    for a, b in zip(got.bottom, want.bottom):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.scaled, want.scaled):
        np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(got.gdb, want.gdb)


def _shards(wd_loc: str) -> list[str]:
    return glob.glob(os.path.join(wd_loc, "data", "sketch_shards", "*.npz"))


def test_killed_ingest_resumes_from_shards(tmp_path, genome_paths, monkeypatch):
    """test_ingest_resume.py:35."""
    calls = _counting(monkeypatch, ingest_mod)
    wd = WorkDirectory(str(tmp_path / "wd"))
    bdb = make_bdb(genome_paths)  # 5 genomes
    calls["die_after"] = 4
    with pytest.raises(RuntimeError, match="simulated kill"):
        sketch_genomes(bdb, wd=wd)
    assert calls["n"] == 4 and len(_shards(wd.location)) == 2
    calls.update(die_after=None, n=0)
    gs = sketch_genomes(bdb, wd=wd)
    assert calls["n"] == 1  # only the fifth genome
    _assert_same_sketches(gs, sketch_genomes(bdb, wd=WorkDirectory(str(tmp_path / "wd2"))))
    assert not os.path.exists(os.path.join(wd.location, "data", "sketch_shards"))


def test_changed_args_invalidate_sketch_shards(tmp_path, genome_paths, monkeypatch):
    """test_ingest_resume.py:67."""
    calls = _counting(monkeypatch, ingest_mod)
    wd = WorkDirectory(str(tmp_path / "wd"))
    bdb = make_bdb(genome_paths)
    calls["die_after"] = 4
    with pytest.raises(RuntimeError):
        sketch_genomes(bdb, wd=wd)
    calls.update(die_after=None, n=0)
    sketch_genomes(bdb, wd=wd, scale=100)
    assert calls["n"] == len(bdb)


def test_corrupt_shard_is_sketched_again(tmp_path, genome_paths, monkeypatch):
    """A torn shard is counted, removed and its genomes sketched again."""
    calls = _counting(monkeypatch, ingest_mod)
    wd = WorkDirectory(str(tmp_path / "wd"))
    bdb = make_bdb(genome_paths)
    calls["die_after"] = 4
    with pytest.raises(RuntimeError):
        sketch_genomes(bdb, wd=wd)
    torn = sorted(_shards(wd.location))[0]
    with open(torn, "r+b") as f:
        f.truncate(40)
    counters.reset()
    calls.update(die_after=None, n=0)
    gs = sketch_genomes(bdb, wd=wd)
    assert calls["n"] == 3 and counters.faults["corrupt_shards_healed"] == 1
    counters.reset()
    _assert_same_sketches(gs, sketch_genomes(bdb))


def test_sketch_cache_will_hit_sees_shard_complete_store(tmp_path, genome_paths, monkeypatch):
    """test_ingest_resume.py:135, and the JAX probe agrees at each step."""
    from drep_tpu_torch.utils.ckptmeta import open_checkpoint_dir

    calls = _counting(monkeypatch, ingest_mod)
    wd = WorkDirectory(str(tmp_path / "wd"))
    jwd = JaxWorkDirectory(wd.location)
    bdb = make_bdb(genome_paths)
    key = (bdb["genome"], *KEY)

    def hit() -> bool:
        got = sketch_cache_will_hit(wd, *key)
        assert got == jax_ingest.sketch_cache_will_hit(jwd, *key)
        return got

    assert not sketch_cache_will_hit(None, *key)
    assert not hit()
    gs = sketch_genomes(bdb)
    batch = {
        g: {**{k: int(gs.gdb.iloc[i][k]) for k in ("length", "N50", "contigs", "n_kmers")},
            "bottom": gs.bottom[i], "scaled": gs.scaled[i]}
        for i, g in enumerate(gs.names)
    }
    shard_dir = wd.get_dir(ingest_mod._SKETCH_SHARD_SUBDIR)
    snapshot = ingest_mod.sketch_args_snapshot(*key)
    open_checkpoint_dir(shard_dir, ingest_mod._sketch_shard_meta(snapshot), clear_suffixes=(".npz",))
    ingest_mod._save_sketch_shard(os.path.join(shard_dir, "shard_a.npz"), {g: batch[g] for g in gs.names[:3]})
    assert not hit()
    ingest_mod._save_sketch_shard(os.path.join(shard_dir, "shard_b.npz"), {g: batch[g] for g in gs.names[3:]})
    assert not wd.has_arrays("sketches") and hit()
    other = (bdb["genome"], DEFAULT_K, ingest_mod.DEFAULT_SKETCH_SIZE, 100, "splitmix64")
    assert not sketch_cache_will_hit(wd, *other)
    assert len(os.listdir(shard_dir)) == 3  # read only
    calls["n"] = 0
    gs2 = sketch_genomes(bdb, wd=wd)
    assert calls["n"] == 0 and gs2.names == gs.names
    assert hit()


def test_sketch_cache_will_hit_rejects_zero_kmer_stale_cache(tmp_path, genome_paths):
    """test_ingest_resume.py:206."""
    wd = WorkDirectory(str(tmp_path / "wd"))
    bdb = make_bdb(genome_paths)
    key = (bdb["genome"], *KEY)
    sketch_genomes(bdb, wd=wd)
    assert sketch_cache_will_hit(wd, *key)
    gdb = wd.get_db("Gdb")
    gdb.loc[0, "n_kmers"] = 0
    wd.store_db(gdb, "Gdb")
    assert not sketch_cache_will_hit(wd, *key)
    assert not jax_ingest.sketch_cache_will_hit(JaxWorkDirectory(wd.location), *key)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shards_resume_across_packages(tmp_path, genome_paths, monkeypatch, writer):
    """An ingest of one package killed after two shards resumes in the
    other, which sketches only the fifth genome; the assembled cache and
    Gdb are the bytes an uninterrupted run of the writer leaves."""
    port_calls = _counting(monkeypatch, ingest_mod)
    jax_calls = _counting(monkeypatch, jax_ingest)
    bdb = make_bdb(genome_paths)
    loc = str(tmp_path / "wd")
    kill_calls, kill = (jax_calls, lambda: jax_ingest.sketch_genomes(bdb, wd=JaxWorkDirectory(loc))) \
        if writer == "jax" else (port_calls, lambda: sketch_genomes(bdb, wd=WorkDirectory(loc)))
    kill_calls["die_after"] = 4
    with pytest.raises(RuntimeError, match="simulated kill"):
        kill()
    assert len(_shards(loc)) == 2
    if writer == "jax":
        gs = sketch_genomes(bdb, wd=WorkDirectory(loc))
        assert port_calls["n"] == 1
    else:
        gs = jax_ingest.sketch_genomes(bdb, wd=JaxWorkDirectory(loc))
        assert jax_calls["n"] == 1
    assert not os.path.exists(os.path.join(loc, "data", "sketch_shards"))
    port_calls["die_after"] = None
    fresh = str(tmp_path / "fresh")
    sketch_genomes(bdb, wd=WorkDirectory(fresh))
    for rel in (os.path.join("data", "arrays", "sketches.npz"), os.path.join("data_tables", "Gdb.csv")):
        with open(os.path.join(loc, rel), "rb") as f, open(os.path.join(fresh, rel), "rb") as g:
            assert f.read() == g.read()
    assert gs.names == list(bdb["genome"])
