"""The port's per-cluster secondary checkpoints
(drep_tpu_torch/cluster/secondary_ckpt.py and the controller's resume)
against the JAX package's (drep_tpu/cluster/secondary_ckpt.py,
tests/test_secondary_ckpt.py):

- the store: save/load round trip, a changed snapshot or primary
  partition clears it, a corrupt file is recomputed, a disabled store
  does nothing; the payload bytes are the JAX package's; writer processes
  write the files once started (this process before, and while injection
  is on), and a failed write raises at the next flush;
- the pipeline resumes from it with both secondary engines patched to
  raise, and a store written by either package resumes in the other,
  with Cdb and Ndb byte-identical to an uninterrupted run;
- a run killed in the secondary loop (an injected fault past its
  retries) has checkpointed exactly the clusters of the batches before
  it, and the rerun launches only the batches left.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from drep_tpu.cluster import controller as jax_controller
from drep_tpu.cluster import dispatch as jax_dispatch
from drep_tpu.cluster.secondary_ckpt import SecondaryCheckpoint as JaxSecondaryCheckpoint
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu.workflows import compare_wrapper as jax_compare
from drep_tpu_torch.cluster import controller, dispatch, secondary_ckpt
from drep_tpu_torch.cluster.secondary_ckpt import SecondaryCheckpoint
from drep_tpu_torch.ingest import save_sketch_cache
from drep_tpu_torch.parallel.faulttol import FaultTolError
from drep_tpu_torch.utils import durableio, faults
from drep_tpu_torch.utils.profiling import counters
from drep_tpu_torch.utils.synth import planted_sketches
from drep_tpu_torch.workdir import WorkDirectory
from drep_tpu_torch.workflows import compare_wrapper


@pytest.fixture(autouse=True)
def _clean():
    faults.configure(None)
    counters.reset()
    yield
    faults.configure(None)
    counters.reset()


def _mk(cls, tmp_path, snapshot=None, primary=None, names=None):
    return cls(
        str(tmp_path / "ckpt"),
        snapshot if snapshot is not None else {"S_ani": 0.95},
        primary if primary is not None else np.array([1, 1, 2]),
        names if names is not None else ["a", "b", "c"],
    )


def _payload():
    ndb = pd.DataFrame({"reference": ["a"], "querry": ["b"], "ani": [0.97]})
    return ndb, np.array([1, 1]), np.empty((0, 4))


def _save(store, pc: int, *result) -> None:
    """Save, and wait for the file: the port's store has a started
    writer process write it (then stops the processes)."""
    if isinstance(store, SecondaryCheckpoint):
        _started(store)
    store.save(pc, *result)
    if isinstance(store, SecondaryCheckpoint):
        store.close()


def _started(ck):
    ck.start()
    assert all(w.ready.wait(60) for w in ck._writers)
    return ck


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_load_roundtrip(tmp_path, writer):
    first = SecondaryCheckpoint if writer == "torch" else JaxSecondaryCheckpoint
    ndb, labels, link = _payload()
    _save(_mk(first, tmp_path), 1, ndb, labels, link)
    ck2 = _mk(SecondaryCheckpoint, tmp_path)
    got = ck2.load(1)
    assert got is not None
    pd.testing.assert_frame_equal(got[0], ndb)
    np.testing.assert_array_equal(got[1], labels)
    assert ck2.n_resumed == 1
    assert ck2.load(2) is None


def test_payload_and_meta_bytes_equal_jax(tmp_path):
    for cls, sub in ((SecondaryCheckpoint, "t"), (JaxSecondaryCheckpoint, "j")):
        _save(_mk(cls, tmp_path / sub), 7, *_payload())
    for name in ("meta.json", "pc_000007.npz"):
        assert (tmp_path / "t" / "ckpt" / name).read_bytes() == (tmp_path / "j" / "ckpt" / name).read_bytes()


def test_snapshot_change_invalidates(tmp_path):
    _save(_mk(SecondaryCheckpoint, tmp_path), 1, *_payload())
    assert _mk(SecondaryCheckpoint, tmp_path, snapshot={"S_ani": 0.99}).load(1) is None


def test_primary_partition_change_invalidates(tmp_path):
    _save(_mk(SecondaryCheckpoint, tmp_path), 1, *_payload())
    assert _mk(SecondaryCheckpoint, tmp_path, primary=np.array([1, 2, 2])).load(1) is None


def test_corrupt_checkpoint_recomputed(tmp_path):
    _save(_mk(SecondaryCheckpoint, tmp_path), 1, *_payload())
    path = glob.glob(str(tmp_path / "ckpt" / "pc_*.npz"))[0]
    with open(path, "wb") as f:
        f.write(b"garbage")
    ck2 = _mk(SecondaryCheckpoint, tmp_path)
    assert ck2.load(1) is None and ck2.n_resumed == 0
    assert not os.path.exists(path)
    assert counters.faults["corrupt_shards_healed"] == 1


def test_disabled_is_noop():
    ck = SecondaryCheckpoint(None, {}, np.array([1]), ["a"])
    ck.save(1, *_payload())
    assert ck.load(1) is None
    ck.finish(1)


def test_saves_are_written_by_the_writer_processes(tmp_path, monkeypatch):
    """Once started, the writer processes write the files (this process's
    atomic_savez is never called), a save on each idle writer; finish
    leaves every file on disk, readable, and stops the processes."""
    def not_here(*a, **k):
        raise AssertionError("written in the caller's process")

    ck = _started(_mk(SecondaryCheckpoint, tmp_path))
    monkeypatch.setattr(durableio, "atomic_savez", not_here)
    ck.save_many([(1, *_payload()), (2, *_payload())])
    ck.save(3, *_payload())
    writers = list(ck._writers)
    assert len(writers) == secondary_ckpt.WRITERS == 2 and all(w.sender is not None for w in writers)
    ck.finish(3)
    assert ck._writers == [] and [w.proc.returncode for w in writers] == [0, 0] and ck.write_s > 0
    monkeypatch.undo()
    ck2 = _mk(SecondaryCheckpoint, tmp_path)
    assert all(ck2.load(pc) is not None for pc in (1, 2, 3)) and ck2.n_resumed == 3


def test_busy_writers_take_the_next_save_in_turn(tmp_path, monkeypatch):
    """With every writer busy, a save waits for the one whose save is
    oldest."""
    monkeypatch.setattr(secondary_ckpt, "WRITERS", 1)
    ck = _started(_mk(SecondaryCheckpoint, tmp_path))
    for pc in (1, 2, 3):
        ck.save(pc, *_payload())
        assert ck._writers[0].submitted == pc
    ck.finish(3)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["meta.json"] + [f"pc_00000{pc}.npz" for pc in (1, 2, 3)]


def test_saves_before_a_writer_starts_are_written_here(tmp_path):
    """A save made while every writer is still starting is written in
    this process, on return; closing kills the writers still starting."""
    ck = _mk(SecondaryCheckpoint, tmp_path)
    ck.save(1, *_payload())  # starts the writers, none started yet
    writers = list(ck._writers)
    assert len(writers) == 2 and (tmp_path / "ckpt" / "pc_000001.npz").exists()
    ck.finish(1)
    assert all(w.proc.poll() is not None for w in writers)


def test_saves_under_injection_are_written_here(tmp_path):
    """While a fault spec is installed the saves are written in this
    process, on return, so the spec's rules see every write in order."""
    faults.configure("secondary_batch:raise:max=1")
    ck = _mk(SecondaryCheckpoint, tmp_path)
    ck.save(1, *_payload())
    assert ck._writers == [] and (tmp_path / "ckpt" / "pc_000001.npz").exists()
    ck.finish(1)


def test_failed_write_raises_at_the_next_flush(tmp_path):
    """A save the writer process cannot publish (its path is a directory)
    raises on the caller's side at the next flush, once; the store and
    its process go on afterwards."""
    ck = _started(_mk(SecondaryCheckpoint, tmp_path))
    (tmp_path / "ckpt" / "pc_000001.npz").mkdir()
    ck.save(1, *_payload())
    with pytest.raises(OSError):
        ck.flush()
    ck.flush()
    ck.save(2, *_payload())
    ck.finish(2)
    assert (tmp_path / "ckpt" / "pc_000002.npz").is_file()


def _table(wd: str, name: str) -> bytes:
    with open(os.path.join(wd, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


def _boom(*a, **k):
    raise AssertionError("secondary recomputed despite valid checkpoints")


def _crash_after_secondary(wd: str) -> None:
    """A run killed after its secondary loop: Cdb and Ndb gone."""
    for name in ("Cdb", "Ndb"):
        os.remove(os.path.join(wd, "data_tables", f"{name}.csv"))


def test_pipeline_resumes_secondary(tmp_path, genome_paths, monkeypatch):
    """Both engines patched to raise: only the checkpoints can finish."""
    wd = str(tmp_path / "wd")
    compare_wrapper(wd, genome_paths, device="cpu", skip_plots=True, processes=1)
    want = {t: _table(wd, t) for t in ("Cdb", "Ndb")}
    assert len(glob.glob(os.path.join(wd, "data", "secondary_checkpoints", "pc_*.npz"))) == 2
    _crash_after_secondary(wd)
    monkeypatch.setattr(controller, "secondary_for_cluster", _boom)
    monkeypatch.setitem(dispatch.SECONDARY_BATCHED, "jax_ani", _boom)
    cdb = compare_wrapper(wd, genome_paths, device="cpu", skip_plots=True, processes=1)
    assert cdb["secondary_cluster"].nunique() == 3
    assert controller.SECONDARY_RESUMED == {"resumed": 2, "clusters": 2}
    assert {t: _table(wd, t) for t in ("Cdb", "Ndb")} == want


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_resumes_across_packages(tmp_path, genome_paths, monkeypatch, writer):
    """A store one package wrote resumes in the other with no secondary
    call, the meta untouched; Cdb and Ndb are the writer's bytes."""
    wd = str(tmp_path / "wd")

    def port():
        compare_wrapper(wd, genome_paths, device="cpu", skip_plots=True, processes=1)

    def jax():
        jax_compare(wd, genome_paths, skip_plots=True, processes=1)

    first, second = (jax, port) if writer == "jax" else (port, jax)
    first()
    want = {t: _table(wd, t) for t in ("Cdb", "Ndb")}
    meta = os.path.join(wd, "data", "secondary_checkpoints", "meta.json")
    with open(meta, "rb") as f:
        meta_bytes = f.read()
    _crash_after_secondary(wd)
    monkeypatch.setattr(controller, "secondary_for_cluster", _boom)
    monkeypatch.setitem(dispatch.SECONDARY_BATCHED, "jax_ani", _boom)
    monkeypatch.setattr(jax_controller, "_secondary_for_cluster", _boom)
    monkeypatch.setitem(jax_dispatch.SECONDARY_BATCHED, "jax_ani", _boom)
    second()
    with open(meta, "rb") as f:
        assert f.read() == meta_bytes
    assert {t: _table(wd, t) for t in ("Cdb", "Ndb")} == want


def _planted(root, n=150, seed=5):
    """(Bdb, port workdir, JAX workdir) holding one planted sketch set as
    their sketch cache; the genome files do not exist."""
    gs, _ = planted_sketches(n, seed=seed, s_bottom=200, s_scaled=300)
    bdb = pd.DataFrame({"genome": gs.names, "location": [f"/nonexistent/{g}" for g in gs.names]})
    wd = WorkDirectory(str(root / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(root / "jax"))
    jax_save(jwd, JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled, k=gs.k,
                                    sketch_size=gs.sketch_size, scale=gs.scale))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    return bdb, wd, jwd


def test_killed_secondary_resumes_the_batches_left(tmp_path, monkeypatch):
    """chip_smoke phase 14a on the CPU: batches of at most 24 rows; the
    third engine call fails past --fault_retries 1, so FaultTolError ends
    the run with exactly the first two batches' clusters checkpointed;
    the rerun resumes them and calls the engine for the batches left;
    Cdb and Ndb equal an uninterrupted run's, and the JAX package's."""
    monkeypatch.setattr(controller, "BATCH_ROWS_MAX", 24)
    bdb, wd, jwd = _planted(tmp_path)
    calls = []
    real = dispatch.SECONDARY_BATCHED["jax_ani"]

    def counted(gs, clusters, **kw):
        calls.append([len(ix) for ix in clusters])
        return real(gs, clusters, **kw)

    monkeypatch.setitem(dispatch.SECONDARY_BATCHED, "jax_ani", counted)
    _, clean, _ = _planted(tmp_path / "clean")
    controller.d_cluster_wrapper(clean, bdb, device="cpu", MASH_sketch=200)
    n_batches = len(calls)
    assert n_batches >= 4 and controller.SECONDARY_RESUMED["resumed"] == 0

    cdb = clean.get_db("Cdb")
    sizes = cdb.groupby("primary_cluster").size()
    small = [(int(pc), list(range(int(m)))) for pc, m in sizes.items() if m > 1]
    batches = controller.batch_small_clusters(small)
    assert len(batches) == n_batches
    want_ckpt = sorted(f"pc_{pc:06d}.npz" for batch in batches[:2] for pc, _ in batch)

    calls.clear()
    faults.configure("secondary_batch:raise:skip=2")
    with pytest.raises(FaultTolError, match="secondary_batch: failed after 2 attempts"):
        controller.d_cluster_wrapper(wd, bdb, device="cpu", MASH_sketch=200, fault_retries=1)
    assert len(calls) == 2 and counters.faults["retries"] == 1
    ckpt_dir = os.path.join(wd.location, "data", "secondary_checkpoints")
    assert sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz")) == want_ckpt

    faults.configure(None)
    calls.clear()
    controller.d_cluster_wrapper(wd, bdb, device="cpu", MASH_sketch=200)
    assert len(calls) == n_batches - 2
    assert controller.SECONDARY_RESUMED == {"resumed": len(want_ckpt), "clusters": len(small)}
    for table in ("Cdb", "Ndb"):
        assert _table(wd.location, table) == _table(clean.location, table)
    jax_controller.d_cluster_wrapper(jwd, bdb, MASH_sketch=200)
    for table in ("Cdb", "Ndb"):
        assert _table(wd.location, table) == _table(jwd.location, table)


def test_greedy_route_checkpoints_its_clusters(tmp_path, monkeypatch):
    """The greedy secondary saves each cluster's result too, on both its
    routes, and a rerun resumes them all with Cdb/Ndb unchanged."""
    monkeypatch.setattr(controller, "SMALL_CLUSTER_MAX", 3)  # larger clusters take greedy_secondary_cluster
    bdb, wd, _ = _planted(tmp_path, n=90, seed=7)
    real, large = controller.greedy_secondary_cluster, []
    monkeypatch.setattr(controller, "greedy_secondary_cluster", lambda *a: large.append(a[3]) or real(*a))
    controller.d_cluster_wrapper(wd, bdb, device="cpu", MASH_sketch=200, greedy_secondary_clustering=True)
    multi = controller.SECONDARY_RESUMED["clusters"]
    assert 0 < len(large) < multi  # both routes ran
    want = {t: _table(wd.location, t) for t in ("Cdb", "Ndb")}
    _crash_after_secondary(wd.location)
    monkeypatch.setattr(controller, "greedy_secondary_cluster", _boom)
    monkeypatch.setitem(dispatch.SECONDARY_BATCHED, "jax_ani", _boom)
    controller.d_cluster_wrapper(wd, bdb, device="cpu", MASH_sketch=200, greedy_secondary_clustering=True)
    assert controller.SECONDARY_RESUMED == {"resumed": multi, "clusters": multi}
    assert {t: _table(wd.location, t) for t in ("Cdb", "Ndb")} == want
