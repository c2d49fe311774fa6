"""The port's compare/dereplicate slice end to end on the CPU, against the
JAX package on the same inputs, plus the guard that keeps the port free of
JAX and of drep_tpu.

Tables are compared as CSV bytes. Mdb is the one exception: its distances
come from a float32 log taken on the device in the JAX package's CPU sort
estimator and in numpy here, so they agree to the repo's atol=1e-7
(tests/test_pallas_mash.py) rather than bit for bit.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.choose import d_choose_wrapper as jax_d_choose_wrapper
from drep_tpu.cluster.controller import d_cluster_wrapper as jax_d_cluster_wrapper
from drep_tpu.cluster.engines import SECONDARY_PATH_COUNTS as JAX_SECONDARY_PATH_COUNTS
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu.workflows import compare_wrapper as jax_compare
from drep_tpu.workflows import dereplicate_wrapper as jax_dereplicate
from drep_tpu_torch.choose import d_choose_wrapper
from drep_tpu_torch.cluster.controller import d_cluster_wrapper
from drep_tpu_torch.cluster.engines import SECONDARY_PATH_COUNTS
from drep_tpu_torch.controller import check_dependencies
from drep_tpu_torch.controller import main as torch_main
from drep_tpu_torch.ops import ring
from drep_tpu_torch.ops.containment import pack_scaled_sketches
from drep_tpu_torch.ingest import save_sketch_cache
from drep_tpu_torch.utils.synth import planted_sketches
from drep_tpu_torch.workdir import WorkDirectory
from drep_tpu_torch.workflows import compare_wrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = (
    "genome,completeness,contamination\ngenome_A.fasta,99,0.5\ngenome_B.fasta,90,1\n"
    "genome_C.fasta,85,2\ngenome_D.fasta,95,0.1\ngenome_E.fasta,94,0.2\n"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(wd: str, name: str) -> bytes:
    with open(os.path.join(wd, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


def _assert_mdb_close(wd: str, jwd: str) -> None:
    got = pd.read_csv(os.path.join(wd, "data_tables", "Mdb.csv"))
    want = pd.read_csv(os.path.join(jwd, "data_tables", "Mdb.csv"))
    assert got[["genome1", "genome2"]].equals(want[["genome1", "genome2"]])
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-7)
    np.testing.assert_allclose(got["similarity"], want["similarity"], atol=1e-7)


@pytest.fixture(scope="module")
def compared(tmp_path_factory, genome_paths):
    root = tmp_path_factory.mktemp("compare")
    wd, jwd = str(root / "torch"), str(root / "jax")
    cdb = compare_wrapper(wd, genome_paths, device="cpu", skip_plots=True)
    jax_compare(jwd, genome_paths, skip_plots=True)
    return wd, jwd, cdb


@pytest.fixture(scope="module")
def dereplicated(tmp_path_factory, genome_paths):
    root = tmp_path_factory.mktemp("dereplicate")
    q = root / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(root / "torch"), str(root / "jax")
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", str(q),
                "--skip_plots", "-p", "1", "--device", "cpu"])
    jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=1)
    return wd, jwd


@pytest.mark.parametrize("table", ["Bdb", "Cdb", "Ndb", "Gdb", "genomeInformation"])
def test_compare_tables_equal_jax_bytes(compared, table):
    wd, jwd, _ = compared
    assert _table(wd, table) == _table(jwd, table)


def test_compare_mdb_close_to_jax(compared):
    wd, jwd, _ = compared
    _assert_mdb_close(wd, jwd)


def test_compare_expected_fixture_clusters(compared):
    _, _, cdb = compared
    sec = dict(zip(cdb["genome"], cdb["secondary_cluster"]))
    assert sec == {
        "genome_A.fasta": "1_1", "genome_B.fasta": "1_1", "genome_C.fasta": "1_2",
        "genome_D.fasta": "2_1", "genome_E.fasta": "2_1",
    }
    assert cdb["primary_cluster"].nunique() == 2
    assert set(cdb["comparison_algorithm"]) == {"jax_ani"}


def test_compare_resume_skips_recompute(compared, genome_paths, monkeypatch):
    wd, _, cdb = compared
    import drep_tpu_torch.cluster.controller as cc

    def boom(*a, **k):
        raise AssertionError("resume should not re-run sketching")

    monkeypatch.setattr(cc, "sketch_genomes", boom)
    again = compare_wrapper(wd, genome_paths, device="cpu", skip_plots=True)
    pd.testing.assert_frame_equal(again, pd.read_csv(os.path.join(wd, "data_tables", "Cdb.csv")))
    assert list(again["secondary_cluster"]) == list(cdb["secondary_cluster"])


@pytest.mark.parametrize(
    "table", ["Bdb", "Cdb", "Ndb", "Sdb", "Wdb", "Widb", "genomeInfo", "genomeInformation"]
)
def test_dereplicate_tables_equal_jax_bytes(dereplicated, table):
    wd, jwd = dereplicated
    assert _table(wd, table) == _table(jwd, table)


def test_dereplicate_winners(dereplicated):
    wd, jwd = dereplicated
    _assert_mdb_close(wd, jwd)
    assert sorted(os.listdir(os.path.join(wd, "dereplicated_genomes"))) == [
        "genome_A.fasta", "genome_C.fasta", "genome_D.fasta",
    ]


def _planted_workdirs(root, gs, placeholders: bool = False):
    """(Bdb, port workdir, JAX workdir), both holding `gs` as their sketch
    cache; with `placeholders`, empty genome files and genomeInformation
    for the choose stage."""
    locs = [f"/nonexistent/{g}" for g in gs.names]
    if placeholders:
        (root / "genomes").mkdir()
        locs = [str(root / "genomes" / g) for g in gs.names]
        for loc in locs:
            open(loc, "wb").close()
    bdb = pd.DataFrame({"genome": gs.names, "location": locs})
    wd = WorkDirectory(str(root / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(root / "jax"))
    jax_save(jwd, JaxGenomeSketches(
        names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
        k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale,
    ))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    if placeholders:
        for w in (wd, jwd):
            w.store_db(gs.gdb[["genome", "length", "N50", "contigs"]], "genomeInformation")
    return bdb, wd, jwd


@pytest.mark.parametrize("n,cluster_size", [(200, None), (80, 40)])
def test_planted_set_cdb_equals_jax(tmp_path, n, cluster_size):
    """Planted genomes through both d_cluster_wrappers from one sketch
    cache (the JAX package stays on its sort estimator below 512 genomes,
    the port's only estimator). ~200 genomes in small clusters take the
    batched secondary; clusters of 40 (> SMALL_CLUSTER_MAX) the
    per-cluster one."""
    gs, planted = planted_sketches(n, seed=4, s_bottom=200, s_scaled=300, cluster_size=cluster_size)
    bdb, wd, jwd = _planted_workdirs(tmp_path, gs)
    kw = {"MASH_sketch": gs.sketch_size, "processes": 1}
    paths_before = dict(SECONDARY_PATH_COUNTS)
    cdb = d_cluster_wrapper(wd, bdb, device="cpu", **kw)
    paths = {p for p, c in SECONDARY_PATH_COUNTS.items() if c != paths_before.get(p, 0)}
    assert paths == ({"one_shot_clusterlocal"} if cluster_size is None else {"one_shot"})
    jax_d_cluster_wrapper(jwd, bdb, **kw)
    for table in ("Cdb", "Ndb"):
        assert _table(wd.location, table) == _table(jwd.location, table)
    _assert_mdb_close(wd.location, jwd.location)
    # every planted cluster is one secondary cluster, and no two share one
    sec = cdb.set_index("genome").loc[gs.names, "secondary_cluster"].to_numpy()
    assert len(set(zip(planted, sec))) == len(set(planted)) == len(set(sec))


@pytest.fixture(scope="module")
def dereplicated_past_budget(tmp_path_factory, genome_paths):
    """The JAX package's dereplicate with its one-shot budget cut to 2^12
    elements: every secondary cluster is past the budget, and off a TPU it
    takes its exact CPU tile walk."""
    root = tmp_path_factory.mktemp("past_budget")
    q = root / "q.csv"
    q.write_text(QUALITY)
    jwd = str(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("drep_tpu.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
        jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=1)
    return str(q), jwd


@pytest.mark.parametrize("route,cost", [("pallas_range", 0.0), ("matmul_chunked", 1e30)])
def test_past_budget_routes_equal_jax_bytes(dereplicated_past_budget, genome_paths, tmp_path,
                                            monkeypatch, route, cost):
    """A dereplicate past the one-shot budget on each beyond-budget route
    (the port's MERGE_VS_MATMUL_ELEM_COST pinned to force it) writes
    Cdb/Ndb/Sdb/Wdb byte-identical to the JAX package's."""
    q, jwd = dereplicated_past_budget
    monkeypatch.setattr("drep_tpu_torch.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    monkeypatch.setattr("drep_tpu_torch.cluster.engines.MERGE_VS_MATMUL_ELEM_COST", cost)
    wd = str(tmp_path / "torch")
    before = dict(SECONDARY_PATH_COUNTS)
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", q,
                "--skip_plots", "-p", "1", "--device", "cpu"])
    assert {p for p, c in SECONDARY_PATH_COUNTS.items() if c != before.get(p, 0)} == {route}
    for table in ("Cdb", "Ndb", "Sdb", "Wdb"):
        assert _table(wd, table) == _table(jwd, table)


def _count_plain_steps(monkeypatch) -> list[int]:
    """Count the port's ring steps (on the CPU each runs the plain step)."""
    calls = [0]
    plain = ring.ring_step_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(ring, "ring_step_plain", counted)
    return calls


@pytest.fixture(scope="module")
def mesh_planted(tmp_path_factory):
    """200 planted genomes through the JAX package's d_cluster_wrapper and
    choose with --mesh_shape 4: the primary runs its ring on 4 of the
    virtual CPU devices."""
    root = tmp_path_factory.mktemp("mesh_planted")
    gs, _ = planted_sketches(200, seed=8, s_bottom=200, s_scaled=300)
    bdb, _, jwd = _planted_workdirs(root, gs, placeholders=True)
    kw = {"MASH_sketch": gs.sketch_size, "processes": 1, "mesh_shape": 4}
    jax_d_cluster_wrapper(jwd, bdb, **kw)
    jax_d_choose_wrapper(jwd, bdb)
    return root, gs, bdb, jwd.location, kw


@pytest.mark.parametrize("ring_comm", ["auto", "ppermute"])
def test_mesh_shape_4_equals_jax_bytes(mesh_planted, monkeypatch, ring_comm):
    """--mesh_shape 4 on the CPU: the port's primary over a 4-position ring
    writes Cdb/Ndb/Sdb/Wdb byte-identical to the JAX package's --mesh_shape
    4 (the JAX CLI's --ring_comm values are accepted and run the one
    ring)."""
    root, gs, bdb, jwd, kw = mesh_planted
    wd = WorkDirectory(str(root / f"torch_{ring_comm}"))
    save_sketch_cache(wd, gs)
    wd.store_db(gs.gdb[["genome", "length", "N50", "contigs"]], "genomeInformation")
    steps = _count_plain_steps(monkeypatch)
    d_cluster_wrapper(wd, bdb, device="cpu", ring_comm=ring_comm, **kw)
    d_choose_wrapper(wd, bdb)
    assert steps[0] == 4 + 4 + 2  # D = 4: steps 0 and 1 on every position, half of step 2
    for table in ("Cdb", "Ndb", "Sdb", "Wdb"):
        assert _table(wd.location, table) == _table(jwd, table)
    _assert_mdb_close(wd.location, jwd)


def test_past_budget_cluster_on_mesh_ring_equals_jax_bytes(tmp_path, monkeypatch):
    """One 80-genome cluster past the one-shot budget (cut to 2^12) with
    --mesh_shape 4: both packages take `mesh_ring` for it, and Cdb/Ndb are
    byte-identical."""
    gs, _ = planted_sketches(80, seed=9, s_bottom=200, s_scaled=300, cluster_size=80)
    bdb, wd, jwd = _planted_workdirs(tmp_path, gs)
    kw = {"MASH_sketch": gs.sketch_size, "processes": 1, "mesh_shape": 4}
    monkeypatch.setattr("drep_tpu.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    monkeypatch.setattr("drep_tpu_torch.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    before, jbefore = dict(SECONDARY_PATH_COUNTS), dict(JAX_SECONDARY_PATH_COUNTS)
    d_cluster_wrapper(wd, bdb, device="cpu", **kw)
    jax_d_cluster_wrapper(jwd, bdb, **kw)
    for counts, start in ((SECONDARY_PATH_COUNTS, before), (JAX_SECONDARY_PATH_COUNTS, jbefore)):
        assert {p: c - start.get(p, 0) for p, c in counts.items() if c != start.get(p, 0)} == {"mesh_ring": 1}
    for table in ("Cdb", "Ndb"):
        assert _table(wd.location, table) == _table(jwd.location, table)
    _assert_mdb_close(wd.location, jwd.location)


def test_wide_past_budget_cluster_on_mesh_ring_equals_one_device(tmp_path, monkeypatch):
    """A 64-genome cluster past the one-shot budget (cut to 2^12) whose
    scaled rows pad to width 65 536, wider than a card's shared memory
    stages: with --mesh_shape 4 it takes `mesh_ring`, and its Cdb, Ndb and
    Mdb are byte-identical to the single-device run's."""
    gs, _ = planted_sketches(64, seed=10, s_bottom=200, s_scaled=30_000, cluster_size=64)
    assert pack_scaled_sketches(gs.scaled, gs.names).ids.shape[1] == 1 << 16
    bdb = pd.DataFrame({"genome": gs.names, "location": [f"/nonexistent/{g}" for g in gs.names]})
    monkeypatch.setattr("drep_tpu_torch.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    kw = {"MASH_sketch": gs.sketch_size, "processes": 1}
    tables = {}
    for mesh_shape in (4, 1):
        wd = WorkDirectory(str(tmp_path / f"mesh{mesh_shape}"))
        save_sketch_cache(wd, gs)
        before = dict(SECONDARY_PATH_COUNTS)
        d_cluster_wrapper(wd, bdb, device="cpu", mesh_shape=mesh_shape, **kw)
        paths = {p for p, c in SECONDARY_PATH_COUNTS.items() if c != before.get(p, 0)}
        assert (paths == {"mesh_ring"}) == (mesh_shape == 4), paths
        tables[mesh_shape] = [_table(wd.location, t) for t in ("Cdb", "Ndb", "Mdb")]
    assert tables[4] == tables[1]


def test_compare_cli_with_mesh_shape_runs(compared, genome_paths, tmp_path):
    """The CLI takes --mesh_shape and the ring flags; five genomes are
    below MESH_MIN_GENOMES, so the run is the single-device one."""
    _, jwd, _ = compared
    wd = str(tmp_path / "wd")
    torch_main(["compare", wd, "-g", *genome_paths, "--device", "cpu", "--skip_plots",
                "--mesh_shape", "4", "--ring_comm", "ppermute", "--ring_monolithic"])
    assert _table(wd, "Cdb") == _table(jwd, "Cdb")


@pytest.mark.parametrize("flags", [[], ["--mesh_shape", "4"]])
def test_entry_points_refuse_cpu_without_being_asked(tmp_path, genome_paths, monkeypatch, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        compare_wrapper(str(tmp_path / "a"), genome_paths)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(["dereplicate", str(tmp_path / "b"), "-g", *genome_paths, *flags])
    gs, _ = planted_sketches(3, seed=0, s_bottom=20, s_scaled=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d_cluster_wrapper(WorkDirectory(str(tmp_path / "c")), pd.DataFrame({"genome": gs.names}))
    assert not os.path.exists(tmp_path / "a" / "data_tables" / "Cdb.csv")


@pytest.fixture()
def fake_binaries(tmp_path, monkeypatch):
    """chip_smoke.py's stand-ins for the subprocess engines' binaries,
    first on $PATH."""
    from chip_smoke import write_fake_tools

    d = write_fake_tools(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", d + os.pathsep + os.environ["PATH"])
    return d


@pytest.mark.parametrize("flag,kwargs", [
    (["--primary_algorithm", "mash"], {"primary_algorithm": "mash"}),
    (["--S_algorithm", "fastANI"], {"S_algorithm": "fastANI"}),
    (["--S_algorithm", "ANImf"], {"S_algorithm": "ANImf"}),
    (["--S_algorithm", "ANIn"], {"S_algorithm": "ANIn"}),
    (["--S_algorithm", "gANI"], {"S_algorithm": "gANI"}),
    (["--S_algorithm", "goANI"], {"S_algorithm": "goANI"}),
])
def test_subprocess_engine_argvs_equal_jax_bytes(tmp_path, genome_paths, fake_binaries, flag, kwargs):
    """Each subprocess engine through the CLI's compare, the binaries
    stood in for on $PATH: Bdb, Cdb and Ndb byte-identical to the JAX
    package's on the same argv; Mdb too under the mash primary (its
    distances are the binary's), within the sort estimator's 1e-7 under
    jax_mash."""
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    torch_main(["compare", wd, "-g", *genome_paths, "--skip_plots", "-p", "2", "--device", "cpu", *flag])
    jax_compare(jwd, genome_paths, skip_plots=True, processes=2, **kwargs)
    for table in ("Bdb", "Cdb", "Ndb"):
        assert _table(wd, table) == _table(jwd, table)
    if "mash" in flag:
        assert _table(wd, "Mdb") == _table(jwd, "Mdb")
    else:
        _assert_mdb_close(wd, jwd)
        cdb = pd.read_csv(os.path.join(wd, "data_tables", "Cdb.csv"))
        assert set(cdb["comparison_algorithm"]) == {kwargs["S_algorithm"]}


@pytest.mark.parametrize("operation,flags,kwargs", [
    ("dereplicate", ["--greedy_secondary_clustering"], {"greedy_secondary_clustering": True}),
    ("dereplicate", ["--run_tertiary_clustering"], {"run_tertiary_clustering": True}),
    ("dereplicate", ["--greedy_secondary_clustering", "--run_tertiary_clustering"],
     {"greedy_secondary_clustering": True, "run_tertiary_clustering": True}),
    # the JAX package takes multiround only above --primary_chunksize
    ("dereplicate", ["--multiround_primary_clustering", "--primary_chunksize", "2"],
     {"multiround_primary_clustering": True, "primary_chunksize": 2}),
    ("compare", ["--multiround_primary_clustering", "--primary_chunksize", "3", "--primary_estimator", "matmul"],
     {"multiround_primary_clustering": True, "primary_chunksize": 3, "primary_estimator": "matmul"}),
    ("compare", ["--primary_estimator", "matmul"], {"primary_estimator": "matmul"}),
    ("dereplicate", ["--primary_estimator", "matmul", "--greedy_secondary_clustering"],
     {"primary_estimator": "matmul", "greedy_secondary_clustering": True}),
])
def test_item_9a_argvs_equal_jax_bytes(tmp_path, genome_paths, operation, flags, kwargs):
    """The options of ROADMAP queue 1 item 9a on the fixture genomes, the
    same argv through both packages' compare or dereplicate: Cdb, Ndb (and
    Sdb, Wdb) byte-identical; Mdb byte-identical where the matmul estimator
    wrote it (its distances are host numpy in both packages), within the
    sort estimator's 1e-7 elsewhere, and written by neither under
    multiround."""
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    extra = ["--genomeInfo", str(q)] if operation == "dereplicate" else []
    torch_main([operation, wd, "-g", *genome_paths, *extra, "--skip_plots", "-p", "1", "--device", "cpu", *flags])
    if operation == "dereplicate":
        jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=1, **kwargs)
    else:
        jax_compare(jwd, genome_paths, skip_plots=True, processes=1, **kwargs)
    tables = ("Cdb", "Ndb", "Sdb", "Wdb") if operation == "dereplicate" else ("Bdb", "Cdb", "Ndb")
    for table in tables:
        assert _table(wd, table) == _table(jwd, table)
    has_mdb = os.path.exists(os.path.join(wd, "data_tables", "Mdb.csv"))
    assert has_mdb == os.path.exists(os.path.join(jwd, "data_tables", "Mdb.csv"))
    assert has_mdb == ("--multiround_primary_clustering" not in flags)
    if has_mdb and "matmul" in flags:
        assert _table(wd, "Mdb") == _table(jwd, "Mdb")
    elif has_mdb:
        _assert_mdb_close(wd, jwd)


@pytest.mark.parametrize("flags,kwargs", [
    (["--multiround_primary_clustering"], {"multiround_primary_clustering": True}),
    (["--primary_prune", "lsh"], {"primary_prune": "lsh"}),
    (["--greedy_secondary_clustering", "--SkipSecondary"],
     {"greedy_secondary_clustering": True, "SkipSecondary": True}),
    (["--run_tertiary_clustering", "--SkipSecondary"],
     {"run_tertiary_clustering": True, "SkipSecondary": True}),
    (["--S_algorithm", "ANImf", "--SkipSecondary"], {"S_algorithm": "ANImf", "SkipSecondary": True}),
    (["--primary_algorithm", "mash", "--SkipMash"], {"primary_algorithm": "mash", "SkipMash": True}),
])
def test_flags_jax_ignores_here_equal_jax_bytes(tmp_path, genome_paths, flags, kwargs):
    """Flags on argvs where the JAX package does not take their path
    (multiround at or below --primary_chunksize, pruning on the dense
    primary, greedy/tertiary/an external S engine under --SkipSecondary,
    an external primary engine under --SkipMash, its binary absent) run,
    and the dereplicate tables are byte-identical to the JAX package's."""
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", str(q),
                "--skip_plots", "-p", "1", "--device", "cpu", *flags])
    jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=1, **kwargs)
    for table in ("Cdb", "Ndb", "Sdb", "Wdb"):
        assert _table(wd, table) == _table(jwd, table)


@pytest.mark.parametrize("operation,flags,kwargs", [
    ("compare", ["--streaming_primary"], {"streaming_primary": True}),
    ("compare", ["--streaming_primary", "--primary_prune", "lsh"], {"streaming_primary": True, "primary_prune": "lsh"}),
    ("dereplicate", ["--prune_bands", "4"], {"prune_bands": 4}),
    ("dereplicate", ["--prune_min_shared", "1"], {"prune_min_shared": 1}),
    ("dereplicate", ["--prune_join_chunk", "1000"], {"prune_join_chunk": 1000}),
])
def test_streaming_argvs_equal_jax_bytes(tmp_path, genome_paths, operation, flags, kwargs):
    """The streaming primary's argvs on the fixture genomes (the first two
    stream; the LSH knobs alone leave the run on the dense path, where both
    packages ignore them): the port's tables equal the JAX package's."""
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    extra = ["--genomeInfo", str(q)] if operation == "dereplicate" else []
    torch_main([operation, wd, "-g", *genome_paths, *extra, "--skip_plots", "-p", "1", "--device", "cpu", *flags])
    if operation == "dereplicate":
        jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=1, **kwargs)
    else:
        jax_compare(jwd, genome_paths, skip_plots=True, processes=1, **kwargs)
    streamed = os.path.isdir(os.path.join(wd, "data", "streaming_primary"))
    assert streamed == ("--streaming_primary" in flags)
    tables = ("Cdb", "Ndb", "Sdb", "Wdb") if operation == "dereplicate" else ("Bdb", "Cdb", "Ndb")
    for table in tables:
        assert _table(wd, table) == _table(jwd, table)
    _assert_mdb_close(wd, jwd)


# the JAX CLI's flags that the port parses and runs only at their JAX
# defaults: a value to refuse, and the ROADMAP item that ports it; None
# where the port now runs the value (the fault-tolerance and durable-I/O
# flags, item 5): it reaches the cluster stage's _ft_config; the tracing
# flags (item 13) the workflow runs itself, around the cluster stage
_UNPORTED_FLAG_VALUES = [
    (["--events", "on"], None),
    (["--fsync"], None),
    (["--io_retries", "5"], None),
    (["--profile"], None),
    (["--fault_retries", "0"], None),
    (["--dispatch_timeout", "10"], None),
    (["--max_dead_processes", "0"], "item 12b"),
    (["--no_overlap_ingest"], None),
    (["--max_joins", "1"], "item 12b"),
    (["--drain_grace_s", "5"], "item 12b"),
]
_FLAG_KW = {"--fsync": ("fsync", True), "--io_retries": ("io_retries", 5), "--fault_retries": ("fault_retries", 0),
            "--dispatch_timeout": ("dispatch_timeout", 10.0), "--no_overlap_ingest": ("overlap_ingest", False)}


class _ReachedFtConfig(Exception):
    pass


@pytest.mark.parametrize("flag,item", _UNPORTED_FLAG_VALUES)
def test_jax_cli_flags_off_default_raise(tmp_path, genome_paths, flag, item, monkeypatch):
    """A JAX CLI flag set to a value the port does not run raises naming
    its ROADMAP item before any work: the workdir is not even made. A
    flag the port runs reaches the cluster stage's _ft_config with its
    value, before ingest; --events and --profile the workflow consumes
    (the cluster stage never sees them), and --events on has opened the
    trace with the cluster stage's span by then."""
    from drep_tpu_torch.cluster import controller

    wd = tmp_path / "wd"
    argv = ["dereplicate", str(wd), "-g", *genome_paths, "--device", "cpu", "--skip_plots", *flag]
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            torch_main(argv)
        assert not wd.exists()
        return
    seen = {}

    def reached(kw):
        seen.update(kw)
        raise _ReachedFtConfig

    monkeypatch.setattr(controller, "_ft_config", reached)
    with pytest.raises(_ReachedFtConfig):
        torch_main(argv)
    if flag[0] in ("--events", "--profile"):
        assert flag[0][2:] not in seen
        events = wd / "log" / "events.p0.jsonl"
        assert events.exists() == (flag[0] == "--events")
        if events.exists():
            assert json.loads(events.read_text().splitlines()[-1])["ev"] == "stage:cluster"
        return
    key, value = _FLAG_KW[flag[0]]
    assert seen[key] == value
    assert not (wd / "data" / "sketch_shards").exists()  # before ingest


def test_jax_cli_flags_at_defaults_run(dereplicated, genome_paths, tmp_path):
    """dereplicate with every JAX CLI flag of _UNPORTED_FLAG_VALUES given
    at its JAX default (where argparse can spell it), --events off and the
    TPU-only --ring_vmem_mb runs and writes the JAX package's tables."""
    _, jwd = dereplicated
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd = str(tmp_path / "wd")
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", str(q), "--skip_plots", "-p", "1",
                "--device", "cpu", "--events", "off", "--fault_retries", "2", "--dispatch_timeout", "0",
                "--max_dead_processes", "1", "--max_joins", "0", "--drain_grace_s", "30",
                "--prune_bands", "0", "--prune_min_shared", "0", "--prune_join_chunk", "0",
                "--ring_vmem_mb", "12"])
    for table in ("Cdb", "Ndb", "Sdb", "Wdb"):
        assert _table(wd, table) == _table(jwd, table)


@pytest.mark.parametrize("flags,kwargs", [
    (["--run_tax", "--cent_index", "idx", "--S_algorithm", "fastANI"],
     {"run_tax": True, "cent_index": "idx", "S_algorithm": "fastANI"}),
    (["--cent_index", "idx"], {"cent_index": "idx"}),
])
def test_taxonomy_argvs_equal_jax_bytes(tmp_path, genome_paths, fake_binaries, flags, kwargs):
    """dereplicate with the taxonomy flags, centrifuge (and fastANI) stood
    in for on $PATH: the tables (Tdb where --run_tax asks for it, and
    only there) byte-identical to the JAX package's on the same argv."""
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", str(q), "--skip_plots", "-p", "2",
                "--device", "cpu", *flags])
    jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=2, **kwargs)
    has_tdb = os.path.exists(os.path.join(wd, "data_tables", "Tdb.csv"))
    assert has_tdb == os.path.exists(os.path.join(jwd, "data_tables", "Tdb.csv")) == ("--run_tax" in flags)
    for table in ("Cdb", "Ndb", "Sdb", "Wdb") + (("Tdb",) if has_tdb else ()):
        assert _table(wd, table) == _table(jwd, table)


def test_check_dependencies_runs(fake_binaries):
    """The check_dependencies subcommand exists and reports the cards,
    then each external binary of EXTERNAL_SUITE: the stand-ins with their
    path and version, checkm (no stand-in) not found."""
    from drep_tpu_torch.cluster.external import EXTERNAL_SUITE

    torch_main(["check_dependencies"])
    lines = check_dependencies()
    assert "CUDA device(s)" in lines[0]
    ext = {ln.split()[1]: ln for ln in lines if ln.startswith("  external ")}
    assert sorted(ext) == sorted(EXTERNAL_SUITE)
    assert "NOT FOUND" in ext["checkm"]
    assert os.path.join(fake_binaries, "mash") in ext["mash"] and "(2.3)" in ext["mash"]
    assert os.path.join(fake_binaries, "nsimscan") in ext["nsimscan"] and "(" not in ext["nsimscan"]


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "drep_tpu")


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "drep_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def test_port_sources_import_no_jax_or_drep_tpu():
    bad = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _is_forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _is_forbidden(node.module):
                    bad.append((path, node.module))
    assert len(_port_sources()) > 20
    scanned = {os.path.relpath(p, os.path.join(REPO, "drep_tpu_torch")) for p in _port_sources()}
    assert {os.path.join("serve", f) for f in ("daemon.py", "protocol.py", "batcher.py", "client.py",
                                               "router.py")} <= scanned
    assert {os.path.join("index", f) for f in ("federation.py", "maintenance.py", "meta.py")} <= scanned
    assert bad == []


def test_port_compare_subprocess_loads_no_jax_or_drep_tpu(tmp_path, genome_paths):
    code = (
        "import sys\n"
        "from drep_tpu_torch.controller import main\n"
        f"main(['compare', {str(tmp_path / 'wd')!r}, '-g', *{list(genome_paths)!r}, "
        "'--device', 'cpu', '--skip_plots', '-p', '1'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'drep_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "LOADED []" in res.stdout
    assert os.path.exists(tmp_path / "wd" / "data_tables" / "Cdb.csv")
