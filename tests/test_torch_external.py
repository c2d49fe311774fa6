"""The subprocess engines (cluster/external.py, cluster/anim.py) against
the JAX package's, on the CPU.

mash, fastANI, nucmer, prodigal, ANIcalculator and nsimscan are not
installed where the tests run, so both packages run the same stand-ins
(chip_smoke.py's ``write_fake_tools``: small Python scripts that write
each tool's output format from the FASTA files they are given, and log
their calls), put first on $PATH. Held bit for bit: every parser on the same files, each
engine's (ani, cov) on the same sketches and Bdb, and d_cluster_wrapper's
Cdb/Ndb on the fixture genomes plus three derived ones whose ANI
straddles S_ani (Mdb byte-identical under the mash primary; under
jax_mash within the sort estimator's 1e-7, as everywhere in the port's
tests). Then the missing-binary errors, the engines' import cost, and a
retried, a killed and a resumed fastANI secondary.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import FAKE_TOOLS, calls_by_tool, fake_calls, sub_implied_calls, write_fake_tools
from drep_tpu.cluster import anim as jax_anim
from drep_tpu.cluster import dispatch as jax_dispatch
from drep_tpu.cluster import external as jax_external
from drep_tpu.cluster.controller import d_cluster_wrapper as jax_d_cluster_wrapper
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu_torch.cluster import anim, dispatch, external
from drep_tpu_torch.cluster.controller import SECONDARY_RESUMED, d_cluster_wrapper
from drep_tpu_torch.ingest import make_bdb, save_sketch_cache, sketch_genomes, sketches_from_arrays
from drep_tpu_torch.parallel.faulttol import FaultTolError
from drep_tpu_torch.utils.profiling import counters
from drep_tpu_torch.workdir import WorkDirectory

SECONDARIES = ("fastANI", "ANImf", "ANIn", "gANI", "goANI")
# the derived genomes: (name, source, point-mutation rate); the fakes'
# ANI is ~1 - rate, so 4% joins A's secondary cluster at S_ani 0.95, 6%
# does not, and D at 5% sits on the cutoff
DERIVED = (("genome_A4.fasta", "genome_A.fasta", 0.04), ("genome_A6.fasta", "genome_A.fasta", 0.06),
           ("genome_D5.fasta", "genome_D.fasta", 0.05))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate_fasta(src: str, dst: str, rate: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    with open(src) as f:
        records = f.read().split(">")[1:]
    for rec in records:
        header, *lines = rec.splitlines()
        seq = np.frombuffer("".join(lines).encode(), np.uint8).copy()
        pos = np.nonzero(rng.random(len(seq)) < rate)[0]
        code = np.searchsorted(bases, seq[pos])
        seq[pos] = bases[(code + rng.integers(1, 4, len(pos))) % 4]
        out.append(f">{header}\n{seq.tobytes().decode()}\n")
    with open(dst, "w") as f:
        f.write("".join(out))


@pytest.fixture(scope="module")
def fakes(tmp_path_factory):
    return write_fake_tools(str(tmp_path_factory.mktemp("fake_bin")))


@pytest.fixture()
def on_path(fakes, monkeypatch):
    monkeypatch.setenv("PATH", fakes + os.pathsep + os.environ["PATH"])
    return fakes


@pytest.fixture(scope="module")
def derived_set(tmp_path_factory, genome_paths):
    """The fixture genomes plus DERIVED, their Bdb and port sketches."""
    d = tmp_path_factory.mktemp("derived")
    src = {os.path.basename(p): p for p in genome_paths}
    paths = list(genome_paths)
    for i, (name, source, rate) in enumerate(DERIVED):
        _mutate_fasta(src[source], str(d / name), rate, seed=i)
        paths.append(str(d / name))
    bdb = make_bdb(paths)
    return bdb, sketch_genomes(bdb, processes=1)


def _port_sketches(jax_gs):
    return sketches_from_arrays(jax_gs.names, jax_gs.bottom, jax_gs.scaled, jax_gs.gdb, jax_gs.k,
                                jax_gs.sketch_size, jax_gs.scale)


def _records(alns) -> list[tuple]:
    return [dataclasses.astuple(a) for a in alns]


# ---- parsers ------------------------------------------------------------


def test_delta_parsing_filter_and_ani_equal_jax(on_path, genome_paths, tmp_path):
    """A fake nucmer's .delta (A against B, multi-contig, with repeats for
    the ANImf filter to drop) and a hand-written one: the same records,
    filtered records and (ani, qcov, rcov) in both packages."""
    prefix = str(tmp_path / "p")
    subprocess.run(["nucmer", "--mum", "-p", prefix, genome_paths[0], genome_paths[1]], check=True)
    hand = tmp_path / "hand.delta"
    hand.write_text("/ref.fa /qry.fa\nNUCMER\n>ctgR ctgQ 10000 8000\n1 5000 1 5001 25 25 0\n12\n-4\n0\n"
                    "6000 9999 8000 4001 40 40 0\n0\n>ctgR2 ctgQ2 2000 2000\n100 1099 200 1199 10 10 0\n7\n0\n")
    dropped = []
    for path in (prefix + ".delta", str(hand)):
        got, want = anim.parse_delta(path), jax_anim.parse_delta(path)
        assert _records(got) == _records(want) and len(got) >= 3
        kept, jkept = anim.filter_best_per_query_region(got), jax_anim.filter_best_per_query_region(want)
        assert _records(kept) == _records(jkept)
        dropped.append(len(got) - len(kept))
        for alns, jalns in ((got, want), (kept, jkept)):
            assert anim.ani_cov_from_alignments(alns, 120_000, 119_000) == \
                jax_anim.ani_cov_from_alignments(jalns, 120_000, 119_000)
    assert dropped[0] > 0  # the fake's repeats exercise the filter


def _prodigal(genome: str, tmp_path, stem: str) -> str:
    genes = str(tmp_path / f"{stem}.genes.fna")
    subprocess.run(["prodigal", "-i", genome, "-d", genes, "-m", "-p", "meta", "-o", str(tmp_path / f"{stem}.gff"),
                    "-q"], check=True)
    return genes


def test_gani_parsing_equals_jax(on_path, genome_paths, tmp_path):
    """ANIcalculator tables (the fake's on prodigal's genes of A and B, a
    reordered header, a table with no row for the pair, a bad header):
    the same values or the same error in both packages."""
    genes = [_prodigal(genome_paths[i], tmp_path, f"genome_{i}") for i in (0, 1)]
    subprocess.run(["ANIcalculator", "-genome1fna", genes[0], "-genome2fna", genes[1], "-outdir",
                    str(tmp_path / "o"), "-outfile", "ani.out"], check=True)
    fake = str(tmp_path / "o" / "ani.out")
    reordered = tmp_path / "r.out"
    reordered.write_text("GENOME1\tGENOME2\tAF(1->2)\tAF(2->1)\tANI(1->2)\tANI(2->1)\n"
                         "gA.genes\tgB.genes\t0.80\t0.70\t98.5\t98.1\n")
    empty = tmp_path / "e.out"
    empty.write_text("GENOME1\tGENOME2\tANI(1->2)\tANI(2->1)\tAF(1->2)\tAF(2->1)\nx\ty\t99\t99\t1\t1\n")
    cases = [(fake, "genome_0.genes", "genome_1.genes"), (fake, "genome_1.genes", "genome_0.genes"),
             (str(reordered), "gB.genes", "gA.genes"), (str(empty), "gA.genes", "gB.genes")]
    anim.reset_run_state()
    jax_anim.reset_run_state()
    for path, a, b in cases:
        assert anim.parse_gani_file(path, a, b) == jax_anim.parse_gani_file(path, a, b)
    assert anim.parse_gani_file(fake, "genome_0.genes", "genome_1.genes")[0][0] > 0.9
    assert anim._WARNED_GANI_MISMATCH == [True]  # the unmatched pair warned once
    anim.reset_run_state()
    assert anim._WARNED_GANI_MISMATCH == []
    bad = tmp_path / "bad.out"
    bad.write_text("WHAT\tEVER\n")
    with pytest.raises(RuntimeError) as e1:
        anim.parse_gani_file(str(bad), "x", "y")
    with pytest.raises(RuntimeError) as e2:
        jax_anim.parse_gani_file(str(bad), "x", "y")
    assert str(e1.value) == str(e2.value)


def test_nsimscan_parsing_and_goani_equal_jax(on_path, genome_paths, tmp_path):
    """nsimscan tables (the fake's on two prodigal gene sets, a reordered
    header with a summary line) -> the same hits and (ani, af) in both
    packages, with the same gene lengths."""
    genes = [_prodigal(genome_paths[i], tmp_path, f"g{i}") for i in (0, 2)]
    out = str(tmp_path / "ns.tab")
    subprocess.run(["nsimscan", "--om", "TABX", genes[0], genes[1], out], check=True)
    other = tmp_path / "o.tab"
    other.write_text("p_ident\tquery\tlength\tsubject\n98.5\tg1\t450\ts1\n# summary\tx\ty\tz\n")
    for path in (out, str(other)):
        hits = anim.parse_nsimscan_table(path)
        assert hits == jax_anim.parse_nsimscan_table(path)
    lens = anim._gene_lengths(genes[0])
    assert lens == jax_anim._gene_lengths(genes[0]) and len(lens) > 100
    hits = anim.parse_nsimscan_table(out)
    assert anim.goani_ani_af(hits, lens) == jax_anim.goani_ani_af(hits, lens)
    assert 0.9 < anim.goani_ani_af(hits, lens)[0] < 0.95


@pytest.mark.parametrize("binary", external.EXTERNAL_SUITE)
def test_find_program_equals_jax(on_path, binary):
    """Each binary check_dependencies probes: the same (path, version)
    through either package (checkm has no stand-in: not found)."""
    got = external.find_program(binary)
    assert got == jax_external.find_program(binary)
    assert (got[0] is not None) == (binary in FAKE_TOOLS)


def test_registries_equal_jax():
    assert set(dispatch.PRIMARY_ALGORITHMS) == set(jax_dispatch.PRIMARY_ALGORITHMS) == {"jax_mash", "mash"}
    assert set(dispatch.SECONDARY_ALGORITHMS) == set(jax_dispatch.SECONDARY_ALGORITHMS)
    assert set(dispatch.SECONDARY_ALGORITHMS) == {"jax_ani", *SECONDARIES}
    assert set(dispatch.SECONDARY_BATCHED) == {"jax_ani"}


def test_engines_import_only_the_standard_library():
    """Importing the subprocess engines adds no module to a jax_ani run's
    start beyond the standard library's and their own two."""
    code = (
        "import sys\n"
        "import drep_tpu_torch.cluster.dispatch, drep_tpu_torch.ingest, drep_tpu_torch.utils.durableio\n"
        "before = set(sys.modules)\n"
        "import drep_tpu_torch.cluster.external, drep_tpu_torch.cluster.anim\n"
        "new = set(sys.modules) - before\n"
        "own = {'drep_tpu_torch.cluster.external', 'drep_tpu_torch.cluster.anim'}\n"
        "print(sorted(m for m in new if m not in own and m.split('.')[0].lstrip('_') not in "
        "sys.stdlib_module_names and m.split('.')[0] not in sys.stdlib_module_names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.stdout.strip() == "[]", res.stdout


# ---- engines ------------------------------------------------------------


@pytest.mark.parametrize("engine", ("mash", *SECONDARIES))
def test_engine_equals_jax(on_path, sketches, bdb, engine):
    """Each engine on the same GenomeSketches and Bdb: (dist, sim) or
    (ani, cov) bit-identical to the JAX engine's, float32."""
    gs = _port_sketches(sketches)
    if engine == "mash":
        got = dispatch.get_primary(engine)(gs, bdb=bdb, processes=2)
        want = jax_dispatch.get_primary(engine)(sketches, bdb=bdb, processes=2)
    else:
        got = dispatch.get_secondary(engine)(gs, [0, 1, 2, 3], bdb=bdb, processes=4)
        want = jax_dispatch.get_secondary(engine)(sketches, [0, 1, 2, 3], bdb=bdb, processes=4)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    first = got[0][0]
    assert (0.0 < first[2] < 0.1) if engine == "mash" else (first[1] > 0.95 > first[2] > 0.85)


def _workdirs(root, gs, bdb):
    wd = WorkDirectory(str(root / "torch"))
    save_sketch_cache(wd, gs)
    jwd = JaxWorkDirectory(str(root / "jax"))
    jax_save(jwd, JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled, k=gs.k,
                                    sketch_size=gs.sketch_size, scale=gs.scale))
    jwd.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    return wd, jwd


def _table(wd, name: str) -> bytes:
    with open(os.path.join(wd.location, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [
    {"S_algorithm": "fastANI"},
    {"S_algorithm": "ANImf"},
    {"S_algorithm": "ANIn"},
    {"S_algorithm": "gANI"},
    {"S_algorithm": "goANI"},
    {"primary_algorithm": "mash", "S_algorithm": "fastANI"},
], ids=lambda kw: "-".join(kw.values()))
def test_d_cluster_wrapper_equals_jax(on_path, derived_set, tmp_path, kw):
    """d_cluster_wrapper with each engine on the fixture and derived
    genomes: Cdb and Ndb byte-identical to the JAX package's, Mdb too
    under the mash primary; the derived genomes split secondary clusters;
    the stand-ins' logs show the calls the engine implies, per package."""
    bdb, gs = derived_set
    wd, jwd = _workdirs(tmp_path, gs, bdb)
    n0 = len(fake_calls(on_path))
    cdb = d_cluster_wrapper(wd, bdb, device="cpu", processes=4, **kw)
    n1 = len(fake_calls(on_path))
    jax_d_cluster_wrapper(jwd, bdb, processes=4, **kw)
    calls = [calls_by_tool(on_path, n0, n1), calls_by_tool(on_path, n1)]
    for table in ("Cdb", "Ndb"):
        assert _table(wd, table) == _table(jwd, table)
    if kw.get("primary_algorithm") == "mash":
        assert _table(wd, "Mdb") == _table(jwd, "Mdb")
    else:
        got, want = (pd.read_csv(os.path.join(w.location, "data_tables", "Mdb.csv")) for w in (wd, jwd))
        assert got[["genome1", "genome2"]].equals(want[["genome1", "genome2"]])
        np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-7)
    sizes = [m for m in cdb.groupby("primary_cluster").size() if m > 1]
    assert len(sizes) >= 2 and cdb["secondary_cluster"].nunique() > cdb["primary_cluster"].nunique()
    assert set(cdb["comparison_algorithm"]) == {kw["S_algorithm"]}
    want_calls = sub_implied_calls(kw["S_algorithm"], sizes)
    if kw.get("primary_algorithm") == "mash":
        want_calls["mash"] = 2
    assert calls[0] == calls[1] == want_calls


# ---- missing binaries ---------------------------------------------------


@pytest.mark.parametrize("engine,binary", [("mash", "mash"), ("fastANI", "fastANI"), ("ANImf", "nucmer"),
                                           ("ANIn", "nucmer"), ("gANI", "ANIcalculator"), ("goANI", "nsimscan")])
def test_missing_binary_raises_as_jax(sketches, bdb, tmp_path, monkeypatch, engine, binary):
    """No binary on $PATH: the same exception type and message from
    either package, naming the binary; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    gs = _port_sketches(sketches)
    errors = []
    for disp, g in ((dispatch, gs), (jax_dispatch, sketches)):
        fn = disp.get_primary(engine) if engine == "mash" else disp.get_secondary(engine)
        args = (g,) if engine == "mash" else (g, [0, 1])
        with pytest.raises(ValueError) as e:
            fn(*args, bdb=bdb)
        errors.append(e.value)
    assert [type(e).__name__ for e in errors] == ["UserInputError"] * 2
    assert str(errors[0]) == str(errors[1]) and repr(binary) in str(errors[0])


# ---- retries and resume -------------------------------------------------


def _fail_plan(fakes: str, match: str, times: int) -> None:
    import json

    with open(os.path.join(fakes, "fail.json"), "w") as f:
        json.dump({"tool": "fastANI", "match": match, "times": times}, f)


def test_subprocess_secondary_retried_killed_and_resumed(derived_set, tmp_path, monkeypatch):
    """fastANI failing its first call on D's cluster is retried (retries
    1) and the tables equal a clean run's; failing twice with
    --fault_retries 1 raises FaultTolError with A's cluster checkpointed,
    and the rerun calls fastANI for D's cluster alone, with the clean
    run's tables."""
    bdb, gs = derived_set
    fakes = write_fake_tools(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", fakes + os.pathsep + os.environ["PATH"])
    kw = {"S_algorithm": "fastANI", "processes": 2}
    clean = WorkDirectory(str(tmp_path / "clean"))
    save_sketch_cache(clean, gs)
    d_cluster_wrapper(clean, bdb, device="cpu", **kw)
    assert len(fake_calls(fakes)) == 2

    _fail_plan(fakes, "genome_D5.fasta", 1)
    retried = WorkDirectory(str(tmp_path / "retried"))
    save_sketch_cache(retried, gs)
    counters.reset()
    d_cluster_wrapper(retried, bdb, device="cpu", **kw)
    assert counters.faults["retries"] == 1 and len(fake_calls(fakes)) == 2 + 3
    for table in ("Cdb", "Ndb"):
        assert _table(retried, table) == _table(clean, table)

    _fail_plan(fakes, "genome_D5.fasta", 2)
    killed = WorkDirectory(str(tmp_path / "killed"))
    save_sketch_cache(killed, gs)
    with pytest.raises(FaultTolError, match="secondary_batch: failed after 2 attempts"):
        d_cluster_wrapper(killed, bdb, device="cpu", fault_retries=1, **kw)
    assert not killed.hasDb("Cdb") and len(fake_calls(fakes)) == 5 + 3
    os.remove(os.path.join(fakes, "fail.json"))
    d_cluster_wrapper(killed, bdb, device="cpu", fault_retries=1, **kw)
    resumed_calls = fake_calls(fakes)[8:]
    assert SECONDARY_RESUMED == {"resumed": 1, "clusters": 2}
    assert len(resumed_calls) == 1 and "genome_D5.fasta" in resumed_calls[0][-1]
    for table in ("Cdb", "Ndb"):
        assert _table(killed, table) == _table(clean, table)
