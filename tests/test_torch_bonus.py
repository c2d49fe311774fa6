"""The bonus stage (bonus.py: centrifuge taxonomy, ``dereplicate
--run_tax``) against the JAX package's, on the CPU, with chip_smoke.py's
stand-in centrifuge first on $PATH: the report parser and the reduction
bit for bit, the prerequisite checks' errors, Tdb byte-identical, the
per-genome resume, and the check failing before any table is written.
"""

import os
import subprocess

import pytest

from chip_smoke import fake_calls, write_fake_tools
from drep_tpu import bonus as jax_bonus
from drep_tpu.workdir import WorkDirectory as JaxWorkDirectory
from drep_tpu.workflows import dereplicate_wrapper as jax_dereplicate
from drep_tpu_torch import bonus
from drep_tpu_torch.argparser import parse_args
from drep_tpu_torch.controller import main as torch_main
from drep_tpu_torch.controller import run as torch_run
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.workdir import WorkDirectory

REPORT = (
    "name\ttaxID\ttaxRank\tgenomeSize\tnumReads\tnumUniqueReads\tabundance\n"
    "Escherichia coli\t562\tspecies\t4641652\t900\t700\t0.7\n"
    "Salmonella enterica\t28901\tspecies\t4857450\t400\t200\t0.2\n"
    "Enterobacteriaceae\t543\tfamily\t0\t1300\t100\t0.1\n"
    "# a summary row\tx\ty\tz\tw\tv\tu\n"
)
QUALITY = (
    "genome,completeness,contamination\ngenome_A.fasta,99,0.5\ngenome_B.fasta,90,1\n"
    "genome_C.fasta,85,2\ngenome_D.fasta,95,0.1\ngenome_E.fasta,94,0.2\n"
)


@pytest.fixture()
def fakes(tmp_path, monkeypatch):
    d = write_fake_tools(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", d + os.pathsep + os.environ["PATH"])
    return d


def _table(loc: str, name: str) -> bytes:
    with open(os.path.join(loc, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


def test_report_parser_and_reduction_equal_jax(fakes, genome_paths, tmp_path):
    """A hand-written report (with a summary row) and the stand-in's: the
    same rows and the same (taxonomy, taxID, fraction) in both packages;
    a bad header fails alike."""
    hand = tmp_path / "hand.tsv"
    hand.write_text(REPORT)
    stem = str(tmp_path / "fake")
    subprocess.run(["centrifuge", "-f", "--mm", "-x", "idx", "-U", genome_paths[0], "-S", stem + ".hits",
                    "--report-file", stem + ".tsv", "-p", "1"], check=True)
    for path in (str(hand), stem + ".tsv"):
        rows = bonus.parse_centrifuge_report(path)
        assert rows == jax_bonus.parse_centrifuge_report(path) and len(rows) == 3
        assert bonus.genome_taxonomy(rows) == jax_bonus.genome_taxonomy(rows)
    for rows in ([], [{"name": "a", "taxid": 1, "numreads": 5, "numunique": 0}],
                 [{"name": "b", "taxid": 2, "numreads": 5, "numunique": 3},
                  {"name": "a", "taxid": 1, "numreads": 5, "numunique": 3}]):
        assert bonus.genome_taxonomy(rows) == jax_bonus.genome_taxonomy(rows)
    bad = tmp_path / "bad.tsv"
    bad.write_text("foo\tbar\n1\t2\n")
    msgs = []
    for mod in (bonus, jax_bonus):
        with pytest.raises(RuntimeError) as e:
            mod.parse_centrifuge_report(str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kwargs,on_path", [
    ({"run_tax": False}, False),
    ({"run_tax": True, "cent_index": "idx"}, False),
    ({"run_tax": True, "cent_index": None}, True),
    ({"run_tax": True, "cent_index": "idx"}, True),
])
def test_validate_bonus_args_equals_jax(tmp_path, monkeypatch, kwargs, on_path):
    """The prerequisite checks: nothing without --run_tax; no centrifuge,
    or no --cent_index, raise UserInputError with the JAX text."""
    if on_path:
        monkeypatch.setenv("PATH", write_fake_tools(str(tmp_path / "bin")))
    else:
        monkeypatch.setenv("PATH", str(tmp_path))
    outcomes = []
    for mod in (bonus, jax_bonus):
        try:
            mod.validate_bonus_args(dict(kwargs))
            outcomes.append(None)
        except ValueError as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    ok = not kwargs["run_tax"] or (on_path and kwargs["cent_index"])
    assert (outcomes[0] is None) == bool(ok)


def test_d_bonus_wrapper_tdb_equals_jax_and_resumes(fakes, bdb, tmp_path):
    """Tdb from the stand-in through both packages is byte-identical; a
    second port run reads the per-genome reports and calls nothing."""
    wd, jwd = WorkDirectory(str(tmp_path / "torch")), JaxWorkDirectory(str(tmp_path / "jax"))
    tdb = bonus.d_bonus_wrapper(wd, bdb, cent_index="idx", processes=2)
    assert len(fake_calls(fakes)) == len(bdb)
    jax_bonus.d_bonus_wrapper(jwd, bdb, cent_index="idx", processes=2)
    assert _table(wd.location, "Tdb") == _table(jwd.location, "Tdb")
    assert list(tdb.columns) == ["genome", "taxonomy", "taxID", "fraction"] and len(tdb) == len(bdb)
    n = len(fake_calls(fakes))
    again = bonus.d_bonus_wrapper(wd, bdb, cent_index="idx", processes=2)
    assert len(fake_calls(fakes)) == n and again.equals(tdb)


def test_dereplicate_run_tax_refused_before_any_table(tmp_path, genome_paths, monkeypatch):
    """dereplicate --run_tax without centrifuge on $PATH fails with the
    JAX text before the workdir is made; with centrifuge but without
    --cent_index, likewise."""
    monkeypatch.setenv("PATH", str(tmp_path))
    wd = tmp_path / "wd"
    with pytest.raises(UserInputError, match="'centrifuge' not found"):
        torch_run(parse_args(["dereplicate", str(wd), "-g", *genome_paths, "--device", "cpu", "--run_tax",
                              "--cent_index", "idx"]))
    monkeypatch.setenv("PATH", write_fake_tools(str(tmp_path / "bin")))
    with pytest.raises(UserInputError, match="--run_tax needs --cent_index"):
        torch_run(parse_args(["dereplicate", str(wd), "-g", *genome_paths, "--device", "cpu", "--run_tax"]))
    assert not wd.exists()


def test_dereplicate_run_tax_equals_jax(fakes, genome_paths, tmp_path):
    """dereplicate --run_tax --cent_index through both packages: Tdb (one
    row a genome past the filter) and the winners byte-identical; one
    centrifuge call a genome in each."""
    q = tmp_path / "q.csv"
    q.write_text(QUALITY)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    torch_main(["dereplicate", wd, "-g", *genome_paths, "--genomeInfo", str(q), "--skip_plots", "-p", "2",
                "--device", "cpu", "--run_tax", "--cent_index", "idx"])
    n = len(fake_calls(fakes))
    jax_dereplicate(jwd, genome_paths, genomeInfo=str(q), skip_plots=True, processes=2, run_tax=True,
                    cent_index="idx")
    assert n == len(fake_calls(fakes)) - n == len(genome_paths)
    for table in ("Tdb", "Cdb", "Wdb"):
        assert _table(wd, table) == _table(jwd, table)
