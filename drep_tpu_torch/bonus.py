"""Bonus stage: genome taxonomy via centrifuge (``dereplicate --run_tax``).

Counterpart of drep_tpu/bonus.py (the reference's d_bonus run_centrifuge).
Like the subprocess engines (cluster/external.py, cluster/anim.py) it runs
an external binary on the host and never touches the card. The report
parsing is pure Python, so its numbers hold without the binary.

Per genome: ``centrifuge -f -x <index> -U <fasta>`` classifies every
contig; the tab report is reduced to one call — the taxon with the most
uniquely-assigned reads — plus the fraction of unique assignments it owns
(taxonomy confidence). Results land in **Tdb** (genome, taxonomy, taxID,
fraction) under data_tables/.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import pandas as pd

from drep_tpu_torch.cluster.external import require_binary, run_subprocess
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.workdir import WorkDirectory

# centrifuge report headers vary little, but parse by name anyway (the
# strategy every external parser here uses — column ORDER is never trusted)
_REPORT_COLS = {
    "name": ("name",),
    "taxid": ("taxid", "tax_id"),
    "numreads": ("numreads", "num_reads", "reads"),
    "numunique": ("numuniquereads", "num_unique_reads", "uniquereads"),
}


def parse_centrifuge_report(path: str) -> list[dict]:
    """Centrifuge --report-file TSV -> [{name, taxid, numreads, numunique}]."""
    with open(path) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        return []
    header = [h.strip().lower() for h in lines[0]]
    col: dict[str, int] = {}
    for want, aliases in _REPORT_COLS.items():
        for a in aliases:
            if a in header:
                col[want] = header.index(a)
                break
    missing = [c for c in _REPORT_COLS if c not in col]
    if missing:
        raise RuntimeError(
            f"unrecognized centrifuge report header {header} in {path}: missing {missing}"
        )
    out: list[dict] = []
    for row in lines[1:]:
        if len(row) <= max(col.values()):
            continue
        try:
            out.append(
                {
                    "name": row[col["name"]].strip(),
                    "taxid": int(float(row[col["taxid"]])),
                    "numreads": int(float(row[col["numreads"]])),
                    "numunique": int(float(row[col["numunique"]])),
                }
            )
        except ValueError:
            continue  # summary/comment rows
    return out


def genome_taxonomy(rows: list[dict]) -> tuple[str, int, float]:
    """(taxonomy, taxID, fraction) for one genome's report rows.

    Winner = most uniquely-assigned reads (ties: more total reads, then
    name — deterministic); fraction = its share of all unique assignments.
    No classified rows -> ('unclassified', 0, 0.0).
    """
    scored = [r for r in rows if r["numunique"] > 0] or rows
    if not scored:
        return "unclassified", 0, 0.0
    total = sum(r["numunique"] for r in scored)
    best = max(scored, key=lambda r: (r["numunique"], r["numreads"], r["name"]))
    frac = best["numunique"] / total if total else 0.0
    return best["name"], best["taxid"], frac


def validate_bonus_args(kwargs: dict) -> None:
    """Fail --run_tax prerequisites BEFORE the pipeline runs — discovering a
    missing binary/index after hours of clustering would waste the run."""
    if not kwargs.get("run_tax"):
        return
    require_binary("centrifuge", hint="drop --run_tax")
    if not kwargs.get("cent_index"):
        raise UserInputError("--run_tax needs --cent_index (a centrifuge index prefix)")


def _centrifuge_one(args) -> tuple[str, str, int, float]:
    genome, fasta, index, out_dir, threads = args
    stem = os.path.join(out_dir, genome)
    report = stem + ".report.tsv"
    if not os.path.exists(report):  # per-genome resume, like checkm/sketches
        # write via tmp + atomic replace: a mid-run kill must never leave a
        # truncated report that a resume would silently parse as taxonomy
        tmp = f"{report}.tmp{os.getpid()}"
        run_subprocess(
            [
                # --mm memory-maps the index so concurrent jobs share ONE
                # copy instead of loading processes * multi-GB each
                "centrifuge", "-f", "--mm", "-x", index, "-U", fasta,
                "-S", stem + ".hits.tsv", "--report-file", tmp,
                "-p", str(max(threads, 1)),
            ]
        )
        # the external binary wrote the tmp; the rename publishes it whole
        os.replace(tmp, report)
    tax, taxid, frac = genome_taxonomy(parse_centrifuge_report(report))
    return genome, tax, taxid, frac


def d_bonus_wrapper(
    wd: WorkDirectory,
    bdb: pd.DataFrame,
    cent_index: str | None = None,
    processes: int = 1,
    **_,
) -> pd.DataFrame:
    """Run centrifuge over every genome in Bdb; store and return Tdb."""
    require_binary("centrifuge", hint="drop --run_tax")
    if not cent_index:
        raise UserInputError("--run_tax needs --cent_index (a centrifuge index prefix)")
    out_dir = wd.get_dir(os.path.join("data", "centrifuge"))
    # parallelism budget: EITHER many 1-thread processes OR one
    # `processes`-thread process — `processes` concurrent jobs each with
    # -p processes would square the thread count and load N copies of the
    # multi-GB index at once
    per_job = processes if len(bdb) == 1 else 1
    jobs = [(r.genome, r.location, cent_index, out_dir, per_job) for r in bdb.itertuples()]
    rows = []
    # centrifuge is an external process — threads fan it out fine
    with ThreadPoolExecutor(max_workers=max(processes, 1)) as pool:
        for genome, tax, taxid, frac in pool.map(_centrifuge_one, jobs):
            rows.append(
                {"genome": genome, "taxonomy": tax, "taxID": taxid, "fraction": frac}
            )
    tdb = pd.DataFrame(rows, columns=["genome", "taxonomy", "taxID", "fraction"])
    wd.store_db(tdb, "Tdb")
    get_logger().info("bonus: taxonomy for %d genomes -> Tdb", len(tdb))
    return tdb
