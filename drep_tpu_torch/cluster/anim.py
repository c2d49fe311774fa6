"""Alignment-based ANI engines: ANImf / ANIn (nucmer), gANI
(prodigal + ANIcalculator) and goANI (prodigal + nsimscan).

Counterpart of drep_tpu/cluster/anim.py (the reference's run_nucmer +
process_deltafiles and its gANI/goANI runners). Like cluster/external.py
these engines run external binaries on the host, fanned out over
``processes`` threads, and move no work onto the card or off it. The
parsers (nucmer's .delta, ANIcalculator's and nsimscan's tables) are pure
Python, so their numbers hold on machines without the binaries.
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import pandas as pd

from drep_tpu_torch.cluster.dispatch import register_secondary
from drep_tpu_torch.cluster.external import require_binary
from drep_tpu_torch.cluster.external import run_subprocess as _run
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.utils.fasta import read_fasta_headers_lengths
from drep_tpu_torch.utils.logger import get_logger


@dataclass
class DeltaAlignment:
    ref_name: str
    qry_name: str
    ref_start: int
    ref_end: int
    qry_start: int
    qry_end: int
    errors: int

    @property
    def qry_aligned(self) -> int:
        return abs(self.qry_end - self.qry_start) + 1

    @property
    def ref_aligned(self) -> int:
        return abs(self.ref_end - self.ref_start) + 1


def parse_delta(path: str) -> list[DeltaAlignment]:
    """Parse a nucmer .delta file into alignment records.

    Format: two header lines (paths, program), then per sequence pair a
    ``>ref qry ref_len qry_len`` line followed by alignment headers of 7
    integers (ref_start ref_end qry_start qry_end errors sim_errors stops)
    each trailed by indel-offset lines terminated with a lone ``0``.
    """
    out: list[DeltaAlignment] = []
    ref = qry = None
    with open(path) as f:
        lines = f.read().splitlines()
    i = 2  # skip path + program header lines
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        if line.startswith(">"):
            parts = line[1:].split()
            ref, qry = parts[0], parts[1]
            i += 1
            continue
        fields = line.split()
        if len(fields) == 7 and ref is not None:
            rs, re_, qs, qe, err, _sim, _stp = (int(x) for x in fields)
            out.append(DeltaAlignment(ref, qry, rs, re_, qs, qe, err))
            i += 1
            while i < len(lines) and lines[i].strip() != "0":
                i += 1
            i += 1  # consume the terminating 0
            continue
        i += 1
    return out


def _merge_intervals(ivals: list[tuple[int, int]]) -> int:
    """Total length covered by possibly-overlapping 1-based closed intervals."""
    if not ivals:
        return 0
    ivals = sorted((min(a, b), max(a, b)) for a, b in ivals)
    total, cur_lo, cur_hi = 0, *ivals[0]
    for lo, hi in ivals[1:]:
        if lo > cur_hi + 1:
            total += cur_hi - cur_lo + 1
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo + 1)


def filter_best_per_query_region(alns: list[DeltaAlignment]) -> list[DeltaAlignment]:
    """Greedy 1-to-1 filtering on the query axis — the role of MUMmer's
    ``delta-filter -q`` in the reference's ANImf ("mf" = many-to-one
    filtered): alignments are taken longest-first, and one that overlaps an
    already-claimed query region of the same query sequence by >50% of its
    own length is dropped (repeats would otherwise inflate ANI coverage)."""
    claimed: dict[str, list[tuple[int, int]]] = {}
    kept: list[DeltaAlignment] = []
    for aln in sorted(alns, key=lambda a: -a.qry_aligned):
        lo, hi = sorted((aln.qry_start, aln.qry_end))
        overlap = 0
        for clo, chi in claimed.get(aln.qry_name, []):
            overlap += max(0, min(hi, chi) - max(lo, clo) + 1)
        if overlap * 2 > aln.qry_aligned:
            continue
        claimed.setdefault(aln.qry_name, []).append((lo, hi))
        kept.append(aln)
    return kept


def ani_cov_from_alignments(
    alns: list[DeltaAlignment], qry_len: int, ref_len: int
) -> tuple[float, float, float]:
    """(ani, qry_coverage, ref_coverage) from alignment records.

    ANI = 1 - errors/aligned, length-weighted over alignments (the
    reference's process_deltafiles contract); coverage = merged aligned
    fraction of each genome.
    """
    if not alns:
        return 0.0, 0.0, 0.0
    tot = sum(a.qry_aligned for a in alns)
    err = sum(a.errors for a in alns)
    ani = max(0.0, 1.0 - err / max(tot, 1))

    def merged(key, ival):  # intervals merge within one contig, not across
        by_name: dict[str, list[tuple[int, int]]] = {}
        for a in alns:
            by_name.setdefault(key(a), []).append(ival(a))
        return sum(_merge_intervals(v) for v in by_name.values())

    qcov = merged(lambda a: a.qry_name, lambda a: (a.qry_start, a.qry_end)) / max(qry_len, 1)
    rcov = merged(lambda a: a.ref_name, lambda a: (a.ref_start, a.ref_end)) / max(ref_len, 1)
    return ani, min(qcov, 1.0), min(rcov, 1.0)


def _require(binary: str) -> str:
    return require_binary(binary, hint="--S_algorithm jax_ani")


def _nucmer_pair(args) -> tuple[int, int, float, float, float]:
    i, j, qry_path, ref_path, qry_len, ref_len, tmp, filtered = args
    prefix = os.path.join(tmp, f"p{i}_{j}")
    _run(["nucmer", "--mum", "-p", prefix, ref_path, qry_path])
    alns = parse_delta(prefix + ".delta")
    if filtered:
        alns = filter_best_per_query_region(alns)
    ani, qcov, rcov = ani_cov_from_alignments(alns, qry_len, ref_len)
    return i, j, ani, qcov, rcov


def _nucmer_allpairs(
    gs: GenomeSketches, indices: list[int], bdb: pd.DataFrame, processes: int, filtered: bool
):
    _require("nucmer")
    loc = {r.genome: r.location for r in bdb.itertuples()}
    glen = gs.gdb.set_index("genome")["length"]
    names = [gs.names[i] for i in indices]
    m = len(names)
    ani = np.zeros((m, m), np.float32)
    cov = np.zeros((m, m), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        # ANIn (unfiltered) is direction-symmetric: one nucmer run yields
        # both directions (ani is shared; rcov IS the reverse coverage).
        # ANImf's query-axis filter makes directions differ, so both run.
        jobs = [
            (i, j, loc[names[i]], loc[names[j]], int(glen[names[i]]), int(glen[names[j]]), tmp, filtered)
            for i in range(m)
            for j in range(m)
            if (i != j if filtered else i < j)
        ]
        # nucmer is an external process: threads are enough to fan it out
        with ThreadPoolExecutor(max_workers=max(processes, 1)) as pool:
            for i, j, a, qcov, rcov in pool.map(_nucmer_pair, jobs):
                ani[i, j] = a
                cov[i, j] = qcov
                if not filtered:
                    ani[j, i] = a
                    cov[j, i] = rcov
    np.fill_diagonal(ani, 1.0)
    np.fill_diagonal(cov, 1.0)
    return ani, cov


@register_secondary("ANImf")
def secondary_animf(gs, indices, bdb=None, processes: int = 1, **_):
    """nucmer + best-per-query-region filtering (reference ANImf)."""
    if bdb is None:
        raise ValueError("ANImf needs Bdb (paths to the FASTA files)")
    return _nucmer_allpairs(gs, indices, bdb, processes, filtered=True)


@register_secondary("ANIn")
def secondary_anin(gs, indices, bdb=None, processes: int = 1, **_):
    """Raw nucmer alignments, unfiltered (reference ANIn)."""
    if bdb is None:
        raise ValueError("ANIn needs Bdb (paths to the FASTA files)")
    return _nucmer_allpairs(gs, indices, bdb, processes, filtered=False)


_WARNED_GANI_MISMATCH: list[bool] = []


def reset_run_state() -> None:
    """Clear per-run warn-once flags (workflows call this at run start so a
    second run in the same process warns again)."""
    _WARNED_GANI_MISMATCH.clear()


def parse_gani_file(path: str, name1: str, name2: str):
    """Parse ANIcalculator output by HEADER NAME (column order varies across
    versions — the reference parses by name for the same reason). Returns
    ((ani12, af12), (ani21, af21)); a pair absent from the output means no
    significant alignment (an expected outcome at loose primary cutoffs),
    reported as zeros, not an error."""
    with open(path) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        return (0.0, 0.0), (0.0, 0.0)
    header = [h.strip().upper() for h in lines[0]]
    col = {name: i for i, name in enumerate(header)}
    needed = ["GENOME1", "GENOME2", "ANI(1->2)", "ANI(2->1)", "AF(1->2)", "AF(2->1)"]
    missing = [c for c in needed if c not in col]
    if missing:
        raise RuntimeError(f"unrecognized ANIcalculator header {header} in {path}: missing {missing}")
    for row in lines[1:]:
        if len(row) < len(header):
            continue
        g1, g2 = row[col["GENOME1"]], row[col["GENOME2"]]
        if {g1, g2} != {name1, name2}:
            continue
        ani12 = float(row[col["ANI(1->2)"]])
        ani21 = float(row[col["ANI(2->1)"]])
        af12 = float(row[col["AF(1->2)"]])
        af21 = float(row[col["AF(2->1)"]])
        if g1 != name1:  # swap to the requested orientation
            ani12, ani21, af12, af21 = ani21, ani12, af21, af12
        return (ani12 / 100.0, af12), (ani21 / 100.0, af21)
    if len(lines) > 1 and not _WARNED_GANI_MISMATCH:
        # rows exist but none mention the requested pair — likely a genome
        # name-normalization mismatch, which would otherwise masquerade as
        # "no significant alignment" for EVERY pair. Warn once: when the
        # condition is real it hits every parse and would flood the log.
        _WARNED_GANI_MISMATCH.append(True)
        get_logger().warning(
            "gANI output %s has %d rows but none match pair (%s, %s) — "
            "check genome name normalization (reported once; likely affects "
            "every pair in this run)",
            path, len(lines) - 1, name1, name2,
        )
    return (0.0, 0.0), (0.0, 0.0)


def _prodigal_genes(fasta: str, out_dir: str, stem: str) -> str:
    """Gene nucleotide FASTA via prodigal (shared by gANI/goANI).

    `stem` must be unique per genome — basenames can collide across input
    directories, so callers key by genome index, never by file name.
    """
    _require("prodigal")
    base = os.path.join(out_dir, stem)
    genes = base + ".genes.fna"
    if not os.path.exists(genes):
        _run(["prodigal", "-i", fasta, "-d", genes, "-m", "-p", "meta", "-o", base + ".gff", "-q"])
    return genes


def _gani_pair(args) -> tuple[int, int, float, float, float, float]:
    i, j, genes_i, genes_j, tmp = args
    pair_dir = os.path.join(tmp, f"g{i}_{j}")
    _run(
        ["ANIcalculator", "-genome1fna", genes_i, "-genome2fna", genes_j,
         "-outdir", pair_dir, "-outfile", "ani.out"],
    )
    (a12, f12), (a21, f21) = parse_gani_file(
        os.path.join(pair_dir, "ani.out"),
        os.path.basename(genes_i).rsplit(".fna", 1)[0],
        os.path.basename(genes_j).rsplit(".fna", 1)[0],
    )
    return i, j, a12, f12, a21, f21


@register_secondary("gANI")
def secondary_gani(gs, indices, bdb=None, processes: int = 1, **_):
    """ANIcalculator on prodigal gene calls (reference gANI)."""
    _require("ANIcalculator")
    if bdb is None:
        raise ValueError("gANI needs Bdb (paths to the FASTA files)")
    loc = {r.genome: r.location for r in bdb.itertuples()}
    names = [gs.names[i] for i in indices]
    m = len(names)
    ani = np.zeros((m, m), np.float32)
    cov = np.zeros((m, m), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        # prodigal and ANIcalculator are external processes: threads fan
        # both out fine (gene calling dominates per-genome wall-clock)
        with ThreadPoolExecutor(max_workers=max(processes, 1)) as pool:
            genes = list(
                pool.map(
                    lambda tg: _prodigal_genes(loc[tg[1]], tmp, stem=f"genome_{tg[0]}"),
                    enumerate(names),
                )
            )
            jobs = [
                (i, j, genes[i], genes[j], tmp) for i in range(m) for j in range(i + 1, m)
            ]
            for i, j, a12, f12, a21, f21 in pool.map(_gani_pair, jobs):
                ani[i, j], cov[i, j] = a12, f12
                ani[j, i], cov[j, i] = a21, f21
    np.fill_diagonal(ani, 1.0)
    np.fill_diagonal(cov, 1.0)
    return ani, cov


# ---- goANI: prodigal + nsimscan (open-source gANI replacement) --------------

# nsimscan tabular output headers vary across releases; columns are located
# by name from these alias sets (same strategy as parse_gani_file above —
# the reference, too, parses by header name because orders differ)
_NSIMSCAN_COLS = {
    "query": ("q_id", "qid", "query", "qry_id", "qry"),
    "subject": ("s_id", "sid", "subject", "sbj_id", "sbj"),
    "al_len": ("al_len", "alen", "length", "aln_len"),
    "pident": ("p_inden", "p_ident", "pident", "identity", "p_identity"),
}


def parse_nsimscan_table(path: str) -> list[tuple[str, str, int, float]]:
    """nsimscan tab output -> [(query_gene, subject_gene, al_len, pident)].

    The first non-empty line must be a header naming the four required
    columns (any alias, any order, case-insensitive); rows failing to parse
    numerically are skipped (nsimscan appends summary lines in some modes).
    """
    with open(path) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        return []
    header = [h.strip().lower() for h in lines[0]]
    col: dict[str, int] = {}
    for want, aliases in _NSIMSCAN_COLS.items():
        for a in aliases:
            if a in header:
                col[want] = header.index(a)
                break
    missing = [c for c in _NSIMSCAN_COLS if c not in col]
    if missing:
        raise RuntimeError(
            f"unrecognized nsimscan header {header} in {path}: missing {missing}"
        )
    out: list[tuple[str, str, int, float]] = []
    for row in lines[1:]:
        if len(row) <= max(col.values()):
            continue
        try:
            out.append(
                (
                    row[col["query"]].strip(),
                    row[col["subject"]].strip(),
                    int(float(row[col["al_len"]])),
                    float(row[col["pident"]]),
                )
            )
        except ValueError:
            continue  # summary/comment row
    return out


def goani_ani_af(
    hits: list[tuple[str, str, int, float]], qry_gene_lengths: dict[str, int]
) -> tuple[float, float]:
    """(ani, af) for one direction from nsimscan gene hits.

    Per query gene the single best hit (largest al_len * pident) is kept —
    the reference's process_goani_files keeps one reciprocal-best per gene
    for the same reason gANI does: paralogs must not double-count. ANI is
    the alignment-length-weighted mean identity over kept hits; AF is the
    kept aligned length over the total query gene length.
    """
    best: dict[str, tuple[int, float]] = {}
    for q, _s, al, pid in hits:
        score = al * pid
        if q not in best or score > best[q][0] * best[q][1]:
            best[q] = (al, pid)
    total_aln = sum(al for al, _ in best.values())
    total_len = sum(qry_gene_lengths.values())
    if total_aln == 0 or total_len == 0:
        return 0.0, 0.0
    ani = sum(al * pid for al, pid in best.values()) / total_aln / 100.0
    return min(ani, 1.0), min(total_aln / total_len, 1.0)


def _gene_lengths(genes_fna: str) -> dict[str, int]:
    return dict(read_fasta_headers_lengths(genes_fna))


def _nsimscan_pair(args) -> tuple[int, int, float, float]:
    i, j, genes_i, genes_j, lens_i, tmp = args
    out = os.path.join(tmp, f"ns{i}_{j}.tab")
    # TABX: tab-separated with a header line (the JAX package's argv)
    _run(["nsimscan", "--om", "TABX", genes_i, genes_j, out])
    ani, af = goani_ani_af(parse_nsimscan_table(out), lens_i)
    return i, j, ani, af


@register_secondary("goANI")
def secondary_goani(gs, indices, bdb=None, processes: int = 1, **_):
    """Open-source gANI replacement: prodigal gene calls + nsimscan
    all-vs-all gene alignment (reference goANI path)."""
    _require("nsimscan")
    if bdb is None:
        raise ValueError("goANI needs Bdb (paths to the FASTA files)")
    loc = {r.genome: r.location for r in bdb.itertuples()}
    names = [gs.names[i] for i in indices]
    m = len(names)
    ani = np.zeros((m, m), np.float32)
    cov = np.zeros((m, m), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(max_workers=max(processes, 1)) as pool:
            genes = list(
                pool.map(
                    lambda tg: _prodigal_genes(loc[tg[1]], tmp, stem=f"genome_{tg[0]}"),
                    enumerate(names),
                )
            )
            lens = [_gene_lengths(g) for g in genes]
            # directional: gene hits of i's genes against j's gene set give
            # ani/AF (i->j); both directions run (like gANI's two columns)
            jobs = [
                (i, j, genes[i], genes[j], lens[i], tmp)
                for i in range(m)
                for j in range(m)
                if i != j
            ]
            for i, j, a, f in pool.map(_nsimscan_pair, jobs):
                ani[i, j] = a
                cov[i, j] = f
    np.fill_diagonal(ani, 1.0)
    np.fill_diagonal(cov, 1.0)
    return ani, cov
