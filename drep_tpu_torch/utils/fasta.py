"""FASTA ingestion and per-genome assembly statistics.

Reference parity: drep/d_filter.py::calc_fasta_stats (length/N50 via
Biopython per-contig scan — SURVEY.md §2, hot loop #0; reference mount
empty). Here parsing is a single bytes pass with numpy post-processing, and
an optional C++ fast path (drep_tpu_torch.native) takes over for bulk ingest.

Supports plain and gzip FASTA.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class FastaStats:
    genome: str
    length: int
    N50: int
    contigs: int


def _open_maybe_gzip(path: str):
    # content-based detection (gzip magic), matching the native path's
    # transparent gzopen — a ".gz" name must not change how bytes are parsed
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta_contigs(path: str) -> list[bytes]:
    """Return the list of contig sequences (uppercase bytes, no newlines)."""
    contigs: list[bytes] = []
    chunks: list[bytes] = []
    with _open_maybe_gzip(path) as f:
        data = f.read()
    if not data:
        return []
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if chunks:
                contigs.append(b"".join(chunks).upper())
                chunks = []
        elif stripped := line.strip():
            # whitespace-only lines add no contig (the native path agrees)
            chunks.append(stripped)
    if chunks:
        contigs.append(b"".join(chunks).upper())
    return contigs


def read_fasta_headers_lengths(path: str) -> list[tuple[str, int]]:
    """[(record_id, sequence_length)] per record — record_id is the first
    whitespace-delimited token of the header (the id nsimscan/prodigal
    reports in hit tables)."""
    out: list[tuple[str, int]] = []
    name: str | None = None
    length = 0
    with _open_maybe_gzip(path) as f:
        data = f.read()
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if name is not None:
                out.append((name, length))
            name = line[1:].split()[0].decode() if line[1:].split() else ""
            length = 0
        else:
            length += len(line.strip())
    if name is not None:
        out.append((name, length))
    return out


def read_fasta_concat(path: str, separator: bytes = b"N") -> bytes:
    """All contigs joined by one `N` (k-mer windows never span contigs,
    because windows containing non-ACGT are masked out downstream)."""
    return separator.join(read_fasta_contigs(path))


def n50(lengths: np.ndarray) -> int:
    """Standard N50: length L such that contigs >= L cover half the assembly."""
    if len(lengths) == 0:
        return 0
    srt = np.sort(np.asarray(lengths))[::-1]
    csum = np.cumsum(srt)
    total = csum[-1]
    idx = int(np.searchsorted(csum, total / 2.0))
    return int(srt[min(idx, len(srt) - 1)])


def fasta_stats(path: str, genome: str | None = None) -> FastaStats:
    contigs = read_fasta_contigs(path)
    lengths = np.array([len(c) for c in contigs], dtype=np.int64)
    return FastaStats(
        genome=genome if genome is not None else os.path.basename(path),
        length=int(lengths.sum()) if len(lengths) else 0,
        N50=n50(lengths),
        contigs=len(contigs),
    )
