"""Canonical data-table contracts (the dRep DataFrame schemas).

These are the stable *semantics* the rebuild preserves while swapping the
execution engine (SURVEY.md §2, §7 step 1). Column names and meanings follow
the reference's canonical tables (reference mount empty; names corroborated
by BASELINE.json north-star text — Mdb/Ndb/Cdb/Wdb — and upstream dRep):

- **Bdb**: genome -> location on disk
- **Gdb / genomeInfo**: per-genome stats (length, N50, completeness, ...)
- **Mdb**: primary all-pairs MinHash table (genome1, genome2, dist, similarity)
- **Ndb**: secondary ANI pairs (reference, querry, ani, alignment_coverage,
  primary_cluster)  [sic: "querry" is the reference's historical spelling]
- **Cdb**: genome -> primary_cluster, secondary_cluster, threshold,
  cluster_method, comparison_algorithm
- **Sdb**: genome -> score
- **Wdb**: secondary cluster -> winner genome, score
"""

from __future__ import annotations

import pandas as pd

BDB_COLUMNS = ["genome", "location"]
GDB_COLUMNS = ["genome", "length", "N50", "contigs"]
GENOME_INFO_COLUMNS = ["genome", "completeness", "contamination"]
MDB_COLUMNS = ["genome1", "genome2", "dist", "similarity"]
NDB_COLUMNS = [
    "reference",
    "querry",
    "ani",
    "alignment_coverage",
    "ref_coverage",
    "querry_coverage",
    "primary_cluster",
]
CDB_COLUMNS = [
    "genome",
    "secondary_cluster",
    "threshold",
    "cluster_method",
    "comparison_algorithm",
    "primary_cluster",
]
SDB_COLUMNS = ["genome", "score"]
WDB_COLUMNS = ["genome", "cluster", "score"]

_SCHEMAS: dict[str, list[str]] = {
    "Bdb": BDB_COLUMNS,
    "Gdb": GDB_COLUMNS,
    "Mdb": MDB_COLUMNS,
    "Ndb": NDB_COLUMNS,
    "Cdb": CDB_COLUMNS,
    "Sdb": SDB_COLUMNS,
    "Wdb": WDB_COLUMNS,
}


def required_columns(name: str) -> list[str]:
    return list(_SCHEMAS[name])


def validate(df: pd.DataFrame, name: str) -> pd.DataFrame:
    """Assert `df` carries the required columns for table `name`.

    Extra columns are allowed (the reference tables accumulate extras like
    `genome` metadata); missing ones are an error.
    """
    missing = [c for c in _SCHEMAS[name] if c not in df.columns]
    if missing:
        raise ValueError(f"{name} is missing required columns {missing}; has {list(df.columns)}")
    return df


def empty(name: str) -> pd.DataFrame:
    return pd.DataFrame({c: [] for c in _SCHEMAS[name]})
