"""Shared pair-table construction and coverage gating.

One implementation of the Ndb row layout (directional, fastANI-style
query->reference rows — reference drep/d_cluster Ndb contract, SURVEY.md §2)
and of the two-sided coverage gate + symmetrization used before secondary/
tertiary hierarchical clustering, so the stages cannot drift apart.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

NDB_COLUMNS = [
    "reference",
    "querry",
    "ani",
    "alignment_coverage",
    "ref_coverage",
    "querry_coverage",
    "primary_cluster",
]


def directional_ndb(
    names: list[str],
    ani: np.ndarray,
    cov: np.ndarray,
    primary_cluster: int,
    pair_mask: np.ndarray | None = None,
) -> pd.DataFrame:
    """All ordered off-diagonal pairs as Ndb rows (row i = query i vs ref j).

    `pair_mask` [m, m] optionally restricts which ordered pairs are emitted
    (tertiary uses it to keep only cross-primary comparisons).
    """
    m = len(names)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    keep = ii != jj
    if pair_mask is not None:
        keep &= pair_mask
    ii, jj = ii[keep], jj[keep]
    arr = np.array(names)
    return pd.DataFrame(
        {
            "reference": arr[jj],
            "querry": arr[ii],
            "ani": ani[ii, jj].astype(np.float64),
            "alignment_coverage": cov[ii, jj].astype(np.float64),
            "ref_coverage": cov[jj, ii].astype(np.float64),
            "querry_coverage": cov[ii, jj].astype(np.float64),
            "primary_cluster": primary_cluster,
        }
    )


def empty_ndb() -> pd.DataFrame:
    return pd.DataFrame(columns=NDB_COLUMNS)


def gated_symmetric_ani(
    ani: np.ndarray,
    cov: np.ndarray,
    cov_thresh: float,
    allow_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Symmetrized ANI with the reference's two-sided coverage gate applied
    (cov < cov_thresh in either direction -> similarity zeroed), diagonal 1.

    `allow_mask` [m, m] optionally zeroes additional pairs (tertiary uses it
    to forbid same-primary merges).
    """
    sym = (ani + ani.T) / 2.0
    gate = (cov >= cov_thresh) & (cov.T >= cov_thresh)
    if allow_mask is not None:
        gate &= allow_mask
    sym = np.where(gate, sym, 0.0)
    np.fill_diagonal(sym, 1.0)
    return sym
