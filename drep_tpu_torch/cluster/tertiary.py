"""Tertiary clustering: merge secondary clusters across primary boundaries.

Counterpart of drep_tpu/cluster/tertiary.py (`--run_tertiary_clustering`).
The primary (Mash) clustering is approximate, so two genomes of one
species can land in two primary clusters and never meet in a secondary
comparison. Tertiary clustering compares one representative of each
secondary cluster all-vs-all with the secondary engine; representatives
that clear S_ani and the two-sided coverage gate are clustered, and their
secondary clusters merge. Pairs of representatives from one primary
cluster are masked out of the merge graph and of the Ndb rows: the
secondary stage decided them over the clusters' full membership.

The representatives are one pack and one engine call (the secondary's
routes: one-shot, past the budget, or the mesh ring).
"""

from __future__ import annotations

from typing import Any

import pandas as pd

from drep_tpu_torch.cluster import dispatch, pairs
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.ops.linkage import cluster_hierarchical
from drep_tpu_torch.utils.logger import get_logger


def pick_representatives(cdb: pd.DataFrame, gdb: pd.DataFrame) -> pd.DataFrame:
    """One representative a secondary cluster: the member with the most
    k-mers, ties broken by name."""
    df = cdb.merge(gdb[["genome", "n_kmers"]], on="genome", how="left")
    df["n_kmers"] = df["n_kmers"].fillna(0)
    df = df.sort_values(["n_kmers", "genome"], ascending=[False, True])
    return df.groupby("secondary_cluster", sort=True).head(1)[["genome", "secondary_cluster", "primary_cluster"]]


def run_tertiary_clustering(
    gs: GenomeSketches,
    bdb: pd.DataFrame,
    cdb: pd.DataFrame,
    kw: dict[str, Any],
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Returns (Cdb with merged secondary clusters, the tertiary Ndb rows:
    cross-primary pairs only). A merged group takes the label of its
    first-appearing member cluster, so a run without cross-primary
    duplicates leaves Cdb as it was."""
    logger = get_logger()
    reps = pick_representatives(cdb, gs.gdb)
    m = len(reps)
    rep_primary = reps["primary_cluster"].to_numpy()
    cross = rep_primary[:, None] != rep_primary[None, :]
    if m <= 1 or not cross.any():
        return cdb, pairs.empty_ndb()

    name_to_idx = {g: i for i, g in enumerate(gs.names)}
    indices = [name_to_idx[g] for g in reps["genome"]]
    engine = dispatch.get_secondary(kw["S_algorithm"])
    ani, cov = engine(gs, indices, bdb=bdb, device=kw["device"], processes=kw.get("processes", 1),
                      mesh_shape=kw.get("mesh_shape"))

    rep_names = list(reps["genome"])
    # primary_cluster 0 marks tertiary (cross-primary) comparisons
    ndb = pairs.directional_ndb(rep_names, ani, cov, 0, pair_mask=cross)
    sym_ani = pairs.gated_symmetric_ani(ani, cov, kw["cov_thresh"], allow_mask=cross)
    labels, _ = cluster_hierarchical(1.0 - sym_ani, 1.0 - kw["S_ani"], method=kw["clusterAlg"])

    # a merged group -> the label of its first-appearing member cluster
    rep_cluster = list(reps["secondary_cluster"])
    merged_label: dict[str, str] = {}
    group_name: dict[int, str] = {}
    n_merges = 0
    for t in range(m):
        grp = int(labels[t])
        if grp not in group_name:
            group_name[grp] = rep_cluster[t]
        else:
            n_merges += 1
        merged_label[rep_cluster[t]] = group_name[grp]

    if n_merges == 0:
        logger.info("tertiary clustering: no cross-primary merges")
        return cdb, ndb

    out = cdb.copy()
    out["secondary_cluster"] = out["secondary_cluster"].map(merged_label).fillna(out["secondary_cluster"])
    logger.info(
        "tertiary clustering: merged %d secondary clusters (%d -> %d)",
        n_merges,
        cdb["secondary_cluster"].nunique(),
        out["secondary_cluster"].nunique(),
    )
    return out, ndb
