"""Chunked (multi-round) primary clustering for very large genome sets.

Counterpart of drep_tpu/cluster/multiround.py (`--multiround_primary_
clustering` with n > `--primary_chunksize`). It never builds the full
N^2 Mash matrix:

round 1: split the genomes into chunks of `--primary_chunksize`, all-vs-all
         Mash and hierarchical clustering within each chunk; one
         representative (the most k-mers) for each chunk cluster;
round 2: all-vs-all Mash over the representatives; every genome takes its
         representative's round-2 cluster, renumbered by first appearance.

As in the reference, this is an approximation: genomes whose similarity
straddles two chunks merge only if their representatives do. Each Mash
matrix is engines.py::mash_distance_matrix, so a chunk runs the estimator
and the mesh the run asked for.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas as pd
import torch

from drep_tpu_torch.cluster.engines import mash_distance_matrix
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.ops.linkage import cluster_hierarchical
from drep_tpu_torch.ops.minhash import pack_sketches
from drep_tpu_torch.utils.logger import get_logger


def _cluster_chunk(
    gs: GenomeSketches,
    idx: list[int],
    cutoff: float,
    method: str,
    mesh_shape: int | None,
    estimator: str,
    device: torch.device,
) -> np.ndarray:
    packed = pack_sketches([gs.bottom[i] for i in idx], [gs.names[i] for i in idx], gs.sketch_size)
    dist = mash_distance_matrix(packed, gs.k, device, mesh_shape=mesh_shape, estimator=estimator)
    labels, _ = cluster_hierarchical(dist, cutoff, method=method)
    return labels


def multiround_primary_clustering(
    gs: GenomeSketches, bdb: pd.DataFrame, kw: dict[str, Any]
) -> tuple[np.ndarray, int]:
    """Returns (labels 1..C, pairs compared across both rounds)."""
    n = len(gs.names)
    chunk = int(kw["primary_chunksize"])
    cutoff = 1.0 - kw["P_ani"]
    method = kw["clusterAlg"]
    mesh_shape = kw.get("mesh_shape")
    estimator = kw.get("primary_estimator", "auto")
    device = kw["device"]
    nk = gs.gdb["n_kmers"].to_numpy()

    # round 1: within-chunk clustering, one representative a chunk cluster
    rep_of_genome = np.zeros(n, dtype=np.int64)
    reps: list[int] = []
    pairs_compared = 0
    for c0 in range(0, n, chunk):
        idx = list(range(c0, min(c0 + chunk, n)))
        pairs_compared += len(idx) * (len(idx) - 1) // 2
        labels = _cluster_chunk(gs, idx, cutoff, method, mesh_shape, estimator, device)
        groups: dict[int, list[int]] = {}
        for t, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(idx[t])
        for lab in sorted(groups):
            members = groups[lab]
            rep = max(members, key=lambda i: int(nk[i]))
            reps.append(rep)
            for i in members:
                rep_of_genome[i] = rep
    get_logger().info("multiround: %d chunks -> %d representatives", -(-n // chunk), len(reps))

    # round 2: cluster the representatives
    pairs_compared += len(reps) * (len(reps) - 1) // 2
    rep_labels = _cluster_chunk(gs, reps, cutoff, method, mesh_shape, estimator, device)
    label_of_rep = {rep: int(rep_labels[t]) for t, rep in enumerate(reps)}

    raw = np.array([label_of_rep[int(rep_of_genome[i])] for i in range(n)], dtype=np.int64)
    # renumbered by first appearance, for determinism
    out = np.zeros(n, dtype=np.int64)
    seen: dict[int, int] = {}
    for i, lab in enumerate(raw):
        if int(lab) not in seen:
            seen[int(lab)] = len(seen) + 1
        out[i] = seen[int(lab)]
    return out, pairs_compared
