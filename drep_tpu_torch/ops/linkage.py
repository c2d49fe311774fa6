"""Hierarchical clustering on distance matrices.

Counterpart of drep_tpu/ops/linkage.py. Two engines:

- :func:`cluster_hierarchical` (host, scipy): exact reference semantics for
  every linkage method (average is dRep's default) — a copy of the JAX
  package's.
- :func:`single_linkage_device` (torch): single-linkage flat clusters at a
  cutoff == connected components of the thresholded distance graph,
  computed as min-label propagation with pointer jumping on the device.

Labels are renumbered 1..C by first appearance in genome order for both.
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch
import scipy.spatial.distance as ssd
import torch


def _renumber_first_appearance(labels: np.ndarray) -> np.ndarray:
    """Map arbitrary labels -> 1..C ordered by first appearance."""
    out = np.zeros(len(labels), dtype=np.int64)
    mapping: dict[int, int] = {}
    for i, lab in enumerate(labels):
        key = int(lab)
        if key not in mapping:
            mapping[key] = len(mapping) + 1
        out[i] = mapping[key]
    return out


def cluster_hierarchical(
    dist: np.ndarray,
    cutoff: float,
    method: str = "average",
) -> tuple[np.ndarray, np.ndarray]:
    """Flat clusters of a square distance matrix at cophenetic cutoff.

    Returns (labels 1..C int64 by first appearance, scipy linkage matrix).
    """
    dist = np.asarray(dist, dtype=np.float64)
    n = dist.shape[0]
    if n == 1:
        return np.ones(1, dtype=np.int64), np.empty((0, 4))
    dist = np.maximum(dist, dist.T)  # enforce symmetry for squareform
    np.fill_diagonal(dist, 0.0)
    condensed = ssd.squareform(dist, checks=False)
    link = sch.linkage(condensed, method=method)
    labels = sch.fcluster(link, t=cutoff, criterion="distance")
    return _renumber_first_appearance(labels), link


def connected_components_labels(adj: torch.Tensor) -> torch.Tensor:
    """Min-label propagation over a boolean adjacency matrix [N, N]:
    labels[i] converges to the min node index reachable from i. Each sweep
    is one masked min-reduce plus a pointer jump labels[labels]."""
    n = adj.shape[0]
    adj = adj | torch.eye(n, dtype=torch.bool, device=adj.device)
    labels = torch.arange(n, dtype=torch.int64, device=adj.device)
    big = torch.tensor(n, dtype=torch.int64, device=adj.device)
    while True:
        cand = torch.where(adj, labels[None, :], big)
        new = torch.minimum(labels, cand.min(dim=1).values)
        new = torch.minimum(new, new[new])
        if torch.equal(new, labels):
            return labels
        labels = new


def single_linkage_device(dist: np.ndarray, cutoff: float, device: torch.device) -> np.ndarray:
    """Single-linkage flat clusters at `cutoff` via components on `device`.

    Equals scipy single-linkage + fcluster(criterion='distance'): a cluster
    is a connected component of {d <= cutoff}.
    """
    adj = torch.as_tensor(np.asarray(dist), device=device) <= cutoff
    labels = connected_components_labels(adj).cpu().numpy()
    return _renumber_first_appearance(labels)
