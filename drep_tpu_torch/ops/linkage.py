"""Hierarchical clustering on distance matrices.

Counterpart of drep_tpu/ops/linkage.py. Three engines:

- :func:`cluster_hierarchical` (host, scipy): exact reference semantics for
  every linkage method (average is dRep's default) — a copy of the JAX
  package's.
- :func:`single_linkage_device` (torch): single-linkage flat clusters at a
  cutoff == connected components of the thresholded distance graph,
  computed as min-label propagation with pointer jumping on the device.
- :func:`sparse_average_linkage` (host): UPGMA over the streaming
  primary's retained edges, the C++ replica in native/linkage.cc where it
  builds, else the Python lazy heap it replicates.

Labels are renumbered 1..C by first appearance in genome order for both.
"""

from __future__ import annotations

import heapq

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


def sparse_average_linkage(
    n: int, ii: np.ndarray, jj: np.ndarray, dd: np.ndarray, cutoff: float, keep: float
) -> tuple[np.ndarray, int]:
    """Average-linkage (UPGMA) flat clusters at `cutoff` from a sparse
    edge set: every pair with distance <= `keep` is an edge, so a pair
    not in the set has distance > keep and enters the averages at that
    lower bound. A rejected merge is therefore always right, and an
    accepted merge whose average held no unobserved pair is exact.

    Returns (labels 1..C by first appearance, accepted merges that
    averaged over unobserved pairs); a zero second value certifies the
    partition equals scipy's full-matrix average linkage + fcluster at
    `cutoff` up to the order of tied merges. The native replica
    (native/linkage.cc) runs where it builds, else
    :func:`sparse_average_linkage_python`; both give the same partition.
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    from drep_tpu_torch.native import sparse_upgma_native

    native = sparse_upgma_native(n, ii, jj, dd, cutoff, keep)
    if native is None:
        return sparse_average_linkage_python(n, ii, jj, dd, cutoff, keep)
    raw, approx_merges = native
    return _renumber_first_appearance(raw), approx_merges


def sparse_average_linkage_python(
    n: int, ii: np.ndarray, jj: np.ndarray, dd: np.ndarray, cutoff: float, keep: float
) -> tuple[np.ndarray, int]:
    """The lazy-heap formulation native/linkage.cc replicates (the JAX
    package's): only edge-connected cluster pairs are merge candidates,
    since a pair with no observed cross edge averages >= keep > cutoff;
    heap entries order by the whole (avg, a, b, s, c) tuple, and entries
    whose pair changed since they were pushed are skipped."""
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    # symmetric neighbour maps: nbr[a][b] == nbr[b][a] == (sum_obs, cnt_obs)
    nbr: dict[int, dict[int, tuple[float, int]]] = {i: {} for i in range(n)}
    for a, b, d in zip(ii.tolist(), jj.tolist(), dd.tolist()):
        if a == b:
            continue
        cur = nbr[a].get(b)
        if cur is None or d < cur[0]:  # duplicates collapse to their min
            nbr[a][b] = nbr[b][a] = (float(d), 1)

    size = {i: 1 for i in range(n)}
    members: dict[int, list[int]] = {i: [i] for i in range(n)}
    alive = set(range(n))

    def bound(a: int, b: int, s: float, c: int) -> float:
        total = size[a] * size[b]
        return (s + (total - c) * keep) / total

    # singleton pairs: the bound is the edge's distance; heapify once
    heap: list[tuple[float, int, int, float, int]] = [
        (s, a, b, s, c) for a in range(n) for b, (s, c) in nbr[a].items() if a < b
    ]
    heapq.heapify(heap)

    next_id = n
    approx_merges = 0
    while heap:
        avg, a, b, s, c = heapq.heappop(heap)
        if avg > cutoff:
            break  # the heap's minimum is the global minimum over valid candidates
        if a not in alive or b not in alive:
            continue
        if nbr[a].get(b) != (s, c):
            continue  # stale entry
        if c < size[a] * size[b]:
            approx_merges += 1
        cid = next_id
        next_id += 1
        merged: dict[int, tuple[float, int]] = {}
        for src in (a, b):
            for x, (sx, cx) in nbr[src].items():
                if x == a or x == b:
                    continue
                del nbr[x][src]
                prev = merged.get(x)
                merged[x] = (prev[0] + sx, prev[1] + cx) if prev else (sx, cx)
        del nbr[a], nbr[b]
        alive.discard(a)
        alive.discard(b)
        alive.add(cid)
        size[cid] = size[a] + size[b]
        # small-to-large extend keeps the member moves O(N log N)
        ma, mb = members.pop(a), members.pop(b)
        if len(ma) < len(mb):
            ma, mb = mb, ma
        ma.extend(mb)
        members[cid] = ma
        nbr[cid] = merged
        for x, (sx, cx) in merged.items():
            nbr[x][cid] = (sx, cx)
            heapq.heappush(heap, (bound(cid, x, sx, cx), cid, x, sx, cx))

    labels = np.zeros(n, dtype=np.int64)
    for cid in alive:
        for node in members[cid]:
            labels[node] = cid
    return _renumber_first_appearance(labels), approx_merges
