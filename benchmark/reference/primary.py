"""The plain streaming primary: every retained edge and the primary
clusters, worked out from the raw bottom sketches.

1. Components: genomes that share a hash are joined (label propagation
   over the hashes, plain torch). Two genomes in different components
   share no hash, so their shared count is 0, their distance 1, and no
   edge joins them at any retention bound below 1.
2. Edges: every pair inside a component, its shared count by
   :func:`mash.shared_counts`, its distance by :func:`mash.distance`;
   retained where d <= keep.
3. Clusters: average linkage (UPGMA) over each component's full distance
   matrix, cut at the cutoff: :func:`upgma_flat`. A pair of components
   averages 1 and never merges below a cutoff under 1, so the partition
   is full-matrix UPGMA's over all genomes.

UPGMA leaves the partition undefined where two candidate merges have the
same average; :func:`upgma_flat` states its rule for them (the one the
program documents for its heap), so that the comparison can be exact.

Nothing here imports the program; the inputs are the benchmark's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import mash


@dataclass
class PrimaryReference:
    """keys: sorted i * n + j of the retained pairs (i < j); dist: their
    float32 distances; canon: [n, 2] (smallest member, size) of each
    genome's primary cluster; shared_sum: the shared counts summed over
    every pair (the roofline's merge steps need it); ties: the accepted
    merges at which another candidate had the same average."""

    n: int
    keys: np.ndarray
    dist: np.ndarray
    canon: np.ndarray
    shared_sum: int
    ties: int = 0


def components(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[n] the smallest genome index of each genome's component of the
    shares-a-hash graph."""
    n, w = rows.shape
    valid = torch.arange(w, device=rows.device)[None, :] < counts[:, None]
    owner = torch.arange(n, device=rows.device)[:, None].expand(n, w)[valid]
    _, group = torch.unique(rows[valid], return_inverse=True)
    n_groups = int(group.max()) + 1 if group.numel() else 0
    lab = torch.arange(n, device=rows.device)
    while True:
        hmin = torch.full((n_groups,), n, device=rows.device).scatter_reduce(0, group, lab[owner], "amin")
        new = lab.scatter_reduce(0, owner, hmin[group], "amin")
        new = new[new]  # pointer jump
        if torch.equal(new, lab):
            return lab
        lab = new


def component_pairs(comp: np.ndarray) -> tuple[list[np.ndarray], np.ndarray, np.ndarray]:
    """(members of each multi-genome component, ascending; all their pairs
    ii < jj, component by component, each in condensed order)."""
    order = np.argsort(comp, kind="stable")
    _, starts, sizes = np.unique(comp[order], return_index=True, return_counts=True)
    groups = [order[s : s + m] for s, m in zip(starts, sizes) if m > 1]
    ii, jj = [], []
    by_size: dict[int, list[int]] = {}
    for g, members in enumerate(groups):
        by_size.setdefault(len(members), []).append(g)
    # pairs in component order: each size class gives a block of rows
    pair_of_group: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for m, gs in by_size.items():
        iu, ju = np.triu_indices(m, 1)
        mem = np.stack([groups[g] for g in gs])
        for row, g in enumerate(gs):
            pair_of_group[g] = (mem[row, iu], mem[row, ju])
    for g in range(len(groups)):
        ii.append(pair_of_group[g][0])
        jj.append(pair_of_group[g][1])
    cat = (lambda xs: np.concatenate(xs) if xs else np.empty(0, np.int64))
    return groups, cat(ii).astype(np.int64), cat(jj).astype(np.int64)


def primary_reference(
    hashes: np.ndarray,
    counts: np.ndarray,
    sketch: int,
    k: int,
    cutoff: float,
    keep: float,
    device: torch.device,
    precision: str = "float32",
) -> PrimaryReference:
    """The retained edges and the primary clusters of these sketches
    (module docstring), distances in `precision`."""
    n = hashes.shape[0]
    rows = torch.from_numpy(mash.signed_rows(hashes, counts)).to(device)
    cnt = torch.from_numpy(counts.astype(np.int64)).to(device)
    comp = components(rows, cnt).cpu().numpy()
    groups, ii, jj = component_pairs(comp)
    shared = mash.pair_shared(rows, cnt, torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device), sketch)
    shared = shared.cpu().numpy()
    del rows
    s_use = np.minimum(np.minimum(counts[ii], counts[jj]), sketch).astype(np.int64)
    d = mash.distance(shared, s_use, k, precision)
    kept = d <= np.float32(keep)
    keys = ii[kept] * n + jj[kept]
    order = np.argsort(keys, kind="stable")

    labels = np.arange(n, dtype=np.int64)  # singletons: their own cluster
    ties = 0
    off = 0
    for members in groups:
        m = len(members)
        npairs = m * (m - 1) // 2
        dm = np.zeros((m, m), dtype=np.float64)
        iu, ju = np.triu_indices(m, 1)
        dm[iu, ju] = d[off : off + npairs]
        dm[ju, iu] = dm[iu, ju]
        first, tied = upgma_flat(dm, members, n, cutoff)
        labels[members] = first
        ties += tied
        off += npairs
    return PrimaryReference(n=n, keys=keys[order], dist=d[kept][order], canon=canonical(labels),
                            shared_sum=int(shared.sum()), ties=ties)


def _keys(ids_a: np.ndarray, ids_b: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The tie order of the candidate merges of clusters ids_a[i], ids_b[i]
    (module docstring of :func:`upgma_flat`)."""
    lo, hi = np.minimum(ids_a, ids_b), np.maximum(ids_a, ids_b)
    both_single = hi < n
    return np.where(both_single, lo, hi), np.where(both_single, hi, lo)


def upgma_flat(dist: np.ndarray, members: np.ndarray, n: int, cutoff: float) -> tuple[np.ndarray, int]:
    """Average linkage over one component's full distance matrix `dist`
    [m, m] (float64 of the float32 distances), cut at `cutoff`: (the
    smallest member of each member's flat cluster, the tied merges).

    The merge with the least average is made while that average is <=
    cutoff (fcluster's "distance" criterion). The average of two clusters
    is the sum of their pair distances, kept exactly in float64, over the
    product of their sizes. Clusters are named as scipy names them: a
    genome by its index (`members`, of n genomes), the merge made t-th by
    n + t. Among equal averages the merge whose pair of names is least
    goes first: two genomes by (smaller, larger) index, any other pair by
    (newer name, older name).

    Each cluster keeps its best candidate (least average, then least key),
    and only the rows that a merge touches are searched again."""
    m = dist.shape[0]
    first = members.astype(np.int64).copy()
    if m < 2:
        return first, 0
    sums = dist.copy()
    size = np.ones(m, dtype=np.float64)
    ids = members.astype(np.int64).copy()
    alive = np.ones(m, dtype=bool)
    slot_of = np.arange(m)  # each member's current cluster slot
    next_id = n
    best_v = np.empty(m)
    best_k = np.empty((m, 2), dtype=np.int64)
    best_c = np.empty(m, dtype=np.int64)

    def search(rows: np.ndarray) -> None:
        avg = sums[rows] / (size[rows, None] * size[None, :])
        avg[:, ~alive] = np.inf
        avg[np.arange(rows.shape[0]), rows] = np.inf
        v = avg.min(axis=1)
        eq = avg == v[:, None]
        col = eq.argmax(axis=1)
        k1, k2 = _keys(ids[rows], ids[col], n)
        best_v[rows], best_c[rows], best_k[rows, 0], best_k[rows, 1] = v, col, k1, k2
        for i in np.flatnonzero(eq.sum(axis=1) > 1).tolist():  # a row with equal candidates
            r, cols = rows[i], np.flatnonzero(eq[i])
            k1, k2 = _keys(np.full(cols.shape[0], ids[r]), ids[cols], n)
            j = np.lexsort((k2, k1))[0]
            best_k[r], best_c[r] = (k1[j], k2[j]), cols[j]

    search(np.arange(m))
    tied = 0
    while alive.sum() > 1:
        rows = np.flatnonzero(alive)
        v = best_v[rows].min()
        if v > cutoff:
            break
        at = rows[best_v[rows] == v]
        r = at[np.lexsort((best_k[at, 1], best_k[at, 0]))[0]]
        c = int(best_c[r])
        if at.shape[0] > 2 or np.count_nonzero((sums[r] / (size[r] * size) == v) & alive) > 1:
            tied += 1
        # merge c into r's slot as a new cluster
        sums[r] += sums[c]
        sums[:, r] = sums[r]
        size[r] += size[c]
        alive[c] = False
        ids[r] = next_id
        next_id += 1
        slot_of[slot_of == c] = r
        rows = np.flatnonzero(alive)
        again = rows[(best_c[rows] == r) | (best_c[rows] == c) | (rows == r)]
        rest = rows[~np.isin(rows, again)]
        if rest.shape[0]:
            # the new cluster as each other row's candidate: key (its name, theirs)
            av = sums[rest, r] / (size[rest] * size[r])
            better = (av < best_v[rest]) | (
                (av == best_v[rest])
                & ((ids[r] < best_k[rest, 0]) | ((ids[r] == best_k[rest, 0]) & (ids[rest] < best_k[rest, 1])))
            )
            up = rest[better]
            best_v[up], best_c[up] = av[better], r
            best_k[up, 0], best_k[up, 1] = ids[r], ids[up]
        if again.shape[0]:
            search(again)
    low = np.full(m, np.iinfo(np.int64).max)
    np.minimum.at(low, slot_of, first)
    return low[slot_of], tied


def canonical(labels: np.ndarray) -> np.ndarray:
    """[n, 2]: (smallest member, size) of each genome's class under any
    labelling; two labellings give the same partition iff these agree."""
    n = labels.shape[0]
    _, inv, sizes = np.unique(labels, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    first = np.full(sizes.shape[0], n, dtype=np.int64)
    np.minimum.at(first, inv, np.arange(n))
    return np.stack([first[inv], sizes[inv]], axis=1)
