"""The common-threshold MinHash estimator (`--primary_estimator matmul`):
all-vs-all Mash distance from exact intersection counts.

Counterpart of drep_tpu/ops/minhash_matmul.py::all_vs_all_mash_matmul.
For a pair (i, j) let t = min(t_i, t_j), t_i the largest id of sketch i
(its bottom-s threshold). Below t both sketches are complete samples of
their genomes, so

    j_est = |S_i ∩ S_j| / (|S_i <= t| + |S_j <= t| - |S_i ∩ S_j|)

is an unbiased Jaccard estimate. It differs from the sort estimator
(ops/mash.py) only in which unbiased sample it conditions on.

The [N, N] intersection counts are the vocabulary-chunked indicator
product of the secondary's chunked route (ops/containment.py::
intersections_chunked: one ``csrc/indicator_mm.cu`` launch a vocabulary
chunk of the packed dense ranks, added into one accumulator on the
device), with the rows padded to the kernel's 128-row tile rather than
the secondary's pow2 bucket. The below-threshold counts need no product:
rows are sorted, so one host ``searchsorted`` a row gives them
(:func:`_below_counts`), and the Jaccard and distance are elementwise
host math (:func:`_jaccard_host`), both copied from the JAX package, so
``dist`` and ``jac`` are its values bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from drep_tpu_torch.ops.containment import intersections_chunked
from drep_tpu_torch.ops.minhash import PackedSketches, mash_distance_from_jaccard

# rows of the intersection product are padded to a multiple of the
# kernel's output tile (csrc/mm_block.cuh TM): the secondary's pow2 bucket
# would give 16 384 rows at 10 000 genomes, ~2.6x the upper tiles
ROW_PAD = 128

# seconds of the parts of the last all_vs_all_mash_matmul call
STAGE_SECONDS: dict[str, float] = {}


def _below_counts(ids: np.ndarray, counts: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """below[i, j] = |S_i <= t_j|, exact, by one searchsorted a sorted row."""
    n = ids.shape[0]
    below = np.empty((n, n), np.float32)
    for i in range(n):
        below[i] = np.searchsorted(ids[i, : counts[i]], thresholds, side="right")
    return below


def _jaccard_host(inter: np.ndarray, below: np.ndarray, counts: np.ndarray, t: np.ndarray, k: int):
    """Common-threshold Jaccard and Mash distance on the host. u is the
    union restricted to t_min = min(t_i, t_j): the side with the larger
    threshold is a complete sample below t_min, the other contributes its
    below-threshold count."""
    nf = counts.astype(np.float32)
    inter = inter.astype(np.float32)
    t_i = t[:, None]
    t_j = t[None, :]
    u = np.where(
        t_j < t_i,
        below + nf[None, :] - inter,
        nf[:, None] + below.T - inter,
    )
    j = np.where(u > 0, inter / np.maximum(u, 1.0), 0.0).astype(np.float32)
    dist = mash_distance_from_jaccard(j, k).astype(np.float32)
    return dist, j


def all_vs_all_mash_matmul(packed: PackedSketches, k: int, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Full [N, N] (dist, jaccard) by the common-threshold estimator, the
    intersection counts on `device`."""
    n = packed.n
    if n == 0:
        return np.zeros((0, 0), np.float32), np.zeros((0, 0), np.float32)
    ids, counts = packed.ids, packed.counts
    if int(counts.max()) == 0:
        # all sketches empty: maximal distance everywhere (as the sort
        # estimator gives), identity on the diagonal
        dist = np.ones((n, n), np.float32)
        jac = np.zeros((n, n), np.float32)
        np.fill_diagonal(dist, 0.0)
        np.fill_diagonal(jac, 1.0)
        return dist, jac
    # each genome's bottom-s threshold: the largest id of its row
    t = np.where(counts > 0, ids[np.arange(n), np.maximum(counts - 1, 0)], np.int32(-1)).astype(np.int32)
    t0 = time.perf_counter()
    inter = intersections_chunked(packed, device, m_pad=-(-n // ROW_PAD) * ROW_PAD)
    t1 = time.perf_counter()
    below = _below_counts(ids, counts, t)
    t2 = time.perf_counter()
    dist, jac = _jaccard_host(inter, below, counts, t, k=k)
    np.fill_diagonal(dist, 0.0)
    np.fill_diagonal(jac, 1.0)
    STAGE_SECONDS.update(intersections=t1 - t0, below_counts=t2 - t1, jaccard=time.perf_counter() - t2)
    return dist, jac
