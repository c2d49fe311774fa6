"""Merge steps and bytes of the Mash shared-count kernel, and the peaks
they are set against.

Copies of chip_smoke.py's bound arithmetic (``mash_ops``,
``mash_grid_cost``, ``HBM_BYTES_PER_S``, ``SCALAR_OPS_PER_S``), kept here
so that the yardstick does not move with the program. A pair's merge walk
advances through its s_use distinct ids plus its duplicates among them,
so it needs s_use + shared steps; a step is an int32 compare-and-advance,
set against the H100's CUDA-core float32 rate (the data sheet lists no
int32 issue rate, and 67 T counts an FMA as two operations, so a share
against it reads low and never above 100%). Bytes: the ids and counts read
once and one int32 count a pair written once.

:func:`dense_job_cost` counts these over every pair a dense job decides,
from the inputs, never from the tiles an implementation launches.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet; full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TILE = 128


def mash_ops(shared: np.ndarray, na: np.ndarray, nb: np.ndarray, s_orig: int) -> int:
    """Merge steps the pair walks need on this data: each pair advances
    through s_use distinct ids plus its duplicates among them."""
    s_use = np.minimum(np.minimum(na[:, None], nb[None, :]), s_orig).astype(np.int64)
    return int(s_use.sum() + shared.astype(np.int64).sum())


def mash_grid_cost(shared: np.ndarray, counts: np.ndarray, width: int) -> tuple[int, int]:
    """(merge steps, bytes) of the symmetric Mash grid over [n, n] shared
    counts: the steps of every pair of the tiles the wrapped grid computes
    (rows padded to TILE multiples with count 0 need none); the ids and
    counts read once, the wrapped output written once."""
    n = shared.shape[0]
    t = -(-n // TILE)
    steps = 0
    for i in range(t):
        ri = slice(i * TILE, (i + 1) * TILE)
        for jj in range(t // 2 + 1):
            j = (i + jj) % t
            rj = slice(j * TILE, (j + 1) * TILE)
            steps += mash_ops(shared[ri, rj], counts[ri], counts[rj], width)
    rows = t * TILE
    return steps, rows * width * 4 + rows * 4 + rows * (t // 2 + 1) * TILE * 4


def sum_pair_min(counts: np.ndarray, cap: int) -> int:
    """sum over pairs i < j of min(counts[i], counts[j], cap): each count,
    taken in ascending order, is the smaller one of its pairs with every
    count after it."""
    c = np.sort(np.minimum(counts.astype(np.int64), cap))
    n = c.shape[0]
    return int((c * (n - 1 - np.arange(n, dtype=np.int64))).sum())


def dense_job_cost(counts: np.ndarray, width: int, shared_sum: int) -> tuple[int, int]:
    """(merge steps, bytes) of one dense job over n genomes: every pair
    i < j decided once. `shared_sum` is the shared counts summed over all
    pairs (the reference's)."""
    n = counts.shape[0]
    steps = sum_pair_min(counts, width) + int(shared_sum)
    pairs = n * (n - 1) // 2
    return steps, n * width * 4 + n * 4 + pairs * 4


def bound_seconds(steps: int, nbytes: int) -> tuple[float, str]:
    """(the least time the chip could take, what bounds it)."""
    t_ops, t_bytes = steps / SCALAR_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
