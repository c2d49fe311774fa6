"""Built-in comparison engines registered with the dispatch.

Counterpart of drep_tpu/cluster/engines.py. The engine names stay
`jax_mash` and `jax_ani` so argv and Cdb's `comparison_algorithm` column
are identical to the JAX package's; here they run the CUDA kernels
(ops/mash.py, ops/indicator.py) on the run's device.

- `jax_mash`: the exact union-bottom-s Mash estimator over the upper
  triangle of pair tiles, host-mirrored. `auto` resolves to it (the sort
  estimator), as on a TPU; the MXU-style `matmul` estimator is not ported.
- `jax_ani`: the one-shot indicator matmul, per cluster or batched over
  many small clusters in cluster-local id spaces. A cluster past the
  one-shot budget raises; it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from drep_tpu_torch.cluster.dispatch import (
    register_primary,
    register_secondary,
    register_secondary_batched,
)
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.ops.containment import (
    all_vs_all_containment_matmul,
    matmul_vocab_pad,
    matmul_vocab_pad_extent,
    one_shot_fits,
    pack_scaled_sketches,
    pack_scaled_sketches_clusterlocal,
)
from drep_tpu_torch.ops.mash import all_vs_all_mash
from drep_tpu_torch.ops.minhash import pack_sketches

MATMUL_ESTIMATOR_TODO = (
    "--primary_estimator matmul (the common-threshold MinHash estimator, "
    "drep_tpu/ops/minhash_matmul.py) is not ported yet: ROADMAP.md queue 1, "
    "item 9 (other primary and secondary options)"
)
BEYOND_BUDGET_TODO = (
    "is past the one-shot indicator budget; the vocabulary-chunked matmul and the "
    "merge-intersect kernel (pallas_merge) are not ported yet: ROADMAP.md queue 1, "
    "item 7 and queue 2, kernel 3"
)


def resolve_primary_estimator(estimator: str) -> str:
    """The concrete estimator the dense primary runs: `auto` and `sort`
    are the union-bottom-s sort estimator; `matmul` raises."""
    if estimator not in ("auto", "sort", "matmul"):
        raise ValueError(f"unknown mash estimator {estimator!r}")
    if estimator == "matmul":
        raise NotImplementedError(MATMUL_ESTIMATOR_TODO)
    return "sort"


@register_primary("jax_mash")
def primary_jax_mash(
    gs: GenomeSketches,
    device: torch.device,
    primary_estimator: str = "auto",
    **_,
) -> tuple[np.ndarray, np.ndarray]:
    """All-vs-all Mash distance from bottom-k sketches on `device`.

    Returns (dist [N,N], similarity [N,N]), similarity = 1 - dist.
    """
    resolve_primary_estimator(primary_estimator)
    packed = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    dist, _jac = all_vs_all_mash(packed, k=gs.k, device=device)
    return dist, 1.0 - dist


# how many calls each secondary path served this process (one_shot,
# one_shot_clusterlocal) — a run diffs it to show which route it took
SECONDARY_PATH_COUNTS: dict[str, int] = {}


def _count_path(path: str) -> None:
    SECONDARY_PATH_COUNTS[path] = SECONDARY_PATH_COUNTS.get(path, 0) + 1


def containment_matrices(packed, k: int, device: torch.device):
    """(symmetric max-containment ani, directional cov) through the
    one-shot indicator matmul; a pack past its budget raises."""
    v_pad = matmul_vocab_pad(packed)
    if not one_shot_fits(packed.n, v_pad):
        raise NotImplementedError(
            f"a secondary cluster of {packed.n} genomes over a {v_pad}-id vocabulary "
            + BEYOND_BUDGET_TODO
        )
    _count_path("one_shot")
    return all_vs_all_containment_matmul(packed, k=k, device=device, v_pad=v_pad)


@register_secondary("jax_ani")
def secondary_jax_ani(
    gs: GenomeSketches,
    indices: list[int],
    device: torch.device,
    **_,
) -> tuple[np.ndarray, np.ndarray]:
    """(symmetric max-containment ani, directional cov) for a genome
    subset, [m, m] in `indices` order."""
    sketches = [gs.scaled[i] for i in indices]
    names = [gs.names[i] for i in indices]
    packed = pack_scaled_sketches(sketches, names)
    return containment_matrices(packed, gs.k, device)


@register_secondary_batched("jax_ani")
def secondary_jax_ani_batched(
    gs: GenomeSketches,
    clusters: list[list[int]],
    device: torch.device,
    **_,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """One device call for MANY small primary clusters: a cluster-local
    pack (every cluster ranked into its own vocabulary) and one one-shot
    indicator matmul; each cluster reads its diagonal block. When even the
    widest cluster vocabulary is past the one-shot budget the batch takes
    the shared-vocabulary pack through :func:`containment_matrices`."""
    flat = [i for cl in clusters for i in cl]
    names = [gs.names[i] for i in flat]
    packed_l, v_extent = pack_scaled_sketches_clusterlocal(
        [[gs.scaled[i] for i in cl] for cl in clusters], names
    )
    v_pad = matmul_vocab_pad_extent(v_extent)
    if one_shot_fits(packed_l.n, v_pad):
        _count_path("one_shot_clusterlocal")
        ani_all, cov_all = all_vs_all_containment_matmul(
            packed_l, k=gs.k, device=device, v_pad=v_pad
        )
    else:
        packed = pack_scaled_sketches([gs.scaled[i] for i in flat], names)
        ani_all, cov_all = containment_matrices(packed, gs.k, device)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    o = 0
    for cl in clusters:
        m = len(cl)
        out.append((ani_all[o : o + m, o : o + m], cov_all[o : o + m, o : o + m]))
        o += m
    return out
