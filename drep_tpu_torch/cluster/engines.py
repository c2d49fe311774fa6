"""Built-in comparison engines registered with the dispatch.

Counterpart of drep_tpu/cluster/engines.py. The engine names stay
`jax_mash` and `jax_ani` so argv and Cdb's `comparison_algorithm` column
are identical to the JAX package's; here they run the CUDA kernels
(ops/mash.py, ops/indicator.py) on the run's device.

- `jax_mash`: the exact union-bottom-s Mash estimator over the upper
  triangle of pair tiles, host-mirrored. `auto` resolves to it (the sort
  estimator), as on a TPU; `--primary_estimator matmul` runs the
  common-threshold estimator (ops/minhash_matmul.py) on one device.
- `jax_ani`: the one-shot indicator matmul, per cluster or batched over
  many small clusters in cluster-local id spaces. A cluster past the
  one-shot budget takes the mesh ring when the run has one, else one of
  the JAX package's two single-chip routes, by the same rule: the
  merge-intersect kernel over id-range buckets (ops/intersect.py,
  `pallas_range`) or the vocabulary-chunked indicator matmul
  (`matmul_chunked`). On the CPU the same routing runs the plain
  versions; no route falls back to another.

A run with a mesh of D > 1 positions (`--mesh_shape D`; None is one
position per card) and at least MESH_MIN_GENOMES genomes runs the dense
primary, and every past-budget secondary cluster of that size, over the
ring (parallel/allpairs.py). On a pod the primary's ring spans the
members and the secondary's stays on each member's own positions,
replicated (:func:`_mesh_or_none`).
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
    all_vs_all_containment_matmul_chunked,
    matmul_vocab_pad,
    matmul_vocab_pad_extent,
    one_shot_fits,
    pack_scaled_sketches,
    pack_scaled_sketches_clusterlocal,
)
from drep_tpu_torch.ops.intersect import all_vs_all_containment_merge
from drep_tpu_torch.ops.mash import all_vs_all_mash
from drep_tpu_torch.ops.minhash_matmul import all_vs_all_mash_matmul
from drep_tpu_torch.ops.minhash import next_pow2, pack_sketches
from drep_tpu_torch.parallel.allpairs import sharded_containment_allpairs, sharded_mash_allpairs
from drep_tpu_torch.parallel.mesh import Mesh, make_mesh
from drep_tpu_torch.utils.logger import get_logger

# below this many genomes a multi-position ring costs more in steps and
# padding than it saves in compute
MESH_MIN_GENOMES = 64


def _mesh_or_none(mesh_shape: int | None, n: int, device: torch.device, local_only: bool = False) -> Mesh | None:
    """The ring's mesh for `n` genomes, or None for the single-device
    path: `mesh_shape` positions (None: one per card) when there are at
    least two and n >= MESH_MIN_GENOMES.

    On a pod the mesh spans the members, except in the two local regimes
    of the JAX package, where it is this member's share of the positions
    (parallel/mesh.py::make_local_mesh): a pod that lost a member (a mesh
    over the dead member's positions would wait on it), and `local_only`
    calls — the secondary engines', whose launches must stay process-local
    so that a failed batch retries on its member alone
    (faulttol.retrying_call). The work then runs replicated on every
    member, with the same numbers."""
    from drep_tpu_torch.parallel.faulttol import pod_live
    from drep_tpu_torch.parallel.mesh import make_local_mesh, process_count

    pc = process_count()
    if pc > 1 and (local_only or pod_live() is not None):
        mesh = make_local_mesh(device, None if mesh_shape is None else max(1, int(mesh_shape) // pc))
    else:
        mesh = make_mesh(mesh_shape, device)
    if mesh.size > 1 and n >= MESH_MIN_GENOMES:
        return mesh
    return None


def resolve_primary_estimator(
    n: int, mesh_shape: int | None, estimator: str, device: torch.device
) -> str:
    """The concrete estimator the dense primary runs for `n` genomes:
    `ring_sort` on a mesh (whatever the request), else `matmul` where it is
    asked for, and the union-bottom-s `sort` estimator for `auto` and
    `sort` (as the JAX package resolves `auto` on a TPU)."""
    if estimator not in ("auto", "sort", "matmul"):
        raise ValueError(f"unknown mash estimator {estimator!r}")
    if _mesh_or_none(mesh_shape, n, device) is not None:
        return "ring_sort"
    return "matmul" if estimator == "matmul" else "sort"


def mash_distance_matrix(
    packed, k: int, device: torch.device, mesh_shape: int | None = None, estimator: str = "auto"
) -> np.ndarray:
    """[N, N] Mash distance: over the ring on a mesh, else on `device` by
    the estimator asked for (the sort estimator's wrapped symmetric grid,
    or the matmul estimator's chunked intersection product). The ring
    computes the sort estimator, so it serves `auto` and `sort`; `matmul`
    on a mesh warns and rides it."""
    resolved = resolve_primary_estimator(packed.n, mesh_shape, estimator, device)
    if resolved == "ring_sort":
        mesh = _mesh_or_none(mesh_shape, packed.n, device)
        if estimator == "matmul":
            get_logger().warning(
                "primary_estimator='matmul' is single-chip only — using the "
                "mesh ring (sort estimator) to honor the %d-position mesh",
                mesh.size,
            )
        return sharded_mash_allpairs(packed, k=k, mesh=mesh)
    if resolved == "matmul":
        dist, _jac = all_vs_all_mash_matmul(packed, k=k, device=device)
    else:
        dist, _jac = all_vs_all_mash(packed, k=k, device=device)
    return dist


@register_primary("jax_mash")
def primary_jax_mash(
    gs: GenomeSketches,
    device: torch.device,
    primary_estimator: str = "auto",
    mesh_shape: int | None = None,
    **_,
) -> tuple[np.ndarray, np.ndarray]:
    """All-vs-all Mash distance from bottom-k sketches on `device`.

    Returns (dist [N,N], similarity [N,N]), similarity = 1 - dist.
    """
    packed = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    dist = mash_distance_matrix(packed, gs.k, device, mesh_shape=mesh_shape, estimator=primary_estimator)
    return dist, 1.0 - dist


# Per-element cost of the merge relative to the int8 indicator matmul: a
# beyond-budget cluster weighs merge work (2*s2*log2(2*s2) units a pair)
# against chunked-matmul work (v_pad columns a pair), the merge side times
# this penalty. The value is the JAX package's (drep_tpu/cluster/
# engines.py:203), fitted on a TPU v5e; it is kept so the port routes every
# cluster as the JAX package does on a TPU. Re-fitting it on the H100 waits
# for the port's bench.
MERGE_VS_MATMUL_ELEM_COST = 47.0


def beyond_budget_secondary_path(sketch_width: int, v_pad: int) -> str:
    """Which route owns a cluster past the one-shot budget: `pallas_range`
    (the merge kernel, cost per pair independent of the vocabulary) when
    the vocabulary outgrows the penalised merge work, else
    `matmul_chunked`."""
    s2 = max(128, next_pow2(sketch_width))
    merge_units = 2 * s2 * ((2 * s2).bit_length() - 1)
    if MERGE_VS_MATMUL_ELEM_COST * merge_units < v_pad:
        return "pallas_range"
    return "matmul_chunked"


# how many calls each secondary path served this process (one_shot,
# one_shot_clusterlocal, mesh_ring, pallas_range, matmul_chunked: the JAX
# package's names) — a run diffs it to show which route it took
SECONDARY_PATH_COUNTS: dict[str, int] = {}


def _count_path(path: str) -> None:
    SECONDARY_PATH_COUNTS[path] = SECONDARY_PATH_COUNTS.get(path, 0) + 1


def containment_matrices(packed, k: int, device: torch.device, mesh_shape: int | None = None):
    """(symmetric max-containment ani, directional cov): the one-shot
    indicator matmul when the pack fits its budget, else the mesh ring
    when the run has one (on a pod, this member's positions:
    :func:`_mesh_or_none`), else the route that
    :func:`beyond_budget_secondary_path` picks."""
    v_pad = matmul_vocab_pad(packed)
    if one_shot_fits(packed.n, v_pad):
        _count_path("one_shot")
        return all_vs_all_containment_matmul(packed, k=k, device=device, v_pad=v_pad)
    mesh = _mesh_or_none(mesh_shape, packed.n, device, local_only=True)
    if mesh is not None:
        _count_path("mesh_ring")
        return sharded_containment_allpairs(packed, k=k, mesh=mesh)
    path = beyond_budget_secondary_path(packed.sketch_size, v_pad)
    _count_path(path)
    if path == "pallas_range":
        return all_vs_all_containment_merge(packed, k=k, device=device)
    return all_vs_all_containment_matmul_chunked(packed, k=k, device=device)


@register_secondary("jax_ani")
def secondary_jax_ani(
    gs: GenomeSketches,
    indices: list[int],
    device: torch.device,
    mesh_shape: int | None = None,
    **_,
) -> tuple[np.ndarray, np.ndarray]:
    """(symmetric max-containment ani, directional cov) for a genome
    subset, [m, m] in `indices` order."""
    sketches = [gs.scaled[i] for i in indices]
    names = [gs.names[i] for i in indices]
    packed = pack_scaled_sketches(sketches, names)
    return containment_matrices(packed, gs.k, device, mesh_shape=mesh_shape)


@register_secondary_batched("jax_ani")
def secondary_jax_ani_batched(
    gs: GenomeSketches,
    clusters: list[list[int]],
    device: torch.device,
    mesh_shape: int | None = None,
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
        ani_all, cov_all = containment_matrices(packed, gs.k, device, mesh_shape=mesh_shape)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    o = 0
    for cl in clusters:
        m = len(cl)
        out.append((ani_all[o : o + m, o : o + m], cov_all[o : o + m, o : o + m]))
        o += m
    return out


# the subprocess engines register themselves on import (the JAX package's
# registry holds all eight names once its engines module is loaded)
from drep_tpu_torch.cluster import anim as _anim  # noqa: E402,F401
from drep_tpu_torch.cluster import external as _external  # noqa: E402,F401
