"""Cluster-stage orchestration: Bdb -> Mdb -> Ndb -> Cdb.

Counterpart of drep_tpu/cluster/controller.py (one device, or a mesh
ring of --mesh_shape positions, on one process or a pod):

- resume: if the workdir already holds Cdb and the stored cluster
  arguments match, skip recompute entirely (with the JAX package's
  warning where the primary estimator would now resolve otherwise);
- PRIMARY: all-vs-all Mash distance (ops/mash.py kernel, the
  --primary_estimator matmul estimator of ops/minhash_matmul.py, or the
  ring of parallel/allpairs.py on a mesh) -> hierarchical clustering at
  1-P_ani -> integer primary clusters (Mdb: dense for small N,
  thresholded beyond `mdb_dense_limit`); with
  --multiround_primary_clustering above --primary_chunksize, the chunked
  two-round primary of cluster/multiround.py (no Mdb); at n >=
  --streaming_threshold or with --streaming_primary, the streaming
  primary (parallel/streaming.py: the Mash kernel stripe by stripe, shard
  checkpoints under ``data/streaming_primary``, --primary_prune lsh,
  sparse UPGMA or connected components; a sparse Mdb of the retained
  edges);
- SECONDARY: per primary cluster with >1 member, containment ANI through
  the one-shot indicator matmul (small clusters batched into one call),
  or past its budget the mesh ring, the merge kernel or the chunked
  matmul (engines) -> coverage-gated hierarchical clustering at 1-S_ani
  -> "P_S" ids (Ndb); one cluster alone through :func:`secondary_for_cluster`
  (the genome index's re-run of a dirty cluster); with
  --greedy_secondary_clustering, the greedy
  assignment instead (cluster/greedy.py: small clusters over the batched
  call's matrices, larger ones block by block on the rectangular
  indicator product);
- with --run_tertiary_clustering, cross-primary merges of the secondary
  clusters' representatives (cluster/tertiary.py);
- Cdb assembly and ``data/Clustering_files/clustering.pickle``.

Failures, as in the JAX package: ingest publishes sketch
shards as it goes (ingest.py); each primary cluster's secondary result is
checkpointed the moment it finishes (cluster/secondary_ckpt.py), so a
rerun of a killed run resumes at the first unfinished cluster; each
secondary engine call (a cluster, or a batch of small ones) runs under
``retrying_call``, as does each streaming stripe (parallel/faulttol.py:
--fault_retries, --dispatch_timeout), and the
run's durable-I/O policy is --io_retries and --fsync. Spent retries raise
FaultTolError: nothing recomputes on the CPU. With the device cuda and
sketching to do, the kernels build and the CUDA context starts on a
thread while ingest runs (--no_overlap_ingest turns it off). The dense
ring publishes its blocks under ``data/dense_ring`` (parallel/allpairs.py:
a rerun resumes them, a failed step's blocks are recomputed one by one).

On a pod (``python -m drep_tpu_torch`` launched as N processes,
parallel/mesh.py) every member runs this same control flow: ingest is
sharded across the members, the streaming primary deals its stripes and
the dense primary's ring spans the members, both elastic
(--max_dead_processes deaths tolerated, --max_joins admissions, a drain
on SIGTERM within --drain_grace_s; parallel/faulttol.py), and the
secondary runs replicated on each member's own positions, so its calls
retry on that member alone. Every member writes the same tables.

The subprocess engines (cluster/external.py, cluster/anim.py) run
exactly where the JAX package runs them: ``--primary_algorithm mash`` on
the dense primary branch, ``--S_algorithm fastANI|ANImf|ANIn|gANI|goANI``
for every secondary call (the tertiary's too) unless --SkipSecondary.
Their calls go through the same ``retrying_call`` and checkpoints as
``jax_ani``'s; a failed binary is retried, spent retries raise
FaultTolError, and a rerun resumes the finished clusters.

Stage accounting, as in the JAX package: ``ingest_or_cache``,
``primary_compare`` (pairs and seconds), ``secondary_compare`` a call,
``secondary_postprocess`` a batch and ``assembly_io`` go to
utils/profiling.py's counters (``perf_counters.json``), each a
``stage:<name>`` span when tracing is on; the secondary loop is bracketed
by ``stage_open`` / ``stage_close`` instants.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any

import numpy as np
import pandas as pd
import torch

from drep_tpu_torch import schemas
from drep_tpu_torch.cluster import dispatch, engines, pairs
from drep_tpu_torch.cluster.greedy import greedy_assign_from_matrices, greedy_secondary_cluster
from drep_tpu_torch.cluster.multiround import multiround_primary_clustering
from drep_tpu_torch.cluster.tertiary import run_tertiary_clustering
from drep_tpu_torch.device import resolve_device
from drep_tpu_torch.cluster.secondary_ckpt import SecondaryCheckpoint
from drep_tpu_torch.ingest import (
    DEFAULT_SCALE,
    DEFAULT_SKETCH_SIZE,
    GenomeSketches,
    sketch_cache_will_hit,
    sketch_genomes,
)
from drep_tpu_torch.ops.kmers import DEFAULT_K
from drep_tpu_torch.ops.linkage import cluster_hierarchical, single_linkage_device
from drep_tpu_torch.parallel.faulttol import (
    FaultTolConfig,
    configure_defaults,
    install_drain_handler,
    pod_dead,
    pod_epoch,
    pod_live,
    retrying_call,
)
from drep_tpu_torch.utils import durableio, telemetry
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters
from drep_tpu_torch.workdir import WorkDirectory

CLUSTER_DEFAULTS: dict[str, Any] = {
    "P_ani": 0.9,
    "S_ani": 0.95,
    "cov_thresh": 0.1,
    "clusterAlg": "average",
    "primary_algorithm": "jax_mash",
    "S_algorithm": "jax_ani",
    "MASH_sketch": DEFAULT_SKETCH_SIZE,
    "scale": DEFAULT_SCALE,
    "kmer_size": DEFAULT_K,
    "hash": "splitmix64",
    "processes": 1,
    "SkipMash": False,
    "SkipSecondary": False,
    "greedy_secondary_clustering": False,
    "run_tertiary_clustering": False,
    "multiround_primary_clustering": False,
    "primary_chunksize": 5000,
    "mdb_dense_limit": 2000,
    "mesh_shape": None,
    "primary_estimator": "auto",
    "streaming_primary": False,
    "streaming_block": 1024,
    "streaming_threshold": 30_000,
    "primary_prune": "off",
    "prune_bands": 0,
    "prune_min_shared": 0,
    "prune_join_chunk": 0,
    # how failures are survived, never what is computed: none of these is
    # a _RESUME_KEY (parallel/faulttol.py, utils/durableio.py)
    "overlap_ingest": True,
    "fault_retries": 2,
    "dispatch_timeout": 0.0,
    "io_retries": None,
    "fsync": False,
    "max_dead_processes": 1,
    "max_joins": 0,
    "drain_grace_s": 30.0,
}

_RESUME_KEYS = [
    "P_ani",
    "S_ani",
    "cov_thresh",
    "clusterAlg",
    "primary_algorithm",
    "primary_estimator",
    "S_algorithm",
    "MASH_sketch",
    "scale",
    "kmer_size",
    "hash",
    "SkipMash",
    "SkipSecondary",
    "greedy_secondary_clustering",
    "run_tertiary_clustering",
    "streaming_primary",
    "streaming_threshold",
    "warn_dist",
    "genomes",
]

# batching of small clusters: one device call replaces hundreds of
# latency-bound round trips (most primary clusters are tiny at scale)
SMALL_CLUSTER_MAX = 32
BATCH_ROWS_MAX = 512

# wall-clock seconds of each stage of the last d_cluster_wrapper run
STAGE_SECONDS: dict[str, float] = {}
# genome pairs each compare stage of the last run compared (the JAX
# package's counters: the greedy secondary counts its Ndb rows, the
# comparisons its scan made, on both its routes)
STAGE_PAIRS: dict[str, int] = {}
# multi-member primary clusters of the last run's secondary stage, and
# how many of them it resumed from the checkpoint store
SECONDARY_RESUMED: dict[str, int] = {}


def _fill_defaults(kwargs: dict[str, Any]) -> dict[str, Any]:
    out = dict(CLUSTER_DEFAULTS)
    out.update({k: v for k, v in kwargs.items() if v is not None})
    return out


def _streams(kw: dict[str, Any], n: int) -> bool:
    """Does the primary of `n` genomes take the streaming path (the JAX
    package's switch: --streaming_primary, or jax_mash at n >=
    --streaming_threshold)?"""
    return kw["streaming_primary"] or (kw["primary_algorithm"] == "jax_mash" and n >= kw["streaming_threshold"])


def _multiround(kw: dict[str, Any], n: int) -> bool:
    """Does the primary of `n` genomes take the multiround path (the JAX
    package's branch: --multiround_primary_clustering above
    --primary_chunksize, ahead of streaming)?"""
    return kw["multiround_primary_clustering"] and n > kw["primary_chunksize"]


def _warn_dist(kw: dict[str, Any]) -> float:
    """warn_dist for sparse-Mdb retention — the evaluate stage's default,
    honoring an explicit 0.0 (warnings disabled)."""
    from drep_tpu_torch.evaluate import EVALUATE_DEFAULTS

    v = kw.get("warn_dist")
    return EVALUATE_DEFAULTS["warn_dist"] if v is None else float(v)


def _ft_config(kw: dict[str, Any]) -> FaultTolConfig:
    """The fault-tolerance flags -> the retry config, installed as the
    process default too (workflows.py's front door installs the durable-I/O
    flags). --dispatch_timeout 0 derives the streaming stripes' watchdog
    from the run's own launch latencies, a positive value bounds every
    watched launch, a negative one turns the watchdog off."""
    timeout = float(kw["dispatch_timeout"])
    cfg = FaultTolConfig(
        max_retries=int(kw["fault_retries"]),
        dispatch_timeout_s=max(0.0, timeout),
        auto_timeout=timeout == 0.0,
        max_dead_processes=int(kw["max_dead_processes"]),
        max_joins=int(kw["max_joins"]),
    )
    configure_defaults(cfg)
    # SIGTERM -> a planned departure at the next stripe or ring-step
    # boundary, a forced exit 0 past the grace (library embeddings off the
    # main thread keep their own signal policy)
    install_drain_handler(float(kw["drain_grace_s"]))
    return cfg


class _KernelWarmup:
    """Builds the CUDA kernels (``ops/_build.py::build_all``) and starts
    the CUDA context on a thread while ingest sketches on the host. The
    caller joins it whatever ingest did, then calls :meth:`raise_error`:
    a failed build is raised, never swallowed."""

    def __init__(self, device: torch.device) -> None:
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(device,), name="drep-kernel-warmup")
        self._thread.start()

    def _run(self, device: torch.device) -> None:
        try:
            from drep_tpu_torch.ops import _build

            _build.build_all()
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
        except BaseException as e:  # noqa: BLE001 — raised by the caller after the join
            self.error = e

    def join(self) -> None:
        self._thread.join()
        if self.error is not None:
            get_logger().error("kernel warmup failed: %r", self.error)

    def raise_error(self) -> None:
        if self.error is not None:
            raise self.error


def _start_kernel_warmup(kw: dict[str, Any], wd: WorkDirectory, bdb: pd.DataFrame) -> _KernelWarmup | None:
    """The warmup thread, where the device is cuda, --no_overlap_ingest is
    not given and ingest will sketch (no cache or shard store covers the
    genomes: otherwise there is nothing to hide the build behind)."""
    if kw["device"].type != "cuda" or not kw["overlap_ingest"]:
        return None
    if sketch_cache_will_hit(wd, bdb["genome"], kw["kmer_size"], kw["MASH_sketch"], kw["scale"], kw["hash"]):
        return None
    return _KernelWarmup(kw["device"])


def _mdb_from_dist(
    dist: np.ndarray, names: list[str], dense_limit: int, p_ani: float, warn_dist: float
) -> pd.DataFrame:
    """Pair table from the distance matrix. Dense (all N^2 ordered pairs,
    reference-style) for small N; thresholded sparse beyond `dense_limit`,
    keeping pairs up to max(1-P_ani, warn_dist) so the evaluate stage still
    sees near-threshold winner pairs."""
    n = len(names)
    if n <= dense_limit:
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ii, jj = ii.ravel(), jj.ravel()
    else:
        keep = dist <= max(1.0 - p_ani, warn_dist)
        np.fill_diagonal(keep, True)
        ii, jj = np.nonzero(keep)
    d = dist[ii, jj]
    arr = np.array(names)
    return pd.DataFrame(
        {"genome1": arr[ii], "genome2": arr[jj], "dist": d, "similarity": 1.0 - d}
    )


def _streaming_mdb(edges, names: list[str]) -> pd.DataFrame:
    """Sparse Mdb from thresholded streaming edges: both directions plus the
    diagonal, matching the thresholded branch of `_mdb_from_dist`."""
    ii, jj, dd = edges
    n = len(names)
    arr = np.array(names)
    g1 = np.concatenate([arr[ii], arr[jj], arr])
    g2 = np.concatenate([arr[jj], arr[ii], arr])
    d = np.concatenate([dd, dd, np.zeros(n, np.float32)])
    return pd.DataFrame({"genome1": g1, "genome2": g2, "dist": d, "similarity": 1.0 - d})


def _resolve_estimator_for_run(n: int, kw: dict[str, Any]) -> str:
    """The estimator the run will use, in `_primary_clusters`' branch
    order (SkipMash, multiround, streaming, the dense engine): multiround
    resolves a chunk's, and the streaming primary always runs the sort
    estimator's tiles."""
    if kw["SkipMash"] or n == 1:
        return "skipmash"
    if _multiround(kw, n):
        per_chunk = engines.resolve_primary_estimator(
            min(n, kw["primary_chunksize"]), kw["mesh_shape"], kw["primary_estimator"], kw["device"]
        )
        return f"multiround_{per_chunk}"
    if _streams(kw, n):
        return "streaming_sort"
    return engines.resolve_primary_estimator(n, kw["mesh_shape"], kw["primary_estimator"], kw["device"])


def _streaming_primary(
    gs: GenomeSketches, kw: dict[str, Any], wd: WorkDirectory, ft_cfg: FaultTolConfig
) -> tuple[np.ndarray, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The streaming primary of the JAX package's branch: (labels, edges)."""
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.parallel import streaming

    logger = get_logger()
    n = len(gs.names)
    if not kw["streaming_primary"]:
        logger.warning(
            "%d genomes >= --streaming_threshold %d: primary stage auto-switches "
            "to the out-of-core streaming path (pass --streaming_primary to opt "
            "in explicitly, or raise the threshold to keep the dense path)",
            n, kw["streaming_threshold"],
        )
    if kw["primary_estimator"] not in ("auto", "sort"):
        logger.warning(
            "streaming primary always uses the sort (union-bottom-s) tile "
            "estimator; --primary_estimator %s is ignored on this path",
            kw["primary_estimator"],
        )
    t0 = time.perf_counter()
    packed = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    t1 = time.perf_counter()
    labels, edges, STAGE_PAIRS["primary_compare"] = streaming.streaming_primary_clusters(
        packed,
        gs.k,
        kw["P_ani"],
        block=kw["streaming_block"],
        checkpoint_dir=wd.get_dir(os.path.join("data", "streaming_primary")),
        keep_dist=_warn_dist(kw),
        cluster_alg=kw["clusterAlg"],
        primary_prune=kw["primary_prune"],
        prune_bands=kw["prune_bands"],
        prune_min_shared=kw["prune_min_shared"],
        prune_join_chunk=kw["prune_join_chunk"],
        device=kw["device"],
        ft_config=ft_cfg,
    )
    st = streaming.STATS
    STAGE_SECONDS.update(
        primary_pack=t1 - t0, primary_prune=st["prune_seconds"], primary_compare=st["seconds"],
        primary_linkage=st["linkage_seconds"],
    )
    return labels, edges


def _primary_clusters(
    gs: GenomeSketches, bdb: pd.DataFrame, kw: dict[str, Any], wd: WorkDirectory, ft_cfg: FaultTolConfig
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray, pd.DataFrame | None]:
    """Returns (labels 1..C, dist matrix or None, linkage, sparse Mdb of
    the streaming primary or None)."""
    n = len(gs.names)
    if kw["SkipMash"] or n == 1:
        # reference --SkipMash: everything lands in one primary cluster
        return np.ones(n, dtype=np.int64), np.zeros((n, n), np.float32), np.empty((0, 4)), None
    if _multiround(kw, n):
        t0 = time.perf_counter()
        labels, STAGE_PAIRS["primary_compare"] = multiround_primary_clustering(gs, bdb, kw)
        STAGE_SECONDS.update(primary_compare=time.perf_counter() - t0)
        return labels, None, np.empty((0, 4)), None
    if _streams(kw, n):
        labels, edges = _streaming_primary(gs, kw, wd, ft_cfg)
        return labels, None, np.empty((0, 4)), _streaming_mdb(edges, gs.names)
    if kw["primary_prune"] != "off":
        # the JAX package's warning: pruning exists only on the streaming schedule
        get_logger().warning(
            "--primary_prune %s only applies to the streaming primary "
            "(this run resolved to the dense path; lower "
            "--streaming_threshold or pass --streaming_primary) — ignored",
            kw["primary_prune"],
        )
    engine = dispatch.get_primary(kw["primary_algorithm"])
    t0 = time.perf_counter()
    dist, _sim = engine(
        gs, bdb=bdb, device=kw["device"], primary_estimator=kw["primary_estimator"],
        mesh_shape=kw["mesh_shape"],
    )
    t1 = time.perf_counter()
    STAGE_PAIRS["primary_compare"] = n * (n - 1) // 2
    cutoff = 1.0 - kw["P_ani"]
    if kw["clusterAlg"] == "single" and n > 64:
        labels = single_linkage_device(dist, cutoff, kw["device"])
        link = np.empty((0, 4))
    else:
        labels, link = cluster_hierarchical(dist, cutoff, method=kw["clusterAlg"])
    STAGE_SECONDS.update(primary_compare=t1 - t0, primary_linkage=time.perf_counter() - t1)
    return labels, dist, link, None


def _secondary_postprocess(
    gs: GenomeSketches,
    indices: list[int],
    pc: int,
    kw: dict[str, Any],
    ani: np.ndarray,
    cov: np.ndarray,
) -> tuple[pd.DataFrame, np.ndarray, np.ndarray]:
    """(ani, cov) for one primary cluster -> (Ndb rows, labels 1.., linkage)."""
    names = [gs.names[i] for i in indices]
    ndb = pairs.directional_ndb(names, ani, cov, pc)
    dist = 1.0 - pairs.gated_symmetric_ani(ani, cov, kw["cov_thresh"])
    labels, link = cluster_hierarchical(dist, 1.0 - kw["S_ani"], method=kw["clusterAlg"])
    return ndb, labels, link


def secondary_for_cluster(
    gs: GenomeSketches,
    bdb: pd.DataFrame,
    indices: list[int],
    pc: int,
    kw: dict[str, Any],
) -> tuple[pd.DataFrame, np.ndarray, np.ndarray]:
    """One primary cluster -> (Ndb rows, secondary labels 1.., linkage):
    the engine's per-cluster route (the one-shot indicator product, or
    past its budget the mesh ring, `pallas_range` or `matmul_chunked`, by
    the rule `_secondary_clusters` applies to a cluster it does not
    batch), then `_secondary_postprocess`. The genome index
    (index/update.py) re-runs the secondary through it for exactly the
    primary clusters an update touched, so a cluster's rows are those a
    from-scratch run gives the same members. `kw` needs S_algorithm,
    S_ani, cov_thresh, clusterAlg, processes, mesh_shape and device."""
    engine = dispatch.get_secondary(kw["S_algorithm"])
    ani, cov = engine(gs, indices, bdb=bdb, device=kw["device"], processes=kw["processes"],
                      mesh_shape=kw["mesh_shape"])
    return _secondary_postprocess(gs, indices, pc, kw, ani, cov)


def batch_small_clusters(small: list[tuple[int, list[int]]]) -> list[list[tuple[int, list[int]]]]:
    """The small clusters in row-bounded batches, in order: a batch closes
    before a cluster that would take it past BATCH_ROWS_MAX rows."""
    batches: list[list[tuple[int, list[int]]]] = []
    rows = BATCH_ROWS_MAX + 1  # force a new batch on the first item
    for item in small:
        if rows + len(item[1]) > BATCH_ROWS_MAX:
            batches.append([])
            rows = 0
        batches[-1].append(item)
        rows += len(item[1])
    return batches


def _secondary_clusters(
    gs: GenomeSketches,
    bdb: pd.DataFrame,
    primary: np.ndarray,
    kw: dict[str, Any],
    ckpt: SecondaryCheckpoint,
    ft_cfg: FaultTolConfig,
) -> tuple[dict[int, tuple[pd.DataFrame, np.ndarray, np.ndarray]], list[tuple[int, list[int]]], dict[str, str]]:
    """Secondary stage over every primary cluster: (results by primary
    cluster, multi-member clusters in order, names of singleton clusters).
    A cluster `ckpt` holds is resumed before any launch; every other
    cluster's result is handed to its writer as soon as its call returns,
    a batch's clusters together (``STAGE_SECONDS["checkpoint_write"]`` the
    writer's seconds, ``["checkpoint_wait"]`` this thread's waits on it),
    and each
    engine call (one large cluster, or one batch of small ones) runs under
    ``retrying_call`` at the ``secondary_batch`` fault site."""
    n_primary = int(primary.max()) if len(primary) else 0
    members: dict[int, list[int]] = {}
    for i, pc in enumerate(primary):
        members.setdefault(int(pc), []).append(i)
    singles: dict[str, str] = {}
    multi = []
    for pc in range(1, n_primary + 1):
        indices = members.get(pc, [])
        if len(indices) == 1:
            singles[gs.names[indices[0]]] = f"{pc}_1"
        elif indices:
            multi.append((pc, indices))

    greedy = kw["greedy_secondary_clustering"]
    # under greedy the batched route stays for small clusters, whose
    # assignment then runs on the batch's matrices; only for jax_ani, whose
    # containment numbers the greedy engine computes for the larger ones
    batched_fn = (
        dispatch.get_secondary_batched(kw["S_algorithm"]) if not greedy or kw["S_algorithm"] == "jax_ani" else None
    )
    results: dict[int, tuple[pd.DataFrame, np.ndarray, np.ndarray]] = {}
    small: list[tuple[int, list[int]]] = []
    pairs_done = 0
    try:
        if multi:
            ckpt.start()  # the writer processes start while the first clusters compute
        for pc, indices in multi:
            m = len(indices)
            cached = ckpt.load(pc)
            if cached is not None:
                results[pc] = cached  # resumed: no pairs counted
            elif batched_fn is not None and m <= SMALL_CLUSTER_MAX:
                small.append((pc, indices))  # one device call for many
            elif greedy:
                with counters.stage("secondary_compare"):
                    ndb, labels = greedy_secondary_cluster(gs, bdb, indices, pc, kw)
                counters.stages["secondary_compare"].pairs += len(ndb)
                pairs_done += len(ndb)  # the comparisons the greedy scan made
                results[pc] = (ndb, labels, np.empty((0, 4)))
                ckpt.save(pc, *results[pc])
            else:
                pairs_done += m * (m - 1) // 2
                with counters.stage("secondary_compare", pairs=m * (m - 1) // 2):
                    results[pc] = retrying_call(
                        lambda indices=indices, pc=pc: secondary_for_cluster(gs, bdb, indices, pc, kw),
                        site="secondary_batch", config=ft_cfg,
                    )
                ckpt.save(pc, *results[pc])

        for batch in batch_small_clusters(small):
            # under greedy the batch's pairs are the greedy scan's, counted below
            pairs_in_batch = 0 if greedy else sum(len(ix) * (len(ix) - 1) // 2 for _, ix in batch)
            with counters.stage("secondary_compare", pairs=pairs_in_batch):
                outs = retrying_call(
                    lambda batch=batch: batched_fn(gs, [ix for _, ix in batch], device=kw["device"],
                                                   mesh_shape=kw["mesh_shape"]),
                    site="secondary_batch", config=ft_cfg,
                )
            with counters.stage("secondary_postprocess"):
                for (pc, indices), (ani, cov) in zip(batch, outs, strict=True):
                    if greedy:
                        ndb, labels = greedy_assign_from_matrices(gs, indices, pc, kw, ani, cov)
                        counters.stages["secondary_compare"].pairs += len(ndb)
                        pairs_done += len(ndb)
                        results[pc] = (ndb, labels, np.empty((0, 4)))
                    else:
                        pairs_done += len(indices) * (len(indices) - 1) // 2
                        results[pc] = _secondary_postprocess(gs, indices, pc, kw, ani, cov)
                ckpt.save_many([(pc, *results[pc]) for pc, _ in batch])
    finally:
        ckpt.close()  # what was handed to the writer is on disk, whether or not the stage failed
    if pod_live() is not None and ckpt.dir is not None:
        # the pod lost a member: the lowest live one stamps how the store
        # was produced (extra provenance keys never invalidate a resume)
        from drep_tpu_torch.parallel.mesh import process_index
        from drep_tpu_torch.utils.ckptmeta import stamp_checkpoint_meta

        if process_index() == min(pod_live()):
            stamp_checkpoint_meta(ckpt.dir, {"pod_epochs": pod_epoch() + 1, "dead_processes": pod_dead()})
    STAGE_PAIRS["secondary_compare"] = pairs_done
    SECONDARY_RESUMED.update(resumed=ckpt.n_resumed, clusters=len(multi))
    ckpt.finish(n_primary)
    STAGE_SECONDS.update(checkpoint_write=ckpt.write_s, checkpoint_wait=ckpt.wait_s)
    return results, multi, singles


def d_cluster_wrapper(
    wd: WorkDirectory, bdb: pd.DataFrame, device=None, **kwargs
) -> pd.DataFrame:
    """Run (or resume) the full clustering stage on `device` (default
    cuda; a CUDA request without CUDA raises); returns Cdb. The dense
    ring's block stores live under ``<wd>/data/dense_ring`` for the
    stage (a directory is made only when a ring runs): its rings resume,
    and survive a pod member. Ring calls outside a stage keep their blocks
    in memory."""
    from drep_tpu_torch.parallel.allpairs import configure_ring

    configure_ring(checkpoint_base=os.path.join(wd.location, "data", "dense_ring"))
    try:
        return _cluster_stage(wd, bdb, device, **kwargs)
    finally:
        configure_ring()


def _cluster_stage(wd: WorkDirectory, bdb: pd.DataFrame, device, **kwargs) -> pd.DataFrame:
    logger = get_logger()
    kw = _fill_defaults(kwargs)
    kw["device"] = resolve_device(device)
    ft_cfg = _ft_config(kw)  # installed before anything is read or written
    snapshot = {k: kw.get(k) for k in _RESUME_KEYS if k != "genomes"}
    # normalize: CLI passes 0.25 explicitly, library callers omit it
    snapshot["warn_dist"] = _warn_dist(kw)
    snapshot["genomes"] = sorted(bdb["genome"])
    # stored to detect a resolution that changed, and kept out of the match
    # keys: a changed resolution warns rather than recomputes
    snapshot["primary_estimator_resolved"] = _resolve_estimator_for_run(len(bdb), kw)
    match_keys = [k for k in snapshot if k != "primary_estimator_resolved"]
    if wd.hasDb("Cdb") and wd.arguments_match("cluster", snapshot, keys=match_keys):
        stored = (wd.get_arguments("cluster") or {}).get("primary_estimator_resolved")
        if stored is not None and stored != snapshot["primary_estimator_resolved"]:
            logger.warning(
                "resuming a workdir whose primary estimator resolved to %r, but this "
                "run would resolve to %r (N or device count crossed an auto-selection "
                "boundary). The cached Mdb is kept — its per-pair values differ from a "
                "fresh run within estimator variance; delete Cdb/Mdb to recompute.",
                stored, snapshot["primary_estimator_resolved"],
            )
        logger.info("resuming: Cdb present with matching cluster arguments — skipping recompute")
        return wd.get_db("Cdb")

    STAGE_SECONDS.clear()
    STAGE_PAIRS.clear()
    SECONDARY_RESUMED.clear()
    t0 = time.perf_counter()
    warmup = _start_kernel_warmup(kw, wd, bdb)
    try:
        with counters.stage("ingest_or_cache"):
            gs = sketch_genomes(
                bdb,
                k=kw["kmer_size"],
                sketch_size=kw["MASH_sketch"],
                scale=kw["scale"],
                processes=kw["processes"],
                wd=wd,
                hash_name=kw["hash"],
            )
    finally:
        if warmup is not None:
            warmup.join()
    if warmup is not None:
        warmup.raise_error()
    n = len(gs.names)
    logger.info(
        "clustering %d genomes on %s (primary=%s, secondary=%s)",
        n, kw["device"], kw["primary_algorithm"], kw["S_algorithm"],
    )
    t1 = time.perf_counter()
    # the span keeps when the stage ran; its pairs are known only after it
    with telemetry.span("stage:primary_compare"):
        primary, pdist, plink, sparse_mdb = _primary_clusters(gs, bdb, kw, wd, ft_cfg)
    t2 = time.perf_counter()
    counters.add("primary_compare", pairs=STAGE_PAIRS.get("primary_compare", 0), seconds=t2 - t1)
    n_primary = int(primary.max()) if n else 0
    logger.info("primary clustering: %d clusters from %d genomes", n_primary, n)
    if pdist is not None:
        mdb = _mdb_from_dist(pdist, gs.names, kw["mdb_dense_limit"], kw["P_ani"], warn_dist=_warn_dist(kw))
        wd.store_db(schemas.validate(mdb, "Mdb"), "Mdb")
    elif sparse_mdb is not None:
        wd.store_db(schemas.validate(sparse_mdb, "Mdb"), "Mdb")

    clustering_files: dict[str, Any] = {
        "primary_linkage": plink,
        "primary_names": gs.names,
        "primary_dist": pdist if (pdist is not None and n <= kw["mdb_dense_limit"]) else None,
        "secondary": {},
    }

    ndb_parts: list[pd.DataFrame] = []
    secondary_names: dict[str, str] = {}
    t3 = time.perf_counter()
    if kw["SkipSecondary"]:
        for i, g in enumerate(gs.names):
            secondary_names[g] = f"{primary[i]}_0"
    else:
        # warn_dist shapes only the Mdb's retention and the resolved
        # estimator never touches ANI: neither keys the store
        sec_snapshot = {k: v for k, v in snapshot.items() if k not in ("warn_dist", "primary_estimator_resolved")}
        ckpt = SecondaryCheckpoint(wd.get_dir(os.path.join("data", "secondary_checkpoints")), sec_snapshot,
                                   primary, gs.names)
        # an open with no close is the crash evidence: a run that died in the stage
        telemetry.event("stage_open", stage="secondary")
        results, multi, singles = _secondary_clusters(gs, bdb, primary, kw, ckpt, ft_cfg)
        secondary_names.update(singles)
        for pc, indices in multi:  # assemble in cluster order (deterministic)
            ndb, labels, link = results[pc]
            ndb_parts.append(ndb)
            clustering_files["secondary"][pc] = {
                "linkage": link,
                "names": [gs.names[i] for i in indices],
            }
            for idx, lab in zip(indices, labels):
                secondary_names[gs.names[idx]] = f"{pc}_{lab}"
        telemetry.event("stage_close", stage="secondary")
    t4 = time.perf_counter()

    ndb = pd.concat(ndb_parts, ignore_index=True) if ndb_parts else schemas.empty("Ndb")
    cdb = pd.DataFrame(
        {
            "genome": gs.names,
            "secondary_cluster": [secondary_names[g] for g in gs.names],
            "threshold": 1.0 - kw["S_ani"],
            "cluster_method": kw["clusterAlg"],
            "comparison_algorithm": kw["S_algorithm"],
            "primary_cluster": primary,
        }
    )
    if kw["run_tertiary_clustering"]:
        if kw["SkipSecondary"]:
            logger.warning(
                "--run_tertiary_clustering ignored: requires secondary clustering "
                "(remove --SkipSecondary)"
            )
        else:
            cdb, tertiary_ndb = run_tertiary_clustering(gs, bdb, cdb, kw)
            if len(tertiary_ndb):
                ndb = pd.concat([ndb, tertiary_ndb], ignore_index=True)
            STAGE_SECONDS["tertiary"] = time.perf_counter() - t4
    t5 = time.perf_counter()
    with counters.stage("assembly_io"):
        wd.store_db(schemas.validate(ndb, "Ndb"), "Ndb")
        wd.store_db(schemas.validate(cdb, "Cdb"), "Cdb")
        cf_dir = wd.get_dir(os.path.join("data", "Clustering_files"))

        def _dump(tmp: str) -> None:
            with open(tmp, "wb") as f:
                pickle.dump(clustering_files, f)

        durableio.atomic_write(os.path.join(cf_dir, "clustering.pickle"), _dump)
    wd.store_arguments("cluster", snapshot)
    STAGE_SECONDS.update(
        ingest_or_cache=t1 - t0, primary=t2 - t1, mdb=t3 - t2, secondary=t4 - t3,
        assembly_io=time.perf_counter() - t5,
    )
    logger.info(
        "clustering done: %d primary, %d secondary clusters",
        n_primary,
        cdb["secondary_cluster"].nunique(),
    )
    return cdb
