"""`index classify`: membership queries answered from the index alone.

Counterpart of drep_tpu/index/classify.py, on one store. Read-only: the
queries are sketched in memory (the indexed genomes load from the
store), the K x N rectangle runs with no checkpoint store, and the
hypothetical admission (the recluster `index update` would run) happens
on a scratch copy; nothing under the index directory is written. Because
the answer runs through the update machinery, a verdict is the
assignment `index update` would give the genome.

Queries ride under internal ``query:``-prefixed names, so classifying a
FASTA whose basename is already indexed is a lookup, not a collision.

- :func:`load_resident_index` loads the store once (read-only);
- :func:`sketch_queries` sketches FASTAs under the index's pinned params;
- :func:`classify_batch` answers sketched queries from a resident index
  without mutating it: ``joint=True`` (the CLI) admits the batch as one
  hypothetical admission, ``joint=False`` (the serve daemon) answers each
  query as if it were alone, from one rectangle for the whole batch: the
  resident sketch matrix held on the device (``resident_device.py``),
  or the union rectangle where that path cannot represent the batch.

A federated root is answered from the union of its partitions by
one-shot `index classify` (``load_resident_index(streaming=False)``),
and by the streaming federated resident (``federation.
FederatedResident``, the default ``streaming=True``) in the serve tier:
:func:`classify_batch` hands it to ``classify_batch_federated``, whose
verdicts equal the union path's plus coverage stamps.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import resident_device
from drep_tpu_torch.index.store import LoadedIndex, load_index
from drep_tpu_torch.index.update import STATS, _admit_batch, _rect_edges, recluster
from drep_tpu_torch.utils.logger import get_logger


def load_resident_index(index_loc: str, streaming: bool = True, resident_mb: int | None = None,
                        device=None) -> LoadedIndex:
    """Load the index once, read-only (``heal=False``: a rotted store is
    refused, never rewritten). On a federated root ``streaming=True``
    returns the streaming resident (``federation.FederatedResident``: the
    union spine, partitions' sketches loaded on first consult under an
    LRU budget of `resident_mb` MiB, partition failures contained as
    PARTIAL verdicts), whose compares run on `device` (default cuda; the
    CPU only when asked); ``streaming=False`` assembles the union of the
    partitions (the oracle one-shot `index classify` loads)."""
    from drep_tpu_torch.index import meta as fedmeta

    if streaming and fedmeta.is_federated(index_loc):
        from drep_tpu_torch.index.federation import FederatedResident

        return FederatedResident(index_loc, resident_mb=resident_mb, device=device)
    return load_index(index_loc, heal=False)


def _scratch_index(idx: LoadedIndex) -> LoadedIndex:
    """A classify-scratch copy of a resident index: fresh list containers
    (``_admit_batch`` extends them in place) sharing the per-genome
    payload arrays, which nothing in the classify path writes into. Every
    other field is only ever rebound by the update machinery, so the
    resident index stays as it was through any number of batches."""
    return LoadedIndex(
        location=idx.location, params=idx.params, generation=idx.generation,
        names=list(idx.names), locations=list(idx.locations),
        gdb=idx.gdb, admitted=idx.admitted,
        bottom=list(idx.bottom), scaled=list(idx.scaled),
        edges=idx.edges, primary=idx.primary, suffix=idx.suffix,
        score=idx.score, winners=idx.winners,
        sketch_shards=idx.sketch_shards, edge_shards=idx.edge_shards,
    )


@dataclass
class SketchedQueries:
    """One batch of queries, sketched and gated — the unit
    :func:`classify_batch` consumes. ``admitted`` rows carry the
    ``query:``-prefixed names; ``dropped`` holds the filtered-verdict
    dicts of queries below the index's filter length."""

    admitted: pd.DataFrame  # genome (query:-prefixed), location
    results: dict[str, dict]
    dropped: list[dict] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.admitted)


def sketch_queries(
    idx: LoadedIndex, genome_paths: list[str], processes: int = 1
) -> SketchedQueries:
    """Sketch the query FASTAs under the index's pinned params; duplicate
    basenames in one batch are refused (they would collide under the
    ``query:`` names)."""
    from drep_tpu_torch.ingest import sketch_paths

    p = idx.params
    if not genome_paths:
        return SketchedQueries(
            admitted=pd.DataFrame({"genome": [], "location": []}), results={}
        )
    basenames = [os.path.basename(g) for g in genome_paths]
    if len(set(basenames)) != len(basenames):
        raise UserInputError("duplicate genome basenames in the query list")
    bdb = pd.DataFrame(
        {
            "genome": [f"query:{b}" for b in basenames],
            "location": [os.path.abspath(g) for g in genome_paths],
        }
    )
    results = sketch_paths(
        bdb, int(p["kmer_size"]), int(p["sketch_size"]), int(p["scale"]),
        p["hash"], processes=processes,
    )
    min_len = int(p.get("filter_length", 0))
    admitted = bdb[
        [results[g]["length"] >= min_len for g in bdb["genome"]]
    ].reset_index(drop=True)
    dropped = []
    for g in sorted(set(bdb["genome"]) - set(admitted["genome"])):
        get_logger().warning(
            "classify: %s below the index's filter length %d", g, min_len
        )
        dropped.append(
            {
                "genome": g[len("query:"):],
                "filtered": True,
                "reason": f"below the index's filter length {min_len}",
                "generation": int(idx.generation),
            }
        )
    return SketchedQueries(admitted=admitted, results=results, dropped=dropped)


def _display(name: str) -> str:
    return name[len("query:"):] if name.startswith("query:") else name


def _assemble_verdicts(
    scratch: LoadedIndex,
    n_old: int,
    ii: np.ndarray,
    jj: np.ndarray,
    dd: np.ndarray,
    generation: int,
) -> list[dict]:
    """Verdict dicts for every query row (index >= n_old) of a
    reclustered scratch index. (ii, jj, dd) are the batch's new retained
    edges (jj >= n_old), in canonical order: the nearest indexed genome is
    the first minimum among a query's edges."""
    winner_of = dict(zip(scratch.winners["cluster"], scratch.winners["genome"]))
    sec_names = scratch.secondary_names()
    prim_old = scratch.primary[:n_old]
    sec_old = np.array(sec_names[:n_old], dtype=object)
    out: list[dict] = []
    for q in range(n_old, scratch.n):
        pc = int(scratch.primary[q])
        members = np.nonzero(prim_old == pc)[0].tolist()
        sec = sec_names[q]
        co = np.nonzero(sec_old == sec)[0].tolist()
        touch = (jj == q) & (ii < n_old)
        nearest_i = nearest_d = None
        if touch.any():
            k = int(np.argmin(dd[touch]))
            nearest_i = int(ii[touch][k])
            nearest_d = float(dd[touch][k])
        winner = winner_of.get(sec)
        out.append(
            {
                "genome": _display(scratch.names[q]),
                "primary_cluster": pc,
                "secondary_cluster": sec,
                "novel_primary": not members,
                "novel_secondary": not co,
                "cluster_members": [scratch.names[i] for i in co],
                "winner": _display(winner) if winner is not None else None,
                "would_win": winner == scratch.names[q],
                "score": float(scratch.score[q]),
                "nearest": scratch.names[nearest_i] if nearest_i is not None else None,
                "nearest_dist": nearest_d,
                "generation": int(generation),
            }
        )
    return out


def classify_batch(
    resident: LoadedIndex,
    queries: SketchedQueries,
    processes: int = 1,
    prune_cfg: dict | None = None,
    joint: bool = True,
    device=None,
) -> list[dict]:
    """One verdict dict per admitted query, answered from `resident`
    without mutating it, on `device` (default cuda; the CPU only when
    asked). One K x N rectangle covers the whole batch whatever `joint`
    says; the modes differ only in host-side assembly:

    - ``joint=True``: the batch is one hypothetical admission — queries
      cluster with the index AND each other (the CLI's semantics);
    - ``joint=False``: each query is answered as if it were the only one
      (query-query edges are dropped; each verdict re-runs the recluster
      with just its own query admitted).

    ``prune_cfg`` routes the union rectangle through the LSH candidate
    set `index update` uses (recall 1.0 at the retention bound, so the
    verdicts are the same); the resident rectangle computes every pair.

    A streaming federated resident takes the same front door: the batch
    routes to candidate partitions, runs one rectangle each and merges
    the per-partition edges into the same verdicts, stamped
    ``partitions_consulted`` / ``partitions_unavailable``
    (``federation.classify_batch_federated``, on the device the resident
    was loaded for; another `device` raises)."""
    from drep_tpu_torch.device import resolve_device
    from drep_tpu_torch.index.federation import FederatedResident, classify_batch_federated

    if isinstance(resident, FederatedResident):
        if device is not None and resolve_device(device) != resident.device:
            raise ValueError(f"classify_batch: the streaming resident runs on {resident.device}, not {device}")
        return classify_batch_federated(resident, queries, processes=processes, prune_cfg=prune_cfg, joint=joint)
    dev = resolve_device(device)
    if not queries.n:
        return []
    t0 = time.perf_counter()
    n_old = resident.n
    n_real = queries.n
    gen = int(resident.generation)
    # No shape bucketing: the JAX package pads K to a power of two with
    # copies of the first query so that XLA compiles log-many shapes of
    # the rectangle. The port compiles nothing per shape (the kernels are
    # built once), so K stays as given; the pad columns' edges were never
    # read, so the verdicts are the same.
    # joint=False first takes the resident matrix (one upload per
    # generation): the per-query selection below reads only the
    # query-to-indexed edges it gives; None => the union rectangle
    fast = None if joint else resident_device.rect_edges_device(resident, queries, n_old, dev)
    if fast is not None:
        ii, jj, dd = fast
    else:
        scratch = _scratch_index(resident)
        _admit_batch(scratch, queries.admitted, queries.results, gen + 1)
        # in-memory rectangle: checkpoint_dir None => the walk writes nothing
        ii, jj, dd, _pairs = _rect_edges(scratch, n_old, None, prune_cfg=prune_cfg, device=dev)
    # canonical (ii, jj) order, as in the update: the nearest-neighbour
    # argmin and the linkage merge order break ties on it
    order = np.lexsort((jj, ii))
    ii, jj, dd = ii[order], jj[order], dd[order]
    STATS["classify_rect_s"] = time.perf_counter() - t0
    if joint:
        scratch.edges = (
            np.concatenate([scratch.edges[0], ii]),
            np.concatenate([scratch.edges[1], jj]),
            np.concatenate([scratch.edges[2], dd]),
        )
        recluster(scratch, n_old, processes=processes, device=dev)
        return _assemble_verdicts(scratch, n_old, ii, jj, dd, gen)
    out: list[dict] = []
    for t in range(n_real):
        # per-query scratch: admit ONLY this query, wire ONLY its edges to
        # indexed genomes (remapped to column n_old), recluster — the
        # one-shot single-query answer, since distances are pair-local
        sq = _scratch_index(resident)
        _admit_batch(sq, queries.admitted.iloc[[t]], queries.results, gen + 1)
        sel = (jj == n_old + t) & (ii < n_old)
        qii = ii[sel]
        qjj = np.full(int(sel.sum()), n_old, np.int64)
        qdd = dd[sel]
        sq.edges = (
            np.concatenate([sq.edges[0], qii]),
            np.concatenate([sq.edges[1], qjj]),
            np.concatenate([sq.edges[2], qdd]),
        )
        recluster(sq, n_old, processes=processes, device=dev)
        out.extend(_assemble_verdicts(sq, n_old, qii, qjj, qdd, gen))
    return out


def index_classify(
    index_loc: str, genome_paths: list[str], processes: int = 1,
    primary_prune: str = "off", prune_bands: int = 0, prune_min_shared: int = 0,
    prune_join_chunk: int = 0, device=None,
) -> list[dict]:
    """One verdict dict per query: the primary/secondary cluster it would
    join, that cluster's winner (would the query itself win?), its nearest
    indexed genome by Mash distance, and whether it is novel. Several
    queries are classified jointly. Load + sketch + one joint batch."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    # a federated root is union-assembled: the one-shot classify is the
    # oracle the streaming serving view is held to
    resident = load_resident_index(index_loc, streaming=False)
    queries = sketch_queries(resident, genome_paths, processes=processes)
    prune_cfg = {
        "primary_prune": primary_prune,
        "prune_bands": prune_bands,
        "prune_min_shared": prune_min_shared,
        "prune_join_chunk": prune_join_chunk,
    }
    out = classify_batch(
        resident, queries, processes=processes, prune_cfg=prune_cfg, joint=True, device=dev
    )
    return out + queries.dropped
