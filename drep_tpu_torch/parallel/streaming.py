"""The streaming primary: the 30 000+ genome path, one process.

Counterpart of drep_tpu/parallel/streaming.py. The dense primary
materialises the [N, N] distance matrix (40 GB at N = 100 000); this
path never does:

- the packed sketches live on the device once; the upper triangle of
  [block, block] tiles is walked one row stripe at a time, each stripe
  one launch of the Mash kernel over all its column tiles at once
  (ops/mash.py::stripe_survivors), thresholded and compacted on the
  device, so only the surviving (i, j, shared) triples cross to the host.
  The keep test reads a table built by the dense path's own numpy
  distance transform, so the retained edges and their distances are the
  dense matrix's, bit for bit;
- every finished stripe publishes a checkpoint shard (``row_XXXXX.npz``
  with its edges) under the work directory; a rerun skips finished
  shards. Stores are the JAX package's format both ways (meta.json keys,
  shard names and members, edge order);
- ``prune`` (ops/lsh.py) skips the column tiles that hold no candidate
  pair: the edges are the dense walk's either way;
- primary clusters come from the retained sparse edge graph, honouring
  --clusterAlg: 'average' runs sparse UPGMA (ops/linkage.py), 'single'
  connected components, which at a distance cutoff is exactly
  single-linkage fcluster.

- each stripe's launch runs through parallel/faulttol.py's
  ``retrying_call`` (fault site ``streaming_tile``, fired after the
  launch, on device slot 0): a failed launch retries with backoff on the same device, a
  hung one trips the watchdog (the run's
  ``ft_config``; ``dispatch_timeout_s`` 0 with ``auto_timeout`` derives
  it from the stripes' own latencies, reported as the gauge
  ``derived_dispatch_timeout_s``), and spent retries raise FaultTolError.
  No stripe is recomputed on the host: the JAX package's CPU fallback tile
  is not ported. A shard publish is the ``shard_write`` site, so a torn
  shard reads corrupt on resume and its stripe is recomputed.

With tracing on (utils/telemetry.py), each computed stripe is a
``stripe`` span holding its launch and its shard's publish, each publish a
``shard_publish`` instant (``pruned`` where no tile held a candidate), and
a resume a ``resume`` instant, as in the JAX package's single-process walk.

Not ported here: the JAX package's multi-process stripe dealing, elastic
pod and edge allgather (ROADMAP item 12b), their telemetry, and
its compile warmup (nothing is compiled per run: the kernels build once
into ``_build/``). Its per-tile readback budget does not apply: exactly
the survivors are read back.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from drep_tpu_torch.ops.mash import TILE, distance_table, stripe_survivors
from drep_tpu_torch.ops.minhash import PackedSketches, pad_packed_rows
from drep_tpu_torch.parallel import faulttol
from drep_tpu_torch.parallel.faulttol import AutoTimeout, FaultTolConfig, retrying_call
from drep_tpu_torch.utils import faults, telemetry
from drep_tpu_torch.utils.logger import get_logger

DEFAULT_BLOCK = 1024

# counters and seconds of the last streaming_mash_edges call, plus the
# pruning and linkage seconds of the last streaming_primary_clusters (read
# by cluster/controller.py and chip_smoke.py)
STATS: dict[str, float] = {}


def connected_components(n: int, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """Edge graph -> labels 1..C numbered by first member index (scipy's
    union-find; the partition is single-linkage fcluster at the cutoff)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    graph = coo_matrix((np.ones(len(ii), dtype=np.int8), (ii, jj)), shape=(n, n))
    _, raw = _cc(graph, directed=False)
    _, first_idx = np.unique(raw, return_index=True)
    remap = np.empty(len(first_idx), dtype=np.int64)
    remap[np.argsort(first_idx)] = np.arange(1, len(first_idx) + 1)
    return remap[raw]


def stripe_owner(bi: int, n_blocks: int, pc: int) -> int:
    """The process of `pc` that owns row stripe `bi` in the JAX package's
    pods: stripes pair with their mirror (``n_blocks - 1 - bi``) so every
    pair carries ``n_blocks + 1`` tiles, and pairs are dealt round-robin.
    This port runs one process (pc = 1), which owns every stripe."""
    return min(bi, n_blocks - 1 - bi) % pc


def _shard_name(bi: int, epoch: int) -> str:
    """Stripe `bi`'s shard file name; a nonzero epoch (the JAX package's
    elastic pod after a member died) is stamped into it."""
    return f"row_{bi:05d}.npz" if epoch == 0 else f"row_{bi:05d}.e{epoch:02d}.npz"


def _find_shard(checkpoint_dir: str, bi: int) -> str | None:
    """The shard of stripe `bi` under any ownership epoch, or None."""
    loc = os.path.join(checkpoint_dir, f"row_{bi:05d}.npz")
    if os.path.exists(loc):
        return loc
    hits = sorted(glob.glob(os.path.join(checkpoint_dir, f"row_{bi:05d}.e*.npz")))
    return hits[0] if hits else None


def _load_shard(path: str):
    """(ii, jj, dist) of a shard, or None when it reads corrupt (warned
    and removed: the stripe is recomputed)."""
    from drep_tpu_torch.utils.durableio import load_npz_or_none

    return load_npz_or_none(
        path, what="row shard",
        convert=lambda z: (z["ii"], z["jj"], z["dist"]),
        warn="streaming primary: corrupt shard %s — recomputing",
    )


def _shard_epoch(path: str) -> int:
    """The ownership epoch stamped in a shard file name (0 for bare
    names): a corrupt shard is recomputed into its own path, so the atomic
    rewrite replaces it even where its removal failed."""
    name = os.path.basename(path)
    if ".e" in name:
        try:
            return int(name.split(".e")[1].split(".")[0])
        except ValueError:
            return 0
    return 0


def _real_pairs_in_tile(i0: int, j0: int, block: int, n: int) -> int:
    """Unique real (unpadded, i < j) pairs a tile covers."""
    ra = max(0, min(i0 + block, n) - i0)
    rb = max(0, min(j0 + block, n) - j0)
    if i0 == j0:
        return ra * (ra - 1) // 2
    return ra * rb


def _effective_block(block: int, n: int) -> int:
    """The tile block the walk runs: the JAX package's rule on its TPU
    kernel (at most max(8, n), then up to a multiple of the kernel's
    128-row tiles)."""
    block = max(1, min(block, max(8, n)))
    return max(TILE, -(-block // TILE) * TILE)


def retention_bound(cutoff: float, keep_dist: float, cluster_alg: str) -> float:
    """The edge-retention bound: edges survive up to max(cutoff,
    keep_dist), widened to 2.5 x cutoff for average linkage when that
    would be the cutoff itself (sparse UPGMA needs the band beyond the
    cutoff to tell merges apart)."""
    keep = max(cutoff, keep_dist)
    if cluster_alg == "average" and keep <= cutoff:
        keep = min(1.0, 2.5 * cutoff)
    return keep


_PRUNE_KEYS = ("prune_scheme", "prune_bands", "prune_min_shared", "prune_keep")


def _prune_meta_conflict(checkpoint_dir: str, meta: dict) -> tuple | None:
    """(stored, wanted) banding parameters when the store's meta differs
    from `meta` in them only — a resume then refuses rather than clears
    hours of finished stripes; None otherwise (a missing, corrupt or
    otherwise different meta takes the normal open-and-clear)."""
    from drep_tpu_torch.utils.ckptmeta import META_NAME, META_PROVENANCE_KEYS
    from drep_tpu_torch.utils.durableio import read_json_checked

    loc = os.path.join(checkpoint_dir, META_NAME)
    if not os.path.exists(loc):
        return None
    try:
        stored = read_json_checked(loc, what="checkpoint meta")
    except Exception:  # noqa: BLE001 — a corrupt meta: the open decides
        return None
    if not isinstance(stored, dict):
        return None
    drop = set(_PRUNE_KEYS) | set(META_PROVENANCE_KEYS)
    stored_rest = {k: v for k, v in stored.items() if k not in drop}
    meta_rest = {k: v for k, v in meta.items() if k not in _PRUNE_KEYS}
    if stored_rest != meta_rest:
        return None
    sp = {k: stored.get(k) for k in _PRUNE_KEYS}
    mp = {k: meta.get(k) for k in _PRUNE_KEYS}
    return (sp, mp) if sp != mp else None


def _open_store(checkpoint_dir: str, meta: dict) -> bool:
    """Open the shard store under `meta` (True: its shards resume),
    refusing a store that differs only in its banding parameters."""
    from drep_tpu_torch.errors import UserInputError
    from drep_tpu_torch.utils.ckptmeta import open_checkpoint_dir

    conflict = _prune_meta_conflict(checkpoint_dir, meta)
    if conflict is not None:
        stored_p, wanted_p = conflict
        raise UserInputError(
            f"streaming checkpoint store {checkpoint_dir} was written under different "
            f"candidate-pruning parameters "
            f"({ {k: v for k, v in stored_p.items() if v is not None} or 'pruning off'}) "
            f"than this run requests "
            f"({ {k: v for k, v in wanted_p.items() if v is not None} or 'pruning off'}). "
            f"Refusing to resume: shards must never mix banding configs. Either rerun "
            f"with the original --primary_prune/--prune_bands/--prune_min_shared knobs, "
            f"or delete the store directory to recompute under the new ones."
        )
    return open_checkpoint_dir(checkpoint_dir, meta, clear_suffixes=(".npz",))


def streaming_mash_edges(
    packed: PackedSketches,
    k: int,
    cutoff: float,
    block: int = DEFAULT_BLOCK,
    checkpoint_dir: str | None = None,
    min_col: int = 0,
    prune=None,
    device: torch.device | str | None = None,
    stats_out: dict | None = None,
    ft_config: FaultTolConfig | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """All unordered pairs (i < j) with Mash distance <= cutoff:
    (ii, jj, dist, pairs_computed), in the JAX package's order (stripe by
    stripe, column tile by column tile, row-major inside a tile).

    `min_col` restricts the walk to column tiles that reach indices >=
    min_col (the rectangle of K new genomes appended at the tail against
    N stored ones); tiles at the boundary still emit a few old pairs.
    `prune` (ops/lsh.py CandidateSet, built at or beyond this cutoff)
    skips the tiles that hold no candidate; the edges, and every shard,
    are the dense walk's. The banding parameters are pinned in the store's
    meta, and a store that differs only in them refuses to resume.
    `pairs_computed` counts the pairs of the tiles computed by this call
    (resumed shards add 0).

    Runs on `device` (default cuda; the CPU only when asked): the Mash
    kernel on a CUDA device, its plain version on the CPU. Each stripe's
    launch runs through ``retrying_call`` under `ft_config` (default the
    process's ``faulttol.DEFAULT_CONFIG``). The call's counters land in
    the module's ``STATS`` and, when given, in `stats_out` (the caller's
    own copy, which threads walking at once do not share); ``launches``
    counts every launch, retries included.
    """
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    logger = get_logger()
    t_start = time.perf_counter()
    n = packed.n
    block = _effective_block(block, n)
    ids, counts = pad_packed_rows(packed.ids, packed.counts, block)
    n_blocks = ids.shape[0] // block
    first_col_block = max(0, min(int(min_col), max(n - 1, 0))) // block
    occ = prune.occupancy(block, n_blocks) if prune is not None else None
    width = ids.shape[1]

    resume = False
    if checkpoint_dir is not None:
        from drep_tpu_torch.utils.ckptmeta import content_fingerprint

        meta = {
            "n": n,
            "block": block,
            "k": k,
            "cutoff": round(float(cutoff), 12),
            "sketch_size": int(packed.sketch_size),
            "n_blocks": n_blocks,
            "fingerprint": content_fingerprint(packed.names, packed.counts, packed.ids),
        }
        if first_col_block:
            meta["min_col_block"] = first_col_block
        if prune is not None:
            meta.update(prune.params)
        resume = _open_store(checkpoint_dir, meta)

    # the pack, the keep table and the distance table, made when a stripe
    # first computes (a fully resumed run moves nothing to the device)
    res: dict = {}

    def _resident() -> dict:
        if not res:
            dist_tbl = distance_table(width, k)
            res.update(
                ids=torch.from_numpy(ids).to(dev),
                counts=torch.from_numpy(counts).to(dev),
                keep=torch.from_numpy(dist_tbl <= cutoff).to(dev),
                dist=dist_tbl,
            )
        return res

    ft_config = ft_config if ft_config is not None else faulttol.DEFAULT_CONFIG
    watchdog = AutoTimeout(ft_config)
    stats = {"stripes": 0, "stripes_resumed": 0, "launches": 0, "tiles_computed": 0,
             "tiles_total": 0, "tiles_skipped": 0}
    pairs_computed = 0
    empty = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32))

    def _compute_stripe(bi: int):
        nonlocal pairs_computed
        i0 = bi * block
        first = max(bi, first_col_block)
        cols = [bj for bj in range(first, n_blocks) if occ is None or occ[bi, bj]]
        stats["tiles_skipped"] += n_blocks - first - len(cols)
        stats["tiles_total"] += n_blocks
        stats["stripes"] += 1
        if not cols:
            return empty
        r = _resident()
        a, na = r["ids"][i0 : i0 + block], r["counts"][i0 : i0 + block]
        if cols[-1] - cols[0] + 1 == len(cols):
            b = r["ids"][cols[0] * block : (cols[-1] + 1) * block]
            nb = r["counts"][cols[0] * block : (cols[-1] + 1) * block]
        else:
            rows = torch.from_numpy(
                (np.asarray(cols)[:, None] * block + np.arange(block)[None, :]).ravel()
            ).to(dev)
            b, nb = r["ids"].index_select(0, rows), r["counts"].index_select(0, rows)

        def launch() -> np.ndarray:
            stats["launches"] += 1
            value = stripe_survivors(a, na, b, nb, width, r["keep"], diag=cols[0] == bi)
            faults.fire("streaming_tile", device=0)  # the one device's slot, as the JAX package's
            return value

        surv = retrying_call(launch, "streaming_tile", ft_config, auto=watchdog, fire=False)
        stats["tiles_computed"] += len(cols)
        pairs_computed += sum(_real_pairs_in_tile(i0, bj * block, block, n) for bj in cols)
        gi = surv[:, 1] + i0
        gj = np.asarray(cols, dtype=np.int64)[surv[:, 0]] * block + surv[:, 2]
        s_use = np.minimum(np.minimum(counts[gi], counts[gj]), width)
        dd = r["dist"][s_use, surv[:, 3]].astype(np.float32)
        logger.debug("streaming primary: stripe %d, %d column tiles, %d edges", bi, len(cols), len(gi))
        return gi, gj, dd

    all_ii: list[np.ndarray] = []
    all_jj: list[np.ndarray] = []
    all_dd: list[np.ndarray] = []
    for bi in range(n_blocks):
        found = _find_shard(checkpoint_dir, bi) if resume else None
        loaded = _load_shard(found) if found is not None else None
        if loaded is None:
            epoch = _shard_epoch(found) if found is not None else 0
            # an unclosed "B" is the crash evidence: the stripe in flight
            with telemetry.span("stripe", bi=bi, epoch=epoch):
                launches = stats["launches"]
                loaded = _compute_stripe(bi)
                if checkpoint_dir is not None:
                    from drep_tpu_torch.utils.durableio import atomic_savez

                    name = _shard_name(bi, epoch)
                    atomic_savez(os.path.join(checkpoint_dir, name), ii=loaded[0], jj=loaded[1], dist=loaded[2])
                    if stats["launches"] == launches:  # no tile held a candidate: nothing launched
                        telemetry.event("shard_publish", shard=name, edges=0, pruned=True)
                    else:
                        telemetry.event("shard_publish", shard=name, edges=len(loaded[0]))
        else:
            stats["stripes_resumed"] += 1
        all_ii.append(loaded[0])
        all_jj.append(loaded[1])
        all_dd.append(loaded[2])
    if stats["stripes_resumed"]:
        telemetry.event("resume", stripes=stats["stripes_resumed"], owned=n_blocks)

    derived = watchdog.derived()
    if derived is not None:
        # the deadline this run derived from its own stripes, for an
        # operator to pin --dispatch_timeout from evidence
        from drep_tpu_torch.utils.profiling import counters

        counters.set_gauge("derived_dispatch_timeout_s", round(derived, 3))
    ii = np.concatenate(all_ii) if all_ii else empty[0]
    jj = np.concatenate(all_jj) if all_jj else empty[1]
    dd = np.concatenate(all_dd) if all_dd else empty[2]
    final = dict(stats, n=n, block=block, n_blocks=n_blocks, pairs_computed=pairs_computed, edges=len(ii),
                 seconds=time.perf_counter() - t_start)
    STATS.clear()
    STATS.update(final)
    if stats_out is not None:
        stats_out.update(final)
    sched = stats["tiles_computed"] + stats["tiles_skipped"]
    logger.info(
        "streaming primary: %d genomes, block %d: %d stripes computed in %d Mash launches, "
        "%d resumed; %d of %d schedule tiles computed, %d skipped by pruning "
        "(skip fraction %.4f); %d pairs computed, %d edges kept",
        n, block, stats["stripes"], stats["launches"], stats["stripes_resumed"],
        stats["tiles_computed"], sched, stats["tiles_skipped"],
        stats["tiles_skipped"] / sched if sched else 0.0, pairs_computed, len(ii),
    )
    return ii, jj, dd, pairs_computed


def streaming_primary_clusters(
    packed: PackedSketches,
    k: int,
    p_ani: float,
    block: int = DEFAULT_BLOCK,
    checkpoint_dir: str | None = None,
    keep_dist: float = 0.0,
    cluster_alg: str = "average",
    primary_prune: str = "off",
    prune_bands: int = 0,
    prune_min_shared: int = 0,
    prune_join_chunk: int = 0,
    device: torch.device | str | None = None,
    ft_config: FaultTolConfig | None = None,
) -> tuple[np.ndarray, tuple[np.ndarray, np.ndarray, np.ndarray], int]:
    """Streaming primary clustering: (labels 1..C, retained edges (ii, jj,
    dist), pairs computed by this call).

    Edges are retained up to :func:`retention_bound` (pass the evaluate
    stage's warn_dist as `keep_dist`, so near-threshold pairs stay in the
    sparse Mdb). 'average' runs sparse UPGMA over every retained edge,
    unobserved pairs entering at the bound; 'single' runs connected
    components at the cutoff; other methods need the dense matrix and
    raise before any pair is computed. ``primary_prune="lsh"`` builds the
    candidate set at this call's retention bound and hands it to the walk.
    """
    if cluster_alg not in ("single", "average"):
        raise ValueError(
            f"streaming primary supports --clusterAlg average or single, not "
            f"{cluster_alg!r} (other scipy methods need the dense distance "
            f"matrix — raise --streaming_threshold or drop --streaming_primary "
            f"to use the dense path)"
        )
    cutoff = 1.0 - p_ani
    keep = retention_bound(cutoff, keep_dist, cluster_alg)
    if keep > max(cutoff, keep_dist):
        get_logger().warning(
            "streaming average linkage needs edge retention beyond the "
            "%.3f cutoff to discriminate merges (--warn_dist was <= the "
            "cutoff); widening retention to %.3f",
            cutoff, keep,
        )
    if primary_prune not in ("off", "lsh"):
        raise ValueError(f"--primary_prune supports off or lsh, not {primary_prune!r}")
    t0 = time.perf_counter()
    prune = None
    if primary_prune == "lsh":
        from drep_tpu_torch.ops.lsh import build_candidates

        prune = build_candidates(
            packed, keep=keep, k=k, bands=prune_bands,
            min_shared=prune_min_shared, join_chunk=prune_join_chunk,
        )
    t1 = time.perf_counter()
    ii, jj, dd, pairs_computed = streaming_mash_edges(
        packed, k, keep, block=block, checkpoint_dir=checkpoint_dir, prune=prune, device=device,
        ft_config=ft_config,
    )
    t2 = time.perf_counter()
    if cluster_alg == "single":
        in_cluster = dd <= cutoff
        labels = connected_components(packed.n, ii[in_cluster], jj[in_cluster])
    else:
        from drep_tpu_torch.ops.linkage import sparse_average_linkage

        labels, approx_merges = sparse_average_linkage(packed.n, ii, jj, dd, cutoff, keep)
        if approx_merges:
            get_logger().warning(
                "streaming average linkage: %d accepted merges involved pairs "
                "beyond the %.3f retention bound (entered the averages at that "
                "lower bound) — the partition may over-merge relative to "
                "full-matrix UPGMA; raise --warn_dist to widen retention if "
                "this matters",
                approx_merges, keep,
            )
    STATS.update(prune_seconds=t1 - t0, linkage_seconds=time.perf_counter() - t2)
    return labels, (ii, jj, dd), pairs_computed
