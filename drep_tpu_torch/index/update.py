"""Incremental admission: K new genomes -> the next index generation.

Counterpart of drep_tpu/index/update.py. The pinned invariant: after any
sequence of ``index update`` batches, the index's cluster labels (up to
renumbering) and winners equal a from-scratch ``dereplicate
--streaming_primary`` over the union. It holds exactly because every
quantity decomposes:

- sketches are per genome;
- Mash distances are pair-local, so the union's retained edges are the
  stored edges plus the K x N tail rectangle's, computed on the streaming
  walk (parallel/streaming.py, ``min_col``): the Mash kernel, one launch
  a row stripe, over the column tiles that reach the new genomes;
- the primary (sparse UPGMA or connected components) never merges across
  connected components of the retained graph, so only the components a
  new genome touches ("dirty") re-cluster;
- the secondary and the scores depend only on a primary cluster's
  members: each primary cluster whose member set changed re-runs
  cluster/controller.py::secondary_for_cluster (on the card, one launch
  of the fused indicator kernel at the cluster's own vocabulary) and
  choose.py::score_and_pick; the others are reused verbatim.

Crash story: the rectangle checkpoints per-stripe shards under
``<index>/pending/`` (the streaming store format), new shards are written
under deterministic generation-stamped names, and the mutation becomes
visible only at the atomic manifest publish.

A federated root takes the same front door (index/federation.py): the
batch routes to range partitions, and each dirty partition runs this
update on its own store, in process or as a pod fed by a
``--params_file`` handoff (which also materializes an empty partition's
generation 0 under the federation's pinned params).

The ``index_update`` fault site fires where the JAX package's does: at
batch admission and just before the manifest publish (a raise there
leaves the prior generation). ``STATS`` holds the last update's seconds
and launch counts; the rectangle is also counted as the JAX package's
``index_rect_compare`` stage (utils/profiling.py).
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import meta as fedmeta
from drep_tpu_torch.index.store import IndexStore, LoadedIndex, build_manifest, empty_index, load_index
from drep_tpu_torch.utils import faults
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters

_STAT_COLS = ("length", "N50", "contigs", "n_kmers")

# the last update's (or build's, or classify's) seconds per part, the
# rectangle's pairs and launches, and the secondary re-runs of its dirty
# clusters (read by chip_smoke.py)
STATS: dict = {}


def _genome_sketches(idx: LoadedIndex):
    """The union set as the GenomeSketches the secondary engines consume."""
    from drep_tpu_torch.ingest import GenomeSketches

    p = idx.params
    return GenomeSketches(
        names=idx.names, gdb=idx.gdb, bottom=idx.bottom, scaled=idx.scaled,
        k=int(p["kmer_size"]), sketch_size=int(p["sketch_size"]),
        scale=int(p["scale"]),
    )


def _retention(params: dict) -> tuple[float, float]:
    from drep_tpu_torch.parallel.streaming import retention_bound

    cutoff = 1.0 - float(params["P_ani"])
    return cutoff, retention_bound(
        cutoff, float(params["warn_dist"]), params["clusterAlg"]
    )


def _rect_edges(
    idx: LoadedIndex, n_old: int, checkpoint_dir: str | None, prune_cfg: dict | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """New retained edges (jj >= n_old) of the union set: the streaming
    walk restricted to the column tiles that reach the new genomes at the
    tail (``min_col=n_old``), on `device`. With ``checkpoint_dir=None``
    (classify) the walk writes nothing.

    `prune_cfg` ({"primary_prune": "lsh", "prune_bands": B,
    "prune_min_shared": F, "prune_join_chunk": C}) hands the walk the LSH
    candidate set of the union pack at the index's retention bound,
    restricted to pairs that reach the tail; recall is 1.0 there, so the
    edges are the unpruned walk's."""
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges

    p = idx.params
    _, keep = _retention(p)
    t0 = time.perf_counter()
    packed = pack_sketches(idx.bottom, idx.names, int(p["sketch_size"]))
    t1 = time.perf_counter()
    prune = None
    if prune_cfg and prune_cfg.get("primary_prune", "off") == "lsh":
        from drep_tpu_torch.ops.lsh import build_candidates

        prune = build_candidates(
            packed, keep=keep, k=int(p["kmer_size"]),
            bands=int(prune_cfg.get("prune_bands", 0)),
            min_shared=int(prune_cfg.get("prune_min_shared", 0)),
            min_col=n_old,
            join_chunk=int(prune_cfg.get("prune_join_chunk", 0)),
        )
    t2 = time.perf_counter()
    ii, jj, dd, pairs = streaming_mash_edges(
        packed, int(p["kmer_size"]), keep,
        block=int(p["streaming_block"]),
        checkpoint_dir=checkpoint_dir, min_col=n_old, prune=prune, device=device,
    )
    from drep_tpu_torch.parallel import streaming

    STATS.update(pack_s=t1 - t0, prune_s=t2 - t1, rect_s=time.perf_counter() - t2, rect_pairs=pairs,
                 rect_launches=streaming.STATS["launches"], rect_stripes=streaming.STATS["stripes"],
                 rect_stripes_resumed=streaming.STATS["stripes_resumed"], rect_block=streaming.STATS["block"])
    # the tail-rectangle boundary: the walk computes whole column tiles, and
    # the tile holding column n_old also holds old-old pairs (already stored
    # in an earlier shard). The port's walk emits in the JAX package's
    # order, so the same selection keeps the same edges.
    sel = jj >= n_old
    return ii[sel], jj[sel], dd[sel], pairs


def _primary_partition(idx: LoadedIndex, n_old: int) -> tuple[np.ndarray, list[list[int]], int]:
    """The union primary partition, re-clustering ONLY dirty components.

    Returns (labels 1..C renumbered by first appearance — exactly the
    from-scratch numbering, the member lists per label, and the number of
    components re-clustered)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    n = idx.n
    ii, jj, dd = idx.edges
    cutoff, keep = _retention(idx.params)
    graph = coo_matrix((np.ones(len(ii), np.int8), (ii, jj)), shape=(n, n))
    _, comp = _cc(graph, directed=False)
    dirty = np.zeros(int(comp.max()) + 1 if n else 0, dtype=bool)
    if n_old < n:
        dirty[np.unique(comp[n_old:])] = True
    if idx.state_missing:
        dirty[:] = True  # rotted state: every component re-clusters

    group_of = np.full(n, -1, np.int64)
    next_key = 0
    # clean components keep the stored partition: group by the old label
    clean_nodes = np.nonzero(~dirty[comp])[0] if n else np.empty(0, np.int64)
    if len(clean_nodes):
        old_labels = idx.primary[clean_nodes]
        uniq = np.unique(old_labels)
        remap = {int(l): next_key + i for i, l in enumerate(uniq)}
        group_of[clean_nodes] = [remap[int(l)] for l in old_labels]
        next_key += len(uniq)

    reclustered = 0
    edge_comp = comp[ii] if len(ii) else np.empty(0, comp.dtype)
    for c in np.nonzero(dirty)[0]:
        members = np.nonzero(comp == c)[0]
        reclustered += 1
        if len(members) == 1:
            group_of[members[0]] = next_key
            next_key += 1
            continue
        local = np.full(n, -1, np.int64)
        local[members] = np.arange(len(members))
        sel = edge_comp == c
        li, lj, ld = local[ii[sel]], local[jj[sel]], dd[sel]
        if idx.params["clusterAlg"] == "single":
            from drep_tpu_torch.parallel.streaming import connected_components

            inc = ld <= cutoff
            sub = connected_components(len(members), li[inc], lj[inc])
        else:
            from drep_tpu_torch.ops.linkage import sparse_average_linkage

            sub, approx = sparse_average_linkage(
                len(members), li, lj, ld, cutoff, keep
            )
            if approx:
                get_logger().warning(
                    "index update: %d accepted merges in a re-clustered "
                    "component involved pairs beyond the %.3f retention "
                    "bound — same caveat as the streaming primary",
                    approx, keep,
                )
        group_of[members] = next_key + sub - 1  # sub is 1-based
        next_key += int(sub.max())

    # renumber by first appearance in genome order — the from-scratch rule
    labels = np.zeros(n, np.int64)
    members_of: dict[int, list[int]] = {}
    order: list[int] = []
    for i in range(n):
        g = int(group_of[i])
        if g not in members_of:
            members_of[g] = []
            order.append(g)
        members_of[g].append(i)
    groups: list[list[int]] = []
    for new_id, g in enumerate(order, start=1):
        labels[members_of[g]] = new_id
        groups.append(members_of[g])
    return labels, groups, reclustered


def _score_clusters(idx: LoadedIndex, parts: list[tuple[list[int], list[str], pd.DataFrame]]) -> np.ndarray:
    """Choose-stage scores of the members of several primary clusters
    [(members, their secondary names, the cluster's Ndb)], with the
    index's pinned weights, in one call of the batch pipeline's
    score_and_pick. Its rows are local (a genome's own stats and its
    centrality to co-members of its secondary cluster, summed in the
    order its cluster's Ndb gives), so one call over many clusters gives
    each row the value a call over its own cluster does."""
    from drep_tpu_torch.choose import score_and_pick

    members = [i for m, _, _ in parts for i in m]
    names = [idx.names[i] for i in members]
    cdb_sub = pd.DataFrame({"genome": names, "secondary_cluster": [s for _, sec, _ in parts for s in sec]})
    stats_sub = idx.gdb.iloc[members][["genome", "length", "N50"]]
    ndbs = [nd for _, _, nd in parts if len(nd)]
    ndb = pd.concat(ndbs, ignore_index=True) if ndbs else pd.DataFrame({"querry": [], "reference": [], "ani": []})
    w = idx.params["weights"]
    sdb_full, _ = score_and_pick(cdb_sub, stats_sub, ndb, None, S_ani=idx.params["S_ani"], **w)
    return sdb_full["score"].to_numpy(np.float64)


def recluster(idx: LoadedIndex, n_old: int, processes: int = 1, device=None, stats_out: dict | None = None) -> dict:
    """Recompute the index's derived state after `idx` gained genomes
    beyond `n_old` (sketches and edges already extended in memory), the
    secondary of each changed multi-member primary cluster on `device`.
    Mutates idx.primary/suffix/score/winners; returns a summary. Its
    secondary calls and seconds land in ``STATS`` and, when given, in
    `stats_out` (the caller's own copy).

    ``idx.frozen_rows`` (set by the streaming federated resident,
    index/federation.py) marks genomes whose sketch payloads are
    unavailable (quarantined partitions): they keep their old primary
    label, carry their old suffix and score when their cluster is reused
    whole, and when their cluster is recomputed they ride along with
    suffix 0 and their old score while only the available members
    re-cluster, never reaching a secondary their sketches cannot feed."""
    from drep_tpu_torch.cluster.controller import secondary_for_cluster
    from drep_tpu_torch.device import resolve_device

    t0 = time.perf_counter()
    old_primary = idx.primary
    old_suffix = idx.suffix
    old_score = idx.score
    frozen: set[int] = {int(i) for i in getattr(idx, "frozen_rows", ())}
    # member-set-keyed reuse: a union primary cluster whose member set
    # equals an old one has the old secondary results and scores
    old_groups: dict[frozenset, bool] = {}
    if n_old and not idx.state_missing:
        by_label: dict[int, list[int]] = {}
        for i in range(n_old):
            by_label.setdefault(int(old_primary[i]), []).append(i)
        old_groups = {frozenset(v): True for v in by_label.values()}

    labels, groups, reclustered_comps = _primary_partition(idx, n_old)
    n = idx.n
    suffix = np.zeros(n, np.int64)
    score = np.zeros(n, np.float64)
    gs = _genome_sketches(idx)
    bdb = pd.DataFrame({"genome": idx.names, "location": idx.locations})
    kw = {
        "S_algorithm": idx.params["S_algorithm"],
        "S_ani": idx.params["S_ani"],
        "cov_thresh": idx.params["cov_thresh"],
        "clusterAlg": idx.params["clusterAlg"],
        "processes": processes,
        "mesh_shape": None,
        "device": resolve_device(device),
    }
    # the winner table is spliced: reused clusters keep their old winner
    # row, recomputed ones pick locally by pick_winners' rule (score
    # descending, genome ascending; rows ordered by cluster name)
    reused = recomputed = 0
    win_rows: list[tuple[str, str, float]] = []  # (cluster, genome, score)
    old_win: dict[str, tuple[str, float]] = {}
    if old_groups:
        for row in idx.winners.itertuples():
            old_win[str(row.cluster)] = (str(row.genome), float(row.score))

    def _pick(cands: list[tuple[str, float]]) -> tuple[str, float]:
        return min(cands, key=lambda t: (-t[1], t[0]))

    # per-cluster secondary launches: one secondary_for_cluster call (on
    # the card, one indicator_mm launch at the cluster's own v_pad) for
    # each dirty multi-member cluster — many small launches, counted here,
    # the largest cluster logged. The recomputed clusters are scored in
    # one call after the loop, their winners picked then.
    secondary_calls, largest, t_secondary = 0, 0, 0.0
    to_score: list[tuple[list[int], list[str], pd.DataFrame]] = []
    no_ndb = pd.DataFrame({"querry": [], "reference": [], "ani": []})
    for pc, members in enumerate(groups, start=1):
        fs = frozenset(members)
        if fs in old_groups:
            suffix[members] = old_suffix[members]
            score[members] = old_score[members]
            reused += 1
            by_s: dict[int, list[int]] = {}
            for i in members:
                by_s.setdefault(int(old_suffix[i]), []).append(i)
            for s_val, mem in sorted(by_s.items()):
                old_name = f"{int(old_primary[mem[0]])}_{s_val}"
                won = old_win.get(old_name) or _pick(
                    [(idx.names[i], float(old_score[i])) for i in mem]
                )
                win_rows.append((f"{pc}_{s_val}", won[0], won[1]))
            continue
        recomputed += 1
        if frozen:
            held = [i for i in members if i in frozen]
            if held:
                # unavailable members: suffix 0 (never a real secondary),
                # their old score, no winner row; the rest re-clusters
                for i in held:
                    score[i] = old_score[i] if i < len(old_score) else 0.0
                members = [i for i in members if i not in frozen]
                if not members:
                    continue
        if len(members) == 1:
            suffix[members[0]] = 1  # the pipeline's singleton convention ("pc_1")
            to_score.append((list(members), [f"{pc}_1"], no_ndb))
            continue
        ts = time.perf_counter()
        ndb, labs, _link = secondary_for_cluster(gs, bdb, list(members), pc, kw)
        t_secondary += time.perf_counter() - ts
        secondary_calls += 1
        largest = max(largest, len(members))
        suffix[members] = labs
        to_score.append((list(members), [f"{pc}_{int(l)}" for l in labs], ndb))
    if to_score:
        scored = [i for m, _, _ in to_score for i in m]
        score[scored] = _score_clusters(idx, to_score)
        for members, sec_names, _ in to_score:
            by_name: dict[str, list[int]] = {}
            for i, name in zip(members, sec_names):
                by_name.setdefault(name, []).append(i)
            for name, mem in by_name.items():
                won = _pick([(idx.names[i], float(score[i])) for i in mem])
                win_rows.append((name, won[0], won[1]))
    if secondary_calls:
        get_logger().info(
            "index recluster: %d secondary re-run(s) of dirty primary clusters in %.2f s, "
            "the largest of %d genomes", secondary_calls, t_secondary, largest,
        )

    idx.primary = labels
    idx.suffix = suffix
    idx.score = score
    win_rows.sort(key=lambda r: r[0])  # pick_winners' output order
    idx.winners = pd.DataFrame(
        {
            "cluster": [r[0] for r in win_rows],
            "genome": [r[1] for r in win_rows],
            "score": np.array([r[2] for r in win_rows], np.float64),
        }
    )
    timing = {"secondary_calls": secondary_calls, "secondary_largest": largest, "secondary_s": t_secondary,
              "recluster_s": time.perf_counter() - t0}
    STATS.update(timing)
    if stats_out is not None:
        stats_out.update(timing)
    return {
        "primary_clusters": int(labels.max()) if n else 0,
        "secondary_clusters": len(win_rows),
        "components_reclustered": reclustered_comps,
        "clusters_reused": reused,
        "clusters_recomputed": recomputed,
        "seconds": round(time.perf_counter() - t0, 2),
    }


def _admit_batch(
    idx: LoadedIndex, batch: pd.DataFrame, results: dict[str, dict], gen_new: int
) -> int:
    """Extend idx in memory with the sketched batch; returns n_old."""
    n_old = idx.n
    names_new = list(batch["genome"])
    idx.names.extend(names_new)
    idx.locations.extend(batch["location"])
    rows = pd.DataFrame(
        {
            "genome": names_new,
            **{c: [results[g][c] for g in names_new] for c in _STAT_COLS},
        }
    )
    idx.gdb = pd.concat([idx.gdb, rows], ignore_index=True)
    idx.admitted = np.concatenate(
        [idx.admitted, np.full(len(names_new), gen_new, np.int64)]
    )
    idx.bottom.extend(results[g]["bottom"] for g in names_new)
    idx.scaled.extend(results[g]["scaled"] for g in names_new)
    return n_old


def sketch_batch(idx: LoadedIndex, genome_paths: list[str], processes: int = 1):
    """make_bdb + duplicate check + length filter + sketch — the index's
    ingest front door, shared by build and update."""
    from drep_tpu_torch.ingest import make_bdb, sketch_paths

    bdb = make_bdb(genome_paths)
    dup = sorted(set(bdb["genome"]) & set(idx.names))
    if dup:
        raise UserInputError(
            f"{len(dup)} genome basename(s) already indexed: {dup[:5]} — "
            f"the index keys genomes by basename; rename the files or "
            f"rebuild if they are replacements"
        )
    p = idx.params
    results = sketch_paths(
        bdb, int(p["kmer_size"]), int(p["sketch_size"]), int(p["scale"]),
        p["hash"], processes=processes,
    )
    min_len = int(p.get("filter_length", 0))
    dropped = [g for g in bdb["genome"] if results[g]["length"] < min_len]
    if dropped:
        get_logger().warning(
            "index: %d genome(s) below the index's filter length %d — "
            "not admitted (same rule the batch pipeline's filter stage "
            "applies): %s", len(dropped), min_len, dropped[:5],
        )
        bdb = bdb[~bdb["genome"].isin(dropped)].reset_index(drop=True)
    return bdb, results


def publish_generation(
    store: IndexStore,
    idx: LoadedIndex,
    gen_new: int,
    n_old: int,
    new_edges: tuple[np.ndarray, np.ndarray, np.ndarray],
) -> None:
    """Persist one admitted batch as generation `gen_new`: shards first
    (deterministic names and payloads: a rerun after a kill rewrites them
    alike), the manifest last (THE commit point), gc_states after.
    Shared by `index update` and the fresh `index build` (whose batch is
    the whole initial set at generation 0)."""
    t0 = time.perf_counter()
    store.ensure_dirs()
    sk_rel = store.sketch_shard_name(gen_new)
    ed_rel = store.edge_shard_name(gen_new)
    st_rel = store.state_name(gen_new)
    store.write_sketch_shard(
        sk_rel, idx.names[n_old:], idx.locations[n_old:], idx.gdb.iloc[n_old:],
        idx.bottom[n_old:], idx.scaled[n_old:], gen_new,
    )
    ii, jj, dd = new_edges
    store.write_edge_shard(ed_rel, ii, jj, dd)
    store.write_state(st_rel, idx)
    idx.generation = gen_new
    idx.sketch_shards = idx.sketch_shards + [
        {"file": sk_rel, "lo": n_old, "hi": idx.n, "generation": gen_new}
    ]
    idx.edge_shards = idx.edge_shards + [
        {"file": ed_rel, "lo": n_old, "hi": idx.n, "generation": gen_new}
    ]
    faults.fire("index_update")  # the pre-publish point (skip=1 targets it)
    store.publish_manifest(build_manifest(idx, st_rel))
    store.gc_states(st_rel)
    STATS["publish_s"] = time.perf_counter() - t0


def materialize_generation0(
    store: IndexStore, params: dict, batch: pd.DataFrame, results: dict[str, dict], processes: int = 1,
    device=None,
) -> dict:
    """Generation 0 of a new store from presketched genomes and pinned
    params, on `device`: a federation partition inherits the meta's
    params verbatim (under ``--fed_pods`` they ride the params handoff,
    since the CLI cannot express them)."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if not len(batch):
        raise UserInputError(
            f"partition {store.location}: no routed genome survived the "
            f"length filter — nothing to materialize"
        )
    STATS.clear()
    t0 = time.perf_counter()
    idx = empty_index(dict(params), location=store.location)
    _admit_batch(idx, batch, results, 0)
    with counters.stage("index_rect_compare"):
        ii, jj, dd, pairs = _rect_edges(idx, 0, store.pending_dir(0), device=dev)
    counters.stages["index_rect_compare"].pairs += pairs
    order = np.lexsort((jj, ii))
    idx.edges = (ii[order], jj[order], dd[order])
    summary = recluster(idx, 0, processes=processes, device=dev)
    publish_generation(store, idx, 0, 0, idx.edges)
    STATS["total_s"] = time.perf_counter() - t0
    summary.update(
        {
            "admitted": idx.n, "n_genomes": idx.n, "generation": 0,
            "new_edges": int(len(ii)), "pairs_compared": int(pairs),
            "healed": [],
        }
    )
    return summary


def index_update(
    index_loc: str, genome_paths: list[str] | None, processes: int = 1,
    primary_prune: str = "off", prune_bands: int = 0, prune_min_shared: int = 0,
    prune_join_chunk: int = 0, fed_pods: int | None = None,
    params_file: str | None = None,
    presketched: tuple[pd.DataFrame, dict] | None = None,
    device=None,
) -> dict:
    """`index update`: admit K new genomes (sketch K, compare K x N,
    re-cluster dirty components, re-score touched clusters) and publish
    the next generation, on `device` (default cuda; the CPU only when
    asked). With no genomes this is a pure HEAL pass: corrupt/missing
    shards repair and the generation stays put.

    `presketched` = (batch Bdb, {name: sketch result}) admits genomes
    sketched elsewhere in place of `genome_paths`. `primary_prune="lsh"`
    routes the rectangle through the LSH candidate set (see _rect_edges):
    an execution knob, never pinned, since the edges are the same.

    A federated root routes the batch over its partitions
    (federation.fed_update; `fed_pods` > 0 runs them as concurrent
    subprocess pods). `params_file` is a federation router's handoff to
    one partition store: the routed batch's sketches and the pinned
    params; a store that does not exist yet materializes generation 0
    under them."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if fedmeta.is_federated(index_loc):
        from drep_tpu_torch.index.federation import fed_update

        if params_file or presketched:
            raise UserInputError(
                "--params_file targets ONE partition store (the router "
                "writes it); the federation root takes plain -g genomes"
            )
        return fed_update(
            index_loc, genome_paths, processes=processes, fed_pods=fed_pods,
            primary_prune=primary_prune, prune_bands=prune_bands,
            prune_min_shared=prune_min_shared, prune_join_chunk=prune_join_chunk, device=dev,
        )
    logger = get_logger()
    store = IndexStore(index_loc)
    handoff_params = None
    if params_file:
        from drep_tpu_torch.index.federation import read_params_handoff

        handoff = read_params_handoff(params_file)
        handoff_params = handoff["params"]
        presketched = (handoff["batch"], handoff["results"])
        if not store.exists():
            return materialize_generation0(store, handoff_params, *presketched, processes=processes, device=dev)
    STATS.clear()
    t0 = time.perf_counter()
    idx = load_index(index_loc, heal=True, device=dev)
    STATS["load_s"] = time.perf_counter() - t0
    if handoff_params is not None and dict(idx.params) != dict(handoff_params):
        raise UserInputError(
            f"params handoff {params_file} pins different params than the "
            f"store at {index_loc} — the handoff belongs to a different "
            f"federation (or generation); refuse rather than drift numerics"
        )
    faults.fire("index_update")  # the batch admission point
    gen_new = idx.generation + 1

    batch = results = None
    if presketched is not None:
        batch, results = presketched
        dup = sorted(set(batch["genome"]) & set(idx.names))
        if dup:
            raise UserInputError(
                f"{len(dup)} handoff genome basename(s) already indexed: "
                f"{dup[:5]} — the router routed a batch this store already "
                f"admitted (resume the interrupted update instead)"
            )
    elif genome_paths:
        batch, results = sketch_batch(idx, genome_paths, processes=processes)
    if batch is None or not len(batch):
        # heal-only pass: a rotted state recomputes (all components dirty),
        # healed shards were rewritten by load_index; the generation stays
        summary = {"admitted": 0, "generation": idx.generation, "healed": idx.healed}
        if idx.state_missing:
            summary.update(recluster(idx, idx.n, processes=processes, device=dev))
            store.write_state(store.state_name(idx.generation), idx)
            logger.warning("index: state payload healed via full recompute")
        if idx.healed:
            logger.info("index heal pass: repaired %s", idx.healed)
        return summary

    n_old = _admit_batch(idx, batch, results, gen_new)
    prune_cfg = {
        "primary_prune": primary_prune,
        "prune_bands": prune_bands,
        "prune_min_shared": prune_min_shared,
        "prune_join_chunk": prune_join_chunk,
    }
    # the pending dir is the rectangle's shard store: its meta (with the
    # walk's min_col_block) is the JAX package's, so an update killed in
    # either package resumes its finished stripes here in the other
    with counters.stage("index_rect_compare"):
        ii, jj, dd, pairs = _rect_edges(
            idx, n_old, store.pending_dir(gen_new), prune_cfg=prune_cfg, device=dev
        )
    counters.stages["index_rect_compare"].pairs += pairs
    # canonical (ii, jj) order before the edges are used or stored: the
    # nearest-neighbour argmin and the linkage merge order break ties on it
    order = np.lexsort((jj, ii))
    ii, jj, dd = ii[order], jj[order], dd[order]
    idx.edges = (
        np.concatenate([idx.edges[0], ii]),
        np.concatenate([idx.edges[1], jj]),
        np.concatenate([idx.edges[2], dd]),
    )
    summary = recluster(idx, n_old, processes=processes, device=dev)

    publish_generation(store, idx, gen_new, n_old, (ii, jj, dd))
    summary.update(
        {
            "admitted": idx.n - n_old,
            "n_genomes": idx.n,
            "generation": gen_new,
            "new_edges": int(len(ii)),
            "pairs_compared": int(pairs),
            "healed": idx.healed,
        }
    )
    if primary_prune == "lsh":
        # what fraction of the rectangle's schedule the candidates removed
        from drep_tpu_torch.parallel import streaming

        st = streaming.STATS
        sched = st["tiles_computed"] + st["tiles_skipped"]
        summary["primary_prune"] = "lsh"
        summary["skip_fraction"] = round(st["tiles_skipped"] / sched, 4) if sched else 0.0
    STATS["total_s"] = time.perf_counter() - t0
    logger.info(
        "index update: +%d genomes -> generation %d (%d genomes, %d primary / "
        "%d secondary clusters; %d cluster(s) recomputed, %d reused)",
        summary["admitted"], gen_new, idx.n, summary["primary_clusters"],
        summary["secondary_clusters"], summary["clusters_recomputed"],
        summary["clusters_reused"],
    )
    return summary
