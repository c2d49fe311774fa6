"""Federated genome index: range-partitioned stores under one meta-manifest.

Counterpart of drep_tpu/index/federation.py, in its store format byte for
byte, so either package builds, updates, heals and reads the other's
federation. The single-store index tops out at one host's bucket join and
one store's shard families; here the genome space is split into P range
partitions keyed by a sketch-derived code (index/meta.py), each partition
a full index store (own ``manifest.json``, own sketch/edge/state
families, self-healing as one store does), with one layer above them::

    federation.json               -- the meta-manifest (index/meta.py):
                                     every partition's (range, generation,
                                     manifest checksum), the cross-shard
                                     list, the union state and routing
                                     summary pointers; the commit point.
    part_000/ ... part_NNN/       -- one complete index store each.
    cross/cross_g%06d.npz         -- a federation generation's cross-
                                     partition retained edges in union
                                     coordinates (jj in [lo, hi)), plus
                                     the (pid, local) mapping of that
                                     union range: the mapping's redundant
                                     copy (the heal anchor of the state).
    state/fedstate_g%06d.npz      -- the union derived state: the
                                     append-only (pid, local) admission
                                     order, union primary/secondary
                                     labels, scores and the winner table.
    routing/summary_g%06d.npz     -- one coarse-code bitmap a partition
                                     (ops/rangepart.py), for the serving
                                     router (item 11b).

Update (``index update`` on a federated root): new genomes are sketched
once, routed by range code, and each dirty partition runs its own K x N
tail rectangle (the Mash kernel, one launch a row stripe) and recluster
(the fused indicator kernel, one launch a dirty cluster) as an
independent unit: in process one at a time, or as ``--fed_pods``
concurrent subprocess pods (``python -m drep_tpu_torch index update`` on
one partition store, fed by a ``--params_file`` handoff). A partition
that fails stays at its old generation and the run publishes an honest
partial meta naming it and its unadmitted genomes.

Only boundary LSH buckets cross partitions: packed ids are ranks local
to one pack, so the cross join bands the raw bottom hashes into a shared
2^30 code space (rangepart.hash_code_matrix), range-shards it
(rangepart.partition_by_range) and folds the per-shard (pair-code,
count) partials through ops/lsh.py::merge_code_counts. A retained cross
pair shares a raw hash, hence a band code, so candidates have recall
1.0; exact distances then run on the streaming walk (the Mash kernel)
over just the candidate-involved genomes, whose pair distances do not
depend on the pack.

Commit order per federation generation: partitions first (each its own
manifest publish), then the cross shard, union state and routing summary
under generation-stamped names, then ``federation.json`` last. A kill
anywhere leaves readers at the old federation generation:
:func:`load_federated` truncates every partition to the genome count the
meta records.

Not ported here: the streaming per-partition serving view
(``FederatedResident``) and ``classify_batch_federated`` (ROADMAP.md
queue 1 item 11b), and the JAX package's fault sites and telemetry
events (items 5.3 and 13). ``STATS`` holds the last federated update's
seconds, pairs and per-partition launches instead.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import meta as fedmeta
from drep_tpu_torch.index.store import _STAT_COLS, IndexStore, LoadedIndex, empty_index, load_index
from drep_tpu_torch.index.update import _retention, index_update, recluster, sketch_batch
from drep_tpu_torch.utils.logger import get_logger


# the boundary join's widest repacked band-code bucket a range shard
# (pow2; rangepart.partition_by_range), the JAX package's default
FED_SHARD_MAX = 4096

# the last federated update's (or build's) seconds, pairs and launches:
# load_s, join_s, cross_candidates, walk_s, cross_pairs, cross_launches,
# recluster_s, publish_s, and per partition {pid: {s, rect_launches,
# secondary_calls}} (read by chip_smoke.py)
STATS: dict = {}


def _empty_edges():
    return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32)


class FederationStore:
    """Path bookkeeping + federation-level shard (de)serialization."""

    def __init__(self, location: str):
        self.location = os.path.abspath(location)

    # ---- paths -----------------------------------------------------------
    @property
    def meta_path(self) -> str:
        return fedmeta.meta_path(self.location)

    def exists(self) -> bool:
        return fedmeta.is_federated(self.location)

    def partition_dir(self, pid: int) -> str:
        return os.path.join(self.location, fedmeta.partition_dir_name(pid))

    def cross_shard_name(self, gen: int) -> str:
        return os.path.join("cross", f"cross_g{gen:06d}.npz")

    def fedstate_name(self, gen: int) -> str:
        return os.path.join("state", f"fedstate_g{gen:06d}.npz")

    def routing_name(self, gen: int) -> str:
        return os.path.join("routing", f"summary_g{gen:06d}.npz")

    def abspath(self, rel: str) -> str:
        return os.path.join(self.location, rel)

    def ensure_dirs(self) -> None:
        for sub in ("cross", "state", "routing", "log"):
            os.makedirs(os.path.join(self.location, sub), exist_ok=True)

    # ---- meta ------------------------------------------------------------
    def read_meta(self) -> dict:
        return fedmeta.read_meta(self.location)

    def publish_meta(self, meta: dict) -> None:
        fedmeta.publish_meta(self.location, meta)

    # ---- federation shard families --------------------------------------
    def write_cross_shard(self, rel: str, ii, jj, dd, map_pid, map_local) -> None:
        """One federation generation's cross-partition edges (union
        coordinates, sorted by (ii, jj)) + the (pid, local) mapping of
        the union range it admitted."""
        from drep_tpu_torch.utils.durableio import atomic_savez

        order = np.lexsort((jj, ii))
        os.makedirs(os.path.dirname(self.abspath(rel)), exist_ok=True)
        atomic_savez(
            self.abspath(rel),
            ii=np.asarray(ii, np.int64)[order],
            jj=np.asarray(jj, np.int64)[order],
            dist=np.asarray(dd, np.float32)[order],
            map_pid=np.asarray(map_pid, np.int64),
            map_local=np.asarray(map_local, np.int64),
        )

    def write_fedstate(self, rel: str, idx: LoadedIndex, part_of: np.ndarray, local_of: np.ndarray) -> None:
        from drep_tpu_torch.utils.durableio import atomic_savez

        os.makedirs(os.path.dirname(self.abspath(rel)), exist_ok=True)
        atomic_savez(
            self.abspath(rel),
            part_of=np.asarray(part_of, np.int64),
            local_of=np.asarray(local_of, np.int64),
            admitted_generation=np.asarray(idx.admitted, np.int64),
            primary=np.asarray(idx.primary, np.int64),
            suffix=np.asarray(idx.suffix, np.int64),
            score=np.asarray(idx.score, np.float64),
            winner_cluster=idx.winners["cluster"].to_numpy().astype(str),
            winner_genome=idx.winners["genome"].to_numpy().astype(str),
            winner_score=idx.winners["score"].to_numpy().astype(np.float64),
        )

    def write_routing_summary(self, rel: str, bottoms: list[np.ndarray], part_of: np.ndarray,
                              n_partitions: int) -> None:
        """One coarse-code bitmap a partition over the current union
        (rangepart.code_summary_bitmap); deterministic per union content,
        so a killed run's rerun rewrites it alike."""
        from drep_tpu_torch.ops import rangepart
        from drep_tpu_torch.utils.durableio import atomic_savez

        part_of = np.asarray(part_of, np.int64)
        bitmaps = np.stack(
            [
                rangepart.code_summary_bitmap([bottoms[int(i)] for i in np.nonzero(part_of == p)[0]])
                for p in range(int(n_partitions))
            ]
        ) if n_partitions else np.zeros((0, 1), np.uint64)
        os.makedirs(os.path.dirname(self.abspath(rel)), exist_ok=True)
        atomic_savez(self.abspath(rel), bitmaps=bitmaps, bits=np.int64(rangepart.ROUTE_SUMMARY_BITS))

    def gc_states(self, keep_rel: str, keep_routing_rel: str | None = None) -> None:
        """Best-effort removal of superseded union states (and routing
        summaries), strictly after the meta publish."""
        families = [("state", "fedstate_g", os.path.basename(keep_rel))]
        if keep_routing_rel is not None:
            families.append(("routing", "summary_g", os.path.basename(keep_routing_rel)))
        for sub, prefix, keep in families:
            fam_dir = os.path.join(self.location, sub)
            if os.path.isdir(fam_dir):
                for f in os.listdir(fam_dir):
                    if f != keep and f.startswith(prefix) and f.endswith(".npz"):
                        with contextlib.suppress(OSError):
                            os.remove(os.path.join(fam_dir, f))


# ---------------------------------------------------------------------------
# the boundary-bucket cross-partition join
# ---------------------------------------------------------------------------


def cross_candidates(bottoms: list[np.ndarray], part_of: np.ndarray, min_col: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Every cross-partition pair that can survive the retention bound:
    band the raw bottom hashes into the shared code space, range-shard
    it (the boundary buckets are the codes present in more than one
    partition), join within each shard, and fold the shards' (pair-code,
    count) partials through ``lsh.merge_code_counts``. `min_col` keeps
    only pairs reaching the union's new tail. Returns union (ii, jj),
    ii < jj."""
    from drep_tpu_torch.ops import rangepart
    from drep_tpu_torch.ops.lsh import _iter_pair_codes, merge_code_counts
    from drep_tpu_torch.ops.minhash import PAD_ID

    n = len(bottoms)
    part_of = np.asarray(part_of, np.int64)
    empty = (np.empty(0, np.int64), np.empty(0, np.int64))
    if n < 2 or len(np.unique(part_of)) < 2:
        return empty
    codes = rangepart.hash_code_matrix(bottoms)
    mats: list[np.ndarray] = []
    owners: list[np.ndarray] = []
    for p in np.unique(part_of):
        rows = np.nonzero(part_of == p)[0]
        mats.append(codes[rows])
        owners.append(rows)

    def shard_partials():
        # one iteration = one disjoint band-code range = one join shard
        for _origin, buckets in rangepart.partition_by_range(mats, FED_SHARD_MAX):
            flat_codes: list[np.ndarray] = []
            flat_owner: list[np.ndarray] = []
            for b, own in zip(buckets, owners):
                r, c = np.nonzero(b != PAD_ID)
                flat_codes.append(b[r, c])
                flat_owner.append(own[r])
            fc = np.concatenate(flat_codes)
            fo = np.concatenate(flat_owner)
            order = np.argsort(fc, kind="stable")
            ks, gs = fc[order], fo[order]
            starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
            sizes = np.diff(np.r_[starts, len(ks)])
            for batch in _iter_pair_codes(starts, sizes, gs, n, 1 << 20):
                lo, hi = batch // n, batch % n
                sel = part_of[lo] != part_of[hi]
                if min_col > 0:
                    sel &= hi >= min_col
                if sel.any():
                    yield batch[sel]

    uniq, _counts = merge_code_counts(shard_partials())
    if not len(uniq):
        return empty
    return uniq // n, uniq % n


def cross_edges(union: LoadedIndex, part_of: np.ndarray, cand_ii: np.ndarray, cand_jj: np.ndarray,
                min_col: int = 0, device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Exact retained cross-partition edges of the candidate pairs: pack
    only the candidate-involved genomes and run the streaming walk (the
    Mash kernel, one launch a row stripe, on `device`) over the
    candidate-occupied tiles. Returns (ii, jj, dist, pairs_compared) in
    union coordinates, sorted, filtered to cross-partition pairs with
    jj >= min_col."""
    from drep_tpu_torch.ops.lsh import CandidateSet
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges

    if not len(cand_ii):
        return (*_empty_edges(), 0)
    p = union.params
    _, keep = _retention(p)
    subset = np.unique(np.concatenate([cand_ii, cand_jj]))
    li = np.searchsorted(subset, cand_ii)
    lj = np.searchsorted(subset, cand_jj)
    packed = pack_sketches([union.bottom[int(u)] for u in subset], [union.names[int(u)] for u in subset],
                           int(p["sketch_size"]))
    prune = CandidateSet(ii=li, jj=lj, n=len(subset), params={"prune_scheme": "fed_boundary"})
    ii, jj, dd, pairs = streaming_mash_edges(
        packed, int(p["kmer_size"]), keep, block=int(p["streaming_block"]), prune=prune, device=device,
    )
    ui, uj = subset[ii], subset[jj]
    # candidate-occupied tiles also emit intra-partition and old-old
    # pairs, both stored elsewhere: keep only this shard's slice
    sel = np.asarray(part_of)[ui] != np.asarray(part_of)[uj]
    if min_col > 0:
        sel &= uj >= min_col
    ui, uj, dd = ui[sel], uj[sel], dd[sel]
    order = np.lexsort((uj, ui))
    return ui[order], uj[order], dd[order], int(pairs)


# ---------------------------------------------------------------------------
# the federated load (the union view every reader consumes)
# ---------------------------------------------------------------------------


def _truncate_partition(pidx: LoadedIndex, n_p: int) -> LoadedIndex:
    """The partition as of the meta's recorded generation: its first
    `n_p` genomes and the edges among them (stores are append-only in
    genome-index space, so the prefix is the old generation's content)."""
    if pidx.n <= n_p:
        return pidx
    ii, jj, dd = pidx.edges
    sel = jj < n_p  # ii < jj, so both endpoints are inside the prefix
    return LoadedIndex(
        location=pidx.location, params=pidx.params, generation=pidx.generation,
        names=pidx.names[:n_p], locations=pidx.locations[:n_p],
        gdb=pidx.gdb.iloc[:n_p].reset_index(drop=True),
        admitted=pidx.admitted[:n_p],
        bottom=pidx.bottom[:n_p], scaled=pidx.scaled[:n_p],
        edges=(ii[sel], jj[sel], dd[sel]),
        primary=pidx.primary[:n_p], suffix=pidx.suffix[:n_p],
        score=pidx.score[:n_p], winners=pidx.winners,
        healed=pidx.healed,
    )


def _read_npz_or_refuse(path: str, what: str, location: str, heal: bool):
    """A federation family's payload, or None when missing (or corrupt
    under `heal`); read-only mode refuses a corrupt one."""
    from drep_tpu_torch.utils import durableio

    if heal:
        return durableio.load_npz_or_none(
            path, what=what, convert=lambda z: z,
            warn=f"federated index {what}: corrupt %s — healing via recompute",
        )
    try:
        return durableio.load_npz_checked(path, what=what)
    except FileNotFoundError:
        return None
    except durableio.CorruptPayloadError as e:
        raise UserInputError(
            f"federated index {what} {path} is corrupt ({e}). classify/serve "
            f"are read-only; run `drep-tpu index update {location}` (no "
            f"genomes needed) to heal it"
        ) from e


def partition_refusal(pid: int, rng, gen: int, err: BaseException) -> str:
    """The unreadable-partition message: the partition id and its
    recorded (range, generation), not just the underlying error."""
    lo, hi = (int(rng[0]), int(rng[1])) if rng is not None else (0, 0)
    return (
        f"federated index: partition {pid} (range [{lo:#x}, {hi:#x}), "
        f"meta-recorded generation {gen}) is unreadable: "
        f"{type(err).__name__}: {err} — scope the damage with "
        f"`python tools/scrub_store.py <root> --partition {pid}` and heal "
        f"with `drep-tpu index update <root>` (no genomes needed)"
    )


def partition_heal_hint(pid: int) -> str:
    """The partition-scoped probe an operator shells to, then the heal."""
    return (
        f"python tools/scrub_store.py <root> --partition {pid} "
        f"(then `drep-tpu index update <root>` to heal)"
    )


def load_federated(location: str, heal: bool = False, device=None) -> LoadedIndex:
    """The whole federation at its meta generation, assembled as one union
    ``LoadedIndex`` (what one-shot classify and the update machinery
    consume). Every partition loads through the store loader (its own
    heal matrix applies, an edge-shard recompute on `device`) and is
    truncated to the genome count the meta records; union labels, scores
    and winners come from the federation state; edges are the
    partitions' intra edges in union coordinates plus the cross shards.

    Heal matrix at the federation level (update-time; read-only refuses):

    - union state rotted -> the mapping is recovered from the cross
      shards' redundant copies and the caller reclusters the whole union
      (``state_missing``);
    - cross shard rotted -> its candidate join and distances recompute
      for the shard's union range (on `device`) and the shard rewrites
      with the same payload;
    - union state and a cross shard both rotted -> fatal.

    The returned index carries ``fed_part_of``, ``fed_local_of`` and
    ``fed_meta``. A partition that fails to load raises UserInputError
    carrying ``fed_partition`` (the update's partial contract)."""
    logger = get_logger()
    store = FederationStore(location)
    m = store.read_meta()
    params = m["params"]
    gen = int(m["generation"])
    healed: list[str] = []
    if gen < 0:
        if not heal:
            raise UserInputError(
                f"federated index at {location} is an empty skeleton "
                f"(generation -1) — finish the initial `drep-tpu index "
                f"update {location} -g ...` before serving from it"
            )
        idx = empty_index(params, location=store.location)
        idx.fed_part_of = np.empty(0, np.int64)  # type: ignore[attr-defined]
        idx.fed_local_of = np.empty(0, np.int64)  # type: ignore[attr-defined]
        idx.fed_meta = m  # type: ignore[attr-defined]
        return idx

    # 1. partitions, each at the meta's recorded generation ---------------
    loaded: dict[int, LoadedIndex | None] = {}
    for e in m["partitions"]:
        pid = int(e["pid"])
        n_p = int(e["n_genomes"])
        if n_p <= 0:
            loaded[pid] = None
            continue
        # the meta's recorded dir: a split or merge renumbers pids densely
        pdir = store.abspath(e["dir"])
        try:
            pidx = load_index(pdir, heal=heal, device=device)
        except Exception as err:  # noqa: BLE001 — any failure is named as this partition's
            refusal = UserInputError(partition_refusal(pid, e.get("range"), int(e["generation"]), err))
            refusal.fed_partition = pid  # type: ignore[attr-defined]
            raise refusal from err
        healed.extend(f"{e['dir']}/{h}" for h in pidx.healed)
        g_meta = int(e["generation"])
        if pidx.generation < g_meta:
            raise UserInputError(
                f"federated index: partition {pid} is at generation "
                f"{pidx.generation} but the meta-manifest recorded "
                f"{g_meta} — the partition store was rolled back or "
                f"restored out of band; restore a matching backup pair"
            )
        if pidx.generation > g_meta + 1:
            raise UserInputError(
                f"federated index: partition {pid} is {pidx.generation - g_meta} "
                f"generations ahead of the meta-manifest — partitions of a "
                f"federation must only be updated THROUGH `index update` on "
                f"the federation root"
            )
        if pidx.generation == g_meta and e.get("manifest_crc") is not None:
            crc = fedmeta.manifest_crc(pdir)
            if crc is not None and int(crc) != int(e["manifest_crc"]):
                raise UserInputError(
                    f"federated index: partition {pid}'s manifest checksum "
                    f"does not match what the meta-manifest was published "
                    f"against — the partition was swapped out from under "
                    f"the federation"
                )
        if pidx.n < n_p:
            raise UserInputError(
                f"federated index: partition {pid} holds {pidx.n} genomes "
                f"but the meta-manifest records {n_p}"
            )
        loaded[pid] = _truncate_partition(pidx, n_p)

    # 2. union state (mapping + labels) -----------------------------------
    n = int(m["n_genomes"])
    state = None
    if m.get("state"):
        state = _read_npz_or_refuse(store.abspath(m["state"]), "union state", location, heal)
        if state is None and not heal:
            raise UserInputError(
                f"federated index union state {store.abspath(m['state'])} is "
                f"missing; run `drep-tpu index update {location}` to heal"
            )

    cross_entries = list(m.get("cross_shards", ()))
    cross_payloads = [
        _read_npz_or_refuse(store.abspath(e["file"]), "cross shard", location, heal) for e in cross_entries
    ]
    for e, z in zip(cross_entries, cross_payloads):
        if z is None and not heal:
            raise UserInputError(
                f"federated index cross shard {store.abspath(e['file'])} is "
                f"missing; classify/serve are read-only — run `drep-tpu "
                f"index update {location}` to heal the store first"
            )

    if state is not None:
        part_of = state["part_of"].astype(np.int64)
        local_of = state["local_of"].astype(np.int64)
    else:
        # heal: the mapping's redundant copy lives range-sliced in the
        # cross shards, all of which must then be readable
        parts_map: list[np.ndarray] = []
        locals_map: list[np.ndarray] = []
        for e, z in zip(cross_entries, cross_payloads):
            if z is None:
                raise UserInputError(
                    f"federated index at {location}: the union state AND "
                    f"cross shard {e['file']} are both unreadable — the "
                    f"double fault the federation's redundancy cannot "
                    f"cover. Rebuild the federation."
                )
            parts_map.append(z["map_pid"].astype(np.int64))
            locals_map.append(z["map_local"].astype(np.int64))
        part_of = np.concatenate(parts_map) if parts_map else np.empty(0, np.int64)
        local_of = np.concatenate(locals_map) if locals_map else np.empty(0, np.int64)
    if len(part_of) != n:
        raise UserInputError(
            f"federated index at {location}: union mapping covers "
            f"{len(part_of)} genomes but the meta-manifest records {n}"
        )

    # 3. union assembly ----------------------------------------------------
    names: list = [None] * n
    locations_l: list = [None] * n
    bottom: list = [None] * n
    scaled: list = [None] * n
    admitted = np.zeros(n, np.int64)
    stats = {c: np.zeros(n, np.int64) for c in _STAT_COLS}
    l2u: dict[int, np.ndarray] = {}
    for pid, pidx in loaded.items():
        if pidx is None:
            continue
        sel = np.nonzero(part_of == pid)[0]
        locs = local_of[sel]
        arr = np.full(pidx.n, -1, np.int64)
        arr[locs] = sel
        l2u[pid] = arr
        for c in _STAT_COLS:
            stats[c][sel] = pidx.gdb[c].to_numpy()[locs]
        for u, loc in zip(sel, locs):
            names[u] = pidx.names[loc]
            locations_l[u] = pidx.locations[loc]
            bottom[u] = pidx.bottom[loc]
            scaled[u] = pidx.scaled[loc]
    missing = [g for g in range(n) if names[g] is None]
    if missing:
        raise UserInputError(
            f"federated index at {location}: union slot(s) {missing[:5]} "
            f"resolve to no partition genome — meta/mapping mismatch"
        )

    parts_ii: list[np.ndarray] = []
    parts_jj: list[np.ndarray] = []
    parts_dd: list[np.ndarray] = []
    for pid in sorted(loaded):
        pidx = loaded[pid]
        if pidx is None or not len(pidx.edges[0]):
            continue
        ii, jj, dd = pidx.edges
        parts_ii.append(l2u[pid][ii])
        parts_jj.append(l2u[pid][jj])
        parts_dd.append(dd)

    idx = LoadedIndex(
        location=store.location, params=params, generation=gen,
        names=[str(x) for x in names],
        locations=[str(x) for x in locations_l],
        gdb=pd.DataFrame({"genome": [str(x) for x in names], **stats}),
        admitted=admitted, bottom=bottom, scaled=scaled,
        edges=_empty_edges(),
        primary=np.zeros(n, np.int64), suffix=np.zeros(n, np.int64),
        score=np.zeros(n, np.float64),
        winners=pd.DataFrame({"cluster": [], "genome": [], "score": []}),
        healed=healed,
    )
    idx.fed_part_of = part_of  # type: ignore[attr-defined]
    idx.fed_local_of = local_of  # type: ignore[attr-defined]
    idx.fed_meta = m  # type: ignore[attr-defined]

    # 4. cross shards (a rotted one recomputes now that bottoms are here) -
    for e, z in zip(cross_entries, cross_payloads):
        lo, hi = int(e["lo"]), int(e["hi"])
        if z is None:
            logger.warning("federated index: recomputing cross range [%d, %d) to heal %s", lo, hi, e["file"])
            ci, cj = cross_candidates(bottom, part_of, min_col=lo)
            keep_range = cj < hi
            ui, uj, dd, _pairs = cross_edges(idx, part_of, ci[keep_range], cj[keep_range], min_col=lo,
                                             device=device)
            store.write_cross_shard(e["file"], ui, uj, dd, part_of[lo:hi], local_of[lo:hi])
            healed.append(e["file"])
        else:
            ui = z["ii"].astype(np.int64)
            uj = z["jj"].astype(np.int64)
            dd = z["dist"].astype(np.float32)
        parts_ii.append(ui)
        parts_jj.append(uj)
        parts_dd.append(dd)

    # the union edge order: one global lexsort, however the shards came
    if parts_ii:
        ii = np.concatenate(parts_ii)
        jj = np.concatenate(parts_jj)
        dd = np.concatenate(parts_dd)
        order = np.lexsort((jj, ii))
        idx.edges = (ii[order], jj[order], dd[order])

    # 5. union derived state ----------------------------------------------
    if state is not None:
        idx.admitted = state["admitted_generation"].astype(np.int64)
        idx.primary = state["primary"].astype(np.int64)
        idx.suffix = state["suffix"].astype(np.int64)
        idx.score = state["score"].astype(np.float64)
        idx.winners = pd.DataFrame(
            {
                "cluster": [str(x) for x in state["winner_cluster"]],
                "genome": [str(x) for x in state["winner_genome"]],
                "score": state["winner_score"].astype(np.float64),
            }
        )
    else:
        # admission generations are recoverable per cross-shard range
        for e in cross_entries:
            idx.admitted[int(e["lo"]): int(e["hi"])] = int(e["generation"])
        idx.state_missing = True  # the caller (fed_update) reclusters the union
    return idx


# ---------------------------------------------------------------------------
# build, the params handoff, partition helpers
# ---------------------------------------------------------------------------


def build_federated(location: str, genome_paths: list[str], partitions: int, processes: int = 1,
                    fed_pods: int | None = None, device=None, **kwargs) -> dict:
    """`index build --partitions N`: create a federated index and admit
    the whole input set as federation generation 0, on `device` (default
    cuda; the CPU only when asked). The build is an empty-skeleton meta
    publish followed by one federated update, so a killed build resumes
    through `index update <root> -g <same paths>`."""
    from drep_tpu_torch.device import resolve_device
    from drep_tpu_torch.index.build import resolve_params

    dev = resolve_device(device)
    store = FederationStore(location)
    if store.exists() or IndexStore(location).exists():
        raise UserInputError(
            f"{location} already holds an index; `index update` grows it — "
            f"build refuses to overwrite"
        )
    params = resolve_params(**kwargs)
    bounds = fedmeta.partition_bounds(partitions)
    skeleton = {
        "format": fedmeta.FED_FORMAT,
        "generation": -1,
        "n_genomes": 0,
        "n_partitions": int(partitions),
        "params": params,
        "partitions": [
            {
                "pid": p,
                "dir": fedmeta.partition_dir_name(p),
                "range": [int(lo), int(hi)],
                "generation": -1,
                "n_genomes": 0,
                "manifest_crc": None,
            }
            for p, (lo, hi) in enumerate(bounds)
        ],
        "cross_shards": [],
        "state": None,
    }
    store.ensure_dirs()
    store.publish_meta(skeleton)
    summary = fed_update(location, genome_paths, processes=processes, fed_pods=fed_pods, device=dev)
    get_logger().info(
        "index build: federated %d genomes over %d partitions -> %s (federation generation 0)",
        summary.get("n_genomes", 0), partitions, location,
    )
    return summary


def write_params_handoff(path: str, params: dict, batch: pd.DataFrame, results: dict[str, dict]) -> None:
    """The router -> partition-pod handoff: the routed batch's sketches
    and the federation's pinned params in one checked npz, so a pod
    neither re-sketches nor needs the CLI to express the params."""
    import json

    from drep_tpu_torch.ingest import pack_ragged
    from drep_tpu_torch.utils.durableio import atomic_savez

    names = list(batch["genome"])
    payload: dict[str, np.ndarray] = {
        "names": np.array(names, dtype=str),
        "locations": np.array(list(batch["location"]), dtype=str),
        "params_json": np.array(json.dumps(params, sort_keys=True)),
    }
    for c in _STAT_COLS:
        payload[c] = np.array([results[g][c] for g in names], np.int64)
    for key in ("bottom", "scaled"):
        payload[key], payload[f"{key}_offsets"] = pack_ragged([results[g][key] for g in names])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_savez(path, **payload)


def read_params_handoff(path: str) -> dict:
    """A :func:`write_params_handoff` file back as {"params", "batch",
    "results"}, the shapes ``sketch_batch`` returns."""
    import json

    from drep_tpu_torch.ingest import unpack_ragged
    from drep_tpu_torch.utils.durableio import load_npz_checked

    z = load_npz_checked(path, what="params handoff")
    names = [str(x) for x in z["names"]]
    bottom = unpack_ragged(z["bottom"], z["bottom_offsets"], len(names))
    scaled = unpack_ragged(z["scaled"], z["scaled_offsets"], len(names))
    results = {
        g: {"bottom": bottom[i], "scaled": scaled[i], **{c: int(z[c][i]) for c in _STAT_COLS}}
        for i, g in enumerate(names)
    }
    batch = pd.DataFrame({"genome": names, "location": [str(x) for x in z["locations"]]})
    return {"params": json.loads(str(z["params_json"])), "batch": batch, "results": results}


def _build_partition(part_dir: str, params: dict, batch: pd.DataFrame, results: dict, processes: int,
                     device=None) -> None:
    """An empty partition's generation 0 under the federation's pinned
    params and the router's sketches."""
    from drep_tpu_torch.index.update import materialize_generation0

    materialize_generation0(IndexStore(part_dir), params, batch, results, processes=processes, device=device)


def _partition_generation(part_dir: str) -> int:
    """The partition's manifest generation, -1 when it has no store yet."""
    store = IndexStore(part_dir)
    if not store.exists():
        return -1
    return int(store.read_manifest()["generation"])


def _partition_names(part_dir: str, lo: int = 0) -> list[str]:
    """Genome names at index >= `lo`, read from only the sketch shards
    that reach there (the resume check's tail probe)."""
    from drep_tpu_torch.utils import durableio

    store = IndexStore(part_dir)
    names: list[str] = []
    for e in store.read_manifest()["sketch_shards"]:
        if int(e["hi"]) <= lo:
            continue
        z = durableio.load_npz_checked(store.abspath(e["file"]), what="sketch shard")
        names.extend(str(x) for i, x in enumerate(z["names"], start=int(e["lo"])) if i >= lo)
    return names


def _run_pods(jobs: list[tuple[int, str, str, dict]], pods: int, processes: int, device) -> dict[int, object]:
    """Run partition updates as `python -m drep_tpu_torch index update`
    pods on `device`, up to `pods` at once, each fed by its
    ``--params_file`` handoff. The kernels are built here first, so pods
    load them and never run nvcc side by side. A pod's output goes to a
    temp file (an undrained pipe would block a chatty pod). Returns
    {pid: returncode}."""
    import tempfile

    if device.type == "cuda":
        from drep_tpu_torch.ops import _build

        _build.build_all()
    logger = get_logger()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    queue = list(jobs)
    running: dict[int, tuple[subprocess.Popen, object]] = {}
    results: dict[int, object] = {}
    while queue or running:
        while queue and len(running) < max(1, pods):
            pid, part_dir, handoff, prune_flags = queue.pop(0)
            cmd = [sys.executable, "-m", "drep_tpu_torch", "index", "update", part_dir,
                   "--params_file", handoff, "-p", str(processes), "--device", device.type]
            for flag, val in prune_flags.items():
                if val:
                    cmd += [f"--{flag}", str(val)]
            logger.info("federated update: launching pod for partition %d (sketches ride the params handoff %s)",
                        pid, os.path.basename(handoff))
            log = tempfile.TemporaryFile(mode="w+")
            proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log, text=True)
            running[pid] = (proc, log)
        for pid, (proc, log) in list(running.items()):
            rc = proc.poll()
            if rc is None:
                continue
            log.seek(0)
            out = log.read()
            log.close()
            results[pid] = rc
            del running[pid]
            if rc != 0:
                logger.error("federated update: partition %d pod failed (rc=%d):\n%s", pid, rc, out[-2000:])
        if running:
            time.sleep(0.05)
    return results


def _routed_batches(batch: pd.DataFrame, results: dict[str, dict], bounds: list) -> dict[int, pd.DataFrame]:
    """The sketched batch routed to partitions by range code, in batch
    order within each partition (the admission order a resume repeats)."""
    pids = [fedmeta.route_partition(fedmeta.route_code(results[g]["bottom"]), bounds) for g in batch["genome"]]
    out: dict[int, pd.DataFrame] = {}
    for pid in sorted(set(pids)):
        sel = [p == pid for p in pids]
        out[pid] = batch[sel].reset_index(drop=True)
    return out


def _publish_unavailable_meta(store: FederationStore, m: dict, pid: int, reason: str,
                              genome_paths: list[str] | None, logger) -> dict:
    """The degraded but honest partial meta: the same generation, the
    unreadable partition stamped ``partial.partitions_unavailable``, this
    batch's genomes recorded unadmitted. A repeat merges into the stamp."""
    partial = dict(m.get("partial") or {})
    unavailable = sorted(set(partial.get("partitions_unavailable", ())) | {pid})
    partial["partitions_unavailable"] = unavailable
    partial["reason"] = reason
    if genome_paths:
        partial["unadmitted"] = sorted(
            set(partial.get("unadmitted", ())) | {os.path.basename(p) for p in genome_paths}
        )
    m2 = dict(m)
    m2["partial"] = partial
    store.publish_meta(m2)
    logger.error(
        "federated update: partition %d is unreadable — publishing a "
        "DEGRADED meta at generation %d (partitions_unavailable=%s, %d "
        "genome(s) unadmitted). Heal the partition and re-run `index "
        "update` — a clean heal pass clears the stamp. %s",
        pid, int(m.get("generation", -1)), unavailable, len(partial.get("unadmitted", ())), reason,
    )
    return {
        "admitted": 0,
        "generation": int(m.get("generation", -1)),
        "n_partitions": int(m.get("n_partitions", 0)),
        "partitions_unavailable": unavailable,
        "unadmitted": list(partial.get("unadmitted", ())),
        "partial": partial,
    }


# ---------------------------------------------------------------------------
# the federated update
# ---------------------------------------------------------------------------


def fed_update(location: str, genome_paths: list[str] | None, processes: int = 1, fed_pods: int | None = None,
               primary_prune: str = "off", prune_bands: int = 0, prune_min_shared: int = 0,
               prune_join_chunk: int = 0, device=None) -> dict:
    """`index update` on a federated root, on `device` (default cuda; the
    CPU only when asked): sketch and route the batch, run one independent
    update per dirty partition (in process, or as `fed_pods` concurrent
    subprocess pods), join the boundary buckets across partitions,
    recluster the union's dirty components, and publish the next
    federation generation through the meta-manifest.

    A partition that fails stays at its old generation, its routed
    genomes are not admitted, and the meta carries a ``partial`` note
    naming them. With no genomes this is a heal pass over every
    partition and the federation families; the generation stays."""
    from drep_tpu_torch.device import resolve_device
    from drep_tpu_torch.index import maintenance as fedmaint
    from drep_tpu_torch.index import update as upd
    from drep_tpu_torch.parallel import streaming

    dev = resolve_device(device)
    logger = get_logger()
    STATS.clear()
    t0 = time.perf_counter()
    store = FederationStore(location)
    # converge an interrupted split, merge or compaction first: an update
    # never lands on a half-committed range map
    fedmaint.roll_forward(location, device=dev)
    m = store.read_meta()
    params = m["params"]
    gen = int(m["generation"])
    gen_new = gen + 1
    fed_pods = int(fed_pods or 0)
    try:
        union = load_federated(location, heal=True, device=dev)
    except UserInputError as err:
        bad_pid = getattr(err, "fed_partition", None)
        if bad_pid is None:
            raise
        # one unreadable partition degrades the update instead of refusing
        # it: nothing can be admitted (the cross edges need its sketches),
        # so the meta republishes at the same generation, stamped
        return _publish_unavailable_meta(store, m, int(bad_pid), str(err), genome_paths, logger)
    stale_unavail = (m.get("partial") or {}).get("partitions_unavailable")
    if stale_unavail:
        # every recorded partition loaded again: clear the stamp
        partial = dict(m["partial"])
        partial.pop("partitions_unavailable", None)
        partial.pop("reason", None)
        if not partial.get("failed_partitions"):
            partial.pop("unadmitted", None)
        m2 = dict(m)
        if partial:
            m2["partial"] = partial
        else:
            m2.pop("partial", None)
        store.publish_meta(m2)
        m = m2
        logger.warning(
            "federated index: previously unavailable partition(s) %s are "
            "readable again — PARTIAL stamp cleared at generation %d "
            "(genomes unadmitted during the window must be re-submitted)",
            stale_unavail, int(m.get("generation", -1)),
        )
    part_of = np.asarray(union.fed_part_of, np.int64)  # type: ignore[attr-defined]
    local_of = np.asarray(union.fed_local_of, np.int64)  # type: ignore[attr-defined]
    STATS["load_s"] = time.perf_counter() - t0

    batch = results = None
    if genome_paths:
        batch, results = sketch_batch(union, genome_paths, processes=processes)
    if batch is None or not len(batch):
        summary = {"admitted": 0, "generation": gen, "healed": union.healed, "n_partitions": int(m["n_partitions"])}
        if union.state_missing and union.n:
            summary.update(recluster(union, union.n, processes=processes, device=dev))
            store.write_fedstate(store.fedstate_name(gen), union, part_of, local_of)
            logger.warning("federated index: union state healed via full recompute")
        # the routing summary: a rotted or missing file recomputes from
        # the union, and the meta republishes at the same generation
        if union.n and gen >= 0:
            rt_rel = m.get("routing") or store.routing_name(gen)
            rt_ok = False
            if m.get("routing"):
                from drep_tpu_torch.utils import durableio

                try:
                    durableio.load_npz_checked(store.abspath(rt_rel), what="routing summary")
                    rt_ok = True
                except (OSError, durableio.CorruptPayloadError):
                    rt_ok = False
            if not rt_ok:
                store.ensure_dirs()
                store.write_routing_summary(rt_rel, union.bottom, part_of, int(m["n_partitions"]))
                summary["healed"] = list(summary["healed"]) + [rt_rel]
                if m.get("routing") != rt_rel:
                    m2 = dict(m)
                    m2["routing"] = rt_rel
                    store.publish_meta(m2)
                logger.info("federated heal pass: routing summary rewritten (%s)", rt_rel)
        if union.healed:
            logger.info("federated heal pass: repaired %s", union.healed)
        return summary

    bounds = [tuple(e["range"]) for e in m["partitions"]]
    meta_gen = {int(e["pid"]): int(e["generation"]) for e in m["partitions"]}
    meta_n = {int(e["pid"]): int(e["n_genomes"]) for e in m["partitions"]}
    meta_dir = {int(e["pid"]): store.abspath(e["dir"]) for e in m["partitions"]}
    routed = _routed_batches(batch, results, bounds)
    prune_flags = {
        "primary_prune": primary_prune if primary_prune != "off" else "",
        "prune_bands": prune_bands, "prune_min_shared": prune_min_shared,
        "prune_join_chunk": prune_join_chunk,
    }

    # -- per-partition resume/skip classification -------------------------
    # a partition ahead of the meta that this batch does not route to is a
    # killed earlier update: admitting another batch now would strand its
    # tail outside the union
    for e in m["partitions"]:
        pid = int(e["pid"])
        if pid in routed:
            continue
        if _partition_generation(meta_dir[pid]) > int(e["generation"]):
            raise UserInputError(
                f"federated index: partition {pid} is ahead of the "
                f"meta-manifest from an interrupted earlier update, and "
                f"this batch routes nothing to it — re-run the "
                f"interrupted update with ITS batch first (its admitted "
                f"tail must reach the union before a new batch lands)"
            )
    dirty: list[tuple[int, str, str]] = []  # (pid, part_dir, build|update)
    done: set[int] = set()
    for pid in sorted(routed):
        pdir = meta_dir.get(pid, store.partition_dir(pid))
        want = list(routed[pid]["genome"])
        actual_gen = _partition_generation(pdir)
        base_n = meta_n[pid]
        if meta_gen[pid] < 0:
            if actual_gen < 0:
                dirty.append((pid, pdir, "build"))
            elif actual_gen == 0 and sorted(_partition_names(pdir)) == sorted(want):
                done.add(pid)  # a killed earlier attempt already materialized it
            else:
                raise UserInputError(
                    f"federated index: empty partition {pid} holds an "
                    f"unexpected store (generation {actual_gen}) — it was "
                    f"written out of band, or a DIFFERENT interrupted batch "
                    f"materialized it; re-run that batch first, or remove "
                    f"{pdir} / restore the federation backup"
                )
        elif actual_gen == meta_gen[pid]:
            dirty.append((pid, pdir, "update"))
        elif actual_gen == meta_gen[pid] + 1 and sorted(_partition_names(pdir, lo=base_n)) == sorted(want):
            done.add(pid)  # a killed earlier attempt already admitted the batch
        else:
            raise UserInputError(
                f"federated index: partition {pid} is at generation "
                f"{actual_gen} (meta records {meta_gen[pid]}) with a tail "
                f"that does not match this batch — it was updated out of "
                f"band, or a different batch is being resumed"
            )

    # -- the dirty partitions, as independent units -----------------------
    # partitions take the router's sketches: in process through
    # `presketched`, pods through a `--params_file` handoff that also
    # carries the pinned params (so a build runs as a pod too)
    failed: dict[int, str] = {}
    per_part: dict[int, dict] = {}
    if fed_pods > 0 and dirty:
        store.ensure_dirs()
        jobs: list[tuple[int, str, str, dict]] = []
        handoffs: list[str] = []
        for pid, pdir, _kind in dirty:
            handoff = store.abspath(os.path.join("log", f"handoff_p{pid:03d}_g{gen_new:06d}.npz"))
            write_params_handoff(handoff, params, routed[pid], results)
            handoffs.append(handoff)
            jobs.append((pid, pdir, handoff, prune_flags))
        tp = time.perf_counter()
        try:
            rcs = _run_pods(jobs, fed_pods, processes, dev)
        finally:
            for handoff in handoffs:
                with contextlib.suppress(OSError):
                    os.remove(handoff)
        STATS["pods_s"] = time.perf_counter() - tp
        STATS["pod_rcs"] = {int(p): rc for p, rc in rcs.items()}
        for pid, rc in rcs.items():
            if rc != 0:
                failed[pid] = f"pod exited rc={rc}" if isinstance(rc, int) else str(rc)
    else:
        for pid, pdir, kind in dirty:
            tp = time.perf_counter()
            try:
                if kind == "build":
                    _build_partition(pdir, params, routed[pid], results, processes, device=dev)
                else:
                    index_update(
                        pdir, None, processes=processes, primary_prune=primary_prune,
                        prune_bands=prune_bands, prune_min_shared=prune_min_shared,
                        prune_join_chunk=prune_join_chunk, presketched=(routed[pid], results), device=dev,
                    )
            except Exception as e:  # noqa: BLE001 — a partition's failure is tolerated: it
                # stays at its old generation (or absent) and the publish is partial
                failed[pid] = f"{type(e).__name__}: {e}"
                logger.error("federated update: partition %d %s failed: %s", pid, kind, e)
                continue
            per_part[pid] = {"op": kind, "n": len(routed[pid]), "s": time.perf_counter() - tp,
                             "rect_launches": upd.STATS.get("rect_launches", 0),
                             "secondary_calls": upd.STATS.get("secondary_calls", 0)}
    STATS["partitions"] = per_part
    STATS["failed"] = dict(failed)

    succeeded = sorted((set(routed) - set(failed)) | done)
    if not succeeded:
        raise UserInputError(
            f"federated update: every dirty partition failed "
            f"({sorted(failed)}) — nothing to publish. Per-partition "
            f"errors: {failed}"
        )

    # -- append the admitted tails to the union ---------------------------
    n_old = union.n
    part_of_l = list(part_of)
    local_of_l = list(local_of)
    new_intra: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    unadmitted: list[str] = []
    for pid in sorted(routed):
        if pid in failed:
            unadmitted.extend(routed[pid]["genome"])
            continue
        pdir = meta_dir[pid]
        pidx = load_index(pdir)
        base_n = meta_n[pid]
        tail = list(range(base_n, pidx.n))
        want = sorted(routed[pid]["genome"])
        if sorted(pidx.names[base_n:]) != want:
            raise UserInputError(
                f"federated update: partition {pid} admitted "
                f"{pidx.names[base_n:]} but this batch routed {want} — "
                f"concurrent out-of-band update detected"
            )
        # the union admission order is (pid, local) over this batch:
        # deterministic, so a killed run's rerun repeats it
        l2u = np.full(pidx.n, -1, np.int64)
        sel = np.nonzero(part_of == pid)[0]
        l2u[local_of[sel]] = sel
        for loc in tail:
            l2u[loc] = len(part_of_l)
            part_of_l.append(pid)
            local_of_l.append(loc)
            union.names.append(pidx.names[loc])
            union.locations.append(pidx.locations[loc])
            union.bottom.append(pidx.bottom[loc])
            union.scaled.append(pidx.scaled[loc])
        rows = pidx.gdb.iloc[tail][["genome", *_STAT_COLS]]
        union.gdb = pd.concat([union.gdb, rows], ignore_index=True)
        union.admitted = np.concatenate([union.admitted, np.full(len(tail), gen_new, np.int64)])
        ii, jj, dd = pidx.edges
        sel_new = jj >= base_n
        new_intra.append((l2u[ii[sel_new]], l2u[jj[sel_new]], dd[sel_new]))
    part_of = np.asarray(part_of_l, np.int64)
    local_of = np.asarray(local_of_l, np.int64)
    admitted_k = union.n - n_old

    # -- the boundary-bucket cross join over the grown union --------------
    tj = time.perf_counter()
    ci, cj = cross_candidates(union.bottom, part_of, min_col=n_old)
    tw = time.perf_counter()
    xi, xj, xd, cross_pairs = cross_edges(union, part_of, ci, cj, min_col=n_old, device=dev)
    STATS.update(join_s=tw - tj, cross_candidates=int(len(ci)), walk_s=time.perf_counter() - tw,
                 cross_pairs=int(cross_pairs), cross_launches=streaming.STATS.get("launches", 0) if len(ci) else 0)
    ii = np.concatenate([union.edges[0], *(e[0] for e in new_intra), xi])
    jj = np.concatenate([union.edges[1], *(e[1] for e in new_intra), xj])
    dd = np.concatenate([union.edges[2], *(e[2] for e in new_intra), xd])
    order = np.lexsort((jj, ii))
    union.edges = (ii[order], jj[order], dd[order])

    tr = time.perf_counter()
    summary = recluster(union, n_old, processes=processes, device=dev)
    STATS.update(recluster_s=time.perf_counter() - tr, union_secondary_calls=upd.STATS.get("secondary_calls", 0))

    # -- publish: cross shard, union state and routing first, the meta last
    tpub = time.perf_counter()
    store.ensure_dirs()
    cr_rel = store.cross_shard_name(gen_new)
    st_rel = store.fedstate_name(gen_new)
    rt_rel = store.routing_name(gen_new)
    store.write_cross_shard(cr_rel, xi, xj, xd, part_of[n_old:], local_of[n_old:])
    union.generation = gen_new
    store.write_fedstate(st_rel, union, part_of, local_of)
    store.write_routing_summary(rt_rel, union.bottom, part_of, int(m["n_partitions"]))
    new_n = {pid: meta_n[pid] for pid in meta_n}
    new_gen = dict(meta_gen)
    for pid in sorted(routed):
        if pid in failed:
            continue
        new_gen[pid] = max(meta_gen[pid] + 1, 0)
        new_n[pid] = meta_n[pid] + len(routed[pid])
    meta_new = {
        "format": fedmeta.FED_FORMAT,
        "generation": gen_new,
        "n_genomes": union.n,
        "n_partitions": int(m["n_partitions"]),
        "params": params,
        "partitions": [
            {
                "pid": int(e["pid"]),
                "dir": e["dir"],
                "range": [int(e["range"][0]), int(e["range"][1])],
                "generation": new_gen[int(e["pid"])],
                "n_genomes": new_n[int(e["pid"])],
                "manifest_crc": (
                    fedmeta.manifest_crc(store.abspath(e["dir"])) if new_n[int(e["pid"])] > 0 else None
                ),
            }
            for e in m["partitions"]
        ],
        "cross_shards": list(m.get("cross_shards", ()))
        + [{"file": cr_rel, "lo": n_old, "hi": union.n, "generation": gen_new}],
        "state": st_rel,
        "routing": rt_rel,
    }
    if failed:
        meta_new["partial"] = {"failed_partitions": sorted(failed), "unadmitted": sorted(unadmitted)}
    store.publish_meta(meta_new)
    store.gc_states(st_rel, rt_rel)
    STATS.update(publish_s=time.perf_counter() - tpub, total_s=time.perf_counter() - t0)

    summary.update(
        {
            "admitted": admitted_k,
            "n_genomes": union.n,
            "generation": gen_new,
            "n_partitions": int(m["n_partitions"]),
            "partitions_updated": succeeded,
            "partitions_failed": sorted(failed),
            "unadmitted": sorted(unadmitted),
            "cross_edges": int(len(xi)),
            "cross_pairs_compared": cross_pairs,
            "healed": union.healed,
        }
    )
    logger.info(
        "federated update: +%d genomes over %d partition(s) -> federation "
        "generation %d (%d genomes, %d cross edge(s)%s)",
        admitted_k, len(succeeded), gen_new, union.n, len(xi),
        f"; PARTIAL — {len(unadmitted)} genome(s) unadmitted in partition(s) {sorted(failed)}" if failed else "",
    )
    return summary
