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
                                     (ops/rangepart.py), the serving
                                     resident's and router's routing.

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

Serving: union assembly (:func:`load_federated`) is the oracle path; a
serve replica runs the streaming per-partition classify instead
(:class:`FederatedResident`, :func:`classify_batch_federated`: routing
by coarse code, LRU partition residency, a partition health state
machine, PARTIAL verdicts), held to the union path's verdicts.

The JAX package's fault sites fire at its points: ``partition_update``
before each partition's in-process update or pod launch (a failure there
leaves that partition at its old generation and the publish partial),
``partition_load`` and ``partition_classify`` inside a served
partition's load and consult (a failure books the partition suspect,
then quarantined). With tracing on, the resident's load and consult are
``partition_load`` / ``partition_classify`` spans and its health
transitions instants, as are each partition's update
(``federation_partition``) and a partial meta's publish and clearing.
Knobs: ``DREP_TORCH_FED_PODS``, ``_FED_SHARD_MAX``,
``_SERVE_RESIDENT_MB``, ``_SERVE_PROBE_BACKOFF_S``, ``_SERVE_PROBE_MAX_S``.
``STATS`` holds the last federated update's seconds, pairs and
per-partition launches, and a resident's ``work`` its compares' and
reclusters'.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import meta as fedmeta
from drep_tpu_torch.index.store import _STAT_COLS, IndexStore, LoadedIndex, empty_index, load_index
from drep_tpu_torch.index.update import _admit_batch, _retention, index_update, recluster, sketch_batch
from drep_tpu_torch.utils import envknobs, faults, telemetry
from drep_tpu_torch.utils.logger import get_logger


# the boundary join's widest repacked band-code bucket a range shard
# (pow2; rangepart.partition_by_range), the JAX package's default

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
        for _origin, buckets in rangepart.partition_by_range(mats, envknobs.env_int("DREP_TORCH_FED_SHARD_MAX")):
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
# the streaming serving view: FederatedResident
# ---------------------------------------------------------------------------
# A serve replica of a federated root holds the cheap spine (meta, union
# state, cross shards, each partition's names, stats and intra edges: no
# sketch payloads), routes each query to the partitions whose genomes can
# share a band code with it (the routing summary, recall 1.0), loads only
# the consulted partitions' sketches (LRU under a byte budget), runs one
# rectangle [partition | queries] each (the Mash kernel, one launch a row
# stripe) and merges the per-partition edges into per-query verdicts
# through the recluster one-shot classify runs, so the verdicts equal the
# union-assembled classify's. A partition that fails to load or to
# compare moves through healthy -> suspect -> quarantined (bounded-backoff
# reload probes); the queries it touches get PARTIAL verdicts stamped
# ``partitions_consulted`` / ``partitions_unavailable``, never an
# exception out of the daemon, and never a CPU or plain-version retry.

PARTITION_HEALTHY = "healthy"
PARTITION_SUSPECT = "suspect"
PARTITION_QUARANTINED = "quarantined"



@dataclass
class _PartitionSlot:
    """One partition's health + residency bookkeeping in a serve replica."""

    pid: int
    dir: str
    range: tuple[int, int]
    meta_generation: int
    n: int  # genome count at the federation generation (meta-recorded)
    state: str = PARTITION_HEALTHY
    reason: str | None = None  # the partition_refusal text of the last failure
    failures: int = 0  # consecutive
    backoff_s: float = 0.0
    next_probe_mono: float = 0.0
    last_probe_mono: float | None = None
    # spine (loaded once): union slots in partition-local order, intra edges
    u_of_local: np.ndarray | None = None
    intra: tuple | None = None  # union-coordinate (ii, jj, dd)
    # the lazily loaded sketch payload
    resident: bool = False
    resident_bytes: int = 0
    last_used: int = 0
    loads: int = 0


class FederatedResident:
    """The streaming serving view of a federated index.

    Stands in for the resident ``LoadedIndex`` where the serve tier needs
    it (``.params``, ``.generation``, ``.n``, ``.names``, ``.location``),
    but holds sketch payloads per partition under an LRU byte budget
    (`resident_mb`; None or 0: no budget) and contains a partition's
    failure at the partition boundary. Construction refuses only what
    leaves nothing answerable: an empty skeleton, a missing or corrupt
    union state or cross shard. The per-partition compares and the
    recluster run on `device` (default cuda; the CPU only when asked).

    ``work`` holds this resident's compares (``compares``, ``stripes``:
    Mash kernel launches, ``pack_s``, ``walk_s``) and reclusters
    (``reclusters``, ``secondary_calls``: fused indicator launches,
    ``recluster_s``), read by chip_smoke.py.
    """

    def __init__(self, location: str, resident_mb: int | None = None, probe_backoff_s: float | None = None,
                 probe_max_s: float | None = None, device=None):
        from drep_tpu_torch.device import resolve_device

        logger = get_logger()
        self.device = resolve_device(device)
        self.store = FederationStore(location)
        self.location = self.store.location
        m = self.store.read_meta()
        if int(m["generation"]) < 0:
            raise UserInputError(
                f"federated index at {location} is an empty skeleton "
                f"(generation -1) — finish the initial `drep-tpu index "
                f"update {location} -g ...` before serving from it"
            )
        self.fed_meta = m
        self.params = m["params"]
        self.generation = int(m["generation"])
        # None: the DREP_TORCH_SERVE_* knob
        if resident_mb is None:
            resident_mb = envknobs.env_int("DREP_TORCH_SERVE_RESIDENT_MB")
        self.budget_bytes = int(resident_mb) << 20 if resident_mb else 0
        self.probe_backoff_s = (envknobs.env_float("DREP_TORCH_SERVE_PROBE_BACKOFF_S")
                                if probe_backoff_s is None else float(probe_backoff_s))
        self.probe_max_s = envknobs.env_float("DREP_TORCH_SERVE_PROBE_MAX_S") if probe_max_s is None else float(probe_max_s)
        self.stats = {"loads": 0, "evictions": 0, "recoveries": 0, "peak_resident_partitions": 0}
        self.work = {"compares": 0, "stripes": 0, "pack_s": 0.0, "walk_s": 0.0, "reclusters": 0,
                     "secondary_calls": 0, "recluster_s": 0.0}
        self._tick = 0
        self._resident_total = 0
        self._edge_cache: dict[frozenset, tuple] = {}

        # the union state: nothing is answerable without it
        n = int(m["n_genomes"])
        state = _read_npz_or_refuse(
            self.store.abspath(m["state"]), "union state", location, heal=False
        ) if m.get("state") else None
        if state is None:
            raise UserInputError(
                f"federated index union state under {location} is missing or "
                f"was never published; serve is read-only — run `drep-tpu "
                f"index update {location}` to heal the store first"
            )
        self.part_of = state["part_of"].astype(np.int64)
        self.local_of = state["local_of"].astype(np.int64)
        if len(self.part_of) != n:
            raise UserInputError(
                f"federated index at {location}: union mapping covers "
                f"{len(self.part_of)} genomes but the meta-manifest records {n}"
            )

        # the cross shards (federation-level, required like the state)
        cross_ii: list[np.ndarray] = []
        cross_jj: list[np.ndarray] = []
        cross_dd: list[np.ndarray] = []
        for e in m.get("cross_shards", ()):
            z = _read_npz_or_refuse(self.store.abspath(e["file"]), "cross shard", location, heal=False)
            if z is None:
                raise UserInputError(
                    f"federated index cross shard {self.store.abspath(e['file'])} "
                    f"is missing; serve is read-only — run `drep-tpu index "
                    f"update {location}` to heal the store first"
                )
            cross_ii.append(z["ii"].astype(np.int64))
            cross_jj.append(z["jj"].astype(np.int64))
            cross_dd.append(z["dist"].astype(np.float32))
        self._cross = (
            np.concatenate(cross_ii) if cross_ii else np.empty(0, np.int64),
            np.concatenate(cross_jj) if cross_jj else np.empty(0, np.int64),
            np.concatenate(cross_dd) if cross_dd else np.empty(0, np.float32),
        )
        self._cross_pi = self.part_of[self._cross[0]] if len(self._cross[0]) else np.empty(0, np.int64)
        self._cross_pj = self.part_of[self._cross[1]] if len(self._cross[1]) else np.empty(0, np.int64)

        # the routing summaries (optional: absent or corrupt -> consult all)
        self._route_bitmaps = self._route_bits = None
        if m.get("routing"):
            try:
                from drep_tpu_torch.utils import durableio

                z = durableio.load_npz_checked(self.store.abspath(m["routing"]), what="routing summary")
                self._route_bitmaps = z["bitmaps"].astype(np.uint64)
                self._route_bits = int(z["bits"])
            except Exception as err:  # noqa: BLE001 — routing only prunes: losing it consults all
                logger.warning(
                    "federated serve: routing summary unreadable (%s) — "
                    "every query consults every partition until the next "
                    "`index update` rewrites it", err,
                )

        # each partition's spine (contained: a failure quarantines it)
        self._stats_arrays = {c: np.zeros(n, np.int64) for c in _STAT_COLS}
        names: list[str] = [f"?part?:{int(p)}:{int(l)}" for p, l in zip(self.part_of, self.local_of)]
        locations: list[str] = [""] * n
        self._slots: dict[int, _PartitionSlot] = {}
        for e in m["partitions"]:
            pid = int(e["pid"])
            slot = _PartitionSlot(
                pid=pid, dir=e["dir"], range=(int(e["range"][0]), int(e["range"][1])),
                meta_generation=int(e["generation"]), n=int(e["n_genomes"]),
            )
            self._slots[pid] = slot
            if slot.n <= 0:
                continue
            try:
                self._load_spine(slot, names, locations)
            except Exception as err:  # noqa: BLE001 — one damaged partition must not take the replica down
                self._book_failure(slot, err, during="spine")

        admitted = np.zeros(n, np.int64)
        for e in m.get("cross_shards", ()):
            admitted[int(e["lo"]): int(e["hi"])] = int(e["generation"])
        self.union = LoadedIndex(
            location=self.location, params=self.params, generation=self.generation,
            names=names, locations=locations,
            gdb=pd.DataFrame({"genome": list(names), **self._stats_arrays}),
            admitted=admitted, bottom=[None] * n, scaled=[None] * n,
            edges=_empty_edges(),
            primary=state["primary"].astype(np.int64),
            suffix=state["suffix"].astype(np.int64),
            score=state["score"].astype(np.float64),
            winners=pd.DataFrame(
                {
                    "cluster": [str(x) for x in state["winner_cluster"]],
                    "genome": [str(x) for x in state["winner_genome"]],
                    "score": state["winner_score"].astype(np.float64),
                }
            ),
        )
        quarantined = sorted(p for p, s in self._slots.items() if s.state == PARTITION_QUARANTINED)
        logger.info(
            "federated serve: generation %d spine resident (%d genomes over "
            "%d partitions, 0 sketch payloads loaded%s)",
            self.generation, n, len(self._slots),
            f"; QUARANTINED at startup: {quarantined}" if quarantined else "",
        )

    # ---- LoadedIndex-compatible surface ---------------------------------
    @property
    def n(self) -> int:
        return len(self.union.names)

    @property
    def names(self) -> list[str]:
        return self.union.names

    # ---- spine / residency loads ----------------------------------------
    def _partition_manifest(self, slot: _PartitionSlot) -> dict:
        """The partition's current manifest, re-read on every residency
        load with the identity checks the union assembly applies: a
        rollback, an out-of-band swap or rot lands here, at consult time,
        as a containable failure."""
        pdir = os.path.join(self.location, slot.dir)
        manifest = IndexStore(pdir).read_manifest()
        g_meta = slot.meta_generation
        actual = int(manifest["generation"])
        if actual < g_meta:
            raise UserInputError(
                f"partition store is at generation {actual} but the "
                f"meta-manifest recorded {g_meta} — rolled back or restored "
                f"out of band"
            )
        if actual > g_meta + 1:
            raise UserInputError(
                f"partition store is {actual - g_meta} generations ahead of "
                f"the meta-manifest — updated outside `index update` on the "
                f"federation root"
            )
        e = next(e for e in self.fed_meta["partitions"] if int(e["pid"]) == slot.pid)
        if actual == g_meta and e.get("manifest_crc") is not None:
            crc = fedmeta.manifest_crc(pdir)
            if crc is not None and int(crc) != int(e["manifest_crc"]):
                raise UserInputError(
                    "partition manifest checksum does not match what the "
                    "meta-manifest was published against — swapped out from "
                    "under the federation"
                )
        if int(manifest["n_genomes"]) < slot.n:
            raise UserInputError(
                f"partition holds {manifest['n_genomes']} genomes but the "
                f"meta-manifest records {slot.n} — truncated by a stale meta"
            )
        return manifest

    def _load_spine(self, slot: _PartitionSlot, names: list, locations: list) -> None:
        """Names, locations, stats and intra edges of one partition: O(n_p)
        metadata, no sketch payloads (those load on first consult)."""
        from drep_tpu_torch.utils import durableio

        pdir = os.path.join(self.location, slot.dir)
        manifest = self._partition_manifest(slot)
        state = durableio.load_npz_checked(os.path.join(pdir, manifest["state"]), what="partition state")
        sel = np.nonzero(self.part_of == slot.pid)[0]
        locs = self.local_of[sel]
        u_of_local = np.full(slot.n, -1, np.int64)
        u_of_local[locs] = sel
        if (u_of_local < 0).any():
            raise UserInputError("union mapping does not cover every partition-local genome")
        p_names = [str(x) for x in state["names"][: slot.n]]
        p_locs = [str(x) for x in state["locations"][: slot.n]]
        for loc in range(slot.n):
            names[int(u_of_local[loc])] = p_names[loc]
            locations[int(u_of_local[loc])] = p_locs[loc]
        for c in _STAT_COLS:
            self._stats_arrays[c][sel] = state[c].astype(np.int64)[locs]
        ii_l: list[np.ndarray] = []
        jj_l: list[np.ndarray] = []
        dd_l: list[np.ndarray] = []
        for e in manifest["edge_shards"]:
            if int(e["lo"]) >= slot.n:
                continue  # published ahead of the meta: truncated out
            z = durableio.load_npz_checked(os.path.join(pdir, e["file"]), what="partition edge shard")
            ii, jj, dd = z["ii"].astype(np.int64), z["jj"].astype(np.int64), z["dist"].astype(np.float32)
            keep = jj < slot.n  # ii < jj: both endpoints inside the prefix
            ii_l.append(u_of_local[ii[keep]])
            jj_l.append(u_of_local[jj[keep]])
            dd_l.append(dd[keep])
        slot.u_of_local = u_of_local
        slot.intra = (
            np.concatenate(ii_l) if ii_l else np.empty(0, np.int64),
            np.concatenate(jj_l) if jj_l else np.empty(0, np.int64),
            np.concatenate(dd_l) if dd_l else np.empty(0, np.float32),
        )
        self._edge_cache.clear()

    def _load_sketches(self, slot: _PartitionSlot) -> None:
        from drep_tpu_torch.ingest import unpack_ragged
        from drep_tpu_torch.utils import durableio

        pdir = os.path.join(self.location, slot.dir)
        manifest = self._partition_manifest(slot)
        # stage everything before installing anything: a failure at the
        # second shard must leave union.bottom as it was (a partial
        # install would hold bytes outside the residency accounting)
        staged: list[tuple[int, np.ndarray, np.ndarray]] = []
        nbytes = 0
        for e in manifest["sketch_shards"]:
            lo = int(e["lo"])
            if lo >= slot.n:
                continue
            hi = min(int(e["hi"]), slot.n)
            z = durableio.load_npz_checked(os.path.join(pdir, e["file"]), what="partition sketch shard")
            m = int(e["hi"]) - lo
            bot = unpack_ragged(z["bottom"], z["bottom_offsets"], m)
            sca = unpack_ragged(z["scaled"], z["scaled_offsets"], m)
            for loc in range(lo, hi):
                staged.append((int(slot.u_of_local[loc]), bot[loc - lo], sca[loc - lo]))
                nbytes += bot[loc - lo].nbytes + sca[loc - lo].nbytes
        for u, b, s in staged:
            self.union.bottom[u] = b
            self.union.scaled[u] = s
        slot.resident_bytes = nbytes

    # ---- health state machine -------------------------------------------
    def _book_failure(self, slot: _PartitionSlot, err: BaseException, during: str) -> None:
        from drep_tpu_torch.utils.profiling import counters

        msg = partition_refusal(slot.pid, slot.range, slot.meta_generation, err)
        now = time.monotonic()
        slot.failures += 1
        slot.reason = msg
        slot.last_probe_mono = now
        self._drop_residency(slot)
        was = slot.state
        # spine damage goes straight to quarantine (a corrupt manifest
        # does not heal by an immediate retry); a load or compare failure
        # gets one suspect retry first
        if during == "spine" or was in (PARTITION_SUSPECT, PARTITION_QUARANTINED):
            slot.state = PARTITION_QUARANTINED
            slot.backoff_s = min(self.probe_max_s, max(self.probe_backoff_s, slot.backoff_s * 2.0))
            slot.next_probe_mono = now + slot.backoff_s
            if was != PARTITION_QUARANTINED:
                counters.add_fault("partition_quarantined")
            telemetry.event(
                "partition_quarantine", pid=slot.pid, during=during, reason=msg,
                heal_hint=partition_heal_hint(slot.pid), backoff_s=round(slot.backoff_s, 3),
            )
        else:
            slot.state = PARTITION_SUSPECT
        # the message carries the exception's text: on the card a failed
        # launch surfaces here (a CUDA error is sticky for the process)
        get_logger().warning(
            "federated serve: partition %d %s after a %s failure: %s",
            slot.pid, slot.state, during, msg,
        )

    def _mark_recovered(self, slot: _PartitionSlot) -> None:
        slot.state = PARTITION_HEALTHY
        slot.failures = 0
        slot.backoff_s = 0.0
        slot.reason = None
        self.stats["recoveries"] += 1
        telemetry.event("partition_recovered", pid=slot.pid, loads=slot.loads)
        get_logger().info(
            "federated serve: partition %d recovered (probe load succeeded) "
            "— full coverage restored for its range", slot.pid,
        )

    def _drop_residency(self, slot: _PartitionSlot) -> None:
        if not slot.resident:
            return
        for u in slot.u_of_local if slot.u_of_local is not None else ():
            self.union.bottom[int(u)] = None
            self.union.scaled[int(u)] = None
        self._resident_total -= slot.resident_bytes
        slot.resident = False
        slot.resident_bytes = 0

    def _evict(self, slot: _PartitionSlot) -> None:
        nbytes = slot.resident_bytes
        self._drop_residency(slot)
        self.stats["evictions"] += 1
        telemetry.event("partition_evict", pid=slot.pid, bytes=nbytes)

    def _evict_to_budget(self, pin: set[int]) -> None:
        from drep_tpu_torch.utils.profiling import counters

        resident = [s for s in self._slots.values() if s.resident]
        self.stats["peak_resident_partitions"] = max(self.stats["peak_resident_partitions"], len(resident))
        if self.budget_bytes:
            evictable = sorted((s for s in resident if s.pid not in pin), key=lambda s: s.last_used)
            while self._resident_total > self.budget_bytes and evictable:
                self._evict(evictable.pop(0))
        counters.set_gauge("serve_partitions_resident", float(sum(1 for s in self._slots.values() if s.resident)))
        counters.set_gauge("serve_resident_bytes", float(self._resident_total))

    def ensure_resident(self, pid: int, pin: frozenset | set = frozenset()) -> bool:
        """Make partition `pid`'s sketch payload resident (loading it on
        first consult, re-probing a quarantined partition once its backoff
        elapsed). False, the caller's PARTIAL verdict, when the partition
        is (or just became) unavailable."""
        slot = self._slots[pid]
        if slot.n <= 0:
            return True
        if slot.resident:
            self._tick += 1
            slot.last_used = self._tick
            return True
        now = time.monotonic()
        if slot.state == PARTITION_QUARANTINED and now < slot.next_probe_mono:
            return False
        probing = slot.state != PARTITION_HEALTHY
        try:
            with telemetry.span("partition_load", pid=pid, probe=probing):
                faults.fire("partition_load")
                if slot.u_of_local is None:
                    self._load_spine(slot, self.union.names, self.union.locations)
                    self.union.gdb = pd.DataFrame({"genome": list(self.union.names), **self._stats_arrays})
                self._load_sketches(slot)
        except Exception as err:  # noqa: BLE001 — containment: book and degrade
            self._book_failure(slot, err, during="load")
            return False
        slot.resident = True
        slot.loads += 1
        self._tick += 1
        slot.last_used = self._tick
        slot.last_probe_mono = now
        self._resident_total += slot.resident_bytes
        self.stats["loads"] += 1
        if probing:
            self._mark_recovered(slot)
        self._evict_to_budget(set(pin) | {pid})
        return True

    # ---- routing + per-partition compare --------------------------------
    def route_candidates(self, q_bottoms: list[np.ndarray]) -> list[set[int]]:
        """Each query's candidate partitions: those whose genomes can share
        a band code with it (the coarse summary's intersection, recall
        1.0). Without a usable summary every non-empty partition is one."""
        from drep_tpu_torch.ops import rangepart

        active = [pid for pid, s in self._slots.items() if s.n > 0]
        if self._route_bitmaps is None:
            return [set(active) for _ in q_bottoms]
        out: list[set[int]] = []
        for b in q_bottoms:
            codes = rangepart.coarse_codes(b, self._route_bits)
            out.append({
                pid for pid in active
                if pid < len(self._route_bitmaps) and rangepart.bitmap_contains_any(self._route_bitmaps[pid], codes)
            })
        return out

    def classify_partition(self, pid: int, q_names: list[str], q_bottoms: list[np.ndarray], prune_cfg: dict | None):
        """One routed batch against one resident partition: the rectangle
        [partition | queries] with ``min_col = n_p``. Pair distances do not
        depend on the pack, so the retained (indexed, query) edges are the
        union rectangle's slice for this partition. Returns (union_i,
        query_idx, dist), or None after booking a failure (suspect or
        quarantined); there is no retry on the CPU or a plain version."""
        slot = self._slots[pid]
        try:
            with telemetry.span("partition_classify", pid=pid, k=len(q_names)):
                faults.fire("partition_classify")
                return self._rect_compare(slot, q_names, q_bottoms, prune_cfg)
        except Exception as err:  # noqa: BLE001 — mid-classify containment
            self._book_failure(slot, err, during="classify")
            return None

    def _rect_compare(self, slot: _PartitionSlot, q_names: list[str], q_bottoms: list[np.ndarray],
                      prune_cfg: dict | None):
        from drep_tpu_torch.ops.minhash import pack_sketches
        from drep_tpu_torch.parallel.streaming import streaming_mash_edges

        p = self.params
        _, keep = _retention(p)
        n_p = slot.n
        t0 = time.perf_counter()
        part_names = [self.union.names[int(u)] for u in slot.u_of_local]
        part_bottoms = [self.union.bottom[int(u)] for u in slot.u_of_local]
        packed = pack_sketches(part_bottoms + list(q_bottoms), part_names + list(q_names), int(p["sketch_size"]))
        prune = None
        if prune_cfg and prune_cfg.get("primary_prune", "off") == "lsh":
            from drep_tpu_torch.ops.lsh import build_candidates

            prune = build_candidates(
                packed, keep=keep, k=int(p["kmer_size"]),
                bands=int(prune_cfg.get("prune_bands", 0)),
                min_shared=int(prune_cfg.get("prune_min_shared", 0)),
                min_col=n_p, join_chunk=int(prune_cfg.get("prune_join_chunk", 0)),
            )
        t1 = time.perf_counter()
        st: dict = {}
        ii, jj, dd, _pairs = streaming_mash_edges(
            packed, int(p["kmer_size"]), keep, block=int(p["streaming_block"]), min_col=n_p, prune=prune,
            device=self.device, stats_out=st,
        )
        self.work["compares"] += 1
        self.work["stripes"] += st["launches"]
        self.work["pack_s"] += t1 - t0
        self.work["walk_s"] += time.perf_counter() - t1
        sel = (jj >= n_p) & (ii < n_p)  # (indexed, query) pairs only
        return slot.u_of_local[ii[sel]], jj[sel] - n_p, dd[sel]

    # ---- union edge view -------------------------------------------------
    def _spineless(self) -> set[int]:
        return {pid for pid, s in self._slots.items() if s.n > 0 and s.u_of_local is None}

    def edges_excluding(self, excluded: set[int]):
        """The union retained-edge graph without every edge incident to an
        excluded (or spine-less) partition's genomes, in the canonical
        (ii, jj) lexsort order: the degraded graph a PARTIAL verdict
        reclusters over (the full graph when nothing is excluded)."""
        eff = frozenset(set(excluded) | self._spineless())
        hit = self._edge_cache.get(eff)
        if hit is not None:
            return hit
        parts_ii: list[np.ndarray] = []
        parts_jj: list[np.ndarray] = []
        parts_dd: list[np.ndarray] = []
        for pid in sorted(self._slots):
            slot = self._slots[pid]
            if pid in eff or slot.intra is None or not len(slot.intra[0]):
                continue
            parts_ii.append(slot.intra[0])
            parts_jj.append(slot.intra[1])
            parts_dd.append(slot.intra[2])
        ci, cj, cd = self._cross
        if len(ci):
            if eff:
                bad = np.asarray(sorted(eff), np.int64)
                mask = ~np.isin(self._cross_pi, bad) & ~np.isin(self._cross_pj, bad)
                ci, cj, cd = ci[mask], cj[mask], cd[mask]
            parts_ii.append(ci)
            parts_jj.append(cj)
            parts_dd.append(cd)
        if parts_ii:
            ii = np.concatenate(parts_ii)
            jj = np.concatenate(parts_jj)
            dd = np.concatenate(parts_dd)
            order = np.lexsort((jj, ii))
            out = (ii[order], jj[order], dd[order])
        else:
            out = _empty_edges()
        self._edge_cache[eff] = out
        return out

    def scratch_excluding(self, excluded: set[int]) -> LoadedIndex:
        """A classify-scratch union copy (fresh containers, shared payloads:
        classify.py's _scratch_index); the caller installs its own edges.

        Excluded partitions' genomes keep their old primary labels (so
        unaffected partitions' verdicts stay those of the full union) but
        are marked ``frozen_rows``: ``recluster`` carries their old suffix
        and score and never routes them into a secondary, since their
        sketches are what is unavailable. A split cluster's available
        remainder still re-clusters (the degraded answer a PARTIAL verdict
        reports), which is why the component closure loads remainders."""
        u = self.union
        sq = LoadedIndex(
            location=u.location, params=u.params, generation=u.generation,
            names=list(u.names), locations=list(u.locations), gdb=u.gdb, admitted=u.admitted,
            bottom=list(u.bottom), scaled=list(u.scaled), edges=u.edges, primary=u.primary,
            suffix=u.suffix, score=u.score, winners=u.winners,
        )
        eff = set(excluded) | self._spineless()
        if eff:
            bad = np.isin(self.part_of, np.asarray(sorted(eff), np.int64))
            sq.frozen_rows = np.nonzero(bad)[0]  # type: ignore[attr-defined]
        return sq

    # ---- health surface ---------------------------------------------------
    def retry_hint_s(self) -> float:
        """A strict refusal's retry_after hint: the soonest any quarantined
        partition is probed again."""
        now = time.monotonic()
        waits = [max(0.0, s.next_probe_mono - now) for s in self._slots.values() if s.state == PARTITION_QUARANTINED]
        return round(max(0.05, min(waits) if waits else self.probe_backoff_s), 4)

    def health_map(self) -> dict:
        """The partition health map the daemon's snapshot (``status`` and
        ``/healthz``) carries: per-partition state, residency and probe
        schedule, and the replica's residency accounting."""
        now = time.monotonic()
        parts: dict[str, dict] = {}
        for pid in sorted(self._slots):
            s = self._slots[pid]
            entry: dict = {
                "state": s.state if s.n > 0 else "empty",
                "resident": bool(s.resident),
                "resident_bytes": int(s.resident_bytes),
                "n_genomes": int(s.n),
                "generation": int(s.meta_generation),
                "loads": int(s.loads),
                "last_probe_ago_s": round(now - s.last_probe_mono, 3) if s.last_probe_mono is not None else None,
            }
            if s.state == PARTITION_QUARANTINED:
                entry["next_probe_in_s"] = round(max(0.0, s.next_probe_mono - now), 3)
                entry["heal_hint"] = partition_heal_hint(pid)
            if s.reason:
                entry["reason"] = s.reason
            parts[str(pid)] = entry
        return {
            "generation": self.generation,
            "n_partitions": len(self._slots),
            "resident_partitions": sum(1 for s in self._slots.values() if s.resident),
            "resident_bytes": int(self._resident_total),
            "budget_bytes": int(self.budget_bytes),
            "peak_resident_partitions": self.stats["peak_resident_partitions"],
            "loads": self.stats["loads"],
            "evictions": self.stats["evictions"],
            "recoveries": self.stats["recoveries"],
            "quarantined": sorted(p for p, s in self._slots.items() if s.state == PARTITION_QUARANTINED),
            "suspect": sorted(p for p, s in self._slots.items() if s.state == PARTITION_SUSPECT),
            "partitions": parts,
        }


# ---------------------------------------------------------------------------
# streaming classify over a FederatedResident
# ---------------------------------------------------------------------------


def _query_query_edges(fed: FederatedResident, q_names: list[str], q_bottoms: list, device):
    """Retained query-query edges of the joint mode, from a pack of the
    queries alone (pair distances do not depend on the pack). Returns
    pack-local (ti, tj, dd)."""
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges

    if len(q_names) < 2:
        return _empty_edges()
    p = fed.params
    _, keep = _retention(p)
    packed = pack_sketches(list(q_bottoms), list(q_names), int(p["sketch_size"]))
    ii, jj, dd, _ = streaming_mash_edges(packed, int(p["kmer_size"]), keep, block=int(p["streaming_block"]),
                                         device=device)
    return ii, jj, dd


def _components(n: int, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix((np.ones(len(ii), np.int8), (ii, jj)), shape=(n, n))
    return connected_components(graph, directed=False)[1]


def _component_closure(fed: FederatedResident, q_edges: list[tuple[np.ndarray, np.ndarray]], unavailable: set[int]):
    """Grow the consulted set until every member of every query's dirty
    component is sketch-resident (the recluster's secondary needs the
    co-members' sketches), excluding (and stamping) the partitions that
    cannot be loaded. Returns (base edge view, per-query filtered direct
    edges, consulted by the closure, excluded)."""
    n_old = fed.n
    k = len(q_edges)
    excluded = set(unavailable)
    closure_consulted: set[int] = set()
    for _ in range(len(fed._slots) + 1):
        base = fed.edges_excluding(excluded)
        eff = excluded | fed._spineless()
        filt: list[tuple[np.ndarray, np.ndarray]] = []
        for ui, dd in q_edges:
            if len(ui) and eff:
                m = ~np.isin(fed.part_of[ui], np.asarray(sorted(eff), np.int64))
                ui, dd = ui[m], dd[m]
            filt.append((ui, dd))
        ii = np.concatenate([base[0]] + [f[0] for f in filt])
        jj = np.concatenate([base[1]] + [np.full(len(f[0]), n_old + t, np.int64) for t, f in enumerate(filt)])
        comp = _components(n_old + k, ii, jj)
        q_comps = {comp[n_old + t] for t in range(k)}
        members = np.nonzero(np.isin(comp[:n_old], sorted(q_comps)))[0]
        need = {int(p) for p in np.unique(fed.part_of[members])} if len(members) else set()
        # a cluster split by the exclusion re-clusters its available
        # remainder (the degraded answer): a multi-member remainder runs
        # the secondary, so its sketches must be resident too
        if eff:
            bad = np.isin(fed.part_of, np.asarray(sorted(eff), np.int64))
            for lab in np.unique(fed.union.primary[bad]) if bad.any() else ():
                rem = np.nonzero((fed.union.primary == lab) & ~bad)[0]
                if len(rem) >= 2:
                    need |= {int(p) for p in np.unique(fed.part_of[rem])}
        need -= excluded
        missing = set()
        for pid in sorted(need):
            if not fed.ensure_resident(pid, pin=need):
                missing.add(pid)
        closure_consulted |= need - missing
        if not missing:
            return base, filt, closure_consulted, excluded
        excluded |= missing
    return base, filt, closure_consulted, excluded  # pragma: no cover — bounded by the partition count


def _affected_by_exclusion(fed: FederatedResident, q_edges: list[tuple[np.ndarray, np.ndarray]],
                           eff: set[int]) -> list[set[int]]:
    """Per query: the excluded partitions whose genomes are connected to
    its unfiltered component, the coverage holes the filtered graph no
    longer sees. A quarantined partition's genome can co-cluster with the
    query only through dropped edges (an a--b cross edge where the query
    reaches only `a`); the degraded answer then differs from the full one
    though the partition was never routed to, so the verdict must still
    stamp it. Built from every spine-loaded partition's intra edges and
    the cross edges (a spine-less partition's internal chains are unknown,
    which can only under-extend a component inside that stamped
    partition)."""
    if not eff:
        return [set() for _ in q_edges]
    n_old = fed.n
    k = len(q_edges)
    parts_ii = [fed._cross[0]]
    parts_jj = [fed._cross[1]]
    for pid in sorted(fed._slots):
        slot = fed._slots[pid]
        if slot.intra is not None and len(slot.intra[0]):
            parts_ii.append(slot.intra[0])
            parts_jj.append(slot.intra[1])
    ii = np.concatenate(parts_ii + [e[0] for e in q_edges])
    jj = np.concatenate(parts_jj + [np.full(len(e[0]), n_old + t, np.int64) for t, e in enumerate(q_edges)])
    comp = _components(n_old + k, ii, jj)
    out: list[set[int]] = []
    for t in range(k):
        members = np.nonzero(comp[:n_old] == comp[n_old + t])[0]
        pids = {int(p) for p in np.unique(fed.part_of[members])} if len(members) else set()
        out.append(pids & eff)
    return out


def _stamp(verdict: dict, consulted: set[int], unavailable: set[int]) -> dict:
    verdict["partitions_consulted"] = sorted(consulted)
    verdict["partitions_unavailable"] = sorted(unavailable)
    if unavailable:
        verdict["partial"] = True
    return verdict


def _recluster(fed: FederatedResident, sq: LoadedIndex, n_old: int, processes: int, device) -> None:
    st: dict = {}
    recluster(sq, n_old, processes=processes, device=device, stats_out=st)
    fed.work["reclusters"] += 1
    fed.work["secondary_calls"] += st["secondary_calls"]
    fed.work["recluster_s"] += st["recluster_s"]


def classify_batch_federated(fed: FederatedResident, queries, processes: int = 1, prune_cfg: dict | None = None,
                             joint: bool = True, partition_compare=None, consult_check=None) -> list[dict]:
    """Streaming per-partition classify: route, one rectangle per
    (consulted partition x batch), merge the per-partition edges and
    assemble per-query verdicts through the recluster the union path
    runs. The verdicts equal the union-assembled ``classify_batch``'s when
    every consulted partition is healthy, and are PARTIAL (stamped
    ``partitions_consulted`` / ``partitions_unavailable``) when one is
    not. Runs on the resident's device.

    ``partition_compare(pid, names, bottoms) -> (ui, qi, dd) | None``
    replaces the local per-partition rectangle: the fleet router
    (serve/router.py) injects its gathered remote legs here, so a routed
    verdict runs the same merge and recluster. None books the partition
    unavailable, as a local residency failure does.

    ``consult_check() -> bool`` gates each consult up front: False books
    the partition unavailable without running its compare (the router's
    batch deadline: a gather whose clients have walked away degrades to
    an immediate PARTIAL)."""
    from drep_tpu_torch.index.classify import _assemble_verdicts

    if not queries.n:
        return []
    dev = fed.device
    gen = int(fed.generation)
    n_old = fed.n
    q_names = list(queries.admitted["genome"])
    q_bottoms = [np.asarray(queries.results[g]["bottom"], np.uint64) for g in q_names]
    k = len(q_names)
    cand = fed.route_candidates(q_bottoms)
    consulted: set[int] = set()
    unavailable: set[int] = set()
    q_edges: list[tuple[np.ndarray, np.ndarray]] = [
        (np.empty(0, np.int64), np.empty(0, np.float32)) for _ in range(k)
    ]
    for pid in sorted(set().union(*cand) if cand else ()):
        if consult_check is not None and not consult_check():
            # the batch's deadline passed mid-merge: every remaining
            # partition books unavailable and the verdict goes out PARTIAL
            unavailable.add(pid)
            continue
        cols = [t for t in range(k) if pid in cand[t]]
        if partition_compare is not None:
            res = partition_compare(pid, [q_names[t] for t in cols], [q_bottoms[t] for t in cols])
        else:
            if not fed.ensure_resident(pid, pin={pid}):
                unavailable.add(pid)
                continue
            res = fed.classify_partition(pid, [q_names[t] for t in cols], [q_bottoms[t] for t in cols], prune_cfg)
        if res is None:
            unavailable.add(pid)
            continue
        consulted.add(pid)
        ui, qt, dd = res
        for j, t in enumerate(cols):
            s = qt == j
            if s.any():
                old_ui, old_dd = q_edges[t]
                q_edges[t] = (np.concatenate([old_ui, ui[s]]), np.concatenate([old_dd, dd[s].astype(np.float32)]))

    routed_unavailable = set(unavailable)
    base, filt, closure_consulted, excluded = _component_closure(fed, q_edges, unavailable)
    closure_missing = excluded - routed_unavailable
    unavailable = excluded  # the closure started from the routed failures
    # a partition consulted for the compare can fail its closure reload
    # (evicted, then rot landed): its edges were filtered out again, so
    # the two stamps stay one or the other
    consulted = (consulted | closure_consulted) - unavailable
    closure_consulted -= unavailable
    # excluded partitions reachable from a query's component only through
    # dropped edges still degrade its answer and are stamped
    affected = _affected_by_exclusion(fed, q_edges, unavailable | fed._spineless())

    if joint:
        sq = fed.scratch_excluding(excluded)
        _admit_batch(sq, queries.admitted, queries.results, gen + 1)
        ti, tj, td = _query_query_edges(fed, q_names, q_bottoms, dev)
        new_ii = np.concatenate([f[0] for f in filt] + [n_old + ti])
        new_jj = np.concatenate([np.full(len(f[0]), n_old + t, np.int64) for t, f in enumerate(filt)] + [n_old + tj])
        new_dd = np.concatenate([f[1] for f in filt] + [td])
        order = np.lexsort((new_jj, new_ii))
        new_ii, new_jj, new_dd = new_ii[order], new_jj[order], new_dd[order]
        sq.edges = (
            np.concatenate([base[0], new_ii]),
            np.concatenate([base[1], new_jj]),
            np.concatenate([base[2], new_dd]),
        )
        _recluster(fed, sq, n_old, processes, dev)
        out = _assemble_verdicts(sq, n_old, new_ii, new_jj, new_dd, gen)
        fed._evict_to_budget(set())  # settle under the budget between batches
        joint_unavail = unavailable | set().union(*affected)
        return [_stamp(v, consulted - joint_unavail, joint_unavail) for v in out]

    out: list[dict] = []
    for t in range(k):
        sq = fed.scratch_excluding(excluded)
        _admit_batch(sq, queries.admitted.iloc[[t]], queries.results, gen + 1)
        ui, dd = filt[t]
        order = np.argsort(ui, kind="stable")
        qii, qdd = ui[order], dd[order]
        qjj = np.full(len(qii), n_old, np.int64)
        sq.edges = (
            np.concatenate([base[0], qii]),
            np.concatenate([base[1], qjj]),
            np.concatenate([base[2], qdd]),
        )
        _recluster(fed, sq, n_old, processes, dev)
        v = _assemble_verdicts(sq, n_old, qii, qjj, qdd, gen)[0]
        # this query's coverage: its routed candidates plus whatever the
        # closure pulled in (closure needs are graph-global, attributed
        # to every query, erring toward "consulted")
        unavail_t = (routed_unavailable & cand[t]) | closure_missing | affected[t]
        consulted_t = ((consulted & cand[t]) | closure_consulted) - unavail_t
        out.append(_stamp(v, consulted_t, unavail_t))
    # one batch's working set is pinned above the budget while in flight;
    # settle back under it before the next batch (residency is an
    # inter-batch contract, the peak gauge records the in-flight truth)
    fed._evict_to_budget(set())
    return out


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
            try:
                faults.fire("partition_update")
            except Exception as e:  # noqa: BLE001 — a partition's failure is tolerated, as in process
                results[pid] = f"{type(e).__name__}: {e}"
                logger.error("federated update: partition %d pod launch failed: %s", pid, e)
                continue
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
    telemetry.event("federation_partial_meta", partitions_unavailable=unavailable,
                    unadmitted=len(partial.get("unadmitted", ())))
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
    fed_pods = envknobs.env_int("DREP_TORCH_FED_PODS") if fed_pods is None else int(fed_pods)
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
        telemetry.event("federation_partial_cleared", partitions_recovered=stale_unavail)
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
                telemetry.event("federation_partition", pid=pid, op="pod", n=len(routed[pid]))
    else:
        for pid, pdir, kind in dirty:
            tp = time.perf_counter()
            try:
                faults.fire("partition_update")
                if kind == "build":
                    _build_partition(pdir, params, routed[pid], results, processes, device=dev)
                else:
                    index_update(
                        pdir, None, processes=processes, primary_prune=primary_prune,
                        prune_bands=prune_bands, prune_min_shared=prune_min_shared,
                        prune_join_chunk=prune_join_chunk, presketched=(routed[pid], results), device=dev,
                    )
                telemetry.event("federation_partition", pid=pid, op=kind, n=len(routed[pid]))
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
