"""Transactional index lifecycle: partition split and merge, generation
compaction.

Counterpart of drep_tpu/index/maintenance.py, in its store format and
transaction record byte for byte, so either package rolls forward the
other's interrupted transaction. A federated store pins its partition
ranges at creation and appends one sketch/edge/state shard triple per
admitted generation; this module bounds both:

SPLIT / MERGE, meta-manifest transactions over the range map
    ``fed_split`` bisects one partition's range at the median of its
    genomes' range codes into two child stores; ``fed_merge`` folds two
    adjacent partitions into one. No distance is recomputed: the union
    edge graph already holds every retained edge (intra edges plus the
    recall-1.0 cross shards), so each child's edges are that graph
    restricted to its members, and its derived state is a local
    recluster (the fused indicator kernel, one launch a multi-member
    primary cluster). The transaction is staged:

    1. STAGE    ``pending/maint.json`` (the checked transaction record)
                and the child stores under ``pending/``; the old meta
                stays fully live.
    2. INSTALL  children renamed to their ``part_###`` dirs; the cross,
                fedstate and routing families written at the new
                federation generation for the new range map (pids
                renumbered densely by range order). Still invisible.
    3. COMMIT   one atomic ``federation.json`` publish.
    4. GC       parent stores and superseded family files removed,
                strictly after the commit.

    A kill before the commit leaves the old meta live (``roll_forward``
    discards the staging; the rerun restages the same bytes); a kill
    after it is finished by the next ``roll_forward``.

COMPACTION, merge-and-supersede over generation families
    ``fed_compact`` (and ``compact_store`` for a plain store) folds a
    store's N sketch/edge/state generations into one written at ``g+1``:
    the same genomes, per-genome admitted generations and edge set. The
    partition manifests publish first, then the meta (new partition
    ``(generation, manifest_crc)``; the union families stay, membership
    did not move), then gc. A compacted store classifies and updates as
    its uncompacted twin does. A kill between a partition's manifest
    publish and the meta's leaves the partition one generation ahead with
    an unchanged genome count (an update always grows it), which
    ``roll_forward`` adopts even without the transaction record.

``roll_forward(location)`` is the convergence point: every verb here and
``fed_update`` call it first.

The JAX package's fault sites fire at its kill points: ``partition_split``
(split and merge) when staged, before the meta commit and before the gc;
``compaction`` the same three. With tracing on, each commit is an
``index_maintenance`` instant. The gc grace delays are the knobs
``DREP_TORCH_SPLIT_GC_GRACE_S`` / ``_COMPACT_GC_GRACE_S``.

The maintenance scheduler's inputs: :func:`maintenance_snapshot` (a
read-only per-partition view) and :func:`maintenance_targets_from_env`
(``DREP_TORCH_COMPACT_MIN_SHARDS``, ``_SPLIT_MAX_GENOMES``), for
``autoscale.policy.maintenance_decide``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import meta as fedmeta
from drep_tpu_torch.index.federation import FederationStore, _partition_generation, load_federated
from drep_tpu_torch.index.store import _STAT_COLS, IndexStore, LoadedIndex, build_manifest, load_index
from drep_tpu_torch.utils import envknobs, faults, telemetry
from drep_tpu_torch.utils.logger import get_logger


MAINT_NAME = os.path.join("pending", "maint.json")


# ---------------------------------------------------------------------------
# the transaction record
# ---------------------------------------------------------------------------


def maint_path(location: str) -> str:
    return os.path.join(os.path.abspath(location), MAINT_NAME)


def read_staging(location: str) -> dict | None:
    """The in-flight transaction record, or None. A corrupt record is
    removed and reads as None: it cannot name its children, and what it
    staged becomes orphaned staging."""
    from drep_tpu_torch.utils.durableio import CorruptPayloadError, read_json_checked

    path = maint_path(location)
    if not os.path.exists(path):
        return None
    try:
        doc = read_json_checked(path, what="maintenance transaction record")
    except CorruptPayloadError:
        get_logger().warning(
            "index maintenance: transaction record %s is corrupt — "
            "discarding it (staged artifacts become scrub-able orphans; "
            "the next maintenance pass restages from the live meta)", path,
        )
        with contextlib.suppress(OSError):
            os.remove(path)
        return None
    return doc if isinstance(doc, dict) else None


def _write_staging(location: str, doc: dict) -> None:
    from drep_tpu_torch.utils.durableio import atomic_write_json

    os.makedirs(os.path.dirname(maint_path(location)), exist_ok=True)
    atomic_write_json(maint_path(location), doc)


def _remove_staging(location: str) -> None:
    with contextlib.suppress(OSError):
        os.remove(maint_path(location))
    # the shared pending/ staging area goes when empty (partition stores
    # keep their own pending/ rectangle stores)
    with contextlib.suppress(OSError):
        os.rmdir(os.path.join(os.path.abspath(location), "pending"))


# ---------------------------------------------------------------------------
# roll forward / roll back
# ---------------------------------------------------------------------------


def roll_forward(location: str, device=None) -> dict | None:
    """Converge an interrupted maintenance transaction before new work: a
    committed one (meta already at ``gen_new``) finishes its gc; an
    uncommitted split or merge is discarded (the old meta is live and the
    rerun restages the same bytes); an uncommitted compaction is
    completed on `device` (its partition manifest publishes may already
    be durable). Also adopts record-less compaction interrupts. Returns a
    small summary of what it did, or None."""
    store = FederationStore(location)
    if not store.exists():
        return None
    logger = get_logger()
    doc = read_staging(location)
    out: dict | None = None
    if doc is not None:
        m = store.read_meta()
        gen_new = int(doc.get("gen_new", -1))
        op = str(doc.get("op", "?"))
        if int(m["generation"]) >= gen_new:
            _gc_after_commit(store, doc)
            logger.info(
                "index maintenance: rolled %s transaction forward (generation %d committed; gc completed)",
                op, gen_new,
            )
            out = {"op": op, "rolled": "forward", "generation": gen_new,
                   "parents": [int(p["pid"]) for p in doc.get("parents", ())]}
        elif op == "compact":
            out = _resume_compact(store, doc, device=device)
        else:
            _discard_staging(store, doc)
            logger.info(
                "index maintenance: discarded uncommitted %s staging — old meta (generation %d) fully "
                "live; rerun restages deterministically", op, int(m["generation"]),
            )
            out = {"op": op, "rolled": "back", "generation": int(m["generation"])}
    adopted = _adopt_ahead_partitions(store)
    return out or adopted


def _discard_staging(store: FederationStore, doc: dict) -> None:
    """Undo an uncommitted split or merge: its staged children (under
    pending/ and any already renamed, never a dir the live meta
    references), the family files at the aborted generation, the record."""
    m = store.read_meta()
    live_dirs = {e["dir"] for e in m.get("partitions", ())}
    for child in doc.get("children", ()):
        d = str(child["dir"])
        if d in live_dirs:
            continue
        shutil.rmtree(os.path.join(store.location, "pending", d), ignore_errors=True)
        shutil.rmtree(store.abspath(d), ignore_errors=True)
    gen_new = int(doc.get("gen_new", -1))
    if gen_new > int(m["generation"]):
        for rel in (store.cross_shard_name(gen_new), store.fedstate_name(gen_new), store.routing_name(gen_new)):
            with contextlib.suppress(OSError):
                os.remove(store.abspath(rel))
    _remove_staging(store.location)


def _adopt_ahead_partitions(store: FederationStore) -> dict | None:
    """A record-less compaction interrupt: a partition manifest published
    at meta+1 with an unchanged genome count. Republish the meta with its
    new (generation, crc), then gc its superseded shards."""
    m = store.read_meta()
    gen = int(m["generation"])
    if gen < 0:
        return None
    adopted: list[int] = []
    entries = [dict(e) for e in m["partitions"]]
    for e in entries:
        if int(e["n_genomes"]) <= 0:
            continue
        pdir = store.abspath(e["dir"])
        if _partition_generation(pdir) != int(e["generation"]) + 1:
            continue
        try:
            pm = IndexStore(pdir).read_manifest()
        except UserInputError:
            continue
        if int(pm.get("n_genomes", -1)) != int(e["n_genomes"]):
            continue  # a grown tail: an interrupted update, not ours
        e["generation"] = int(e["generation"]) + 1
        e["manifest_crc"] = fedmeta.manifest_crc(pdir)
        adopted.append(int(e["pid"]))
    if not adopted:
        return None
    m_new = dict(m)
    m_new["partitions"] = entries
    m_new["generation"] = gen + 1
    store.publish_meta(m_new)
    for e in entries:
        if int(e["pid"]) in adopted:
            _gc_unreferenced(store.abspath(e["dir"]))
    get_logger().warning(
        "index maintenance: adopted interrupted compaction of partition(s) %s (ahead-by-one, unchanged "
        "genome count) -> federation generation %d", adopted, gen + 1,
    )
    return {"op": "compact", "rolled": "forward", "generation": gen + 1, "parents": adopted}


# ---------------------------------------------------------------------------
# gc
# ---------------------------------------------------------------------------


def _gc_after_commit(store: FederationStore, doc: dict) -> None:
    """Phase 4, strictly after the meta publish; idempotent. Delayed by
    the op's gc grace knob, so live replicas still on the old meta
    hot-swap before the parents vanish."""
    knob = "DREP_TORCH_COMPACT_GC_GRACE_S" if doc.get("op") == "compact" else "DREP_TORCH_SPLIT_GC_GRACE_S"
    grace = envknobs.env_float(knob)
    if grace > 0:
        time.sleep(grace)
    m = store.read_meta()
    live_dirs = {e["dir"] for e in m.get("partitions", ())}
    if doc.get("op") == "compact":
        for p in doc.get("parents", ()):
            if p["dir"] in live_dirs:
                _gc_unreferenced(store.abspath(p["dir"]))
    else:
        for p in doc.get("parents", ()):
            if p["dir"] not in live_dirs:
                shutil.rmtree(store.abspath(p["dir"]), ignore_errors=True)
        for child in doc.get("children", ()):
            shutil.rmtree(os.path.join(store.location, "pending", str(child["dir"])), ignore_errors=True)
        _gc_superseded_families(store, m)
    _remove_staging(store.location)


def _gc_superseded_families(store: FederationStore, m: dict) -> None:
    """Remove the federation family files the current meta no longer
    references (a split or merge folds every cross shard into one)."""
    referenced = {os.path.basename(e["file"]) for e in m.get("cross_shards", ())}
    cross_dir = os.path.join(store.location, "cross")
    if os.path.isdir(cross_dir):
        for f in os.listdir(cross_dir):
            if f.startswith("cross_g") and f.endswith(".npz") and f not in referenced:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(cross_dir, f))
    if m.get("state"):
        store.gc_states(m["state"], m.get("routing"))


def _gc_unreferenced(part_dir: str) -> None:
    """Store gc: remove the generation-family files its current manifest
    does not reference, and its pending rectangle store. Idempotent."""
    try:
        pm = IndexStore(part_dir).read_manifest()
    except UserInputError:
        return
    referenced = {e["file"] for e in pm.get("sketch_shards", ())}
    referenced |= {e["file"] for e in pm.get("edge_shards", ())}
    if pm.get("state"):
        referenced.add(pm["state"])
    referenced = {os.path.basename(r) for r in referenced}
    for sub, prefix in (("sketches", "sketch_g"), ("edges", "edges_g"), ("state", "state_g")):
        fam = os.path.join(part_dir, sub)
        if not os.path.isdir(fam):
            continue
        for f in os.listdir(fam):
            if f.startswith(prefix) and f.endswith(".npz") and f not in referenced:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(fam, f))
    shutil.rmtree(os.path.join(part_dir, "pending"), ignore_errors=True)


# ---------------------------------------------------------------------------
# split / merge
# ---------------------------------------------------------------------------


def _refuse_if_degraded(m: dict, location: str, verb: str) -> None:
    partial = m.get("partial") or {}
    if partial.get("failed_partitions") or partial.get("partitions_unavailable"):
        raise UserInputError(
            f"federated index at {location} carries a PARTIAL stamp "
            f"({partial}) — `index {verb}` rewrites the range map and "
            f"refuses to bake a degraded union in; finish/heal the "
            f"pending work first (`drep-tpu index update {location}`)"
        )


def _allocate_dirs(m: dict, count: int) -> list[str]:
    """The smallest part_### names no meta entry uses: deterministic from
    the meta alone, so a rerun allocates the same names."""
    used = {str(e["dir"]) for e in m.get("partitions", ())}
    out: list[str] = []
    i = 0
    while len(out) < count:
        name = fedmeta.partition_dir_name(i)
        if name not in used:
            out.append(name)
        i += 1
        if i > fedmeta.MAX_PARTITIONS:
            raise UserInputError(
                f"federation at {m.get('n_partitions')} partitions has no "
                f"free part_### names (MAX_PARTITIONS={fedmeta.MAX_PARTITIONS})"
            )
    return out


def _member_rows(union: LoadedIndex, pid: int) -> np.ndarray:
    part_of = np.asarray(union.fed_part_of, np.int64)  # type: ignore[attr-defined]
    local_of = np.asarray(union.fed_local_of, np.int64)  # type: ignore[attr-defined]
    rows = np.nonzero(part_of == pid)[0]
    return rows[np.argsort(local_of[rows], kind="stable")]


def _build_child_store(union: LoadedIndex, dst: str, rows: np.ndarray, processes: int = 1, device=None) -> None:
    """One child partition store from the union: its genomes in parent-
    local order, the union edge graph restricted to them (distances do
    not depend on the pack, so a fresh build of the member set retains
    exactly these pairs), and a local recluster on `device`. One
    generation-0 shard per family; admitted generations are kept."""
    from drep_tpu_torch.index.update import recluster

    rows = np.asarray(rows, np.int64)
    n_c = len(rows)
    if n_c == 0:
        return
    u2c = np.full(union.n, -1, np.int64)
    u2c[rows] = np.arange(n_c, dtype=np.int64)
    ii, jj, dd = union.edges
    sel = (u2c[ii] >= 0) & (u2c[jj] >= 0)
    ci, cj, cd = u2c[ii[sel]], u2c[jj[sel]], dd[sel]
    # a merge's member order (parent b's rows after parent a's) can invert ii < jj
    swap = ci > cj
    ci[swap], cj[swap] = cj[swap], ci[swap].copy()
    child = LoadedIndex(
        location=os.path.abspath(dst), params=union.params, generation=0,
        names=[union.names[u] for u in rows],
        locations=[union.locations[u] for u in rows],
        gdb=pd.DataFrame({
            "genome": [union.names[u] for u in rows],
            **{c: union.gdb[c].to_numpy()[rows].astype(np.int64) for c in _STAT_COLS},
        }),
        admitted=np.asarray(union.admitted, np.int64)[rows],
        bottom=[union.bottom[u] for u in rows],
        scaled=[union.scaled[u] for u in rows],
        edges=(ci, cj, cd),
        primary=np.zeros(n_c, np.int64), suffix=np.zeros(n_c, np.int64),
        score=np.zeros(n_c, np.float64),
        winners=pd.DataFrame({"cluster": [], "genome": [], "score": []}),
    )
    recluster(child, 0, processes=processes, device=device)
    st = IndexStore(dst)
    st.ensure_dirs()
    sk_rel, ed_rel = st.sketch_shard_name(0), st.edge_shard_name(0)
    state_rel = st.state_name(0)
    st.write_sketch_shard(sk_rel, child.names, child.locations, child.gdb, child.bottom, child.scaled, child.admitted)
    st.write_edge_shard(ed_rel, ci, cj, cd)
    st.write_state(state_rel, child)
    child.sketch_shards = [{"file": sk_rel, "lo": 0, "hi": n_c, "generation": 0}]
    child.edge_shards = [{"file": ed_rel, "lo": 0, "hi": n_c, "generation": 0}]
    st.publish_manifest(build_manifest(child, state_rel))


def _run_range_txn(store: FederationStore, m: dict, union: LoadedIndex, txn: dict,
                   members_by_dir: dict[str, np.ndarray], processes: int, device=None) -> dict:
    """The split/merge transaction body: stage, install, commit, gc."""
    logger = get_logger()
    location = store.location
    gen_new = int(txn["gen_new"])
    op = str(txn["op"])
    parent_pids = {int(p["pid"]) for p in txn["parents"]}
    parent_dirs = {str(p["dir"]) for p in txn["parents"]}

    # -- phase 1: STAGE ---------------------------------------------------
    _write_staging(location, txn)
    staged_root = os.path.join(location, "pending")
    for child in txn["children"]:
        rows = members_by_dir[str(child["dir"])]
        if not len(rows):
            continue
        dst = os.path.join(staged_root, str(child["dir"]))
        shutil.rmtree(dst, ignore_errors=True)
        _build_child_store(union, dst, rows, processes=processes, device=device)
    faults.fire("partition_split")  # kill point: staged

    # -- phase 2: INSTALL -------------------------------------------------
    # children to their dirs, pids renumbered densely by range order (the
    # routing bitmaps are pid-indexed), the families for the new range
    # map; the old meta references none of it yet
    for child in txn["children"]:
        if not int(child["n_genomes"]):
            continue
        src = os.path.join(staged_root, str(child["dir"]))
        dst = store.abspath(str(child["dir"]))
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        # every file inside was published atomically when staged; the
        # directory rename installs it, invisible until the meta commit
        os.replace(src, dst)
    kept = [e for e in m["partitions"] if int(e["pid"]) not in parent_pids]
    entries = [dict(e) for e in kept]
    for child in txn["children"]:
        entries.append({
            "pid": -1, "dir": str(child["dir"]),
            "range": [int(child["range"][0]), int(child["range"][1])],
            "generation": 0 if int(child["n_genomes"]) else -1,
            "n_genomes": int(child["n_genomes"]),
            "manifest_crc": (
                fedmeta.manifest_crc(store.abspath(str(child["dir"]))) if int(child["n_genomes"]) else None
            ),
        })
    entries.sort(key=lambda e: int(e["range"][0]))
    dir_to_pid = {}
    for new_pid, e in enumerate(entries):
        e["pid"] = new_pid
        dir_to_pid[str(e["dir"])] = new_pid

    part_of = np.asarray(union.fed_part_of, np.int64)  # type: ignore[attr-defined]
    local_of = np.asarray(union.fed_local_of, np.int64)  # type: ignore[attr-defined]
    old_dir = {int(e["pid"]): str(e["dir"]) for e in m["partitions"]}
    new_part_of = np.empty(union.n, np.int64)
    new_local_of = np.empty(union.n, np.int64)
    keep_sel = ~np.isin(part_of, list(parent_pids))
    for u in np.nonzero(keep_sel)[0]:
        new_part_of[u] = dir_to_pid[old_dir[int(part_of[u])]]
        new_local_of[u] = local_of[u]
    for child in txn["children"]:
        pid = dir_to_pid[str(child["dir"])]
        rows = members_by_dir[str(child["dir"])]
        new_part_of[rows] = pid
        new_local_of[rows] = np.arange(len(rows), dtype=np.int64)

    store.ensure_dirs()
    cr_rel = store.cross_shard_name(gen_new)
    st_rel = store.fedstate_name(gen_new)
    rt_rel = store.routing_name(gen_new)
    ii, jj, dd = union.edges
    xsel = new_part_of[ii] != new_part_of[jj]
    store.write_cross_shard(cr_rel, ii[xsel], jj[xsel], dd[xsel], new_part_of, new_local_of)
    union.generation = gen_new
    store.write_fedstate(st_rel, union, new_part_of, new_local_of)
    store.write_routing_summary(rt_rel, union.bottom, new_part_of, len(entries))
    meta_new = {
        "format": fedmeta.FED_FORMAT,
        "generation": gen_new,
        "n_genomes": union.n,
        "n_partitions": len(entries),
        "params": m["params"],
        "partitions": entries,
        # the fold: one cross shard over the whole union, its redundant
        # (map_pid, map_local) copy for the new range map
        "cross_shards": [{"file": cr_rel, "lo": 0, "hi": union.n, "generation": gen_new}],
        "state": st_rel,
        "routing": rt_rel,
    }
    faults.fire("partition_split")  # kill point: before the commit

    # -- phase 3: COMMIT --------------------------------------------------
    store.publish_meta(meta_new)
    telemetry.event("index_maintenance", op=op, generation=gen_new, parents=sorted(parent_pids),
                    n_partitions=len(entries))
    faults.fire("partition_split")  # kill point: before the gc

    # -- phase 4: GC ------------------------------------------------------
    _gc_after_commit(store, txn)
    logger.info(
        "index %s: partition(s) %s (%s) -> %s at federation generation %d (%d partitions, %d cross edge(s))",
        op, sorted(parent_pids), sorted(parent_dirs), [c["dir"] for c in txn["children"]], gen_new,
        len(entries), int(np.count_nonzero(xsel)),
    )
    return {
        "op": op,
        "generation": gen_new,
        "n_partitions": len(entries),
        "n_genomes": union.n,
        "parents": sorted(parent_pids),
        "children": [
            {"pid": dir_to_pid[str(c["dir"])], "dir": str(c["dir"]),
             "range": [int(c["range"][0]), int(c["range"][1])], "n_genomes": int(c["n_genomes"])}
            for c in txn["children"]
        ],
        "cross_edges": int(np.count_nonzero(xsel)),
    }


def fed_split(location: str, pid: int, processes: int = 1, device=None) -> dict:
    """`index split`: bisect partition `pid`'s range at the median of its
    genomes' range codes into two child stores, one staged meta
    transaction, the children reclustered on `device` (default cuda; the
    CPU only when asked). A rerun after a kill converges; a rerun naming
    a parent whose split already committed returns that summary."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rf = roll_forward(location, device=dev)
    if (rf and rf.get("rolled") == "forward" and rf.get("op") == "split"
            and int(pid) in rf.get("parents", ())):
        return {"op": "split", "generation": int(rf["generation"]), "already_committed": True,
                "parents": [int(pid)]}
    store = FederationStore(location)
    m = store.read_meta()
    _refuse_if_degraded(m, location, "split")
    gen = int(m["generation"])
    if gen < 0:
        raise UserInputError(f"federated index at {location} is an empty skeleton — there is nothing to split yet")
    entry = next((e for e in m["partitions"] if int(e["pid"]) == int(pid)), None)
    if entry is None:
        raise UserInputError(
            f"federated index at {location} has no partition {pid} (pids 0..{int(m['n_partitions']) - 1})"
        )
    if int(entry["n_genomes"]) < 2:
        raise UserInputError(f"partition {pid} holds {entry['n_genomes']} genome(s) — a split needs at least 2")
    union = load_federated(location, heal=False)
    rows = _member_rows(union, int(pid))
    codes = np.array([fedmeta.route_code(union.bottom[int(u)]) for u in rows], np.uint64)
    uniq = np.unique(codes)
    if len(uniq) < 2:
        raise UserInputError(
            f"partition {pid}: all {len(rows)} genomes share one sketch "
            f"range code — the range cannot be bisected (they would all "
            f"land in one child). Merge-and-resplit a neighboring range "
            f"instead."
        )
    mid = int(uniq[len(uniq) // 2])
    lo, hi = int(entry["range"][0]), int(entry["range"][1])
    left = rows[codes < np.uint64(mid)]
    right = rows[codes >= np.uint64(mid)]
    dirs = _allocate_dirs(m, 2)
    txn = {
        "op": "split",
        "gen_new": gen + 1,
        "parents": [{"pid": int(pid), "dir": str(entry["dir"])}],
        "children": [
            {"dir": dirs[0], "range": [lo, mid], "n_genomes": int(len(left))},
            {"dir": dirs[1], "range": [mid, hi], "n_genomes": int(len(right))},
        ],
        "mid": mid,
    }
    return _run_range_txn(store, m, union, txn, {dirs[0]: left, dirs[1]: right}, processes, device=dev)


def fed_merge(location: str, pid_a: int, pid_b: int, processes: int = 1, device=None) -> dict:
    """`index merge`: fold two adjacent partitions into one child whose
    range is their union, through the split's staged transaction, the
    child reclustered on `device`."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    pids = sorted({int(pid_a), int(pid_b)})
    if len(pids) != 2:
        raise UserInputError("`index merge` needs two DISTINCT partition ids")
    rf = roll_forward(location, device=dev)
    if (rf and rf.get("rolled") == "forward" and rf.get("op") == "merge"
            and set(pids) <= set(rf.get("parents", ()))):
        return {"op": "merge", "generation": int(rf["generation"]), "already_committed": True, "parents": pids}
    store = FederationStore(location)
    m = store.read_meta()
    _refuse_if_degraded(m, location, "merge")
    gen = int(m["generation"])
    if gen < 0:
        raise UserInputError(f"federated index at {location} is an empty skeleton — there is nothing to merge yet")
    if int(m["n_partitions"]) <= 2:
        raise UserInputError(
            "a federation keeps at least 2 partitions (a 1-partition "
            "federation is just a plain index) — merge refused"
        )
    by_pid = {int(e["pid"]): e for e in m["partitions"]}
    try:
        ea, eb = by_pid[pids[0]], by_pid[pids[1]]
    except KeyError as e:
        raise UserInputError(
            f"federated index at {location} has no partition {e} (pids 0..{int(m['n_partitions']) - 1})"
        ) from e
    if int(ea["range"][1]) != int(eb["range"][0]):
        raise UserInputError(
            f"partitions {pids[0]} and {pids[1]} are not adjacent "
            f"(ranges {ea['range']} and {eb['range']}) — merge folds one "
            f"contiguous range"
        )
    union = load_federated(location, heal=False)
    rows_a = _member_rows(union, pids[0])
    rows_b = _member_rows(union, pids[1])
    rows = np.concatenate([rows_a, rows_b])
    (child_dir,) = _allocate_dirs(m, 1)
    txn = {
        "op": "merge",
        "gen_new": gen + 1,
        "parents": [{"pid": pids[0], "dir": str(ea["dir"])}, {"pid": pids[1], "dir": str(eb["dir"])}],
        "children": [
            {"dir": child_dir, "range": [int(ea["range"][0]), int(eb["range"][1])], "n_genomes": int(len(rows))}
        ],
    }
    return _run_range_txn(store, m, union, txn, {child_dir: rows}, processes, device=dev)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _family_generations(pm: dict) -> int:
    return max(len(pm.get("sketch_shards", ())), len(pm.get("edge_shards", ())))


def _stage_compact(part_dir: str, device=None) -> tuple[dict, int]:
    """Write one store's folded generation (shards only: the manifest
    publish is the caller's commit). Returns (manifest_doc,
    healed_count); a heal's edge recompute runs on `device`. A rerun
    rewrites the same names with the same payloads."""
    st = IndexStore(part_dir)
    idx = load_index(part_dir, heal=True, device=device)
    gen_new = idx.generation + 1
    sk_rel, ed_rel = st.sketch_shard_name(gen_new), st.edge_shard_name(gen_new)
    state_rel = st.state_name(gen_new)
    st.write_sketch_shard(sk_rel, idx.names, idx.locations, idx.gdb, idx.bottom, idx.scaled, idx.admitted)
    st.write_edge_shard(ed_rel, *idx.edges)
    idx.generation = gen_new
    st.write_state(state_rel, idx)
    idx.sketch_shards = [{"file": sk_rel, "lo": 0, "hi": idx.n, "generation": gen_new}]
    idx.edge_shards = [{"file": ed_rel, "lo": 0, "hi": idx.n, "generation": gen_new}]
    return build_manifest(idx, state_rel), len(idx.healed)


def compact_store(location: str, processes: int = 1, device=None) -> dict:
    """Compact a plain index store: fold its N shard generations into one
    at ``g+1``, publish, gc the superseded shards. Per-genome admitted
    generations and the edge set are kept, so classify and update answer
    as on the uncompacted twin. An already compact store only sweeps
    unreferenced leftovers."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    st = IndexStore(location)
    pm = st.read_manifest()
    if _family_generations(pm) < 2:
        _gc_unreferenced(st.location)
        return {"op": "compact", "generation": int(pm["generation"]), "compacted": [],
                "skipped": ["single-generation store"]}
    manifest, healed = _stage_compact(st.location, device=dev)
    faults.fire("compaction")  # kill point: staged
    faults.fire("compaction")  # kill point: before the commit
    st.publish_manifest(manifest)
    telemetry.event("index_maintenance", op="compact", generation=int(manifest["generation"]),
                    n_genomes=int(manifest["n_genomes"]))
    faults.fire("compaction")  # kill point: before the gc
    _gc_unreferenced(st.location)
    return {"op": "compact", "generation": int(manifest["generation"]),
            "compacted": [os.path.basename(st.location)], "healed": healed, "skipped": []}


def fed_compact(location: str, pid: int | None = None, processes: int = 1, min_generations: int = 2,
                device=None) -> dict:
    """`index compact`: on a federated root, fold every target partition's
    shard families into one generation, commit through the partition
    manifest publishes and then one meta publish, then gc. ``pid=None``
    compacts every partition holding at least ``min_generations``
    generations. A plain root runs :func:`compact_store`."""
    from drep_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if not fedmeta.is_federated(location):
        return compact_store(location, processes=processes, device=dev)
    rf = roll_forward(location, device=dev)
    store = FederationStore(location)
    m = store.read_meta()
    gen = int(m["generation"])
    if gen < 0:
        raise UserInputError(f"federated index at {location} is an empty skeleton — there is nothing to compact yet")
    targets: list[dict] = []
    skipped: list[str] = []
    for e in m["partitions"]:
        if pid is not None and int(e["pid"]) != int(pid):
            continue
        if int(e["n_genomes"]) <= 0:
            if pid is not None:
                raise UserInputError(f"partition {pid} is empty — nothing to compact")
            continue
        pdir = store.abspath(e["dir"])
        pm = IndexStore(pdir).read_manifest()
        need = 2 if pid is not None else max(2, int(min_generations))
        if _family_generations(pm) < need:
            skipped.append(str(e["dir"]))
            continue
        targets.append(dict(e))
    if pid is not None and not targets and not skipped:
        raise UserInputError(
            f"federated index at {location} has no partition {pid} (pids 0..{int(m['n_partitions']) - 1})"
        )
    if not targets:
        return {"op": "compact", "generation": gen, "compacted": [], "skipped": skipped,
                "already_committed": bool(rf and rf.get("op") == "compact")}

    txn = {
        "op": "compact",
        "gen_new": gen + 1,
        "parents": [
            {"pid": int(e["pid"]), "dir": str(e["dir"]), "generation": int(e["generation"])} for e in targets
        ],
        "children": [],
    }
    _write_staging(location, txn)
    manifests: dict[str, dict] = {}
    healed = 0
    for e in targets:
        doc, h = _stage_compact(store.abspath(e["dir"]), device=dev)
        manifests[str(e["dir"])] = doc
        healed += h
    faults.fire("compaction")  # kill point: staged
    # the partition commits, each its own manifest publish: a kill between
    # them and the meta publish is the state roll_forward adopts
    for e in targets:
        IndexStore(store.abspath(e["dir"])).publish_manifest(manifests[str(e["dir"])])
    entries = [dict(e) for e in m["partitions"]]
    target_pids = {int(e["pid"]) for e in targets}
    for e in entries:
        if int(e["pid"]) in target_pids:
            e["generation"] = int(e["generation"]) + 1
            e["manifest_crc"] = fedmeta.manifest_crc(store.abspath(e["dir"]))
    meta_new = dict(m)
    meta_new["partitions"] = entries
    meta_new["generation"] = gen + 1
    faults.fire("compaction")  # kill point: before the commit
    store.publish_meta(meta_new)
    telemetry.event("index_maintenance", op="compact", generation=gen + 1, parents=sorted(target_pids))
    faults.fire("compaction")  # kill point: before the gc
    _gc_after_commit(store, txn)
    get_logger().info(
        "index compact: folded %d partition(s) %s -> federation generation %d (%d skipped already-compact)",
        len(targets), sorted(target_pids), gen + 1, len(skipped),
    )
    return {"op": "compact", "generation": gen + 1, "compacted": sorted(str(e["dir"]) for e in targets),
            "skipped": skipped, "healed": healed, "parents": sorted(target_pids)}


def _resume_compact(store: FederationStore, doc: dict, device=None) -> dict:
    """Roll an uncommitted compaction forward: partitions still at their
    old generation are restaged (on `device`) and published, then the
    meta commit and gc complete."""
    gen_new = int(doc["gen_new"])
    m = store.read_meta()
    for p in doc.get("parents", ()):
        pdir = store.abspath(str(p["dir"]))
        if _partition_generation(pdir) <= int(p["generation"]):
            manifest, _healed = _stage_compact(pdir, device=device)
            IndexStore(pdir).publish_manifest(manifest)
    entries = [dict(e) for e in m["partitions"]]
    by_dir = {str(p["dir"]): p for p in doc.get("parents", ())}
    for e in entries:
        p = by_dir.get(str(e["dir"]))
        if p is not None:
            e["generation"] = int(p["generation"]) + 1
            e["manifest_crc"] = fedmeta.manifest_crc(store.abspath(e["dir"]))
    meta_new = dict(m)
    meta_new["partitions"] = entries
    meta_new["generation"] = gen_new
    store.publish_meta(meta_new)
    _gc_after_commit(store, doc)
    get_logger().info("index maintenance: resumed interrupted compaction -> federation generation %d", gen_new)
    return {"op": "compact", "rolled": "forward", "generation": gen_new,
            "parents": [int(p["pid"]) for p in doc.get("parents", ())]}


# ---------------------------------------------------------------------------
# the maintenance scheduler's inputs (the pure policy is autoscale/policy.py)
# ---------------------------------------------------------------------------


def maintenance_snapshot(location: str) -> dict:
    """Read-only input of ``autoscale.policy.maintenance_decide``: each
    partition's genome count and shard-family generations, stamped with
    the monotonic clock. Never writes."""
    out: dict = {"observed_at": time.monotonic(), "location": location}
    if not fedmeta.is_federated(location):
        out["error"] = "not a federated index"
        return out
    try:
        m = fedmeta.read_meta(location)
    except UserInputError as e:
        out["error"] = str(e)
        return out
    store = FederationStore(location)
    parts = []
    for e in m["partitions"]:
        entry = {"pid": int(e["pid"]), "n_genomes": int(e["n_genomes"]), "generations": 0}
        if int(e["n_genomes"]) > 0:
            try:
                pm = IndexStore(store.abspath(e["dir"])).read_manifest()
                entry["generations"] = _family_generations(pm)
            except UserInputError:
                entry["generations"] = -1  # unreadable: the scheduler holds
        parts.append(entry)
    out.update({
        "generation": int(m["generation"]),
        "n_partitions": int(m["n_partitions"]),
        "maintenance_pending": os.path.exists(maint_path(location)),
        "partitions": parts,
    })
    return out


def maintenance_targets_from_env():
    """The operator's maintenance envelope, read once from the knobs (the
    pure policy reads no environment): compaction proposed at
    ``DREP_TORCH_COMPACT_MIN_SHARDS`` generations, a split past
    ``DREP_TORCH_SPLIT_MAX_GENOMES`` genomes (0: never)."""
    from drep_tpu_torch.autoscale.policy import MaintenanceTargets

    return MaintenanceTargets(
        compact_min_shards=envknobs.env_int("DREP_TORCH_COMPACT_MIN_SHARDS"),
        split_max_genomes=envknobs.env_int("DREP_TORCH_SPLIT_MAX_GENOMES"),
    )
