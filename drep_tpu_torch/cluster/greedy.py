"""Greedy-incremental secondary clustering (`--greedy_secondary_clustering`).

Counterpart of drep_tpu/cluster/greedy.py on its TPU route (the
rectangular indicator products; the JAX package's gather tiles serve only
its CPU). Each genome is compared only with the representatives that
exist when it is visited, largest first (most k-mers); it joins the best
one that clears S_ani and the two-sided coverage gate, or becomes a
representative itself. That takes a primary cluster from O(m^2)
comparisons to O(m x representatives).

Genomes are taken in blocks. One device pass gives a block's intersection
counts with every representative and with itself; the assignment, which
is sequential (a genome may become a representative mid-block), then runs
on the host over those counts. The vocabulary chunks are fixed once from
the whole cluster (ops/containment.py::VocabChunkGeometry); the
representatives stay on the device, append-only, one tensor a chunk, and
are read in rep tiles of 4 x block rows. The block against each rep tile
is one launch of the rectangular indicator product a chunk
(ops/indicator.py::indicator_rect_intersections); the block against itself
one launch of the symmetric one a chunk. Under `--mesh_shape D` the block
grows D-fold and its rows are split over the mesh's positions: each runs
the rectangular product of its rows (against the rep tiles, and against
the whole block for the self comparison) on its own device.

:func:`greedy_assign_from_matrices` is the same assignment over (ani,
cov) matrices already computed: the controller's route for clusters small
enough to ride the batched secondary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np
import pandas as pd
import torch

from drep_tpu_torch.cluster.engines import _mesh_or_none
from drep_tpu_torch.cluster.pairs import NDB_COLUMNS
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.ops.containment import (
    VocabChunkGeometry,
    containment_to_ani,
    pack_scaled_sketches,
    rect_from_chunks,
    self_from_chunks,
)
from drep_tpu_torch.ops.minhash import PAD_ID, ids_to_device

# seconds of each part of this process's greedy clusters, and the device
# passes (one a block)
GREEDY_TIMINGS: dict[str, float] = {}


@contextlib.contextmanager
def _timed(key: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        GREEDY_TIMINGS[key] = GREEDY_TIMINGS.get(key, 0.0) + time.perf_counter() - t0


def _cov_from_inter(inter: np.ndarray, denom: np.ndarray) -> np.ndarray:
    """cov = inter / denom in float32, rows or columns of zero count 0."""
    d = np.maximum(denom.astype(np.float32), 1.0)
    return np.where(denom > 0, inter / d, 0.0).astype(np.float32)


def _ndb_from_rows(ndb_rows: list[dict], pc: int) -> pd.DataFrame:
    """The greedy Ndb, from the rows of each visited genome."""
    if ndb_rows:
        ndb = pd.DataFrame({key: np.concatenate([r[key] for r in ndb_rows]) for key in ndb_rows[0]})
        ndb["primary_cluster"] = pc
        return ndb
    return pd.DataFrame(columns=NDB_COLUMNS)


def greedy_assign_from_matrices(
    gs: GenomeSketches,
    indices: list[int],
    pc: int,
    kw: dict[str, Any],
    ani: np.ndarray,
    cov: np.ndarray,
) -> tuple[pd.DataFrame, np.ndarray]:
    """Greedy representative assignment from (ani, cov) matrices already
    computed (one batched device call for many small clusters): the same
    visiting order, gate and Ndb rows as :func:`greedy_secondary_cluster`
    (each genome against the representatives existing when it is
    visited)."""
    s_ani, cov_thresh = kw["S_ani"], kw["cov_thresh"]
    m = len(indices)
    n_kmers = [int(gs.gdb["n_kmers"].iloc[i]) for i in indices]
    order = sorted(range(m), key=lambda t: -n_kmers[t])
    names = [gs.names[i] for i in indices]
    labels = np.zeros(m, dtype=np.int64)
    reps: list[int] = []
    ndb_rows: list[dict] = []
    for t in order:
        if reps:
            r = np.asarray(reps)
            cov_row = cov[t, r].astype(np.float64)
            cov_rev = cov[r, t].astype(np.float64)
            ani_row = ani[t, r].astype(np.float64)
            ndb_rows.append(
                {
                    "reference": np.array([names[x] for x in reps]),
                    "querry": np.repeat(names[t], len(reps)),
                    "ani": ani_row,
                    "alignment_coverage": cov_row,
                    "ref_coverage": cov_rev,
                    "querry_coverage": cov_row,
                }
            )
            ok = (ani_row >= s_ani) & (cov_row >= cov_thresh) & (cov_rev >= cov_thresh)
            if ok.any():
                labels[t] = int(np.argmax(np.where(ok, ani_row, -1.0))) + 1
                continue
        reps.append(t)
        labels[t] = len(reps)
    return _ndb_from_rows(ndb_rows, pc), labels


def _rep_tile(rep: torch.Tensor, t0: int, rows: int) -> torch.Tensor:
    """Rows t0 .. t0 + rows - 1 of a representatives' chunk tensor, PAD
    rows past its end."""
    part = rep[t0 : t0 + rows]
    if part.shape[0] == rows:
        return part
    return torch.nn.functional.pad(part, (0, 0, 0, rows - part.shape[0]), value=int(PAD_ID))


def _compare_block(
    blk_chunks: list[np.ndarray],
    reps: dict[torch.device, list[torch.Tensor]],
    n_reps: int,
    rep_pad: int,
    rep_tile: int,
    v_chunk: int,
    devices: tuple[torch.device, ...],
) -> tuple[np.ndarray, np.ndarray]:
    """(the block against the representatives [block, rep_pad], the block
    against itself [block, block]) int32 intersection counts: position p
    of `devices` takes block rows p x block / D onwards, on its device."""
    block = blk_chunks[0].shape[0]
    share = block // len(devices)
    on_device = {dev: [ids_to_device(c, dev) for c in blk_chunks] for dev in dict.fromkeys(devices)}
    inter, inter_self = [], []
    for p, dev in enumerate(devices):
        blk = on_device[dev]
        mine = [c[p * share : (p + 1) * share] for c in blk]
        tiles = torch.zeros((rep_pad // rep_tile, share, rep_tile), dtype=torch.int32, device=dev)
        for ti in range(rep_pad // rep_tile if n_reps else 0):
            rect_from_chunks(mine, [_rep_tile(rc, ti * rep_tile, rep_tile) for rc in reps[dev]], v_chunk,
                             out=tiles[ti])
        inter.append(tiles.permute(1, 0, 2).reshape(share, rep_pad))
        inter_self.append(self_from_chunks(blk, v_chunk) if len(devices) == 1 else rect_from_chunks(mine, blk, v_chunk))
    return (np.concatenate([x.cpu().numpy() for x in inter]), np.concatenate([x.cpu().numpy() for x in inter_self]))


def greedy_secondary_cluster(
    gs: GenomeSketches,
    bdb: pd.DataFrame,
    indices: list[int],
    pc: int,
    kw: dict[str, Any],
    block: int = 128,
) -> tuple[pd.DataFrame, np.ndarray]:
    """Returns (Ndb rows of the comparisons made, labels 1..R in `indices`
    order), on kw["device"] (or the mesh of kw["mesh_shape"])."""
    s_ani, cov_thresh = kw["S_ani"], kw["cov_thresh"]
    m = len(indices)
    order = sorted(range(m), key=lambda t: -int(gs.gdb["n_kmers"].iloc[indices[t]]))
    packed = pack_scaled_sketches([gs.scaled[indices[t]] for t in order], [gs.names[indices[t]] for t in order])
    ids, counts = packed.ids, packed.counts

    # local_only: a secondary's launches stay on this pod member's positions
    mesh = _mesh_or_none(kw.get("mesh_shape"), m, kw["device"], local_only=True)
    devices = mesh.devices if mesh is not None else (torch.device(kw["device"]),)
    # the rep side rides the unscaled block: under a mesh the candidate
    # block grows D-fold, the representatives (every position's) do not
    rep_tile = 4 * block
    block *= len(devices)
    geom = VocabChunkGeometry(ids, max_rows_per_call=max(rep_tile, block))
    # the representatives, once on each device the positions use
    rep_chunks = {
        dev: [torch.full((0, w), int(PAD_ID), dtype=torch.int32, device=dev) for w in geom.widths]
        for dev in dict.fromkeys(devices)
    }
    n_shipped = 0

    labels_ordered = np.zeros(m, dtype=np.int64)
    reps: list[int] = []  # positions (in `order`) of the representatives
    ndb_rows: list[dict] = []
    name_arr = np.array(packed.names)

    for b0 in range(0, m, block):
        rows = list(range(b0, min(b0 + block, m)))
        nb = len(rows)
        b_counts = np.zeros(block, np.int32)
        b_counts[:nb] = counts[rows]
        rep_pad = max(-(-len(reps) // rep_tile) * rep_tile, rep_tile)
        if n_shipped < len(reps):
            with _timed("ship_reps_s"):
                new_chunks = geom.rows_chunks(reps[n_shipped:])
                for dev, chunks in rep_chunks.items():
                    rep_chunks[dev] = [torch.cat([old, ids_to_device(nc, dev)]) for old, nc in zip(chunks, new_chunks)]
                n_shipped = len(reps)
        r_counts = np.zeros(rep_pad, np.int32)
        r_counts[: len(reps)] = counts[reps]
        with _timed("host_repack_s"):
            blk_chunks = [
                np.pad(bc, ((0, block - nb), (0, 0)), constant_values=PAD_ID) for bc in geom.rows_chunks(rows)
            ]
        # both coverage directions from one count matrix (the sets are
        # symmetric; only the denominators differ); counts below 2^24 are
        # exact in float32, as the JAX package divides them
        with _timed("device_compare_s"):
            GREEDY_TIMINGS["device_calls"] = GREEDY_TIMINGS.get("device_calls", 0) + 1
            inter, inter_self = _compare_block(blk_chunks, rep_chunks, len(reps), rep_pad, rep_tile, geom.v_chunk,
                                               devices)
            inter = inter.astype(np.float32)
            cov_vs_reps = _cov_from_inter(inter, b_counts[:, None])
            cov_rev_reps = _cov_from_inter(inter, r_counts[None, :])
            c_blk = _cov_from_inter(inter_self.astype(np.float32), b_counts[:, None])

        # sequential over the block's genomes (one may become a
        # representative mid-block), vectorized over the representatives
        with _timed("assign_s"):
            n_pre = len(reps)  # representatives from before this block
            in_block: list[int] = []  # block-local positions of mid-block representatives
            for t, pos in enumerate(rows):
                cov_row = np.concatenate([cov_vs_reps[t, :n_pre], c_blk[t, in_block]])
                cov_rev = np.concatenate([cov_rev_reps[t, :n_pre], c_blk[in_block, t]])
                ani_row = containment_to_ani(np.maximum(cov_row, cov_rev), gs.k)
                if len(ani_row):
                    ndb_rows.append(
                        {
                            "reference": name_arr[np.array(reps, dtype=np.int64)],
                            "querry": np.repeat(name_arr[pos], len(ani_row)),
                            "ani": ani_row.astype(np.float64),
                            "alignment_coverage": cov_row.astype(np.float64),
                            "ref_coverage": cov_rev.astype(np.float64),
                            "querry_coverage": cov_row.astype(np.float64),
                        }
                    )
                    ok = (ani_row >= s_ani) & (cov_row >= cov_thresh) & (cov_rev >= cov_thresh)
                    if ok.any():
                        labels_ordered[pos] = int(np.argmax(np.where(ok, ani_row, -1.0))) + 1
                        continue
                reps.append(pos)
                in_block.append(pos - b0)
                labels_ordered[pos] = len(reps)

    # back to the `indices` order
    labels = np.zeros(m, dtype=np.int64)
    for t in range(m):
        labels[order[t]] = labels_ordered[t]
    return _ndb_from_rows(ndb_rows, pc), labels
