"""Containment ANI from FracMinHash sketches — the indicator-matmul paths
of the `jax_ani` secondary.

Counterpart of the indicator-matmul subset of drep_tpu/ops/containment.py.
Scaled sketches map to a dense int32 id space; the intersection sizes
|A ∩ B| of all row pairs are one exact integer product of 0/1 indicator
rows:

    inter = ind @ ind.T,   ind [m, v_pad] int8

which ops/indicator.py::indicator_intersections computes whole on the
device (one fused kernel; the JAX package's triangular product and host
mirror in its plain version). ANI = max(C(A,B), C(B,A))^(1/k), C =
|A∩B|/|A|, derives from the counts on the host with the JAX package's
float32 formula.

Two regimes, chosen by cluster/engines.py::containment_matrices:

- one-shot: the whole [m, v_pad] indicator fits MATMUL_BUDGET_ELEMS;
- vocabulary-chunked: past the budget the vocabulary splits into chunks
  (ops/rangepart.py), each one launch adding its counts into one
  accumulator on the device.

The other beyond-budget route, the merge-intersect kernel, is
ops/intersect.py. The greedy secondary's working set is
:class:`VocabChunkGeometry` (chunk bounds fixed from a whole cluster, any
subset of its rows repacked into them), read by :func:`rect_from_chunks`
and :func:`self_from_chunks`.
"""

from __future__ import annotations

import numpy as np
import torch

from drep_tpu_torch.ops.indicator import ROW_BUCKET_MIN, indicator_intersections, indicator_rect_intersections
from drep_tpu_torch.ops.minhash import (
    PAD_ID,
    U16_PAD,
    PackedSketches,
    dense_ranks,
    ids_to_device,
    next_pow2,
    pad_packed_rows,
    pad_sentinel,
    require_int32_ids,
)
from drep_tpu_torch.ops.rangepart import MIN_BUCKET_WIDTH, bucket_starts, repack_bucket, vocab_extent

# budget for the dense indicator matrix [m, V] in int8 elements (~512 MB)
MATMUL_BUDGET_ELEMS = 1 << 29
_VOCAB_BUCKET_MIN = 8192


def _pow2_bucket(x: int, minimum: int) -> int:
    """Round up to a power of two (>= minimum)."""
    return max(minimum, 1 << (max(x, 1) - 1).bit_length())


def pack_scaled_sketches(
    sketches: list[np.ndarray], names: list[str], pad_multiple: int = 128
) -> PackedSketches:
    """Ragged uint64 scaled sketches -> padded int32 id matrix [N, S], S the
    max sketch length rounded up to a power of two (>= `pad_multiple`)."""
    if not sketches:
        raise ValueError("no sketches to pack")
    width = _pow2_bucket(max(max(len(s) for s in sketches), 1), pad_multiple)
    n = len(sketches)
    ids = np.full((n, width), PAD_ID, dtype=np.int32)
    lens = np.array([len(s) for s in sketches], dtype=np.int64)
    flat = np.concatenate(sketches)
    _, ranks = dense_ranks(flat)
    rows = np.repeat(np.arange(n), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(len(flat)) - np.repeat(offs, lens)
    ids[rows, cols] = ranks
    return PackedSketches(ids=ids, counts=lens.astype(np.int32), names=list(names))


def pack_scaled_sketches_clusterlocal(
    sketch_groups: list[list[np.ndarray]],
    names: list[str],
    pad_multiple: int = 128,
) -> tuple[PackedSketches, int]:
    """Pack MANY clusters into one id matrix with per-cluster-LOCAL dense id
    spaces: cluster c's ids are ranks into c's own vocabulary, so every
    cluster shares the same narrow [0, v_extent) range and one one-shot
    indicator matmul serves the whole batch. Cross-cluster blocks of the
    result are id-collision garbage by construction — callers read the
    diagonal blocks only.

    Returns (packed, v_extent), v_extent the max cluster vocabulary size.
    When every cluster vocabulary fits 16 bits the pack is uint16 with a
    0xFFFF pad (half the host->device bytes; widened on the device).
    """
    if not sketch_groups:
        raise ValueError("no clusters to pack")
    rank_parts: list[np.ndarray] = []
    lens: list[int] = []
    v_extent = 1
    for group in sketch_groups:
        flat = np.concatenate(group) if group else np.array([], np.uint64)
        vocab = np.unique(flat)
        if vocab.size >= np.iinfo(np.int32).max:
            raise ValueError("id space overflow: >2^31 distinct sketch hashes")
        v_extent = max(v_extent, int(vocab.size))
        rank_parts.append(np.searchsorted(vocab, flat).astype(np.int32))
        lens.extend(len(s) for s in group)
    lens_arr = np.array(lens, dtype=np.int64)
    n = len(lens_arr)
    width = _pow2_bucket(max(int(lens_arr.max()) if n else 1, 1), pad_multiple)
    if v_extent < 0xFFFF:
        ids = np.full((n, width), np.uint16(0xFFFF), dtype=np.uint16)
    else:
        ids = np.full((n, width), PAD_ID, dtype=np.int32)
    flat_ranks = np.concatenate(rank_parts) if rank_parts else np.zeros(0, np.int32)
    rows = np.repeat(np.arange(n), lens_arr)
    offs = np.concatenate([[0], np.cumsum(lens_arr)[:-1]])
    cols = np.arange(len(flat_ranks)) - np.repeat(offs, lens_arr)
    ids[rows, cols] = flat_ranks  # ranks of a sorted-unique sketch are sorted
    return (
        PackedSketches(ids=ids, counts=lens_arr.astype(np.int32), names=list(names)),
        v_extent,
    )


def matmul_vocab_pad_extent(extent: int) -> int:
    """Bucketed indicator width for a known vocabulary extent."""
    return _pow2_bucket(max(extent, 1), _VOCAB_BUCKET_MIN)


def matmul_vocab_pad(packed: PackedSketches) -> int:
    """Bucketed indicator width of a pack (one scan of packed.ids)."""
    return matmul_vocab_pad_extent(vocab_extent(packed.ids))


def matmul_rows_pad(n: int) -> int:
    """Row count the indicator matmul allocates for n genomes."""
    return _pow2_bucket(n, ROW_BUCKET_MIN)


def one_shot_fits(n_rows: int, v_pad: int) -> bool:
    """Whether the [rows, v_pad(+trash)] indicator fits the one-shot
    budget — the dispatch inequality of the JAX package."""
    return matmul_rows_pad(n_rows) * (v_pad + 1) <= MATMUL_BUDGET_ELEMS


def containment_to_ani(c: np.ndarray, k: int) -> np.ndarray:
    """Elementwise containment -> ANI (c^(1/k); 0 stays 0), float32."""
    return np.where(c > 0.0, np.exp(np.log(np.maximum(c, 1e-30)) / k), 0.0).astype(np.float32)


def max_containment_ani(cov: np.ndarray, k: int) -> np.ndarray:
    """ani[i,j] = max(cov[i,j], cov[j,i])^(1/k), diagonal pinned to 1."""
    ani = containment_to_ani(np.maximum(cov, cov.T), k)
    np.fill_diagonal(ani, 1.0)
    return ani


def ani_cov_from_intersections(
    inter: np.ndarray, counts: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host: (symmetric max-containment ani, directional cov) from
    intersection counts. cov = |A∩B|/|A|; diagonals pinned to 1."""
    na = np.maximum(counts.astype(np.float32), 1.0)
    cov = (inter.astype(np.float32) / na[:, None]).astype(np.float32)
    ani = max_containment_ani(cov, k)
    np.fill_diagonal(cov, 1.0)
    return ani, cov


def intersections_one_shot(packed: PackedSketches, v_pad: int, device: torch.device) -> np.ndarray:
    """[m, m] int32 exact intersection counts of a pack whose indicator
    fits the one-shot budget: rows padded to the pow2 bucket, the counts
    computed on the device."""
    m = packed.n
    m_pad = matmul_rows_pad(m)
    if not one_shot_fits(m, v_pad):
        raise ValueError(
            f"containment of {m} rows over a {v_pad}-wide vocabulary exceeds the one-shot "
            "indicator budget; route it through cluster/engines.py::containment_matrices"
        )
    ids, _ = pad_packed_rows(packed.ids, packed.counts, m_pad)
    return indicator_intersections(ids_to_device(ids, device), v_pad).cpu().numpy()[:m, :m]


def all_vs_all_containment_matmul(
    packed: PackedSketches, k: int, device: torch.device, v_pad: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(ani, cov) [m, m] through the one-shot indicator matmul —
    drep_tpu/ops/containment.py::all_vs_all_containment_matmul."""
    if v_pad is None:
        v_pad = matmul_vocab_pad(packed)
    inter = intersections_one_shot(packed, v_pad, device)
    return ani_cov_from_intersections(inter, packed.counts, k)


def matmul_vocab_chunk(m_pad: int) -> int:
    """Widest pow2 vocabulary chunk whose [m_pad, chunk+1] int8 indicator
    fits MATMUL_BUDGET_ELEMS (>= _VOCAB_BUCKET_MIN)."""
    fit = max(MATMUL_BUDGET_ELEMS // max(m_pad, 1) - 1, 1)
    return max(_VOCAB_BUCKET_MIN, 1 << (fit.bit_length() - 1))


def _chunk_plan(ids: np.ndarray, v_chunk: int, extent: int):
    """(n_chunks, starts, hist, width) of a vocabulary-chunk layout, shared
    by the byte comparison and the materialization."""
    n_chunks = -(-extent // v_chunk)
    starts = bucket_starts(ids, v_chunk, n_chunks)
    hist = np.diff(starts, axis=1)
    width = max(MIN_BUCKET_WIDTH, next_pow2(int(hist.max())))
    return n_chunks, starts, hist, width


def _stacked_vocab_chunks(ids: np.ndarray, v_chunk: int, m_pad: int, plan=None) -> np.ndarray:
    """[R, m_pad, W] stacked vocabulary chunks for one host->device copy:
    chunk r holds each row's ids in [r*v_chunk, (r+1)*v_chunk), rebased to
    the chunk origin and repacked to the shared pow2 width W. Below 2^16
    (strictly: a rebased 65535 would be the sentinel) the chunks ship as
    uint16 with a 0xFFFF pad. `plan`: a precomputed :func:`_chunk_plan`."""
    extent = vocab_extent(ids)
    if extent == 0:
        return np.full((0, m_pad, MIN_BUCKET_WIDTH), PAD_ID, np.int32)
    n_chunks, starts, hist, width = plan if plan is not None else _chunk_plan(ids, v_chunk, extent)
    dtype = np.uint16 if v_chunk < (1 << 16) else np.int32
    out = np.full((n_chunks, m_pad, width), pad_sentinel(dtype), dtype)
    for r in range(n_chunks):
        blk = repack_bucket(ids, starts[:, r], hist[:, r], width, rebase=r * v_chunk)
        if dtype == np.uint16:
            out[r, : ids.shape[0]] = np.where(blk == PAD_ID, U16_PAD, blk).astype(np.uint16)
        else:
            out[r, : ids.shape[0]] = blk
    return out


def vocab_chunks(packed: PackedSketches, m_pad: int | None = None) -> tuple[np.ndarray, int]:
    """(stacked [R, m_pad, W] vocabulary chunks, chunk width) of the
    chunked route: the chunk plan (int32 chunks, or 2^15-wide uint16
    chunks when those ship fewer bytes). Rows pad to `m_pad` (default the
    secondary's pow2 bucket, :func:`matmul_rows_pad`)."""
    require_int32_ids(packed.ids, "intersections_chunked")
    if m_pad is None:
        m_pad = matmul_rows_pad(packed.n)
    v_chunk = matmul_vocab_chunk(m_pad)
    extent = vocab_extent(packed.ids)
    u16_chunk = 1 << 15
    plan = None
    if v_chunk > u16_chunk and extent > 0:
        plan32 = _chunk_plan(packed.ids, v_chunk, extent)
        plan16 = _chunk_plan(packed.ids, u16_chunk, extent)
        if plan16[0] * plan16[3] * 2 < plan32[0] * plan32[3] * 4:
            v_chunk, plan = u16_chunk, plan16
        else:
            plan = plan32
    return _stacked_vocab_chunks(packed.ids, v_chunk, m_pad, plan=plan), v_chunk


def intersections_chunked(packed: PackedSketches, device: torch.device, m_pad: int | None = None) -> np.ndarray:
    """[m, m] int32 exact intersection counts through vocabulary chunks
    (:func:`vocab_chunks`, rows padded to `m_pad`): ONE stacked copy to
    the device, per chunk one launch adding its counts into one
    accumulator on the device, one copy back —
    drep_tpu/ops/containment.py::all_vs_all_containment_matmul_chunked."""
    chunks, v_chunk = vocab_chunks(packed, m_pad)
    m, m_pad = packed.n, chunks.shape[1]
    stacked = ids_to_device(chunks, device)
    acc = torch.zeros((m_pad, m_pad), dtype=torch.int32, device=stacked.device)
    for r in range(stacked.shape[0]):
        indicator_intersections(stacked[r], v_chunk, out=acc)
    return acc.cpu().numpy()[:m, :m]


def all_vs_all_containment_matmul_chunked(
    packed: PackedSketches, k: int, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """(ani, cov) [m, m] through the vocabulary-chunked indicator matmul,
    for a pack past the one-shot budget."""
    return ani_cov_from_intersections(intersections_chunked(packed, device), packed.counts, k)


class VocabChunkGeometry:
    """Per-cluster vocabulary-chunk layout for incremental rectangular
    intersections (the greedy secondary's working set) —
    drep_tpu/ops/containment.py::VocabChunkGeometry.

    The chunk bounds, each chunk's width and every row's slice of each
    chunk are fixed once from the whole cluster's id matrix, so any subset
    of rows repacks into aligned chunk tensors in O(rows) host work, and an
    append-only subset (the representatives) can stay on the device as
    per-chunk tensors that only ever receive new rows.
    """

    def __init__(self, ids: np.ndarray, max_rows_per_call: int):
        require_int32_ids(ids, "VocabChunkGeometry")
        self.ids = ids
        extent = vocab_extent(ids)
        # the budget covers both operands of a rectangular call at the
        # stated row bound (the JAX package's indicator budget; the chunk
        # bounds, and so the chunk tensors, are the JAX package's)
        fit = max(MATMUL_BUDGET_ELEMS // max(2 * matmul_rows_pad(max_rows_per_call), 1) - 1, 1)
        self.v_chunk = max(_VOCAB_BUCKET_MIN, 1 << (fit.bit_length() - 1))
        self.n_chunks = max(1, -(-extent // self.v_chunk))
        self.starts = bucket_starts(ids, self.v_chunk, self.n_chunks)
        self.hist = np.diff(self.starts, axis=1)
        # a chunk's width is its largest count over ALL the cluster's rows,
        # so any subset fits and no chunk tensor is ever widened
        self.widths = [_pow2_bucket(int(self.hist[:, c].max()), MIN_BUCKET_WIDTH) for c in range(self.n_chunks)]

    def rows_chunks(self, rows) -> list[np.ndarray]:
        """[len(rows), W_c] rebased int32 chunk tensor of each chunk, for
        any subset of the cluster's rows."""
        rows = np.asarray(rows, dtype=np.int64)
        sub = self.ids[rows]
        return [
            repack_bucket(sub, self.starts[rows, c], self.hist[rows, c], self.widths[c], rebase=c * self.v_chunk)
            for c in range(self.n_chunks)
        ]


def rect_from_chunks(a_chunks, b_chunks, v_chunk: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_c |A ∩ B| over aligned chunk tensors on one device: one launch of
    the rectangular indicator product a chunk, each adding into one int32
    [na, nb] accumulator on the device (`out`, zeros when None), which is
    returned (the caller copies it back once)."""
    for a_c, b_c in zip(a_chunks, b_chunks, strict=True):
        out = indicator_rect_intersections(a_c, b_c, v_chunk, out=out)
    return out


def self_from_chunks(chunks, v_chunk: int) -> torch.Tensor:
    """Σ_c |A ∩ A| over one side's chunk tensors on one device: one launch
    of the symmetric indicator product a chunk (one staged side on each
    diagonal tile), adding into one int32 [n, n] accumulator."""
    out = None
    for c in chunks:
        out = indicator_intersections(c, v_chunk, out=out)
    return out
