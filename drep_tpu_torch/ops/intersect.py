"""Pairwise intersection counts of sorted id rows by merging: CUDA kernel
wrappers, their plain PyTorch versions, and the all-vs-all callers.

Counterpart of drep_tpu/ops/pallas_merge.py. This is the secondary path
for clusters past the one-shot indicator budget whose vocabulary is far
wider than their sketches: the cost per pair is the merge of two rows,
whatever the vocabulary. ``csrc/intersect.cu`` counts, per pair, the
adjacent equal non-PAD elements of the sorted concatenation of the two
rows, summed over R stacked id-range buckets (R = 1 is the plain kernel):

- :func:`intersect` takes [rows, W] id rows (W <= PALLAS_MAX_WIDTH);
- :func:`intersect_stacked` takes the [R, rows, W] buckets of
  ops/rangepart.py::stacked_range_buckets (int32, or uint16 widened on
  the device first).

Each runs the kernel for CUDA tensors and its plain version for CPU
tensors; there is no fallback between them. :func:`intersect_counts` and
:func:`intersect_counts_self` do the JAX package's host work on every
device: columns padded to a power of two, rows to TILE_A, rows wider than
PALLAS_MAX_WIDTH range-partitioned.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.containment import ani_cov_from_intersections
from drep_tpu_torch.ops.mash import _wrap_symmetric_plain, unwrap_symmetric
from drep_tpu_torch.ops.minhash import (
    PAD_ID,
    PackedSketches,
    ids_to_device,
    next_pow2,
    pad_sentinel,
    require_int32_ids,
    widen_ids,
)
from drep_tpu_torch.ops.rangepart import stacked_range_buckets

TILE_A = TILE_B = 128  # pair-tile dims (csrc/intersect.cu TILE)
# bucket width of the range partition: the TPU kernel's VMEM limit, kept so
# the bucket layout and the routing equal the JAX package's; also the
# widest row the kernel is given (its callers range-partition wider rows)
PALLAS_MAX_WIDTH = 2048
# elements of [rows, cols, 2 * width] the plain version sorts at once
_PLAIN_BUDGET_ELEMS = 1 << 26

LAUNCHES = {"intersect": 0, "intersect_stacked": 0}


def _adjacent_dups(x: torch.Tensor) -> torch.Tensor:
    """Adjacent equal non-PAD elements along the last axis (sorted rows)."""
    return ((x[..., 1:] == x[..., :-1]) & (x[..., 1:] != int(PAD_ID))).sum(dim=-1, dtype=torch.int32)


def intersect_stacked_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[rows_a, rows_b] int32: per pair, Σ over buckets of the adjacent
    equal non-PAD elements of sort(A_r ++ B_r) — the JAX definition, as
    batched torch on whatever device the int32 tensors are on. A pair with
    an all-PAD row counts the other row's own duplicates, so only pairs of
    non-empty rows are sorted."""
    n_b, ra, w = a.shape
    out = torch.zeros((ra, b.shape[1]), dtype=torch.int32, device=a.device)
    for r in range(n_b):
        ar, br = a[r], b[r]
        out += _adjacent_dups(ar)[:, None] + _adjacent_dups(br)[None, :]
        rows_a = (ar[:, 0] != int(PAD_ID)).nonzero().flatten()
        rows_b = (br[:, 0] != int(PAD_ID)).nonzero().flatten()
        bb = br[rows_b]
        rb = bb.shape[0]
        step = max(1, _PLAIN_BUDGET_ELEMS // max(1, rb * 2 * w))
        for lo in range(0, rows_a.shape[0], step):
            ia = rows_a[lo : lo + step]
            c = ia.shape[0]
            x = torch.cat([ar[ia][:, None, :].expand(c, rb, w), bb[None].expand(c, rb, w)], dim=2)
            merged = _adjacent_dups(torch.sort(x, dim=2).values)
            # the merge's count replaces the two rows' own counts added above
            out[ia[:, None], rows_b[None, :]] += (
                merged - _adjacent_dups(ar[ia])[:, None] - _adjacent_dups(bb)[None, :]
            )
    return out


def intersect_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[rows_a, rows_b] int32 merge-intersect counts of [rows, W] rows."""
    return intersect_stacked_plain(a[None], b[None])


def _launch(a: torch.Tensor, b: torch.Tensor, symmetric: bool, what: str) -> torch.Tensor:
    """Check stacked [R, rows, W] operands and run the kernel (CUDA) or
    the plain version (CPU) in the requested layout."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"{what}: want A [R, rows_a, W] and B [R, rows_b, W], got "
                         f"{tuple(a.shape)}/{tuple(b.shape)}")
    if a.shape[1] % TILE_A or b.shape[1] % TILE_B:
        raise ValueError(f"{what}: rows must be multiples of {TILE_A}")
    if symmetric and a.shape[1] != b.shape[1]:
        raise ValueError(f"{what}: the symmetric layout compares a row set with itself")
    if a.device != b.device:
        raise ValueError(f"{what}: A and B must be on one device")
    same = b is a
    a = widen_ids(a).contiguous()
    b = a if same else widen_ids(b).contiguous()
    n_b, rows_a, width = a.shape
    rows_b = b.shape[1]
    if a.device.type == "cpu":
        full = intersect_stacked_plain(a, b)
        return _wrap_symmetric_plain(full) if symmetric else full
    if a.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {a.device}")
    if width > PALLAS_MAX_WIDTH or width % 4:
        raise ValueError(f"{what}: width {width} must be a multiple of 4 up to {PALLAS_MAX_WIDTH} "
                         "(wider rows go through intersect_counts' range partition)")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel reads rows as 16-byte vectors; operands must be 16-byte aligned")
    cols = (rows_a // TILE_A // 2 + 1) * TILE_B if symmetric else rows_b
    if n_b == 0:
        return torch.zeros((rows_a, cols), dtype=torch.int32, device=a.device)
    out = torch.empty((rows_a, cols), dtype=torch.int32, device=a.device)
    fn = _build.load("intersect").intersect_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n_b, rows_a, rows_b, width,
            int(symmetric), _build.stream_handle(a.device))
    _build.check(rc, what)
    LAUNCHES[what] += 1
    return out


def intersect(a: torch.Tensor, b: torch.Tensor, symmetric: bool = False) -> torch.Tensor:
    """Merge-intersect counts of [rows, W] sorted id rows (int32 PAD_ID or
    uint16 0xFFFF; rows a multiple of TILE_A). `symmetric` (a is b)
    returns the wrapped half-grid [n, (t//2+1)*TILE_B] (unwrap with
    :func:`unwrap_symmetric`), else the rectangle [rows_a, rows_b]."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"intersect: want [rows, W] rows, got {tuple(a.shape)}/{tuple(b.shape)}")
    a3 = a[None]
    return _launch(a3, a3 if b is a else b[None], symmetric, "intersect")


def intersect_stacked(a: torch.Tensor, b: torch.Tensor, symmetric: bool = False) -> torch.Tensor:
    """Merge-intersect counts summed over the R stacked id-range buckets
    of [R, rows, W] tensors; layouts as :func:`intersect`."""
    return _launch(a, b, symmetric, "intersect_stacked")


def _pad_cols_pow2(ids: np.ndarray, s2: int) -> np.ndarray:
    if ids.shape[1] == s2:
        return ids
    out = np.full((ids.shape[0], s2), PAD_ID, dtype=ids.dtype)
    out[:, : ids.shape[1]] = ids
    return out


def _pad_rows(ids: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad the row axis of [N, W] (axis 0) or stacked [R, N, W] (axis 1)
    to a tile multiple with the dtype's pad sentinel."""
    n = ids.shape[axis]
    nt = -(-n // multiple) * multiple
    if nt == n:
        return ids
    widths = [(0, 0)] * ids.ndim
    widths[axis] = (0, nt - n)
    return np.pad(ids, widths, constant_values=pad_sentinel(ids.dtype))


def _merge_width(*widths: int) -> int:
    return max(128, next_pow2(max(widths)))


def intersect_counts(a_ids: np.ndarray, b_ids: np.ndarray, device: torch.device) -> np.ndarray:
    """int32 [na, nb] merge-intersect counts of sorted PAD_ID-padded int32
    rows — pallas_merge.py::intersect_counts_pallas, with rows past
    PALLAS_MAX_WIDTH always range-partitioned (its `force="range"`)."""
    require_int32_ids(a_ids, "intersect_counts")
    require_int32_ids(b_ids, "intersect_counts")
    na, nb = a_ids.shape[0], b_ids.shape[0]
    s2 = _merge_width(a_ids.shape[1], b_ids.shape[1])
    a = _pad_cols_pow2(np.ascontiguousarray(a_ids), s2)
    b = _pad_cols_pow2(np.ascontiguousarray(b_ids), s2)
    if s2 <= PALLAS_MAX_WIDTH:
        inter = intersect(ids_to_device(_pad_rows(a, TILE_A), device),
                          ids_to_device(_pad_rows(b, TILE_B), device))
    else:
        a_st, b_st = stacked_range_buckets([a, b], PALLAS_MAX_WIDTH)
        if a_st.shape[0] == 0:
            return np.zeros((na, nb), dtype=np.int32)
        inter = intersect_stacked(ids_to_device(_pad_rows(a_st, TILE_A, axis=1), device),
                                  ids_to_device(_pad_rows(b_st, TILE_B, axis=1), device))
    return inter.cpu().numpy()[:na, :nb]


def self_operand(ids: np.ndarray) -> np.ndarray:
    """The host operand :func:`intersect_counts_self` sends to the device:
    [rows, s2] rows for :func:`intersect` when the pow2 width s2 <=
    PALLAS_MAX_WIDTH, else the [R, rows, W] range buckets for
    :func:`intersect_stacked`; rows padded to TILE_A."""
    require_int32_ids(ids, "intersect_counts_self")
    a = _pad_cols_pow2(np.ascontiguousarray(ids), _merge_width(ids.shape[1]))
    if a.shape[1] <= PALLAS_MAX_WIDTH:
        return _pad_rows(a, TILE_A)
    (stacked,) = stacked_range_buckets([a], PALLAS_MAX_WIDTH)
    return _pad_rows(stacked, TILE_A, axis=1)


# seconds of each part of the last intersect_counts_self call: operand
# (column pad, bucket plan, row pad), h2d, kernel (CUDA events on a CUDA
# device, else the wall clock of the plain version), kernel_d2h (launch
# to counts on the host), unwrap
STAGE_SECONDS: dict[str, float] = {}


def intersect_counts_self(ids: np.ndarray, device: torch.device) -> np.ndarray:
    """int32 [n, n] merge-intersect counts within one row set through the
    wrapped symmetric half-grid, mirrored on the host —
    pallas_merge.py::intersect_counts_pallas_self (range path past
    PALLAS_MAX_WIDTH, the same bucket set for both sides)."""
    n = ids.shape[0]
    STAGE_SECONDS.clear()
    t0 = time.perf_counter()
    op = self_operand(ids)
    t1 = time.perf_counter()
    STAGE_SECONDS["operand"] = t1 - t0
    if op.ndim == 3 and op.shape[0] == 0:
        return np.zeros((n, n), dtype=np.int32)
    d = ids_to_device(op, device)
    t2 = time.perf_counter()
    events = None
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    compact = (intersect if op.ndim == 2 else intersect_stacked)(d, d, symmetric=True)
    if events is not None:
        events[1].record()
    host = compact.cpu().numpy()
    t3 = time.perf_counter()
    inter = unwrap_symmetric(host, TILE_A)[:n, :n]
    STAGE_SECONDS.update(
        h2d=t2 - t1,
        kernel=events[0].elapsed_time(events[1]) / 1e3 if events is not None else t3 - t2,
        kernel_d2h=t3 - t2,
        unwrap=time.perf_counter() - t3,
    )
    return inter


def all_vs_all_containment_merge(
    packed: PackedSketches, k: int, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """(symmetric max-containment ani, directional cov) [N, N] through the
    merge kernel — pallas_merge.py::all_vs_all_containment_pallas."""
    inter = intersect_counts_self(packed.ids, device)
    return ani_cov_from_intersections(inter, packed.counts, k)
