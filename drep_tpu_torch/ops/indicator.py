"""Exact intersection counts of a pack's rows by the 0/1 indicator product:
CUDA kernel wrapper and its plain PyTorch version.

Counterpart of drep_tpu/ops/pallas_indicator.py fused with the int8 dot
that reads its rows: the JAX package's one-shot secondary builds the
[m, v_pad] indicator (ids >= v_pad, PAD_ID included, contribute nothing)
and multiplies its upper block triangle
(containment.py::_intersect_matmul_tri_jit), then mirrors the lower blocks
on the host. :func:`indicator_intersections` computes the same [m, m]
int32 counts: ``csrc/indicator_mm.cu`` for a CUDA tensor (one launch; the
indicator never reaches device memory), :func:`indicator_intersections_plain`
for a CPU tensor. :func:`indicator_rect_intersections` is the rectangular
[na, nb] product of two packs (containment.py::_intersect_matmul_rect_jit,
the greedy secondary's block-versus-representatives counts): the same
kernel's rectangular entry, or :func:`indicator_rect_intersections_plain`.
:func:`indicator` stays as the validating plain scatter the plain versions
build on.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.minhash import PAD_ID, widen_ids

LAUNCHES = {"indicator_mm": 0, "indicator_mm_rect": 0}
# the counts are bumped under a lock: a serve process launches from
# several threads (a replica's batch loop, a router's merge)
_LAUNCH_LOCK = threading.Lock()
ROW_BUCKET_MIN = 64  # smallest row bucket of the containment matmul (pow2 above)
KC = 256  # csrc/mm_block.cuh: vocabulary ids a chunk
MAX_V_PAD = 1 << 30  # csrc/indicator_mm.cu keeps chunk bounds in int32
# The fewest ids a row may hold per KC-id chunk, on the mean over a full
# row (width x KC / v_pad), for the kernel's producers to read each row
# with 8 lanes of a warp, 32 ids a load (the dense walk), rather than with
# one thread, an id a load (the sparse walk, which jumps past chunks the
# tile does not touch). From both walks timed at the
# secondary's shapes on one H100 (PERF.md).
DENSE_MIN_IDS_PER_CHUNK = 2


def indicator_plain(ids: torch.Tensor, v_pad: int) -> torch.Tensor:
    """The JAX package's scatter (containment.py::_indicator, XLA branch):
    every id >= v_pad lands in a trash column that is sliced away."""
    m = ids.shape[0]
    cols = torch.where(ids < v_pad, ids, torch.full_like(ids, v_pad)).to(torch.int64)
    out = torch.zeros((m, v_pad + 1), dtype=torch.int8, device=ids.device)
    out.scatter_(1, cols, 1)
    return out[:, :v_pad].contiguous()


def _check(ids: torch.Tensor, v_pad: int, what: str) -> None:
    if ids.dim() != 2:
        raise ValueError(f"{what}: want ids [m, W], got {tuple(ids.shape)}")
    if v_pad <= 0 or v_pad % 16:
        raise ValueError(f"{what}: v_pad {v_pad} must be a positive multiple of 16")


def indicator(ids: torch.Tensor, v_pad: int) -> torch.Tensor:
    """[m, v_pad] int8 indicator of sorted id rows (int32 with PAD_ID, or a
    uint16 pack with 0xFFFF), on the tensor's device."""
    _check(ids, v_pad, "indicator")
    return indicator_plain(widen_ids(ids).contiguous(), v_pad)


def tri_row_block(m_pad: int) -> int:
    """Row-block size of the triangular matmul schedule: a power of two
    dividing the pow2-bucketed `m_pad`, targeting 8 block rows."""
    return max(ROW_BUCKET_MIN, m_pad // 8)


def triangle_counts(ind: torch.Tensor) -> torch.Tensor:
    """[m, m] int32 counts of one [m, v_pad] int8 indicator as the JAX
    package's triangular schedule computes them: per row block `lo` (of
    :func:`tri_row_block` rows) one exact int8 x int8 -> int32 product
    against all columns from `lo` on, then the lower blocks mirrored in."""
    m = ind.shape[0]
    tb = tri_row_block(m)
    out = torch.zeros((m, m), dtype=torch.int32, device=ind.device)
    for lo in range(0, m, tb):
        out[lo : lo + tb, lo:] = torch._int_mm(ind[lo : lo + tb], ind[lo:].T)
    for lo in range(tb, m, tb):
        out[lo : lo + tb, :lo] = out[:lo, lo : lo + tb].T
    return out


def indicator_intersections_plain(ids: torch.Tensor, v_pad: int) -> torch.Tensor:
    """[m, m] int32 counts in plain torch on the tensor's device, as the
    JAX package computes them: the scatter, then :func:`triangle_counts`."""
    return triangle_counts(indicator_plain(widen_ids(ids).contiguous(), v_pad))


def indicator_rect_intersections_plain(a: torch.Tensor, b: torch.Tensor, v_pad: int) -> torch.Tensor:
    """[na, nb] int32 counts in plain torch on the tensors' device, as the
    JAX package computes them (_intersect_matmul_rect_jit): both scatters,
    then one int32 product of the two indicators."""
    a_ind = indicator_plain(widen_ids(a).contiguous(), v_pad)
    b_ind = indicator_plain(widen_ids(b).contiguous(), v_pad)
    return torch._int_mm(a_ind, b_ind.T)


def dense_walk(width: int, v_pad: int) -> bool:
    """The walk csrc/indicator_mm.cu's producers take for rows of `width`
    over `v_pad`: dense where a full row holds DENSE_MIN_IDS_PER_CHUNK ids
    or more a chunk."""
    return width * KC >= DENSE_MIN_IDS_PER_CHUNK * v_pad


def _aligned(ids: torch.Tensor) -> torch.Tensor:
    """int32 rows as the dense walk reads them, in 16-byte pieces: a width
    that is not a multiple of 4, or rows not 16-byte aligned, are copied
    into PAD-padded rows first."""
    if ids.shape[1] % 4 or ids.data_ptr() % 16:
        ids = torch.nn.functional.pad(ids, (0, -ids.shape[1] % 4), value=int(PAD_ID))
    return ids


def _launch(ids: torch.Tensor, v_pad: int, out: torch.Tensor, dense: bool) -> None:
    """One launch of csrc/indicator_mm.cu on int32 ids with the walk
    given (the measurement scripts time both walks through it)."""
    ids = _aligned(ids)
    m, width = ids.shape
    fn = _build.load("indicator_mm").indicator_mm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(ids.device):
        rc = fn(ids.data_ptr(), out.data_ptr(), m, width, v_pad, int(dense), _build.stream_handle(ids.device))
    _build.check(rc, "indicator_intersections")
    with _LAUNCH_LOCK:
        LAUNCHES["indicator_mm"] += 1


def indicator_intersections(ids: torch.Tensor, v_pad: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """[m, m] int32 |set(row_i) ∩ set(row_j)| over the ids below `v_pad`
    of sorted id rows (int32 with PAD_ID, or a uint16 pack with 0xFFFF),
    added into `out` (zeros when None) and returned. CUDA tensors launch
    ``csrc/indicator_mm.cu`` (the walk by :func:`dense_walk`), CPU tensors
    run :func:`indicator_intersections_plain`."""
    _check(ids, v_pad, "indicator_intersections")
    ids = widen_ids(ids).contiguous()
    m = ids.shape[0]
    if out is None:
        out = torch.zeros((m, m), dtype=torch.int32, device=ids.device)
    elif out.shape != (m, m) or out.dtype != torch.int32 or not out.is_contiguous() or out.device != ids.device:
        raise ValueError(f"indicator_intersections: out must be a contiguous [{m}, {m}] int32 tensor on {ids.device}")
    if ids.device.type == "cpu":
        out += indicator_intersections_plain(ids, v_pad)
        return out
    if ids.device.type != "cuda":
        raise ValueError(f"indicator_intersections: unsupported device {ids.device}")
    if v_pad > MAX_V_PAD:
        raise ValueError(f"indicator_intersections: v_pad {v_pad} past the kernel's {MAX_V_PAD}")
    _launch(ids, v_pad, out, dense_walk(ids.shape[1], v_pad))
    return out


def _launch_rect(a: torch.Tensor, b: torch.Tensor, v_pad: int, out: torch.Tensor, dense: bool) -> None:
    """One launch of csrc/indicator_mm.cu's rectangular entry on int32 ids
    of one width with the walk given."""
    a, b = _aligned(a), _aligned(b)
    fn = _build.load("indicator_mm").indicator_mm_rect_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0], a.shape[1], v_pad, int(dense),
                _build.stream_handle(a.device))
    _build.check(rc, "indicator_rect_intersections")
    with _LAUNCH_LOCK:
        LAUNCHES["indicator_mm_rect"] += 1


def indicator_rect_intersections(
    a: torch.Tensor, b: torch.Tensor, v_pad: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """[na, nb] int32 |set(a_i) ∩ set(b_j)| over the ids below `v_pad` of
    two packs of sorted id rows of one width on one device (int32 with
    PAD_ID, or uint16 packs with 0xFFFF), added into `out` (zeros when
    None) and returned. CUDA tensors launch csrc/indicator_mm.cu's
    rectangular entry (the walk by :func:`dense_walk`), CPU tensors run
    :func:`indicator_rect_intersections_plain`."""
    _check(a, v_pad, "indicator_rect_intersections")
    _check(b, v_pad, "indicator_rect_intersections")
    if a.device != b.device or a.shape[1] != b.shape[1]:
        raise ValueError(f"indicator_rect_intersections: want packs of one width on one device, got "
                         f"{tuple(a.shape)} on {a.device} and {tuple(b.shape)} on {b.device}")
    a, b = widen_ids(a).contiguous(), widen_ids(b).contiguous()
    shape = (a.shape[0], b.shape[0])
    if out is None:
        out = torch.zeros(shape, dtype=torch.int32, device=a.device)
    elif out.shape != shape or out.dtype != torch.int32 or not out.is_contiguous() or out.device != a.device:
        raise ValueError(f"indicator_rect_intersections: out must be a contiguous {list(shape)} int32 tensor "
                         f"on {a.device}")
    if a.device.type == "cpu":
        out += indicator_rect_intersections_plain(a, b, v_pad)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"indicator_rect_intersections: unsupported device {a.device}")
    if v_pad > MAX_V_PAD:
        raise ValueError(f"indicator_rect_intersections: v_pad {v_pad} past the kernel's {MAX_V_PAD}")
    _launch_rect(a, b, v_pad, out, dense_walk(a.shape[1], v_pad))
    return out
