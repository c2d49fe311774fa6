"""One step of the dense all-pairs ring, fused with the rotation of its B
operand: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of drep_tpu/ops/pallas_ring.py (the merge variant of
``_fused_step_kernel``). A ring position holds an A block and the current
B block: ``n_local`` sorted PAD_ID-padded int32 id rows of one width, with
their counts. :func:`ring_step` returns the step's ``[n_local, n_local]``
int32 tile and, when given receive buffers, writes B's ids and counts into
them in the same launch (``csrc/ring_step.cu``: one warp a pair walks the
merge path of ``csrc/merge_path.cuh`` over rows staged in shared memory,
or over per-warp windows of rows too wide to stage, so any width runs):

- ``"mash"``: union-bottom-s shared counts with s_use = min(n_a, n_b,
  width), as ops/mash.py counts them; the ring turns them into distances
  with :func:`ops.mash.shared_counts_to_distance`, as the single-device
  matrix does;
- ``"containment"``: per pair, the non-PAD A elements that occur in B
  (drep_tpu/ops/containment.py::_pair_intersection), |A ∩ B| on a scaled
  pack's unique ranks.

The indicator-matmul variant (the JAX ``variant="matmul"``, containment
only): :func:`ring_step_matmul` computes the containment tile as the sum
over vocabulary chunks of 0/1 indicator products below ``v_pad``
(``csrc/ring_step_mm.cu``: producer warpgroups scatter each chunk into
shared memory while consumer warpgroups multiply the one before with int8
``wgmma``), with the same copy. It
counts set membership, as the JAX indicator does: an id repeated in a row
counts once, where the merge step counts every copy; on a scaled pack's
unique ranks the two tiles are equal. :func:`pick_variant` picks the
variant a containment ring's rotating steps run from its v_pad and width.

CUDA tensors launch the kernel, CPU tensors run the plain version
(:func:`ring_step_plain`, :func:`ring_step_matmul_plain`); there is no
fallback between them. The receive buffers may sit on another card, whose
memory this one must be able to access (parallel/mesh.py checks it when it
deals the positions).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.containment import _pow2_bucket
from drep_tpu_torch.ops.mash import mash_shared_plain
from drep_tpu_torch.ops.minhash import PAD_ID

KINDS = ("mash", "containment")  # csrc/ring_step.cu `kind` 0 and 1
VARIANTS = ("merge", "matmul")
# kinds whose tile is the plain count-free |A ∩ B| over dense ranks — the
# only tile the indicator product can express
MATMUL_TILE_KINDS = ("containment",)
LANES = 128  # v_pad's granule (the JAX package's lane width)
MAX_V_PAD = 1 << 30  # csrc/ring_step_mm.cu keeps chunk bounds in int32
# The largest v_pad / W at which a containment ring runs the matmul step,
# from both steps timed at the ring's four block shapes on one H100
# (kernel_ab.py; the port bench is to re-fit it). Both steps cost n_local^2
# times a per-pair term: a merge pair walks its two rows (~W ids), a
# matmul pair the vocabulary chunks below v_pad that its tile touches. The
# matmul step was 7-8x faster at v_pad / W of 16 and 32; at 2 048 it tied
# on one cluster's blocks and was 2x slower on another's. The crossover
# sits between them, at their geometric middle.
MATMUL_MAX_VPAD_PER_WIDTH = 256
# elements of [rows, cols, width] the plain containment searches at once
_PLAIN_BUDGET_ELEMS = 1 << 25
# elements of one side's float32 indicator chunk in the plain matmul step
_PLAIN_INDICATOR_ELEMS = 1 << 26

LAUNCHES = {"ring_step": 0, "ring_step_mm": 0}

_peers: set[tuple[int, int]] = set()


def contained_counts_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[rows_a, rows_b] int32: per pair, the non-PAD elements of A_i found
    in B_j — a batched searchsorted of every A element into B, clipped and
    compared, as the JAX package's _pair_intersection."""
    ra, w = a.shape
    rb = b.shape[0]
    out = torch.empty((ra, rb), dtype=torch.int32, device=a.device)
    step = max(1, _PLAIN_BUDGET_ELEMS // max(1, rb * w))
    for lo in range(0, ra, step):
        blk = a[lo : lo + step]
        c = blk.shape[0]
        seq = b[None].expand(c, rb, w).contiguous()
        val = blk[:, None, :].expand(c, rb, w).contiguous()
        idx = torch.searchsorted(seq, val).clamp_(max=w - 1)
        hit = (torch.gather(seq, 2, idx) == val) & (val != int(PAD_ID))
        out[lo : lo + step] = hit.sum(dim=2, dtype=torch.int32)
    return out


def ring_step_plain(
    kind: str,
    a_ids: torch.Tensor,
    a_counts: torch.Tensor,
    b_ids: torch.Tensor,
    b_counts: torch.Tensor,
    dst_ids: torch.Tensor | None = None,
    dst_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """The step in plain torch on the tensors' device: the tile, then B
    copied into the receive buffers when given."""
    if kind == "mash":
        tile = mash_shared_plain(a_ids, a_counts, b_ids, b_counts, s_orig=a_ids.shape[1])
    else:
        tile = contained_counts_plain(a_ids, b_ids)
    if dst_ids is not None:
        dst_ids.copy_(b_ids)
        dst_counts.copy_(b_counts)
    return tile


def _span(x: torch.Tensor) -> tuple[int, int]:
    return x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    (x0, x1), (y0, y1) = _span(x), _span(y)
    return x.device == y.device and x0 < y1 and y0 < x1


def _check(kind, a_ids, a_counts, b_ids, b_counts, dst_ids, dst_counts) -> None:
    if kind not in KINDS:
        raise ValueError(f"ring_step: kind {kind!r}, expected one of {KINDS}")
    block = (a_ids, a_counts, b_ids, b_counts)
    if any(t.dtype != torch.int32 for t in block):
        raise TypeError("ring_step: ids and counts must be int32 (PAD_ID padding)")
    n_local, width = a_ids.shape if a_ids.dim() == 2 else (-1, -1)
    if b_ids.shape != (n_local, width) or a_counts.shape != (n_local,) or b_counts.shape != (n_local,):
        raise ValueError(
            f"ring_step: want A and B blocks of [n_local, W] ids and [n_local] counts, got "
            f"{tuple(a_ids.shape)}/{tuple(a_counts.shape)} and {tuple(b_ids.shape)}/{tuple(b_counts.shape)}"
        )
    if not all(t.is_contiguous() for t in block):
        raise ValueError("ring_step: ids and counts must be contiguous")
    if len({t.device for t in block}) != 1:
        raise ValueError("ring_step: A and B must be on one device")
    if (dst_ids is None) != (dst_counts is None):
        raise ValueError("ring_step: pass both receive buffers or neither")
    if dst_ids is None:
        return
    if dst_ids.shape != b_ids.shape or dst_counts.shape != b_counts.shape:
        raise ValueError("ring_step: the receive buffers must have B's shapes")
    if dst_ids.dtype != torch.int32 or dst_counts.dtype != torch.int32:
        raise TypeError("ring_step: the receive buffers must be int32")
    if not (dst_ids.is_contiguous() and dst_counts.is_contiguous()):
        raise ValueError("ring_step: the receive buffers must be contiguous")
    if dst_ids.device.type != a_ids.device.type or dst_counts.device != dst_ids.device:
        raise ValueError("ring_step: the receive buffers must be on one device of the blocks' type")
    if any(_overlaps(d, t) for d in (dst_ids, dst_counts) for t in block) or _overlaps(dst_ids, dst_counts):
        raise ValueError("ring_step: a receive buffer overlaps an operand")


def _enable_peer(lib: ctypes.CDLL, dev: int, peer: int) -> None:
    if (dev, peer) in _peers:
        return
    fn = lib.ring_enable_peer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    _build.check(fn(dev, peer), f"ring_step: enabling access from cuda:{dev} to cuda:{peer}")
    _peers.add((dev, peer))


def ring_step(
    kind: str,
    a_ids: torch.Tensor,
    a_counts: torch.Tensor,
    b_ids: torch.Tensor,
    b_counts: torch.Tensor,
    dst_ids: torch.Tensor | None = None,
    dst_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """[n_local, n_local] int32 tile of one ring step; with receive
    buffers, B's ids and counts are written into them by the same launch
    (``dst=None``: a step with nothing to rotate). CUDA tensors launch
    ``csrc/ring_step.cu`` on the blocks' card and its current stream, CPU
    tensors run :func:`ring_step_plain`."""
    _check(kind, a_ids, a_counts, b_ids, b_counts, dst_ids, dst_counts)
    dev = a_ids.device
    if dev.type == "cpu":
        return ring_step_plain(kind, a_ids, a_counts, b_ids, b_counts, dst_ids, dst_counts)
    if dev.type != "cuda":
        raise ValueError(f"ring_step: unsupported device {dev}")
    n_local, width = a_ids.shape
    lib = _build.load("ring_step")
    if dst_ids is not None and dst_ids.device != dev:
        _enable_peer(lib, dev.index, dst_ids.device.index)
    tile = torch.empty((n_local, n_local), dtype=torch.int32, device=dev)
    fn = lib.ring_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(
            a_ids.data_ptr(), a_counts.data_ptr(), b_ids.data_ptr(), b_counts.data_ptr(),
            tile.data_ptr(),
            None if dst_ids is None else dst_ids.data_ptr(),
            None if dst_counts is None else dst_counts.data_ptr(),
            n_local, width, KINDS.index(kind), _build.stream_handle(dev),
        )
    _build.check(rc, "ring_step")
    LAUNCHES["ring_step"] += 1
    return tile


def matmul_ring_vocab_pad(ids: np.ndarray) -> int:
    """The v_pad the matmul variant needs, from the host copy of the packed
    id matrix (before the blocks are dealt): the pow2 bucket (at least
    LANES) of max real id + 1. Packed ids are ranks into the pack's
    vocabulary, so PAD_ID never scatters."""
    real = ids[ids != PAD_ID]
    extent = int(real.max()) + 1 if real.size else 1
    return _pow2_bucket(extent, LANES)


def check_variant(kind: str, variant: str, v_pad: int = 0) -> None:
    """Raise ValueError where the JAX package's fused_ring_step_fn refuses
    a (kind, variant, v_pad): an unknown variant, matmul on a kind it
    cannot express, or a matmul v_pad that is not a positive multiple of
    LANES (nor at most MAX_V_PAD, the kernel's own limit)."""
    if variant not in VARIANTS:
        raise ValueError(f"ring variant {variant!r}: expected merge|matmul")
    if variant != "matmul":
        return
    if kind not in MATMUL_TILE_KINDS:
        raise ValueError(
            f"matmul ring variant supports {MATMUL_TILE_KINDS}, not {kind!r} "
            "(the mash tile counts union-bottom shared ids, not plain |A∩B|)"
        )
    if v_pad <= 0 or v_pad % LANES or v_pad > MAX_V_PAD:
        raise ValueError(
            f"matmul ring variant needs a positive {LANES}-multiple v_pad of at most {MAX_V_PAD}, got {v_pad}"
        )


def pick_variant(kind: str, v_pad: int, width: int) -> str:
    """The step a ring of `kind` runs on its rotating steps, from what it
    observes: matmul for a containment ring whose v_pad is at most
    MATMUL_MAX_VPAD_PER_WIDTH times its row width (and within the kernel's
    MAX_V_PAD), merge otherwise."""
    if kind in MATMUL_TILE_KINDS and v_pad <= min(MAX_V_PAD, MATMUL_MAX_VPAD_PER_WIDTH * width):
        return "matmul"
    return "merge"


def _chunk_indicator(ids: torch.Tensor, base: int, size: int) -> torch.Tensor:
    """[rows, size] float32 0/1: row r is 1 at id - base for each of its ids
    in [base, base + size); every other id lands in a trash column."""
    rel = ids.to(torch.int64) - base
    cols = torch.where((rel >= 0) & (rel < size), rel, torch.full_like(rel, size))
    out = torch.zeros((ids.shape[0], size + 1), dtype=torch.float32, device=ids.device)
    out.scatter_(1, cols, 1.0)
    return out[:, :size]


def ring_step_matmul_plain(
    a_ids: torch.Tensor,
    a_counts: torch.Tensor,
    b_ids: torch.Tensor,
    b_counts: torch.Tensor,
    v_pad: int,
    dst_ids: torch.Tensor | None = None,
    dst_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """The matmul step in plain torch on the tensors' device: the int32
    tile as the sum over vocabulary chunks of float32 0/1 indicator
    products (exact: every chunk's count is below 2^24), then B copied into
    the receive buffers when given. Rows need not be sorted."""
    del a_counts
    n = a_ids.shape[0]
    tile = torch.zeros((n, b_ids.shape[0]), dtype=torch.int32, device=a_ids.device)
    per_row = max(1, _PLAIN_INDICATOR_ELEMS // max(1, n))
    chunk = min(v_pad, max(LANES, 1 << (per_row.bit_length() - 1)))
    for base in range(0, v_pad, chunk):
        size = min(chunk, v_pad - base)
        prod = _chunk_indicator(a_ids, base, size) @ _chunk_indicator(b_ids, base, size).T
        tile += prod.to(torch.int32)
    if dst_ids is not None:
        dst_ids.copy_(b_ids)
        dst_counts.copy_(b_counts)
    return tile


def ring_step_matmul(
    a_ids: torch.Tensor,
    a_counts: torch.Tensor,
    b_ids: torch.Tensor,
    b_counts: torch.Tensor,
    v_pad: int,
    dst_ids: torch.Tensor | None = None,
    dst_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """[n_local, n_local] int32 containment tile of one ring step by the
    indicator product over ids below `v_pad` (rows ascending, ids >= 0);
    with receive buffers, B's ids and counts are written into them by the
    same launch. CUDA tensors launch ``csrc/ring_step_mm.cu`` on the
    blocks' card and its current stream, CPU tensors run
    :func:`ring_step_matmul_plain`."""
    _check("containment", a_ids, a_counts, b_ids, b_counts, dst_ids, dst_counts)
    check_variant("containment", "matmul", v_pad)
    dev = a_ids.device
    if dev.type == "cpu":
        return ring_step_matmul_plain(a_ids, a_counts, b_ids, b_counts, v_pad, dst_ids, dst_counts)
    if dev.type != "cuda":
        raise ValueError(f"ring_step_matmul: unsupported device {dev}")
    n_local, width = a_ids.shape
    lib = _build.load("ring_step_mm")
    if dst_ids is not None and dst_ids.device != dev:
        _enable_peer(_build.load("ring_step"), dev.index, dst_ids.device.index)
    tile = torch.empty((n_local, n_local), dtype=torch.int32, device=dev)
    fn = lib.ring_step_mm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(
            a_ids.data_ptr(), b_ids.data_ptr(), b_counts.data_ptr(), tile.data_ptr(),
            None if dst_ids is None else dst_ids.data_ptr(),
            None if dst_counts is None else dst_counts.data_ptr(),
            n_local, width, v_pad, _build.stream_handle(dev),
        )
    _build.check(rc, "ring_step_matmul")
    LAUNCHES["ring_step_mm"] += 1
    return tile
