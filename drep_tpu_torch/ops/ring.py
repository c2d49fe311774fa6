"""One step of the dense all-pairs ring, fused with the rotation of its B
operand: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of drep_tpu/ops/pallas_ring.py (the merge variant of
``_fused_step_kernel``). A ring position holds an A block and the current
B block: ``n_local`` sorted PAD_ID-padded int32 id rows of one width, with
their counts. :func:`ring_step` returns the step's ``[n_local, n_local]``
int32 tile and, when given receive buffers, writes B's ids and counts into
them in the same launch (``csrc/ring_step.cu``, at any width: the kernel
stages the A row in shared memory a piece at a time):

- ``"mash"``: union-bottom-s shared counts with s_use = min(n_a, n_b,
  width), as ops/mash.py counts them; the ring turns them into distances
  with :func:`ops.mash.shared_counts_to_distance`, as the single-device
  matrix does;
- ``"containment"``: per pair, the non-PAD A elements that occur in B
  (drep_tpu/ops/containment.py::_pair_intersection), |A ∩ B| on a scaled
  pack's unique ranks.

CUDA tensors launch the kernel, CPU tensors run :func:`ring_step_plain`;
there is no fallback between them. The receive buffers may sit on another
card, whose memory this one must be able to access (parallel/mesh.py
checks it when it deals the positions).
"""

from __future__ import annotations

import ctypes

import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.mash import mash_shared_plain
from drep_tpu_torch.ops.minhash import PAD_ID

KINDS = ("mash", "containment")  # csrc/ring_step.cu `kind` 0 and 1
# elements of [rows, cols, width] the plain containment searches at once
_PLAIN_BUDGET_ELEMS = 1 << 25

LAUNCHES = {"ring_step": 0}

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
