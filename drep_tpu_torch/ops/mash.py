"""The exact Mash union-bottom-s estimator: CUDA kernel wrapper, its plain
PyTorch version, and the all-vs-all and rectangular callers.

Counterpart of drep_tpu/ops/pallas_mash.py. For each pair of packed
sketch rows the kernel returns one int32 `shared` count: the ids present
in both rows among the bottom-s_use distinct ids of their union, with
s_use = min(|A|, |B|, s_orig). The jaccard -> distance transform runs on
the host in numpy (:func:`shared_counts_to_distance`, copied exactly from
the JAX package), so every consumer shares one formula; the streaming
primary's keep test (:func:`stripe_survivors`) reads a table that formula
built, so its edges are the dense matrix's, bit for bit; the serve
daemon's walk over the resident index (:func:`rect_survivors`) reads the
same table.

:func:`mash_shared` runs ``csrc/mash_shared.cu`` for CUDA tensors and
:func:`mash_shared_plain` for CPU tensors; there is no fallback between
them.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.minhash import PAD_ID, mash_distance_from_jaccard

TILE = 128  # both pair-tile dims (csrc/mash_shared.cu TILE)
# elements of [rows, cols, 2 * width] the plain version merges at once
_PLAIN_BUDGET_ELEMS = 1 << 26

LAUNCHES = {"mash_shared": 0}
# the count is bumped under a lock: a serve replica launches from its
# batch loop and from connection threads (classify_part legs)
_LAUNCH_LOCK = threading.Lock()


def _check_rows(x: torch.Tensor, n: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or n.dtype != torch.int32:
        raise TypeError(f"{what}: ids and counts must be int32, got {x.dtype}/{n.dtype}")
    if x.dim() != 2 or n.dim() != 1 or n.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: want ids [rows, W] and counts [rows], got {tuple(x.shape)}/{tuple(n.shape)}")
    if not (x.is_contiguous() and n.is_contiguous()):
        raise ValueError(f"{what}: ids and counts must be contiguous")


def mash_shared_plain(
    a: torch.Tensor, na: torch.Tensor, b: torch.Tensor, nb: torch.Tensor, s_orig: int
) -> torch.Tensor:
    """[rows_a, rows_b] int32 shared counts, the batched torch form of
    drep_tpu/ops/minhash.py::_pair_shared: sort each concatenated pair,
    flag duplicates, rank distinct ids by cumsum, count duplicates whose
    rank is within s_use. Runs on whatever device the tensors are on."""
    ra, w = a.shape
    rb = b.shape[0]
    out = torch.empty((ra, rb), dtype=torch.int32, device=a.device)
    step = max(1, _PLAIN_BUDGET_ELEMS // max(1, rb * 2 * w))
    nb_row = nb.view(1, rb)
    for lo in range(0, ra, step):
        blk = a[lo : lo + step]
        c = blk.shape[0]
        x = torch.cat([blk[:, None, :].expand(c, rb, w), b[None].expand(c, rb, w)], dim=2)
        x = torch.sort(x, dim=2).values
        real = x != int(PAD_ID)
        dup = torch.zeros_like(real)
        dup[..., 1:] = (x[..., 1:] == x[..., :-1]) & real[..., 1:]
        rank = torch.cumsum((real & ~dup).to(torch.int32), dim=2)
        s_use = torch.clamp(torch.minimum(na[lo : lo + step, None], nb_row), max=s_orig)
        out[lo : lo + step] = (dup & (rank <= s_use[..., None])).sum(dim=2, dtype=torch.int32)
    return out


def _wrap_symmetric_plain(full: torch.Tensor) -> torch.Tensor:
    """Full [n, n] counts -> the wrapped [n, (t//2+1)*TILE] layout the
    symmetric kernel writes."""
    n = full.shape[0]
    t = n // TILE
    th = t // 2 + 1
    out = torch.empty((n, th * TILE), dtype=full.dtype, device=full.device)
    for i in range(t):
        for jj in range(th):
            j = (i + jj) % t
            out[i * TILE : (i + 1) * TILE, jj * TILE : (jj + 1) * TILE] = full[
                i * TILE : (i + 1) * TILE, j * TILE : (j + 1) * TILE
            ]
    return out


def mash_shared(
    a: torch.Tensor,
    na: torch.Tensor,
    b: torch.Tensor,
    nb: torch.Tensor,
    s_orig: int,
    symmetric: bool = False,
) -> torch.Tensor:
    """Shared counts for row tiles of packed sketches (rows a multiple of
    TILE, one common width). `symmetric` (a is b) returns the wrapped
    half-grid [n, (t//2+1)*TILE] (unwrap with :func:`unwrap_symmetric`),
    else the rectangle [rows_a, rows_b]. CUDA tensors run the kernel (any
    width: rows too wide to stage whole go through per-warp windows), CPU
    tensors the plain version."""
    _check_rows(a, na, "mash_shared A")
    _check_rows(b, nb, "mash_shared B")
    if a.shape[1] != b.shape[1]:
        raise ValueError("mash_shared: A and B must share one width (pad with PAD_ID)")
    if a.shape[0] % TILE or b.shape[0] % TILE:
        raise ValueError(f"mash_shared: rows must be multiples of {TILE}")
    if symmetric and a.shape[0] != b.shape[0]:
        raise ValueError("mash_shared: the symmetric layout compares a row set with itself")
    if len({a.device, na.device, b.device, nb.device}) != 1:
        raise ValueError("mash_shared: all operands must be on one device")
    width = a.shape[1]
    if a.device.type == "cpu":
        full = mash_shared_plain(a, na, b, nb, s_orig)
        return _wrap_symmetric_plain(full) if symmetric else full
    if a.device.type != "cuda":
        raise ValueError(f"mash_shared: unsupported device {a.device}")
    rows_a, rows_b = a.shape[0], b.shape[0]
    t = rows_a // TILE
    cols = (t // 2 + 1) * TILE if symmetric else rows_b
    out = torch.empty((rows_a, cols), dtype=torch.int32, device=a.device)
    lib = _build.load("mash_shared")
    fn = lib.mash_shared_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(
        a.data_ptr(), na.data_ptr(), b.data_ptr(), nb.data_ptr(), out.data_ptr(),
        rows_a, rows_b, width, int(s_orig), int(symmetric), _build.stream_handle(a.device),
    )
    _build.check(rc, "mash_shared")
    with _LAUNCH_LOCK:
        LAUNCHES["mash_shared"] += 1
    return out


def unwrap_symmetric(compact: np.ndarray, tile: int = TILE) -> np.ndarray:
    """[n, th*tile] wrapped-compact tiles -> full symmetric [n, n] (host
    mirror; drep_tpu/ops/pallas_merge.py::_unwrap_symmetric)."""
    n = compact.shape[0]
    t = n // tile
    th = compact.shape[1] // tile
    out = np.empty((n, n), dtype=compact.dtype)
    for i in range(t):
        rows = slice(i * tile, (i + 1) * tile)
        for jj in range(th):
            j = (i + jj) % t
            cols = slice(j * tile, (j + 1) * tile)
            blk = compact[rows, jj * tile : (jj + 1) * tile]
            out[rows, cols] = blk
            out[cols, rows] = blk.T
    return out


def shared_counts_to_distance(
    shared: np.ndarray,
    a_counts: np.ndarray,
    b_counts: np.ndarray,
    s_orig: int,
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(distance, jaccard) float32 from raw `shared` counts — the JAX
    package's transform (pallas_mash.py::shared_counts_to_distance with
    xp=np), all-float32 intermediates."""
    s_use = np.minimum(
        np.minimum(a_counts.astype(np.int32)[:, None], b_counts.astype(np.int32)[None, :]),
        np.int32(s_orig),
    ).astype(np.float32)
    j = np.where(
        s_use > 0, shared.astype(np.float32) / np.maximum(s_use, np.float32(1.0)), np.float32(0.0)
    ).astype(np.float32)
    dist = mash_distance_from_jaccard(j, k).astype(np.float32)
    return dist, j


def distance_table(width: int, k: int) -> np.ndarray:
    """[width + 1, width + 1] float32: entry [s_use, shared] is the Mash
    distance of a pair with that s_use and shared count, computed by
    :func:`shared_counts_to_distance` itself, so a lookup equals the dense
    matrix's entry bit for bit (entries with shared > s_use never occur)."""
    s = np.arange(width + 1, dtype=np.int32)
    shared = np.broadcast_to(s[None, :], (width + 1, width + 1))
    dist, _ = shared_counts_to_distance(shared, s, np.full(width + 1, width, np.int32), width, k)
    return dist


def _keep_mask(
    shared: torch.Tensor, na: torch.Tensor, nb: torch.Tensor, s_orig: int, keep_table: torch.Tensor
) -> torch.Tensor:
    """``keep_table[s_use, shared]`` with s_use = min(na, nb, s_orig),
    and the pad-row mask (a row of count 0 keeps nothing)."""
    s_use = torch.clamp(torch.minimum(na[:, None], nb[None, :]), max=s_orig)
    if (s_orig + 1) ** 2 > np.iinfo(np.int32).max:  # the flat index outgrows int32
        s_use = s_use.long()
    keep = keep_table.reshape(-1)[s_use * (s_orig + 1) + shared]
    keep &= (na > 0)[:, None] & (nb > 0)[None, :]
    return keep


def stripe_survivors(
    a: torch.Tensor,
    na: torch.Tensor,
    b: torch.Tensor,
    nb: torch.Tensor,
    s_orig: int,
    keep_table: torch.Tensor,
    diag: bool,
) -> np.ndarray:
    """The pairs of one row stripe that a keep table retains, compacted on
    the stripe's device: one :func:`mash_shared` launch of the stripe rows
    `a` [block, W] against their column tiles `b` [n_tiles * block, W]
    (ascending, concatenated), then the keep test
    ``keep_table[s_use, shared]``, the pad-row mask (count 0) and, with
    `diag`, the i < j mask on the first tile (the stripe's own), all as
    plain torch. Returns [E, 4] int64 rows (tile, row, col, shared) in the
    JAX package's edge order: tile by tile, row-major inside a tile."""
    block = a.shape[0]
    n_tiles = b.shape[0] // block
    shared = mash_shared(a, na, b, nb, s_orig)
    keep = _keep_mask(shared, na, nb, s_orig, keep_table)
    if diag:
        keep[:, :block] &= torch.ones((block, block), dtype=torch.bool, device=a.device).triu(1)
    tiles = keep.view(block, n_tiles, block).permute(1, 0, 2)
    t, r, c = tiles.nonzero(as_tuple=True)
    got = shared.view(block, n_tiles, block)[r, t, c]
    return torch.stack([t, r, c, got.long()], dim=1).cpu().numpy()


def rect_survivors(
    a: torch.Tensor,
    na: torch.Tensor,
    b: torch.Tensor,
    nb: torch.Tensor,
    s_orig: int,
    keep_table: torch.Tensor,
) -> np.ndarray:
    """The pairs of the rectangle `a` x `b` that a keep table retains,
    compacted on the operands' device: one :func:`mash_shared` launch of
    the rows `a` [rows_a, W] against `b` [rows_b, W] (both TILE multiples,
    pad rows of count 0), then the keep test and the pad-row mask of
    :func:`stripe_survivors`. Returns [E, 3] int64 rows (row of a, row of
    b, shared), row-major: ascending by a's row, then b's."""
    shared = mash_shared(a, na, b, nb, s_orig)
    r, c = _keep_mask(shared, na, nb, s_orig, keep_table).nonzero(as_tuple=True)
    return torch.stack([r, c, shared[r, c].long()], dim=1).cpu().numpy()


def _pad_rows(ids: np.ndarray, counts: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    rows = -(-ids.shape[0] // TILE) * TILE
    out = np.full((rows, width), PAD_ID, dtype=np.int32)
    out[: ids.shape[0], : ids.shape[1]] = ids
    cnt = np.zeros(rows, dtype=np.int32)
    cnt[: counts.shape[0]] = counts
    return out, cnt


def shared_all_vs_all(packed, device: torch.device) -> np.ndarray:
    """[N, N] int32 shared counts of one packed sketch set: the wrapped
    symmetric grid on the device (upper triangle of tiles), mirrored on
    the host."""
    n, width = packed.ids.shape
    a, cc = _pad_rows(packed.ids, packed.counts, width)
    a_d = torch.from_numpy(a).to(device)
    c_d = torch.from_numpy(cc).to(device)
    compact = mash_shared(a_d, c_d, a_d, c_d, s_orig=width, symmetric=True).cpu().numpy()
    return unwrap_symmetric(compact, TILE)[:n, :n]


def all_vs_all_mash(packed, k: int, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Full [N, N] (distance, jaccard) for one packed sketch set — the
    counterpart of pallas_mash.py::all_vs_all_mash_pallas, same output
    contract (diagonal distance 0, jaccard 1)."""
    width = packed.ids.shape[1]
    shared = shared_all_vs_all(packed, device)
    dist, j = shared_counts_to_distance(shared, packed.counts, packed.counts, width, k)
    np.fill_diagonal(dist, 0.0)
    np.fill_diagonal(j, 1.0)
    return dist, j


def mash_distance_tile(
    a_ids, a_counts, b_ids, b_counts, *, k: int = 21, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """[Ta, Tb] (distance, jaccard) between two packed sketch blocks that
    share one id space — pallas_mash.py::mash_distance_tile_pallas. Rows
    are padded to TILE multiples and widths to the wider block."""
    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    a_counts, b_counts = np.asarray(a_counts), np.asarray(b_counts)
    na, nb = a_ids.shape[0], b_ids.shape[0]
    s_orig = max(a_ids.shape[1], b_ids.shape[1])
    a, ca = _pad_rows(a_ids, a_counts, s_orig)
    b, cb = _pad_rows(b_ids, b_counts, s_orig)
    shared = mash_shared(
        torch.from_numpy(a).to(device), torch.from_numpy(ca).to(device),
        torch.from_numpy(b).to(device), torch.from_numpy(cb).to(device),
        s_orig=s_orig,
    ).cpu().numpy()[:na, :nb]
    return shared_counts_to_distance(shared, a_counts, b_counts, s_orig, k)
