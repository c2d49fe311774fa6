"""Mesh-sharded all-pairs comparison: the dense ring.

Counterpart of drep_tpu/parallel/allpairs.py, in one process. Genomes are
row-sharded over the D positions of a mesh (parallel/mesh.py): position m
holds A block m and a B operand that starts as its own block and moves one
hop around the ring each step, so at step i position m computes block
(m, (m - i) mod D).

Half-ring schedule: both tiles are symmetric (tile(A, B) == tile(B, A).T),
so only ``D // 2 + 1`` of the D steps run; for even D the last (middle)
step is self-paired across the two halves of the ring and only positions
m < D/2 keep it. The host mirrors the transposed blocks into the rest.
``full_grid=True`` runs all D steps (the equality reference).

Every step of every position is one launch of the fused kernel
(ops/ring.py), which computes the tile and writes the B operand into the
neighbour's receive buffer: ``csrc/ring_step.cu`` (the merge variant), or,
for a containment ring under the matmul variant (``variant``, by default
ops/ring.py::pick_variant on the ring's v_pad and width),
``csrc/ring_step_mm.cu``. The final step has nothing to rotate and runs
the same kernel without the copy (the JAX package runs a plain XLA
program there; both tiles are equal on dense ranks). Every launch
is issued up front; every rotation lands in a fresh buffer allocated
before the first launch, so no step writes a buffer that another still
reads. Each card runs its positions on its current stream; where
neighbouring positions sit on different cards, an event orders each step
after the step that wrote its B operand. The JAX package's one-program (monolithic) ring
and its rotation backends are not carried over: the port has this one
ring, whose matrices are held against the single-device ones.

With tracing on (utils/telemetry.py) each step is a ``ring_step`` span
around its launches (the JAX package's span waits on the step; here the
launches are asynchronous, so the span covers their enqueueing).

Not carried over yet: the per-block shard store under ``data/dense_ring``,
resume and per-block recovery, the elastic pod protocol and multi-host
rings, with their spans and instants (ROADMAP.md queue 1, item 12b).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from drep_tpu_torch.ops.containment import ani_cov_from_intersections
from drep_tpu_torch.ops.mash import shared_counts_to_distance
from drep_tpu_torch.ops.minhash import PackedSketches, ids_to_device, pad_packed_rows, require_int32_ids
from drep_tpu_torch.ops.ring import (
    MATMUL_TILE_KINDS,
    check_variant,
    matmul_ring_vocab_pad,
    pick_variant,
    ring_step,
    ring_step_matmul,
)
from drep_tpu_torch.parallel.mesh import Mesh
from drep_tpu_torch.utils import telemetry

def half_ring_steps(n_devices: int) -> int:
    """Ring steps the triangular schedule runs: ceil((D+1)/2) of D."""
    return n_devices // 2 + 1


def ring_tiles_computed(n_devices: int, half: bool) -> int:
    """Unique block tiles the schedule produces (D*(D+1)/2 when half: the
    even-D middle step contributes only its canonical device half)."""
    if half:
        return n_devices * (n_devices + 1) // 2
    return n_devices * n_devices


def _ring_block_computed(a: int, b: int, n_devices: int) -> bool:
    """Whether the half-ring schedule stored block (row a, col b): device a
    computes column block (a - i) mod D at step i, steps 0..n_steps-1, with
    the even-D middle step kept only on devices a < D/2."""
    i = (a - b) % n_devices
    n_steps = half_ring_steps(n_devices)
    if i >= n_steps:
        return False
    if n_devices % 2 == 0 and n_devices > 1 and i == n_devices // 2:
        return a < n_devices // 2
    return True


def mirror_half_ring(mat: np.ndarray, n_devices: int) -> None:
    """Fill the blocks the half-ring schedule skipped with the transpose of
    their computed twins, in place. `mat` is the gathered [n_pad, n_pad]
    matrix (n_pad a multiple of n_devices)."""
    n_local = mat.shape[0] // n_devices
    for a in range(n_devices):
        for b in range(n_devices):
            if a == b or _ring_block_computed(a, b, n_devices):
                continue
            assert _ring_block_computed(b, a, n_devices), "schedule hole"
            ra = slice(a * n_local, (a + 1) * n_local)
            rb = slice(b * n_local, (b + 1) * n_local)
            mat[ra, rb] = mat[rb, ra].T


def ring_schedule(n_devices: int, half: bool) -> list[tuple[int, int]]:
    """The ordered block list the schedule stores: (row block a, col block
    b) pairs, canonical (a-major) order."""
    return [
        (a, b)
        for a in range(n_devices)
        for b in range(n_devices)
        if not half or _ring_block_computed(a, b, n_devices)
    ]


def ring_step_of(a: int, b: int, n_devices: int) -> int:
    """The ring step that produces block (a, b): device `a` computes
    column block ``(a - i) mod D`` at step `i`."""
    return (a - b) % n_devices


def _finish_mash(mat: np.ndarray, packed: PackedSketches, k: int) -> np.ndarray:
    """Shared counts -> float32 distance, the single-device transform."""
    dist, _j = shared_counts_to_distance(mat, packed.counts, packed.counts, packed.sketch_size, k)
    return dist


def _finish_containment(mat: np.ndarray, packed: PackedSketches, k: int) -> np.ndarray:
    """|A ∩ B| as float32 (exact: every count is far below 2^24)."""
    del packed, k
    return mat.astype(np.float32)


# kind -> host transform of the assembled int32 matrix. Both tiles are
# symmetric, which the half-ring host mirror depends on.
_TILE_KINDS = {"mash": _finish_mash, "containment": _finish_containment}


def _blocks(packed: PackedSketches, mesh: Mesh) -> tuple[list[tuple[torch.Tensor, torch.Tensor]], int]:
    """Each position's (ids, counts) block on its device, rows padded to a
    multiple of D (PAD_ID rows, count 0), and the block's row count."""
    ids, counts = pad_packed_rows(packed.ids, packed.counts, mesh.size)
    n_local = ids.shape[0] // mesh.size
    out = []
    for m, dev in enumerate(mesh.devices):
        rows = slice(m * n_local, (m + 1) * n_local)
        out.append((ids_to_device(ids[rows], dev), torch.from_numpy(np.ascontiguousarray(counts[rows])).to(dev)))
    return out, n_local


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _ring_matrix(packed, kind: str, mesh: Mesh, half: bool, variant: str | None) -> np.ndarray:
    """The ring (module docstring): the assembled, mirrored int32 [n_pad,
    n_pad] matrix."""
    D = mesh.size
    width = packed.ids.shape[1]
    # the matmul step's vocabulary extent, once, from the host ids
    v_pad = matmul_ring_vocab_pad(packed.ids) if kind in MATMUL_TILE_KINDS else 0
    variant = pick_variant(kind, v_pad, width) if variant is None else variant
    check_variant(kind, variant, v_pad)
    blocks, n_local = _blocks(packed, mesh)
    n_steps = half_ring_steps(D) if half else D
    keep = set(ring_schedule(D, half))
    # recv[i][m]: position m's B after step i, on position m+1's device
    recv = [
        [
            tuple(torch.empty(shape, dtype=torch.int32, device=mesh.devices[(m + 1) % D])
                  for shape in ((n_local, width), (n_local,)))
            for m in range(D)
        ]
        for _ in range(n_steps - 1)
    ]
    cards = {d for d in mesh.devices if d.type == "cuda"}
    multi = len(cards) > 1
    if multi:
        # a peer writes into buffers the caching allocator handed out on
        # another card's stream: let that card's earlier work finish first
        for c in cards:
            torch.cuda.synchronize(c)
    b = list(blocks)
    done: list = [None] * D  # event after each position's previous step
    tiles = []
    for i in range(n_steps):
        with telemetry.span("ring_step", step=i, steps=n_steps):
            nxt: list = [None] * D
            ev: list = [None] * D
            for m, dev in enumerate(mesh.devices):
                if (m, (m - i) % D) not in keep:
                    continue  # the even-D middle step's second half: its twin is kept
                dst = recv[i][m] if i < n_steps - 1 else None
                with _on(dev):
                    src_dev = mesh.devices[(m - 1) % D]
                    if multi and done[(m - 1) % D] is not None and src_dev != dev:
                        torch.cuda.current_stream(dev).wait_event(done[(m - 1) % D])
                    if variant == "matmul":
                        tile = ring_step_matmul(*blocks[m], *b[m], v_pad, *(dst or (None, None)))
                    else:
                        tile = ring_step(kind, *blocks[m], *b[m], *(dst or (None, None)))
                    tiles.append((m, (m - i) % D, tile))
                    if multi:
                        ev[m] = torch.cuda.Event()
                        ev[m].record(torch.cuda.current_stream(dev))
                if dst is not None:
                    nxt[(m + 1) % D] = dst
            b, done = nxt, ev
    mat = np.zeros((n_local * D, n_local * D), np.int32)
    for a, c, tile in tiles:
        mat[a * n_local : (a + 1) * n_local, c * n_local : (c + 1) * n_local] = tile.cpu().numpy()
    if half:
        mirror_half_ring(mat, D)
    return mat


def ring_allpairs(
    packed: PackedSketches,
    kind: str,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
    variant: str | None = None,
) -> np.ndarray:
    """The `kind` tile over every pair of rows, sharded over the mesh: the
    [N, N] float32 matrix (Mash distance, diagonal not pinned; or |A ∩ B|).
    Half-ring schedule unless `full_grid`. `variant` (merge|matmul) overrides
    the step the ring picks for its rotating steps (``pick_variant``)."""
    if kind not in _TILE_KINDS:
        raise ValueError(f"ring kind {kind!r}: expected one of {tuple(_TILE_KINDS)}")
    require_int32_ids(packed.ids, "ring_allpairs")
    mat = _ring_matrix(packed, kind, mesh, half=not full_grid, variant=variant)
    n = packed.n
    return _TILE_KINDS[kind](mat[:n, :n], packed, k)


def sharded_mash_allpairs(
    packed: PackedSketches,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
) -> np.ndarray:
    """[N, N] float32 Mash distance over the ring, diagonal 0 —
    bit-identical to ops/mash.py::all_vs_all_mash's distance."""
    dist = ring_allpairs(packed, "mash", k, mesh, full_grid)
    np.fill_diagonal(dist, 0.0)
    return dist


def sharded_containment_allpairs(
    packed: PackedSketches,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
    variant: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """([N, N] symmetric max-containment ani, [N, N] directional cov) over
    the ring: symmetric |A ∩ B| tiles, both cov directions from the counts
    on the host. `variant`: as :func:`ring_allpairs`."""
    inter = ring_allpairs(packed, "containment", k, mesh, full_grid, variant)
    return ani_cov_from_intersections(inter, packed.counts, k)
