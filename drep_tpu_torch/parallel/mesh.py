"""A ring of D positions over the visible devices.

Counterpart of drep_tpu/parallel/mesh.py::make_mesh. The dense ring
(parallel/allpairs.py) shards genomes over the D positions of a mesh; each
position is the device its blocks live on. Positions are dealt round-robin
over the cards, so D positions may share a card — the counterpart of the
JAX package's virtual CPU devices. On one card every position sits on it
and a rotation lands in another buffer of the same card; on four cards
with D = 4 each position has its own card and a rotation crosses NVLink.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from drep_tpu_torch.utils.logger import get_logger


@dataclass(frozen=True)
class Mesh:
    """The ring's positions, in ring order: position m sends its B operand
    to position (m + 1) % D."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _peer_ring_cards(cards: int) -> int:
    """The most cards k, from cuda:0 up, whose ring cuda:0 -> ... ->
    cuda:k-1 -> cuda:0 has peer access at every hop; 1 when no two do."""
    for k in range(cards, 1, -1):
        if all(torch.cuda.can_device_access_peer(c, (c + 1) % k) for c in range(k)):
            return k
    return 1


def make_mesh(n: int | None, device: str | torch.device) -> Mesh:
    """`n` positions on the type of `device`: all on the CPU, or dealt
    round-robin over ``torch.cuda.device_count()`` cards. ``n=None`` is
    one position per card (one on the CPU), as the JAX package's "all
    devices", over as many cards as form a ring with peer access at every
    hop (one position where no two cards do). Where neighbouring positions
    of an explicit `n` sit on different cards, the first must be able to
    access the second's memory: the ring step writes its B operand straight
    into the neighbour and never copies through the host, so a pair of
    cards without peer access raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        count = 1 if n is None else int(n)
        devices = (torch.device("cpu"),) * count
    elif dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        if n is None:
            count = _peer_ring_cards(cards)
            if count < cards:
                get_logger().warning(
                    "make_mesh: only %d of %d cards form a ring with peer access; the mesh has %d "
                    "position(s) (--mesh_shape D deals D positions over the cards and needs peer access)",
                    count, cards, count,
                )
        else:
            count = int(n)
        devices = tuple(torch.device("cuda", m % cards) for m in range(count))
    else:
        raise ValueError(f"make_mesh: unsupported device {dev}")
    if count < 1:
        raise ValueError(f"make_mesh: a mesh needs at least one position, got {n}")
    for m, src in enumerate(devices):
        dst = devices[(m + 1) % count]
        if src != dst and not torch.cuda.can_device_access_peer(src.index, dst.index):
            raise RuntimeError(
                f"make_mesh: positions {m} and {(m + 1) % count} sit on {src} and {dst}, and {src} "
                f"cannot access {dst}'s memory; the ring copies each B operand straight into its "
                f"neighbour, never through the host"
            )
    return Mesh(devices)
