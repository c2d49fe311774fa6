"""A ring of D positions over the visible devices, and the pod's processes.

Counterpart of drep_tpu/parallel/mesh.py. The dense ring
(parallel/allpairs.py) shards genomes over the D positions of a mesh; each
position is the device its blocks live on. Positions are dealt round-robin
over the cards, so D positions may share a card — the counterpart of the
JAX package's virtual CPU devices. On one card every position sits on it
and a rotation lands in another buffer of the same card; on four cards
with D = 4 each position has its own card and a rotation crosses NVLink.

A pod is N processes of one run (``python -m drep_tpu_torch ...`` started
N times, as ``torchrun`` starts them), joined by
:func:`initialize_distributed` from the standard environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). On a pod the mesh spans the processes: process p holds
the positions ``p * D / N .. (p + 1) * D / N - 1`` on its own cards
(``Mesh.procs`` names each position's process), and
:func:`make_local_mesh` is a mesh over this process's positions only.

The pod's host collectives (the edge allgather, the barriers, the
store-less row exchange) run over gloo on host arrays, as the JAX
package's ``process_allgather`` does: NCCL refuses two ranks of one
communicator on one card ("Duplicate GPU detected"), and no device tensor
crosses processes anywhere in the port, so the pod runs on one card as on
many.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

from drep_tpu_torch.utils.logger import get_logger

# the gloo process group's own timeout; the pod's collectives are bounded
# by parallel/faulttol.py's watchdogs well inside it
_PG_TIMEOUT = datetime.timedelta(hours=7)


@dataclass(frozen=True)
class Mesh:
    """The ring's positions, in ring order: position m sends its B operand
    to position (m + 1) % D. `procs` names the process of each position on
    a pod (None: every position is this process's)."""

    devices: tuple[torch.device, ...]
    procs: tuple[int, ...] | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def proc_of(self, m: int) -> int:
        return process_index() if self.procs is None else self.procs[m]

    def local_positions(self) -> list[int]:
        """The positions this process computes."""
        pid = process_index()
        return [m for m in range(self.size) if self.proc_of(m) == pid]

    @property
    def spans_processes(self) -> bool:
        return self.procs is not None and len(set(self.procs)) > 1


def _dist_ready() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank in the pod (0 outside one)."""
    return torch.distributed.get_rank() if _dist_ready() else 0


def process_count() -> int:
    """The pod's process count (1 outside one)."""
    return torch.distributed.get_world_size() if _dist_ready() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def initialize_distributed() -> bool:
    """Join the pod the environment describes: True when this process is
    one of several. ``WORLD_SIZE`` unset or 1 is a single-process run (a
    no-op); a pod environment that is set but wrong raises, as the JAX
    package's initialize_distributed does for explicit arguments. The
    process group is gloo (module docstring). Idempotent. Each member's
    default card is ``cuda:LOCAL_RANK`` modulo the visible cards."""
    if _dist_ready():
        return process_count() > 1
    raw = os.environ.get("WORLD_SIZE", "").strip()
    if not raw:
        return False
    try:
        world = int(raw)
    except ValueError:
        raise ValueError(f"WORLD_SIZE={raw!r}: expected a positive integer") from None
    if world < 1:
        raise ValueError(f"WORLD_SIZE={world}: expected a positive integer")
    if world == 1:
        return False
    missing = [v for v in ("RANK", "MASTER_ADDR", "MASTER_PORT") if not os.environ.get(v, "").strip()]
    if missing:
        raise ValueError(
            f"WORLD_SIZE={world} names a pod, but {', '.join(missing)} is not set: a pod member needs "
            f"RANK, MASTER_ADDR and MASTER_PORT (as torchrun sets them)"
        )
    try:
        rank = int(os.environ["RANK"])
        port = int(os.environ["MASTER_PORT"])
    except ValueError:
        raise ValueError(
            f"RANK={os.environ['RANK']!r} / MASTER_PORT={os.environ['MASTER_PORT']!r}: expected integers"
        ) from None
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is outside the pod of WORLD_SIZE={world}")
    if not 0 < port < 65536:
        raise ValueError(f"MASTER_PORT={port} is not a TCP port")
    torch.distributed.init_process_group(
        backend="gloo",
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{port}",
        world_size=world,
        rank=rank,
        timeout=_PG_TIMEOUT,
    )
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    get_logger().info(
        "pod: process %d of %d joined over gloo (the pod exchanges host arrays only; NCCL refuses "
        "two ranks on one card, and no device tensor crosses processes)",
        rank, world,
    )
    return True


def allgather_array(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's 1-D `arr` (lengths may differ), in rank order, over
    the gloo group: lengths first, then the arrays padded to the longest."""
    arr = np.ascontiguousarray(arr).reshape(-1)
    pc = process_count()
    n = torch.tensor([arr.shape[0]], dtype=torch.int64)
    ns = [torch.zeros(1, dtype=torch.int64) for _ in range(pc)]
    torch.distributed.all_gather(ns, n)
    lengths = [int(x.item()) for x in ns]
    m = max(lengths)
    if m == 0:
        return [arr[:0].copy() for _ in range(pc)]
    buf = np.zeros(m, arr.dtype)
    buf[: arr.shape[0]] = arr
    mine = torch.from_numpy(buf)
    outs = [torch.empty_like(mine) for _ in range(pc)]
    torch.distributed.all_gather(outs, mine)
    return [o.numpy()[:c].copy() for o, c in zip(outs, lengths)]


def _peer_ring_cards(cards: int) -> int:
    """The most cards k, from cuda:0 up, whose ring cuda:0 -> ... ->
    cuda:k-1 -> cuda:0 has peer access at every hop; 1 when no two do."""
    for k in range(cards, 1, -1):
        if all(torch.cuda.can_device_access_peer(c, (c + 1) % k) for c in range(k)):
            return k
    return 1


def _cuda_cards() -> int:
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("make_mesh: no CUDA device is visible")
    return cards


def _check_peers(devices: tuple[torch.device, ...], procs: tuple[int, ...] | None) -> None:
    count = len(devices)
    for m, src in enumerate(devices):
        nxt = (m + 1) % count
        dst = devices[nxt]
        if procs is not None and procs[m] != procs[nxt]:
            continue  # a hop between processes reads the host pack, not the neighbour's memory
        if src != dst and not torch.cuda.can_device_access_peer(src.index, dst.index):
            raise RuntimeError(
                f"make_mesh: positions {m} and {nxt} sit on {src} and {dst}, and {src} "
                f"cannot access {dst}'s memory; the ring copies each B operand straight into its "
                f"neighbour, never through the host"
            )


def make_mesh(n: int | None, device: str | torch.device) -> Mesh:
    """`n` positions on the type of `device`: all on the CPU, or dealt
    round-robin over ``torch.cuda.device_count()`` cards. ``n=None`` is
    one position per card (one on the CPU), as the JAX package's "all
    devices", over as many cards as form a ring with peer access at every
    hop (one position where no two cards do). Where neighbouring positions
    of an explicit `n` sit on different cards, the first must be able to
    access the second's memory: the ring step writes its B operand straight
    into the neighbour and never copies through the host, so a pair of
    cards without peer access raises.

    On a pod (:func:`process_count` > 1) the `n` positions (None: one per
    process's cards, times the processes) are split evenly over the
    processes in rank order, each process's share dealt over its own cards
    from ``cuda:LOCAL_RANK`` on; `n` must divide by the process count."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"make_mesh: unsupported device {dev}")
    pc = process_count()
    if pc > 1:
        if n is None:
            per = 1 if dev.type == "cpu" else _peer_ring_cards(_cuda_cards())
            n = per * pc
        n = int(n)
        if n < 1:
            raise ValueError(f"make_mesh: a mesh needs at least one position, got {n}")
        if n % pc:
            raise ValueError(
                f"make_mesh: {n} positions do not split evenly over the pod's {pc} processes"
            )
        per = n // pc
        procs = tuple(m // per for m in range(n))
        local = _local_devices(per, dev)
        me = process_index()
        # a position of another process is named by the card it would sit
        # on there; only this process's own positions are ever touched
        devices = tuple(local[m % per] if procs[m] == me else local[0] for m in range(n))
        if dev.type == "cuda":
            _check_peers(devices, procs)
        return Mesh(devices, procs)
    if dev.type == "cpu":
        count = 1 if n is None else int(n)
        devices = (torch.device("cpu"),) * count
    else:
        cards = _cuda_cards()
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
    if count < 1:
        raise ValueError(f"make_mesh: a mesh needs at least one position, got {n}")
    if dev.type == "cuda":
        _check_peers(devices, None)
    return Mesh(devices)


def _local_devices(count: int, dev: torch.device) -> list[torch.device]:
    """`count` positions of this process, dealt round-robin over its cards
    from ``cuda:LOCAL_RANK`` on (all on the CPU for a CPU run)."""
    if dev.type == "cpu":
        return [torch.device("cpu")] * count
    cards = _cuda_cards()
    first = local_rank() % cards
    return [torch.device("cuda", (first + m) % cards) for m in range(count)]


def make_local_mesh(device: str | torch.device, n: int | None = None) -> Mesh:
    """A mesh over THIS process's positions only: no hop of it reaches
    another process. `n` positions (None: this process's share of a pod
    mesh, one a card). The secondary engines run on it on any pod, and
    every engine does once the pod has lost a member
    (cluster/engines.py::_mesh_or_none): the work runs replicated on each
    member, with the same numbers."""
    dev = torch.device(device)
    if n is None:
        n = 1 if dev.type == "cpu" else _peer_ring_cards(_cuda_cards())
    devices = tuple(_local_devices(int(n), dev))
    if dev.type == "cuda":
        _check_peers(devices, None)
    return Mesh(devices)
