"""The federation meta-manifest: one commit point above N partition stores.

Counterpart of drep_tpu/index/meta.py, in its format byte for byte. A
federated index (index/federation.py) splits the genome space into range
partitions keyed by a sketch-derived code; each partition is a full,
self-contained index store. This module owns the layer above them:

``federation.json``
    The atomically published federation root (checked JSON, in-band
    "crc"). It records, for every partition, the ``(range, generation,
    manifest checksum)`` the federation generation was published
    against, plus the federation-level shard families (cross-partition
    edge shards, the union state, the routing summary). Whatever a
    partition publishes is invisible to federated readers until this
    file moves: a reader loads each partition truncated to the genome
    count the meta records.

Routing
    A genome's range code is the splitmix64 finalizer of its smallest
    bottom-sketch hash: similar genomes share the min-hash with
    probability about their Jaccard, so relatives co-locate, and the
    code is uniform over the uint64 space, so equal range splits stay
    balanced. The bounds are the equal split of ``[0, 2^64)`` into P
    ranges, pinned in the meta at creation; routing bisects them.
"""

from __future__ import annotations

import bisect
import os

import numpy as np

from drep_tpu_torch.errors import UserInputError

META_NAME = "federation.json"
FED_FORMAT = 1
MAX_PARTITIONS = 999  # part_%03d naming

_U64 = 1 << 64


def meta_path(location: str) -> str:
    return os.path.join(os.path.abspath(location), META_NAME)


def is_federated(location: str) -> bool:
    return os.path.exists(meta_path(location))


def partition_dir_name(pid: int) -> str:
    return f"part_{pid:03d}"


def partition_bounds(n_partitions: int) -> list[tuple[int, int]]:
    """The equal split of the uint64 code space into `n_partitions`
    ranges (disjoint, covering, monotone), pinned in the meta at
    creation."""
    if not 2 <= n_partitions <= MAX_PARTITIONS:
        raise UserInputError(
            f"--partitions must be in [2, {MAX_PARTITIONS}] (got "
            f"{n_partitions}); a 1-partition federation is just a plain "
            f"index — use `index build` without --partitions"
        )
    edges = [i * _U64 // n_partitions for i in range(n_partitions + 1)]
    return [(edges[i], edges[i + 1]) for i in range(n_partitions)]


def route_code(bottom: np.ndarray) -> int:
    """The genome's range code: the splitmix64 finalizer of its smallest
    bottom-sketch hash (0 for an empty sketch), in Python ints."""
    if len(bottom) == 0:
        return 0
    x = int(bottom[0]) & (_U64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (_U64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (_U64 - 1)
    return x ^ (x >> 31)


def route_partition(code: int, bounds: list) -> int:
    """The partition whose pinned range holds `code` (a bisect of the
    lower bounds): the rule every admission shares."""
    los = [int(lo) for lo, _hi in bounds]
    pid = bisect.bisect_right(los, int(code)) - 1
    return max(0, min(pid, len(bounds) - 1))


def read_meta(location: str) -> dict:
    """The federation root document. Corruption is fatal, as for a store
    manifest: only the meta records which partition generations belong
    together."""
    from drep_tpu_torch.utils.durableio import CorruptPayloadError, read_json_checked

    path = meta_path(location)
    if not os.path.exists(path):
        raise UserInputError(
            f"{location} is not a federated genome index (no {META_NAME}); "
            f"create one with `drep-tpu index build --partitions N`"
        )
    try:
        m = read_json_checked(path, what="federation meta-manifest")
    except CorruptPayloadError as e:
        raise UserInputError(
            f"federation meta-manifest {path} is corrupt ({e}); restore it "
            f"from a backup — the partition stores underneath are intact, "
            f"but only the meta records which generations belong together"
        ) from e
    if not isinstance(m, dict) or m.get("format") != FED_FORMAT:
        raise UserInputError(
            f"federation meta-manifest {path} has unsupported format "
            f"{m.get('format') if isinstance(m, dict) else type(m).__name__!r} "
            f"(this build reads format {FED_FORMAT})"
        )
    return m


def publish_meta(location: str, meta: dict) -> None:
    """The federation commit point: every partition publish before it is
    invisible to federated readers; after it, the recorded (range,
    generation, checksum) triples are the federation generation. The
    ``meta_publish`` fault site fires just before the write (a raise
    there keeps the prior generation), and a traced run records a
    ``federation_generation`` instant after it."""
    from drep_tpu_torch.utils import faults, telemetry
    from drep_tpu_torch.utils.durableio import atomic_write_json

    faults.fire("meta_publish")
    atomic_write_json(meta_path(location), meta)
    telemetry.event(
        "federation_generation",
        generation=int(meta.get("generation", -1)),
        n_genomes=int(meta.get("n_genomes", 0)),
        n_partitions=int(meta.get("n_partitions", 0)),
    )


def manifest_crc(part_location: str) -> int | None:
    """The in-band "crc" of a partition's current manifest: what the meta
    records at publish, so a load can prove the manifest it reads is the
    one the federation generation was committed against."""
    from drep_tpu_torch.utils import durableio

    try:
        body = durableio.read_json_unverified(os.path.join(part_location, "manifest.json"), what="manifest")
    except (OSError, ValueError):
        return None
    if isinstance(body, dict):
        crc = body.get(durableio.JSON_CRC_KEY)
        return int(crc) if crc is not None else None
    return None


def current_generation(location: str) -> int:
    """The published generation of a plain or federated index: a checked
    read of its manifest or meta, nothing written."""
    if is_federated(location):
        return int(read_meta(location).get("generation", -1))
    from drep_tpu_torch.index.store import IndexStore

    return int(IndexStore(location).read_manifest().get("generation", -1))
