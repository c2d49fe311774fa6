"""Recognising a federated index root, so the single-store path refuses
it, and reading a plain root's published generation.

Counterpart of the part of drep_tpu/index/meta.py that a plain (one-store)
index needs. A federated index keeps a ``federation.json`` meta-manifest
above N partition stores; the federation (``index build --partitions``,
its updates, and loading it as the union) is ROADMAP.md queue 1 item 10b,
not ported yet. Every entry of this package checks for the meta first and
raises NotImplementedError before it sketches or writes anything.
"""

from __future__ import annotations

import os

META_NAME = "federation.json"

# the ROADMAP item that owns the federated index and the maintenance verbs
FEDERATION_ITEM = "ROADMAP.md queue 1, item 10b"


def meta_path(location: str) -> str:
    return os.path.join(os.path.abspath(location), META_NAME)


def is_federated(location: str) -> bool:
    return os.path.exists(meta_path(location))


def refuse_federated(location: str, what: str) -> None:
    """Raise NotImplementedError when `location` is a federated root."""
    if is_federated(location):
        raise NotImplementedError(
            f"{what} on a federated index ({meta_path(location)}): the federated "
            f"index is not ported yet ({FEDERATION_ITEM})"
        )


def current_generation(location: str) -> int:
    """The published generation of a plain index: a checked read of its
    manifest, nothing written (the serve daemon's hot-swap poller). A
    federated root raises NotImplementedError (item 10b)."""
    from drep_tpu_torch.index.store import IndexStore

    refuse_federated(location, "reading the generation")
    return int(IndexStore(location).read_manifest().get("generation", -1))
