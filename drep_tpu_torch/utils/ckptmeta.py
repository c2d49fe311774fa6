"""The checkpoint-directory meta protocol of the shard stores, one process.

Counterpart of drep_tpu/utils/ckptmeta.py. A ``meta.json`` pins the exact
inputs the shards of a store were computed from: on open, a matching meta
means the shards resume; a mismatch (or a corrupt meta) clears the
directory and writes the new meta. The format is the JAX package's, so a
store written by either package opens in the other. The JAX package's
multi-process leader and barrier (its pod branch) belong to ROADMAP item
12b and are not ported: this module serves one process.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Any, Iterable

import numpy as np

from drep_tpu_torch.utils.durableio import atomic_write_json, read_json_checked

META_NAME = "meta.json"

# the only stored-meta keys a resume may ignore: provenance the JAX
# package's elastic pod stamps into a finished store (how its shards were
# produced, never what from)
META_PROVENANCE_KEYS = ("pod_epochs", "dead_processes", "planned_departures", "pod_joins")


def content_fingerprint(names: Iterable[str], *arrays: np.ndarray) -> str:
    """SHA-1 over an ordered name list plus array contents: the packed
    int32 ids are a run's own vocabulary remap, so a store is pinned to
    its inputs, not to their shapes."""
    h = hashlib.sha1()
    for name in names:
        h.update(str(name).encode())
        h.update(b"\0")
    for arr in arrays:
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def checkpoint_meta_matches(ckpt_dir: str, meta: dict[str, Any]) -> bool:
    """Does `ckpt_dir` hold a meta equal to `meta`, up to the provenance
    keys? Every key of `meta` must be stored with an equal value, and the
    stored meta may carry nothing else. A missing or corrupt meta is not a
    match; an I/O error is raised (an intact store must not be cleared
    for it). Reads only."""
    loc = os.path.join(ckpt_dir, META_NAME)
    if not os.path.exists(loc):
        return False
    try:
        stored = read_json_checked(loc, what="checkpoint meta")
    except FileNotFoundError:
        return False
    except OSError:
        raise
    except Exception:  # noqa: BLE001 — a corrupt meta is not resumable
        return False
    if not isinstance(stored, dict):
        return False
    if set(stored) - set(meta) - set(META_PROVENANCE_KEYS):
        return False
    return all(stored.get(k) == v for k, v in meta.items())


def open_checkpoint_dir(ckpt_dir: str, meta: dict[str, Any], clear_suffixes: tuple[str, ...]) -> bool:
    """Prepare `ckpt_dir` for shards computed under `meta`. True when a
    matching meta is already there (its shards resume); else the files
    ending in any of `clear_suffixes` and the meta are removed, the new
    meta is written, and False is returned."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if checkpoint_meta_matches(ckpt_dir, meta):
        return True
    for f in os.listdir(ckpt_dir):
        if f == META_NAME or any(f.endswith(s) for s in clear_suffixes):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(ckpt_dir, f))
    atomic_write_json(os.path.join(ckpt_dir, META_NAME), meta)
    return False
