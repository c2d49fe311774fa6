"""Atomic publishes and in-band checksums for the work directory.

The port keeps the JAX package's on-disk formats byte for byte, so a
workdir written by one package resumes in the other:

- every npz payload carries a ``__crc__`` member (crc32 over member names,
  dtypes, shapes and bytes, sorted by name);
- every JSON argument snapshot carries a ``"crc"`` key (crc32 of the
  canonical dump without it);
- every publish is uuid-tmp + rename, whole-file-or-nothing.

The streaming primary's row shards publish through :func:`atomic_savez`
and read back through :func:`load_npz_or_none`, as the JAX package's do,
so a shard store written by either package resumes in the other. The
shared-filesystem retry, fsync and fault-injection layers of the JAX
package's store belong to paths this port does not run yet (index, pods)
and are not carried over.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import uuid
import zlib
from typing import Any, Callable

import numpy as np

CRC_KEY = "__crc__"
JSON_CRC_KEY = "crc"


class CorruptPayloadError(Exception):
    """A payload read back corrupt: unparseable bytes or an in-band
    checksum mismatch."""


def atomic_write(path: str, write_fn: Callable[[str], None], keep_suffix: bool = False) -> None:
    """`write_fn(tmp)` produces the content; the tmp is renamed onto `path`.
    `keep_suffix` keeps the target's suffix on the tmp name, for writers
    that derive the output name from it (``np.savez`` appends ``.npz``)."""
    base, suffix = os.path.splitext(path)
    tmp = f"{base}.tmp-{uuid.uuid4().hex}{suffix}" if keep_suffix else f"{path}.tmp-{uuid.uuid4().hex}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            with contextlib.suppress(OSError):
                os.remove(tmp)


def atomic_write_bytes(path: str, data) -> None:
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(data)

    atomic_write(path, write)


def checksum_arrays(arrays: dict[str, np.ndarray]) -> int:
    """crc32 over member names, dtypes, shapes and raw bytes, sorted by
    name, CRC_KEY excluded."""
    crc = 0
    for name in sorted(arrays):
        if name == CRC_KEY:
            continue
        a = np.ascontiguousarray(arrays[name])
        crc = zlib.crc32(str(name).encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(str(a.shape).encode(), crc)
        try:
            buf = memoryview(a).cast("B")
        except (TypeError, ValueError):
            buf = a.tobytes()
        crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def with_checksum(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The arrays plus their in-band ``__crc__`` member."""
    if CRC_KEY in arrays:
        raise ValueError(f"npz payload already carries the reserved member {CRC_KEY!r}")
    out = dict(arrays)
    out[CRC_KEY] = np.array([checksum_arrays(arrays)], dtype=np.uint32)
    return out


def load_npz_checked(path: str, what: str = "payload") -> dict[str, np.ndarray]:
    """Read an npz payload and verify its in-band checksum (payloads with
    no ``__crc__`` are accepted as written before checksums existed)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            loaded = {k: z[k] for k in z.files}
    except OSError:
        raise
    except Exception as e:  # noqa: BLE001 — BadZipFile / EOF: classify as corrupt
        raise CorruptPayloadError(f"{what} {path}: unreadable ({e!r})") from e
    if CRC_KEY not in loaded:
        return loaded
    stored = int(np.asarray(loaded.pop(CRC_KEY)).ravel()[0])
    if checksum_arrays(loaded) != stored:
        raise CorruptPayloadError(f"{what} {path}: in-band checksum mismatch")
    return loaded


def atomic_savez(path: str, compressed: bool = True, **arrays) -> None:
    """Serialise `arrays` plus their in-band ``__crc__`` to an npz in
    memory and publish it whole through :func:`atomic_write`. The tmp name
    does not end in ``.npz``, so a crash leaves nothing a shard glob or a
    store clear would take for a shard."""
    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **with_checksum(arrays))
    atomic_write_bytes(path, buf.getbuffer())


def load_npz_or_none(path: str, what: str, convert: Callable[[dict], Any], warn: str) -> Any:
    """``convert(payload)`` of a checked npz read, or None for the caller
    to recompute: a missing file returns None; an I/O error warns and
    leaves the file in place (it may be intact); anything else (torn,
    unparseable, checksum mismatch, a member missing inside `convert`)
    warns with `warn` (%s = path) and removes the payload."""
    from drep_tpu_torch.utils.logger import get_logger

    try:
        return convert(load_npz_checked(path, what=what))
    except FileNotFoundError:
        return None
    except OSError:
        get_logger().warning("%s %s: unreadable — recomputing, shard left in place", what, path)
        return None
    except Exception:  # noqa: BLE001 — any corrupt shard is recomputed
        get_logger().warning(warn, path)
        with contextlib.suppress(OSError):
            os.remove(path)
        return None


def dump_json_checked(obj: dict[str, Any], default=str) -> bytes:
    """Canonical JSON bytes with an in-band ``"crc"`` key."""
    if JSON_CRC_KEY in obj:
        raise ValueError(f"JSON payload already carries the reserved key {JSON_CRC_KEY!r}")
    body = dict(obj)
    canon = json.dumps(body, sort_keys=True, default=default).encode()
    body[JSON_CRC_KEY] = zlib.crc32(json.dumps(json.loads(canon), sort_keys=True).encode()) & 0xFFFFFFFF
    return json.dumps(body, sort_keys=True, default=default).encode()


def atomic_write_json(path: str, obj: dict[str, Any], default=str) -> None:
    atomic_write_bytes(path, dump_json_checked(obj, default=default))


def read_json_unverified(path: str, what: str = "note"):
    """Read + parse a JSON document without verifying its checksum: a
    present ``"crc"`` key stays in the returned document (a federation
    meta records each partition manifest's)."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return json.loads(raw.decode())
    except ValueError as e:  # includes UnicodeDecodeError
        raise CorruptPayloadError(f"{what} {path}: unparseable JSON ({e})") from e


def read_json_checked(path: str, what: str = "note"):
    """Read + verify a checked JSON document; the ``"crc"`` key is
    stripped from the returned dict."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        body = json.loads(raw.decode())
    except ValueError as e:
        raise CorruptPayloadError(f"{what} {path}: unparseable JSON ({e})") from e
    if not isinstance(body, dict) or JSON_CRC_KEY not in body:
        return body
    stored = body.pop(JSON_CRC_KEY)
    try:
        want = int(stored)
    except (TypeError, ValueError) as e:
        raise CorruptPayloadError(f"{what} {path}: unreadable in-band checksum ({stored!r})") from e
    canon = json.dumps(body, sort_keys=True, default=str).encode()
    if (zlib.crc32(canon) & 0xFFFFFFFF) != want:
        raise CorruptPayloadError(f"{what} {path}: in-band checksum mismatch")
    return body
