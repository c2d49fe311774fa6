"""Durable work-directory I/O: atomic publishes, in-band checksums,
transient-error retries.

The port keeps the JAX package's on-disk formats byte for byte, so a
workdir written by one package resumes in the other:

- every npz payload carries a ``__crc__`` member (crc32 over member names,
  dtypes, shapes and bytes, sorted by name);
- every JSON argument snapshot carries a ``"crc"`` key (crc32 of the
  canonical dump without it);
- every publish is uuid-tmp + rename, whole-file-or-nothing, and with
  :func:`configure` ``fsync=True`` (CLI ``--fsync``) the tmp file is
  fsynced before the rename and its directory after it.

Transient errors (``EIO``, ``ESTALE``, ``ETIMEDOUT``) on a read or a write
retry with bounded exponential backoff (:func:`retry_io`; the budget is
``--io_retries``, default 3, counted as ``io_retries``; past it the op
books ``io_unrecoverable`` and raises). ``ENOSPC`` never retries: it
becomes a :class:`StoreFullError` naming the store and the bytes the
write needed. A shard read that comes back corrupt is treated like a
missing shard: counted (``corrupt_shards_healed``), removed, recomputed.

The ``io`` fault site (utils/faults.py) fires inside the retried
regions, and ``shard_write:torn`` / ``io:corrupt`` act in
:func:`atomic_savez`, so the layer is testable on the CPU. The defaults
are the knobs ``DREP_TORCH_IO_RETRIES``, ``_IO_BACKOFF_S``, ``_FSYNC``
and ``_IO_CRC`` (utils/envknobs.py); the CLI's --io_retries and --fsync
win over them. With tracing on, a spent retry budget leaves an
``io_unrecoverable`` instant and a healed shard an ``io_heal`` one.
"""

from __future__ import annotations

import contextlib
import errno
import io
import json
import os
import time
import uuid
import zlib
from typing import Any, Callable

import numpy as np

from drep_tpu_torch.utils import envknobs, telemetry

CRC_KEY = "__crc__"
JSON_CRC_KEY = "crc"

IO_RETRIES_ENV = "DREP_TORCH_IO_RETRIES"
IO_BACKOFF_ENV = "DREP_TORCH_IO_BACKOFF_S"
FSYNC_ENV = "DREP_TORCH_FSYNC"
CRC_ENV = "DREP_TORCH_IO_CRC"
DEFAULT_IO_RETRIES = envknobs.knob(IO_RETRIES_ENV).default

# errnos retried as transient (NFS, FUSE object stores): a flaky backend,
# a handle a server-side rename invalidated, a slow metadata server.
# Everything else (ENOENT, EACCES, EROFS) is an answer and surfaces.
TRANSIENT_ERRNOS = frozenset({errno.EIO, errno.ESTALE, errno.ETIMEDOUT})

# the run's overrides, installed by the CLI (--io_retries, --fsync);
# None = the knob
_CONFIG: dict[str, Any] = {"retries": None, "fsync": None}


def configure(retries: int | None = None, fsync: bool | None = None) -> None:
    """Install the run's I/O knobs. Replaces the whole config: an omitted
    argument resets that knob to its default."""
    _CONFIG["retries"] = retries
    _CONFIG["fsync"] = fsync


def io_retries() -> int:
    if _CONFIG["retries"] is not None:
        return max(0, int(_CONFIG["retries"]))
    return max(0, envknobs.env_int(IO_RETRIES_ENV))


def io_backoff_s() -> float:
    return envknobs.env_float(IO_BACKOFF_ENV)


def fsync_enabled() -> bool:
    if _CONFIG["fsync"] is not None:
        return bool(_CONFIG["fsync"])
    return envknobs.env_bool(FSYNC_ENV)


def crc_enabled() -> bool:
    return envknobs.env_bool(CRC_ENV)


class StoreFullError(OSError):
    """ENOSPC, as an error naming the store and the bytes the write
    needed: what to grow, not a bare errno."""


class CorruptPayloadError(Exception):
    """A payload read back corrupt: unparseable bytes or an in-band
    checksum mismatch. Deliberately not an OSError, so the transient
    retry loop never spins on it."""


def _count(kind: str, n: int = 1) -> None:
    from drep_tpu_torch.utils.profiling import counters

    counters.add_fault(kind, n)


def retry_io(fn: Callable[[], Any], what: str, path: str, bytes_needed: int | None = None):
    """`fn()`, with transient OSErrors (TRANSIENT_ERRNOS) retried under
    bounded exponential backoff. ENOSPC raises StoreFullError at once;
    past the budget the op books ``io_unrecoverable`` and the last error
    surfaces."""
    from drep_tpu_torch.utils.logger import get_logger

    retries = io_retries()
    last: OSError | None = None
    for attempt in range(retries + 1):
        if attempt:
            time.sleep(io_backoff_s() * (2 ** (attempt - 1)))
            _count("io_retries")
        try:
            return fn()
        except OSError as e:
            if e.errno == errno.ENOSPC:
                need = f"~{bytes_needed} bytes" if bytes_needed is not None else "an unknown payload size"
                raise StoreFullError(
                    errno.ENOSPC,
                    f"{what}: filesystem full (ENOSPC) publishing {path} — the store at "
                    f"{os.path.dirname(os.path.abspath(path))} needs {need} free. Grow the quota / "
                    f"free space and rerun; finished shards resume.",
                ) from e
            if e.errno not in TRANSIENT_ERRNOS:
                raise
            last = e
            get_logger().warning("%s: transient I/O error (%s) on %s — attempt %d/%d", what,
                                 errno.errorcode.get(e.errno, e.errno), path, attempt + 1, retries + 1)
    _count("io_unrecoverable")
    # which payload ran out of budget (the generic fault instant rides add_fault)
    telemetry.event("io_unrecoverable", what=what, path=path)
    raise last  # type: ignore[misc]  # the loop ran at least once on a transient error


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(
    path: str, write_fn: Callable[[str], None], keep_suffix: bool = False, bytes_needed: int | None = None
) -> None:
    """`write_fn(tmp)` produces the content; the tmp is renamed onto `path`.
    `keep_suffix` keeps the target's suffix on the tmp name, for writers
    that derive the output name from it (``np.savez`` appends ``.npz``);
    without it the tmp name does not end in the target's suffix, so no
    shard glob takes a crash artifact for a shard. A transient error
    retries the whole attempt (every caller writes deterministic content);
    with fsync on, the tmp file is fsynced before the rename and the
    directory after it."""
    from drep_tpu_torch.utils import faults

    def attempt() -> None:
        base, suffix = os.path.splitext(path)
        tmp = f"{base}.tmp-{uuid.uuid4().hex}{suffix}" if keep_suffix else f"{path}.tmp-{uuid.uuid4().hex}"
        try:
            faults.fire_io("write", path=path)
            write_fn(tmp)
            if fsync_enabled():
                _fsync_path(tmp)
            os.replace(tmp, path)
            if fsync_enabled():
                with contextlib.suppress(OSError):  # a directory may refuse fsync
                    _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
        finally:
            if os.path.exists(tmp):
                with contextlib.suppress(OSError):
                    os.remove(tmp)

    retry_io(attempt, what="atomic write", path=path, bytes_needed=bytes_needed)


def atomic_write_bytes(path: str, data) -> None:
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(data)

    atomic_write(path, write, bytes_needed=len(data))


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
    if not crc_enabled():
        return arrays
    out = dict(arrays)
    out[CRC_KEY] = np.array([checksum_arrays(arrays)], dtype=np.uint32)
    return out


def load_npz_checked(path: str, what: str = "payload") -> dict[str, np.ndarray]:
    """Read an npz payload, transient errors retried, and verify its
    in-band checksum (payloads with no ``__crc__`` are accepted as written
    before checksums existed). Zero-byte, truncated, unparseable or
    mismatched bytes raise CorruptPayloadError; an OSError past the retry
    budget surfaces as itself."""
    from drep_tpu_torch.utils import faults

    def read() -> dict[str, np.ndarray]:
        faults.fire_io("read", path=path)
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    try:
        loaded = retry_io(read, what=f"read {what}", path=path)
    except OSError:
        raise
    except Exception as e:  # noqa: BLE001 — BadZipFile / EOF: classify as corrupt
        raise CorruptPayloadError(f"{what} {path}: unreadable ({e!r})") from e
    if CRC_KEY not in loaded:
        return loaded
    try:
        stored = int(np.asarray(loaded.pop(CRC_KEY)).ravel()[0])
    except (IndexError, TypeError, ValueError) as e:
        raise CorruptPayloadError(f"{what} {path}: unreadable in-band checksum ({e!r})") from e
    if crc_enabled() and checksum_arrays(loaded) != stored:
        raise CorruptPayloadError(f"{what} {path}: in-band checksum mismatch")
    return loaded


def _flip_bit(path: str) -> None:
    """The ``io:corrupt`` fault: flip one bit of the published file, inside
    the largest zip member's data where the file is a zip (a bit in a
    structure field zipfile ignores would inject nothing), else mid-file."""
    size = os.path.getsize(path)
    if size == 0:
        return
    off = None
    try:
        import zipfile

        with zipfile.ZipFile(path) as zf:
            info = max(zf.infolist(), key=lambda i: i.compress_size)
        if info.compress_size > 0:
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                hdr = f.read(30)  # local file header: name and extra lengths at 26 and 28
            name_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            off = info.header_offset + 30 + name_len + extra_len + info.compress_size // 2
    except Exception:  # noqa: BLE001 — not a zip: rot the middle byte
        off = None
    if off is None or off >= size:
        off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x01]))


def atomic_savez(path: str, compressed: bool = True, fault_site: str = "shard_write", **arrays) -> None:
    """Serialise `arrays` plus their in-band ``__crc__`` to an npz in
    memory and publish it whole through :func:`atomic_write`. The tmp name
    does not end in ``.npz``, so a crash leaves nothing a shard glob or a
    store clear would take for a shard. `compressed=False` for stores of
    many small files. The `fault_site` torn rule publishes a truncated
    file in place of the atomic write, and ``io:corrupt`` rots the
    published file (utils/faults.py)."""
    from drep_tpu_torch.utils import faults

    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **with_checksum(arrays))
    if faults.torn_write(fault_site, path=path):
        data = bytes(buf.getbuffer())
        with open(path, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
        return
    atomic_write_bytes(path, buf.getbuffer())
    if faults.corrupt_write(path=path):
        _flip_bit(path)


def load_npz_or_none(path: str, what: str, convert: Callable[[dict], Any], warn: str) -> Any:
    """``convert(payload)`` of a checked npz read, or None for the caller
    to recompute: a missing file returns None; an I/O error past the
    retries warns and leaves the file in place (it may be intact);
    anything else (torn, unparseable, checksum mismatch, a member missing
    inside `convert`) warns with `warn` (%s = path) and goes through
    :func:`quarantine_corrupt`."""
    from drep_tpu_torch.utils.logger import get_logger

    try:
        return convert(load_npz_checked(path, what=what))
    except FileNotFoundError:
        return None
    except OSError:
        get_logger().warning("%s %s: unreadable after transient I/O retries — recomputing, shard left in place",
                             what, path)
        return None
    except Exception:  # noqa: BLE001 — any corrupt shard is recomputed
        get_logger().warning(warn, path)
        quarantine_corrupt(path)
        return None


def quarantine_corrupt(path: str) -> None:
    """Count one corrupt-shard heal (``corrupt_shards_healed``; the caller
    recomputes) and remove the payload where the filesystem lets it: the
    recompute's atomic rewrite replaces it either way."""
    _count("corrupt_shards_healed")
    telemetry.event("io_heal", path=path)
    with contextlib.suppress(OSError):
        os.remove(path)


def dump_json_checked(obj: dict[str, Any], default=str) -> bytes:
    """Canonical JSON bytes with an in-band ``"crc"`` key."""
    if JSON_CRC_KEY in obj:
        raise ValueError(f"JSON payload already carries the reserved key {JSON_CRC_KEY!r}")
    body = dict(obj)
    if crc_enabled():
        canon = json.dumps(body, sort_keys=True, default=default).encode()
        body[JSON_CRC_KEY] = zlib.crc32(json.dumps(json.loads(canon), sort_keys=True).encode()) & 0xFFFFFFFF
    return json.dumps(body, sort_keys=True, default=default).encode()


def atomic_write_json(path: str, obj: dict[str, Any], default=str) -> None:
    atomic_write_bytes(path, dump_json_checked(obj, default=default))


def _read_bytes(path: str, what: str) -> bytes:
    from drep_tpu_torch.utils import faults

    def read() -> bytes:
        faults.fire_io("read", path=path)
        with open(path, "rb") as f:
            return f.read()

    return retry_io(read, what=f"read {what}", path=path)


def read_json_unverified(path: str, what: str = "note"):
    """Read + parse a JSON document, transient errors retried, without
    verifying its checksum: a present ``"crc"`` key stays in the returned
    document (a federation meta records each partition manifest's)."""
    raw = _read_bytes(path, what)
    try:
        return json.loads(raw.decode())
    except ValueError as e:  # includes UnicodeDecodeError
        raise CorruptPayloadError(f"{what} {path}: unparseable JSON ({e})") from e


def read_json_checked(path: str, what: str = "note"):
    """Read + verify a checked JSON document; the ``"crc"`` key is
    stripped from the returned dict."""
    body = read_json_unverified(path, what)
    if not isinstance(body, dict) or JSON_CRC_KEY not in body:
        return body
    stored = body.pop(JSON_CRC_KEY)
    if not crc_enabled():
        return body
    try:
        want = int(stored)
    except (TypeError, ValueError) as e:
        raise CorruptPayloadError(f"{what} {path}: unreadable in-band checksum ({stored!r})") from e
    canon = json.dumps(body, sort_keys=True, default=str).encode()
    if (zlib.crc32(canon) & 0xFFFFFFFF) != want:
        raise CorruptPayloadError(f"{what} {path}: in-band checksum mismatch")
    return body
