"""The `index serve` wire protocol: newline-delimited JSON, one object
per line, request/response — plus a minimal HTTP/1.0 shim on the same
listener (auto-detected per connection from the first bytes).

Counterpart of drep_tpu/serve/protocol.py, byte for byte on the wire:
either package's client talks to either package's daemon.

NDJSON requests (the native protocol — what ServeClient speaks)::

    {"op": "classify", "genome": "/abs/path.fasta", "id": "optional",
     "strict": false, "deadline_ms": 5000}
    {"op": "status"}        # the daemon's health/metrics snapshot
    {"op": "ping"}          # liveness + current generation
    {"op": "cancel", "id": "<request id>"}   # abandon a pending request

``deadline_ms`` (optional) is the request's END-TO-END budget:
the daemon stamps an absolute (monotonic) deadline at admission and a
queued request whose budget expires before dispatch is SHED with a
``reason: "deadline_exceeded"`` refusal instead of wasting a device
slot. Requests without it get the daemon's default budget (30 s, the
JAX package's default) — legacy clients are bounded too. The router
DECREMENTS the budget per hop (elapsed time subtracted) before
forwarding it on legs. ``cancel`` names a prior request's ``id``:
a still-queued request is dropped (answered with ``reason:
"cancelled"``), an in-flight one is flagged so its compute result is
discarded; the ack carries ``{"cancelled": true|false}``.

Wire integrity (the store's in-band-checksum idiom on the wire):
:func:`seal` appends a ``"crc"`` key — CRC-32 of the frame's serialized
bytes — as the LAST key of every NDJSON line. Receivers verify+strip it
when present (:func:`check_crc` / :func:`unseal`), raising
:class:`WireCorruption` on mismatch, so a garbled frame is DETECTED and classified — retried by
the client, never merged into a verdict. Frames without a crc pass
through (mixed fleets interoperate: the JAX package can turn its CRC
off).
Replies echo the request ``id`` verbatim, which is what lets a client
discard duplicated or reordered replies exactly-once.

Fleet ops (the router tier; a plain daemon refuses them).
``classify_part`` is one scatter LEG: the router asks a replica for the
per-partition rect compare of an already-sketched query batch,
generation-fenced (the replica refuses with ``reason: "generation_mismatch"`` — carrying ITS
generation — when it is not at the requested one, so a mixed-generation
gather can never merge silently)::

    {"op": "classify_part", "pid": 2, "generation": 7,
     "names": ["query:a.fasta", ...], "bottoms": [[int64...], ...],
     "prune": {...} | null, "id": "optional"}
    -> {"ok": true, "op": "classify_part", "pid": 2, "generation": 7,
        "ui": [...], "qi": [...], "dist": [...]}

``bottoms`` are the queries' minhash bottom sketches as JSON integer
lists (int64 survives JSON exactly); ``ui``/``qi``/``dist`` are the
retained union-row/query-column/distance edge triple
(``FederatedResident.classify_partition``'s return, listified —
float32 -> JSON -> float32 round-trips bit-exact, so routed merges stay
byte-identical to local ones).

``fleet`` is the router's membership op (replicas joining/leaving a
running fleet without a dropped query; a plain daemon answers
``reason: "not_a_router"``)::

    {"op": "fleet", "action": "join"|"leave", "address": "host:port",
     "partitions": [0, 2] | null}

``strict`` (optional, federated serving only): a verdict
answered with PARTIAL partition coverage (one or more candidate
partitions quarantined — the verdict carries ``partitions_unavailable``)
is converted into a refusal with ``reason: "partial_coverage"`` and a
``retry_after_s`` hint (the soonest quarantined-partition reload probe)
instead of returning the degraded answer. Non-strict clients get the
honest PARTIAL verdict, stamped.

Responses always carry ``ok``. A classify success::

    {"ok": true, "id": ..., "verdict": {...}, "generation": G,
     "batch_size": K, "queue_ms": ..., "batch_ms": ...}

``verdict`` is byte-for-byte the one-shot `index classify` verdict dict
(generation-stamped). A refusal (backpressure or drain) is an error
WITH a retry hint — the client's cue to back off, never a broken pipe::

    {"ok": false, "id": ..., "error": "admission queue full (256)",
     "reason": "backpressure", "retry_after_s": 0.05}

HTTP shim (one request per connection, enough for curl/k8s probes)::

    GET /healthz          -> 200, the status snapshot JSON
    GET /status           -> same
    POST /classify        -> body {"genome": "/abs/path.fasta"}; the
                             classify response JSON (503 + Retry-After
                             on backpressure/drain)

The protocol layer is transport-free (pure bytes <-> dicts) so the
daemon, the client library, and the tests share one encoder/decoder and
none of them can drift.
"""

from __future__ import annotations

import json
import re
import zlib
from typing import Any

MAX_LINE_BYTES = 1 << 20  # a request line is a path + opcode, never MBs

OPS = ("classify", "status", "ping", "classify_part", "fleet", "prewarm",
       "cancel")

# the in-band frame checksum, always spliced as the LAST key so the
# receiver can strip it textually and verify the exact bytes the sender
# summed (no float re-serialization ambiguity)
_CRC_TAIL_RE = re.compile(rb',"crc":(\d+)\}$')

# HTTP methods the shim answers; anything else on a connection whose
# first line is not JSON is a protocol error
_HTTP_METHODS = ("GET ", "POST ", "HEAD ")


class ProtocolError(ValueError):
    """A malformed request line — answered with an error response (the
    connection survives; a client bug must not look like a server
    crash)."""


class WireCorruption(ProtocolError):
    """A frame whose in-band CRC (or JSON shape) does not survive the
    wire — detected, classified, never merged. The client's cue to
    discard the frame and retry."""


def encode(obj: dict) -> bytes:
    """One response/request line (newline-terminated, compact)."""
    return json.dumps(obj, separators=(",", ":"), default=str).encode() + b"\n"


def seal(obj: dict) -> bytes:
    """Encode one frame WITH the in-band crc: CRC-32 of the serialized
    payload bytes, spliced textually as the last key — the wire-level
    twin of durableio's npz/JSON checksum embed."""
    body = json.dumps(obj, separators=(",", ":"), default=str).encode()
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return b'%s,"crc":%d}\n' % (body[:-1], crc)


def check_crc(line: bytes) -> bytes:
    """Verify+strip the in-band crc suffix of one frame, when present.
    Returns the bare frame bytes. Raises :class:`WireCorruption` on a
    mismatch; frames WITHOUT a crc pass through untouched (a JAX-package
    peer with its CRC turned off interoperates)."""
    bare = line.rstrip(b"\r\n")
    m = _CRC_TAIL_RE.search(bare)
    if m is None:
        return bare
    body = bare[: m.start()] + b"}"
    if (zlib.crc32(body) & 0xFFFFFFFF) != int(m.group(1)):
        raise WireCorruption(
            "frame CRC mismatch — the line was corrupted in transit "
            "(garbled reply discarded, never merged)"
        )
    return body


def unseal(line: bytes) -> dict:
    """One received frame -> dict: crc verify+strip, then JSON decode.
    Any failure to decode classifies as :class:`WireCorruption` — from
    the receiver's seat an unparseable frame IS wire damage."""
    body = check_crc(line)
    try:
        obj = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireCorruption(f"frame is not valid JSON: {e}") from e
    if not isinstance(obj, dict):
        raise WireCorruption(
            f"frame must be a JSON object, got {type(obj).__name__}"
        )
    return obj


def parse_request(line: bytes) -> dict:
    """Validate one NDJSON request line into a request dict. Raises
    ProtocolError with an actionable message on anything malformed."""
    if len(line) > MAX_LINE_BYTES:
        raise ProtocolError(f"request line exceeds {MAX_LINE_BYTES} bytes")
    try:
        req = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"request is not valid JSON: {e}") from e
    if not isinstance(req, dict):
        raise ProtocolError(f"request must be a JSON object, got {type(req).__name__}")
    op = req.get("op")
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r} (expected one of {list(OPS)})")
    if op == "classify":
        genome = req.get("genome")
        if not isinstance(genome, str) or not genome:
            raise ProtocolError('classify needs a "genome" FASTA path')
        if "strict" in req and not isinstance(req["strict"], bool):
            raise ProtocolError('"strict" must be a JSON boolean')
        _check_deadline(req)
    elif op == "cancel":
        # cooperative abandonment: the id names a prior request on any
        # connection — a queued one is dropped, an in-flight one has its
        # result discarded; either way the device stops working for a
        # client that has already walked away
        rid = req.get("id")
        if not isinstance(rid, str) or not rid:
            raise ProtocolError('cancel needs the "id" of a prior request')
    elif op == "classify_part":
        if not isinstance(req.get("pid"), int) or isinstance(req.get("pid"), bool):
            raise ProtocolError('classify_part needs an integer "pid"')
        if not isinstance(req.get("generation"), int):
            raise ProtocolError(
                'classify_part needs an integer "generation" (the fence)'
            )
        names, bottoms = req.get("names"), req.get("bottoms")
        if not isinstance(names, list) or not names or not all(
            isinstance(n, str) and n for n in names
        ):
            raise ProtocolError('classify_part needs a non-empty "names" list')
        if not isinstance(bottoms, list) or len(bottoms) != len(names) or not all(
            isinstance(b, list) and b for b in bottoms
        ):
            raise ProtocolError(
                'classify_part needs "bottoms": one non-empty integer list per name'
            )
        if "prune" in req and req["prune"] is not None and not isinstance(
            req["prune"], dict
        ):
            raise ProtocolError('"prune" must be a JSON object or null')
        _check_deadline(req)
    elif op == "fleet":
        if req.get("action") not in ("join", "leave"):
            raise ProtocolError('fleet "action" must be "join" or "leave"')
        if not isinstance(req.get("address"), str) or not req["address"]:
            raise ProtocolError('fleet needs a replica "address"')
        parts = req.get("partitions")
        if parts is not None and (
            not isinstance(parts, list)
            or not all(isinstance(p, int) and not isinstance(p, bool) for p in parts)
        ):
            raise ProtocolError('"partitions" must be an integer list or null')
    elif op == "prewarm":
        # sketch prefetch hint (federated replicas): load these
        # partitions' sketch payloads into the LRU NOW, before the
        # replica takes scatter legs — so its first leg carries no
        # cold-load spike
        parts = req.get("partitions")
        if (
            not isinstance(parts, list) or not parts
            or not all(isinstance(p, int) and not isinstance(p, bool) for p in parts)
        ):
            raise ProtocolError('prewarm needs a non-empty integer "partitions" list')
    return req


def _check_deadline(req: dict) -> None:
    """Shared ``deadline_ms`` validation: a positive JSON number. The
    bool guard matters — ``True`` is an int to Python and a 1 ms budget
    would shed every request it touched."""
    if "deadline_ms" not in req or req["deadline_ms"] is None:
        return
    d = req["deadline_ms"]
    if isinstance(d, bool) or not isinstance(d, (int, float)) or d <= 0:
        raise ProtocolError(
            '"deadline_ms" must be a positive number (milliseconds of '
            "end-to-end budget)"
        )


def error_response(
    msg: str, *, req_id: Any = None, reason: str | None = None,
    retry_after_s: float | None = None,
) -> dict:
    out: dict[str, Any] = {"ok": False, "error": str(msg)}
    if req_id is not None:
        out["id"] = req_id
    if reason is not None:
        out["reason"] = reason
    if retry_after_s is not None:
        out["retry_after_s"] = round(float(retry_after_s), 4)
    return out


def classify_response(
    verdict: dict, *, req_id: Any = None, batch_size: int = 1,
    queue_ms: float = 0.0, batch_ms: float = 0.0,
) -> dict:
    out: dict[str, Any] = {
        "ok": True,
        "verdict": verdict,
        "generation": verdict.get("generation"),
        "batch_size": int(batch_size),
        "queue_ms": round(float(queue_ms), 3),
        "batch_ms": round(float(batch_ms), 3),
    }
    if req_id is not None:
        out["id"] = req_id
    return out


# ---- HTTP shim ------------------------------------------------------------


def looks_like_http(first_line: bytes) -> bool:
    try:
        head = first_line.decode("latin-1")
    except Exception:  # noqa: BLE001 — binary junk is not HTTP
        return False
    return head.startswith(_HTTP_METHODS)


def http_request(first_line: bytes, reader) -> tuple[str, str, bytes]:
    """Parse one HTTP/1.0-style request from `reader` (a file-like
    yielding lines, the first already consumed as `first_line`).
    Returns (method, path, body)."""
    parts = first_line.decode("latin-1").strip().split()
    if len(parts) < 2:
        raise ProtocolError("malformed HTTP request line")
    method, path = parts[0].upper(), parts[1]
    length = 0
    while True:
        hline = reader.readline(MAX_LINE_BYTES)
        if not hline or hline in (b"\r\n", b"\n"):
            break
        name, _, value = hline.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                length = min(int(value.strip()), MAX_LINE_BYTES)
            except ValueError as e:
                raise ProtocolError("bad Content-Length") from e
    body = reader.read(length) if length else b""
    return method, path, body


def http_response(status: int, payload: dict, retry_after_s: float | None = None) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              503: "Service Unavailable"}.get(status, "OK")
    body = json.dumps(payload, separators=(",", ":"), default=str).encode()
    head = (
        f"HTTP/1.0 {status} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
    )
    if retry_after_s is not None:
        head += f"Retry-After: {max(1, round(retry_after_s))}\r\n"
    return head.encode("latin-1") + b"Connection: close\r\n\r\n" + body


def http_to_request(method: str, path: str, body: bytes) -> dict:
    """Map one shim endpoint onto the native request shape. Raises
    ProtocolError (-> 400/404) on anything outside the documented
    surface."""
    route = path.split("?", 1)[0].rstrip("/") or "/"
    if method in ("GET", "HEAD") and route in ("/healthz", "/status"):
        return {"op": "status"}
    if method == "POST" and route == "/classify":
        try:
            doc = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError) as e:
            raise ProtocolError(f"classify body is not valid JSON: {e}") from e
        if not isinstance(doc, dict) or not doc.get("genome"):
            raise ProtocolError('POST /classify body needs {"genome": "<path>"}')
        out = {"op": "classify", "genome": str(doc["genome"]), "id": doc.get("id")}
        if "strict" in doc:
            # same type discipline as the NDJSON path: bool("false") is
            # True, so a coerced string would silently INVERT the
            # client's intent on one protocol but not the other
            if not isinstance(doc["strict"], bool):
                raise ProtocolError('"strict" must be a JSON boolean')
            out["strict"] = doc["strict"]
        if "deadline_ms" in doc:
            out["deadline_ms"] = doc["deadline_ms"]
            _check_deadline(out)
        return out
    raise ProtocolError(f"no route {method} {route} (try GET /healthz or POST /classify)")
