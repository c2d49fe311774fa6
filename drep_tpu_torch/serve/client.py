"""Client library for the `index serve` daemon.

Counterpart of drep_tpu/serve/client.py: the same wire, so it talks to
either package's daemon.

Speaks the NDJSON protocol (serve/protocol.py) over a unix-domain or
TCP socket. One connection per client; requests can be PIPELINED
(``classify_many`` sends the whole batch before reading replies — how a
loadgen actually fills the daemon's batch window). Backpressure is a
first-class outcome, not an exception storm: a refusal carries
``retry_after_s`` and ``classify`` honors it up to ``retries`` times.

Used by chip_smoke.py and the serve tests; kept dependency-free (no
torch, no pandas) so a thin front-end can import it alone.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
import uuid
from typing import Any

from drep_tpu_torch.serve import protocol


class ServeError(RuntimeError):
    """An error response from the daemon (or a dead connection).
    ``reason`` mirrors the protocol field; ``retry_after_s`` is the
    daemon's backoff hint (None when the error is not retryable)."""

    def __init__(self, msg: str, reason: str | None = None,
                 retry_after_s: float | None = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


def _parse_address(address: str) -> tuple[int, Any]:
    """'host:port' -> TCP; anything with a path separator (or an
    existing socket file) -> unix domain."""
    if os.path.sep in address or os.path.exists(address):
        return socket.AF_UNIX, address
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"bad serve address {address!r} (want host:port or a socket path)"
        )
    return socket.AF_INET, (host, int(port))


class ServeClient:
    """One connection to a serve daemon. Thread-compatible (a lock
    serializes request/response turns); use one client per loadgen
    thread for true concurrency."""

    def __init__(self, address: str, timeout_s: float = 120.0):
        self.address = address
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        # wire-damage accounting: corrupt frames discarded,
        # duplicate replies deduped, retries spent on wire damage — the
        # loadgen folds these into its honest proxy_metrics record
        self.wire_stats = {"corrupt": 0, "dup": 0, "wire_retries": 0}
        # replies read while waiting for a DIFFERENT id (reordered or
        # raced frames): parked here, consumed by the next matching read
        self._stash: dict[Any, dict] = {}
        family, target = _parse_address(address)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(target)
        self._reader = self._sock.makefile("rb")

    # ---- context manager -------------------------------------------------
    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for closer in (self._reader.close, self._sock.close):
            try:
                closer()
            except OSError:
                pass

    # ---- wire ------------------------------------------------------------
    def _send(self, obj: dict) -> None:
        # seal: the per-line CRC rides every request frame so the
        # daemon detects a garbled
        # request instead of mis-parsing it
        self._sock.sendall(protocol.seal(obj))

    def _recv(self) -> dict:
        """One frame off the wire: crc verify+strip, JSON decode.
        Raises protocol.WireCorruption (counted) on a garbled frame —
        the line was consumed whole, so the stream stays aligned and the
        caller can retry."""
        line = self._reader.readline()
        if not line:
            raise ServeError(
                f"connection to {self.address} closed by the daemon",
                reason="disconnected",
            )
        try:
            return protocol.unseal(line)
        except protocol.WireCorruption:
            self.wire_stats["corrupt"] += 1
            raise

    def _recv_for(self, rid, expect_op: str | None = None) -> dict:
        """The reply matching request id `rid` — the request-id echo is
        what lets duplicated/reordered replies be DETECTED and
        classified, never merged: a frame whose id is already accounted
        for is a dup (dropped, counted), a frame for a different id is
        parked in the stash for its own reader. ``rid=None`` accepts the
        first frame (ops that send no id)."""
        if rid is not None and expect_op is None and rid in self._stash:
            return self._stash.pop(rid)
        # bounded: a dup storm must end in an honest error, not a spin
        for _ in range(64):
            resp = self._recv()
            got = resp.get("id")
            if rid is None:
                return resp
            if got == rid and (
                expect_op is None or resp.get("op") == expect_op
            ):
                return resp
            if got is None:
                if expect_op is None:
                    # a legacy daemon that does not echo ids: the first
                    # frame IS the reply (dedup needs an echo to exist)
                    return resp
                self.wire_stats["dup"] += 1  # id-less stray mid-cancel
                continue
            if got == rid or got in self._stash:
                # a dup of an already-parked reply, or a same-id frame
                # of the wrong op: drop exactly-once
                self.wire_stats["dup"] += 1
                continue
            self._stash[got] = resp
        raise ServeError(
            f"no reply for request {rid!r} within 64 frames "
            f"(duplicate/reordered reply storm?)", reason="wire_corrupt",
        )

    def request(self, obj: dict) -> dict:
        """One request/response turn (matched by request-id echo when
        the request carries an ``id``)."""
        with self._lock:
            self._send(obj)
            return self._recv_for(obj.get("id"))

    # ---- ops -------------------------------------------------------------
    def ping(self) -> dict:
        return self.request({"op": "ping"})

    def status(self) -> dict:
        resp = self.request({"op": "status"})
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "status failed"),
                             reason=resp.get("reason"))
        return resp["status"]

    def prewarm(self, partitions: list[int]) -> dict:
        """Sketch prefetch hint: ask a federated replica to make these
        partitions' sketch payloads resident now (so its first scatter
        leg carries no cold-load spike). Returns the daemon's
        ``{warmed, failed, generation}`` report."""
        resp = self.request(
            {"op": "prewarm", "partitions": [int(p) for p in partitions]}
        )
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "prewarm failed"),
                             reason=resp.get("reason"))
        return resp

    def cancel(self, req_id: str) -> bool:
        """Cooperatively abandon a prior request by id. Returns True
        when the daemon dropped it still-queued (its slot freed without
        a dispatch), False when it was already in flight (the result is
        discarded server-side) or already answered. The ack is matched
        by op+id, so a racing classify reply for the same id is not
        mistaken for it."""
        with self._lock:
            self._send({"op": "cancel", "id": req_id})
            resp = self._recv_for(req_id, expect_op="cancel")
        self._stash.pop(req_id, None)  # drop any parked reply for it
        return bool(resp.get("cancelled"))

    def classify(
        self, genome: str, retries: int = 0, strict: bool = False,
        deadline_ms: float | None = None,
    ) -> dict:
        """Classify one genome; returns the full classify response
        (``verdict``, ``generation``, ``batch_size``, latencies).
        Honors backpressure up to `retries` times, sleeping a JITTERED
        multiple (0.5x-1.5x) of the daemon's own ``retry_after_s`` hint
        between attempts — a herd of clients refused together must not
        re-arrive in lockstep and re-fill the queue to the exact
        high-water mark that refused them.

        A timeout mid-retry surfaces the LAST refusal (reason +
        retry hint), not a bare socket timeout: "backpressure after 3
        attempts" is actionable, "timed out" is not.

        ``strict`` (federated serving): refuse PARTIAL partition
        coverage — a verdict that would be stamped with
        ``partitions_unavailable`` comes back as a ``partial_coverage``
        refusal carrying ``retry_after_s`` (the next reload-probe
        instant), which the retry loop here honors like backpressure.

        ``deadline_ms``: the end-to-end budget, sent on the
        wire (the daemon sheds the request if it expires in queue) AND
        enforced locally — the socket wait is bounded by the REMAINING
        budget, so a stalled wire ends in a clean stamped
        ``deadline_exceeded`` refusal, never a hang. Retries spend the
        same budget (the re-sent request carries the decremented
        remainder). A reply garbled in transit (CRC mismatch) or a
        request the daemon received garbled (``reason: "wire_corrupt"``)
        is retried immediately within the same ``retries`` budget — the
        verdict that finally lands is byte-identical to a clean wire's."""
        deadline = (
            None if deadline_ms is None
            else time.monotonic() + float(deadline_ms) / 1000.0
        )

        def remaining_s() -> float | None:
            return None if deadline is None else deadline - time.monotonic()

        def deadline_refusal(cause: Exception | None = None) -> ServeError:
            err = ServeError(
                f"deadline budget ({deadline_ms:.0f} ms) exhausted "
                f"client-side", reason="deadline_exceeded",
                retry_after_s=float(deadline_ms) / 1000.0,
            )
            err.__cause__ = cause
            return err

        attempt = 0
        last_refusal: dict | None = None
        try:
            while True:
                req = {"op": "classify", "genome": genome,
                       "id": uuid.uuid4().hex[:8]}
                if strict:
                    req["strict"] = True
                left = remaining_s()
                if left is not None:
                    if left <= 0:
                        raise deadline_refusal()
                    req["deadline_ms"] = round(left * 1000.0, 3)
                    # bound the wire wait by the remaining budget: a
                    # stall past it surfaces as the stamped refusal
                    self._sock.settimeout(min(self.timeout_s, left))
                try:
                    resp = self.request(req)
                except protocol.WireCorruption as e:
                    if attempt < retries:
                        attempt += 1
                        self.wire_stats["wire_retries"] += 1
                        continue
                    raise ServeError(
                        f"reply corrupted in transit and retries "
                        f"exhausted after {attempt} attempt(s): {e}",
                        reason="wire_corrupt",
                    ) from e
                except (TimeoutError, socket.timeout) as e:
                    if deadline is not None and remaining_s() <= 0:
                        raise deadline_refusal(e) from e
                    if last_refusal is not None:
                        raise ServeError(
                            f"classify timed out after {attempt} retried refusal(s); "
                            f"last refusal: {last_refusal.get('error', '?')}",
                            reason=last_refusal.get("reason"),
                            retry_after_s=last_refusal.get("retry_after_s"),
                        ) from e
                    raise ServeError(
                        f"classify timed out after {self.timeout_s}s "
                        f"(no refusal seen — daemon unresponsive?)",
                        reason="timeout",
                    ) from e
                if resp.get("ok"):
                    return resp
                if resp.get("reason") == "wire_corrupt" and attempt < retries:
                    # the DAEMON saw our request garbled: re-send now —
                    # nothing was admitted, so this cannot double-classify
                    attempt += 1
                    self.wire_stats["wire_retries"] += 1
                    continue
                retry_after = resp.get("retry_after_s")
                if retry_after is not None and attempt < retries:
                    attempt += 1
                    last_refusal = resp
                    sleep_s = float(retry_after) * (0.5 + random.random())
                    left = remaining_s()
                    if left is not None and sleep_s >= left:
                        # honoring the hint would burn the whole budget:
                        # surface the refusal instead of missing silently
                        raise ServeError(
                            resp.get("error", "classify failed"),
                            reason=resp.get("reason"),
                            retry_after_s=retry_after,
                        )
                    time.sleep(sleep_s)
                    continue
                raise ServeError(
                    resp.get("error", "classify failed"),
                    reason=resp.get("reason"), retry_after_s=retry_after,
                )
        finally:
            if deadline is not None:
                self._sock.settimeout(self.timeout_s)

    def classify_many(
        self, genomes: list[str], strict: bool = False,
        deadline_ms: float | None = None,
    ) -> list[dict]:
        """PIPELINED classify: all requests go out before any reply is
        read, so the daemon's batch window sees them together (the
        coalescing path). Replies are matched by request id — a
        DUPLICATED reply is dropped exactly-once (first frame wins,
        counted in ``wire_stats``), a garbled frame is discarded and its
        request reported as a ``wire_corrupt`` error inline. Returns
        responses in input order (errors inline, not raised) — except a
        disconnection on an UNDAMAGED stream, which raises
        ``disconnected`` like classify does: the daemon died."""
        with self._lock:
            ids = []
            for g in genomes:
                rid = uuid.uuid4().hex[:8]
                ids.append(rid)
                req = {"op": "classify", "genome": g, "id": rid}
                if strict:
                    req["strict"] = True
                if deadline_ms is not None:
                    req["deadline_ms"] = float(deadline_ms)
                self._send(req)
            want = set(ids)
            by_id: dict[str, dict] = {
                rid: self._stash.pop(rid) for rid in ids if rid in self._stash
            }
            frames = corrupts = dups = 0
            while want - set(by_id):
                if corrupts and frames >= len(want) + dups:
                    break  # a corrupt frame ATE a reply: stop honestly
                try:
                    resp = self._recv()
                except protocol.WireCorruption:
                    corrupts += 1
                    frames += 1
                    continue
                except (TimeoutError, socket.timeout):
                    break  # stalled: report the holes inline
                except ServeError:
                    if not corrupts:
                        raise  # clean-stream disconnect: the daemon died
                    break  # EOF after damage (short read): holes inline
                frames += 1
                rid = resp.get("id")
                if rid not in want or rid in by_id:
                    # duplicated reply (or a stray for nobody): first
                    # frame won, this one is dropped — exactly-once
                    self.wire_stats["dup"] += 1
                    dups += 1
                    continue
                by_id[rid] = resp
        return [
            by_id.get(rid, {
                "ok": False,
                "error": "no reply (frame lost or corrupted in transit)",
                "reason": "wire_corrupt" if corrupts else "no_reply",
            })
            for rid in ids
        ]
