"""Dynamic batching + bounded admission for the serve daemon.

Counterpart of drep_tpu/serve/batcher.py.

The queue is the daemon's ONLY buffer, and it is bounded on purpose: a
classify request costs sketching + a share of a rect compare, so an
unbounded queue under overload converts client timeouts into server
OOM. Admission control answers `full` IMMEDIATELY with a retry hint
(protocol.error_response reason="backpressure") — shedding load at the
door is the production behavior, queueing forever is not.

Batch formation is the tentpole's economics: the first waiting request
opens a batch window (``batch_window_ms``); everything that arrives
inside the window joins, up to ``max_batch`` — so 16 concurrent
single-genome queries coalesce into ONE K x N rectangular compare
instead of 16. An idle daemon serves a lone request with at most one
window of added latency (and ``max_batch=1`` degenerates to pure FIFO —
the unbatched reference the serve bench compares against).

One correctness wrinkle rides here: queries are namespaced by basename
(``query:<basename>`` — index/classify.py), so two DIFFERENT paths with
the SAME basename cannot share a batch. ``next_batch`` defers the
collider to the next batch instead of failing either request.

Deadline budgets: every admitted request carries an absolute
monotonic ``deadline`` (stamped by the daemon from the request's
``deadline_ms`` or its default). ``next_batch`` SHEDS an
entry whose budget has already expired — the client has (or is about
to) walk away, so dispatching it would spend a device slot on an answer
nobody reads — via the ``on_shed`` callback (the daemon answers with a
``deadline_exceeded`` refusal carrying the histogram-derived ETA as its
retry hint). The shed happens strictly BEFORE batch membership, so a
shed request never reaches the rect compare. ``cancel`` removes a
still-queued entry by request id — the cooperative-abandonment half of
the same contract.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class PendingRequest:
    """One admitted classify request waiting for its batch."""

    genome: str  # absolute FASTA path
    reply: Callable[[dict], None]  # writes one response to the client
    req_id: Any = None
    # strict partition-coverage mode (federated serving): a PARTIAL verdict is
    # converted into a partial_coverage refusal with retry_after_s
    strict: bool = False
    enqueued_at: float = field(default_factory=time.monotonic)
    # absolute monotonic deadline; None = unbounded (the daemon stamps
    # its default budget on every request it admits)
    deadline: float | None = None

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    @property
    def basename(self) -> str:
        return os.path.basename(self.genome)


def queue_eta_s(
    depth: int, max_batch: int, window_s: float, batch_ms_hist=None,
) -> float:
    """Expected seconds until a request admitted NOW is dispatched: the
    batches already ahead of it (queue depth / batch capacity, plus the
    batch it joins) times the recent median batch wall
    (utils/profiling.Histogram over ``serve_batch_ms``). Before any
    batch has run, the window itself is the only honest estimate. Pure
    arithmetic — the admission check refuses up front when this already
    exceeds a request's budget, and the shed refusal's retry hint
    derives from it (the histogram-ETA rule, pinned by tests)."""
    batches_ahead = int(depth) // max(1, int(max_batch)) + 1
    per_batch_s = max(0.0, float(window_s))
    if batch_ms_hist is not None and getattr(batch_ms_hist, "count", 0) > 0:
        per_batch_s += batch_ms_hist.percentile(0.5) / 1000.0
    return batches_ahead * per_batch_s


class AdmissionQueue:
    """Bounded FIFO with condition-variable batch formation and a drain
    latch. Thread-safe: connection handlers submit, the single batch
    loop consumes."""

    def __init__(
        self, max_queue: int = 256,
        on_shed: Callable[[PendingRequest], None] | None = None,
    ):
        self.max_queue = int(max_queue)
        self._items: deque[PendingRequest] = deque()
        self._cond = threading.Condition()
        self._draining = False
        # called (outside batch membership, inside the lock's shadow) for
        # every entry shed because its deadline expired in queue
        self._on_shed = on_shed

    # ---- admission (handler threads) ------------------------------------
    def submit(self, req: PendingRequest) -> str | None:
        """Admit one request. Returns None on success, or the refusal
        reason ("backpressure" / "draining") — the caller answers the
        client immediately either way."""
        with self._cond:
            if self._draining:
                return "draining"
            if len(self._items) >= self.max_queue:
                return "backpressure"
            self._items.append(req)
            self._cond.notify()
            return None

    def depth(self) -> int:
        return len(self._items)

    @property
    def draining(self) -> bool:
        return self._draining

    def cancel(self, req_id) -> PendingRequest | None:
        """Remove a still-QUEUED request by id (cooperative abandonment).
        Returns the removed entry (the caller still owes its connection a
        terminal ``cancelled`` reply — the in-flight accounting must
        balance) or None when no queued entry matches (already batched,
        already answered, or never seen)."""
        if req_id is None:
            return None
        with self._cond:
            for req in self._items:
                if req.req_id == req_id:
                    self._items.remove(req)
                    return req
        return None

    # ---- drain (signal handler / tests) ----------------------------------
    def drain(self) -> None:
        """Refuse all future admissions; wake the batch loop so it can
        finish what is queued and exit (the drain idiom: in-flight
        work completes, new work is refused, the process exits 0)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    # ---- batch formation (the batch loop) --------------------------------
    def next_batch(
        self, max_batch: int, window_s: float
    ) -> list[PendingRequest] | None:
        """Block until at least one request is queued, then hold the
        batch window open for late arrivals up to `max_batch`. Returns
        None exactly once the queue is BOTH draining and empty — the
        batch loop's termination signal."""
        max_batch = max(1, int(max_batch))
        with self._cond:
            while not self._items:
                if self._draining:
                    return None
                self._cond.wait()
            if max_batch > 1 and window_s > 0:
                deadline = time.monotonic() + window_s
                while len(self._items) < max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(timeout=left):
                        break
            batch: list[PendingRequest] = []
            seen: dict[str, str] = {}  # basename -> path already in batch
            deferred: list[PendingRequest] = []
            shed: list[PendingRequest] = []
            now = time.monotonic()
            while self._items and len(batch) < max_batch:
                req = self._items.popleft()
                if req.expired(now):
                    # budget burned in queue: shedding here — BEFORE batch
                    # membership — is what guarantees an expired request
                    # never reaches the rect compare
                    shed.append(req)
                    continue
                if seen.get(req.basename, req.genome) != req.genome:
                    # same basename, DIFFERENT path: the query: namespace
                    # can hold only one per batch — defer, never fail.
                    # (The same path twice is fine: the daemon classifies
                    # it once and fans the verdict out.)
                    deferred.append(req)
                    continue
                seen[req.basename] = req.genome
                batch.append(req)
            for req in reversed(deferred):
                self._items.appendleft(req)
            if deferred:
                self._cond.notify()
        # refusals go out OUTSIDE the lock: a slow client socket must
        # not stall admissions behind the shed bookkeeping
        if self._on_shed is not None:
            for req in shed:
                self._on_shed(req)
        if not batch and (shed or deferred):
            # everything popped was shed/deferred: recurse rather than
            # hand the loop an empty batch (it would treat [] as work)
            return self.next_batch(max_batch, window_s)
        return batch
