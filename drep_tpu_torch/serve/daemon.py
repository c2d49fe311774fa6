"""The `index serve` daemon: a long-lived, dynamically batching,
hot-swapping classify front door over one index store or a federated
root.

Counterpart of drep_tpu/serve/daemon.py. One process loads the index
once (:func:`load_resident_index`): a plain store's sketch matrix is
uploaded to the device (``index/resident_device.py``); a federated
root's streaming resident (``index/federation.py::FederatedResident``)
holds the union spine and loads each partition's sketches on first
consult. It then serves classify requests over a local socket until
drained:

- **dynamic batching** (serve/batcher.py): concurrent requests coalesce
  into one K x N rectangle, one ``mash_shared`` launch against the
  resident matrix. Each answer is the one-shot `index classify` verdict
  of that genome alone (``classify_batch(joint=False)``).
- **hot-swap generations**: a poller re-reads ``manifest.json`` (or a
  federated root's ``federation.json``) every ``poll_generation_s``; a
  published generation G+1 is loaded into a new resident object, a plain
  store's pack uploaded, and swapped in between batches.
  In-flight batches finish on the generation they started on, and every
  verdict carries the generation that produced it. The daemon never
  writes under the index directory.
- **backpressure**: the admission queue is bounded; a full queue (or a
  draining daemon) answers at once with ``retry_after_s``.
- **deadlines and cancel**: a request's budget (its ``deadline_ms``, or
  30 s) is checked at admission against the queue's ETA and again before
  dispatch; ``cancel`` drops a queued request or discards an in-flight
  one's result.
- **graceful drain**: SIGTERM refuses new admissions, finishes every
  queued batch, answers every in-flight client, and exits 0.
- **observability**: latency histograms and queue/batch gauges through
  utils/profiling.py, served by the ``status`` op and HTTP ``/healthz``
  and written under ``--log_dir``, never the index directory. On a
  federated root the snapshot carries the partition health map.
- **federated ops**: a verdict with a coverage hole (a quarantined
  partition) is stamped PARTIAL, and a ``strict`` request refuses it
  with ``partial_coverage`` and the next reload probe as its
  ``retry_after_s``; ``classify_part`` serves one fleet router leg (the
  rectangle of one partition, generation-fenced) and ``prewarm`` loads
  named partitions ahead of the first leg. On a plain root both answer
  ``not_federated``; ``fleet`` answers ``not_a_router`` (the router is
  serve/router.py). One compute lock serializes the batch loop and the
  legs served on connection threads: the resident's residency and health
  bookkeeping is single-threaded by design.

With tracing on (utils/telemetry.py) the daemon leaves the JAX daemon's
timeline: a ``serve_load`` span, ``serve_start``, a ``serve_batch`` span a
batch, ``generation_load`` / ``generation_swap`` on a hot swap, and
``serve_drain`` / ``serve_stop``. The default budget of a request that
carries no ``deadline_ms`` is ``DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS``.
While an `index update` is in flight under the root (a ``pending/g*``
store, under a federated root's ``part_*/pending`` too) the snapshot
carries ``update_pod``: the pod-status snapshot
(utils/hosttools.py::collect) of the newest such store, cut to its
operational keys, the update whose publish the daemon will hot-swap to.

The server is equally usable as a library (tests and chip_smoke.py run it
in-process): ``IndexServer(cfg).start()`` binds and returns the address;
``serve_batches()`` runs the batch loop in the calling thread;
``request_drain()`` is the programmatic SIGTERM.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from drep_tpu_torch.device import resolve_device
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.index import resident_device
from drep_tpu_torch.index.classify import classify_batch, load_resident_index, sketch_queries
from drep_tpu_torch.serve import protocol
from drep_tpu_torch.serve.batcher import AdmissionQueue, PendingRequest, queue_eta_s
from drep_tpu_torch.utils import envknobs, telemetry
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters

# retry hint sent with a backpressure refusal: roughly one batch window
# plus slack — long enough that an immediate retry storm cannot hold the
# queue at the high-water mark, short enough to be invisible to a human
_RETRY_AFTER_FLOOR_S = 0.05

# the end-to-end budget stamped onto requests that carry no deadline_ms
# (legacy clients are bounded too): the knob, read when a server is made,
# and this fallback where it is unset; <= 0 disables the default
DEADLINE_ENV = "DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS"
DEADLINE_DEFAULT_MS = envknobs.knob(DEADLINE_ENV).default


# the pod-status keys the snapshot's update_pod keeps (the JAX daemon's)
UPDATE_POD_KEYS = ("epoch", "live", "dead", "draining", "shards_published", "shards_total", "progress", "eta_s")


def pending_update_status(index_loc: str) -> dict | None:
    """The pod-status snapshot of the newest in-flight update under
    `index_loc` (by the mtime of its ``pending/g*`` store, the root's or a
    partition's), cut to ``checkpoint_dir`` and :data:`UPDATE_POD_KEYS`;
    None when no update is in flight, or on any error (health never
    crashes on a racing update)."""
    from drep_tpu_torch.utils.hosttools import collect

    root = os.path.abspath(index_loc)
    pending_dirs = [os.path.join(root, "pending")]
    with contextlib.suppress(OSError):
        pending_dirs += sorted(os.path.join(root, d, "pending") for d in os.listdir(root)
                               if d.startswith("part_") and os.path.isdir(os.path.join(root, d)))
    candidates: list[tuple[float, str]] = []
    for pending in pending_dirs:
        try:
            gens = [d for d in os.listdir(pending) if d.startswith("g") and os.path.isdir(os.path.join(pending, d))]
        except OSError:
            continue
        for d in gens:
            path = os.path.join(pending, d)
            with contextlib.suppress(OSError):
                candidates.append((os.stat(path).st_mtime, path))
    if not candidates:
        return None
    # several concurrent partition updates leave several: the most
    # recently active one, not the highest-numbered
    ckpt = max(candidates)[1]
    try:
        status = collect(ckpt)
        return {"checkpoint_dir": ckpt, **{k: status[k] for k in UPDATE_POD_KEYS if k in status}}
    except Exception:  # noqa: BLE001 — health must never crash on a racing update
        return None


@dataclass
class ServeConfig:
    index_loc: str
    host: str = "127.0.0.1"
    port: int = 0  # 0 = OS-assigned, reported in the ready line
    socket_path: str | None = None  # unix domain socket (wins over TCP)
    max_queue: int = 256
    max_batch: int = 64
    batch_window_ms: float = 5.0
    poll_generation_s: float = 2.0
    processes: int = 1
    prune_cfg: dict | None = None
    log_dir: str | None = None  # metrics home — never the index
    # a federated root's residency budget (MiB) for partition sketch
    # payloads; None or 0: no budget
    resident_mb: int | None = None
    device: Any = None  # where the kernels run (default cuda; cpu when asked)

    def address(self) -> str:
        return self.socket_path if self.socket_path else f"{self.host}:{self.port}"


@dataclass
class _ServeStats:
    started_at: float = field(default_factory=time.monotonic)
    requests_total: int = 0
    rejected_total: int = 0
    errors_total: int = 0
    batches_total: int = 0
    swaps_total: int = 0
    partial_refusals: int = 0  # strict refusals on PARTIAL coverage
    legs_total: int = 0  # classify_part legs served (the fleet's scatter tier)
    leg_refusals: int = 0  # legs refused (fence, drain, partition loss)
    deadline_shed: int = 0  # queued entries shed on an expired budget
    cancels: int = 0  # requests and legs abandoned via the cancel op


class IndexServer:
    """One resident index + one listener + one batch loop.

    `classify_fn(resident, paths) -> {display_name: verdict}` is
    injectable for tests (backpressure cells stub it with a sleep); the
    default runs the real resident path."""

    def __init__(
        self,
        cfg: ServeConfig,
        classify_fn: Callable[[Any, list[str]], dict] | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.queue = AdmissionQueue(cfg.max_queue, on_shed=self._shed_expired)
        self.stats = _ServeStats()
        self._deadline_default_ms = envknobs.env_float(DEADLINE_ENV, default=DEADLINE_DEFAULT_MS)
        # request ids cancelled while in flight: the result is discarded at
        # reply time. Bounded — a stream of cancels for ids this daemon
        # never saw must not grow memory.
        self._cancelled: "collections.OrderedDict[str, None]" = collections.OrderedDict()
        # the tightest remaining deadline of the batch dispatching now (set
        # by _serve_one_batch, read by the router's leg fan-out)
        self._batch_deadline: float | None = None
        self._classify_fn = classify_fn or self._classify_paths
        self._resident = None
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stop_poll = threading.Event()
        self._lock = threading.Lock()  # stats + the cancel set
        # serializes all resident compute: the batch loop's classify and
        # the classify_part legs served on connection threads (a
        # FederatedResident's LRU and health bookkeeping is single-threaded
        # by design)
        self._compute_lock = threading.Lock()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> str:
        """Load the index (once), upload its pack, bind the listener,
        start the acceptor and generation-poller threads. Returns the
        bound address."""
        t0 = time.monotonic()
        with telemetry.span("serve_load", index=self.cfg.index_loc):
            self._resident = load_resident_index(self.cfg.index_loc, resident_mb=self.cfg.resident_mb,
                                                 device=self.device)
        counters.set_gauge("serve_generation", float(self._resident.generation))
        # arm the resident rectangle before the first batch: one sketch
        # matrix upload per generation, not per batch (a federated root's
        # partitions load on first consult instead)
        resident_device.prewarm_resident(self._resident, self.device)
        get_logger().info(
            "index serve: generation %d (%d genomes) resident on %s in %.2fs",
            self._resident.generation, self._resident.n, self.device, time.monotonic() - t0,
        )
        if self.cfg.socket_path:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            with contextlib.suppress(OSError):
                os.unlink(self.cfg.socket_path)  # the daemon's own socket node
            sock.bind(self.cfg.socket_path)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.cfg.host, self.cfg.port))
            self.cfg.port = sock.getsockname()[1]
        sock.listen(128)
        self._listener = sock
        acceptor = threading.Thread(target=self._accept_loop, daemon=True, name="drep-serve-accept")
        poller = threading.Thread(target=self._poll_generations, daemon=True, name="drep-serve-poll")
        self._threads = [acceptor, poller]
        for t in self._threads:
            t.start()
        telemetry.event("serve_start", address=self.cfg.address(), generation=int(self._resident.generation),
                        n=self._resident.n)
        return self.cfg.address()

    def run(self) -> int:
        """start() + the batch loop in the calling thread, with a JSON
        ready line on stdout (the handshake clients and orchestration
        parse). Returns 0 after a graceful drain."""
        address = self.start()
        print(
            json.dumps(
                {
                    "serving": address,
                    "generation": int(self._resident.generation),
                    "n_genomes": self._resident.n,
                    "pid": os.getpid(),
                },
                separators=(",", ":"),
            ),
            flush=True,
        )
        self.serve_batches()
        self.close()
        get_logger().info(
            "index serve: drained cleanly after %d request(s) in %d batch(es)",
            self.stats.requests_total, self.stats.batches_total,
        )
        return 0

    def request_drain(self) -> None:
        """The programmatic SIGTERM: refuse new admissions, let the batch
        loop finish what is queued, stop the poller."""
        telemetry.event("serve_drain", queued=self.queue.depth())
        self._stop_poll.set()
        self.queue.drain()
        # stop accepting new connections (in-flight sockets finish)
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()

    def close(self) -> None:
        self._stop_poll.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        if self.cfg.socket_path:
            with contextlib.suppress(OSError):
                os.unlink(self.cfg.socket_path)  # the daemon's own socket node
        telemetry.event("serve_stop", requests=self.stats.requests_total)

    # ---- the batch loop --------------------------------------------------
    def serve_batches(self) -> None:
        """Form and serve batches until drained and empty. The serving
        thread: every kernel launch and every resident read of the
        classify path happens here, so a generation swap (poller thread)
        only ever lands between batches."""
        window_s = max(0.0, float(self.cfg.batch_window_ms)) / 1000.0
        while True:
            batch = self.queue.next_batch(self.cfg.max_batch, window_s)
            if batch is None:
                return
            self._serve_one_batch(batch)

    def _classify_paths(self, resident, paths: list[str]) -> dict:
        """The real classify core: sketch the batch once, one rectangle,
        independent verdict assembly. Returns verdicts (and filtered
        refusals) keyed by display name (basename)."""
        queries = sketch_queries(resident, paths, processes=self.cfg.processes)
        verdicts = classify_batch(
            resident, queries, processes=self.cfg.processes,
            prune_cfg=self.cfg.prune_cfg, joint=False, device=self.device,
        )
        return {v["genome"]: v for v in verdicts + queries.dropped}

    def _serve_one_batch(self, batch: list[PendingRequest]) -> None:
        t0 = time.monotonic()
        # queue wait ends when the batch STARTS, so queue + batch sum to
        # the request's server-side wall
        queue_ms_of = {id(req): (t0 - req.enqueued_at) * 1000.0 for req in batch}
        resident = self._resident  # pinned for the whole batch
        paths = list(dict.fromkeys(req.genome for req in batch))
        counters.set_gauge("serve_queue_depth", float(self.queue.depth()))
        counters.set_gauge("serve_batch_size", float(len(batch)))
        by_name: dict = {}
        # basename -> (message, reason, retry_after_s): per-path failures
        # keep their refusal (a router's no-replica error carries reason
        # and retry_after_s attributes the client's backoff needs)
        path_err: dict[str, tuple[str, str, float | None]] = {}
        # the batch's tightest remaining budget, visible to the classify
        # core while it runs: the router decrements it per leg
        deadlines = [req.deadline for req in batch if req.deadline is not None]
        self._batch_deadline = min(deadlines) if deadlines else None
        try:
            with counters.stage("serve_batch"), telemetry.span(
                "serve_batch", n=len(batch), unique=len(paths), generation=int(resident.generation)
            ), self._compute_lock:
                by_name = self._classify_fn(resident, paths)
        except Exception as e:  # noqa: BLE001 — a poisoned batch must not kill the daemon
            # isolate the poison: one unreadable query must not fail its
            # co-batched neighbours (K one-shot classifies would only have
            # failed the bad one). Retry each path alone; only the bad
            # ones answer with an error.
            get_logger().warning(
                "serve: batch of %d failed (%s: %s) — isolating per query",
                len(batch), type(e).__name__, e,
            )
            counters.add_fault("serve_batch_poisoned")
            for p in paths:
                try:
                    with counters.stage("serve_batch"), self._compute_lock:
                        by_name.update(self._classify_fn(resident, [p]))
                except UserInputError as pe:
                    path_err[os.path.basename(p)] = (str(pe), "classify_failed", None)
                except Exception as pe:  # noqa: BLE001
                    path_err[os.path.basename(p)] = (
                        f"{type(pe).__name__}: {pe}", getattr(pe, "reason", None) or "classify_failed",
                        getattr(pe, "retry_after_s", None),
                    )
                    get_logger().exception("serve: query %s failed", p)
        batch_ms = (time.monotonic() - t0) * 1000.0
        counters.observe("serve_batch_ms", batch_ms)
        counters.observe("serve_batch_requests", float(len(batch)))
        # book the batch BEFORE replying: a client that queries status
        # right after its verdict must see its own request counted
        with self._lock:
            self.stats.batches_total += 1
            self.stats.requests_total += len(batch)
        for req in batch:
            queue_ms = queue_ms_of[id(req)]
            base = os.path.basename(req.genome)
            verdict = by_name.get(base)
            if self._is_cancelled(req.req_id):
                # cancelled while in flight: the abandoning client gets the
                # terminal refusal, never a verdict it stopped waiting for
                with self._lock:
                    self.stats.cancels += 1
                counters.add_fault("serve_cancelled")
                req.reply(protocol.error_response(
                    "request cancelled by the client", req_id=req.req_id, reason="cancelled",
                ))
                continue
            if verdict is None:
                with self._lock:
                    self.stats.errors_total += 1
                msg, reason, retry = path_err.get(
                    base, (f"no verdict produced for {req.genome}", "classify_failed", None)
                )
                resp = protocol.error_response(msg, req_id=req.req_id, reason=reason, retry_after_s=retry)
            elif req.strict and verdict.get("partitions_unavailable"):
                # --strict: a PARTIAL verdict (a quarantined partition left
                # a coverage hole) refuses, with the soonest reload probe as
                # the retry hint, instead of a degraded answer
                with self._lock:
                    self.stats.partial_refusals += 1
                counters.add_fault("serve_partial_refused")
                resp = protocol.error_response(
                    f"partial partition coverage: partition(s) "
                    f"{verdict['partitions_unavailable']} unavailable "
                    f"(consulted {verdict.get('partitions_consulted', [])})",
                    req_id=req.req_id, reason="partial_coverage",
                    retry_after_s=self._partial_retry_hint(),
                )
            else:
                resp = protocol.classify_response(
                    verdict, req_id=req.req_id, batch_size=len(batch),
                    queue_ms=queue_ms, batch_ms=batch_ms,
                )
            counters.observe("serve_request_ms", queue_ms + batch_ms)
            req.reply(resp)

    # ---- generation hot-swap --------------------------------------------
    def _poll_generations(self) -> None:
        """Re-read the published generation on a cadence; a bump loads
        into a new resident object, uploads its pack, and swaps in with
        one reference assignment (in-flight batches keep the old object).
        Polling is a checked JSON read of the store's manifest or the
        federated root's meta, the reload ``heal=False``."""
        from drep_tpu_torch.index import meta

        while not self._stop_poll.wait(max(0.05, float(self.cfg.poll_generation_s))):
            try:
                gen = meta.current_generation(self.cfg.index_loc)
            except Exception:  # noqa: BLE001 — a torn or in-flight publish reads as "not yet"
                continue
            if self._resident is None or gen <= int(self._resident.generation):
                continue
            try:
                t0 = time.monotonic()
                with telemetry.span("generation_load", generation=gen):
                    fresh = load_resident_index(self.cfg.index_loc, resident_mb=self.cfg.resident_mb,
                                                device=self.device)
            except Exception as e:  # noqa: BLE001 — keep serving the old generation
                get_logger().warning(
                    "serve: failed to load generation %d (%s) — still serving %d",
                    gen, e, self._resident.generation,
                )
                continue
            old = int(self._resident.generation)
            # the fresh resident carries no pack yet: upload the new
            # generation's sketch matrix before batches land on it
            resident_device.prewarm_resident(fresh, self.device)
            self._resident = fresh
            with self._lock:
                self.stats.swaps_total += 1
            counters.set_gauge("serve_generation", float(fresh.generation))
            telemetry.event("generation_swap", old=old, new=int(fresh.generation), n=fresh.n,
                            load_s=round(time.monotonic() - t0, 4))
            get_logger().info(
                "serve: hot-swapped generation %d -> %d (%d genomes)", old, fresh.generation, fresh.n,
            )

    # ---- status ----------------------------------------------------------
    def snapshot(self) -> dict:
        """The health/metrics snapshot the `status` op and the HTTP
        ``/healthz`` shim both serve (one function: the endpoints cannot
        drift)."""
        resident = self._resident
        hists = {
            name: h.summary()
            # list(): the batch thread inserts new histogram keys
            # concurrently with this handler-thread read
            for name, h in list(counters.hists.items())
            if name.startswith("serve_")
        }
        out = {
            "ok": True,
            "pid": os.getpid(),
            "address": self.cfg.address(),
            "generation": int(resident.generation) if resident is not None else None,
            "n_genomes": resident.n if resident is not None else None,
            "uptime_s": round(time.monotonic() - self.stats.started_at, 3),
            "draining": self.queue.draining,
            "queue_depth": self.queue.depth(),
            "max_queue": self.cfg.max_queue,
            "max_batch": self.cfg.max_batch,
            "batch_window_ms": self.cfg.batch_window_ms,
            "requests_total": self.stats.requests_total,
            "rejected_total": self.stats.rejected_total,
            "errors_total": self.stats.errors_total,
            "batches_total": self.stats.batches_total,
            "generation_swaps": self.stats.swaps_total,
            "latency_ms": hists,
            "partial_refusals": self.stats.partial_refusals,
            "deadline_shed": self.stats.deadline_shed,
            "cancels": self.stats.cancels,
        }
        # a streaming federated resident: the partition health map rides
        # the same snapshot /healthz serves
        if hasattr(resident, "health_map"):
            out["partitions"] = resident.health_map()
        pod = pending_update_status(self.cfg.index_loc)
        if pod is not None:
            out["update_pod"] = pod
        return out

    def _partial_retry_hint(self) -> float:
        resident = self._resident
        if hasattr(resident, "retry_hint_s"):
            return float(resident.retry_hint_s())
        return _RETRY_AFTER_FLOOR_S

    # ---- connections -----------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: drain/shutdown
            # SEND-only timeout (SO_SNDTIMEO, not settimeout, which would
            # also drop idle readers): a client that stops consuming
            # replies makes sendall error out instead of wedging the
            # single batch-loop thread and with it the drain
            with contextlib.suppress(OSError):
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, struct.pack("ll", 15, 0))
            t = threading.Thread(target=self._handle_conn, args=(conn,), daemon=True, name="drep-serve-conn")
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        # per-connection in-flight accounting: the reader may hit EOF (a
        # pipelining client half-closing its write side) while the batch
        # loop still owes replies on this socket — the LAST reply closes
        # the fd, never the reader
        state = {"inflight": 0, "eof": False}

        def send(obj: dict) -> None:
            data = protocol.seal(obj)  # every reply frame carries its CRC
            with wlock:
                with contextlib.suppress(OSError):
                    conn.sendall(data)

        def reply_classify(resp: dict) -> None:
            send(resp)
            with wlock:
                state["inflight"] -= 1
                last = state["eof"] and state["inflight"] <= 0
            if last:
                with contextlib.suppress(OSError):
                    conn.close()

        reader = conn.makefile("rb")
        try:
            first = reader.readline(protocol.MAX_LINE_BYTES)
            if not first:
                return
            if protocol.looks_like_http(first):
                self._handle_http(conn, first, reader)
                return
            line = first
            while line:
                stripped = line.strip()
                if stripped:
                    try:
                        self._handle_line(stripped, send, reply_classify, state, wlock)
                    except Exception as e:  # noqa: BLE001 — one bad request
                        # must not kill the connection thread silently
                        send(protocol.error_response(
                            f"internal error: {type(e).__name__}: {e}", reason="internal",
                        ))
                        get_logger().exception("serve: request handler failed")
                line = reader.readline(protocol.MAX_LINE_BYTES)
        except (OSError, ValueError):
            pass  # client went away: its queued requests still classify;
            # the reply write is suppressed above
        finally:
            with contextlib.suppress(OSError):
                reader.close()
            with wlock:
                state["eof"] = True
                idle = state["inflight"] <= 0
            if idle:
                with contextlib.suppress(OSError):
                    conn.close()

    def _handle_line(
        self, line: bytes, send: Callable[[dict], None],
        reply_classify: Callable[[dict], None], state: dict, wlock,
    ) -> None:
        try:
            req = protocol.parse_request(protocol.check_crc(line))
        except protocol.WireCorruption as e:
            # a request garbled in transit: no id survives to echo, so the
            # refusal is connection-scoped; the client re-sends
            counters.add_fault("serve_wire_corrupt")
            send(protocol.error_response(str(e), reason="wire_corrupt"))
            return
        except protocol.ProtocolError as e:
            send(protocol.error_response(str(e), reason="protocol"))
            return
        op = req["op"]
        if op == "ping":
            send({"ok": True, "op": "ping", "generation": int(self._resident.generation)})
            return
        if op == "status":
            send({"ok": True, "op": "status", "status": self.snapshot()})
            return
        if op == "classify_part":
            # one scatter leg, served on this connection thread (the router
            # bounds its own wait); the compute lock serializes it against
            # the batch loop
            self._serve_leg(req, send)
            return
        if op == "prewarm":
            self._serve_prewarm(req, send)
            return
        if op == "cancel":
            self._cancel(req, send)
            return
        if op == "fleet":
            send(protocol.error_response(
                "this daemon is a serve replica, not a router — fleet membership ops go to "
                "the `index route` front door",
                req_id=req.get("id"), reason="not_a_router",
            ))
            return
        with wlock:
            state["inflight"] += 1
        self._admit_classify(req, reply_classify)

    # ---- deadline budgets + cancellation ---------------------------------
    def _budget_ms(self, req: dict) -> float | None:
        """The request's end-to-end budget: its own ``deadline_ms``, else
        the default when that is > 0, else none (no ETA refusal, no shed)."""
        d = req.get("deadline_ms")
        if d is not None:
            return float(d)
        return self._deadline_default_ms if self._deadline_default_ms > 0 else None

    def _eta_s(self) -> float:
        """Histogram-derived dispatch ETA for a request admitted now: the
        admission check's refusal threshold and a deadline refusal's
        retry hint."""
        return queue_eta_s(
            self.queue.depth(), self.cfg.max_batch,
            max(0.0, float(self.cfg.batch_window_ms)) / 1000.0,
            counters.hists.get("serve_batch_ms"),
        )

    def _shed_expired(self, req: PendingRequest) -> None:
        """AdmissionQueue's on_shed: a queued entry whose budget expired
        before dispatch gets a stamped refusal with the ETA as its retry
        hint; the device never sees it."""
        with self._lock:
            self.stats.deadline_shed += 1
        counters.add_fault("serve_deadline_shed")
        req.reply(protocol.error_response(
            "deadline budget expired while queued "
            f"(waited {(time.monotonic() - req.enqueued_at) * 1000.0:.0f} ms)",
            req_id=req.req_id, reason="deadline_exceeded",
            retry_after_s=max(_RETRY_AFTER_FLOOR_S, self._eta_s()),
        ))

    def _cancel(self, req: dict, send: Callable[[dict], None]) -> None:
        """The cancel op: drop a still-queued request (its connection gets
        the terminal ``cancelled`` refusal so in-flight accounting
        balances), or flag an in-flight id so its result is discarded at
        reply time. The ack states which happened."""
        rid = req["id"]
        queued = self.queue.cancel(rid)
        if queued is not None:
            with self._lock:
                self.stats.cancels += 1
            counters.add_fault("serve_cancelled")
            queued.reply(protocol.error_response(
                "request cancelled by the client", req_id=rid, reason="cancelled",
            ))
        else:
            with self._lock:
                self._cancelled[rid] = None
                while len(self._cancelled) > 1024:
                    self._cancelled.popitem(last=False)
        send({"ok": True, "op": "cancel", "id": rid, "cancelled": queued is not None})

    def _is_cancelled(self, rid) -> bool:
        """Consume (test-and-clear) an in-flight cancellation flag."""
        if rid is None:
            return False
        with self._lock:
            if rid in self._cancelled:
                del self._cancelled[rid]
                return True
        return False

    def _admit_classify(self, req: dict, send: Callable[[dict], None]) -> None:
        genome = os.path.abspath(req["genome"])
        req_id = req.get("id")
        if not os.path.isfile(genome):
            send(protocol.error_response(
                f"no such genome file: {genome}", req_id=req_id, reason="bad_request",
            ))
            return
        budget_ms = self._budget_ms(req)
        deadline = None
        if budget_ms is not None:
            budget_s = budget_ms / 1000.0
            eta_s = self._eta_s()
            if eta_s > budget_s:
                # the queue's dispatch ETA already exceeds the budget: refuse
                # now rather than admit a request we would shed after it aged
                with self._lock:
                    self.stats.deadline_shed += 1
                    self.stats.rejected_total += 1
                counters.add_fault("serve_deadline_shed")
                send(protocol.error_response(
                    f"queue ETA {eta_s * 1000.0:.0f} ms exceeds the {budget_ms:.0f} ms deadline budget",
                    req_id=req_id, reason="deadline_exceeded",
                    retry_after_s=max(_RETRY_AFTER_FLOOR_S, eta_s),
                ))
                return
            deadline = time.monotonic() + budget_s
        pending = PendingRequest(
            genome=genome, reply=send, req_id=req_id,
            strict=bool(req.get("strict", False)), deadline=deadline,
        )
        refused = self.queue.submit(pending)
        if refused is not None:
            with self._lock:
                self.stats.rejected_total += 1
            counters.add_fault("serve_rejected")
            retry = max(_RETRY_AFTER_FLOOR_S, float(self.cfg.batch_window_ms) / 1000.0)
            msg = (
                "daemon is draining (SIGTERM received)"
                if refused == "draining"
                else f"admission queue full ({self.cfg.max_queue})"
            )
            send(protocol.error_response(msg, req_id=req_id, reason=refused, retry_after_s=retry))

    # ---- federated ops: prewarm and classify_part legs -----------------
    def _serve_prewarm(self, req: dict, send: Callable[[dict], None]) -> None:
        """The sketch prefetch hint: make the named partitions' sketch
        payloads resident now (the router sends it at `fleet join` with the
        replica's partitions, so the first leg carries no cold load).
        Best effort: an unknown or unloadable partition is reported under
        "failed" (the quarantine machinery owns it); the reply is never an
        error."""
        req_id = req.get("id")
        resident = self._resident  # pinned: a swap replaces the object
        if not hasattr(resident, "ensure_resident"):
            send(protocol.error_response(
                "this replica serves a monolithic index — prewarm hints need a federated root",
                req_id=req_id, reason="not_federated",
            ))
            return
        warmed: list[int] = []
        failed: list[int] = []
        for pid in req["partitions"]:
            pid = int(pid)
            if pid not in resident._slots:
                failed.append(pid)
                continue
            try:
                with self._compute_lock:
                    ok = resident.ensure_resident(pid)
            except Exception:  # noqa: BLE001 — a hint must not take the replica down
                ok = False
            (warmed if ok else failed).append(pid)
        resp: dict = {"ok": True, "op": "prewarm", "generation": int(resident.generation),
                      "warmed": warmed, "failed": failed}
        if req_id is not None:
            resp["id"] = req_id
        send(resp)

    def _serve_leg(self, req: dict, send: Callable[[dict], None]) -> None:
        """One ``classify_part`` leg: the rectangle of one partition
        against a router's already-sketched query batch. Generation-fenced:
        a leg for another generation is refused with this replica's, never
        computed, so a gather cannot merge union rows of two generations."""
        req_id = req.get("id")
        resident = self._resident  # pinned: a swap replaces the object
        if not hasattr(resident, "classify_partition"):
            send(protocol.error_response(
                "this replica serves a monolithic index — classify_part needs a federated root",
                req_id=req_id, reason="not_federated",
            ))
            return
        if self.queue.draining:
            # leaving: the router reroutes the leg (no dropped query)
            send(protocol.error_response("replica is draining", req_id=req_id, reason="draining",
                                         retry_after_s=_RETRY_AFTER_FLOOR_S))
            return
        have = int(resident.generation)
        want = int(req["generation"])
        if want != have:
            with self._lock:
                self.stats.leg_refusals += 1
            resp = protocol.error_response(
                f"replica is at generation {have}, leg wants {want}", req_id=req_id,
                reason="generation_mismatch",
                retry_after_s=max(_RETRY_AFTER_FLOOR_S, float(self.cfg.poll_generation_s)),
            )
            resp["generation"] = have
            send(resp)
            return
        pid = int(req["pid"])
        if pid not in resident._slots:
            send(protocol.error_response(f"no partition {pid} at generation {have}", req_id=req_id,
                                         reason="bad_request"))
            return
        names = [str(n) for n in req["names"]]
        bottoms = [np.asarray(b, np.uint64) for b in req["bottoms"]]
        prune_cfg = req.get("prune", self.cfg.prune_cfg)
        t0 = time.monotonic()

        def cancelled_refusal() -> None:
            # a losing hedge leg queued behind the compute lock sees its
            # cancel before it spends the card on an answer already given
            with self._lock:
                self.stats.cancels += 1
            counters.add_fault("serve_leg_cancelled")
            send(protocol.error_response("leg cancelled by the router", req_id=req_id, reason="cancelled"))

        if self._is_cancelled(req_id):
            cancelled_refusal()
            return
        # the remaining per-hop budget (the router decrements it before
        # sending) bounds the wait for the compute lock: a leg that cannot
        # start in time refuses instead of computing an unread answer
        leg_deadline = None if req.get("deadline_ms") is None else t0 + float(req["deadline_ms"]) / 1000.0
        try:
            if not self._compute_lock.acquire(
                timeout=-1 if leg_deadline is None else max(0.0, leg_deadline - time.monotonic())
            ):
                with self._lock:
                    self.stats.deadline_shed += 1
                    self.stats.leg_refusals += 1
                counters.add_fault("serve_deadline_shed")
                send(protocol.error_response(
                    "leg deadline budget expired waiting for the compute slot", req_id=req_id,
                    reason="deadline_exceeded", retry_after_s=self._partial_retry_hint(),
                ))
                return
            try:
                if self._is_cancelled(req_id):
                    cancelled_refusal()
                    return
                if not resident.ensure_resident(pid, pin={pid}):
                    res = None
                else:
                    res = resident.classify_partition(pid, names, bottoms, prune_cfg)
            finally:
                self._compute_lock.release()
        except Exception as e:  # noqa: BLE001 — a leg failure must not take the replica down
            get_logger().exception("serve: classify_part leg pid=%d failed", pid)
            with self._lock:
                self.stats.leg_refusals += 1
            send(protocol.error_response(f"leg failed: {type(e).__name__}: {e}", req_id=req_id,
                                         reason="leg_failed", retry_after_s=self._partial_retry_hint()))
            return
        if res is None:
            # this replica's copy of the partition is quarantined: the
            # router reroutes or stamps PARTIAL, the probe hint as its cue
            with self._lock:
                self.stats.leg_refusals += 1
            counters.add_fault("serve_leg_unavailable")
            send(protocol.error_response(f"partition {pid} unavailable on this replica", req_id=req_id,
                                         reason="partition_unavailable", retry_after_s=self._partial_retry_hint()))
            return
        ui, qi, dd = res
        with self._lock:
            self.stats.legs_total += 1
        counters.observe("serve_leg_ms", (time.monotonic() - t0) * 1000.0)
        send({
            "ok": True, "op": "classify_part", "id": req_id, "pid": pid, "generation": have,
            "ui": [int(x) for x in ui],
            "qi": [int(x) for x in qi],
            # float32 -> float -> JSON -> float32 is exact (a double holds
            # every float32), so the routed merge sees the same distances
            "dist": [float(x) for x in dd],
        })

    # ---- HTTP shim -------------------------------------------------------
    def _handle_http(self, conn: socket.socket, first: bytes, reader) -> None:
        try:
            method, path, body = protocol.http_request(first, reader)
            req = protocol.http_to_request(method, path, body)
        except protocol.ProtocolError as e:
            with contextlib.suppress(OSError):
                conn.sendall(protocol.http_response(
                    404 if "no route" in str(e) else 400,
                    protocol.error_response(str(e), reason="protocol"),
                ))
            with contextlib.suppress(OSError):
                conn.close()
            return
        if req["op"] == "status":
            with contextlib.suppress(OSError):
                conn.sendall(protocol.http_response(200, self.snapshot()))
            with contextlib.suppress(OSError):
                conn.close()
            return
        # POST /classify: admit, block this shim thread for the verdict
        done = threading.Event()
        box: dict[str, dict] = {}

        def reply(resp: dict) -> None:
            box["resp"] = resp
            done.set()

        self._admit_classify(dict(req), reply)
        done.wait()
        resp = box.get("resp", protocol.error_response("no response"))
        status = 200 if resp.get("ok") else (
            503 if resp.get("reason") in ("backpressure", "draining", "partial_coverage", "no_replicas",
                                          "deadline_exceeded") else 400
        )
        with contextlib.suppress(OSError):
            conn.sendall(protocol.http_response(status, resp, retry_after_s=resp.get("retry_after_s")))
        with contextlib.suppress(OSError):
            conn.close()


def install_signal_handlers(server: IndexServer) -> None:
    """SIGTERM/SIGINT -> graceful drain (main thread only — the CLI
    path). The handler only starts the drain; the batch loop finishes and
    run() returns 0."""
    import signal

    def _drain(signum, _frame):
        get_logger().warning(
            "serve: %s received — draining (%d queued)",
            signal.Signals(signum).name, server.queue.depth(),
        )
        # off the signal frame: the handler interrupts the batch loop (the
        # main thread), and touching its locks from the interrupted frame
        # could deadlock
        threading.Thread(target=server.request_drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
