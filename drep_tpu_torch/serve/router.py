"""The `index route` fleet front door: a stateless scatter/gather router
over N `index serve` replicas of one federated root.

Counterpart of drep_tpu/serve/router.py. One router process speaks the
serve protocol (serve/protocol.py: NDJSON and the HTTP shim, so every
client works unchanged) in front of a fleet of replicas, each holding
some or all of the root's partitions. The router holds the cheap half of
the same root, the streaming resident's spine and routing bitmaps with no
sketch payloads at start, and farms each per-partition rectangle out to
the fleet:

- **routing**: each query's coarse code summary names its candidate
  partitions (recall 1.0); a leg goes to a replica with cache affinity
  for its partition (resident before evicted, shallow queue before deep).
- **forward**: a query whose whole candidate set one replica covers is
  forwarded as a plain ``classify`` (the replica's batch window coalesces
  concurrent forwards).
- **scatter/gather**: the other queries fan out as ``classify_part``
  legs, one a candidate partition, and merge through the recluster the
  replicas run themselves (``classify_batch_federated`` with the gathered
  legs injected as ``partition_compare``), so a routed verdict is the
  single daemon's, byte for byte. The merge's recluster runs on this
  process's device: the fused indicator kernel of each dirty cluster.
- **generation fence**: every leg carries the router's federation
  generation and a replica at another generation refuses it (with its
  own), so a mixed-generation gather never merges. A replica ahead of the
  router triggers one synchronous reload and a retry of the whole gather.
- **robustness**: per-leg timeouts; straggler hedging (a duplicate to a
  second capable replica after ``hedge_delay_s``; the first answer wins,
  the loser is cancelled through the protocol's ``cancel`` op); a failed
  leg is rerouted, else the verdict is stamped PARTIAL (``strict`` turns
  it into a ``partial_coverage`` refusal); refusals of a saturated or
  draining replica spill to PARTIAL instead of queueing behind it;
  replicas join and leave a running router (the ``fleet`` op) without a
  dropped query.
- **replica containment**: /healthz probes drive healthy -> suspect
  (immediate reprobe) -> ejected (doubling reprobe backoff); on top, a
  per-replica error-rate circuit breaker opens on ``breaker_errs`` leg
  errors in ``breaker_window_s`` and lets one half-open probe leg through
  after ``breaker_halfopen_s``.
- **deadline propagation**: a batch's tightest remaining budget stamps
  every leg with what is left at its own launch, bounds the hedge, and
  gates each partition consult of the merge.

The router writes nothing anywhere: kill and restart it and the fleet
re-forms from the replica specs and the probes. Not ported: the fleet
supervisor and its durable membership manifest (``index supervise``,
``--fleet_manifest``), and the wire-chaos proxy (ROADMAP.md queue 1 item
11c). The defaults of :class:`RouterConfig`'s fleet fields are the
``DREP_TORCH_ROUTER_*`` / ``DREP_TORCH_SERVE_PROBE_MAX_S`` knobs, read when
a config is made (an explicit field wins). The ``router_leg`` fault site
fires at each scatter leg and forward group, ``replica_health`` at each
replica probe; with tracing on, the replica table's transitions, the
fleet op, the fence reload and the router's start are instants
(``replica_<state>``, ``replica_breaker_*``, ``fleet_*``,
``generation_swap``, ``route_start``).
"""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.serve import protocol
from drep_tpu_torch.serve.client import ServeClient
from drep_tpu_torch.serve.daemon import _RETRY_AFTER_FLOOR_S, IndexServer, ServeConfig
from drep_tpu_torch.utils import envknobs, faults, telemetry
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters

REPLICA_HEALTHY = "healthy"
REPLICA_SUSPECT = "suspect"
REPLICA_EJECTED = "ejected"

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# the ROADMAP item that owns the fleet supervisor, its manifest and the
# wire-chaos proxy
FLEET_SUPERVISION_ITEM = "ROADMAP.md queue 1, item 11c"

# entries the router's sketch cache keeps (a sketch is a few KB; the cap
# bounds a leak, it is not a memory budget)
_SKETCH_CACHE_CAP = 4096

# leg request ids (the cancel handle of a losing hedge leg), unique in the
# process; itertools.count.__next__ is atomic under the GIL
_LEG_SEQ = itertools.count()


def refuse_fleet_manifest(path: str | None) -> None:
    """Raise NotImplementedError for a ``--fleet_manifest``: the
    supervisor's durable membership is item 11c."""
    if path:
        raise NotImplementedError(
            f"--fleet_manifest {path}: the fleet supervisor's manifest is not ported yet "
            f"({FLEET_SUPERVISION_ITEM}); name the replicas with --replica or join them "
            f"through the fleet op"
        )


def decrement_budget_ms(budget_ms: float | None, elapsed_s: float) -> float | None:
    """The per-hop budget rule: what remains of a request's budget after
    `elapsed_s` at this hop, clamped at zero (a leg never gets more than
    its parent has left, and an exhausted budget propagates as 0.0, an
    immediate shed at the replica). None (no budget) stays None."""
    if budget_ms is None:
        return None
    return max(0.0, float(budget_ms) - float(elapsed_s) * 1000.0)


def remaining_budget_ms(deadline: float | None, now: float | None = None) -> float | None:
    """:func:`decrement_budget_ms` against an absolute monotonic deadline,
    the form the dispatch paths carry: a leg launched late inherits what
    is left, not the original grant."""
    if deadline is None:
        return None
    if now is None:
        now = time.monotonic()
    return max(0.0, (deadline - now) * 1000.0)


class FleetUnavailableError(RuntimeError):
    """No usable replica: the clients get a ``no_replicas`` refusal with
    the soonest reprobe as its retry hint (the daemon's per-path error
    isolation forwards ``reason`` and ``retry_after_s``)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.reason = "no_replicas"
        self.retry_after_s = retry_after_s


def parse_replica_spec(spec: str) -> tuple[str, frozenset | None]:
    """``ADDR`` or ``ADDR=PIDS``, PIDS a comma list of ids and inclusive
    ranges (``0-2,5``). No assignment: the replica serves every
    partition."""
    addr, sep, rest = spec.partition("=")
    addr = addr.strip()
    if not addr:
        raise UserInputError(f"bad replica spec {spec!r}: empty address")
    if not sep:
        return addr, None
    pids: set[int] = set()
    for part in filter(None, (p.strip() for p in rest.split(","))):
        lo, dash, hi = part.partition("-")
        try:
            if dash:
                pids.update(range(int(lo), int(hi) + 1))
            else:
                pids.add(int(part))
        except ValueError as e:
            raise UserInputError(
                f"bad replica spec {spec!r}: partition list must be ids/"
                f"ranges like 0-2,5 (got {part!r})"
            ) from e
    if not pids:
        raise UserInputError(f"bad replica spec {spec!r}: '=' given but no partitions named")
    return addr, frozenset(pids)


@dataclass
class RouterConfig(ServeConfig):
    """ServeConfig plus the fleet surface. ``replicas`` are
    :func:`parse_replica_spec` strings; each knob field defaults to its
    ``DREP_TORCH_*`` knob, read when the config is made.
    ``fleet_manifest`` (the supervisor's, item 11c) makes the router
    refuse to start."""

    replicas: list[str] = field(default_factory=list)
    leg_timeout_s: float = field(default_factory=lambda: envknobs.env_float("DREP_TORCH_ROUTER_LEG_TIMEOUT_S"))
    hedge_delay_s: float = field(default_factory=lambda: envknobs.env_float("DREP_TORCH_ROUTER_HEDGE_DELAY_S"))
    probe_interval_s: float = 1.0
    probe_backoff_s: float = field(default_factory=lambda: envknobs.env_float("DREP_TORCH_ROUTER_PROBE_BACKOFF_S"))
    probe_max_s: float = field(default_factory=lambda: envknobs.env_float("DREP_TORCH_SERVE_PROBE_MAX_S"))
    # the admission bound (it sets max_queue)
    max_inflight: int = field(default_factory=lambda: envknobs.env_int("DREP_TORCH_ROUTER_MAX_INFLIGHT"))
    breaker_errs: int = field(default_factory=lambda: envknobs.env_int("DREP_TORCH_ROUTER_BREAKER_ERRS"))
    breaker_window_s: float = field(default_factory=lambda: envknobs.env_float("DREP_TORCH_ROUTER_BREAKER_WINDOW_S"))
    breaker_halfopen_s: float = field(
        default_factory=lambda: envknobs.env_float("DREP_TORCH_ROUTER_BREAKER_HALFOPEN_S"))
    fleet_manifest: str | None = None


@dataclass
class ReplicaSlot:
    """One replica's containment record: the partition slot machine of
    the streaming resident, promoted to a whole process."""

    address: str
    assigned: frozenset | None = None  # None = serves all partitions
    state: str = REPLICA_HEALTHY
    failures: int = 0
    probes: int = 0
    recoveries: int = 0
    backoff_s: float = 0.0
    next_probe: float = 0.0  # monotonic: the earliest reprobe when ejected
    last_ok: float | None = None
    last_err: str | None = None
    generation: int | None = None
    n_genomes: int | None = None
    queue_depth: int = 0
    inflight: int = 0  # router-side legs and forwards on the wire
    draining: bool = False
    resident: frozenset = frozenset()  # pids with sketches resident
    left: bool = False  # fleet leave: no new legs, record kept
    # the error-rate circuit breaker over the health machine: recent error
    # instants (pruned to the window), its state and when it opened
    err_times: list = field(default_factory=list)
    breaker: str = BREAKER_CLOSED
    breaker_opened: float = 0.0
    breaker_trips: int = 0


class ReplicaTable:
    """The router's only mutable state: per-replica health and affinity,
    fed by the /healthz poller and by leg outcomes. Thread-safe (the probe
    thread, leg threads and fleet-op handler threads all book here)."""

    def __init__(self, specs: list[str], probe_backoff_s: float, probe_max_s: float, breaker_errs: int = 5,
                 breaker_window_s: float = 30.0, breaker_halfopen_s: float = 5.0):
        self._lock = threading.Lock()
        self._slots: dict[str, ReplicaSlot] = {}
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_max_s = float(probe_max_s)
        self.breaker_errs = int(breaker_errs)
        self.breaker_window_s = float(breaker_window_s)
        self.breaker_halfopen_s = float(breaker_halfopen_s)
        for spec in specs:
            addr, assigned = parse_replica_spec(spec)
            self.join(addr, assigned)

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values() if not s.left)

    # ---- membership (the fleet op and the CLI's specs) -----------------
    def join(self, address: str, assigned: frozenset | None = None) -> ReplicaSlot:
        with self._lock:
            slot = self._slots.get(address)
            if slot is None:
                slot = ReplicaSlot(address=address, assigned=assigned)
                self._slots[address] = slot
            else:
                # a rejoin is routable at once; probes re-earn trust
                slot.left = False
                slot.state = REPLICA_HEALTHY
                slot.failures = 0
                slot.backoff_s = 0.0
                slot.next_probe = 0.0
                slot.err_times.clear()
                slot.breaker = BREAKER_CLOSED
                if assigned is not None:
                    slot.assigned = assigned
            return slot

    # ---- in-flight accounting --------------------------------------------
    def lease(self, address: str) -> None:
        """Book one router-side dispatch onto a replica. /healthz's
        ``queue_depth`` refreshes only at probe cadence: within an interval
        the lease count is the only load signal (without it equally good
        targets tie and the address tiebreak sends a batch to one)."""
        with self._lock:
            slot = self._slots.get(address)
            if slot is not None:
                slot.inflight += 1

    def release(self, address: str) -> None:
        with self._lock:
            slot = self._slots.get(address)
            if slot is not None and slot.inflight > 0:
                slot.inflight -= 1

    def leave(self, address: str) -> bool:
        """No new legs route here; legs in flight finish on their sockets."""
        with self._lock:
            slot = self._slots.get(address)
            if slot is None:
                return False
            slot.left = True
            return True

    # ---- outcome booking -------------------------------------------------
    def _book_breaker_error(self, slot: ReplicaSlot, now: float) -> bool:
        """Book one error into the breaker window (lock held). Errors count
        whether or not successes interleave (a flapping replica never
        resets the window the way a success resets the health machine's
        streak). True when this error tripped (or re-tripped) the breaker."""
        slot.err_times.append(now)
        cutoff = now - self.breaker_window_s
        slot.err_times[:] = [t for t in slot.err_times if t > cutoff]
        if slot.breaker == BREAKER_HALF_OPEN:
            # the half-open probe leg failed: reopen for a full cooldown
            slot.breaker = BREAKER_OPEN
            slot.breaker_opened = now
            return True
        if slot.breaker == BREAKER_CLOSED and len(slot.err_times) >= self.breaker_errs:
            slot.breaker = BREAKER_OPEN
            slot.breaker_opened = now
            slot.breaker_trips += 1
            return True
        return False

    def book_failure(self, address: str, err: BaseException | str) -> None:
        now = time.monotonic()
        with self._lock:
            slot = self._slots.get(address)
            if slot is None or slot.left:
                return
            slot.failures += 1
            slot.last_err = f"{err}"
            tripped = self._book_breaker_error(slot, now)
            if slot.state == REPLICA_HEALTHY:
                slot.state = REPLICA_SUSPECT
                slot.next_probe = now  # one immediate reprobe: a blip is not an ejection
            elif slot.state == REPLICA_SUSPECT:
                slot.state = REPLICA_EJECTED
                slot.backoff_s = self.probe_backoff_s
                slot.next_probe = now + slot.backoff_s
            else:
                slot.backoff_s = min(self.probe_max_s, max(self.probe_backoff_s, slot.backoff_s * 2))
                slot.next_probe = now + slot.backoff_s
            state = slot.state
        counters.add_fault(f"router_replica_{state}")
        telemetry.event(f"replica_{state}", address=address, error=f"{err}"[:200])
        if tripped:
            counters.add_fault("router_breaker_open")
            telemetry.event("replica_breaker_open", address=address)

    def book_success(self, address: str, status: dict | None = None) -> None:
        breaker_closed = False
        with self._lock:
            slot = self._slots.get(address)
            if slot is None:
                return
            if status is None and slot.breaker != BREAKER_CLOSED:
                # a real leg answered (the half-open probe, or a leg that
                # raced the trip): close and forget the window. /healthz
                # probes do not close it: a replica can answer /healthz
                # while erroring on every leg
                slot.breaker = BREAKER_CLOSED
                slot.err_times.clear()
                breaker_closed = True
            recovered = slot.state != REPLICA_HEALTHY
            if recovered:
                slot.recoveries += 1
            slot.state = REPLICA_HEALTHY
            slot.failures = 0
            slot.backoff_s = 0.0
            slot.last_ok = time.monotonic()
            slot.last_err = None
            if status:
                slot.probes += 1
                slot.generation = status.get("generation")
                slot.n_genomes = status.get("n_genomes")
                slot.queue_depth = int(status.get("queue_depth") or 0)
                slot.draining = bool(status.get("draining"))
                per = (status.get("partitions") or {}).get("partitions") or {}
                try:
                    slot.resident = frozenset(int(p) for p, info in per.items() if info.get("resident"))
                except (TypeError, ValueError):
                    slot.resident = frozenset()
        if recovered:
            counters.add_fault("router_replica_recovered")
            telemetry.event("replica_recovered", address=address)
        if breaker_closed:
            counters.add_fault("router_breaker_closed")
            telemetry.event("replica_breaker_closed", address=address)

    # ---- routing views ---------------------------------------------------
    def _breaker_allows(self, s: ReplicaSlot, now: float) -> bool:
        """The breaker gate (lock held). Open blocks every leg until the
        half-open instant, when one probe leg may pass: the transition
        happens here, and the lease count bounds the probe (a second leg
        while it is out sees ``inflight > 0`` and routes elsewhere)."""
        if s.breaker == BREAKER_OPEN:
            if now < s.breaker_opened + self.breaker_halfopen_s:
                return False
            s.breaker = BREAKER_HALF_OPEN
        return not (s.breaker == BREAKER_HALF_OPEN and s.inflight > 0)

    def _routable(self) -> list[ReplicaSlot]:
        now = time.monotonic()
        return [
            s for s in self._slots.values()
            if not s.left and not s.draining and s.state != REPLICA_EJECTED and self._breaker_allows(s, now)
        ]

    def eligible(self, pid: int) -> list[ReplicaSlot]:
        """Replicas capable of partition `pid`, best first: sketch
        affinity, then health, then shallow queues (address tiebreak)."""
        with self._lock:
            slots = [s for s in self._routable() if s.assigned is None or pid in s.assigned]
            slots.sort(key=lambda s: (
                0 if pid in s.resident else 1,
                0 if s.state == REPLICA_HEALTHY else 1,
                s.queue_depth + s.inflight, s.address,
            ))
            return slots

    def cover_targets(self, pids: set[int]) -> list[ReplicaSlot]:
        """Replicas whose assignment covers every pid of `pids` (the
        forward path), best first by affinity overlap."""
        with self._lock:
            slots = [s for s in self._routable() if s.assigned is None or pids <= s.assigned]
            slots.sort(key=lambda s: (
                -len(pids & s.resident),
                0 if s.state == REPLICA_HEALTHY else 1,
                s.queue_depth + s.inflight, s.address,
            ))
            return slots

    def usable(self) -> bool:
        with self._lock:
            return bool(self._routable())

    def probe_due(self, now: float) -> list[tuple[str, str]]:
        """(address, state) of each replica to probe this tick: healthy and
        suspect always, ejected past their backoff, left never."""
        with self._lock:
            return [
                (s.address, s.state) for s in self._slots.values()
                if not s.left and (s.state != REPLICA_EJECTED or now >= s.next_probe)
            ]

    def retry_hint_s(self) -> float:
        """The soonest anything could change: the refusal's hint when no
        replica is usable."""
        now = time.monotonic()
        with self._lock:
            waits = [
                max(_RETRY_AFTER_FLOOR_S, s.next_probe - now)
                for s in self._slots.values() if not s.left and s.state == REPLICA_EJECTED
            ]
        return min(waits) if waits else self.probe_backoff_s

    def health_map(self) -> dict:
        with self._lock:
            replicas = {
                s.address: {
                    "state": "left" if s.left else s.state,
                    "assigned": sorted(s.assigned) if s.assigned is not None else None,
                    "generation": s.generation,
                    "n_genomes": s.n_genomes,
                    "queue_depth": s.queue_depth,
                    "inflight": s.inflight,
                    "draining": s.draining,
                    "resident": sorted(s.resident),
                    "failures": s.failures,
                    "recoveries": s.recoveries,
                    "probes": s.probes,
                    "last_error": s.last_err,
                    "breaker": s.breaker,
                    "breaker_trips": s.breaker_trips,
                    "breaker_errors": len(s.err_times),
                }
                for s in sorted(self._slots.values(), key=lambda s: s.address)
            }
            suspect = sorted(s.address for s in self._slots.values() if not s.left and s.state == REPLICA_SUSPECT)
            ejected = sorted(s.address for s in self._slots.values() if not s.left and s.state == REPLICA_EJECTED)
            breaker_open = sorted(
                s.address for s in self._slots.values() if not s.left and s.breaker != BREAKER_CLOSED
            )
        return {"replicas": replicas, "suspect": suspect, "ejected": ejected, "breaker_open": breaker_open}


class RouterServer(IndexServer):
    """IndexServer whose classify core routes to a fleet instead of
    comparing locally. Admission, batching, the strict/PARTIAL refusal,
    the generation poller, SIGTERM drain and /healthz are the daemon's."""

    def __init__(self, cfg: RouterConfig, classify_fn=None):
        refuse_fleet_manifest(cfg.fleet_manifest)
        self.leg_timeout_s = float(cfg.leg_timeout_s)
        self.hedge_delay_s = float(cfg.hedge_delay_s)
        cfg.max_queue = int(cfg.max_inflight)
        super().__init__(cfg, classify_fn=classify_fn)
        self.table = ReplicaTable(
            list(cfg.replicas), cfg.probe_backoff_s, cfg.probe_max_s, breaker_errs=cfg.breaker_errs,
            breaker_window_s=cfg.breaker_window_s, breaker_halfopen_s=cfg.breaker_halfopen_s,
        )
        self.router_stats = {
            "forwarded": 0,  # queries answered by the forward path
            "scattered": 0,  # queries answered by the scatter/gather merge
            "legs_total": 0,
            "leg_failures": 0,
            "reroutes": 0,
            "hedges": 0,
            "hedge_wins": 0,
            "hedge_cancels": 0,  # losing hedge legs cancelled
            "fence_retries": 0,  # gathers retried after a generation fence
            "fence_reloads": 0,  # synchronous reloads the fence forced
            "overload_spills": 0,  # legs abandoned on fleet-wide backpressure
            "partial_verdicts": 0,
        }
        self._swap_lock = threading.Lock()  # the fence's reload against the poller's swap
        self._sketch_lock = threading.Lock()
        self._sketch_cache: OrderedDict[tuple, dict] = OrderedDict()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> str:
        address = super().start()
        if not hasattr(self._resident, "route_candidates"):
            self.close()
            raise UserInputError(
                f"index route needs a FEDERATED root (got a monolithic "
                f"store at {self.cfg.index_loc}) — the router scatters "
                f"per-partition legs; a monolithic index has nothing to "
                f"scatter. Serve it with `index serve` instead."
            )
        # a classify_part leg is one protocol line carrying its queries'
        # bottoms as JSON integers (at most 22 bytes a hash): a leg past
        # the line limit is refused by the replica, and its partition
        # books unavailable for the whole batch
        per_query = 22 * int(self._resident.params["sketch_size"])
        if self.cfg.max_batch * per_query > protocol.MAX_LINE_BYTES:
            get_logger().warning(
                "route: a scatter leg of up to --max_batch %d queries at sketch size %d can pass the "
                "protocol's %d-byte line; such legs are refused and their verdicts go PARTIAL — keep "
                "--max_batch at or below %d", self.cfg.max_batch, int(self._resident.params["sketch_size"]),
                protocol.MAX_LINE_BYTES, protocol.MAX_LINE_BYTES // per_query,
            )
        prober = threading.Thread(target=self._probe_loop, daemon=True, name="drep-route-probe")
        self._threads.append(prober)
        prober.start()
        telemetry.event("route_start", address=address, replicas=len(self.table),
                        generation=int(self._resident.generation))
        return address

    # ---- replica health polling -----------------------------------------
    def _probe_once(self) -> None:
        for addr, _state in self.table.probe_due(time.monotonic()):
            try:
                faults.fire("replica_health")
                with ServeClient(addr, timeout_s=min(5.0, self.leg_timeout_s)) as c:
                    status = c.status()
                self.table.book_success(addr, status)
            except Exception as e:  # noqa: BLE001 — a failed probe advances the slot machine
                self.table.book_failure(addr, e)

    def _probe_loop(self) -> None:
        interval = max(0.05, float(self.cfg.probe_interval_s))
        while True:
            self._probe_once()
            if self._stop_poll.wait(interval):
                return

    # ---- the fleet membership op ----------------------------------------
    def _handle_line(self, line, send, reply_classify, state, wlock) -> None:
        try:
            req = protocol.parse_request(line)
        except protocol.ProtocolError:
            # the base handler answers with the canonical protocol error
            return super()._handle_line(line, send, reply_classify, state, wlock)
        if req["op"] == "fleet":
            self._handle_fleet(req, send)
            return
        return super()._handle_line(line, send, reply_classify, state, wlock)

    def _handle_fleet(self, req: dict, send) -> None:
        action, addr = req["action"], req["address"]
        parts = req.get("partitions")
        assigned = frozenset(int(p) for p in parts) if parts is not None else None
        if action == "join":
            self.table.join(addr, assigned)
            known = True
            # tell the joiner its partitions so it warms their sketches
            # before its first leg: synchronous (the ack means "ready for
            # legs") but contained, a failed hint only logs
            self._prewarm_joiner(addr, assigned)
        else:
            known = self.table.leave(addr)
        get_logger().info(
            "route: fleet %s %s%s (%d replica(s) routable)", action, addr,
            f" partitions={sorted(assigned)}" if assigned is not None else "", len(self.table),
        )
        telemetry.event("fleet_" + action, address=addr,
                        partitions=sorted(assigned) if assigned is not None else None)
        send({"ok": True, "op": "fleet", "action": action, "address": addr, "known": known,
              "replicas": len(self.table), "id": req.get("id")})

    def _prewarm_joiner(self, addr: str, assigned: frozenset | None) -> None:
        """One bounded prewarm turn to a joining replica with its assigned
        partitions (every partition when it is unscoped). Best effort: a
        failure logs and the join proceeds; its first legs load lazily."""
        resident = self._resident
        if assigned is not None:
            pids = sorted(assigned)
        elif hasattr(resident, "_slots"):
            pids = sorted(resident._slots)
        else:
            pids = []
        if not pids:
            return
        try:
            with ServeClient(addr, timeout_s=self.leg_timeout_s) as client:
                report = client.prewarm(pids)
        except Exception as e:  # noqa: BLE001 — a hint never fails the join
            get_logger().warning(
                "route: prewarm hint to joining replica %s failed (%s) — its first legs lazy-load instead", addr, e,
            )
            return
        get_logger().info(
            "route: prewarmed joining replica %s — partitions %s resident%s", addr, report.get("warmed"),
            f", {report['failed']} failed" if report.get("failed") else "",
        )
        telemetry.event("fleet_prewarm", address=addr, warmed=report.get("warmed"), failed=report.get("failed"))

    # ---- status ----------------------------------------------------------
    def snapshot(self) -> dict:
        out = super().snapshot()
        out["role"] = "router"
        out["replicas"] = self.table.health_map()
        with self._lock:
            out["router"] = dict(self.router_stats)
        return out

    # ---- the generation fence --------------------------------------------
    def _fence_reload(self):
        """A synchronous reload when a gather proves the fleet ahead of the
        router's generation (the poller would catch up within
        poll_generation_s; the fence cannot wait). Returns the freshest
        resident."""
        from drep_tpu_torch.index import resident_device
        from drep_tpu_torch.index.classify import load_resident_index

        with self._swap_lock:
            current = self._resident
            try:
                fresh = load_resident_index(self.cfg.index_loc, resident_mb=self.cfg.resident_mb,
                                            device=self.device)
            except Exception as e:  # noqa: BLE001 — keep the current generation
                get_logger().warning("route: fence reload failed (%s)", e)
                return current
            if current is not None and int(fresh.generation) <= int(current.generation):
                return current
            resident_device.prewarm_resident(fresh, self.device)
            old = int(current.generation) if current is not None else -1
            self._resident = fresh
            with self._lock:
                self.stats.swaps_total += 1
                self.router_stats["fence_reloads"] += 1
            counters.set_gauge("serve_generation", float(fresh.generation))
            telemetry.event("generation_swap", old=old, new=int(fresh.generation), n=fresh.n, fenced=True)
            get_logger().info("route: generation fence reload %d -> %d", old, fresh.generation)
            return fresh

    # ---- the routed classify core ---------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.router_stats[key] += n

    def _classify_paths(self, resident, paths: list[str]) -> dict:
        """The daemon's classify core, routed: sketch (cached), route,
        forward or scatter, merge. Returns verdicts keyed by display name;
        the inherited batch loop does admission, batching, the strict
        refusal and the replies. ``self._batch_deadline`` (the batch's
        tightest remaining deadline) bounds every leg."""
        budget_deadline = self._batch_deadline
        queries = self._sketch_batch(resident, paths)
        out: dict[str, dict] = {v["genome"]: v for v in queries.dropped}
        if not queries.n:
            return out
        if not self.table.usable():
            raise FleetUnavailableError(
                "no usable replica in the fleet (all ejected or left)", retry_after_s=self.table.retry_hint_s(),
            )
        q_names = list(queries.admitted["genome"])
        disp = [n[len("query:"):] if n.startswith("query:") else n for n in q_names]
        q_bottoms = [np.asarray(queries.results[g]["bottom"], np.uint64) for g in q_names]
        cand = resident.route_candidates(q_bottoms)
        path_of = {os.path.basename(p): p for p in paths}

        # forward what one replica covers, scatter the rest. Queries placed
        # earlier in this batch count as load on their target (`local`):
        # the table's queue_depth refreshes only at probe cadence, and
        # without this every query would tie-break onto one replica
        forward: dict[str, list[int]] = {}
        scatter_ts: list[int] = []
        local: dict[str, int] = {}
        for t in range(len(q_names)):
            targets = self.table.cover_targets(cand[t]) if cand[t] else []
            if targets:
                best = min(
                    enumerate(targets),
                    key=lambda it: (
                        it[1].queue_depth + it[1].inflight + local.get(it[1].address, 0),
                        it[0],  # affinity order breaks load ties
                    ),
                )[1]
                local[best.address] = local.get(best.address, 0) + 1
                forward.setdefault(best.address, []).append(t)
            else:
                scatter_ts.append(t)

        fwd_results: dict[int, dict] = {}
        threads = []
        for addr, ts in forward.items():
            th = threading.Thread(
                target=self._forward_group,
                args=(addr, ts, [path_of[disp[t]] for t in ts], set().union(*(cand[t] for t in ts)), fwd_results,
                      budget_deadline),
                daemon=True, name="drep-route-fwd",
            )
            threads.append(th)
            th.start()
        deadline = time.monotonic() + self._leg_budget_s() + 1.0
        if budget_deadline is not None:
            deadline = min(deadline, budget_deadline + 1.0)
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))

        gen = int(resident.generation)
        for ts in forward.values():
            for t in ts:
                resp = fwd_results.get(t)
                if resp is not None and resp.get("ok") and resp.get("verdict"):
                    if resp.get("generation") != gen:
                        # a forwarded verdict is complete at the generation
                        # that stamped it: honest to return, worth counting
                        self._bump("fence_retries")
                    out[disp[t]] = resp["verdict"]
                    self._bump("forwarded")
                else:
                    scatter_ts.append(t)  # reroute through the merge

        if scatter_ts:
            sub = self._subset_queries(queries, sorted(scatter_ts))
            for v in self._classify_scatter(resident, sub, budget_deadline):
                out[v["genome"]] = v
                self._bump("scattered")
                if v.get("partitions_unavailable"):
                    self._bump("partial_verdicts")
        return out

    def _subset_queries(self, queries, ts: list[int]):
        from drep_tpu_torch.index.classify import SketchedQueries

        return SketchedQueries(admitted=queries.admitted.iloc[ts].reset_index(drop=True), results=queries.results,
                               dropped=[])

    def _classify_scatter(self, fed, queries, budget_deadline=None) -> list[dict]:
        """Scatter the legs, gather them, and run the federated merge with
        the remote results injected; one fence retry when the fleet proves
        ahead. `budget_deadline` (absolute monotonic, or None) bounds every
        leg and the merge's consults: past it, the remaining partitions
        book unavailable and the verdict goes out PARTIAL."""
        from drep_tpu_torch.index.federation import classify_batch_federated

        for attempt in (0, 1):
            gen = int(fed.generation)
            q_names = list(queries.admitted["genome"])
            q_bottoms = [np.asarray(queries.results[g]["bottom"], np.uint64) for g in q_names]
            cand = fed.route_candidates(q_bottoms)
            legs, ahead = self._gather_legs(gen, cand, q_names, q_bottoms, budget_deadline)
            if ahead and attempt == 0:
                self._bump("fence_retries")
                fresh = self._fence_reload()
                if fresh is not None and int(fresh.generation) > gen:
                    fed = fresh
                    continue  # re-route and re-scatter on the new generation
            return classify_batch_federated(
                fed, queries, processes=self.cfg.processes, prune_cfg=self.cfg.prune_cfg, joint=False,
                partition_compare=lambda pid, _names, _bottoms: legs.get(pid),
                consult_check=None if budget_deadline is None else lambda: time.monotonic() < budget_deadline,
            )
        raise AssertionError("unreachable")  # pragma: no cover

    def _leg_budget_s(self) -> float:
        return 2.0 * self.leg_timeout_s + self.hedge_delay_s

    def _gather_legs(self, gen, cand, q_names, q_bottoms, budget_deadline=None):
        """One classify_part leg per candidate partition, all concurrent,
        each rerouted, hedged and deadlined on its own. Returns ({pid: (ui,
        qi, dd)}, whether the fleet is ahead)."""
        pids = sorted(set().union(*cand)) if cand else []
        legs: dict[int, tuple] = {}
        ahead = threading.Event()
        threads = []
        for pid in pids:
            cols = [t for t in range(len(q_names)) if pid in cand[t]]
            names = [q_names[t] for t in cols]
            bottoms = [[int(x) for x in q_bottoms[t]] for t in cols]
            th = threading.Thread(
                target=self._run_leg, args=(pid, gen, names, bottoms, legs, ahead, budget_deadline),
                daemon=True, name=f"drep-route-leg-{pid}",
            )
            threads.append(th)
            th.start()
        # a backstop: each leg bounds itself, and a leg past this merges
        # as unavailable, never a wedge
        deadline = time.monotonic() + self._leg_budget_s() + 1.0
        if budget_deadline is not None:
            deadline = min(deadline, budget_deadline + 1.0)
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        return legs, ahead.is_set()

    def _run_leg(self, pid, gen, names, bottoms, legs, ahead, budget_deadline=None) -> None:
        try:
            faults.fire("router_leg")
            res = self._leg_dispatch(pid, gen, names, bottoms, ahead, budget_deadline)
        except Exception as e:  # noqa: BLE001 — a leg never raises out of the router: PARTIAL instead
            get_logger().warning("route: leg pid=%d failed: %s", pid, e)
            res = None
        if res is None:
            self._bump("leg_failures")
        else:
            legs[pid] = res

    def _leg_dispatch(self, pid, gen, names, bottoms, ahead, budget_deadline=None):
        """One leg's life: affinity-ordered targets, a socket deadline an
        attempt, a straggler hedge to a second capable replica (the first
        answer wins; the return path is a once-latch, so no double merge),
        reroute on failure or refusal, an overall deadline. Returns (ui,
        qi, dd) or None.

        With a batch budget each attempt carries what is left at its own
        launch, the leg's deadline shrinks to the budget, a hedge launches
        only while more than the hedge delay is left, and the losers still
        in flight when one attempt wins are cancelled."""
        deadline = time.monotonic() + self._leg_budget_s()
        if budget_deadline is not None:
            deadline = min(deadline, budget_deadline)
        base = {"op": "classify_part", "pid": int(pid), "generation": int(gen), "names": names, "bottoms": bottoms,
                "prune": self.cfg.prune_cfg}
        results: queue_mod.Queue = queue_mod.Queue()
        on_wire: dict[str, str] = {}  # addr -> the leg id in flight there

        def attempt(addr: str, leg_id: str) -> None:
            self.table.lease(addr)
            try:
                req = dict(base, id=leg_id)
                left = remaining_budget_ms(budget_deadline)
                if left is not None:
                    req["deadline_ms"] = left  # the per-hop decrement
                with ServeClient(addr, timeout_s=self.leg_timeout_s) as c:
                    results.put((addr, c.request(req), None))
            except Exception as e:  # noqa: BLE001 — handled by the loop below
                results.put((addr, None, e))
            finally:
                self.table.release(addr)

        def launch(addr: str) -> None:
            leg_id = f"leg{next(_LEG_SEQ)}-p{pid}"
            on_wire[addr] = leg_id
            threading.Thread(target=attempt, args=(addr, leg_id), daemon=True, name="drep-route-attempt").start()

        def cancel_stragglers() -> None:
            # the consumed attempt left on_wire already: the rest are losers
            for loser, lid in on_wire.items():
                self._cancel_leg(loser, lid)

        tried: list[str] = []
        hedge_addrs: set[str] = set()
        pending = 0
        saw_busy = False

        def next_target() -> str | None:
            for slot in self.table.eligible(pid):
                if slot.address not in tried:
                    return slot.address
            return None

        self._bump("legs_total")
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            if pending == 0:
                addr = next_target()
                if addr is None:
                    break  # every capable replica tried and failed
                if tried:
                    self._bump("reroutes")
                tried.append(addr)
                launch(addr)
                pending += 1
                wait_until = min(deadline, now + self.hedge_delay_s)
            elif pending == 1 and not hedge_addrs:
                # the hedge window passed with the primary still out: a
                # duplicate to a second capable replica, if the budget
                # leaves it time to answer
                addr = None
                if budget_deadline is None or budget_deadline - now > self.hedge_delay_s:
                    addr = next_target()
                if addr is not None:
                    tried.append(addr)
                    hedge_addrs.add(addr)
                    self._bump("hedges")
                    counters.add_fault("router_leg_hedged")
                    launch(addr)
                    pending += 1
                wait_until = deadline
            else:
                wait_until = deadline
            try:
                addr, resp, err = results.get(timeout=max(0.0, wait_until - time.monotonic()))
            except queue_mod.Empty:
                continue  # decide again: hedge, reroute or expire
            pending -= 1
            on_wire.pop(addr, None)
            if err is not None or resp is None:
                self.table.book_failure(addr, err or "empty leg response")
                continue
            if resp.get("ok"):
                self.table.book_success(addr)
                if addr in hedge_addrs:
                    self._bump("hedge_wins")
                cancel_stragglers()
                return (
                    np.asarray(resp.get("ui", ()), np.int64),
                    np.asarray(resp.get("qi", ()), np.int64),
                    np.asarray(resp.get("dist", ()), np.float32),
                )
            reason = resp.get("reason")
            if reason == "generation_mismatch":
                rgen = resp.get("generation")
                if rgen is not None and int(rgen) > gen:
                    ahead.set()  # the batch-level fence retry takes over
                    cancel_stragglers()  # the whole gather scatters again
                    return None
                continue  # this replica is behind: another may be current
            if reason in ("backpressure", "draining"):
                saw_busy = True  # overload: spill, never queue behind it
                continue
            if reason == "partition_unavailable":
                # the replica quarantined this partition; its others are
                # fine, so no failure is booked
                continue
            self.table.book_failure(addr, resp.get("error") or reason or "leg error")
        if saw_busy:
            self._bump("overload_spills")
            counters.add_fault("router_overload_spill")
        return None

    def _cancel_leg(self, addr: str, leg_id: str) -> None:
        """Best-effort cancel of a losing hedge leg, on a fresh short-lived
        connection (the leg's own socket is blocked in its reply wait). The
        replica drops it still queued or discards its result; a failed
        cancel only means the leg runs to waste."""
        self._bump("hedge_cancels")
        counters.add_fault("router_hedge_cancelled")

        def send_cancel() -> None:
            try:
                with ServeClient(addr, timeout_s=min(2.0, self.leg_timeout_s)) as c:
                    c.cancel(leg_id)
            except Exception as e:  # noqa: BLE001 — best effort
                get_logger().debug("route: hedge cancel of %s at %s failed: %s", leg_id, addr, e)

        threading.Thread(target=send_cancel, daemon=True, name="drep-route-cancel").start()

    # ---- the forward path ------------------------------------------------
    def _forward_group(self, addr, ts, paths, pids, results, budget_deadline=None) -> None:
        """Forward whole queries on one pipelined connection (the replica's
        batch window coalesces them) with a leg's reroute and hedge. A
        failure leaves the queries' slots empty and the caller falls back
        to the scatter merge, which degrades by partition instead of by
        query. No cancel here: classify_many owns its request ids."""
        try:
            faults.fire("router_leg")
        except Exception as e:  # noqa: BLE001 — an injected fault: the same contract
            get_logger().warning("route: forward to %s failed: %s", addr, e)
            return
        deadline = time.monotonic() + self._leg_budget_s()
        if budget_deadline is not None:
            deadline = min(deadline, budget_deadline)
        rq: queue_mod.Queue = queue_mod.Queue()

        def attempt(a: str) -> None:
            self.table.lease(a)
            try:
                with ServeClient(a, timeout_s=self.leg_timeout_s) as c:
                    rq.put((a, c.classify_many(paths, deadline_ms=remaining_budget_ms(budget_deadline)), None))
            except Exception as e:  # noqa: BLE001
                rq.put((a, None, e))
            finally:
                self.table.release(a)

        def start(a: str) -> None:
            threading.Thread(target=attempt, args=(a,), daemon=True, name="drep-route-fwd-try").start()

        tried = [addr]
        hedge_addrs: set[str] = set()
        pending = 1
        start(addr)

        def next_target() -> str | None:
            for slot in self.table.cover_targets(pids):
                if slot.address not in tried:
                    return slot.address
            return None

        while True:
            now = time.monotonic()
            if now >= deadline:
                return
            if pending == 0:
                nxt = next_target()
                if nxt is None:
                    return
                self._bump("reroutes")
                tried.append(nxt)
                start(nxt)
                pending += 1
                wait_until = min(deadline, now + self.hedge_delay_s)
            elif pending == 1 and not hedge_addrs:
                nxt = None
                if budget_deadline is None or budget_deadline - now > self.hedge_delay_s:
                    nxt = next_target()
                if nxt is not None:
                    tried.append(nxt)
                    hedge_addrs.add(nxt)
                    self._bump("hedges")
                    counters.add_fault("router_leg_hedged")
                    start(nxt)
                    pending += 1
                wait_until = deadline
            else:
                wait_until = deadline
            try:
                a, resps, err = rq.get(timeout=max(0.0, wait_until - time.monotonic()))
            except queue_mod.Empty:
                continue
            pending -= 1
            if err is not None or resps is None:
                self.table.book_failure(a, err or "empty forward response")
                self._bump("leg_failures")
                continue
            self.table.book_success(a)
            if a in hedge_addrs:
                self._bump("hedge_wins")
            # a once-latch: the first complete group wins, a later loser
            # finds the results set and is discarded
            for t, resp in zip(ts, resps):
                if t not in results:
                    results[t] = resp
            return

    # ---- the sketch cache ------------------------------------------------
    def _sketch_key(self, path: str) -> tuple | None:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (os.path.abspath(path), st.st_size, st.st_mtime_ns)

    def _sketch_batch(self, resident, paths: list[str]):
        """sketch_queries with an LRU by (path, size, mtime): a hot set is
        sketched once at the router, so the forward path adds routing, not
        sketching, to the replica's work. The admission rule is applied
        each batch from the pinned params; only the sketch is reused."""
        import pandas as pd

        from drep_tpu_torch.index.classify import SketchedQueries, sketch_queries

        basenames = [os.path.basename(p) for p in paths]
        if len(set(basenames)) != len(basenames):
            # the batcher never co-batches basename colliders; stay
            # correct if a caller bypasses it
            return sketch_queries(resident, paths, processes=self.cfg.processes)
        cached: dict[str, dict] = {}
        misses: list[str] = []
        keys = {p: self._sketch_key(p) for p in paths}
        with self._sketch_lock:
            for p in paths:
                ent = self._sketch_cache.get(keys[p]) if keys[p] else None
                if ent is None:
                    misses.append(p)
                else:
                    self._sketch_cache.move_to_end(keys[p])
                    cached[p] = ent
        if misses:
            sq = sketch_queries(resident, misses, processes=self.cfg.processes)
            with self._sketch_lock:
                for p in misses:
                    r = sq.results.get(f"query:{os.path.basename(p)}")
                    if r is None:
                        continue  # pragma: no cover — sketch_paths raises instead
                    cached[p] = r
                    if keys[p] is not None:
                        self._sketch_cache[keys[p]] = r
                while len(self._sketch_cache) > _SKETCH_CACHE_CAP:
                    self._sketch_cache.popitem(last=False)
        min_len = int(resident.params.get("filter_length", 0))
        gen = int(resident.generation)
        rows: dict[str, list] = {"genome": [], "location": []}
        results: dict[str, dict] = {}
        dropped: list[dict] = []
        for p in paths:
            base = os.path.basename(p)
            qn = f"query:{base}"
            r = cached[p]
            results[qn] = r
            if int(r["length"]) >= min_len:
                rows["genome"].append(qn)
                rows["location"].append(os.path.abspath(p))
            else:
                dropped.append({
                    "genome": base, "filtered": True,
                    "reason": f"below the index's filter length {min_len}",
                    "generation": gen,
                })
        return SketchedQueries(admitted=pd.DataFrame(rows), results=results, dropped=dropped)
