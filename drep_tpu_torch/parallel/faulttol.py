"""Fault-tolerant launches and the elastic pod.

Counterpart of drep_tpu/parallel/faulttol.py:

- :func:`retrying_call`, one bounded retry loop with exponential backoff
  and an optional per-attempt watchdog. It runs each streaming stripe
  (parallel/streaming.py, fault site ``streaming_tile``) and each
  secondary engine call (cluster/controller.py, ``secondary_batch``).
  The port's stripe launch is synchronous (``ops/mash.py::
  stripe_survivors`` returns host arrays), so the watchdog bounds the
  launch and its copy back, not only a wait after it. When the attempts
  are spent it raises :class:`FaultTolError`: nothing recomputes the
  work on the host (the JAX package's CPU fallback is not ported, by the
  rule that nothing falls back to a plain version). Every call it wraps
  is process-local, so a retry on a pod never desyncs the members.
- :class:`AutoTimeout`, the watchdog deadline derived from the run's own
  launch latencies (k x rolling median, warmup excluded, floored); the
  streaming walk keeps one for its stripes, the dense ring one for its
  steps.
- :class:`TileExecutor`, the dense ring's per-block redoable unit: a
  block runs on the next of this process's positions round robin, under
  the watchdog; a failure retries with backoff on another position, a
  position that fails ``quarantine_after`` times in a row is benched, and
  a block whose retries are spent raises FaultTolError (no CPU fallback).
- the elastic pod, file-based over the shared checkpoint directory, in
  the JAX package's note names and JSON so that either package's notes
  read in the other: :class:`HeartbeatManager` (beat, done, death
  verdict, drain, join and admit notes ``.pod-<kind>.p<id>``; death after
  ``HEARTBEAT_MISS_FACTOR`` x ``DREP_TORCH_HEARTBEAT_S`` of staleness,
  confirmed across a cadence), the process-global pod state
  (:func:`pod_epoch`, :func:`pod_live`, ... ) that later barriers route
  over, :func:`join_elastic_pod` (a new process started with
  ``DREP_TORCH_POD_JOIN`` asks admission), graceful drain
  (:func:`request_drain`, :func:`install_drain_handler`,
  :class:`PodDrained`: the member finishes its work unit, publishes a
  planned-departure note and exits 0), :func:`wait_elastic` (a bounded
  wait that consults the heartbeats and abandons the wait when the
  membership changes) and :func:`run_with_timeout` (a watchdog for the
  pod's gloo collectives: a dead peer is an actionable
  :class:`CollectiveTimeout`, not a hang).

A CUDA error is sticky. After a launch fails with an error such as
``cudaErrorIllegalAddress`` the context is lost, every retry on the same
card fails again, and the run raises FaultTolError after
``--fault_retries`` attempts. A kernel that really hangs is the same: the
retry queues behind the hung launch on the card and trips the watchdog
again. Either way the run fails fast where it would have hung, and a
rerun resumes from the checkpoints. The retries pay off for transient
host-side failures (a failed allocation, a filesystem hiccup inside the
call, an injected fault).

Every event is counted in utils/profiling's counters (``retries``,
``watchdog_trips``, ``quarantined_devices``, ``dead_processes``,
``pod_epoch_bumps``, ``planned_departures``, ``pod_joins``, ...), each
ownership-epoch bump in its epoch history, and with tracing on the
verdicts are instants (``fenced``, ``death_verdict``, ``drain_announce``,
``drain_adopted``, ``join_admitted``/``join_adopted``, ``joined``,
``done``), as in the JAX package. Fault injection fires inside the
watched regions, so an injected hang trips the same watchdog a real one
does.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from drep_tpu_torch.utils import envknobs, faults, telemetry
from drep_tpu_torch.utils.logger import get_logger

# the pod's collective watchdog (s); 0 disables; the env knob overrides
# both defaults when set. The barrier at a stage's start sees skew of
# seconds; the edge allgather at its end waits out its peers' remaining
# stripes, so its default sits above any plausible stage.
COLLECTIVE_TIMEOUT_ENV = "DREP_TORCH_COLLECTIVE_TIMEOUT_S"
DEFAULT_COLLECTIVE_TIMEOUT_S = float(envknobs.knob(COLLECTIVE_TIMEOUT_ENV).default)
DEFAULT_ALLGATHER_TIMEOUT_S = 6 * 3600.0


def collective_timeout_s(default: float = DEFAULT_COLLECTIVE_TIMEOUT_S) -> float:
    return envknobs.env_float(COLLECTIVE_TIMEOUT_ENV, default=default)


# per-process heartbeat cadence (s) of the elastic pod; 0 disables the
# protocol (a dead member then aborts at the collective timeout). Death
# is diagnosed at HEARTBEAT_MISS_FACTOR x the cadence.
HEARTBEAT_ENV = "DREP_TORCH_HEARTBEAT_S"
DEFAULT_HEARTBEAT_S = float(envknobs.knob(HEARTBEAT_ENV).default)
HEARTBEAT_MISS_FACTOR = 5.0


def heartbeat_cadence_s() -> float:
    return envknobs.env_float(HEARTBEAT_ENV)


# mid-run join request, set on a NEW process started against a running
# pod's checkpoint dir: "auto" derives the join id from the notes in the
# store, an integer pins it (>= the pod's original process count)
POD_JOIN_ENV = "DREP_TORCH_POD_JOIN"
AUTOSCALE_SPAWNED_ENV = "DREP_TORCH_AUTOSCALE_SPAWNED"


def join_requested() -> str | None:
    """The requested join mode: None (not a joiner), "auto", or an
    explicit id string."""
    v = envknobs.env_str(POD_JOIN_ENV).strip()
    return v or None


class FaultTolError(RuntimeError):
    """A launch failed beyond the retry budget."""


class PodDrained(Exception):
    """This process was asked to drain (SIGTERM, or the ``drain`` fault
    mode) and has published its planned-departure note: the caller exits
    0. Not a FaultTolError: nothing may retry a drain."""


class WatchdogTimeout(FaultTolError):
    """One launch outlasted the per-launch watchdog."""


class CollectiveTimeout(FaultTolError):
    """A pod collective did not complete within its timeout: almost
    always a dead or wedged peer process."""


@dataclass(frozen=True)
class FaultTolConfig:
    """Knobs of the retries and the pod (CLI: --fault_retries,
    --dispatch_timeout, --max_dead_processes, --max_joins)."""

    max_retries: int = 2  # attempts after the first failure
    dispatch_timeout_s: float = 0.0  # per-launch watchdog; 0 = auto or off
    # dispatch_timeout_s == 0 with auto_timeout derives the watchdog from
    # the run's own launch latencies; a positive dispatch_timeout_s always
    # governs. Off in the library default (a bare call runs no watchdog
    # thread); the CLI's controller turns it on.
    auto_timeout: bool = False
    backoff_s: float = 0.05  # first retry delay, doubled an attempt
    quarantine_after: int = 3  # consecutive failures that bench a ring position
    # pod-member deaths tolerated a run before the pod aborts
    max_dead_processes: int = 1
    # mid-run join admissions the pod's leader accepts a stage (0 refuses)
    max_joins: int = 0


# the auto-derived watchdog: k x the rolling median wait, the first waits
# excluded as warmup, floored so that ~0 ms waits cannot derive a
# hair-trigger; before enough samples the cap bounds an early hang
AUTO_TIMEOUT_MULT = 20.0
AUTO_TIMEOUT_FLOOR_S = 30.0
AUTO_TIMEOUT_WARMUP = 8
AUTO_TIMEOUT_MIN_SAMPLES = 4
AUTO_TIMEOUT_WARMUP_CAP_S = 300.0


class AutoTimeout:
    """The auto-derived per-launch watchdog deadline: k x the rolling
    median of the caller's own wait latencies, the first `warmup` waits
    excluded, floored at ``AUTO_TIMEOUT_FLOOR_S``, and the warmup cap
    until enough samples exist. A positive ``dispatch_timeout_s`` governs;
    auto off means no watchdog (0.0)."""

    def __init__(self, config: FaultTolConfig, warmup: int = AUTO_TIMEOUT_WARMUP) -> None:
        self.config = config
        self.warmup = warmup
        self._waits: deque[float] = deque(maxlen=64)
        self._n_waits = 0

    def note(self, dt: float) -> None:
        self._n_waits += 1
        if self._n_waits > self.warmup:
            self._waits.append(dt)

    def effective(self) -> float:
        if self.config.dispatch_timeout_s > 0:
            return self.config.dispatch_timeout_s
        if not self.config.auto_timeout:
            return 0.0
        if len(self._waits) < AUTO_TIMEOUT_MIN_SAMPLES:
            return AUTO_TIMEOUT_WARMUP_CAP_S
        return max(AUTO_TIMEOUT_MULT * statistics.median(self._waits), AUTO_TIMEOUT_FLOOR_S)

    def derived(self) -> float | None:
        """The derived deadline, or None where an explicit value governs,
        auto is off, or the samples are still too few (the cap is a bound,
        not a derivation)."""
        if self.config.dispatch_timeout_s > 0 or not self.config.auto_timeout:
            return None
        if len(self._waits) < AUTO_TIMEOUT_MIN_SAMPLES:
            return None
        return self.effective()


# the process-wide default, installed once a run by the cluster
# controller from the CLI flags; callers without a config read it
DEFAULT_CONFIG = FaultTolConfig()


def configure_defaults(config: FaultTolConfig) -> None:
    global DEFAULT_CONFIG
    DEFAULT_CONFIG = config


# -- graceful drain (planned departure) -----------------------------------
#
# A drain REQUEST is process-global (one flag, set by the SIGTERM handler
# or the chaos fault mode) and CONSUMED at the elastic loops' safe
# boundaries: the member finishes its in-flight stripe/ring step,
# publishes a planned-departure note, and raises PodDrained so the caller
# exits 0. The flag deliberately outlives any one stage — a preemption
# notice that lands between stages must still drain the next one.

_DRAIN_EVENT = threading.Event()


def request_drain() -> None:
    """Flag this process for graceful departure at the next safe
    boundary (idempotent)."""
    if not _DRAIN_EVENT.is_set():
        get_logger().warning(
            "elastic pod: drain requested — this process will finish its "
            "in-flight work unit, publish a planned-departure note, and "
            "exit 0"
        )
    _DRAIN_EVENT.set()


def drain_requested() -> bool:
    return _DRAIN_EVENT.is_set()


def clear_drain() -> None:
    """Reset the drain flag (tests; a long-lived service re-arming)."""
    _DRAIN_EVENT.clear()


def _drain_force_exit(grace_s: float) -> None:
    """Grace-expiry fallback: the drain request was never consumed (no
    elastic stage running, or the in-flight dispatch is wedged) — publish
    the departure note best-effort and exit 0 anyway. Preemption gives no
    extension; an exit-0 with the note beats a SIGKILL with nothing."""
    time.sleep(max(0.0, grace_s))
    if not _DRAIN_EVENT.is_set():
        return  # cleared before expiry (a test, or a service re-arming)
    hb = current_heartbeat()
    if hb is not None:
        import contextlib

        with contextlib.suppress(Exception):
            hb.announce_drain()
    get_logger().warning(
        "elastic pod: drain grace (%.1fs) expired with the request "
        "unconsumed — exiting 0 now (shard-level checkpoints keep the "
        "finished work)", grace_s,
    )
    os._exit(0)


def install_drain_handler(grace_s: float) -> bool:
    """Wire SIGTERM to the graceful-drain protocol: the handler sets the
    drain flag (consumed at the next stripe/ring-step boundary) and arms
    a grace timer that force-exits 0 if nothing consumes it within
    `grace_s` (CLI: --drain_grace_s). Returns False when the handler
    cannot be installed (non-main thread — library embeddings keep their
    own signal policy)."""
    import signal

    def _on_term(signum, frame):  # noqa: ARG001 — signal signature
        request_drain()
        threading.Thread(
            target=_drain_force_exit, args=(float(grace_s),),
            daemon=True, name="drep-drain-grace",
        ).start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread
        return False
    return True


# -- elastic pod state ----------------------------------------------------
#
# Process-global because it outlives the streaming stage that discovers a
# death: the controller's SECONDARY loop (and any later checkpoint-store
# open) must route its barriers over the survivor set, or the first
# full-pod collective after the bump would hang on the dead member until
# the collective timeout — exactly the abort the epoch protocol removes.
# Reset at the start of every heartbeat-managed stage (HeartbeatManager
# .start), so one process can run several pods' worth of work sequentially.

_POD = {
    "epoch": 0, "live": None, "dead": [], "drained": [], "joined": [],
    "t0": 0.0,
}


def pod_epoch() -> int:
    """Current ownership epoch (0 = healthy, never bumped)."""
    return _POD["epoch"]


def pod_live() -> list[int] | None:
    """The live-process list once degraded, else None (healthy: everyone).
    ORIGINAL members only: joiners are stage-scoped capacity and never
    appear here — a later stage's barrier must not wait on a process that
    only ever participated in one stripe loop."""
    return _POD["live"]


def pod_dead() -> list[int]:
    return list(_POD["dead"])


def pod_drained() -> list[int]:
    """Members that left via a planned departure (drain note) — gone like
    the dead for downstream routing, but never counted against
    --max_dead_processes."""
    return list(_POD["drained"])


def pod_joined() -> list[int]:
    """Join ids admitted during this run (accounting/provenance only —
    joiners never enter the downstream live view)."""
    return list(_POD["joined"])


def pod_t0() -> float:
    """Wall time the current heartbeat-managed stage began — file-based
    degraded barriers reject notes older than this (a crashed-then-
    restarted pod must never trust a previous run's sentinel)."""
    return _POD["t0"]


def reset_pod(t0: float | None = None) -> None:
    _POD.update(
        epoch=0, live=None, dead=[], drained=[], joined=[],
        t0=(t0 if t0 is not None else 0.0),
    )


def mark_pod_degraded(
    epoch: int,
    live: list[int],
    dead: list[int],
    drained: list[int] | None = None,
    joined: list[int] | None = None,
) -> None:
    _POD.update(epoch=int(epoch), live=list(live), dead=list(dead))
    if drained is not None:
        _POD["drained"] = list(drained)
    if joined is not None:
        _POD["joined"] = list(joined)


def mark_pod_joined(joined: list[int]) -> None:
    """Record admitted joiners WITHOUT degrading the downstream view: a
    pure-join stage (no deaths, no drains) leaves the original pod whole,
    so later barriers keep the healthy gloo collective path — only the
    provenance/bench stamping needs to know capacity was grafted in."""
    _POD["joined"] = list(joined)


# the heartbeat manager of the CURRENTLY running heartbeat-managed stage
# (set by HeartbeatManager.start, cleared by close). Registered process-
# globally so code that cannot thread the manager — the stage-open barrier
# in utils/ckptmeta.py — can still consult peer liveness while it waits:
# a peer that dies BEFORE ever reaching the barrier is diagnosed from its
# missing/stale heartbeat note and, within max_dead, the survivors
# continue degraded instead of raising at the collective timeout.
_CURRENT_HB: "HeartbeatManager | None" = None


def current_heartbeat() -> "HeartbeatManager | None":
    return _CURRENT_HB


def read_pod_note(path: str, what: str = "pod note") -> dict | None:
    """THE checked JSON membership-note read (done/dead/drain/join/admit
    notes, ring store meta): transient I/O errors retry, corrupt or
    non-dict payloads read as ABSENT — a half-written note must never
    crash a liveness scan (one implementation so the corruption contract
    cannot drift across the protocol's consumers)."""
    from drep_tpu_torch.utils import durableio

    try:
        note = durableio.read_json_checked(path, what=what)
        return note if isinstance(note, dict) else None
    except (OSError, ValueError, durableio.CorruptPayloadError):
        return None


# per-(note_dir) count of heartbeat-managed stages THIS process has run —
# the call-sequence scope of done-notes. Replicated control flow means
# every pod member reaches the same count for the same store, so sequence
# k on one process pairs with sequence k on every other (the same
# invariant _BARRIER_SEQ in utils/ckptmeta.py relies on). A RESTARTED
# process starts over at 1, which is exactly how its stale on-disk notes
# (seq >= 1 from the previous incarnation) are recognized and cleared.
_HB_SEQ: dict[str, int] = {}


class HeartbeatManager:
    """Per-process liveness + ownership-epoch bookkeeping over a shared
    checkpoint directory (the elastic-pod protocol's ground truth).

    Lifecycle (driven by parallel/streaming.py):

    - ``start()`` — bump this store's call sequence, clear THIS process's
      done-note from a PREVIOUS incarnation (payload seq >= the fresh
      seq — a crashed-then-restarted pod must never diagnose or trust a
      previous run's state), write the first beat, and launch the daemon
      beat writer. Must run BEFORE the stage-open barrier so every peer's
      cleanup is ordered before anyone starts monitoring. A done-note
      from this process's OWN earlier call (payload seq < the fresh seq)
      is deliberately KEPT: a peer may still be consuming it in the
      previous call's completion wait, and deleting it there deadlocks
      the pod (observed); the note is overwritten at this call's own
      ``mark_done``, which cannot happen before every peer has left the
      previous call (the stage-open barrier orders it).
    - ``check()`` — time-gated peer scan: a peer whose beat file went
      stale (``HEARTBEAT_MISS_FACTOR`` x cadence) with no current
      done-note is declared dead; the epoch bumps, the module pod state
      is published (so downstream barriers route over the survivors),
      and honest counters land (``dead_processes``, ``pod_epoch_bumps``).
      Raises :class:`FaultTolError` past ``max_dead`` deaths.
    - ``mark_done(pairs)`` — publish this process's done-note (its honest
      ``pairs_computed`` rides along for the survivor-set total, stamped
      with the call sequence). A peer whose done-note carries seq >= ours
      finished OUR call (possibly racing ahead into the next) and is
      never declared dead, however stale its beat.
    - ``close()`` — stop the beat writer and remove the own beat file.
      The done-note stays (peers may still be polling it).

    Correctness never depends on peers agreeing on the epoch at the same
    instant: shard writes are atomic and idempotent (identical bytes from
    any process), so a transient live-list disagreement costs at most a
    duplicated stripe computation.
    """

    def __init__(
        self,
        note_dir: str,
        cadence: float,
        max_dead: int = 1,
        pc: int | None = None,
        pid: int | None = None,
        max_joins: int = 0,
    ) -> None:
        if pc is None or pid is None:
            from drep_tpu_torch.parallel.mesh import process_count, process_index

            pc = process_count() if pc is None else pc
            pid = process_index() if pid is None else pid
        self.note_dir = note_dir
        self.cadence = float(cadence)
        self.max_dead = int(max_dead)
        self.max_joins = int(max_joins)
        self.pc, self.pid = int(pc), int(pid)
        self.miss_s = max(HEARTBEAT_MISS_FACTOR * self.cadence, 1.0)
        self.live = list(range(self.pc))
        self.dead: list[int] = []
        # planned departures (drain notes adopted) — out of `live`, never
        # counted against max_dead; and join admissions (ids >= pc) —
        # IN `live` for this stage's dealing, invisible downstream
        self.drained: list[int] = []
        self.joined: list[int] = []
        self._adopted_admits: set[int] = set()
        self._join_budget_logged = False
        self.epoch = 0
        self.seq = 0  # call sequence for this store, set by start()
        self._beat_seq = 0
        # wall-clock stage start: published as pod_t0() and compared
        # against note MTIMES (server clock) by the file barrier — its
        # monotonic twin below anchors purely-local elapsed windows
        self._started_at = 0.0
        self._started_mono = 0.0
        self._last_check = 0.0  # monotonic: cadence gate for maybe_check
        # pid -> monotonic time the peer FIRST looked stale: a death
        # verdict needs staleness confirmed across a full cadence, so one
        # transient failed stat (NFS rename window, ESTALE) can never
        # fence a healthy member
        self._suspect: dict[int, float] = {}
        # pid -> wall time the peer's beat FIRST became unreadable: a
        # failed stat only counts as staleness after it persists for the
        # full miss window (a brief shared-FS outage makes EVERY beat
        # unreadable on every process at once — that must heal, not
        # trigger mutual fencing)
        self._unreadable: dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- note paths (dot-prefixed, process-suffixed: shard-store resume
    # globs and clear_suffixes scans never see them — the same namespace
    # rule as ckptmeta's barrier sentinels)
    def _note(self, kind: str, pid: int) -> str:
        return os.path.join(self.note_dir, f".pod-{kind}.p{pid}")

    def beat_path(self, pid: int | None = None) -> str:
        return self._note("hb", self.pid if pid is None else pid)

    def done_path(self, pid: int | None = None) -> str:
        return self._note("done", self.pid if pid is None else pid)

    def verdict_path(self, pid: int) -> str:
        """Death-verdict note NAMING `pid` (written by whichever survivor
        detected the staleness first). Verdicts make the live view
        CONVERGE: every peer adopts a published verdict instead of
        re-deriving liveness from its own (possibly skewed) view of the
        beat mtimes, and a process that finds a verdict naming ITSELF is
        fenced — it aborts rather than continue as a zombie the rest of
        the pod has already re-dealt around."""
        return self._note("dead", pid)

    def drain_path(self, pid: int | None = None) -> str:
        """Planned-departure note (the drain verdict class): written by
        the DEPARTING member itself at a safe boundary, adopted by every
        peer with no staleness wait — and immunizing the member against a
        later death verdict exactly like a done-note (its beats going
        stale after the drain is the EXPECTED ending, not a second
        failure)."""
        return self._note("drain", self.pid if pid is None else pid)

    def join_path(self, pid: int) -> str:
        """Join-request note published by a NEW process asking admission
        (:func:`join_elastic_pod`)."""
        return self._note("join", pid)

    def admit_path(self, pid: int) -> str:
        """Admission verdict NAMING joiner `pid`, written by the
        lowest-live leader: carries the grown live set, the pod's
        original process count (the canonical epoch-0 geometry the joiner
        cannot otherwise know), and the stage sequence the joiner must
        adopt."""
        return self._note("admit", pid)

    def _beat(self) -> None:
        from drep_tpu_torch.utils.durableio import atomic_write_bytes

        self._beat_seq += 1
        atomic_write_bytes(self.beat_path(), str(self._beat_seq).encode())

    def start(self) -> None:
        import contextlib

        os.makedirs(self.note_dir, exist_ok=True)
        key = os.path.abspath(self.note_dir)
        self.seq = _HB_SEQ[key] = _HB_SEQ.get(key, 0) + 1
        # a done-note with seq >= our fresh sequence can only be a leftover
        # from a previous incarnation of this process (ours count up from
        # here) — clear it BEFORE the stage-open barrier, so no peer's
        # post-barrier monitoring can ever read previous-run state. Lower
        # sequences are our own earlier calls' notes: kept (see class doc).
        stale = self.read_done(self.pid)
        if stale is None or int(stale.get("seq", 0)) >= self.seq:
            with contextlib.suppress(OSError):
                os.remove(self.done_path())
        # a verdict naming THIS process can only be a previous
        # incarnation's (current-run verdicts are written post-barrier,
        # and this cleanup is ordered pre-barrier): a restarted pod must
        # not self-fence on the previous run's death
        with contextlib.suppress(OSError):
            os.remove(self.verdict_path(self.pid))
        # same lifecycle for the membership-churn notes naming THIS id: a
        # drained-then-restarted member must not be re-adopted as
        # departing, and a stale join request must not re-admit an id
        # that is now a first-class member. Admit notes are NOT cleaned
        # here — a joiner starts its manager while peers may still be
        # adopting the note that admitted it (later stages reject old
        # admits by their seq stamp instead).
        for stale_note in (self.drain_path(), self.join_path(self.pid)):
            with contextlib.suppress(OSError):
                os.remove(stale_note)
        # own stale degraded-barrier sentinels likewise predate this
        # stage: a restarted degraded pod must not satisfy a file barrier
        # with a previous incarnation's note. Safe against peers still
        # polling an EARLIER barrier of this run: _file_barrier counts a
        # note once seen, and a process only removes its notes after
        # passing (it reaches this cleanup only via later stages).
        import glob

        for note in glob.glob(
            os.path.join(self.note_dir, f".barrier-*.p{self.pid}")
        ):
            with contextlib.suppress(OSError):
                os.remove(note)
        # wall by design: pod_t0() gates barrier-note freshness against
        # file mtimes (server clock), never elapsed-time math
        self._started_at = time.time()  # drep-lint: allow[clock-mono] — pod_t0 is compared against note mtimes (server clock)
        self._started_mono = time.monotonic()
        prev_live = pod_live()
        if prev_live is not None:
            # the pod already lost members in an earlier stage of this
            # process's run: a new heartbeat-managed stage must keep the
            # survivor view (resetting to the full pod would re-route its
            # barriers over the corpse) — only the freshness epoch resets
            self.live = [p for p in prev_live if p < self.pc]
            self.dead = [p for p in pod_dead() if p < self.pc]
            # drained members are as gone as the dead for this stage's
            # dealing — but restored into their OWN list so the new
            # stage's death budget never re-counts a planned departure
            self.drained = [p for p in pod_drained() if p < self.pc]
            self.epoch = pod_epoch()
            _POD["t0"] = self._started_at
        else:
            reset_pod(t0=self._started_at)
        self._beat()
        global _CURRENT_HB
        _CURRENT_HB = self
        if self.cadence > 0:
            self._thread = threading.Thread(
                target=self._beat_loop, daemon=True, name="drep-heartbeat"
            )
            self._thread.start()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.cadence):
            try:
                self._beat()
            except OSError:  # a flaky write must not kill the writer —
                pass  # one missed beat is well inside the miss window

    def read_done(self, pid: int) -> dict | None:
        """Raw done-note payload, no sequence validation. Checked read
        (utils/durableio.py): transient I/O errors retry, a corrupt note
        (truncated / crc mismatch) reads as ABSENT — the peer then counts
        as not-finished and its heartbeat staleness decides, never a
        crash on a half-written note."""
        from drep_tpu_torch.utils import durableio

        try:
            note = durableio.read_json_checked(self.done_path(pid), what="done-note")
            return note if isinstance(note, dict) else None
        except (OSError, ValueError, durableio.CorruptPayloadError):
            return None

    def done_payload(self, pid: int) -> dict | None:
        """The peer's done-note IF it covers the current call (payload
        seq >= ours — a racing peer's next-call overwrite still implies it
        finished this one). Older notes are a previous call's state."""
        note = self.read_done(pid)
        if note is not None and int(note.get("seq", 0)) >= self.seq:
            return note
        return None

    def peer_finished(self, pid: int) -> bool:
        return self.done_payload(pid) is not None

    def maybe_check(self) -> bool:
        """Time-gated :meth:`check` (at most once per cadence) — cheap
        enough to call per stripe."""
        if time.monotonic() - self._last_check < self.cadence:
            return False
        return self.check()

    def check(self) -> bool:
        """Scan peer membership + liveness; returns True when the epoch
        bumped (any membership change: drain, join, or death — the
        caller's cue to re-deal under the CURRENT live set).

        Verdict ordering matters: planned departures (drain notes) are
        adopted FIRST — a drained member's beats going stale is its
        expected ending, and judging staleness before the drain scan
        could double-count the departure as a death against
        ``max_dead``. Join admissions come second (the leader admits, the
        rest adopt the published admit note). Published death verdicts
        are adopted BEFORE any local staleness judgment, so the survivor
        view converges pod-wide even when one process's view of the beat
        mtimes is skewed (NFS attribute caching): whoever detects first
        publishes, everyone else follows, and the subject — if actually
        alive — fences itself."""
        from drep_tpu_torch.utils.profiling import counters

        # two clocks, deliberately: `now` (wall) is compared against note
        # MTIMES stamped by the shared filesystem's server clock (drain
        # latency, join-admission freshness, the own-beat ref fallback);
        # `mono` anchors purely-local elapsed windows (cadence gate,
        # unreadable-beat and suspect confirmation, startup grace), which
        # an NTP step must never stretch or collapse
        now = time.time()  # drep-lint: allow[clock-mono] — compared against note mtimes (server clock)
        mono = time.monotonic()
        self._last_check = mono
        if os.path.exists(self.verdict_path(self.pid)):
            telemetry.event("fenced", pid=self.pid)
            raise FaultTolError(
                f"elastic pod: a peer declared process {self.pid} dead (its "
                f"view of this process's heartbeat went stale) and the pod "
                f"has re-dealt its stripes — fencing this process rather "
                f"than continuing as a zombie. Restart the pod member."
            )
        # ONE directory scan feeds both membership passes — the drain
        # exists-checks and the join/admit globs would otherwise add
        # per-peer stat + readdir traffic to every cadence tick on the
        # very shared FS this protocol defends (None = transient listdir
        # failure: the passes fall back to direct reads)
        try:
            names: set[str] | None = set(os.listdir(self.note_dir))
        except OSError:
            names = None
        bumped = self._check_drains(now, names)
        bumped = self._check_joins(now, names) or bumped
        newly: list[int] = []
        adopted: list[int] = []
        # staleness is judged SERVER-clock-to-server-clock: our own beat
        # file's mtime (at most one cadence old, stamped by the same
        # filesystem) is the reference, so a constant NFS-server vs host
        # clock skew can never fake a death — the local-clock fallback
        # only covers an unreadable own beat
        try:
            ref = os.stat(self.beat_path()).st_mtime
        except OSError:
            ref = now
        for p in self.live:
            if p == self.pid:
                continue
            if os.path.exists(self.verdict_path(p)):
                newly.append(p)  # adopt a peer's published verdict
                adopted.append(p)
                continue
            if self.peer_finished(p):
                continue
            try:
                stale = ref - os.stat(self.beat_path(p)).st_mtime > self.miss_s
                self._unreadable.pop(p, None)
            except OSError:
                # no readable beat: a transient stat failure, a concurrent
                # clear, or a very early death. Stale only once the beat
                # has been unreadable for the full miss window AND the
                # stage is past its startup grace (the stage-open barrier
                # ordered every peer's first beat before monitoring began)
                first_bad = self._unreadable.setdefault(p, mono)
                stale = (
                    mono - first_bad > self.miss_s
                    and mono - self._started_mono > self.miss_s
                )
            if not stale:
                self._suspect.pop(p, None)
                continue
            # confirm across a full cadence before the irreversible
            # verdict — a single bad observation must heal, not fence
            first = self._suspect.setdefault(p, mono)
            if mono - first >= max(self.cadence, 0.2):
                newly.append(p)
        if not newly:
            return bumped
        if len(self.dead) + len(newly) > self.max_dead:
            raise FaultTolError(
                f"elastic pod: process(es) {newly} stopped heartbeating, but "
                f"{len(self.dead)} death(s) were already tolerated and "
                f"--max_dead_processes is {self.max_dead} — aborting; restart "
                f"the pod (shard-level checkpoints resume finished work)"
            )
        for p in newly:
            if p in adopted:
                continue
            # publish the verdict so every peer adopts THIS view (and the
            # subject fences itself if it was a false positive)
            try:
                from drep_tpu_torch.utils.durableio import atomic_write_json

                atomic_write_json(
                    self.verdict_path(p),
                    {"by": self.pid, "seq": self.seq, "at": now},
                )
            except OSError:  # best-effort: peers can still detect on
                pass  # their own staleness clock
        # the heartbeat verdict instant: WHO was declared dead and whether
        # this process published the verdict or adopted a peer's (the
        # epoch instant that follows carries the bump itself)
        telemetry.event(
            "death_verdict",
            peers=newly,
            adopted=sorted(adopted),
            by=self.pid,
        )
        self.dead.extend(newly)
        self.live = [p for p in self.live if p not in newly]
        self.epoch += 1
        counters.add_fault("dead_processes", len(newly))
        counters.add_fault("pod_epoch_bumps")
        counters.note_epoch(self.epoch, "death")
        self._publish_pod_state()
        get_logger().warning(
            "elastic pod: process(es) %s stopped heartbeating (> %.1fs stale) "
            "— bumping ownership epoch to %d and re-dealing their unfinished "
            "stripes across survivors %s",
            newly, self.miss_s, self.epoch, self.live,
        )
        return True

    def _note_json(self, path: str) -> dict | None:
        return read_pod_note(path)

    def drain_payload(self, pid: int) -> dict | None:
        """The peer's planned-departure note IF it covers the current
        call (seq-gated exactly like done-notes — a previous stage's
        drain must never depart a restarted member)."""
        note = self._note_json(self.drain_path(pid))
        if note is not None and int(note.get("seq", 0)) >= self.seq:
            return note
        return None

    def all_members(self) -> list[int]:
        """Every id that ever held membership this stage: the original
        pod plus admitted joiners — the set whose done/drain notes the
        honest pairs accounting must sum over."""
        return sorted(set(range(self.pc)) | set(self.joined))

    def announce_drain(self, pairs: int = 0) -> None:
        """Publish this process's planned-departure note (called at a
        safe boundary, after the in-flight work unit's shard is durable).
        `pairs` rides along so the survivor-set totals stay honest about
        what the departing member actually computed."""
        from drep_tpu_torch.utils.durableio import atomic_write_json
        from drep_tpu_torch.utils.profiling import counters

        note = {
            "seq": self.seq, "epoch": self.epoch,
            # drep-lint: allow[clock-mono] — cross-host note timestamp (read by pod_status/forensics)
            "pairs": int(pairs), "at": time.time(),
        }
        if envknobs.env_bool(AUTOSCALE_SPAWNED_ENV):
            # controller-governed capacity departing: peers adopting this
            # note book autoscale_churn, so bench records of the governed
            # run refuse as measured perf (tools/missing_stages.py)
            note["autoscale"] = True
        atomic_write_json(self.drain_path(), note)
        counters.add_fault("drain_announced")
        telemetry.event("drain_announce", pid=self.pid, pairs=int(pairs))
        get_logger().warning(
            "elastic pod: process %d published its planned-departure note "
            "(epoch %d) and is exiting 0 — peers re-deal its unfinished "
            "work with no staleness wait", self.pid, self.epoch,
        )

    def _check_drains(self, now: float, names: "set[str] | None" = None) -> bool:
        """Adopt peers' planned-departure notes: immediate membership
        verdict — one epoch bump, no staleness wait, no death verdict,
        never counted against ``max_dead``. `names` is check()'s single
        directory listing — peers without a drain entry there cost no
        further I/O."""
        from drep_tpu_torch.utils.profiling import counters

        departed: list[int] = []
        latency = 0.0
        autoscaled = 0
        for p in self.live:
            if p == self.pid:
                continue
            if names is not None and f".pod-drain.p{p}" not in names:
                continue
            note = self.drain_payload(p)
            if note is None:
                continue
            departed.append(p)
            autoscaled += bool(note.get("autoscale"))
            try:
                latency = max(
                    latency, now - os.stat(self.drain_path(p)).st_mtime
                )
            except OSError:
                pass
        if not departed:
            return False
        if autoscaled:
            # the departure was DECIDED by the autoscaling controller, not
            # an operator/preemption: provenance for bench honesty
            counters.add_fault("autoscale_churn", autoscaled)
        telemetry.event(
            "drain_adopted", peers=departed, latency_s=round(latency, 3)
        )
        self.live = [p for p in self.live if p not in departed]
        self.drained.extend(departed)
        self.epoch += 1
        counters.add_fault("planned_departures", len(departed))
        counters.add_fault("pod_epoch_bumps")
        counters.note_epoch(self.epoch, "drain")
        # the degradation-latency proof: wall time from the departure
        # note's publish to THIS adoption (the re-deal happens in the
        # caller's very next dealing pass) — the drain contract is that
        # this sits at ~one check cadence, never the 5x-cadence staleness
        # window a death costs
        counters.set_gauge("drain_adopt_latency_s", round(latency, 3))
        self._publish_pod_state()
        get_logger().warning(
            "elastic pod: process(es) %s departed PLANNED (drain notes) — "
            "bumping ownership epoch to %d and re-dealing their unfinished "
            "work across %s immediately (no staleness wait; not counted "
            "against --max_dead_processes)",
            departed, self.epoch, self.live,
        )
        return True

    def _check_joins(self, now: float, names: "set[str] | None" = None) -> bool:
        """Admit (leader) / adopt (everyone else) mid-run joiners.

        The lowest-live member is the admitting leader: it scans for
        join-request notes from ids it has never seen, requires a FRESH
        heartbeat from the candidate (a joiner that died between request
        and admission must be garbage, not a member), honors at most
        ``max_joins`` admissions, bumps the epoch, and publishes an admit
        note carrying the grown live set + the pod geometry. Every other
        member adopts published admit notes the same way it adopts death
        verdicts — the membership view converges without any collective.
        `names` is check()'s single directory listing; without join/admit
        entries there the pass costs nothing."""
        from drep_tpu_torch.utils.profiling import counters

        changed = False
        # ADMITTING (turning requests into admit notes) is the leader's
        # call, bounded by its --max_joins budget; ADOPTING a published
        # admit note follows the leader's decision — but BOTH require the
        # candidate to be beating NOW, judged server-clock-to-server-clock
        # against our own beat's mtime (the same skew defense as the
        # staleness verdicts): a fresh-beat requirement is also what makes
        # stale admit notes from a PREVIOUS run harmless — the seq gate
        # cannot reject them across restarts (every process's sequence
        # restarts at 1), but a ghost joiner has no live beat, so it is
        # never adopted and never consumes stripes or the death budget
        lead = bool(self.live) and self.pid == min(self.live)
        try:
            ref = os.stat(self.beat_path()).st_mtime
        except OSError:
            ref = now

        def _beating(j: int) -> bool:
            try:
                return ref - os.stat(self.beat_path(j)).st_mtime <= self.miss_s
            except OSError:
                return False

        if names is not None:
            candidates = [
                os.path.join(self.note_dir, nm)
                for nm in names
                if nm.startswith(".pod-admit.p")
                or (
                    nm.startswith(".pod-join.p") and lead and self.max_joins > 0
                )
            ]
        else:
            import glob

            candidates = glob.glob(
                os.path.join(self.note_dir, ".pod-admit.p*")
            ) + (
                glob.glob(os.path.join(self.note_dir, ".pod-join.p*"))
                if lead and self.max_joins > 0
                else []
            )
        # sorted: admit notes (alphabetically first) are adopted before
        # new requests are judged, and the scan order is deterministic
        for path in sorted(candidates):
            try:
                j = int(path.rsplit(".p", 1)[1])
            except ValueError:
                continue
            admitting = ".pod-join." in os.path.basename(path)
            if admitting and lead and j in set(range(self.pc)) | set(self.live):
                # an auto-derived join id can collide with a canonical
                # member that simply has not beaten yet (pod startup):
                # silence would starve the joiner until its timeout, so
                # the leader REJECTS with a floor the joiner can re-
                # request above
                reject = self.admit_path(j)
                if not os.path.exists(reject):
                    note = self._note_json(path)
                    try:
                        from drep_tpu_torch.utils.durableio import atomic_write_json

                        atomic_write_json(
                            reject,
                            {
                                "pid": j, "reject": "id collides with a pod member",
                                "min_id": max(max(self.live), self.pc - 1) + 1,
                                "seq": self.seq,
                                "token": (note or {}).get("token"),
                                "at": now,
                            },
                        )
                    except OSError:
                        pass
                continue
            if (
                j == self.pid
                or j in self.live
                or j in self.dead
                or j in self.drained
                or j in self._adopted_admits
            ):
                continue
            note = self._note_json(path)
            if note is None:
                continue
            if admitting:
                if not lead:
                    continue  # only the leader turns requests into admits
                # the candidate must already be heartbeating — admission
                # of a corpse would hand it stripes nobody computes until
                # its staleness verdict claws them back
                if not _beating(j):
                    continue
                if len(self.joined) >= self.max_joins:
                    if not self._join_budget_logged:
                        self._join_budget_logged = True
                        get_logger().warning(
                            "elastic pod: join request from process %d "
                            "refused — --max_joins %d admission(s) already "
                            "granted this stage", j, self.max_joins,
                        )
                    continue
            else:
                # adopting a published admit note: seq-gated like every
                # other membership note (a previous stage's admit must
                # not resurrect a long-gone joiner), AND fresh-beat-gated
                # (the seq gate is blind across pod RESTARTS — sequences
                # start over — so liveness is what keeps a previous run's
                # admit from resurrecting a ghost); rejects are a
                # leader-to-joiner message, never a membership verdict
                if (
                    "reject" in note
                    or int(note.get("seq", -1)) < self.seq
                    or not _beating(j)
                ):
                    continue
            if admitting:
                # publish the admit note BEFORE committing the local
                # view: the note is how the joiner (and every peer)
                # learns of the admission — a member only this process
                # knows about would be stranded, so a failed write means
                # no admission happened at all
                try:
                    from drep_tpu_torch.utils.durableio import atomic_write_json

                    admit_note = {
                        "pid": j, "epoch": self.epoch + 1,
                        "live": sorted(self.live + [j]), "pc": self.pc,
                        "seq": self.seq, "token": note.get("token"),
                        "at": now,
                    }
                    if note.get("autoscale"):
                        # relay the joiner's autoscale stamp so adopting
                        # peers (who only ever read the admit note) book
                        # the same churn provenance the leader does
                        admit_note["autoscale"] = True
                    atomic_write_json(self.admit_path(j), admit_note)
                except OSError:
                    continue
            telemetry.event(
                "join_admitted" if admitting else "join_adopted",
                peer=j, by=self.pid,
            )
            if note.get("autoscale"):
                counters.add_fault("autoscale_churn")
            self.live = sorted(self.live + [j])
            self.joined.append(j)
            self._adopted_admits.add(j)
            self.epoch += 1
            changed = True
            counters.add_fault("pod_joins")
            counters.add_fault("pod_epoch_bumps")
            counters.note_epoch(self.epoch, "join")
            self._publish_pod_state()
            get_logger().warning(
                "elastic pod: process %d JOINED mid-run (%s) — bumping "
                "ownership epoch to %d and re-dealing unfinished work over "
                "the grown live set %s",
                j, "admitted by this leader" if admitting else "adopted admit note",
                self.epoch, self.live,
            )
        return changed

    def _publish_pod_state(self) -> None:
        """Module pod state for DOWNSTREAM consumers (later barriers,
        bench provenance). Joiners are stage-scoped: the downstream live
        view holds original members only, and a PURE-join stage (no
        deaths, no drains) leaves the pod state healthy — later stages
        keep the normal collective path over the whole original pod."""
        if self.dead or self.drained:
            mark_pod_degraded(
                self.epoch,
                [p for p in self.live if p < self.pc],
                self.dead,
                drained=self.drained,
                joined=self.joined,
            )
        elif self.joined:
            mark_pod_joined(self.joined)

    def mark_done(self, pairs_computed: int) -> None:
        from drep_tpu_torch.utils.durableio import atomic_write_json

        atomic_write_json(
            self.done_path(),
            {"pairs": int(pairs_computed), "epoch": self.epoch, "seq": self.seq},
        )
        telemetry.event("done", pid=self.pid, pairs=int(pairs_computed))

    def close(self) -> None:
        import contextlib

        global _CURRENT_HB
        if _CURRENT_HB is self:
            _CURRENT_HB = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.cadence))
            self._thread = None
        with contextlib.suppress(OSError):
            os.remove(self.beat_path())


def _next_join_id(note_dir: str) -> int:
    """Auto-derived join id: one past the highest process id any pod note
    in the store names — guaranteed >= the original process count once
    the pod is beating (every member's beat note is visible), so the
    canonical epoch-0 owners are never shadowed. Explicit ids
    (``DREP_TORCH_POD_JOIN=<int>``) exist for orchestration that knows the
    pod geometry up front (and for joins racing the pod's own startup,
    where no notes exist yet to derive from)."""
    import glob
    import re

    top = -1
    for path in glob.glob(os.path.join(note_dir, ".pod-*.p*")):
        m = re.search(r"\.p(\d+)$", path)
        if m:
            top = max(top, int(m.group(1)))
    return top + 1


def join_elastic_pod(
    note_dir: str,
    cadence: float,
    config: "FaultTolConfig | None" = None,
    what: str = "elastic stage",
    timeout_s: float | None = None,
    validate: Callable[[], bool] | None = None,
) -> "HeartbeatManager":
    """Join a RUNNING elastic pod as new capacity (the scale-UP half of
    the protocol): publish a join-request note plus a first
    heartbeat under a fresh id, wait for the leader's admit note, and
    return a started :class:`HeartbeatManager` wired into the pod's
    membership (live set, epoch, stage sequence, original process count —
    all from the admit note, so the joiner's canonical-order view is
    identical to every original member's).

    The note goes out BEFORE any store validation so a pod gated on
    "capacity has arrived" can open its store after seeing the request
    (no circular wait); `validate` (e.g. a checkpoint-meta match) is
    polled alongside the admission wait and must hold before this
    returns — a joiner must never compute against a store whose inputs
    differ from its own.

    Raises :class:`CollectiveTimeout` when no admission (or no valid
    store) materializes within the collective timeout — the pod may be
    gone, finished, or running with ``--max_joins`` exhausted."""
    import contextlib
    import uuid

    from drep_tpu_torch.utils.durableio import atomic_write_json
    from drep_tpu_torch.utils.profiling import counters

    cfg = config if config is not None else DEFAULT_CONFIG
    t = collective_timeout_s() if timeout_s is None else timeout_s
    deadline = time.monotonic() + t if t > 0 else None
    os.makedirs(note_dir, exist_ok=True)
    token = uuid.uuid4().hex
    req = join_requested()
    explicit = None
    if req is not None and req != "auto":
        try:
            explicit = int(req)
        except ValueError:
            from drep_tpu_torch.errors import UserInputError

            raise UserInputError(
                f"{POD_JOIN_ENV}={req!r}: expected 'auto' or an integer "
                f"join id (>= the pod's original process count)"
            ) from None
    logger = get_logger()

    beat_stamp = b"join-candidate:" + token.encode()

    def _owns_beat(jid: int) -> bool:
        """Is `.pod-hb.p{jid}` still OUR candidate beat? A different
        payload means the id's rightful owner (a late-starting canonical
        member whose id an early auto-derivation shadowed, or a racing
        joiner) is beating under it — our writes there would mask that
        process's real death from the staleness detector. Transient read
        trouble reads as ours (collision detection is best-effort; the
        leader's reject path and admit-token check are the guarantees)."""
        try:
            with open(os.path.join(note_dir, f".pod-hb.p{jid}"), "rb") as f:
                return f.read() == beat_stamp
        except OSError:
            return True

    def _beat(jid: int) -> None:
        from drep_tpu_torch.utils.durableio import atomic_write_bytes

        atomic_write_bytes(os.path.join(note_dir, f".pod-hb.p{jid}"), beat_stamp)

    floor = 0
    while True:
        jid = (
            explicit
            if explicit is not None
            else max(_next_join_id(note_dir), floor)
        )
        _beat(jid)  # beat first: admission requires a live candidate
        # drep-lint: allow[clock-mono] — cross-host note timestamp
        join_note: dict = {"token": token, "at": time.time()}
        if envknobs.env_bool(AUTOSCALE_SPAWNED_ENV):
            # spawned by the autoscaling controller: the stamp rides the
            # join note into the leader's admit note, so every member
            # books autoscale_churn and the run's bench records refuse
            # as measured perf (the membership-churn rule)
            join_note["autoscale"] = True
        atomic_write_json(
            os.path.join(note_dir, f".pod-join.p{jid}"), join_note
        )
        logger.info(
            "elastic pod: requesting mid-run JOIN as process %d (note dir %s)",
            jid, note_dir,
        )
        admit_path = os.path.join(note_dir, f".pod-admit.p{jid}")
        last_beat = time.monotonic()
        note = None
        while True:
            if os.path.exists(admit_path):
                note = read_pod_note(admit_path, what="admit note")
                if note is not None and "reject" in note:
                    # the leader refused this id (it collides with a
                    # canonical member that had not beaten yet when the
                    # id was derived) and published the floor to retry
                    # above — explicit ids surface the operator error
                    if explicit is not None:
                        raise FaultTolError(
                            f"{what}: join id {jid} rejected by the pod "
                            f"leader ({note['reject']}); pass an id >= "
                            f"{note.get('min_id', jid + 1)} (or "
                            f"{POD_JOIN_ENV}=auto)"
                        )
                    floor = max(floor, int(note.get("min_id", jid + 1)))
                    note = None
                    # withdraw request AND beat: a stray fresh beat under
                    # a canonical member's id could mask that member's
                    # real death from the staleness detector — but never
                    # remove a beat its rightful owner already reclaimed
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(note_dir, f".pod-join.p{jid}"))
                    if _owns_beat(jid):
                        with contextlib.suppress(OSError):
                            os.remove(os.path.join(note_dir, f".pod-hb.p{jid}"))
                    break
                if note is not None and note.get("token") != token:
                    # another joiner owns this id (two auto-joins raced):
                    # withdraw and re-request under a fresh one (the id's
                    # rightful owner keeps beating — only the join note
                    # was ours to retract, and even that is shared)
                    note = None
                    if explicit is None:
                        break
            if note is not None and (validate is None or validate()):
                break
            if deadline is not None and time.monotonic() > deadline:
                if note is not None:
                    # ALREADY ADMITTED but the store never validated (an
                    # operator pointed a joiner at the wrong inputs): the
                    # pod now counts this process as a member — leave as
                    # a PLANNED DEPARTURE, not a future death verdict
                    # that would burn --max_dead_processes on a healthy
                    # pod a full staleness window from now
                    with contextlib.suppress(OSError):
                        atomic_write_json(
                            os.path.join(note_dir, f".pod-drain.p{jid}"),
                            {
                                "seq": int(note.get("seq", 0)),
                                "epoch": int(note.get("epoch", 0)),
                                # drep-lint: allow[clock-mono] — cross-host note timestamp
                                "pairs": 0, "at": time.time(),
                            },
                        )
                else:
                    # never admitted: withdraw the request AND the beat
                    # (if still ours) so a later leader check cannot
                    # admit a corpse
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(note_dir, f".pod-join.p{jid}"))
                    if _owns_beat(jid):
                        with contextlib.suppress(OSError):
                            os.remove(os.path.join(note_dir, f".pod-hb.p{jid}"))
                raise CollectiveTimeout(
                    f"{what}: join request (process {jid}) was not admitted "
                    f"within {t:.0f}s"
                    + (
                        ""
                        if note is not None
                        else " — the pod may be gone, already finished, or "
                        "running with --max_joins exhausted"
                    )
                    + (
                        ""
                        if validate is None or note is None
                        else " — admitted, but the store's checkpoint meta "
                        "never matched this process's inputs (different "
                        "genome set / parameters?); a planned-departure "
                        "note was published so the pod re-deals with no "
                        "staleness wait and no death-budget charge"
                    )
                    + f". (Timeout via {COLLECTIVE_TIMEOUT_ENV}.)"
                )
            if note is None and explicit is None and not _owns_beat(jid):
                # the id's rightful owner is beating under it (an auto id
                # derived before the pod was fully up shadowed a
                # late-starting canonical member, or another joiner raced
                # us): withdraw the REQUEST — the beat now belongs to the
                # owner and must stay — and re-derive above everyone
                # currently visible
                floor = max(floor, _next_join_id(note_dir))
                note = None
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(note_dir, f".pod-join.p{jid}"))
                break
            if cadence > 0 and time.monotonic() - last_beat >= cadence:
                with contextlib.suppress(OSError):
                    _beat(jid)
                last_beat = time.monotonic()
            time.sleep(min(0.5, max(0.05, cadence / 2 if cadence > 0 else 0.1)))
        if note is not None:
            break

    # adopt the pod's stage sequence BEFORE start() bumps it, so this
    # process's done-note seq pairs with every original member's
    key = os.path.abspath(note_dir)
    _HB_SEQ[key] = int(note["seq"]) - 1
    hb = HeartbeatManager(
        note_dir, cadence,
        max_dead=cfg.max_dead_processes,
        pc=int(note["pc"]), pid=jid,
        max_joins=cfg.max_joins,
    )
    hb.start()
    hb.live = sorted(int(p) for p in note["live"])
    hb.epoch = int(note["epoch"])
    hb.joined = [p for p in hb.live if p >= hb.pc]
    hb._adopted_admits.update(hb.joined)
    with contextlib.suppress(OSError):
        os.remove(os.path.join(note_dir, f".pod-join.p{jid}"))
    counters.add_fault("pod_join_accepted")
    if envknobs.env_bool(AUTOSCALE_SPAWNED_ENV):
        counters.add_fault("autoscale_churn")
    # the joiner's stream must re-home to its ADMITTED id (a production
    # joiner configured telemetry as a pid-0 single-process run — without
    # this its events would interleave into member 0's log) and stamp the
    # pod's CURRENT epoch (it never ran note_epoch for the bumps it
    # missed)
    telemetry.set_pid(jid)
    telemetry.set_epoch(hb.epoch)
    telemetry.event("joined", pid=jid, epoch=hb.epoch, live=hb.live)
    logger.info(
        "elastic pod: JOINED as process %d (epoch %d, live %s, original "
        "pod size %d)", jid, hb.epoch, hb.live, hb.pc,
    )
    return hb



def _watchdog_run(fn: Callable[[], Any], timeout_s: float, what: str, site: str):
    """Run `fn` on a disposable daemon thread bounded by `timeout_s`:
    WatchdogTimeout (counted) on overrun, else `fn`'s value or its
    exception. One thread a watched call: a tripped call leaves its
    thread inside the launch, and the next call must not queue behind the
    thread (on the card it still queues behind the launch: see the module
    docstring)."""
    box: dict[str, Any] = {}
    done = threading.Event()

    def work() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True, name=f"drep-watchdog-{site}").start()
    if not done.wait(timeout_s):
        from drep_tpu_torch.utils.profiling import counters

        counters.add_fault("watchdog_trips")
        raise WatchdogTimeout(f"{what}: exceeded the {timeout_s:.1f}s watchdog")
    if "err" in box:
        raise box["err"]
    return box["value"]


def wait_elastic(
    fn: Callable[[], Any],
    hb: "HeartbeatManager",
    timeout_s: float,
    what: str,
    site: str = "allgather",
    join_tolerant: bool = False,
) -> tuple[bool, Any]:
    """Bounded wait on a (possibly collective) blocking call with live
    heartbeat monitoring — THE primitive that turns "a peer died inside /
    before our collective" from an infinite hang into an elastic re-deal.

    Runs `fn` on a disposable daemon thread and polls the heartbeat
    manager while waiting:

    - `fn` completes -> ``(True, value)`` (a raise from `fn` with the pod
      still healthy at the deadline is re-raised).
    - the pod's MEMBERSHIP CHANGES (``hb.check()`` bumps the ownership
      epoch: a death verdict, a planned departure, or a mid-run join
      admission) -> ``(False, None)`` immediately — the caller abandons
      the collective (the worker thread stays parked inside the collective;
      a gloo collective cannot be cancelled) and re-deals the remaining
      work over the CURRENT live set. A collective-layer
      ERROR from `fn` (a dead peer resets the transport) does NOT abort by
      itself: the death verdict needs a full staleness window to mature,
      so the error is held until the heartbeat evidence confirms it (or
      the deadline passes — then it surfaces).
    - `timeout_s` passes with every heartbeat fresh -> CollectiveTimeout
      (a peer is wedged, not dead — re-dealing cannot help).

    ``join_tolerant=True`` (the ring-phase JOIN upgrade): an
    epoch bump that only ADDED members — no new deaths, no new drains —
    does NOT abandon the wait. A pure-join admission leaves the original
    pod's collective whole (the joiner's devices were never part of the
    mesh), so the in-flight program is still valid; abandoning it would
    demote every original member from the pipelined ring to per-block
    recovery, making scale-up SLOWER. The caller keeps waiting while the
    joiner consumes re-dealt work beside the collective.

    ``hb.check()`` raising (max_dead exceeded, or a verdict fencing THIS
    process) propagates."""
    from drep_tpu_torch.utils.profiling import counters

    box: dict[str, Any] = {}
    done = threading.Event()

    def work() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed/held below
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True, name=f"drep-elastic-{site}").start()
    epoch0 = hb.epoch
    gone0 = (len(hb.dead), len(hb.drained))
    deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
    poll = min(1.0, max(0.05, hb.cadence if hb.cadence > 0 else 0.25))
    held: BaseException | None = None
    while True:
        if done.wait(poll):
            if "err" not in box:
                return True, box["value"]
            held = box["err"]
            if deadline is None:
                # timeout disabled (the module's t<=0 convention — run
                # bare): there is no deadline at which a held error would
                # ever surface, so propagate it immediately instead of
                # silently polling forever
                raise held
            done.clear()  # keep polling: the death verdict must mature
        hb.check()
        if hb.epoch != epoch0:
            if join_tolerant and (len(hb.dead), len(hb.drained)) == gone0:
                # pure-join bump(s): capacity arrived, nobody left — the
                # collective is whole, keep waiting under the new epoch
                epoch0 = hb.epoch
            else:
                return False, None
        if deadline is not None and time.monotonic() > deadline:
            counters.add_fault("watchdog_trips")
            if held is not None:
                raise CollectiveTimeout(
                    f"{what} failed at the collective layer ({held!r}) and no "
                    f"pod-member death was confirmed within {timeout_s:.0f}s — "
                    f"restart the pod; shard-level checkpoints resume finished "
                    f"work."
                ) from held
            raise CollectiveTimeout(
                f"{what} did not complete within {timeout_s:.0f}s and every "
                f"peer's heartbeat is still fresh — a peer is wedged, not "
                f"dead. Restart the pod; shard-level checkpoints resume "
                f"finished work. (Timeout via {COLLECTIVE_TIMEOUT_ENV}; "
                f"heartbeat cadence via {HEARTBEAT_ENV}.)"
            )



class TileExecutor:
    """Retrying round-robin launcher over this process's ring positions
    (the dense ring's per-block recovery, fault site ``ring_dispatch``).

    ``run(compute)`` calls ``compute(slot)`` on the next active slot under
    the watchdog, the fault site fired first inside the watched region
    with ``device=slot``; a failure retries with backoff on another slot,
    and a slot that fails ``quarantine_after`` times in a row leaves the
    round robin. A block whose ``1 + max_retries`` attempts all failed
    raises :class:`FaultTolError`: the JAX package's CPU fallback is not
    ported. A launch in the port is synchronous (the caller copies the
    tile back inside `compute`), so the watchdog bounds the launch itself.
    """

    fault_site = "ring_dispatch"

    def __init__(self, devices: list, config: FaultTolConfig | None = None) -> None:
        self.devices = list(devices)
        self.config = config if config is not None else DEFAULT_CONFIG
        self.active: list[int] = list(range(len(self.devices)))
        self._failures = [0] * len(self.devices)
        self._rr = 0
        self._auto = AutoTimeout(self.config)

    def next_slot(self, exclude: frozenset | set = frozenset()) -> int:
        """Next round-robin slot among the active ones, skipping `exclude`
        (slots this block already failed on) unless nothing else is left."""
        if all(s in exclude for s in self.active):
            exclude = frozenset()
        for _ in range(len(self.active)):
            slot = self.active[self._rr % len(self.active)]
            self._rr += 1
            if slot not in exclude:
                return slot
        raise AssertionError("unreachable: active is never empty")

    def _record_failure(self, slot: int, exc: BaseException) -> None:
        from drep_tpu_torch.utils.profiling import counters

        self._failures[slot] += 1
        get_logger().warning(
            "%s: launch failed on device slot %d (%d consecutive): %s",
            self.fault_site, slot, self._failures[slot], exc,
        )
        if (
            self._failures[slot] >= self.config.quarantine_after
            and slot in self.active
            and len(self.active) > 1
        ):
            self.active.remove(slot)
            counters.add_fault("quarantined_devices")
            get_logger().warning(
                "%s: quarantining device slot %d (%s) after %d consecutive failures — continuing on "
                "%d slot(s)", self.fault_site, slot, self.devices[slot], self._failures[slot],
                len(self.active),
            )

    def _attempt(self, compute: Callable[[int], Any], slot: int) -> Any:
        def work() -> Any:
            faults.fire(self.fault_site, device=slot)
            return compute(slot)

        timeout = self._auto.effective()
        t0 = time.perf_counter()
        value = work() if timeout <= 0 else _watchdog_run(
            work, timeout, what=f"{self.fault_site}: launch on device slot {slot}", site=self.fault_site)
        self._auto.note(time.perf_counter() - t0)
        return value

    def run(self, compute: Callable[[int], Any]) -> Any:
        """``compute(slot)`` with retries over the slots (class doc)."""
        from drep_tpu_torch.utils.profiling import counters

        slot = self.next_slot()
        failed: set[int] = set()
        err: BaseException | None = None
        for attempt in range(self.config.max_retries + 1):
            if attempt:
                time.sleep(self.config.backoff_s * (2 ** (attempt - 1)))
                slot = self.next_slot(exclude=failed)
                counters.add_fault("retries")
            try:
                value = self._attempt(compute, slot)
            except PodDrained:
                raise
            except Exception as e:  # noqa: BLE001 — retried on another slot
                self._record_failure(slot, e)
                failed.add(slot)
                err = e
                continue
            self._failures[slot] = 0
            return value
        raise FaultTolError(
            f"{self.fault_site}: launch failed after {self.config.max_retries + 1} attempts, with no "
            f"CPU fallback (last error: {err!r})"
        ) from err


def retrying_call(
    fn: Callable[[], Any],
    site: str,
    config: FaultTolConfig | None = None,
    auto: AutoTimeout | None = None,
    fire: bool = True,
):
    """``fn()`` with bounded retries: FaultTolError once ``1 +
    max_retries`` attempts have failed. Each attempt runs under the
    watchdog where its deadline is positive: `auto`'s (the caller's
    AutoTimeout, which notes each success's latency), else the config's
    ``dispatch_timeout_s``. The fault `site` fires before each attempt,
    as in the JAX package; ``fire=False`` where `fn` fires it itself (a
    streaming stripe fires after its launch, as the JAX package's fires at
    its wait, so an injected raise costs the launch it follows).

    Every call the port wraps launches on this process's devices only (a
    stripe; a secondary call, whose mesh a pod keeps on the member's own
    positions, cluster/engines.py::_mesh_or_none): the JAX package's
    ``local_only`` promise holds for all of them, so a retry on a pod
    never desyncs its peers. A drain (:class:`PodDrained`) is never
    retried."""
    from drep_tpu_torch.utils.profiling import counters

    cfg = config if config is not None else DEFAULT_CONFIG

    def attempt_fn() -> Any:
        if fire:
            faults.fire(site)
        return fn()

    last: BaseException | None = None
    for attempt in range(cfg.max_retries + 1):
        if attempt:
            time.sleep(cfg.backoff_s * (2 ** (attempt - 1)))
            counters.add_fault("retries")
        timeout = auto.effective() if auto is not None else cfg.dispatch_timeout_s
        t0 = time.perf_counter()
        try:
            value = attempt_fn() if timeout <= 0 else _watchdog_run(attempt_fn, timeout, what=site, site=site)
        except PodDrained:
            raise
        except Exception as e:  # noqa: BLE001
            last = e
            get_logger().warning("%s: attempt %d/%d failed: %s", site, attempt + 1, cfg.max_retries + 1, e)
            continue
        if auto is not None:
            auto.note(time.perf_counter() - t0)
        return value
    raise FaultTolError(f"{site}: failed after {cfg.max_retries + 1} attempts (last: {last!r})") from last


def run_with_timeout(
    fn: Callable[[], Any],
    what: str,
    site: str = "allgather",
    timeout_s: float | None = None,
    diagnose: Callable[[], str] | None = None,
):
    """Watchdog for multi-host collectives: run `fn` on a worker thread;
    on overrun (or a collective-layer error) raise CollectiveTimeout with
    an actionable message — `diagnose()` contributes peer-level detail
    (e.g. which process never reached the barrier) when the caller has a
    way to know."""
    t = collective_timeout_s() if timeout_s is None else timeout_s

    def work() -> Any:
        faults.fire(site)
        return fn()

    if t <= 0:
        return work()

    def detail() -> str:
        if diagnose is None:
            return ""
        try:
            return " " + diagnose()
        except Exception:  # noqa: BLE001 — diagnosis is best-effort
            return ""

    try:
        return _watchdog_run(work, t, what=what, site=site)
    except WatchdogTimeout:
        raise CollectiveTimeout(
            f"{what} did not complete within {t:.0f}s — a peer process has "
            f"likely crashed or wedged.{detail()} Restart the pod; shard-level "
            f"checkpoints will resume finished work. (Timeout is configurable "
            f"via {COLLECTIVE_TIMEOUT_ENV}; 0 disables.)"
        ) from None
    except Exception as e:  # noqa: BLE001 — the collective layer's own error
        raise CollectiveTimeout(
            f"{what} failed at the collective layer ({e!r}) — a peer "
            f"process has likely crashed.{detail()} Restart the pod; "
            f"shard-level checkpoints will resume finished work."
        ) from e
