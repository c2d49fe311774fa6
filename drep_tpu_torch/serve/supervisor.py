"""The fleet supervisor: durable membership and the replica lifecycle.

Counterpart of drep_tpu/serve/supervisor.py, in its formats. It owns the
``index serve`` replica processes of a serving fleet against one durable
manifest:

- **Durable membership.** ``fleet.json``, one checked-JSON manifest
  published through :mod:`drep_tpu_torch.utils.durableio` (atomic, its
  CRC in band), records every slot's address, partition scope, pid and
  supervision state. Each publish also keeps a ``fleet.gNNNNNN.json``
  snapshot (the newest :data:`KEEP_GENERATIONS`; a crash between the
  publish and the clean-up leaves extras that the JAX package's
  ``tools/scrub_store.py`` classifies as ``stale_membership``, never as
  damage). Either package's supervisor adopts the other's manifest, and
  either package's router rebuilds its replica table from it.
- **Restart with decorrelated backoff.** A death books a wall-clock
  instant and its reason into the slot and schedules a respawn after
  ``uniform(base, prev*3)`` clamped to ``DREP_TORCH_SUP_BACKOFF_MAX_S``.
- **Crash-loop quarantine.** ``DREP_TORCH_SUP_CRASHLOOP_K`` deaths
  inside ``DREP_TORCH_SUP_CRASHLOOP_WINDOW_S`` move the slot to
  QUARANTINED with a durable reason: no more respawns, and routed
  traffic over the missing coverage gets the router's stamped PARTIAL
  verdicts. :meth:`FleetSupervisor.unquarantine` is the operator's way
  back.
- **Orphan adoption.** A restarted supervisor never spawns twice: it
  loads the manifest, probes every recorded pid (``kill(pid, 0)``, then
  ``/healthz`` over the serve wire), adopts the live ones and books the
  stale ones as deaths.
- **Graceful drain with escalation.** Retirement is ``fleet leave`` ->
  SIGTERM -> ``DREP_TORCH_SUP_DRAIN_DEADLINE_S`` -> SIGKILL, the
  escalations counted in the slot.

The fleet autoscaler (autoscale/fleet.py) acts only through
:meth:`FleetSupervisor.place` and :meth:`FleetSupervisor.drain`, so a
scale-down picks its victim from the manifest. A replica that cannot
start is a death like any other (backoff, then quarantine); the
supervisor never changes the replica's command line, and so never turns
a card replica into a CPU one. The supervisor itself is a control plane:
it never touches a device.

State machine (one slot)::

    place() --> STARTING --ready line--> HEALTHY
                   |                        | pid death / probe loss
                   | startup deadline       v
                   +------death-------> BACKOFF --retry due--> STARTING
                                           | K deaths in the window
                                           v
                                      QUARANTINED --unquarantine()--> BACKOFF
    drain() from HEALTHY/STARTING/BACKOFF --> DRAINING --exit--> (slot removed)
                                                 | drain deadline
                                                 +--SIGKILL (escalation)--+

Manifest instants are wall-clock (a successor process reads them on its
own clock); waits inside one process are monotonic. With tracing on the
supervisor leaves the JAX supervisor's instants (``supervisor_spawn``,
``_death``, ``_quarantine``, ``_unquarantine``, ``_drain``,
``_escalation``, ``_recover``); the ``supervisor_spawn`` and
``supervisor_tick`` fault sites fire where the JAX package fires them.
"""

from __future__ import annotations

import json
import os
import random
import selectors
import shlex
import signal
import subprocess
import time
from typing import Any, Callable

from drep_tpu_torch.utils import durableio, faults, telemetry
from drep_tpu_torch.utils.envknobs import env_float, env_int
from drep_tpu_torch.utils.logger import get_logger

__all__ = [
    "MANIFEST_NAME",
    "FleetSupervisor",
    "is_crash_loop",
    "load_manifest",
    "manifest_path",
    "next_backoff",
    "pid_alive",
]

MANIFEST_NAME = "fleet.json"
# generation snapshots kept after each publish
KEEP_GENERATIONS = 2
# consecutive failed /healthz probes of a LIVE pid before the replica is
# judged wedged and booked as a death (one miss is routine under load;
# the router's own health machine routes around it meanwhile)
PROBE_STRIKES = 3
# set in each spawned replica's environment, as the JAX supervisor sets
# its twin; only the elastic pod's members read it (the autoscale stamp
# of their join and drain notes, parallel/faulttol.py)
SPAWNED_ENV = "DREP_TORCH_AUTOSCALE_SPAWNED"


# -- the lifecycle arithmetic -------------------------------------------------

def next_backoff(prev_s: float, base_s: float, max_s: float, rng: random.Random) -> float:
    """Decorrelated-jitter backoff: ``uniform(base, max(base, prev*3))``
    clamped to ``max_s``, so N replicas killed by one event spread their
    respawns."""
    lo = float(base_s)
    hi = max(lo, float(prev_s) * 3.0)
    return min(float(max_s), rng.uniform(lo, hi))


def is_crash_loop(deaths, now: float, k: int, window_s: float) -> bool:
    """True when at least ``k`` of the death instants fall inside the
    trailing ``window_s`` seconds. ``k <= 0`` never quarantines."""
    if int(k) <= 0:
        return False
    recent = [d for d in deaths if (now - float(d)) <= float(window_s)]
    return len(recent) >= int(k)


def pid_alive(pid) -> bool:
    """Liveness of any pid (an adopted replica is not our child) by
    ``kill(pid, 0)``; EPERM counts as alive. An exited but unreaped child
    (a zombie) still answers, so where the supervisor holds the Popen
    handle it polls the handle first."""
    try:
        pid = int(pid)
    except (TypeError, ValueError):
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def _parse_ready(line) -> dict | None:
    """One daemon ready line (bytes or str) -> its JSON object, or None
    for any other line."""
    try:
        msg = json.loads(line)
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(msg, dict) and msg.get("serving"):
        return msg
    return None


def _reap(proc, timeout_s: float = 5.0) -> None:
    """Collect a child's exit status so that its zombie goes (without it
    ``kill(pid, 0)`` keeps answering and a drain never retires). A
    spawn_fn fake without ``wait`` is left alone."""
    if proc is None:
        return
    wait = getattr(proc, "wait", None)
    if wait is None:
        return
    try:
        wait(timeout=timeout_s)
    except Exception:  # noqa: BLE001 — best effort: the next tick polls again
        pass


# -- the durable manifest ------------------------------------------------------

def manifest_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, MANIFEST_NAME)


def generation_name(gen: int) -> str:
    return f"fleet.g{int(gen):06d}.json"


def _empty_manifest() -> dict[str, Any]:
    return {"version": 1, "generation": 0, "supervisor_pid": None, "slots": {}}


def load_manifest(fleet_dir: str) -> dict[str, Any]:
    """Read and CRC-check the manifest. A missing file is an empty fleet
    (the first start); a rotted one raises CorruptPayloadError (nothing is
    adopted from garbage)."""
    path = manifest_path(fleet_dir)
    if not os.path.exists(path):
        return _empty_manifest()
    doc = durableio.read_json_checked(path, what="fleet manifest")
    if not isinstance(doc, dict) or not isinstance(doc.get("slots"), dict):
        raise durableio.CorruptPayloadError(f"fleet manifest {path}: not a slots document")
    return doc


def _new_slot(slot_id: str, partitions, spawn_cmd: str | None, now: float) -> dict[str, Any]:
    return {
        "slot_id": slot_id,
        "partitions": None if partitions is None else [int(p) for p in partitions],
        "address": None,
        "pid": None,
        "spawn_cmd": spawn_cmd,
        "state": "starting",
        "restarts": 0,
        "escalations": 0,
        "deaths": [],
        "last_death_reason": None,
        "next_retry_at": None,
        "backoff_s": 0.0,
        "quarantine_reason": None,
        "placed_at": now,
        "drain_started_at": None,
    }


def slot_range_key(slot: dict) -> str:
    """The range id autoscale/fleet.py keys its decisions on: ``"all"``
    for an unscoped slot, else the sorted partition ids joined by ``,``."""
    parts = slot.get("partitions")
    if parts is None:
        return "all"
    return ",".join(str(int(p)) for p in sorted(parts)) or "all"


class FleetSupervisor:
    """Own the replica processes of one fleet against one manifest.

    `fleet_dir` is the manifest's home (made on demand). `spawn_cmd` is
    the ``index serve`` command line of one replica (``{partitions}`` in
    it becomes the slot's comma list, or nothing for an unscoped slot).
    With `router_address`, every replica brought up or retired is
    announced to that router by a ``fleet`` join or leave (advisory: a
    router that is down rebuilds from the manifest when it returns).

    Test seams: `spawn_fn(argv, env) -> Popen-like` replaces the fork
    (a fake needs ``.pid``, ``.poll()``, ``.stdout``, ``.send_signal``),
    `probe_fn(address) -> bool` the ``/healthz`` round trip, and `rng`
    pins the backoff jitter."""

    def __init__(
        self,
        fleet_dir: str,
        *,
        spawn_cmd: str | None = None,
        router_address: str | None = None,
        heartbeat_s: float | None = None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float | None = None,
        crashloop_k: int | None = None,
        crashloop_window_s: float | None = None,
        drain_deadline_s: float | None = None,
        startup_deadline_s: float | None = None,
        spawn_env: dict | None = None,
        spawn_fn: Callable[..., Any] | None = None,
        probe_fn: Callable[[str], bool] | None = None,
        rng: random.Random | None = None,
    ) -> None:
        self.fleet_dir = str(fleet_dir)
        self.spawn_cmd = spawn_cmd
        self.router_address = router_address
        self.heartbeat_s = env_float("DREP_TORCH_SUP_HEARTBEAT_S") if heartbeat_s is None else float(heartbeat_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = (env_float("DREP_TORCH_SUP_BACKOFF_MAX_S") if backoff_max_s is None
                              else float(backoff_max_s))
        self.crashloop_k = env_int("DREP_TORCH_SUP_CRASHLOOP_K") if crashloop_k is None else int(crashloop_k)
        self.crashloop_window_s = (env_float("DREP_TORCH_SUP_CRASHLOOP_WINDOW_S") if crashloop_window_s is None
                                   else float(crashloop_window_s))
        self.drain_deadline_s = (env_float("DREP_TORCH_SUP_DRAIN_DEADLINE_S") if drain_deadline_s is None
                                 else float(drain_deadline_s))
        self.startup_deadline_s = (env_float("DREP_TORCH_SUP_STARTUP_DEADLINE_S") if startup_deadline_s is None
                                   else float(startup_deadline_s))
        self._spawn_env = spawn_env
        self._spawn_fn = spawn_fn
        self._probe_fn = probe_fn
        self._rng = rng if rng is not None else random.Random()
        self._log = get_logger()
        # our children's handles, slot_id -> Popen-like; an adopted slot
        # has none (its liveness is pid_alive alone)
        self.procs: dict[str, Any] = {}
        # consecutive probe misses a slot, in memory only: a successor
        # probing from zero is the right fresh start
        self._strikes: dict[str, int] = {}
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.doc = load_manifest(self.fleet_dir)

    # -- manifest transactions ---------------------------------------------
    def _publish(self) -> None:
        """Publish the manifest and its generation snapshot, then drop old
        snapshots. Every transition goes through here: the manifest is the
        supervisor's memory."""
        self.doc["generation"] = int(self.doc.get("generation", 0)) + 1
        self.doc["supervisor_pid"] = os.getpid()
        self.doc["updated_at"] = time.time()  # a cross-process instant: wall clock
        gen_path = os.path.join(self.fleet_dir, generation_name(self.doc["generation"]))
        durableio.atomic_write_json(gen_path, self.doc)
        durableio.atomic_write_json(manifest_path(self.fleet_dir), self.doc)
        self._gc_generations()

    def _gc_generations(self) -> None:
        kept: list[tuple[int, str]] = []
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            return
        for name in names:
            if name.startswith("fleet.g") and name.endswith(".json"):
                try:
                    kept.append((int(name[len("fleet.g"):-len(".json")]), name))
                except ValueError:
                    continue
        kept.sort()
        for _, name in kept[:-KEEP_GENERATIONS]:
            try:
                os.unlink(os.path.join(self.fleet_dir, name))
            except OSError:
                pass  # a leftover classifies as stale_membership, never damage

    def slots(self) -> dict[str, dict]:
        """A copy of the manifest's slot table (for reading, not mutating)."""
        return json.loads(json.dumps(self.doc.get("slots", {})))

    # -- the router's fleet op: advisory ------------------------------------
    def _fleet_op(self, action: str, address: str, partitions=None) -> None:
        if not self.router_address:
            return
        from drep_tpu_torch.serve.client import ServeClient

        req = {"op": "fleet", "action": action, "address": address}
        if action == "join":
            req["partitions"] = partitions
        try:
            with ServeClient(self.router_address, timeout_s=10.0) as c:
                c.request(req)
        except Exception as e:  # noqa: BLE001 — advisory by contract
            self._log.warning("supervisor: fleet %s for %s failed (router %s): %r",
                              action, address, self.router_address, e)

    def _probe(self, address: str) -> bool:
        if self._probe_fn is not None:
            return bool(self._probe_fn(address))
        from drep_tpu_torch.serve.client import ServeClient

        try:
            with ServeClient(address, timeout_s=5.0) as c:
                return bool(c.status())
        except Exception:  # noqa: BLE001 — an unreachable replica is a fact
            return False

    # -- deaths, backoff, quarantine ----------------------------------------
    def _book_death(self, slot: dict, reason: str, now: float) -> None:
        """Every death's one path: record its instant and reason, then
        quarantine (K deaths in the window) or schedule a backoff respawn."""
        slot["pid"] = None
        deaths = list(slot.get("deaths", []))
        deaths.append(now)
        # the detector looks back one window: a bounded tail is enough
        slot["deaths"] = deaths[-max(10, self.crashloop_k * 3):]
        slot["last_death_reason"] = reason
        self._strikes.pop(slot["slot_id"], None)
        if is_crash_loop(slot["deaths"], now, self.crashloop_k, self.crashloop_window_s):
            slot["state"] = "quarantined"
            slot["quarantine_reason"] = (
                f"crash loop: {self.crashloop_k} deaths within {self.crashloop_window_s:g}s (last: {reason})")
            slot["next_retry_at"] = None
            self._log.warning("supervisor: slot %s QUARANTINED — %s", slot["slot_id"], slot["quarantine_reason"])
            telemetry.event("supervisor_quarantine", slot=slot["slot_id"], reason=slot["quarantine_reason"])
        else:
            slot["backoff_s"] = next_backoff(slot.get("backoff_s") or 0.0, self.backoff_base_s,
                                             self.backoff_max_s, self._rng)
            slot["state"] = "backoff"
            slot["next_retry_at"] = now + slot["backoff_s"]
            self._log.warning("supervisor: slot %s died (%s) — retry in %.2fs",
                              slot["slot_id"], reason, slot["backoff_s"])
            telemetry.event("supervisor_death", slot=slot["slot_id"], reason=reason,
                            backoff_s=round(slot["backoff_s"], 3))

    def unquarantine(self, slot_id: str) -> dict:
        """The operator's way out of QUARANTINE: the reason and the death
        ledger are cleared (a fixed binary gets a fresh window) and a
        respawn is due at once."""
        slot = self.doc["slots"][slot_id]
        if slot.get("state") != "quarantined":
            raise ValueError(f"slot {slot_id} is {slot.get('state')!r}, not quarantined")
        slot["state"] = "backoff"
        slot["quarantine_reason"] = None
        slot["deaths"] = []
        slot["backoff_s"] = 0.0
        slot["next_retry_at"] = time.time()  # a manifest instant: wall clock
        self._publish()
        telemetry.event("supervisor_unquarantine", slot=slot_id)
        return slot

    # -- spawn ----------------------------------------------------------------
    def _slot_cmd(self, slot: dict) -> str | None:
        cmd = slot.get("spawn_cmd") or self.spawn_cmd
        if not cmd:
            return None
        if "{partitions}" in cmd:
            key = slot_range_key(slot)
            cmd = cmd.replace("{partitions}", "" if key == "all" else key)
        return cmd

    def _spawn_slot(self, slot: dict) -> bool:
        """Fork the slot's replica, wait for its JSON ready line under the
        startup deadline, join it to the router. A death at startup books
        like any other (backoff, quarantine). True when the slot is
        HEALTHY."""
        # the manifest already records the intent (state starting): a
        # supervisor killed here leaves a slot its successor spawns once
        faults.fire("supervisor_spawn")
        cmd = self._slot_cmd(slot)
        now = time.time()  # death instants are manifest instants: wall clock
        if not cmd:
            self._book_death(slot, "no spawn command for slot", now)
            return False
        env = dict(self._spawn_env if self._spawn_env is not None else os.environ)
        env[SPAWNED_ENV] = "1"
        argv = [a for a in shlex.split(cmd) if a]
        if self._spawn_fn is not None:
            proc = self._spawn_fn(argv, env)
        else:
            proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, text=True)
        ready = self._await_ready(proc)
        now = time.time()
        if ready is None:
            rc = proc.poll()
            reason = (f"died at startup (exit {rc})" if rc is not None
                      else f"no ready line within {self.startup_deadline_s:g}s")
            if rc is None:
                try:
                    proc.send_signal(signal.SIGKILL)
                except OSError:
                    pass
                _reap(proc)  # a dropped handle would leave a zombie
            self._book_death(slot, reason, now)
            return False
        slot["address"] = str(ready.get("serving"))
        slot["pid"] = int(ready.get("pid") or proc.pid)
        slot["state"] = "healthy"
        slot["placed_at"] = now
        self.procs[slot["slot_id"]] = proc
        self._fleet_op("join", slot["address"], slot.get("partitions"))
        self._log.info("supervisor: slot %s serving at %s (pid %d)", slot["slot_id"], slot["address"], slot["pid"])
        telemetry.event("supervisor_spawn", slot=slot["slot_id"], address=slot["address"], pid=slot["pid"])
        return True

    def _await_ready(self, proc) -> dict | None:
        """The daemon's one-JSON-object ready line off its stdout, under
        the startup deadline. A real pipe is read without blocking through
        a selector: a replica that lives but never prints costs the
        deadline, not the whole tick loop."""
        deadline = time.monotonic() + self.startup_deadline_s
        stdout = proc.stdout
        try:
            fd = stdout.fileno() if stdout is not None else None
        except (AttributeError, OSError, ValueError):
            fd = None  # a spawn_fn fake: its readline() never blocks
        if fd is None:
            while time.monotonic() < deadline:
                line = stdout.readline() if stdout else ""
                if not line:
                    if proc.poll() is not None:
                        return None
                    time.sleep(0.02)
                    continue
                msg = _parse_ready(line)
                if msg is not None:
                    return msg
            return None
        os.set_blocking(fd, False)
        sel = selectors.DefaultSelector()
        sel.register(fd, selectors.EVENT_READ)
        buf = b""
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                if not sel.select(timeout=min(remaining, 0.25)):
                    continue  # EOF reads as readable too: only time passes here
                try:
                    chunk = os.read(fd, 65536)
                except BlockingIOError:
                    continue
                except OSError:
                    return None
                if not chunk:
                    # EOF: the child closed stdout, usually dead before its
                    # ready line; reap it so that poll() gives its exit code
                    _reap(proc, timeout_s=2.0)
                    return None
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    msg = _parse_ready(line)
                    if msg is not None:
                        return msg
        finally:
            sel.close()

    # -- the placement API (what autoscale/fleet.py acts through) ------------
    def _next_slot_id(self) -> str:
        n = int(self.doc.get("next_slot", 0))
        self.doc["next_slot"] = n + 1
        return f"s{n:03d}"

    def place(self, partitions=None, count: int = 1, spawn_cmd: str | None = None) -> list[dict]:
        """Make and start `count` slots over `partitions` (None: unscoped).
        Each slot's intent is published before its process is forked, so a
        supervisor that dies mid-spawn leaks no untracked replica. Returns
        the slot records (their state says whether each is healthy)."""
        placed = []
        for _ in range(int(count)):
            now = time.time()  # placed_at orders drain victims across restarts: wall clock
            slot = _new_slot(self._next_slot_id(), partitions, spawn_cmd, now)
            self.doc["slots"][slot["slot_id"]] = slot
            self._publish()
            self._spawn_slot(slot)
            self._publish()
            placed.append(slot)
        return placed

    def drain(self, partitions=None, count: int = 1, address: str | None = None) -> list[dict]:
        """Retire up to `count` slots of the range (or the one slot serving
        `address`), the most recently placed first, chosen from the
        manifest. Graceful: fleet leave, then SIGTERM now; the tick
        escalates to SIGKILL past the drain deadline. ``count <= 0``
        drains nothing."""
        count = int(count)
        if count <= 0:
            return []
        key = None if partitions is None and address else (
            "all" if partitions is None else ",".join(str(int(p)) for p in sorted(partitions)))
        live = [
            s for s in self.doc["slots"].values()
            if s.get("state") in ("healthy", "starting", "backoff")
            and (address is None or s.get("address") == address)
            and (key is None or slot_range_key(s) == key)
        ]
        live.sort(key=lambda s: float(s.get("placed_at") or 0.0))
        victims = live[-count:]
        for slot in victims:
            if slot.get("address"):
                self._fleet_op("leave", slot["address"])
            slot["drain_started_at"] = time.time()  # read by a successor: wall clock
            slot["state"] = "draining"
            slot["next_retry_at"] = None
            if pid_alive(slot.get("pid")):
                try:
                    os.kill(int(slot["pid"]), signal.SIGTERM)
                except OSError:
                    pass
            telemetry.event("supervisor_drain", slot=slot["slot_id"], address=slot.get("address"))
        if victims:
            self._publish()
        return victims

    # -- crash recovery: adoption -----------------------------------------------
    def recover(self) -> dict[str, list[str]]:
        """A successor's first move: adopt every live replica of the
        manifest (pid alive and ``/healthz`` answering), book stale pids as
        deaths, finish interrupted drains. Adoption comes before any
        spawn, so no slot whose replica survived is spawned again. Returns
        {adopted, reaped, retired, quarantined} slot ids."""
        out: dict[str, list[str]] = {"adopted": [], "reaped": [], "retired": [], "quarantined": []}
        now = time.time()  # compared with manifest instants: wall clock
        for slot_id in list(self.doc.get("slots", {})):
            slot = self.doc["slots"][slot_id]
            state = slot.get("state")
            if state == "quarantined":
                out["quarantined"].append(slot_id)  # durable by contract
                continue
            if state == "draining":
                # the predecessor's drain: a dead pid retires the slot, a
                # live one is escalated by the tick past the deadline
                if not pid_alive(slot.get("pid")):
                    del self.doc["slots"][slot_id]
                    out["retired"].append(slot_id)
                continue
            alive = pid_alive(slot.get("pid"))
            if alive and slot.get("address") and self._probe(slot["address"]):
                slot["state"] = "healthy"
                out["adopted"].append(slot_id)
                self._log.info("supervisor: adopted slot %s at %s (pid %s)", slot_id, slot["address"], slot["pid"])
                # a router restarted with us rebuilds from the manifest, but
                # a join is idempotent and cheap
                self._fleet_op("join", slot["address"], slot.get("partitions"))
                continue
            if alive:
                # the pid lives but its wire is dead: kill it before the
                # death is booked, or the respawn races it
                try:
                    os.kill(int(slot["pid"]), signal.SIGKILL)
                except OSError:
                    pass
                self._book_death(slot, "adoption probe failed (pid alive, wire dead)", now)
            elif state in ("healthy", "starting", "backoff"):
                if state != "backoff":
                    self._book_death(slot, "stale pid reaped at recovery", now)
                out["reaped"].append(slot_id)
        self._publish()
        telemetry.event("supervisor_recover", **{k: len(v) for k, v in out.items()})
        return out

    # -- the heartbeat tick -------------------------------------------------------
    def tick(self) -> None:
        """One pass over every slot: liveness and ``/healthz`` for HEALTHY,
        the due respawn for BACKOFF, the deadline escalation and the
        retirement for DRAINING. Publishes only when something changed."""
        faults.fire("supervisor_tick")
        now = time.time()  # slot instants are manifest instants: wall clock
        changed = False
        for slot_id in list(self.doc.get("slots", {})):
            slot = self.doc["slots"][slot_id]
            state = slot.get("state")
            if state == "healthy":
                proc = self.procs.get(slot_id)
                rc = proc.poll() if proc is not None else None
                if rc is not None or not pid_alive(slot.get("pid")):
                    reason = f"exited rc={rc}" if rc is not None else f"pid {slot.get('pid')} vanished"
                    self.procs.pop(slot_id, None)
                    self._book_death(slot, reason, now)
                    changed = True
                elif slot.get("address") and not self._probe(slot["address"]):
                    strikes = self._strikes.get(slot_id, 0) + 1
                    self._strikes[slot_id] = strikes
                    if strikes >= PROBE_STRIKES:
                        # wedged, not dead: take the pid back, then book it
                        try:
                            os.kill(int(slot["pid"]), signal.SIGKILL)
                        except OSError:
                            pass
                        _reap(self.procs.pop(slot_id, None))
                        self._book_death(slot, f"unresponsive ({strikes} probes missed)", now)
                        changed = True
                else:
                    self._strikes.pop(slot_id, None)
            elif state == "backoff":
                if slot.get("next_retry_at") is not None and now >= float(slot["next_retry_at"]):
                    slot["state"] = "starting"
                    slot["restarts"] = int(slot.get("restarts", 0)) + 1
                    slot["next_retry_at"] = None
                    self._publish()  # the intent before the fork, as in place()
                    self._spawn_slot(slot)
                    changed = True
            elif state == "draining":
                # our own child is judged by poll(): an exited, unreaped
                # child is a zombie that pid_alive() still sees
                proc = self.procs.get(slot_id)
                exited = proc is not None and proc.poll() is not None
                if exited or not pid_alive(slot.get("pid")):
                    _reap(self.procs.pop(slot_id, None), timeout_s=1.0)
                    del self.doc["slots"][slot_id]
                    changed = True
                elif slot.get("drain_started_at") is not None and (
                        now - float(slot["drain_started_at"]) > self.drain_deadline_s):
                    try:
                        os.kill(int(slot["pid"]), signal.SIGKILL)
                    except OSError:
                        pass
                    _reap(proc)  # harvest now; the next tick retires the slot
                    slot["escalations"] = int(slot.get("escalations", 0)) + 1
                    slot["drain_started_at"] = now  # one escalation a deadline
                    self._log.warning("supervisor: slot %s blew the %.1fs drain deadline — SIGKILLed "
                                      "(escalation %d)", slot_id, self.drain_deadline_s, slot["escalations"])
                    telemetry.event("supervisor_escalation", slot=slot_id, escalations=slot["escalations"])
                    changed = True
        if changed:
            self._publish()

    def run(self, count: int = 0) -> int:
        """recover() once, then tick at the heartbeat until interrupted (or
        `count` ticks). Returns 0: replicas outlive their supervisor."""
        self.recover()
        n = 0
        try:
            while True:
                self.tick()
                n += 1
                if count and n >= count:
                    break
                time.sleep(max(0.05, self.heartbeat_s))
        except KeyboardInterrupt:
            pass
        return 0
