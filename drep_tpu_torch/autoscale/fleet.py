"""Fleet autoscaling: the pure scaling policy, one layer up, over a router.

Counterpart of drep_tpu/autoscale/fleet.py. The fleet front door
(serve/router.py) poses the batch policy's question for serving work:
do the replicas covering each partition range have the capacity to keep
queueing delay under the operator's target? This module answers it by
mapping the router's ``status`` onto the inputs
:func:`drep_tpu_torch.autoscale.policy.decide` takes:

- one router snapshot splits into one synthetic pod snapshot a partition
  range (replicas sharing an assignment govern together; unscoped
  replicas form the ``all`` range);
- ``eta_s`` is the queueing-delay projection ``queue_total * svc_s /
  n_live``;
- ``deadline_at`` is rebuilt every tick as ``observed_at +
  queue_deadline_s``, a rolling service target. Hysteresis, cooldown,
  clamps and reason slugs carry over unchanged, and the per-range
  decision history gates the same cooldown.

:class:`FleetAutoscaleController` ticks: the supervisor's heartbeat
(when it has one), the router's status, a decision per range, and the
actuation, recorded in the JSONL decision log (one whole flushed line a
record, the JAX package's keys) and, with tracing on, as a
``fleet_autoscale_decision`` instant. Actuation goes only through the
fleet supervisor's placement API (``serve/supervisor.py``): a scale-up is
:meth:`FleetSupervisor.place` (the manifest transaction, then the spawn,
its ready line and the ``fleet`` join), a scale-down
:meth:`FleetSupervisor.drain`, whose victim is the most recently placed
live slot of the range in the manifest, so the choice holds across any
number of controller restarts. Without a ``fleet_dir`` or ``supervisor``
the controller is recommend-only, and a ``spawn_cmd`` without one is a
ValueError. Replicas outlive the controller: the manifest makes its
successor whole.
"""

from __future__ import annotations

import json
import time
from dataclasses import replace

from drep_tpu_torch.autoscale.policy import Decision, Targets, decide
from drep_tpu_torch.utils import telemetry
from drep_tpu_torch.utils.logger import get_logger

__all__ = ["range_key", "fleet_snapshots", "decide_fleet", "FleetAutoscaleController", "append_decision"]

# replica states that count as serving capacity for a range: a suspect
# replica is still routable (one probe failure, a reprobe pending)
_LIVE_STATES = ("healthy", "suspect")


def range_key(assigned) -> str:
    """Canonical partition-range id: ``"all"`` for an unscoped replica,
    else the sorted partition ids joined with ``,``."""
    if assigned is None:
        return "all"
    return ",".join(str(int(p)) for p in sorted(assigned)) or "all"


def fleet_snapshots(status: dict, observed_at: float, svc_s: float) -> dict[str, dict]:
    """One router ``status`` as per-range synthetic pod snapshots that
    :func:`decide` takes unchanged. Pure: the clock rides in as
    `observed_at`. ``eta_s`` is ``queue_total * svc_s / n_live``, None
    with no live replica (the policy then holds, ``no-live-members``)."""
    replicas = ((status.get("replicas") or {}).get("replicas")) or {}
    ranges: dict[str, dict] = {}
    for addr, rep in replicas.items():
        key = range_key(rep.get("assigned"))
        r = ranges.setdefault(key, {"live": [], "queue_total": 0, "draining": []})
        state = rep.get("state")
        if state in _LIVE_STATES and not rep.get("draining"):
            r["live"].append(addr)
            r["queue_total"] += int(rep.get("queue_depth") or 0)
        elif rep.get("draining"):
            r["draining"].append(addr)
    out: dict[str, dict] = {}
    for key, r in sorted(ranges.items()):
        n_live = len(r["live"])
        eta = (r["queue_total"] * float(svc_s) / n_live) if n_live else None
        out[key] = {
            "observed_at": observed_at,
            "live": sorted(r["live"]),
            # a draining replica is capacity leaving, never a pending join
            "pending_joins": [],
            "shards_published": 0,
            "shards_total": None,  # serving never finishes
            "eta_s": round(eta, 6) if eta is not None else None,
            "queue_total": r["queue_total"],
        }
    return out


def decide_fleet(
    status: dict,
    observed_at: float,
    targets: Targets,
    queue_deadline_s: float,
    svc_s: float,
    history: dict[str, list[dict]],
) -> dict[str, Decision]:
    """One pure fleet verdict: per partition range, the batch policy over
    the mapped snapshot against the rolling deadline ``observed_at +
    queue_deadline_s``. `history` is keyed by range."""
    decisions: dict[str, Decision] = {}
    rolling = replace(targets, deadline_at=observed_at + float(queue_deadline_s))
    for key, snap in fleet_snapshots(status, observed_at, svc_s).items():
        decisions[key] = decide(snap, rolling, history.get(key, []))
    return decisions


def append_decision(path: str, record: dict) -> None:
    """One whole JSON line a decision, flushed: a SIGKILL tears at most
    the final line."""
    line = json.dumps(record, separators=(",", ":"), default=str)
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
        f.flush()


class FleetAutoscaleController:
    """Watch one router and govern its replica fleet, per partition range.

    `router_client` is anything with ``.status()`` (a
    :class:`drep_tpu_torch.serve.ServeClient`, or a test's fake). With
    `fleet_dir` the controller embeds a :class:`FleetSupervisor` anchored
    there (recovered at once: a restarted controller adopts its
    predecessor's replicas); `supervisor` shares an existing one (tests
    pass fakes with ``place``, ``drain`` and ``tick``). `spawn_cmd` is the
    ``index serve`` command line of one replica (``{partitions}`` becomes
    the range's comma list, nothing for ``all``). Each tick appends one
    record a range to `decision_log` (when given) with the JAX package's
    keys: ``at``, ``range``, ``verdict``, ``delta``, ``reason``,
    ``inputs``, ``actuation``."""

    def __init__(
        self,
        router_client,
        targets: Targets,
        queue_deadline_s: float,
        svc_s: float,
        spawn_cmd: str | None = None,
        interval_s: float = 2.0,
        decision_log: str | None = None,
        spawn_env: dict | None = None,
        fleet_dir: str | None = None,
        supervisor=None,
    ) -> None:
        self.client = router_client
        self.targets = targets
        self.queue_deadline_s = float(queue_deadline_s)
        self.svc_s = float(svc_s)
        self.spawn_cmd = spawn_cmd
        self.interval_s = float(interval_s)
        self.decision_log = decision_log
        self.history: dict[str, list[dict]] = {}
        self.decisions = 0
        self._log = get_logger()
        if supervisor is not None:
            self.supervisor = supervisor
        elif fleet_dir:
            from drep_tpu_torch.serve.supervisor import FleetSupervisor

            self.supervisor = FleetSupervisor(fleet_dir, spawn_cmd=spawn_cmd,
                                              router_address=getattr(router_client, "address", None),
                                              spawn_env=spawn_env)
            # adoption before any placement: the manifest, not this
            # process's memory, owns which replica belongs to which range
            self.supervisor.recover()
        elif spawn_cmd:
            raise ValueError("FleetAutoscaleController: spawn_cmd needs a fleet_dir (or an explicit supervisor) "
                             "— actuation is a manifest transaction, never an in-memory Popen ledger")
        else:
            self.supervisor = None  # recommend-only

    # -- actuation, all of it through the supervisor's placement API -----
    def _spawn_replica(self, key: str, count: int) -> str:
        if self.supervisor is None or not (self.spawn_cmd or getattr(self.supervisor, "spawn_cmd", None)):
            return "skipped: no --spawn command (recommend-only mode)"
        count = min(count, self.targets.max_spawn)
        if count <= 0:
            return "skipped: max_spawn is 0"
        parts = None if key == "all" else [int(p) for p in key.split(",")]
        placed = self.supervisor.place(partitions=parts, count=count)
        ok = [s.get("address") for s in placed if s.get("state") == "healthy"]
        pending = [s["slot_id"] for s in placed if s.get("state") != "healthy"]
        if pending and not ok:
            return f"FAILED: slot(s) {pending} died at startup (supervisor retries with backoff)"
        tail = f" ({len(pending)} pending respawn)" if pending else ""
        return f"placed {ok} for range {key}{tail}"

    def _drain_replica(self, key: str, count: int) -> str:
        if self.supervisor is None:
            return "skipped: no supervised capacity (recommend-only mode)"
        parts = None if key == "all" else [int(p) for p in key.split(",")]
        victims = self.supervisor.drain(partitions=parts, count=count)
        if not victims:
            return "skipped: no supervised capacity left to drain"
        out = [s.get("address") or s["slot_id"] for s in victims]
        return f"draining {out} for range {key}"

    def _actuate(self, key: str, decision: Decision) -> str:
        try:
            if decision.verdict == "scale_up":
                return self._spawn_replica(key, decision.delta)
            if decision.verdict == "scale_down":
                return self._drain_replica(key, -decision.delta)
        except Exception as e:  # noqa: BLE001 — a broken spawn must not lose the record
            self._log.warning("fleet autoscale: actuation failed: %r", e)
            return f"FAILED: {e!r}"
        return ""

    def poll_once(self) -> dict[str, Decision]:
        """One tick: the supervisor's heartbeat -> router status ->
        per-range decide -> actuate -> record. Read-only against the
        router (one status op); every process action rides the supervisor."""
        if self.supervisor is not None:
            try:
                self.supervisor.tick()
            except Exception as e:  # noqa: BLE001 — a broken heartbeat is a report; the policy still runs
                self._log.warning("fleet autoscale: supervisor tick failed: %r", e)
        observed_at = time.time()  # the rolling deadline's clock: the snapshot's own family
        try:
            status = self.client.status()
        except Exception as e:  # noqa: BLE001 — a dead router is a report, not a controller failure
            status = {"error": f"router unreachable: {e!r}"}
        if "error" in status:
            decisions = {"all": decide(status, self.targets, [])}
        else:
            decisions = decide_fleet(status, observed_at, self.targets, self.queue_deadline_s, self.svc_s,
                                     self.history)
        self.decisions += 1
        for key, decision in decisions.items():
            actuation = self._actuate(key, decision)
            if decision.verdict != "hold" and not actuation.startswith("skipped"):
                self.history.setdefault(key, []).append(
                    {"at": observed_at, "verdict": decision.verdict, "delta": decision.delta})
            record = {
                "at": observed_at,
                "range": key,
                "verdict": decision.verdict,
                "delta": decision.delta,
                "reason": decision.reason,
                "inputs": decision.inputs,
                "actuation": actuation,
            }
            if self.decision_log:
                try:
                    append_decision(self.decision_log, record)
                except OSError as e:
                    self._log.warning("fleet autoscale: decision log unwritable: %s", e)
            telemetry.event("fleet_autoscale_decision", range=key, verdict=decision.verdict, delta=decision.delta,
                            reason=decision.reason)
            if decision.verdict != "hold":
                self._log.warning("fleet autoscale[%s]: %s %+d (%s) — %s", key, decision.verdict, decision.delta,
                                  decision.reason, actuation)
        return decisions

    def run(self, count: int = 0) -> int:
        """Poll until interrupted (or `count` ticks). Returns 0: a dying
        fleet is a report, not a controller failure."""
        n = 0
        try:
            while True:
                self.poll_once()
                n += 1
                if count and n >= count:
                    break
                time.sleep(max(0.05, self.interval_s))
        except KeyboardInterrupt:
            pass
        finally:
            # placed replicas are fleet members: they stay, the manifest
            # records them and the next supervisor adopts them
            if self.supervisor is not None:
                for slot in self.supervisor.slots().values():
                    if slot.get("state") == "healthy":
                        self._log.info("fleet autoscale: leaving replica %s (pid %s, slot %s) running — "
                                       "fleet.json owns its lifecycle", slot.get("address"), slot.get("pid"),
                                       slot.get("slot_id"))
        return 0
