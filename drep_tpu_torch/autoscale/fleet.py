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

:class:`FleetAutoscaleController` runs recommend-only: each tick reads
the router's status, decides per range, and records every decision in
the JSONL decision log (one whole flushed line a record, the JAX
package's keys) and, with tracing on, as a ``fleet_autoscale_decision``
instant. Nothing spawns or drains. Actuation goes through the fleet
supervisor's manifest (``serve/supervisor.py``), which is ROADMAP.md
queue 1 item 11c: a ``spawn_cmd``, ``fleet_dir`` or ``supervisor``
argument raises NotImplementedError before anything is read.
"""

from __future__ import annotations

import json
import time
from dataclasses import replace

from drep_tpu_torch.autoscale.policy import Decision, Targets, decide
from drep_tpu_torch.utils import telemetry
from drep_tpu_torch.utils.logger import get_logger

__all__ = ["range_key", "fleet_snapshots", "decide_fleet", "FleetAutoscaleController", "append_decision"]

# the ROADMAP.md queue 1 item that ports the supervisor the actuation needs
SUPERVISION_ITEM = "11c"

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


def refuse_actuation(spawn_cmd=None, fleet_dir=None, supervisor=None) -> None:
    """Raise NotImplementedError where an argument asks for actuation,
    which runs through the fleet supervisor (item 11c)."""
    for flag, val in (("spawn_cmd", spawn_cmd), ("fleet_dir", fleet_dir), ("supervisor", supervisor)):
        if val is not None:
            raise NotImplementedError(
                f"fleet autoscale {flag}: spawn and drain go through the fleet supervisor, which is not "
                f"ported yet (ROADMAP.md queue 1, item {SUPERVISION_ITEM}); the port runs recommend-only"
            )


class FleetAutoscaleController:
    """Watch one router and decide for its replica fleet, per partition
    range, recommend-only.

    `router_client` is anything with ``.status()`` (a
    :class:`drep_tpu_torch.serve.ServeClient`, or a test's fake). Each
    tick appends one record a range to `decision_log` (when given) with
    the JAX package's keys: ``at``, ``range``, ``verdict``, ``delta``,
    ``reason``, ``inputs``, ``actuation``."""

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
        refuse_actuation(spawn_cmd, fleet_dir, supervisor)
        self.client = router_client
        self.targets = targets
        self.queue_deadline_s = float(queue_deadline_s)
        self.svc_s = float(svc_s)
        self.interval_s = float(interval_s)
        self.decision_log = decision_log
        self.history: dict[str, list[dict]] = {}
        self.decisions = 0
        self._log = get_logger()

    @staticmethod
    def _actuate(decision: Decision) -> str:
        """What the JAX controller records for a decision it cannot act
        on (recommend-only: no supervisor)."""
        if decision.verdict == "scale_up":
            return "skipped: no --spawn command (recommend-only mode)"
        if decision.verdict == "scale_down":
            return "skipped: no supervised capacity (recommend-only mode)"
        return ""

    def poll_once(self) -> dict[str, Decision]:
        """One tick: router status -> per-range decide -> record.
        Read-only against the router (one status op)."""
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
            actuation = self._actuate(decision)
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
                append_decision(self.decision_log, record)
            telemetry.event("fleet_autoscale_decision", range=key, verdict=decision.verdict, delta=decision.delta,
                            reason=decision.reason)
            if decision.verdict != "hold":
                self._log.warning("fleet autoscale[%s]: %s %+d (%s) — %s", key, decision.verdict, decision.delta,
                                  decision.reason, actuation)
        return decisions

    def run(self, count: int = 0) -> int:
        """Poll until interrupted (or `count` ticks). Returns 0."""
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
        return 0
