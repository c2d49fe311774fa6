"""The elastic pod's autoscaling controller: watch, decide, actuate, record.

Counterpart of drep_tpu/autoscale/controller.py, run as ``python -m
drep_tpu_torch.autoscale <checkpoint_dir>``. A long-lived process beside
a RUNNING pod that the pod's members never know of:

- WATCH: each tick is one read-only snapshot of the pod's shared
  checkpoint dir (utils/hosttools.py::collect); the controller never
  writes a byte into the dir.
- DECIDE: the snapshot feeds the pure policy
  (:func:`drep_tpu_torch.autoscale.policy.decide`); the controller owns
  the clock and the history.
- ACTUATE: only through the pod protocol. A scale-up spawns the
  operator's ``--spawn`` command with ``DREP_TORCH_POD_JOIN=auto`` and
  ``DREP_TORCH_AUTOSCALE_SPAWNED=1`` in its environment (the joiner
  registers itself and the leader admits it; its churn is stamped as
  autoscale-driven). A scale-down SIGTERMs the newest live joiner the
  controller spawned itself (a graceful drain); processes it did not
  start are never touched.
- RECORD: each decision is one JSON line of the decision log
  (``autoscale.jsonl`` beside the checkpoint dir, never inside it; a
  whole line written and flushed, so a kill tears at most the last) and
  an ``autoscale_decision`` instant through utils/telemetry.py.

The controller is advisory: the members never wait on it, so killing it
at any instant leaves the pod to finish as it would have. That is why
the ``autoscale_decide`` fault site (fired at the top of each tick) may
take it down.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import time

from drep_tpu_torch.autoscale.fleet import append_decision
from drep_tpu_torch.autoscale.policy import Decision, Targets, decide
from drep_tpu_torch.parallel.faulttol import AUTOSCALE_SPAWNED_ENV, POD_JOIN_ENV
from drep_tpu_torch.utils import envknobs, faults, telemetry
from drep_tpu_torch.utils.hosttools import collect
from drep_tpu_torch.utils.logger import get_logger

__all__ = ["AutoscaleController", "AUTOSCALE_TELEMETRY_PID", "default_decision_log"]

# the pid the controller's own event stream is written under, far above
# any pod member's or joiner's, so events.p999.jsonl never collides with
# a member's log in the merged trace
AUTOSCALE_TELEMETRY_PID = 999


def default_decision_log(ckpt_dir: str) -> str:
    """``autoscale.jsonl`` in the checkpoint dir's parent: the controller
    writes nothing inside the dir."""
    return os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)), "autoscale.jsonl")


class AutoscaleController:
    """One watch/decide/actuate loop bound to one checkpoint dir.

    `targets` is the resolved :class:`Targets`; `spawn_cmd` the joiner's
    full command line (None: recommend-only, decisions are logged and
    traced and nothing spawns); `decision_log` defaults beside the dir;
    `interval_s` defaults to ``DREP_TORCH_AUTOSCALE_INTERVAL_S``.
    """

    # how long :meth:`run` goes on with nothing to govern (snapshot
    # errors, or no live member before the pod finished) before it exits
    IDLE_EXIT_S = 300.0

    def __init__(
        self,
        ckpt_dir: str,
        targets: Targets,
        spawn_cmd: str | None = None,
        interval_s: float | None = None,
        decision_log: str | None = None,
    ) -> None:
        self.ckpt_dir = ckpt_dir
        self.targets = targets
        self.spawn_cmd = spawn_cmd
        self.interval_s = (envknobs.env_float("DREP_TORCH_AUTOSCALE_INTERVAL_S") if interval_s is None
                           else float(interval_s))
        self.decision_log = default_decision_log(ckpt_dir) if decision_log is None else decision_log
        self.history: list[dict] = []
        self.spawned: list[subprocess.Popen] = []
        self.decisions = 0
        self._log = get_logger()
        self._last_warned: tuple | None = None

    # -- actuation --------------------------------------------------------
    def _spawn_joiners(self, count: int) -> str:
        if not self.spawn_cmd:
            return "skipped: no --spawn command (recommend-only mode)"
        # the policy clamped delta by targets.max_spawn already; clamping
        # again here keeps a hand-built decision from spawning past it
        count = min(count, self.targets.max_spawn)
        if count <= 0:
            return "skipped: max_spawn is 0"
        env = dict(os.environ)
        env[POD_JOIN_ENV] = "auto"
        env[AUTOSCALE_SPAWNED_ENV] = "1"
        argv = shlex.split(self.spawn_cmd)
        for _ in range(count):
            self.spawned.append(subprocess.Popen(argv, env=env))
        return f"spawned {count} joiner(s) (pids {[p.pid for p in self.spawned[-count:]]})"

    def _drain_joiners(self, count: int) -> str:
        alive = [p for p in self.spawned if p.poll() is None]
        if not alive:
            return "skipped: no controller-spawned capacity left to drain"
        victims = alive[-count:] if count else alive[-1:]
        for p in victims:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        return f"SIGTERMed joiner pid(s) {[p.pid for p in victims]} (graceful drain)"

    def _actuate(self, decision: Decision) -> str:
        try:
            if decision.verdict == "scale_up":
                return self._spawn_joiners(decision.delta)
            if decision.verdict == "scale_down":
                return self._drain_joiners(-decision.delta)
        except Exception as e:  # noqa: BLE001 — a broken --spawn is recorded in the decision log, not a crash
            self._log.warning("autoscale: actuation failed: %r", e)
            return f"FAILED: {e!r}"
        return ""

    # -- the loop ---------------------------------------------------------
    def poll_once(self) -> Decision:
        """One tick: snapshot, decide, actuate, record."""
        faults.fire("autoscale_decide")
        snapshot = collect(self.ckpt_dir)
        decision = decide(snapshot, self.targets, self.history)
        self.decisions += 1
        at = snapshot.get("observed_at")
        actuation = self._actuate(decision)
        # the cooldown history holds attempted scalings only: a skipped one
        # (recommend-only, nothing left to drain) must not re-arm the
        # cooldown, and holds never gate anything
        if at is not None and decision.verdict != "hold" and not actuation.startswith("skipped"):
            self.history.append({"at": at, "verdict": decision.verdict, "delta": decision.delta})
        record = {
            "at": at,
            "ckpt": os.path.abspath(self.ckpt_dir),
            "verdict": decision.verdict,
            "delta": decision.delta,
            "reason": decision.reason,
            "inputs": decision.inputs,
            "actuation": actuation,
        }
        try:
            append_decision(self.decision_log, record)
        except OSError as e:  # the log is observability, never a dependency
            self._log.warning("autoscale: decision log unwritable: %s", e)
        telemetry.event("autoscale_decision", verdict=decision.verdict, delta=decision.delta,
                        reason=decision.reason, **decision.inputs)
        if decision.verdict != "hold":
            sig = (decision.verdict, decision.reason, actuation)
            # a futile decision repeating every tick warns once
            if not (actuation.startswith("skipped") and sig == self._last_warned):
                self._log.warning("autoscale: %s %+d (%s) — %s", decision.verdict, decision.delta,
                                  decision.reason, actuation)
                self._last_warned = sig
        return decision

    def finished(self, decision: Decision) -> bool:
        """The pod ran to its end: every shard published and nobody live
        or working."""
        inputs = decision.inputs
        return (decision.reason in ("finished", "no-live-members") and bool(inputs.get("shards_total"))
                and inputs.get("shards_published", 0) >= inputs.get("shards_total", 0))

    def run(self, count: int = 0) -> int:
        """Tick until the pod finishes, `count` ticks pass (0: no limit), or
        nothing was governable for ``IDLE_EXIT_S``. Returns 0: a dying pod is
        a report, not a controller failure. Spawned joiners are left
        running: they are pod members."""
        n = 0
        idle_since = None
        try:
            while True:
                decision = self.poll_once()
                n += 1
                if count and n >= count:
                    break
                if self.finished(decision):
                    self._log.info("autoscale: pod finished after %d decision(s) — exiting", self.decisions)
                    break
                if decision.reason in ("snapshot-error", "no-live-members"):
                    mono = time.monotonic()
                    if idle_since is None:
                        idle_since = mono
                    elif mono - idle_since > self.IDLE_EXIT_S:
                        self._log.warning("autoscale: no governable pod for %.0fs (%s) — exiting (the controller "
                                          "is advisory; restart it with the pod)", self.IDLE_EXIT_S, decision.reason)
                        break
                else:
                    idle_since = None
                time.sleep(max(0.05, self.interval_s))
        except KeyboardInterrupt:
            pass
        finally:
            for p in self.spawned:
                if p.poll() is None:
                    self._log.info("autoscale: leaving spawned joiner pid %d running (it is a pod member; the pod "
                                   "owns its lifecycle)", p.pid)
        return 0
