"""The deadline-driven scaling policy and the maintenance scheduler: pure
decision functions.

Counterpart of drep_tpu/autoscale/policy.py, the same functions with the
same verdicts and reason slugs. ``decide(snapshot, targets, history)``
reads no clock, no environment and no file: the only "now" is the
snapshot's ``observed_at``, and everything the verdict depends on rides
in the three arguments, so a decision replays from its log.

Model (documented proxies):

- ETA: the snapshot's ``eta_s``. Work is assumed to scale about linearly
  with the live process count, so the capacity a deadline needs is
  ``ceil(n_live * eta / remaining)``.
- cost: proc-seconds of the remaining work, ``n_live * eta``.

Stability: hysteresis (scale up only past ``eta > remaining*(1+h)``,
down only when the shrunk projection is under ``remaining*(1-h)``), a
cooldown between scaling decisions judged on the snapshot clock, and
clamps (``max_procs`` above, ``min_procs`` as the scale-down floor,
``max_spawn`` a decision; 0 = decide but never spawn).

``maintenance_decide`` is the index maintenance scheduler over
``index.maintenance.maintenance_snapshot``: split the most skewed
partition past its budget, compact the most sprawled one, or hold.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = [
    "Targets", "Decision", "decide",
    "MaintenanceTargets", "maintenance_decide",
]


@dataclass(frozen=True)
class Targets:
    """The operator's goal, resolved once at controller start.

    ``deadline_at`` is an ABSOLUTE wall-clock instant (same clock family
    as the snapshot's ``observed_at`` — the controller derives it from
    ``--deadline`` seconds at startup); None = no deadline (the policy
    never scales up). ``cost_proc_s`` is the proc-seconds budget for the
    remaining work; None = capacity is free (the policy never scales
    down below what the deadline needs)."""

    deadline_at: float | None = None
    cost_proc_s: float | None = None
    min_procs: int = 1
    max_procs: int = 8
    cooldown_s: float = 30.0
    hysteresis: float = 0.1
    max_spawn: int = 1


@dataclass(frozen=True)
class Decision:
    """One policy verdict: ``scale_up`` (spawn `delta` joiners),
    ``scale_down`` (drain `-delta` members), or ``hold``. `reason` is a
    stable machine-readable slug (tests pin them); `inputs` records the
    numbers the verdict was derived from — the decision log and the
    ``autoscale_decision`` telemetry instant carry both, so every scaling
    event is auditable after the fact."""

    verdict: str  # "scale_up" | "scale_down" | "hold"
    delta: int
    reason: str
    inputs: dict = field(default_factory=dict)


def _hold(reason: str, inputs: dict) -> Decision:
    return Decision(verdict="hold", delta=0, reason=reason, inputs=inputs)


def decide(snapshot: dict, targets: Targets, history: list[dict]) -> Decision:
    """One pure decision from one read-only pod snapshot.

    `snapshot` is a pod status dict (``observed_at``, ``live``,
    ``pending_joins``, ``shards_published``/``shards_total``, ``eta_s``,
    ...), or the per-range snapshot ``autoscale.fleet`` maps a router's
    status onto. `history` is the controller's ordered decision
    record: dicts with at least ``at`` (the snapshot clock when decided),
    ``verdict`` and ``delta`` — only non-hold entries gate the cooldown.
    """
    if "error" in snapshot:
        return _hold("snapshot-error", {"error": snapshot["error"]})
    now = float(snapshot["observed_at"])
    live = list(snapshot.get("live", ()))
    pending = list(snapshot.get("pending_joins", ()))
    n_live = len(live)
    capacity = n_live + len(pending)
    done = int(snapshot.get("shards_published") or 0)
    total = snapshot.get("shards_total")
    eta = snapshot.get("eta_s")
    inputs: dict = {
        "n_live": n_live,
        "pending_joins": len(pending),
        "shards_published": done,
        "shards_total": total,
        "eta_s": eta,
    }
    if targets.deadline_at is not None:
        inputs["remaining_s"] = round(targets.deadline_at - now, 3)
    if eta is not None and n_live:
        inputs["projected_cost_proc_s"] = round(n_live * float(eta), 3)

    if not n_live:
        # nothing to govern: the pod has not started, or every member is
        # finished/gone — actuating against ghosts helps nobody
        return _hold("no-live-members", inputs)
    if total is not None and done >= int(total):
        return _hold("finished", inputs)
    if targets.deadline_at is None and targets.cost_proc_s is None:
        return _hold("no-targets", inputs)

    # cooldown: the last SCALING decision must age out before another —
    # a spawned joiner needs interpreter startup + admission before it
    # shows in the snapshot, and piling on during that window overshoots
    for past in reversed(history):
        if past.get("verdict") in ("scale_up", "scale_down"):
            age = now - float(past.get("at", now))
            if age < targets.cooldown_s:
                inputs["cooldown_remaining_s"] = round(
                    targets.cooldown_s - age, 3
                )
                return _hold("cooldown", inputs)
            break

    h = max(0.0, float(targets.hysteresis))
    remaining = (
        targets.deadline_at - now if targets.deadline_at is not None else None
    )

    # -- scale UP: the deadline projection misses --------------------------
    if remaining is not None:
        if eta is None and remaining > 0:
            # too little publish-rate signal for an ETA (first shards
            # still landing) and the deadline still holds: scaling on no
            # evidence would thrash. A BLOWN deadline needs no ETA — any
            # live pod with work left wants max capacity (below).
            return _hold("warming", inputs)
        miss = (
            float(eta) > remaining * (1.0 + h) if remaining > 0 else True
        )
        if miss:
            if capacity >= targets.max_procs:
                return _hold("at-max-procs", inputs)
            if remaining > 0:
                needed = math.ceil(n_live * float(eta) / remaining)
            else:
                needed = targets.max_procs  # deadline already blown: all in
            inputs["needed_procs"] = needed
            if capacity >= needed:
                # pending joins already cover the projection (the ETA is
                # measured on the CURRENT live set — admitted capacity
                # has not moved it yet): spawning more would pile on
                return _hold("pending-covers", inputs)
            delta = min(
                needed - capacity,
                targets.max_spawn,
                targets.max_procs - capacity,
            )
            if delta <= 0:
                # max_spawn 0 is "decide but never spawn" (recommend-only
                # clamping): record the miss without commanding an
                # actuation the clamp forbids
                return _hold("spawn-clamped", inputs)
            return Decision(
                verdict="scale_up", delta=int(delta),
                reason="eta-misses-deadline" if remaining > 0 else "deadline-passed",
                inputs=inputs,
            )

    # -- scale DOWN: cost pressure with deadline headroom ------------------
    # the floor is max(min_procs, 1): a pod cannot shrink below one live
    # member (and the shrunk-eta projection would divide by zero at 1)
    if targets.cost_proc_s is not None and n_live > max(targets.min_procs, 1):
        if eta is None:
            return _hold("warming", inputs)
        over_cost = n_live * float(eta) > targets.cost_proc_s
        # shedding one proc must not bust the deadline (with the same
        # hysteresis margin the scale-up side honors — the dead band)
        shrunk_eta = float(eta) * n_live / (n_live - 1)
        fits = remaining is None or shrunk_eta < remaining * (1.0 - h)
        if over_cost and fits:
            return Decision(
                verdict="scale_down", delta=-1,
                reason="cost-over-budget", inputs=inputs,
            )

    return _hold(
        "deadline-met" if remaining is not None else "within-cost", inputs
    )


# ---------------------------------------------------------------------------
# the maintenance scheduler: split/compaction in idle windows
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MaintenanceTargets:
    """The operator's index-maintenance envelope (same contract as
    ``Targets``: resolved once, outside the pure function — the env-knob
    reader lives in ``index.maintenance.maintenance_targets_from_env``).

    ``split_max_genomes`` is the skew budget: a partition past it is
    proposed for `index split` (0 = never — splits stay operator-
    initiated). ``compact_min_shards`` is the generation-sprawl budget:
    a partition holding at least this many sketch/edge shard-family
    generations is proposed for `index compact`. ``idle_qps`` bounds
    when maintenance may run at all — a loaded serving tier holds
    (maintenance commits are ordinary hot-swaps, but the child-store
    rebuild competes for the same cores). ``cooldown_s`` spaces
    successive maintenance proposals the way scaling cooldown spaces
    spawns: one transaction must land and age before the next."""

    compact_min_shards: int = 4
    split_max_genomes: int = 0
    idle_qps: float = 1.0
    cooldown_s: float = 300.0


def maintenance_decide(
    snapshot: dict, targets: MaintenanceTargets, history: list[dict]
) -> Decision:
    """One pure maintenance verdict over one read-only index snapshot
    (``index.maintenance.maintenance_snapshot``): ``split`` the most
    skewed over-budget partition, ``compact`` the most sprawled one, or
    ``hold``. Split outranks compaction — skew is the load/residency
    hazard the ROADMAP names first, and a split folds the parent's
    generations into its children anyway (a split IS a compaction of
    the hot range). The chosen pid rides ``inputs["pid"]``; verdict
    ``delta`` is 0 (maintenance moves data, not capacity)."""
    if "error" in snapshot:
        return _hold("snapshot-error", {"error": snapshot["error"]})
    now = float(snapshot["observed_at"])
    parts = list(snapshot.get("partitions", ()))
    qps = snapshot.get("qps")
    inputs: dict = {
        "n_partitions": len(parts),
        "generation": snapshot.get("generation"),
        "qps": qps,
    }
    if not parts:
        return _hold("not-federated", inputs)
    if snapshot.get("maintenance_pending"):
        # an interrupted transaction converges through roll_forward on
        # the next maintenance pass — never propose new work over it
        return _hold("maintenance-pending", inputs)
    if qps is not None and float(qps) > targets.idle_qps:
        return _hold("busy-traffic", inputs)
    for past in reversed(history):
        if past.get("verdict") in ("split", "compact"):
            age = now - float(past.get("at", now))
            if age < targets.cooldown_s:
                inputs["cooldown_remaining_s"] = round(
                    targets.cooldown_s - age, 3
                )
                return _hold("cooldown", inputs)
            break
    if any(int(p.get("generations", 0)) < 0 for p in parts):
        # an unreadable partition manifest: maintenance would rewrite
        # the range map over a store it cannot see — hold for the heal
        return _hold("partition-unreadable", inputs)

    if targets.split_max_genomes > 0:
        fat = max(parts, key=lambda p: int(p["n_genomes"]))
        if int(fat["n_genomes"]) > targets.split_max_genomes:
            inputs["pid"] = int(fat["pid"])
            inputs["n_genomes"] = int(fat["n_genomes"])
            return Decision(
                verdict="split", delta=0,
                reason="partition-over-split-budget", inputs=inputs,
            )

    floor = max(2, int(targets.compact_min_shards))
    sprawled = max(parts, key=lambda p: int(p.get("generations", 0)))
    if int(sprawled.get("generations", 0)) >= floor:
        inputs["pid"] = int(sprawled["pid"])
        inputs["generations"] = int(sprawled["generations"])
        return Decision(
            verdict="compact", delta=0,
            reason="shards-over-budget", inputs=inputs,
        )

    return _hold("healthy", inputs)
