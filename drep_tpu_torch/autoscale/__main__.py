"""``python -m drep_tpu_torch.autoscale``: the autoscaling controllers.

The port's counterpart of ``tools/pod_autoscale.py``, with the same flags
and the same two modes.

Batch mode, ``python -m drep_tpu_torch.autoscale CHECKPOINT_DIR``,
governs a running elastic pod (autoscale/controller.py): each tick reads
the pod's shared checkpoint dir (read-only), runs the pure policy against
``--deadline`` (seconds from the controller's start, on the wall clock)
and ``--cost``, spawns ``--spawn`` as a joiner on a scale-up
(``DREP_TORCH_POD_JOIN=auto``, at most ``--max_spawn`` a decision) or
SIGTERMs a joiner it spawned on a scale-down, and appends one JSON line
to ``--decision_log`` (default ``autoscale.jsonl`` beside the dir); with
``--log_dir`` and ``DREP_TORCH_EVENTS=on`` each decision is also an
``autoscale_decision`` instant in ``events.p999.jsonl``. It exits once
the pod has finished. Without ``--spawn`` it only recommends.

Fleet mode, ``--router ADDR``, governs an `index route` fleet. Each
tick runs the embedded supervisor's heartbeat (with ``--fleet_dir``),
reads the router's status, runs the pure policy per
partition range, places or drains replicas through the supervisor (with
``--spawn`` and ``--fleet_dir``; without them it only recommends) and
appends one JSON line a range to ``--decision_log``; with ``--log_dir``
and ``DREP_TORCH_EVENTS=on`` each decision is also a
``fleet_autoscale_decision`` instant.

Knobs: ``DREP_TORCH_AUTOSCALE_INTERVAL_S`` (batch mode's default tick;
fleet mode ticks every 2 s where it is unset), ``_COOLDOWN_S``,
``_MAX_SPAWN``.
"""

from __future__ import annotations

import argparse
import sys
import time

from drep_tpu_torch.autoscale.controller import AUTOSCALE_TELEMETRY_PID
from drep_tpu_torch.utils import envknobs, telemetry


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m drep_tpu_torch.autoscale",
                                 description="Autoscaling controller for a running elastic pod (batch mode) or an "
                                             "`index route` fleet (--router)")
    ap.add_argument("checkpoint_dir", nargs="?", default=None,
                    help="batch mode: the running pod's shared checkpoint dir (e.g. <wd>/data/streaming_primary); "
                         "omit in --router fleet mode")
    ap.add_argument("--router", default=None, metavar="ADDR",
                    help="fleet mode: the `index route` front door (host:port or socket path) whose fleet to govern")
    ap.add_argument("--fleet_dir", default=None, metavar="DIR",
                    help="home of the durable fleet.json manifest (the embedded supervisor's memory: "
                         "spawn and drain are manifest transactions, and a restarted controller adopts its "
                         "predecessor's replicas from it). Required with --spawn")
    ap.add_argument("--queue_deadline_s", type=float, default=5.0,
                    help="rolling queueing-delay target per partition range")
    ap.add_argument("--svc_s", type=float, default=0.2,
                    help="assumed per-query service time of the drain projection (queue_total * svc_s / n_live)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="batch mode: finish-by target, seconds from the controller's start; the policy scales up "
                         "when the publish-rate ETA projects past it")
    ap.add_argument("--cost", type=float, default=None, metavar="PROC_SECONDS",
                    help="proc-seconds budget of the remaining work (batch mode) or of the projected queue drain "
                         "(fleet mode)")
    ap.add_argument("--min_procs", type=int, default=1)
    ap.add_argument("--max_procs", type=int, default=8)
    ap.add_argument("--interval", type=float, default=None, metavar="SECONDS",
                    help="seconds between ticks (default DREP_TORCH_AUTOSCALE_INTERVAL_S; in fleet mode 2 where "
                         "it is unset)")
    ap.add_argument("--cooldown", type=float, default=None, metavar="SECONDS",
                    help="minimum spacing of scaling decisions (default DREP_TORCH_AUTOSCALE_COOLDOWN_S)")
    ap.add_argument("--max_spawn", type=int, default=None,
                    help="joiners (batch mode) or replicas (fleet mode) per scale-up decision "
                         "(default DREP_TORCH_AUTOSCALE_MAX_SPAWN)")
    ap.add_argument("--hysteresis", type=float, default=0.1, help="dead-band fraction around the deadline")
    ap.add_argument("--spawn", default=None, metavar="CMD",
                    help="batch mode: the joiner's full command line, spawned with DREP_TORCH_POD_JOIN=auto; "
                         "fleet mode: the `index serve` command line of one replica ('{partitions}' becomes "
                         "the range's comma list); omit for recommend-only mode")
    ap.add_argument("--decision_log", default=None,
                    help="decision JSONL path (batch mode: one line a tick, default autoscale.jsonl beside the "
                         "checkpoint dir, never inside it; fleet mode: one line a range a tick)")
    ap.add_argument("--log_dir", default=None,
                    help="event log dir (the pod's <wd>/log) for autoscale_decision or fleet_autoscale_decision "
                         "instants, gated by DREP_TORCH_EVENTS")
    ap.add_argument("--count", type=int, default=0,
                    help="stop after N ticks (0: until the pod finishes, or until interrupted in fleet mode)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from drep_tpu_torch.autoscale.controller import AutoscaleController
    from drep_tpu_torch.autoscale.fleet import FleetAutoscaleController
    from drep_tpu_torch.autoscale.policy import Targets

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.router and args.checkpoint_dir:
        ap.error("--router (fleet mode) and checkpoint_dir are exclusive")
    if not args.router and not args.checkpoint_dir:
        ap.error("need a checkpoint_dir (batch mode) or --router (fleet mode)")
    if args.router and args.spawn and not args.fleet_dir:
        ap.error("--spawn in fleet mode needs --fleet_dir (actuation is a fleet.json manifest transaction)")
    cooldown = envknobs.env_float("DREP_TORCH_AUTOSCALE_COOLDOWN_S") if args.cooldown is None else args.cooldown
    max_spawn = envknobs.env_int("DREP_TORCH_AUTOSCALE_MAX_SPAWN") if args.max_spawn is None else args.max_spawn
    # batch mode's deadline is compared with the snapshots' observed_at, the
    # wall clock, as the pod's note mtimes are; fleet mode rebuilds a
    # rolling one every tick from --queue_deadline_s
    deadline_at = time.time() + args.deadline if args.checkpoint_dir and args.deadline is not None else None
    targets = Targets(deadline_at=deadline_at, cost_proc_s=args.cost, min_procs=args.min_procs,
                      max_procs=args.max_procs, cooldown_s=cooldown, hysteresis=args.hysteresis, max_spawn=max_spawn)
    if args.log_dir:
        telemetry.configure(log_dir=args.log_dir, pid=AUTOSCALE_TELEMETRY_PID)
    try:
        if args.checkpoint_dir:
            controller = AutoscaleController(args.checkpoint_dir, targets, spawn_cmd=args.spawn,
                                             interval_s=args.interval, decision_log=args.decision_log)
        else:
            from drep_tpu_torch.serve import ServeClient

            # fleet mode ticks every 2 s unless the knob is set (the knob's
            # own default, 5 s, is the pod controller's)
            interval = (envknobs.env_float("DREP_TORCH_AUTOSCALE_INTERVAL_S", default=2.0)
                        if args.interval is None else args.interval)
            controller = FleetAutoscaleController(
                ServeClient(args.router), targets, queue_deadline_s=args.queue_deadline_s, svc_s=args.svc_s,
                spawn_cmd=args.spawn, interval_s=interval, decision_log=args.decision_log, fleet_dir=args.fleet_dir,
            )
        return controller.run(count=args.count)
    finally:
        telemetry.close()


if __name__ == "__main__":
    sys.exit(main())
