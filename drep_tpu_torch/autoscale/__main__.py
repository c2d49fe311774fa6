"""``python -m drep_tpu_torch.autoscale --router ADDR``: the fleet
autoscale controller, recommend-only.

The port's counterpart of ``tools/pod_autoscale.py --router``, with the
same flags. Each tick reads the router's status, runs the pure policy per
partition range and appends one JSON line a range to ``--decision_log``;
with ``--log_dir`` and ``DREP_TORCH_EVENTS=on`` each decision is also a
``fleet_autoscale_decision`` instant. Knobs:
``DREP_TORCH_AUTOSCALE_INTERVAL_S``, ``_COOLDOWN_S``, ``_MAX_SPAWN``.

Refused before anything is read: batch mode (a ``checkpoint_dir``: the
elastic pod's controller, ROADMAP.md queue 1 item 12b), and ``--spawn`` /
``--fleet_dir`` (actuation through the fleet supervisor, item 11c).
"""

from __future__ import annotations

import argparse
import sys

from drep_tpu_torch.utils import envknobs, telemetry

# the pid the controller's own event stream is written under, beside a
# pod's members (the JAX package's)
AUTOSCALE_TELEMETRY_PID = 999


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m drep_tpu_torch.autoscale",
                                 description="Fleet autoscaling controller (recommend-only) for an `index route` router")
    ap.add_argument("checkpoint_dir", nargs="?", default=None,
                    help="batch mode (an elastic pod's checkpoint dir): not ported yet (item 12b)")
    ap.add_argument("--router", default=None, metavar="ADDR",
                    help="the `index route` front door (host:port or socket path) whose fleet to govern")
    ap.add_argument("--fleet_dir", default=None, metavar="DIR",
                    help="the fleet supervisor's manifest home: not ported yet (item 11c)")
    ap.add_argument("--queue_deadline_s", type=float, default=5.0,
                    help="rolling queueing-delay target per partition range")
    ap.add_argument("--svc_s", type=float, default=0.2,
                    help="assumed per-query service time of the drain projection (queue_total * svc_s / n_live)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="batch mode's finish-by target (not used in fleet mode)")
    ap.add_argument("--cost", type=float, default=None, metavar="PROC_SECONDS",
                    help="proc-seconds budget of the projected queue drain")
    ap.add_argument("--min_procs", type=int, default=1)
    ap.add_argument("--max_procs", type=int, default=8)
    ap.add_argument("--interval", type=float, default=None, metavar="SECONDS",
                    help="seconds between ticks (default DREP_TORCH_AUTOSCALE_INTERVAL_S where set, else 2)")
    ap.add_argument("--cooldown", type=float, default=None, metavar="SECONDS",
                    help="minimum spacing of scaling decisions (default DREP_TORCH_AUTOSCALE_COOLDOWN_S)")
    ap.add_argument("--max_spawn", type=int, default=None,
                    help="replicas per scale-up decision (default DREP_TORCH_AUTOSCALE_MAX_SPAWN)")
    ap.add_argument("--hysteresis", type=float, default=0.1, help="dead-band fraction around the deadline")
    ap.add_argument("--spawn", default=None, metavar="CMD",
                    help="the replica command line: actuation is not ported yet (item 11c)")
    ap.add_argument("--decision_log", default=None, help="decision JSONL path (one line a range a tick)")
    ap.add_argument("--log_dir", default=None,
                    help="event log dir for fleet_autoscale_decision instants, gated by DREP_TORCH_EVENTS")
    ap.add_argument("--count", type=int, default=0, help="stop after N ticks (0 = until interrupted)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from drep_tpu_torch.autoscale.fleet import FleetAutoscaleController, refuse_actuation
    from drep_tpu_torch.autoscale.policy import Targets

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.router and args.checkpoint_dir:
        ap.error("--router (fleet mode) and checkpoint_dir are exclusive")
    if args.checkpoint_dir:
        raise NotImplementedError(
            f"autoscale batch mode ({args.checkpoint_dir}): the elastic pod's controller is not ported yet "
            f"(ROADMAP.md queue 1, item 12b); pass --router ADDR"
        )
    if not args.router:
        ap.error("need --router ADDR (fleet mode)")
    refuse_actuation(spawn_cmd=args.spawn, fleet_dir=args.fleet_dir)
    from drep_tpu_torch.serve import ServeClient

    cooldown = envknobs.env_float("DREP_TORCH_AUTOSCALE_COOLDOWN_S") if args.cooldown is None else args.cooldown
    max_spawn = envknobs.env_int("DREP_TORCH_AUTOSCALE_MAX_SPAWN") if args.max_spawn is None else args.max_spawn
    # fleet mode ticks every 2 s unless the knob is set (the knob's own
    # default, 5 s, is the elastic pod controller's)
    interval = (envknobs.env_float("DREP_TORCH_AUTOSCALE_INTERVAL_S", default=2.0)
                if args.interval is None else args.interval)
    if args.log_dir:
        telemetry.configure(log_dir=args.log_dir, pid=AUTOSCALE_TELEMETRY_PID)
    # the rolling deadline is rebuilt every tick from --queue_deadline_s
    targets = Targets(deadline_at=None, cost_proc_s=args.cost, min_procs=args.min_procs, max_procs=args.max_procs,
                      cooldown_s=cooldown, hysteresis=args.hysteresis, max_spawn=max_spawn)
    controller = FleetAutoscaleController(
        ServeClient(args.router), targets, queue_deadline_s=args.queue_deadline_s, svc_s=args.svc_s,
        interval_s=interval, decision_log=args.decision_log,
    )
    try:
        return controller.run(count=args.count)
    finally:
        telemetry.close()


if __name__ == "__main__":
    sys.exit(main())
