"""Autoscaling as policy: the pure decision functions and the fleet
controller.

Counterpart of drep_tpu/autoscale/:

- :mod:`drep_tpu_torch.autoscale.policy`: ``decide`` (deadline and cost
  against capacity) and ``maintenance_decide`` (split or compact an
  index's partitions), pure functions;
- :mod:`drep_tpu_torch.autoscale.fleet`: ``decide_fleet``, the same
  policy over a serve router's per-range queue depths, and the
  recommend-only :class:`FleetAutoscaleController`
  (``python -m drep_tpu_torch.autoscale --router ADDR``).

Not ported: the elastic pod's ``AutoscaleController`` (it reads a pod's
checkpoint dir; ROADMAP.md queue 1 item 12b) and the fleet's actuation
through the supervisor (item 11c).
"""

from drep_tpu_torch.autoscale.fleet import FleetAutoscaleController, decide_fleet
from drep_tpu_torch.autoscale.policy import Decision, MaintenanceTargets, Targets, decide, maintenance_decide

__all__ = [
    "Decision",
    "FleetAutoscaleController",
    "MaintenanceTargets",
    "Targets",
    "decide",
    "decide_fleet",
    "maintenance_decide",
]
