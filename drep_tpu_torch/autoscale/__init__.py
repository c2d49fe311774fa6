"""Autoscaling as policy: the pure decision functions and the two
controllers.

Counterpart of drep_tpu/autoscale/:

- :mod:`drep_tpu_torch.autoscale.policy`: ``decide`` (deadline and cost
  against capacity) and ``maintenance_decide`` (split or compact an
  index's partitions), pure functions;
- :mod:`drep_tpu_torch.autoscale.controller`: the elastic pod's
  :class:`AutoscaleController`, which watches a running pod's checkpoint
  dir and spawns or drains joiners through the pod protocol (``python -m
  drep_tpu_torch.autoscale CHECKPOINT_DIR [--deadline S --spawn CMD]``);
- :mod:`drep_tpu_torch.autoscale.fleet`: ``decide_fleet``, the same
  policy over a serve router's per-range queue depths, and the
  :class:`FleetAutoscaleController`, which acts through the fleet
  supervisor (``python -m drep_tpu_torch.autoscale --router ADDR
  [--spawn CMD --fleet_dir DIR]``).
"""

from drep_tpu_torch.autoscale.controller import AutoscaleController
from drep_tpu_torch.autoscale.fleet import FleetAutoscaleController, decide_fleet
from drep_tpu_torch.autoscale.policy import Decision, MaintenanceTargets, Targets, decide, maintenance_decide

__all__ = [
    "AutoscaleController",
    "Decision",
    "FleetAutoscaleController",
    "MaintenanceTargets",
    "Targets",
    "decide",
    "decide_fleet",
    "maintenance_decide",
]
