"""Output activations of the predicted waypoint grids.

Counterpart of ``strajnet_tpu/objective/metrics.py::
apply_sigmoid_to_occupancy_logits``. The challenge metrics are still to be
ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from strajnet_tpu_torch.objective.loss import WaypointGrids


def apply_sigmoid_to_occupancy_logits(
        pred_logits: WaypointGrids) -> WaypointGrids:
    """Occupancy logits -> probabilities (f32); flow passes through."""
    return WaypointGrids(
        observed_occupancy=torch.sigmoid(
            pred_logits.observed_occupancy.float()),
        occluded_occupancy=torch.sigmoid(
            pred_logits.occluded_occupancy.float()),
        flow=pred_logits.flow,
        flow_origin_occupancy=pred_logits.flow_origin_occupancy,
    )
