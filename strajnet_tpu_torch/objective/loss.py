"""Waypoint grids and the slicing of model outputs.

Counterpart of the first part of ``strajnet_tpu/objective/loss.py``
(``WaypointGrids``, ``split_pred_waypoints``). The loss terms are still to be
ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WaypointGrids(NamedTuple):
    """Stacked per-waypoint grids, the waypoint axis after the batch."""

    observed_occupancy: torch.Tensor     # [B, T, H, W, 1]
    occluded_occupancy: torch.Tensor     # [B, T, H, W, 1]
    flow: torch.Tensor                   # [B, T, H, W, 2]
    flow_origin_occupancy: torch.Tensor  # [B, T, H, W, 1] (ground truth only)


def split_pred_waypoints(model_outputs: torch.Tensor,
                         num_waypoints: int = 8) -> WaypointGrids:
    """Slices [B, H, W, T*4] waypoint-major logits into [B, T, H, W, c]."""
    b, h, w, _ = model_outputs.shape
    x = model_outputs.reshape(b, h, w, num_waypoints, 4).permute(0, 3, 1, 2, 4)
    return WaypointGrids(
        observed_occupancy=x[..., 0:1],
        occluded_occupancy=x[..., 1:2],
        flow=x[..., 2:4],
        flow_origin_occupancy=torch.zeros_like(x[..., 0:1]),
    )
