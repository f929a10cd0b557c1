"""The predict step.

Counterpart of ``strajnet_tpu/train/step.py::make_predict_step``. The train
and eval steps are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from strajnet_tpu_torch.objective.loss import WaypointGrids, split_pred_waypoints
from strajnet_tpu_torch.objective.metrics import (
    apply_sigmoid_to_occupancy_logits)

# The model casts its input rasters to its compute dtype itself, so compact
# uint8 / f16 feeds of these pass through unwidened.
_MODEL_RASTER_KEYS = ("ogm", "map_image")


def ensure_f32(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Widens compact-fed tensors to f32, except the model-input rasters."""
    return {k: (v.float() if (isinstance(v, torch.Tensor)
                              and v.dtype != torch.float32
                              and k not in _MODEL_RASTER_KEYS) else v)
            for k, v in batch.items()}


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor]):
    return model(ogm=batch["ogm"], map_img=batch["map_image"],
                 obs=batch["actors"], occ=batch["occl_actors"],
                 mapt=batch["centerlines"], flow=batch["vec_flow"])


def make_predict_step(num_waypoints: int = 8) -> Callable:
    """``predict_step(model, batch) -> WaypointGrids`` of post-sigmoid
    occupancies and raw flow, computed without autograd."""

    def predict_step(model: nn.Module,
                     batch: Dict[str, torch.Tensor]) -> WaypointGrids:
        with torch.inference_mode():
            outputs = _forward(model, ensure_f32(batch))
            logits = split_pred_waypoints(outputs, num_waypoints)
            return apply_sigmoid_to_occupancy_logits(logits)

    return predict_step
