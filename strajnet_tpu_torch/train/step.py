"""Train and predict steps.

Counterpart of ``strajnet_tpu/train/step.py`` (``make_train_step``,
``make_predict_step``). PyTorch runs eagerly, so a step is a plain function:
there is no jit and nothing to donate. The eval step is still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from strajnet_tpu_torch.config import LossConfig, TaskConfig
from strajnet_tpu_torch.objective.loss import (OGMFlowLoss, WaypointGrids,
                                               split_pred_waypoints,
                                               true_waypoints_from_batch)
from strajnet_tpu_torch.objective.metrics import (
    apply_sigmoid_to_occupancy_logits)

# The model casts its input rasters to its compute dtype itself, so compact
# uint8 / f16 feeds of these pass through unwidened.
_MODEL_RASTER_KEYS = ("ogm", "map_image")

LOSS_KEYS = ("observed_xe", "occluded_xe", "flow", "flow_warp_xe", "total")


def ensure_f32(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Widens compact-fed tensors to f32, except the model-input rasters."""
    return {k: (v.float() if (isinstance(v, torch.Tensor)
                              and v.dtype != torch.float32
                              and k not in _MODEL_RASTER_KEYS) else v)
            for k, v in batch.items()}


def _forward(model: nn.Module, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
    return model(ogm=batch["ogm"], map_img=batch["map_image"],
                 obs=batch["actors"], occ=batch["occl_actors"],
                 mapt=batch["centerlines"], flow=batch["vec_flow"],
                 generator=generator)


def zero_loss_sums(device=None) -> Dict[str, torch.Tensor]:
    """Initial device-resident loss accumulator for the accumulating step."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in LOSS_KEYS}


def make_train_step(task_cfg: TaskConfig, loss_cfg: LossConfig,
                    num_waypoints: int = 8,
                    accumulate: bool = False) -> Callable:
    """The train step: forward, ``ogmflow_loss``, backward, one Nadam update.

    With ``accumulate=False`` (default): ``step(state, batch, generator) ->
    (state, loss_dict)``. With ``accumulate=True``: ``step(state, batch,
    generator, loss_sums) -> (state, loss_sums + losses)``; the running sums
    stay on the device. Neither forces a host sync: the losses come back as
    device scalars. ``state`` is a :class:`~strajnet_tpu_torch.train.state.
    TrainState`; its model and optimizer are updated in place. The model runs
    in the mode it is in: ``model.train()`` draws dropout and drop-path noise
    from ``generator`` (on the model's device), ``model.eval()`` switches the
    random parts off. The gradients of the step stay in ``p.grad``.
    """
    loss_fn = OGMFlowLoss(task_cfg, loss_cfg)

    def _step_math(state, batch, generator):
        batch = ensure_f32(batch)
        true_waypoints = true_waypoints_from_batch(batch)
        state.optimizer.zero_grad(set_to_none=True)
        outputs = _forward(state.model, batch, generator)
        logits = split_pred_waypoints(outputs, num_waypoints)
        loss_dict = loss_fn(true_waypoints, logits)
        total = (loss_dict["observed_xe"] + loss_dict["occluded_xe"]
                 + loss_dict["flow"] + loss_dict["flow_warp_xe"])
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach()
                       for k, v in dict(loss_dict, total=total).items()}

    if accumulate:
        def train_step(state, batch, generator, loss_sums):
            state, loss_dict = _step_math(state, batch, generator)
            return state, {k: loss_sums[k] + loss_dict[k] for k in loss_sums}

        return train_step

    def train_step(state, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        return _step_math(state, batch, generator)

    return train_step


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
