"""Train, eval and predict steps.

Counterpart of ``strajnet_tpu/train/step.py`` (``make_train_step``,
``make_eval_step``, ``make_predict_step``). PyTorch runs eagerly, so a step
is a plain function: there is no jit and nothing to donate.

Under data parallelism (``parallel/ddp.py``, world size above 1 when the
step is made) the loss and the metrics are those of the global batch: each
rank's loss terms are its shares of the global batch's (they sum to it over
the ranks), the model's DDP wrapper sums the shares' gradients, and the
metrics come back alike on every rank. At world size 1 nothing changes and
no collective runs. Under a ``('data', 'model')`` mesh (``parallel/mesh.py``)
the shares and the sums are over the ``'data'`` axis: the peers along
``'model'`` hold the same rows and compute the same losses. There each step
first checks once that the ranks along ``'data'`` hold alike many rows
(``parallel/mesh.py::check_rows``: the kernels run on this rank's rows and
refuse uneven ones), and the train step gives the replicated parameters'
gradients model-rank 0's values before the update
(``parallel/mesh.py::align_replicated_grads``), so that the peers' copies
stay bit-equal.

The train and predict steps mark their phases with ``tracing.span``
(``strajnet.train_step``: ``strajnet.forward``, ``strajnet.loss``,
``strajnet.backward``, ``strajnet.optimizer``; ``strajnet.predict_step``:
``strajnet.forward``), which records them only while a ``torch.profiler``
runs.
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
    apply_sigmoid_to_occupancy_logits, compute_occupancy_flow_metrics)
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.parallel.ddp import data_size, sum_over_ranks
from strajnet_tpu_torch.tracing import span

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


def _total(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (loss_dict["observed_xe"] + loss_dict["occluded_xe"]
            + loss_dict["flow"] + loss_dict["flow_warp_xe"])


def _ranks_reduce_sum():
    """The loss's and metrics' ``reduce_sum`` of this process: a sum over
    the ranks of the ``'data'`` axis where it has several, else None."""
    return sum_over_ranks if data_size() > 1 else None


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
    device scalars (under data parallelism: this rank's shares of the global
    batch's losses). ``state`` is a :class:`~strajnet_tpu_torch.train.state.
    TrainState`; its model and optimizer are updated in place. The model runs
    in the mode it is in: ``model.train()`` draws dropout and drop-path noise
    from ``generator`` (on the model's device), ``model.eval()`` switches the
    random parts off. The gradients of the step stay in ``p.grad``.
    """
    loss_fn = OGMFlowLoss(task_cfg, loss_cfg, reduce_sum=_ranks_reduce_sum())

    def _step_math(state, batch, generator):
        with span("strajnet.train_step"):
            tp.check_rows(len(batch["ogm"]))
            batch = ensure_f32(batch)
            true_waypoints = true_waypoints_from_batch(batch)
            state.optimizer.zero_grad(set_to_none=True)
            with span("strajnet.forward"):
                outputs = _forward(state.model, batch, generator)
            with span("strajnet.loss"):
                logits = split_pred_waypoints(outputs, num_waypoints)
                loss_dict = loss_fn(true_waypoints, logits)
                total = _total(loss_dict)
            with span("strajnet.backward"):
                total.backward()
            with span("strajnet.optimizer"):
                tp.align_replicated_grads(state.model)
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


def make_eval_step(task_cfg: TaskConfig, loss_cfg: LossConfig,
                   num_waypoints: int = 8, no_warp: bool = False) -> Callable:
    """``eval_step(model, batch) -> (loss_dict with "total", metrics)``.

    The forward, ``ogmflow_loss`` and the challenge metrics, computed without
    autograd on a model in ``eval()`` mode (a model in training mode raises:
    its dropout would need a generator). Both dicts hold device scalars.
    ``no_warp`` leaves the flow-grounded metrics out; the loss is the
    training loss either way. Under data parallelism the losses are this
    rank's shares and the metrics those of the global batch.
    """
    reduce_sum = _ranks_reduce_sum()
    loss_fn = OGMFlowLoss(task_cfg, loss_cfg, reduce_sum=reduce_sum)

    def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]):
        if model.training:
            raise ValueError("eval_step needs the model in eval() mode")
        tp.check_rows(len(batch["ogm"]))
        with torch.inference_mode():
            batch = ensure_f32(batch)
            true_waypoints = true_waypoints_from_batch(batch)
            logits = split_pred_waypoints(_forward(model, batch),
                                          num_waypoints)
            loss_dict = loss_fn(true_waypoints, logits)
            total = _total(loss_dict)
            metrics = compute_occupancy_flow_metrics(
                true_waypoints, apply_sigmoid_to_occupancy_logits(logits),
                no_warp=no_warp, reduce_sum=reduce_sum)
        return dict(loss_dict, total=total), metrics

    return eval_step


def make_predict_step(num_waypoints: int = 8) -> Callable:
    """``predict_step(model, batch) -> WaypointGrids`` of post-sigmoid
    occupancies and raw flow, computed without autograd."""

    def predict_step(model: nn.Module,
                     batch: Dict[str, torch.Tensor]) -> WaypointGrids:
        with span("strajnet.predict_step"), torch.inference_mode():
            with span("strajnet.forward"):
                outputs = _forward(model, ensure_f32(batch))
            logits = split_pred_waypoints(outputs, num_waypoints)
            return apply_sigmoid_to_occupancy_logits(logits)

    return predict_step
