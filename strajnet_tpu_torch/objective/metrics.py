"""Challenge metrics and the output activations of the waypoint grids.

Counterpart of ``strajnet_tpu/objective/metrics.py``. Per waypoint:
observed / occluded PR-AUC (Keras interpolation semantics,
:mod:`strajnet_tpu_torch.objective.pr_auc`), mean-based soft IoU, flow
end-point error over cells with nonzero true flow, and the flow-grounded
occupancy AUC / IoU on the true flow-origin occupancy warped by the
*predicted* flow (``core.sampling.flow_warp_origin``, the warp-gather kernel
on the card). Everything stays on the tensors' device; the waypoint-presence
gating is off, as in the JAX package. With data parallelism every rank
returns the metrics of the global batch (see
:func:`compute_occupancy_flow_metrics`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from strajnet_tpu_torch.core.sampling import flow_warp_origin
from strajnet_tpu_torch.objective.loss import WaypointGrids
from strajnet_tpu_torch.objective.pr_auc import (bucket_histogram,
                                                 pr_auc_from_histogram)

METRIC_KEYS = ("vehicles_observed_auc", "vehicles_occluded_auc",
               "vehicles_observed_iou", "vehicles_occluded_iou",
               "vehicles_flow_epe", "vehicles_flow_warped_occupancy_auc",
               "vehicles_flow_warped_occupancy_iou")
_SHORT_NAMES = dict(zip(METRIC_KEYS, (
    "observed_auc", "occluded_auc", "observed_iou", "occluded_iou",
    "flow_epe", "flow_ogm_auc", "flow_ogm_iou")))


def _ratio_or_zero(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    ok = denom != 0
    return torch.where(ok, num / torch.where(ok, denom, 1.0),
                       torch.zeros_like(num))


def _per_waypoint(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [T, B * ...] f32."""
    return x.float().transpose(0, 1).reshape(x.shape[1], -1)


def _iou_sums(true_occ: torch.Tensor, pred_occ: torch.Tensor) -> torch.Tensor:
    """``[3, T]``: per waypoint of ``[B, T, ...]`` grids the sums of
    ``pred * true``, ``pred`` and ``true`` that the soft IoU is made of."""
    t, p = _per_waypoint(true_occ), _per_waypoint(pred_occ)
    return torch.stack([(p * t).sum(-1), p.sum(-1), t.sum(-1)])


def _iou_from_sums(sums: torch.Tensor, cells) -> torch.Tensor:
    """Mean-based soft IoU per waypoint from :func:`_iou_sums` over
    ``cells`` grid cells a waypoint."""
    intersection, p, t = sums / cells
    return _ratio_or_zero(intersection, p + t - intersection)


def _soft_iou(true_occ: torch.Tensor, pred_occ: torch.Tensor) -> torch.Tensor:
    """Mean-based soft IoU of ``[B, T, ...]`` grids, one value per waypoint."""
    return _iou_from_sums(_iou_sums(true_occ, pred_occ),
                          true_occ[:, 0].numel())


def _epe_sums(true_flow: torch.Tensor, pred_flow: torch.Tensor
              ) -> torch.Tensor:
    """``[2, T]``: per waypoint of ``[B, T, H, W, 2]`` flows the summed L2
    end-point error over cells with nonzero true flow, and their count."""
    flow_exists = ((true_flow[..., 0:1] != 0.0)
                   | (true_flow[..., 1:2] != 0.0)).float()
    diff = (true_flow - pred_flow).float() * flow_exists
    epe = torch.sqrt((diff * diff).sum(-1, keepdim=True))
    return torch.stack([_per_waypoint(epe).sum(-1),
                        _per_waypoint(flow_exists).sum(-1)])


def _flow_epe(true_flow: torch.Tensor, pred_flow: torch.Tensor) -> torch.Tensor:
    """Mean L2 end-point error over cells with nonzero true flow of
    ``[B, T, H, W, 2]`` flows, one value per waypoint."""
    return _ratio_or_zero(*_epe_sums(true_flow, pred_flow))


def _sum_parts(parts: Dict[str, torch.Tensor], reduce_sum
               ) -> Dict[str, torch.Tensor]:
    """``parts`` summed over the ranks in one all-reduce (as float64: the
    counts stay exact), each back in its own dtype."""
    if reduce_sum is None:
        return parts
    flat = reduce_sum(torch.cat([p.reshape(-1).double()
                                 for p in parts.values()]))
    out, i = {}, 0
    for k, p in parts.items():
        out[k] = flat[i:i + p.numel()].reshape(p.shape).to(p.dtype)
        i += p.numel()
    return out


def compute_occupancy_flow_metrics(
        true_waypoints: WaypointGrids, pred_waypoints: WaypointGrids,
        no_warp: bool = False,
        reduce_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """Mean metric values over all waypoints, as device scalars.

    ``pred_waypoints`` carries post-sigmoid occupancies and raw flow. With
    ``no_warp`` the two flow-grounded metrics are 0. Every metric is computed
    per waypoint, all waypoints in one pass, and averaged. Each is a formula
    over sums of the batch (PR-AUC bucket histograms, the soft IoU's sums,
    EPE's sum and cell count); ``reduce_sum``
    (``parallel/ddp.py::sum_over_ranks``) sums them over the data-parallel
    ranks first, in one all-reduce, so every rank returns the metrics of
    the global batch.
    """
    true_obs = true_waypoints.observed_occupancy
    pred_obs = pred_waypoints.observed_occupancy
    true_occ = true_waypoints.occluded_occupancy
    pred_occ = pred_waypoints.occluded_occupancy
    parts = {
        "cells": torch.tensor(float(true_obs[:, 0].numel()),
                              device=true_obs.device),
        "observed_auc": bucket_histogram(true_obs, pred_obs, group_dim=1),
        "occluded_auc": bucket_histogram(true_occ, pred_occ, group_dim=1),
        "observed_iou": _iou_sums(true_obs, pred_obs),
        "occluded_iou": _iou_sums(true_occ, pred_occ),
        "flow_epe": _epe_sums(true_waypoints.flow, pred_waypoints.flow),
    }
    if not no_warp:
        # one batched warp over S = B*T instead of one per waypoint
        fo = true_waypoints.flow_origin_occupancy
        pf = pred_waypoints.flow
        bt = fo.shape[0] * fo.shape[1]
        warped = flow_warp_origin(
            fo.reshape((bt,) + fo.shape[2:]),
            pf.reshape((bt,) + pf.shape[2:])).reshape(fo.shape)
        true_all = torch.clamp(true_obs + true_occ, 0.0, 1.0)
        pred_all = torch.clamp(pred_obs + pred_occ, 0.0, 1.0)
        flow_grounded = pred_all * warped
        # the argument order is the reference's: the flow-grounded product
        # goes in as y_true and the binary ground truth as y_pred
        parts["flow_ogm_auc"] = bucket_histogram(flow_grounded, true_all,
                                                 group_dim=1)
        parts["flow_ogm_iou"] = _iou_sums(flow_grounded, true_all)
    parts = _sum_parts(parts, reduce_sum)
    cells = parts["cells"]
    out = {
        "vehicles_observed_auc": pr_auc_from_histogram(parts["observed_auc"]),
        "vehicles_occluded_auc": pr_auc_from_histogram(parts["occluded_auc"]),
        "vehicles_observed_iou": _iou_from_sums(parts["observed_iou"], cells),
        "vehicles_occluded_iou": _iou_from_sums(parts["occluded_iou"], cells),
        "vehicles_flow_epe": _ratio_or_zero(*parts["flow_epe"]),
    }
    if no_warp:
        zero = torch.zeros(1, dtype=torch.float32, device=true_obs.device)
        out["vehicles_flow_warped_occupancy_auc"] = zero
        out["vehicles_flow_warped_occupancy_iou"] = zero
    else:
        out["vehicles_flow_warped_occupancy_auc"] = pr_auc_from_histogram(
            parts["flow_ogm_auc"])
        out["vehicles_flow_warped_occupancy_iou"] = _iou_from_sums(
            parts["flow_ogm_iou"], cells)
    return {k: out[k].mean() for k in METRIC_KEYS}


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


@dataclasses.dataclass
class MetricsAccumulator:
    """Running means of per-batch metric dicts. The sums stay device scalars;
    the one fetch to the host happens in :meth:`get_result`."""

    prefix: str = "val"
    no_warp: bool = False

    def __post_init__(self):
        self.reset_states()

    def reset_states(self):
        self._sums: Dict[str, torch.Tensor] = {}
        self._count = 0

    def update_state(self, metrics: Dict[str, torch.Tensor]):
        for k, v in metrics.items():
            prev = self._sums.get(k)
            self._sums[k] = v if prev is None else prev + v
        self._count += 1

    def get_result(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        names = [_SHORT_NAMES.get(k, k) for k in self._sums]
        values = torch.stack([torch.as_tensor(s, dtype=torch.float32)
                              for s in self._sums.values()]).tolist()
        return {f"{self.prefix}_{name}": value / self._count
                for name, value in zip(names, values)
                if not (self.no_warp and name.startswith("flow_ogm"))}


def print_metrics(res_dict: Dict[str, float], prefix: str = "val",
                  no_warp: bool = False) -> str:
    """Prints and returns the formatted metric block."""
    lines = [
        f" |obs-AUC: {res_dict.get(f'{prefix}_observed_auc')}"
        f"|occ-AUC: {res_dict.get(f'{prefix}_occluded_auc')}",
        f" |obs-IOU: {res_dict.get(f'{prefix}_observed_iou')}"
        f"|occ-IOU: {res_dict.get(f'{prefix}_occluded_iou')}",
        f" |Flow-EPE: {res_dict.get(f'{prefix}_flow_epe')}|",
    ]
    if not no_warp:
        lines.append(
            f" |FlowOGM_AUC: {res_dict.get(f'{prefix}_flow_ogm_auc')}"
            f" |FlowOGM_IOU: {res_dict.get(f'{prefix}_flow_ogm_iou')}|")
    block = "\n".join(lines)
    print(block)
    return block
