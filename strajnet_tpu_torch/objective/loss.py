"""Occupancy-flow training objective.

Counterpart of ``strajnet_tpu/objective/loss.py`` (``OGMFlow_loss`` of the
reference at ``use_focal_loss=False, use_pred=False, use_gt=True,
no_use_warp=False``). Four terms per waypoint:

1. ``observed_xe`` / ``occluded_xe``: sum-reduced sigmoid cross-entropy over
   the grid, x1000, normalized by tensor size; an additive sigmoid-focal term
   (tfa semantics) behind ``use_focal_loss``.
2. ``flow``: L1 on cells where the true flow is nonzero, normalized by the
   masked count / 2.
3. ``flow_warp_xe``: the true flow-origin occupancy warped by the *predicted*
   flow, multiplied by clip(sig(a)+sig(b)) where (a, b) are the TRUE binary
   occupancies at the training default ``use_pred=False`` (warp gradients
   flow only through the predicted flow) and the predicted logits when
   ``use_pred=True``. The reference feeds that probability product back
   through ``sigmoid_cross_entropy_with_logits``, a labels/logits convention
   mismatch that is reproduced on purpose; ``use_bce_warp=True`` switches to a
   proper binary cross-entropy, and ``warp_pred_logits=True`` keeps predicted
   logits in the multiplier on the ``use_pred=False`` path.

Per-waypoint gating (``use_gt``): flow terms of waypoints whose scene is empty
are zeroed and the sum of gates is the denominator. The reference gates on a
PR-AUC of the warped origin being > 0, which for this input family equals
``any(true_all != 0)``; that is what is computed here, as in the JAX package.

``replica`` stays at 1.0 and exists only for numerical-parity testing.

Data parallelism (``parallel/ddp.py``): the JAX step computes the loss of the
global batch. With ``reduce_sum`` each rank computes its share of it: the
gates, the flow-cell counts and the element counts that the terms divide by
are those of the global batch, summed over the ranks in one all-reduce of a
small label-derived tensor (no gradient flows through it), so the ranks'
shares sum to the global loss and their gradients to its gradient.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import torch

from strajnet_tpu_torch.config import LossConfig, TaskConfig
from strajnet_tpu_torch.core.sampling import flow_warp_origin


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


def true_waypoints_from_batch(batch: Dict[str, torch.Tensor]
                              ) -> WaypointGrids:
    """Assembles the ground-truth waypoint grids from parsed features."""
    return WaypointGrids(
        observed_occupancy=batch["gt_obs_ogm"],
        occluded_occupancy=batch["gt_occ_ogm"],
        flow=batch["gt_flow"],
        flow_origin_occupancy=batch["origin_flow"],
    )


def _batch_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _sigmoid_xe(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _keras_backend_bce(labels: torch.Tensor,
                       probs: torch.Tensor) -> torch.Tensor:
    """Elementwise ``tf.keras.backend.binary_crossentropy`` (probabilities):
    clips probs to [eps, 1-eps] AND adds eps inside each log; both matter
    numerically when the probability product saturates at 0."""
    eps = 1e-7
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -(labels * torch.log(p + eps)
             + (1.0 - labels) * torch.log(1.0 - p + eps))


def _sigmoid_focal_xe(labels: torch.Tensor, logits_or_probs: torch.Tensor,
                      from_logits: bool, alpha: float = 0.25,
                      gamma: float = 2.0) -> torch.Tensor:
    """tfa.losses.SigmoidFocalCrossEntropy, elementwise before reduction."""
    if from_logits:
        p = torch.sigmoid(logits_or_probs)
        ce = _sigmoid_xe(labels, logits_or_probs)
    else:
        p = logits_or_probs
        ce = _keras_backend_bce(labels, p)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_factor = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    modulating = (1.0 - p_t) ** gamma
    return alpha_factor * modulating * ce


def _bce_probs(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy(from_logits=False, reduction=NONE): the
    backend BCE averaged over the last axis."""
    return _keras_backend_bce(labels, probs).mean(dim=-1)


def _focal_keras_reduced(labels: torch.Tensor, x: torch.Tensor,
                         from_logits: bool) -> torch.Tensor:
    """``tf.reduce_sum(tfa.losses.SigmoidFocalCrossEntropy(...)(y, x))`` as
    the reference calls it: a plain sum over all elements."""
    return _sigmoid_focal_xe(labels, x, from_logits).sum()


def _div_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nonzero = b != 0
    return torch.where(nonzero, a / torch.where(nonzero, b,
                                                torch.ones_like(b)),
                       torch.zeros_like(a))


@dataclasses.dataclass(frozen=True)
class OGMFlowLoss:
    config: TaskConfig
    loss_cfg: LossConfig = LossConfig()
    replica: float = 1.0
    use_bce_warp: bool = False
    reduce_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, true_waypoints: WaypointGrids,
                 pred_waypoint_logits: WaypointGrids
                 ) -> Dict[str, torch.Tensor]:
        return ogmflow_loss(self.config, self.loss_cfg, true_waypoints,
                            pred_waypoint_logits, replica=self.replica,
                            use_bce_warp=self.use_bce_warp,
                            reduce_sum=self.reduce_sum)


def _flow_exists(true_flow: torch.Tensor) -> torch.Tensor:
    """1.0 on the cells whose true flow is nonzero, ``[..., 1]`` f32."""
    return ((true_flow[..., 0:1] != 0.0)
            | (true_flow[..., 1:2] != 0.0)).float()


def _normalisers(true_all: torch.Tensor, true_flow: torch.Tensor,
                 reduce_sum) -> Tuple[torch.Tensor, torch.Tensor,
                                      Union[float, torch.Tensor]]:
    """What the terms divide by, per waypoint of ``[B, T, ...]`` grids:
    the empty-scene gates ``[T]`` (1 where a cell is occupied), the counts
    of cells with a true flow ``[T]``, and the element count of one
    waypoint's grid over the batch. With ``reduce_sum`` the counts are
    summed over the ranks first: those of the global batch."""
    dims = (0,) + tuple(range(2, true_all.dim()))
    occupied = (true_all != 0).sum(dim=dims)
    flow_cells = _flow_exists(true_flow).sum(dim=dims)
    per_sample = true_all[:1, 0].numel()
    if reduce_sum is None:
        return ((occupied > 0).float(), flow_cells,
                float(true_all.shape[0] * per_sample))
    counts = reduce_sum(torch.cat([
        torch.tensor([true_all.shape[0]], dtype=torch.float64,
                     device=true_all.device),
        occupied.double(), flow_cells.double()]))
    n_wp = occupied.shape[0]
    return ((counts[1:1 + n_wp] > 0).float(), counts[1 + n_wp:].float(),
            (counts[0] * per_sample).float())


def ogmflow_loss(config: TaskConfig, loss_cfg: LossConfig,
                 true_waypoints: WaypointGrids,
                 pred_waypoint_logits: WaypointGrids,
                 replica: float = 1.0,
                 use_bce_warp: bool = False,
                 reduce_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> Dict[str, torch.Tensor]:
    """Returns the four scalar loss terms, weighted and normalized.

    ``reduce_sum`` sums a tensor over the data-parallel ranks
    (``parallel/ddp.py::sum_over_ranks``); with it the terms are this rank's
    share of the global batch's loss (see the module docstring)."""
    n_wp = true_waypoints.observed_occupancy.shape[1]
    device = pred_waypoint_logits.flow.device
    true_all_wp = torch.clamp(true_waypoints.observed_occupancy
                              + true_waypoints.occluded_occupancy, 0.0, 1.0)
    gates_wp, flow_cells, numel = _normalisers(true_all_wp,
                                               true_waypoints.flow,
                                               reduce_sum)

    warped_all = None
    if not loss_cfg.no_use_warp:
        # all waypoints warp in one call (S = B*T): one launch of the warp
        # gather instead of one per waypoint
        fo = true_waypoints.flow_origin_occupancy
        pf = pred_waypoint_logits.flow.float()
        bt = fo.shape[0] * fo.shape[1]
        warped_all = flow_warp_origin(
            fo.reshape((bt,) + fo.shape[2:]),
            pf.reshape((bt,) + pf.shape[2:]),
            use_kernel=loss_cfg.warp_kernel).reshape(fo.shape)

    obs_terms: List[torch.Tensor] = []
    occ_terms: List[torch.Tensor] = []
    flow_terms: List[torch.Tensor] = []
    warp_terms: List[torch.Tensor] = []
    gates: List[torch.Tensor] = []

    for k in range(n_wp):
        pred_obs = pred_waypoint_logits.observed_occupancy[:, k]
        pred_occ = pred_waypoint_logits.occluded_occupancy[:, k]
        pred_flow = pred_waypoint_logits.flow[:, k].float()

        true_obs = true_waypoints.observed_occupancy[:, k]
        true_occ = true_waypoints.occluded_occupancy[:, k]
        true_flow = true_waypoints.flow[:, k]

        obs_terms.append(_occupancy_xe(true_obs, pred_obs,
                                       loss_cfg.ogm_weight,
                                       loss_cfg.use_focal_loss, replica,
                                       numel))
        occ_terms.append(_occupancy_xe(true_occ, pred_occ,
                                       loss_cfg.occ_weight,
                                       loss_cfg.use_focal_loss, replica,
                                       numel))

        true_all = true_all_wp[:, k]

        if loss_cfg.use_gt:
            # the empty-scene gate (see the module docstring)
            gate = gates_wp[k]
        else:
            gate = torch.ones((), dtype=torch.float32, device=device)
        gates.append(gate)

        flow_terms.append(gate * _flow_l1(true_flow, pred_flow,
                                          loss_cfg.flow_weight, replica,
                                          flow_cells[k]))

        if not loss_cfg.no_use_warp:
            warped = warped_all[:, k]
            # the occupancy multiplier comes from the PREDICTED logits only
            # on the use_pred path (or with the warp_pred_logits deviation)
            if loss_cfg.use_pred or loss_cfg.warp_pred_logits:
                mult_obs, mult_occ = pred_obs, pred_occ
            else:
                mult_obs, mult_occ = true_obs, true_occ
            warp_terms.append(gate * _warp_xe(
                true_all, mult_obs, mult_occ, warped,
                loss_cfg.flow_origin_weight, loss_cfg.use_focal_loss,
                loss_cfg.use_pred, use_bce_warp, replica, numel))

    gate_sum = sum(gates)
    out = {
        "observed_xe": sum(obs_terms) / n_wp,
        "occluded_xe": sum(occ_terms) / n_wp,
        "flow": _div_no_nan(sum(flow_terms), gate_sum),
    }
    if not loss_cfg.no_use_warp:
        out["flow_warp_xe"] = _div_no_nan(sum(warp_terms), gate_sum)
    else:
        out["flow_warp_xe"] = torch.zeros((), dtype=torch.float32,
                                          device=device)
    return out


def _occupancy_xe(true_occ, pred_logit, weight, use_focal, replica, numel):
    """``numel``: the elements of the (global) batch's grid."""
    labels = _batch_flat(true_occ).float()
    logits = _batch_flat(pred_logit).float()
    xe_sum = _sigmoid_xe(labels, logits).sum()
    if use_focal:
        xe_sum = xe_sum + _focal_keras_reduced(labels, logits,
                                               from_logits=True)
    return weight * xe_sum / (numel * replica)


def _flow_l1(true_flow, pred_flow, weight, replica, flow_cells):
    """``flow_cells``: the (global) batch's cells with a true flow."""
    diff = (true_flow - pred_flow) * _flow_exists(true_flow)
    diff_norm = diff.abs().sum(dim=-1)
    mean_diff = _div_no_nan(diff_norm.sum(), flow_cells * replica / 2.0)
    return weight * mean_diff


def _warp_xe(true_all, mult_obs, mult_occ, warped_origin,
             weight, use_focal, use_pred, use_bce_warp, replica, numel):
    """The warp term. ``mult_obs/mult_occ`` feed the clip(sigmoid+sigmoid)
    multiplier: predicted logits on the use_pred path, TRUE binary
    occupancies otherwise."""
    labels = _batch_flat(true_all).float()
    sig = _batch_flat(torch.sigmoid(mult_obs.float())
                      + torch.sigmoid(mult_occ.float()))
    sig = torch.clamp(sig, 0.0, 1.0)
    joint = sig * _batch_flat(warped_origin).float()

    if use_pred or use_bce_warp:
        # the reference's use_pred path always ends on the BCE sum
        xe_sum = _bce_probs(labels, joint).sum()
    elif use_focal:
        xe_sum = (_focal_keras_reduced(labels, joint, from_logits=False)
                  + _bce_probs(labels, joint).sum())
    else:
        # parity: the probability product passed as a *logit*
        xe_sum = _sigmoid_xe(labels, joint).sum()

    return weight * xe_sum / (numel * replica)
