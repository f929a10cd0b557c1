"""The occupancy-flow training loss and the Keras Nadam step, plain PyTorch.

The loss is the reference's ``OGMFlow_loss`` at its training settings (no
focal term, true occupancies in the warp multiplier, the empty-scene gate
on): per waypoint, the sigmoid cross-entropy of the observed and the
occluded occupancy (x1000, over the grid's elements), the L1 of the flow on
cells with a true flow (over their count / 2), and the true flow-origin
occupancy warped by the predicted flow, times clip(sig(obs) + sig(occ)),
fed to a sigmoid cross-entropy as a logit (x1000; the reference's own
convention). Flow terms are gated by whether the waypoint's scene has any
occupied cell and averaged over the gates.

:func:`nadam_step` is ``tf.keras.optimizers.Nadam(lr)`` (beta_1 0.9,
beta_2 0.999, epsilon 1e-7, momentum decay 0.96) with its scalars in
float32, at the learning rate of SGDR cosine restarts (first decay 45657
steps, t_mul 1.25, m_mul 0.99) of 1e-4.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import sample


def _xe(labels, logits):
    """tf.nn.sigmoid_cross_entropy_with_logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_terms(batch: Dict[str, torch.Tensor], outputs: torch.Tensor,
               num_waypoints: int = 8) -> Dict[str, torch.Tensor]:
    """The four weighted terms of ``outputs [B, H, W, T*4]``."""
    b, h, w, _ = outputs.shape
    t = num_waypoints
    x = outputs.reshape(b, h, w, t, 4).permute(0, 3, 1, 2, 4)
    obs, occ, flow = x[..., 0:1], x[..., 1:2], x[..., 2:4]
    t_obs, t_occ = batch["gt_obs_ogm"], batch["gt_occ_ogm"]
    t_flow, origin = batch["gt_flow"], batch["origin_flow"]
    t_all = torch.clamp(t_obs + t_occ, 0.0, 1.0)
    numel = float(b * h * w)
    dims = (0, 2, 3, 4)
    gates = ((t_all != 0).sum(dim=dims) > 0).float()
    has_flow = ((t_flow[..., 0:1] != 0) | (t_flow[..., 1:2] != 0)).float()
    flow_cells = has_flow.sum(dim=dims)
    grid = torch.stack(torch.meshgrid(torch.arange(h, device=x.device),
                                      torch.arange(w, device=x.device),
                                      indexing="ij"), dim=-1).float()
    warp = grid.flip(-1)[None] + flow.reshape(b * t, h, w, 2)
    warped = sample(origin.reshape(b * t, h, w, 1), warp).reshape(
        origin.shape)
    terms: Dict[str, List[torch.Tensor]] = dict(o=[], c=[], f=[], w=[])
    for k in range(t):
        terms["o"].append(1000.0 * _xe(t_obs[:, k], obs[:, k]).sum() / numel)
        terms["c"].append(1000.0 * _xe(t_occ[:, k], occ[:, k]).sum() / numel)
        diff = ((t_flow[:, k] - flow[:, k]) * has_flow[:, k]).abs().sum()
        l1 = torch.where(flow_cells[k] != 0, diff / (flow_cells[k] / 2.0),
                         torch.zeros_like(diff))
        terms["f"].append(gates[k] * l1)
        sig = torch.clamp(torch.sigmoid(t_obs[:, k]) + torch.sigmoid(
            t_occ[:, k]), 0.0, 1.0)
        xe = _xe(t_all[:, k], sig * warped[:, k]).sum()
        terms["w"].append(gates[k] * 1000.0 * xe / numel)
    gate_sum = gates.sum()

    def over_gates(v):
        return torch.where(gate_sum != 0, v / gate_sum, torch.zeros_like(v))

    return {"observed_xe": sum(terms["o"]) / t,
            "occluded_xe": sum(terms["c"]) / t,
            "flow": over_gates(sum(terms["f"])),
            "flow_warp_xe": over_gates(sum(terms["w"]))}


def total(terms: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (terms["observed_xe"] + terms["occluded_xe"] + terms["flow"]
            + terms["flow_warp_xe"])


def learning_rate(count: int, lr: float = 1e-4, first: int = 45657,
                  t_mul: float = 1.25, m_mul: float = 0.99) -> float:
    """SGDR cosine restarts at step ``count``, in float32."""
    f = np.float32
    done = f(count) / f(first)
    i = np.floor(np.log(f(1) - done * f(1 - t_mul)) / f(math.log(t_mul)))
    frac = (done - (f(1) - f(t_mul) ** i) / f(1 - t_mul)) / f(t_mul) ** i
    return float(f(lr) * f(0.5) * f(m_mul) ** i
                 * (f(1) + np.cos(f(math.pi) * frac)))


class Nadam:
    """Keras Nadam over a list of float32 tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = params
        self.mu = [torch.zeros_like(q) for q in params]
        self.nu = [torch.zeros_like(q) for q in params]
        self.count, self.mu_product = 0, 1.0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        f = np.float32
        b1, b2, decay = f(0.9), f(0.999), f(0.96)
        step = f(self.count + 1)
        u_t = b1 * (f(1) - f(0.5) * decay ** (f(0.004) * step))
        u_t1 = b1 * (f(1) - f(0.5) * decay ** (f(0.004) * (step + f(1))))
        mu_product = f(self.mu_product) * u_t
        c_m = float(u_t1 / (f(1) - mu_product * u_t1))
        c_g = float((f(1) - u_t) / (f(1) - mu_product))
        c_v = float(f(1) / (f(1) - b2 ** step))
        lr = learning_rate(self.count)
        for q, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(float(b1)).add_(g, alpha=float(f(1) - b1))
            v.mul_(float(b2)).addcmul_(g, g, value=float(f(1) - b2))
            upd = (m * c_m + g * c_g) / (torch.sqrt(v * c_v) + 1e-7)
            q.sub_(upd * lr)
        self.count += 1
        self.mu_product = float(mu_product)
