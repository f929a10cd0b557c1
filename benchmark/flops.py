"""Floating-point operations of one step, counted by PyTorch's
``FlopCounterMode`` over the configuration's plain reference at the cell's
shapes (matrix products and convolutions, two per multiply-add, the
backward's included). The reference runs on the ``meta`` device: shapes
only, no memory and no arithmetic. It never counts the program."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import pool as pools
from benchmark.reference import loss as ref_loss


def _meta_batch(cfg: dict, batch: int, train: bool):
    g = torch.Generator().manual_seed(0)
    real = pools.render(cfg, pools.draws(cfg, 1, g, "cpu"), train)
    return {k: torch.empty((batch,) + tuple(v.shape[1:]), device="meta")
            for k, v in real.items()}


def step_flops(reference, model: dict, spec, batch: int,
               train: bool) -> float:
    """FLOPs of one forward (``train``: forward, loss and backward) of a
    batch of ``batch`` scenes, by the module ``reference``
    (:func:`benchmark.harness.load_reference`)."""
    cfg = pools.with_sizes(model)
    params = {k: torch.empty(s, device="meta", requires_grad=train)
              for k, s in spec}
    data = _meta_batch(cfg, batch, train)
    with FlopCounterMode(display=False) as counter:
        out = reference.forward(params, model, data)
        if train:
            total = ref_loss.total(ref_loss.loss_terms(
                data, out, model["num_waypoints"]))
            torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return float(counter.get_total_flops())
