"""Faults planted under the timed path, or in the plain reference put in
its place: the readings that set the correctness limits' upper ends beside
the control's (:mod:`benchmark.reference.prec`), and the checks' own tests.

In the program, through the weights it is handed:

- ``no_relpos``: the Swin blocks' attention without its relative-position
  bias (every block's table zero), as a Swin-block kernel that skipped the
  bias gather would compute;
- ``no_ln_scale``: the Swin blocks' LayerNorms without their scales (one),
  as a kernel whose LayerNorm prologue ignored them.

In the training reference (:func:`benchmark.kinds.train.reference_steps`):

- ``half``: half of each batch left out, forward and loss;
- ``half_loss``: the forward on the whole batch, the loss and its mean over
  the first half of the scenes alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

WEIGHT_FAULTS = ("no_relpos", "no_ln_scale")
BATCH_FAULTS = ("half", "half_loss")


def weights_seen(p: Dict[str, torch.Tensor],
                 fault: Optional[str]) -> Dict[str, torch.Tensor]:
    """The weights handed to the program under ``fault``."""
    if fault not in WEIGHT_FAULTS:
        return p
    out = dict(p)
    for k, v in p.items():
        if ".blocks" not in k:               # a Swin block's leaf
            continue
        if fault == "no_relpos" and k.endswith(
                "relative_position_bias_table"):
            out[k] = torch.zeros_like(v)
        elif fault == "no_ln_scale" and k.endswith(
                ("norm1.weight", "norm2.weight")):
            out[k] = torch.ones_like(v)
    return out


def halved(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of a batch's scenes."""
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}
