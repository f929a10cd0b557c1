"""Faults planted under the timed path, or in the plain reference put in
its place: the readings that set the correctness limits' upper ends beside
the control's (:mod:`benchmark.reference.prec`), and the checks' own tests.

In the program, through the weights it is handed, on the leaves that the
configuration's reference names (its ``FAULT_LEAVES``; ``model.py``'s in
parentheses):

- ``no_relpos``: the blocks' attention without its relative-position bias
  (every Swin block's table zero), as a kernel that skipped the bias gather
  would compute;
- ``no_ln_scale``: the blocks' LayerNorms without their scales (one), as a
  kernel whose LayerNorm prologue ignored them.

In the training reference (:func:`benchmark.kinds.train.reference_steps`):

- ``half``: half of each batch left out, forward and loss;
- ``half_loss``: the forward on the whole batch, the loss and its mean over
  the first half of the scenes alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from benchmark.weights import ends_with

WEIGHT_FAULTS = ("no_relpos", "no_ln_scale")
BATCH_FAULTS = ("half", "half_loss")


def weights_seen(p: Dict[str, torch.Tensor], fault: Optional[str],
                 leaves: Dict[str, Tuple[str, Sequence[str], float]]
                 ) -> Dict[str, torch.Tensor]:
    """The weights handed to the program under ``fault``: for a weight
    fault, ``leaves[fault]`` (the reference's ``FAULT_LEAVES``) is ``(under,
    suffixes, value)``, and each leaf whose name holds ``under`` and ends in
    one of ``suffixes`` is set to ``value``. Raises where it sets none."""
    if fault not in WEIGHT_FAULTS:
        return p
    under, suffixes, value = leaves[fault]
    hit = {k: torch.full_like(v, value) for k, v in p.items()
           if under in k and any(ends_with(k, s) for s in suffixes)}
    if not hit:
        raise ValueError(f"{fault}: no leaf under {under!r} ends in "
                         f"{', '.join(suffixes)}")
    return dict(p, **hit)


def halved(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of a batch's scenes."""
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}
