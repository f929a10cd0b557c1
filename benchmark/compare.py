"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference computes from the same weights
and inputs.

- ``out_gap``: the model's outputs, the occupancy logits and the flow
  together, scene by scene: the worst scene's distance from the
  reference's over the median scene's norm. Training reads the outputs of
  the first step's forward; serving those of a sample of the window's
  batches, the logits read back from the predict step's probabilities.

Training also (the first three steps of the object the window then drives):

- ``loss_gap``: the worst step's ``|loss - loss_ref| / |loss_ref|``;
- ``grad_gap``: the first gradient as the optimizer got it, read back from
  Nadam's first moment after one step (``m = (1 - beta_1) g``): per leaf,
  the gap between the two norms over the larger of the reference leaf's
  norm and the median leaf's; the worst leaf;
- ``grad_diff``: the same gradient's distance from the reference's, per
  leaf over the same norm; the median leaf. The norms alone hardly see a
  loss taken over half of the batch, whose gradient has about the full
  batch's norm in another direction;
- ``update_gap``: the same of each leaf's change over the three steps,
  over the elements whose first reference gradient is at least a thousandth
  of the median leaf's root-mean-square gradient (:func:`moved_mask`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

GRAD_FLOOR = 1e-3


@contextlib.contextmanager
def exact_float32():
    """TF32 off in cuBLAS and cuDNN for the plain reference."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32)
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def _median(v: Sequence[float]) -> float:
    s = sorted(v)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             keep: Sequence[str]) -> float:
    """Worst leaf of ``|got - ref| / max(ref, median ref)`` over ``keep``."""
    if not keep:
        return math.nan
    med = _median([ref[k] for k in keep])
    return worst([abs(got.get(k, math.nan) - ref[k]) / max(ref[k], med)
                  for k in keep])


def leaf_diffs(got: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> List[float]:
    """Per leaf, ``||got - ref||`` over the larger of the reference leaf's
    norm and the median leaf's; NaN for a leaf ``got`` lacks."""
    norms = {k: float(r.norm()) for k, r in ref.items()}
    med = _median(list(norms.values()))
    return [float((got[k].to(r.device, torch.float32) - r).norm())
            / max(norms[k], med) if k in got else math.nan
            for k, r in ref.items()]


def moved_mask(ref_grad: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose reference gradient is at least a
    thousandth of the median leaf's root-mean-square gradient: the others
    (a key's bias under softmax has none but round-off) move under Nadam by
    round-off alone."""
    rms = [float(g.norm()) / math.sqrt(max(g.numel(), 1))
           for g in ref_grad.values()]
    floor = GRAD_FLOOR * _median(rms)
    return {k: g.abs() >= floor for k, g in ref_grad.items()}


def training_gaps(got: dict, ref: dict) -> Dict[str, float]:
    """``got`` and ``ref``: ``losses`` (a list per step), ``out`` (the
    model's outputs in the first step), ``grad`` (the first gradient's
    per-leaf norms) and ``delta`` (each leaf's change over the steps,
    tensors by name) and ``grad_t`` (the first gradient's tensors by
    name)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 ref["losses"])]
    if len(got["losses"]) != len(ref["losses"]):
        losses.append(math.nan)
    mask = moved_mask(ref["grad_t"])
    keep = [k for k, m in mask.items() if bool(m.any())]

    def norms(delta):
        return {k: float(delta[k][mask[k].to(delta[k].device)].norm())
                for k in keep if k in delta}

    diffs = leaf_diffs(got["grad_t"], ref["grad_t"])
    return {"loss_gap": worst(losses),
            "out_gap": scene_gap([got["out"]], [ref["out"]]),
            "grad_gap": leaf_gap(got["grad"], ref["grad"], list(ref["grad"])),
            "grad_diff": (_median(diffs) if all(d == d for d in diffs)
                          else math.nan),
            "update_gap": leaf_gap(norms(got["delta"]), norms(ref["delta"]),
                                   keep)}


def scene_gap(got: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The worst scene's ``||got - ref||`` over the median scene's
    ``||ref||``, over the tensors' scene rows (all ``[scenes, ...]``); NaN
    where ``got`` lacks a scene."""
    n = ref[0].shape[0]
    if any(g.shape[0] < n for g in got):
        return math.nan
    num = sum(((g[:n].double() - r.double()) ** 2).flatten(1).sum(1)
              for g, r in zip(got, ref))
    den = sum((r.double() ** 2).flatten(1).sum(1) for r in ref)
    return worst((num / den.median()).sqrt().tolist())


def worst(values: Sequence[float]) -> float:
    """The largest value; NaN where any is NaN."""
    if not values or any(not v == v for v in values):
        return math.nan
    return max(values)
