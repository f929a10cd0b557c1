"""The model's weights, drawn on the device from the run's seed.

One rule by name and shape for every leaf of the program's ``state_dict``.
The configuration's reference names the rules of its own leaves
(``LEAF_RULES``, by name suffix: ``model.py``'s relative-position tables,
the Swin blocks' and FG-MSA's, z); every other leaf takes the general
rules: matrix, convolution and per-head kernels Glorot-uniform with Flax's
fans (receptive field times in and out features; per-head kernels ``[a, b,
c]`` with fans ``a*b`` and ``a*c``), every bias from N(0, 0.1), each
LayerNorm scale 1 + 0.2 z, with z from N(0, 1) clamped at two. The biases
are random rather than the initialiser's zeros: with zero biases a patch of
an empty raster stays a constant token through every LayerNorm and the bias
gradients of the patch embeds overflow Nadam's second moment at this depth.
The scales are random so that a forward which ignores them gives other
outputs: at the initialiser's ones a LayerNorm that skipped them would
compute the same.

All draws come from two large ``torch.rand`` / ``torch.randn`` calls on the
device, so the same seed gives the same weights on any card, and the
program and the reference get the same tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]
# a leaf's weights from its uniform draw u in [-1, 1) and normal draw z
Rule = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
SCALE_STD = 0.2      # LayerNorm scales: 1 + SCALE_STD z


def ends_with(name: str, suffix: str) -> bool:
    """Whether the leaf ``name`` ends in ``suffix``, whole parts of the
    dotted name."""
    return name == suffix or name.endswith("." + suffix)


def spec_of(state: Dict[str, torch.Tensor]) -> Spec:
    """(name, shape) of every floating leaf of a ``state_dict``."""
    return [(k, tuple(v.shape)) for k, v in state.items()
            if v.is_floating_point()]


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 4:                      # conv, OIHW
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    if len(shape) == 3:                      # per-head or temporal kernel
        return shape[0] * shape[1], shape[0] * shape[2]
    return shape[1], shape[0]                # dense, [out, in]


def draw(spec: Spec, seed: int, device,
         rules: Dict[str, Rule]) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``spec`` from ``seed``; a leaf whose name ends in
    a key of ``rules`` (the reference's ``LEAF_RULES``) takes that rule."""
    sizes = [math.prod(s) for _, s in spec]
    total = sum(sizes)
    g = torch.Generator(device).manual_seed(seed)
    uni = torch.rand(total, device=device, generator=g) * 2.0 - 1.0
    nrm = torch.randn(total, device=device, generator=g)
    out, at = {}, 0
    for (name, shape), size in zip(spec, sizes):
        u, z = uni[at:at + size].view(shape), nrm[at:at + size].view(shape)
        at += size
        rule = next((r for s, r in rules.items() if ends_with(name, s)),
                    None)
        if rule is not None:
            t = rule(u, z)
        elif name.endswith("bias"):
            t = z * 0.1
        elif len(shape) == 1:                # LayerNorm scale
            t = 1.0 + SCALE_STD * torch.clamp(z, -2.0, 2.0)
        else:
            fan_in, fan_out = _fans(shape)
            t = u * math.sqrt(6.0 / (fan_in + fan_out))
        out[name] = t.clone()
    return out
