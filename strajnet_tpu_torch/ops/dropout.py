"""Dropout and drop-path draws from an explicit ``torch.Generator``.

The training step hands one generator down the model, so two runs from one
seed draw the same noise and nothing reads the global generator. The
generator lives on the device of the tensors it draws for.
"""

from __future__ import annotations

from typing import Optional

import torch


def _require(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a module in training mode draws its dropout noise "
                         "from an explicit torch.Generator; pass generator=")
    return generator


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keeps each element with probability ``1 - rate``
    and divides the kept ones by it; the identity when not training."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device,
                      generator=_require(generator)) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path_multipliers(batch: int, rate: float, training: bool,
                          generator: Optional[torch.Generator],
                          device) -> Optional[torch.Tensor]:
    """The fused Swin block's ``drop_path`` argument: ``[B, 2]`` f32, one
    keep-scaled draw ``floor(keep + U[B]) / keep`` per residual branch, each
    entry 0 or ``1 / keep``. None when stochastic depth is inactive."""
    if not training or rate == 0.0:
        return None
    keep = 1.0 - rate
    g = _require(generator)
    draws = [torch.floor(keep + torch.rand(batch, device=device, generator=g))
             / keep for _ in range(2)]
    return torch.stack(draws, dim=1)
