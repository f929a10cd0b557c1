"""Dropout and drop-path draws from an explicit ``torch.Generator``.

The training step hands one generator down the model, so two runs from one
seed draw the same noise and nothing reads the global generator. The
generator lives on the device of the tensors it draws for.

Under data parallelism (``parallel/ddp.py``) every rank seeds the same
generator and draws each mask at the shape of the global batch, whose
leading dimension is ``world_size`` times its own, and keeps its own rows
(rank ``r`` holds rows ``r * B .. (r + 1) * B - 1`` of the concatenated
batch). So ``world_size`` ranks draw the noise of one process on the
concatenated batch, as the JAX step draws every mask of the global batch
from one key. Every tensor drawn for is batch-major (batch, or batch times
heads or actors, outermost) and the ranks' batches are equal.

Under a ``('data', 'model')`` mesh (``parallel/mesh.py``) the rows are
those of the rank's ``'data'`` coordinate, so peers along ``'model'`` draw
the same noise; where a tensor is itself split over ``'model'`` (the heads
of a head-parallel attention, the columns of a column-parallel FFN) the
mask is drawn at its whole width and the rank keeps its part (``split``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from strajnet_tpu_torch.parallel.ddp import data_rank, data_size


def _require(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a module in training mode draws its dropout noise "
                         "from an explicit torch.Generator; pass generator=")
    return generator


def _uniform(shape, device, generator: torch.Generator,
             split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """U[0, 1) of ``shape``: this rank's rows of one draw at the global
    batch's shape (the draw itself at data-axis size 1); with ``split``,
    ``(dim, part, parts)``, the draw is ``parts`` times as wide on ``dim``
    and this rank keeps its ``part``."""
    ranks = data_size()
    if ranks == 1 and split is None:
        return torch.rand(shape, device=device, generator=generator)
    full = [ranks * shape[0]] + list(shape[1:])
    if split is not None:
        full[split[0]] *= split[2]
    u = torch.rand(full, device=device, generator=generator)
    u = u.narrow(0, data_rank() * shape[0], shape[0])
    if split is not None:
        dim, part, _ = split
        u = u.narrow(dim, part * shape[dim], shape[dim])
    return u


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keeps each element with probability ``1 - rate``
    and divides the kept ones by it; the identity when not training.
    ``split`` (``parallel/mesh.py::model_split``): ``x`` is this rank's part
    of a tensor split over ``'model'``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, x.device, _require(generator), split) < keep
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
    draws = [torch.floor(keep + _uniform((batch,), device, g)) / keep
             for _ in range(2)]
    return torch.stack(draws, dim=1)
