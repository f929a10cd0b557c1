"""World <-> grid coordinate transforms (reference grid_utils.py:18-60 parity).

Counterpart of ``strajnet_tpu/core/grid.py`` on float32 tensors: inputs are
narrowed to float32 as ``jnp.asarray`` narrows them, and sine and cosine
are the C library's (``core/libm.py``), as XLA's CPU backend computes them,
so the results equal the JAX functions' bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from strajnet_tpu_torch.config import TaskConfig
from strajnet_tpu_torch.core.libm import cosf, sinf


def _f32(value, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(value, device=device).to(torch.float32)


def transform_to_image_coordinates(points_x, points_y, config: TaskConfig,
                                   larger_box: bool = False,
                                   extra_m: int = 20):
    """Maps ego-frame metric points to integer grid cells + in-FOV mask.

    Mirrors ``_transform_to_image_coordinates`` (reference grid_utils.py:18-60):
    ``x_img = round(x * ppm) + sdc_x``, ``y_img = round(-y * ppm) + sdc_y``.
    With ``larger_box`` the validity margin is extended by ``extra_m * ppm``
    cells on each side (used for occluded-actor candidate selection).

    Returns:
      (x_img, y_img, point_is_in_fov) — int32 grids and bool mask.
    """
    points_x, points_y = _f32(points_x), _f32(points_y)
    ppm = config.pixels_per_meter
    x_img = torch.round(points_x * ppm).to(torch.int32) + config.sdc_x_in_grid
    y_img = torch.round(-points_y * ppm).to(torch.int32) + config.sdc_y_in_grid

    if larger_box:
        margin = int(extra_m * ppm)
        lo_x, lo_y = -margin, -margin
        hi_x = config.grid_width_cells + margin
        hi_y = config.grid_height_cells + margin
    else:
        lo_x = lo_y = 0
        hi_x, hi_y = config.grid_width_cells, config.grid_height_cells

    in_fov = ((x_img >= lo_x) & (x_img < hi_x) &
              (y_img >= lo_y) & (y_img < hi_y))
    return x_img, y_img, in_fov


def rotate_points_around_origin(x, y, angle
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotates 2D points about the origin by ``angle`` radians."""
    x, y = _f32(x), _f32(y)
    angle = _f32(angle, like=x)
    cos, sin = cosf(angle), sinf(angle)
    return x * cos - y * sin, x * sin + y * cos
