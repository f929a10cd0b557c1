"""Bilinear image sampling with challenge-parity semantics.

Counterpart of ``strajnet_tpu/core/sampling.py`` (``interpolate_bilinear``,
``sample``, ``identity_warp_indices``, ``flow_warp_origin``): TF-Addons
bilinear interpolation, where floor indices are
clamped to ``[0, size-2]`` and weights to ``[0, 1]``; ``PixelType.INTEGER``
puts pixel centres on integral coordinates; ``BorderType.ZERO`` pads one zero
pixel on each side and shifts the warp by +1.

:func:`rpe_bias` is FG-MSA's continuous relative-position bias in its
general form (a reference that is not the query grid, or unbounded offsets),
which the JAX package computes with one-hot contractions for the TPU
(``sample_small_table``): here the direct 4-corner gather with the same
ZERO-border, INTEGER-pixel numerics. Where the queries form the grid and the
offsets are bounded, FG-MSA takes ``ops/rpe_window.py`` instead, as JAX does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(grid: torch.Tensor, query_points: torch.Tensor,
                         indexing: str = "ij") -> torch.Tensor:
    """Bilinear interpolation on a regular grid (TF-Addons semantics).

    Args:
      grid: [B, H, W, C] source values.
      query_points: [B, N, 2]; (row, col) with ``indexing='ij'``, (col, row)
        with ``'xy'``.

    Returns:
      [B, N, C] interpolated values.
    """
    if indexing not in ("ij", "xy"):
        raise ValueError("Indexing mode must be 'ij' or 'xy'")
    b, h, w, c = grid.shape
    n = query_points.shape[1]
    index_order = (0, 1) if indexing == "ij" else (1, 0)
    floors, alphas = [], []
    for dim, size in zip(index_order, (h, w)):
        queries = query_points[..., dim]
        floor_f = torch.clamp(torch.floor(queries), 0.0, float(size - 2))
        floors.append(floor_f.long())
        alpha = torch.clamp((queries - floor_f).to(grid.dtype), 0.0, 1.0)
        alphas.append(alpha[..., None])
    flat = grid.reshape(b * h * w, c)
    base = (torch.arange(b, device=grid.device) * (h * w))[:, None]

    def gather(y_idx, x_idx):
        return flat[(base + y_idx * w + x_idx).reshape(-1)].reshape(b, n, c)

    y0, x0 = floors
    top_left = gather(y0, x0)
    top_right = gather(y0, x0 + 1)
    bottom_left = gather(y0 + 1, x0)
    bottom_right = gather(y0 + 1, x0 + 1)
    interp_top = alphas[1] * (top_right - top_left) + top_left
    interp_bottom = alphas[1] * (bottom_right - bottom_left) + bottom_left
    return alphas[0] * (interp_bottom - interp_top) + interp_top


def sample(image: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """Samples ``image`` [B, H, W, C] at (x, y) ``warp`` [B, ..., 2].

    BILINEAR resampling, ZERO border, INTEGER pixels: the only mode any call
    site of the reference uses. Returns [B, ..., C].
    """
    if image.dim() != 4:
        raise ValueError(f"image must be rank 4, got {image.dim()}")
    if warp.shape[-1] != 2 or warp.dim() < 2:
        raise ValueError(f"warp must be [..., 2] of rank>=2, got "
                         f"{tuple(warp.shape)}")
    if image.shape[0] != warp.shape[0]:
        raise ValueError("image and warp batch dimensions must match")
    image = F.pad(image, (0, 0, 1, 1, 1, 1))
    warp = warp + 1.0
    b = warp.shape[0]
    flat = interpolate_bilinear(image, warp.reshape(b, -1, 2), indexing="xy")
    return flat.reshape(warp.shape[:-1] + (image.shape[-1],))


def ref_points(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """FG-MSA reference grid with ``tf.meshgrid``'s xy indexing:
    ``[W, H, 2]`` with ``ref[i, j] = (j, i)`` (== [H, W, 2] when square)."""
    jj, ii = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="xy")
    return torch.stack((jj, ii), dim=-1)


def rpe_bias(table: torch.Tensor, pos: torch.Tensor, q_hw) -> torch.Tensor:
    """FG-MSA's relative-position bias by direct gather.

    Samples ``table`` at the displacement ``q_grid[q] - pos[k]`` of every
    (query, key) pair, with its two components swapped into (x, y) order, as
    ``sample_small_table`` and ``rpe_window_bias`` do.

    Args:
      table: [S, Th, Tw, G] rpe table.
      pos: [S, K, 2] deformed key positions in ``ref_points`` component order.
      q_hw: (h, w) query grid; queries in ``ref_points(h, w)`` flat order.

    Returns:
      [S, h*w, K, G] bias in f32.
    """
    h, w = q_hw
    s = table.shape[0]
    pos = pos.float()
    q_grid = ref_points(h, w, device=pos.device).reshape(1, h * w, 1, 2)
    disp = q_grid - pos[:, None]                    # [S, h*w, K, 2]
    warp = torch.stack((disp[..., 1], disp[..., 0]), dim=-1)
    return sample(table.float(), warp).reshape(s, h * w, pos.shape[1], -1)


def identity_warp_indices(height: int, width: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """[H, W, 2] grid of (x, y) self-indices."""
    h_idx, w_idx = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack((w_idx, h_idx), dim=-1)


def flow_warp_origin(flow_origin_occupancy: torch.Tensor, flow: torch.Tensor,
                     use_kernel: bool = True) -> torch.Tensor:
    """Warps flow-origin occupancy by a (dx, dy) flow field.

    Shared by the warp loss and the flow-grounded metrics: samples the origin
    occupancy at ``identity + flow`` with INTEGER pixels and ZERO border.

    Args:
      flow_origin_occupancy: [B, H, W, 1].
      flow: [B, H, W, 2] (dx, dy).
      use_kernel: route the four-corner gather through
        ``ops/warp_gather.py`` (the CUDA kernel on CUDA tensors, its plain
        version on CPU tensors), which raises on any other shape than a
        single-channel occupancy; False takes :func:`sample`. The two agree
        up to f32 blend rounding, for any f32 occupancy values.
    """
    from strajnet_tpu_torch.ops import warp_gather

    _, h, w, _ = flow_origin_occupancy.shape
    warp = identity_warp_indices(h, w, flow.dtype, flow.device)[None] + flow
    if use_kernel:
        return warp_gather.sample_dense(flow_origin_occupancy, warp)
    return sample(flow_origin_occupancy, warp)
