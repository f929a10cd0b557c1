"""Bilinear image sampling with challenge-parity semantics.

Counterpart of ``strajnet_tpu/core/sampling.py`` (``ResamplingType``,
``BorderType``, ``PixelType``, ``interpolate_bilinear``, ``sample``,
``dense_image_warp``, ``identity_warp_indices``, ``flow_warp_origin``):
TF-Addons bilinear interpolation, where floor indices are clamped to
``[0, size-2]`` and weights to ``[0, 1]``; ``PixelType.INTEGER`` puts pixel
centres on integral coordinates, ``HALF_INTEGER`` shifts the warp by -0.5
first; ``ResamplingType.NEAREST`` rounds the warp, half to even;
``BorderType.ZERO`` pads one zero pixel on each side and shifts the warp by
+1, ``DUPLICATE`` pads nothing and leaves the edge to the clamps.

:func:`rpe_bias` is FG-MSA's continuous relative-position bias in its
general form (a reference that is not the query grid, or unbounded offsets),
which the JAX package computes with one-hot contractions for the TPU
(``sample_small_table``): here the direct 4-corner gather with the same
ZERO-border, INTEGER-pixel numerics. Where the queries form the grid and the
offsets are bounded, FG-MSA takes ``ops/rpe_window.py`` instead, as JAX does.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F


class ResamplingType(enum.Enum):
    NEAREST = 0
    BILINEAR = 1


class BorderType(enum.Enum):
    ZERO = 0
    DUPLICATE = 1


class PixelType(enum.Enum):
    INTEGER = 0
    HALF_INTEGER = 1


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


def sample(image: torch.Tensor, warp: torch.Tensor,
           resampling_type: ResamplingType = ResamplingType.BILINEAR,
           border_type: BorderType = BorderType.ZERO,
           pixel_type: PixelType = PixelType.INTEGER) -> torch.Tensor:
    """Samples ``image`` [B, H, W, C] at (x, y) ``warp`` [B, ..., 2]
    (x indexes the width). Returns [B, ..., C].

    The defaults, BILINEAR resampling, ZERO border and INTEGER pixels, are
    the only mode any call site of the reference uses. The other options
    apply in this order: the half-integer shift, the rounding
    (``torch.round`` rounds half to even, as ``jnp.round`` does), then the
    zero pad and the +1.
    """
    if image.dim() != 4:
        raise ValueError(f"image must be rank 4, got {image.dim()}")
    if warp.shape[-1] != 2 or warp.dim() < 2:
        raise ValueError(f"warp must be [..., 2] of rank>=2, got "
                         f"{tuple(warp.shape)}")
    if image.shape[0] != warp.shape[0]:
        raise ValueError("image and warp batch dimensions must match")
    if pixel_type == PixelType.HALF_INTEGER:
        warp = warp - 0.5
    if resampling_type == ResamplingType.NEAREST:
        warp = torch.round(warp)
    if border_type == BorderType.ZERO:
        image = F.pad(image, (0, 0, 1, 1, 1, 1))
        warp = warp + 1.0
    b = warp.shape[0]
    flat = interpolate_bilinear(image, warp.reshape(b, -1, 2), indexing="xy")
    return flat.reshape(warp.shape[:-1] + (image.shape[-1],))


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Per-pixel backward warp (TF-Addons ``dense_image_warp``):
    ``out[b, j, i] = image[b, j - flow[b, j, i, 0], i - flow[b, j, i, 1]]``,
    bilinear, the edges clamped. The (row, col) queries are made in the
    flow's dtype."""
    b, h, w, c = image.shape
    grid_y, grid_x = torch.meshgrid(torch.arange(h, device=flow.device),
                                    torch.arange(w, device=flow.device),
                                    indexing="ij")
    stacked = torch.stack([grid_y, grid_x], dim=-1).to(flow.dtype)
    query = (stacked[None] - flow).reshape(b, h * w, 2)
    return interpolate_bilinear(image, query, indexing="ij").reshape(
        b, h, w, c)


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
        up to f32 blend rounding, for any f32 occupancy values. Under a
        ``('data', 'model')`` mesh the kernel runs on this rank's rows
        (``parallel/mesh.py::data_shard_map``); rows that differ over the
        data axis are refused by the train and eval steps before their
        forward (``parallel/mesh.py::check_rows``).
    """
    from strajnet_tpu_torch.ops import warp_gather
    from strajnet_tpu_torch.parallel import mesh as tp

    _, h, w, _ = flow_origin_occupancy.shape
    warp = identity_warp_indices(h, w, flow.dtype, flow.device)[None] + flow
    if use_kernel:
        # under a mesh, on this rank's rows (JAX falls through to XLA where
        # they do not divide the data axis; the port's steps raise there)
        return tp.data_shard_map(warp_gather.sample_dense, tp.active_mesh(),
                                 2, 0)(flow_origin_occupancy, warp)
    return sample(flow_origin_occupancy, warp)
