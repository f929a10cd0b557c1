"""Window partition/merge and the shifted-window attention constants.

Counterpart of ``strajnet_tpu/ops/windows.py``: the same reshapes on
``[B, H, W, C]`` tensors, and the same numpy constants (the SW-MSA mask with
values 0 / -100 and the relative-position index), rebuilt here because the
JAX module imports jax at its top.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, ws, ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size,
                  window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size,
                                               c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int,
                   c: int) -> torch.Tensor:
    """[B * nH * nW, ws, ws, C] -> [B, H, W, C]."""
    x = windows.reshape(-1, h // window_size, w // window_size, window_size,
                        window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(height: int, width: int, window_size: int,
                        shift_size: int) -> np.ndarray:
    """Additive SW-MSA mask ``[nW, ws*ws, ws*ws]`` with values 0 / -100.

    Cells are labelled by which of the 3x3 shift regions they fall in; pairs
    from different regions within one (rolled) window get -100.
    """
    img_mask = np.zeros((height, width), dtype=np.float32)
    slices = (slice(0, -window_size),
              slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh, nw = height // window_size, width // window_size
    m = img_mask.reshape(nh, window_size, nw, window_size)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_h: int, window_w: int) -> np.ndarray:
    """``[ws*ws, ws*ws]`` indices into the (2h-1)(2w-1) relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window_h), np.arange(window_w),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window_h - 1
    rel[:, :, 1] += window_w - 1
    rel[:, :, 0] *= 2 * window_w - 1
    return rel.sum(-1).astype(np.int32)
