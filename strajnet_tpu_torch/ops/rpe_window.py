"""FG-MSA's continuous relative-position bias as a blend of table windows.

Counterpart of ``strajnet_tpu/ops/rpe_window.py::rpe_window_bias``. FG-MSA
samples its rel-pos table at ``q_grid[q] - pos[k]`` for every (query, key)
pair. The queries form the integer grid, so for a fixed key the fractional
part of the displacement is the same for every query: the bilinear sample
over all queries is one h x w window of the zero-padded table per bilinear
corner, and the four corners are four adjacent window starts. With every
reachable window start enumerated once per table slice (``Tensor.unfold``
twice), the bias of key k is

    bias[:, k] = sum_z (rowsel_k (x) colsel_k)(z) * W_z

with W_z the window at start z and the selection vector an outer product of
two-tap row and column selectors that carry the bilinear weights: one
batched product per slice. Its backward is dense as well: the window
gradient is the transposed product and folds back onto the table through
the backward of ``unfold``; no gather, no scatter.

It computes what :func:`strajnet_tpu_torch.core.sampling.rpe_bias` computes
(ZERO border, INTEGER pixels) wherever every position lies within ``bound``
of its grid point: a clamped read of the bordered table lands on a zero of
the padded one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rpe_window_bias(table: torch.Tensor, pos: torch.Tensor, q_hw,
                    bound: float,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """FG-MSA's rel-pos bias for queries on the integer grid.

    Args:
      table: [S, Th, Tw, G] rpe table (Th = 2h-1, Tw = 2w-1).
      pos: [S, K, 2] deformed key positions in ``ref_points`` component
        order (component 0 indexes the table's row axis).
      q_hw: (h, w) query grid; queries in ``ref_points(h, w)`` flat order.
      bound: a bound on |pos - reference grid point| (h/2 for FG-MSA's tanh
        offsets, 0 without offsets); it sets the padding, so that no window
        leaves the padded table.
      compute_dtype: dtype of the windows and the selection product (the
        model dtype); the sums run in f32.

    Returns:
      [S, h*w, K, G] bias in f32. Under bf16 each entry is its f32 sum
      rounded once to bf16, which is what FG-MSA casts it to.
    """
    h, w = q_hw
    s, th, tw, g = table.shape
    k = pos.shape[1]
    pos = pos.float()
    cb = math.ceil(bound)
    ph = th // 2 + 1 + cb + 2
    pw = tw // 2 + 1 + cb + 2
    tp = F.pad(table.float(), (0, 0, pw, pw, ph, ph)).to(compute_dtype)

    # row of (query q0, key k) in the padded table:
    # q0 + floor(1 - pos0) - 1 + ph, blended with the next by frac(1 - pos0)
    fy = torch.floor(1.0 - pos[..., 0])
    ay = (1.0 - pos[..., 0]) - fy                      # [S, K]
    fx = torch.floor(1.0 - pos[..., 1])
    ax = (1.0 - pos[..., 1]) - fx

    # every window start a key can reach (nr x nc), and its windows as views
    rbase = (1 - h - cb) - 1 + ph
    cbase = (1 - w - cb) - 1 + pw
    nr = h + 2 * cb + 2
    nc = w + 2 * cb + 2
    win = tp[:, rbase:rbase + nr + h - 1, cbase:cbase + nc + w - 1]
    win = win.unfold(1, h, 1).unfold(2, w, 1)          # [S, nr, nc, G, h, w]
    win = win.permute(0, 1, 2, 4, 5, 3).reshape(s, nr * nc, h * w * g)

    ri = (fy.long() - 1 + ph - rbase)[..., None]       # [S, K, 1]
    ci = (fx.long() - 1 + pw - cbase)[..., None]
    ar = torch.arange(nr, device=pos.device)
    ac = torch.arange(nc, device=pos.device)
    rowsel = ((1.0 - ay)[..., None] * (ri == ar)
              + ay[..., None] * (ri + 1 == ar))        # [S, K, nr]
    colsel = ((1.0 - ax)[..., None] * (ci == ac)
              + ax[..., None] * (ci + 1 == ac))        # [S, K, nc]
    zsel = (rowsel[..., :, None] * colsel[..., None, :]).reshape(
        s, k, nr * nc).to(compute_dtype)
    out = torch.bmm(zsel, win).float().reshape(s, k, h, w, g)

    # flat query order of ref_points(h, w): n = q1 * h + q0
    return out.permute(0, 3, 2, 1, 4).reshape(s, h * w, k, g)
