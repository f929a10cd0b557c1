"""Flow-guided deformable multi-head self-attention (FG-MSA).

Counterpart of ``strajnet_tpu/models/fgmsa.py`` with all of its options:
the offset conv of ``[9, 7, 5, 3][stage_idx]`` (SAME padding), offsets
bounded by ``tanh`` times half the grid (``offset_range_factor`` > 0), left
free (0) or added to the reference before the ``tanh`` (< 0), turned off
(``no_off``), the reference grid or a given one (``use_last_ref`` with
``last_reference``), the rel-pos bias (``use_pe``), the flow head (``fg``)
and ``deform_kv``. With ``deform_kv=False`` (the reference's behaviour) K/V
come from the unsampled features and the deformation reaches only the
rel-pos bias and the returned positions; with ``True`` they are the group
features sampled at the deformed positions, in f32.

The bias takes the branch the JAX module takes: where the queries form the
integer grid and the offsets are bounded, the blend of table windows
(``ops/rpe_window.py``, bound ``h/2``, or 0 under ``no_off``); otherwise
the direct gather ``core/sampling.py::rpe_bias`` of the table in the
compute dtype. ``attn_drop`` and ``proj_drop`` act in training mode, with
noise from the generator handed to ``forward``.

No parameter of FG-MSA matches JAX's tensor-parallel rules (its
projections are 1x1 convs), so under a ``'model'`` axis
(``parallel/mesh.py``) it runs whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.core.sampling import ref_points, rpe_bias, sample
from strajnet_tpu_torch.models.swin import LayerNorm
from strajnet_tpu_torch.ops.dropout import dropout
from strajnet_tpu_torch.ops.rpe_window import rpe_window_bias
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc

OFFSET_KERNELS = (9, 7, 5, 3)   # the offset conv's width, by stage_idx


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """A 1x1 Flax conv over the last axis of any-rank input."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), conv.weight.flatten(1).to(dtype), bias)


class FGMSA(nn.Module):
    """``kv_size`` sizes the rel-pos table; it defaults to ``q_size`` (the
    JAX module's default of (16, 16) works only where the two agree)."""

    def __init__(self, q_size: Tuple[int, int] = (16, 16), n_heads: int = 8,
                 n_head_channels: int = 48, n_groups: int = 8,
                 out_dim: int = 384, in_dim: int = 384,
                 dtype: torch.dtype = torch.float32, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, fg: bool = True,
                 kv_size: Optional[Tuple[int, int]] = None,
                 offset_range_factor: float = 2.0, use_pe: bool = True,
                 no_off: bool = False, stage_idx: int = 3,
                 use_last_ref: bool = False, deform_kv: bool = False):
        super().__init__()
        self.attn_drop, self.proj_drop, self.fg = attn_drop, proj_drop, fg
        self.offset_range_factor, self.use_pe = offset_range_factor, use_pe
        self.no_off, self.use_last_ref = no_off, use_last_ref
        self.deform_kv = deform_kv
        nc = n_head_channels * n_heads
        if nc != in_dim:
            raise ValueError(f"heads*head_channels {nc} != in_dim {in_dim}")
        self.q_size, self.n_heads, self.n_groups = q_size, n_heads, n_groups
        self.n_head_channels, self.dtype = n_head_channels, dtype
        kk = OFFSET_KERNELS[stage_idx]
        self.proj_q = nn.Conv2d(in_dim, nc, 1)
        self.conv_offset_0 = nn.Conv2d(nc, nc, kk, padding=kk // 2,
                                       groups=n_groups)
        self.conv_norm = LayerNorm(nc, 1e-3, dtype)
        self.conv_offset_proj = nn.Conv2d(nc // n_groups, 2, 1, bias=False)
        if fg:
            self.conv_offset_proj2 = nn.Conv2d(2, out_dim, 1)
        self.proj_k = nn.Conv2d(in_dim, nc, 1)
        self.proj_v = nn.Conv2d(in_dim, nc, 1)
        self.proj_out = nn.Conv2d(nc, out_dim, 1)
        if use_pe:
            kh, kw = q_size if kv_size is None else kv_size
            self.rpe_table = nn.Parameter(torch.zeros(2 * kh - 1, 2 * kw - 1,
                                                      n_heads))

    def forward(self, x: torch.Tensor,
                last_reference: Optional[torch.Tensor] = None,
                generator=None):
        """x: [B, h, w, C] -> (y [B, h, w, out], pos [B, G, h, w, 2],
        flow_hidden [B, G, h, w, out]); without the flow head (``fg=False``)
        the third is the reference, [B, G, h, w, 2]. ``last_reference``
        ([B*G, h, w, 2] or any shape of that size) replaces the reference
        grid under ``use_last_ref``."""
        dt = self.dtype
        g, nh, hc = self.n_groups, self.n_heads, self.n_head_channels
        nc = nh * hc
        cg = nc // g
        b, h, w, c = x.shape
        hk, wk = self.q_size
        n = h * w
        x = x.to(dt)

        q = _conv1x1(self.proj_q, x, dt)
        off = conv2d_nhwc(q, self.conv_offset_0.weight.to(dt),
                          self.conv_offset_0.bias.to(dt),
                          padding=self.conv_offset_0.padding, groups=g)
        off = F.gelu(self.conv_norm(off), approximate="tanh")
        off = off.reshape(b, hk, wk, g, cg).permute(0, 3, 1, 2, 4)
        offset = _conv1x1(self.conv_offset_proj, off.reshape(-1, hk, wk, cg),
                          dt)
        if self.offset_range_factor > 0:
            offset_range = torch.tensor([hk / 2.0, wk / 2.0], dtype=dt,
                                        device=x.device)
            offset = torch.tanh(offset) * offset_range

        flow_hidden = None
        if self.fg:
            flow_hidden = _conv1x1(self.conv_offset_proj2,
                                   offset.reshape(b, g, hk, wk, 2), dt)
        if self.use_last_ref:
            reference = last_reference.reshape(-1, hk, wk, 2).to(dt)
        else:
            reference = ref_points(hk, wk, dt, x.device).expand(
                b * g, hk, wk, 2)
        if self.no_off:
            offset = torch.zeros_like(offset)
        if self.offset_range_factor >= 0:
            pos = offset + reference                  # [B*G, hk, wk, 2]
        else:
            pos = torch.tanh(offset + reference)

        def heads_to_batch(t: torch.Tensor) -> torch.Tensor:
            t = t.reshape(b, n, nh, hc).permute(0, 2, 1, 3)
            return t.reshape(b * nh, n, hc)

        if self.deform_kv:
            # the group features sampled at the deformed positions, (x, y)
            xg = x.reshape(b, h, w, g, cg).permute(0, 3, 1, 2, 4)
            warp = torch.stack((pos[..., 1], pos[..., 0]), dim=-1)
            xs = sample(xg.reshape(b * g, h, w, cg).float(),
                        warp.float()).to(dt)
            xs = xs.reshape(b, g, n, cg).permute(0, 2, 1, 3)
            xs = xs.reshape(b, n, 1, c)
        else:
            # the reference's K/V: the identity-grid features
            xs = x.reshape(b, n, 1, c)
        qh = heads_to_batch(q)
        kh = heads_to_batch(_conv1x1(self.proj_k, xs, dt))
        vh = heads_to_batch(_conv1x1(self.proj_v, xs, dt))
        attn = torch.einsum("bqc,bkc->bqk", qh, kh) * hc ** -0.5

        if self.use_pe:
            rpe = self.rpe_table.reshape(2 * h - 1, 2 * w - 1, g, nh // g)
            rpe = rpe.permute(2, 0, 1, 3)[None].expand(b, -1, -1, -1, -1)
            rpe = rpe.reshape(b * g, 2 * h - 1, 2 * w - 1, nh // g)
            posk = pos.reshape(b * g, n, 2)
            # no_off with a negative range factor leaves pos = tanh(grid),
            # off the grid: the general form then
            if not self.use_last_ref and (
                    (self.no_off and self.offset_range_factor >= 0)
                    or self.offset_range_factor > 0):
                bound = 0.0 if self.no_off else max(hk, wk) / 2.0
                bias = rpe_window_bias(rpe, posk, (h, w), bound, dt)
            else:
                bias = rpe_bias(rpe.to(dt), posk, (h, w))
            bias = bias.to(dt).permute(0, 3, 1, 2).reshape(b * nh, n, n)
            attn = attn + bias
        attn = torch.softmax(attn.float(), dim=2).to(dt)
        attn = dropout(attn, self.attn_drop, self.training, generator)

        out = torch.einsum("bkv,bvc->bck", attn, vh)   # [B*heads, hc, N]
        out = out.reshape(b, c, h, w).permute(0, 2, 3, 1)
        y = dropout(_conv1x1(self.proj_out, out, dt), self.proj_drop,
                    self.training, generator)
        third = (flow_hidden if self.fg
                 else reference.reshape(b, g, hk, wk, 2))
        return y, pos.reshape(b, g, hk, wk, 2), third
