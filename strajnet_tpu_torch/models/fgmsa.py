"""Flow-guided deformable multi-head self-attention (FG-MSA).

Counterpart of ``strajnet_tpu/models/fgmsa.py`` at STrajNet's settings: stage
index 3 (3x3 offset conv), ``offset_range_factor`` 2, rel-pos bias on, the
flow head on (``fg=True``) and the reference's ``deform_kv=False`` behaviour,
where K/V come from the unsampled features and the deformation reaches only
the rel-pos bias and the returned positions; the other variants are still
to be ported (ROADMAP.md). ``attn_drop`` and ``proj_drop`` (0 in every
supported config) act in training mode, with noise from the generator handed
to ``forward``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.core.sampling import ref_points, rpe_bias
from strajnet_tpu_torch.models.swin import LayerNorm
from strajnet_tpu_torch.ops.dropout import dropout
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """A 1x1 Flax conv over the last axis of any-rank input."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), conv.weight.flatten(1).to(dtype), bias)


class FGMSA(nn.Module):
    def __init__(self, q_size: Tuple[int, int] = (16, 16), n_heads: int = 8,
                 n_head_channels: int = 48, n_groups: int = 8,
                 out_dim: int = 384, in_dim: int = 384,
                 dtype: torch.dtype = torch.float32, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        nc = n_head_channels * n_heads
        if nc != in_dim:
            raise ValueError(f"heads*head_channels {nc} != in_dim {in_dim}")
        self.q_size, self.n_heads, self.n_groups = q_size, n_heads, n_groups
        self.n_head_channels, self.dtype = n_head_channels, dtype
        hk, wk = q_size
        self.proj_q = nn.Conv2d(in_dim, nc, 1)
        self.conv_offset_0 = nn.Conv2d(nc, nc, 3, padding=1, groups=n_groups)
        self.conv_norm = LayerNorm(nc, 1e-3, dtype)
        self.conv_offset_proj = nn.Conv2d(nc // n_groups, 2, 1, bias=False)
        self.conv_offset_proj2 = nn.Conv2d(2, out_dim, 1)
        self.proj_k = nn.Conv2d(in_dim, nc, 1)
        self.proj_v = nn.Conv2d(in_dim, nc, 1)
        self.proj_out = nn.Conv2d(nc, out_dim, 1)
        self.rpe_table = nn.Parameter(torch.zeros(2 * hk - 1, 2 * wk - 1,
                                                  n_heads))

    def forward(self, x: torch.Tensor, generator=None):
        """x: [B, h, w, C] -> (y [B, h, w, out], pos [B, G, h, w, 2],
        flow_hidden [B, G, h, w, out])."""
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
                          self.conv_offset_0.bias.to(dt), padding=1, groups=g)
        off = F.gelu(self.conv_norm(off), approximate="tanh")
        off = off.reshape(b, hk, wk, g, cg).permute(0, 3, 1, 2, 4)
        offset = _conv1x1(self.conv_offset_proj, off.reshape(-1, hk, wk, cg),
                          dt)
        offset_range = torch.tensor([hk / 2.0, wk / 2.0], dtype=dt,
                                    device=x.device)
        offset = torch.tanh(offset) * offset_range

        flow_hidden = _conv1x1(self.conv_offset_proj2,
                               offset.reshape(b, g, hk, wk, 2), dt)
        reference = ref_points(hk, wk, dt, x.device)
        pos = offset + reference                      # [B*G, hk, wk, 2]

        def heads_to_batch(t: torch.Tensor) -> torch.Tensor:
            t = t.reshape(b, n, nh, hc).permute(0, 2, 1, 3)
            return t.reshape(b * nh, n, hc)

        # deform_kv=False: K/V from the identity-grid features
        xs = x.reshape(b, n, 1, c)
        qh = heads_to_batch(q)
        kh = heads_to_batch(_conv1x1(self.proj_k, xs, dt))
        vh = heads_to_batch(_conv1x1(self.proj_v, xs, dt))
        attn = torch.einsum("bqc,bkc->bqk", qh, kh) * hc ** -0.5

        rpe = self.rpe_table.reshape(2 * h - 1, 2 * w - 1, g, nh // g)
        rpe = rpe.permute(2, 0, 1, 3)[None].expand(b, -1, -1, -1, -1)
        rpe = rpe.reshape(b * g, 2 * h - 1, 2 * w - 1, nh // g)
        bias = rpe_bias(rpe, pos.reshape(b * g, n, 2), (h, w)).to(dt)
        bias = bias.permute(0, 3, 1, 2).reshape(b * nh, n, n)
        attn = torch.softmax((attn + bias).float(), dim=2).to(dt)
        attn = dropout(attn, self.attn_drop, self.training, generator)

        out = torch.einsum("bkv,bvc->bck", attn, vh)   # [B*heads, hc, N]
        out = out.reshape(b, c, h, w).permute(0, 2, 3, 1)
        y = dropout(_conv1x1(self.proj_out, out, dt), self.proj_drop,
                    self.training, generator)
        return y, pos.reshape(b, g, hk, wk, 2), flow_hidden
