"""Multi-head attention with TF-Addons semantics.

Counterpart of ``strajnet_tpu/ops/attention.py``: per-head projection
parameters ``[heads, in, head_size]`` with no q/k/v bias, the query scaled by
``head_size ** -0.5``, a multiplicative {0, 1} mask applied as
``logits += -1e10 * (1 - mask)``, softmax in f32, and a bias on the output
projection only.

Under a ``'model'`` axis whose size divides the heads, the four kernels are
split on their head axis (``parallel/mesh.py``): each rank computes its
heads, draws their dropout as its part of the whole draw, and the output
projection's partial sums are summed over ``'model'`` before the bias.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from strajnet_tpu_torch.ops.dropout import dropout
from strajnet_tpu_torch.parallel import mesh as tp


class TfaMultiHeadAttention(nn.Module):
    """Parameters keep the Flax layout: ``query_kernel`` etc. are
    ``[heads, in, head_size]``, ``projection_kernel`` is
    ``[heads, head_size, out]``. ``dropout`` acts on the attention weights
    in training mode, with noise from the generator handed to ``forward``."""

    def __init__(self, num_heads: int, head_size: int, output_size: int,
                 in_q: int, in_k: Optional[int] = None,
                 in_v: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        in_k = in_q if in_k is None else in_k
        in_v = in_k if in_v is None else in_v
        h, d = num_heads, head_size
        self.head_size = head_size
        self.dtype = dtype
        self.dropout = dropout
        self.query_kernel = nn.Parameter(torch.empty(h, in_q, d))
        self.key_kernel = nn.Parameter(torch.empty(h, in_k, d))
        self.value_kernel = nn.Parameter(torch.empty(h, in_v, d))
        self.projection_kernel = nn.Parameter(torch.empty(h, d, output_size))
        self.projection_bias = nn.Parameter(torch.zeros(output_size))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if value is None:
            value = key
        dt = self.dtype
        heads_split = tp.split_on(self.query_kernel, 0)
        if heads_split:
            same_kv = value is key
            query, key = tp.copy_to_model(query), tp.copy_to_model(key)
            value = key if same_kv else tp.copy_to_model(value)
        q = torch.einsum("...ni,hio->...nho", query.to(dt),
                         self.query_kernel.to(dt))
        k = torch.einsum("...mi,hio->...mho", key.to(dt),
                         self.key_kernel.to(dt))
        v = torch.einsum("...mi,hio->...mho", value.to(dt),
                         self.value_kernel.to(dt))
        q = q * torch.tensor(float(self.head_size), dtype=dt) ** -0.5
        logits = torch.einsum("...nho,...mho->...hnm", q, k)
        if mask is not None:
            mask = mask.to(logits.dtype)
            if mask.dim() < logits.dim():
                mask = mask.unsqueeze(-3)
            logits = logits + (-1e10) * (1.0 - mask)
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        attn = dropout(attn, self.dropout, self.training, generator,
                       tp.model_split(attn.dim() - 3) if heads_split
                       else None)
        out = torch.einsum("...hnm,...mho->...nho", attn, v)
        if heads_split:
            # this rank's heads' share in f32, summed over 'model' and
            # rounded once, as one GEMM over all heads rounds its sum
            out = tp.reduce_from_model(torch.einsum(
                "...nho,hoi->...ni", out.float(),
                self.projection_kernel.to(dt).float())).to(dt)
        else:
            out = torch.einsum("...nho,hoi->...ni", out,
                               self.projection_kernel.to(dt))
        return out + self.projection_bias.to(dt)
