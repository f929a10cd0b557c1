"""Swin-Transformer encoder.

Counterpart of ``strajnet_tpu/models/swin.py`` with every wiring of the JAX
encoder: the separate patch embeds of the vehicle OGM, the map and the flow
(``sep_encode``) or one patch embed of them concatenated; the flow through
a Swin stage of its own (``flow_sep`` with ``use_flow``) or added after its
patch embed; no map (``no_map``); the 512² OGM with the 256² map padded
into the centre of the patch grid and centre-cropped residuals
(``large_input``) or all rasters at one size; the absolute position
embedding (``ape``). Module and parameter names follow the Flax tree so that
``interop/from_flax.py`` maps it leaf by leaf.

Tensors are token-major ``[B, L, C]`` between modules, as in JAX. Parameters
stay f32; each op casts them to the compute dtype where the JAX module does.
:class:`SwinTransformerBlock` rolls the input and calls
``ops/swin_block.py`` (the CUDA kernels on the card, forward and backward;
the plain version on the CPU), or the plain version everywhere when the
kernel is off. In the ``"attn"`` mode only the windowed attention goes through
a kernel (``ops/window_attention.py``) and LayerNorm, MLP and residuals are
plain torch. In training mode each block draws its two per-sample drop-path
multipliers (the fused block takes them as ``drop_path``); the rates rise
linearly over the blocks to ``drop_path_rate`` and the flow branch takes
stage 0's. The block has no place for the in-block dropouts (``drop_rate``,
``attn_drop_rate``; 0 in every supported config), so a non-zero value raises.
``remat`` (the model's ``remat_encoder``) recomputes a block's forward in its
backward instead of saving its intermediates, as the JAX encoder's
``nn.remat`` does. ``block="swinv2"`` builds SwinV2's blocks and patch
merging instead (:class:`SwinV2TransformerBlock`, :class:`PatchMergingV2`:
post-norm residuals, scaled cosine attention, the continuous position bias,
the published code's leaf names), which the JAX package does not have; they
run in the ``"block"`` and plain modes without a mesh.
:class:`BasicLayerDecoder` and :class:`PatchUpsampling`,
the reference's upsampling stage, complete the module inventory; nothing
builds them.

Under a ``('data', 'model')`` mesh (``parallel/mesh.py``) a block runs on
this rank's rows. The kernel modes (``"block"``, ``"block_fwd"``,
``"attn"``) call their kernels inside ``data_shard_map`` with every weight
gathered whole over ``'model'`` (K1/K2 and K3/K4 see plain local tensors,
as without a mesh; in ``"attn"`` the MLP around K3 is gathered too, as the
whole block is inside the map). The plain mode computes on the shards
where the layer allows it: ``qkv`` is gathered (its 3C columns interleave
q, k and v, so a contiguous shard holds no whole heads), the attention runs
whole, ``proj`` is row-parallel on this rank's columns of the attention
output, fc1 column-parallel and fc2 row-parallel, each row-parallel product
summed in f32 by one all-reduce over ``'model'`` and rounded to the
compute dtype once. ``spatial_shard`` hints the
tokens of every block's output split over ``'model'``
(``parallel/mesh.py::sharding_hint``), as ``strajnet_tpu/models/swin.py``
does; the hint records the split and leaves the tokens whole.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from strajnet_tpu_torch.ops.dropout import drop_path_multipliers
from strajnet_tpu_torch.ops.swin_block import swin_block, swin_block_reference
from strajnet_tpu_torch.ops.swinv2_block import (swinv2_block,
                                                 swinv2_block_reference)
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc
from strajnet_tpu_torch.ops.window_attention import window_attention
from strajnet_tpu_torch.ops.windows import (relative_position_index,
                                            shifted_window_mask)
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.tracing import span

BLOCKS = ("swin", "swinv2")


class LayerNorm(nn.LayerNorm):
    """LayerNorm with statistics in f32 and the output cast to ``dtype``
    (Flax's ``nn.LayerNorm`` with f32 params, as the JAX modules use it)."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """A Flax ``nn.Dense`` with compute dtype: operands and bias in dtype.
    A weight sharded over ``'model'`` is gathered whole first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), tp.whole(layer.weight).to(dtype), bias)


def parallel_ffn(fc1: nn.Linear, fc2: nn.Linear, x: torch.Tensor,
                 act, dtype: torch.dtype) -> torch.Tensor:
    """``dense(fc2, act(dense(fc1, x)))``. Where fc1 is column- and fc2
    row-parallel over ``'model'`` (``parallel/mesh.py``), this rank computes
    its columns of the hidden layer and its part of the output, summed over
    ``'model'`` in f32 and rounded once (as one GEMM rounds its f32 sum)
    before fc2's bias; otherwise the two layers whole. ``act``
    takes the hidden layer and ``model_split``'s split of it (for dropout;
    None where it is whole)."""
    if not (tp.split_on(fc1.weight, 0) and tp.split_on(fc2.weight, 1)):
        return dense(fc2, act(dense(fc1, x, dtype), None), dtype)
    x = tp.copy_to_model(x.to(dtype))
    b1 = tp.local_part(tp.copy_to_model(fc1.bias), 0)
    y = act(F.linear(x, fc1.weight.to(dtype), b1.to(dtype)),
            tp.model_split(-1))
    y = tp.reduce_from_model(F.linear(y.float(),
                                      fc2.weight.to(dtype).float()))
    return y.to(dtype) + fc2.bias.to(dtype)


class WindowAttention(nn.Module):
    """The attention parameters of a block: qkv, proj and the rel-pos table."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        n = window_size * window_size
        rpi = relative_position_index(window_size, window_size)
        self.register_buffer("rpi", torch.from_numpy(rpi.reshape(-1)).long(),
                             persistent=False)
        self.n = n

    def rel_bias(self) -> torch.Tensor:
        """[heads, n, n] bias gathered from the table."""
        rel = self.relative_position_bias_table[self.rpi]
        return rel.reshape(self.n, self.n, -1).permute(2, 0, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinTransformerBlock(nn.Module):
    """LN -> (shifted) W-MSA -> residual -> LN -> MLP -> residual.

    The cyclic roll stays outside the fused block; a resolution no larger
    than the window shrinks the window to it and turns the shift off.
    ``kernel_mode``: "block" (the wrapper: kernels on CUDA tensors),
    "block_fwd" (kernel forward, autograd of the plain version backward),
    "attn" (LayerNorm, MLP and residuals in plain torch around the
    window-attention wrapper, whose kernels run on CUDA tensors) or False (the
    plain version everywhere).

    ``remat``: while gradients are recorded, the ``"attn"`` and plain modes
    run the block under ``torch.utils.checkpoint``, which keeps only its
    input and recomputes the rest in the backward (JAX's ``nn.remat`` around
    the block, which also does not look at the training flag). The drop-path
    multipliers are drawn before, outside the recomputed part, so the
    recomputation sees the same ones and the generator advances as without
    remat. The ``"block"`` and ``"block_fwd"`` modes save only the block's
    inputs already (``ops/swin_block.py``), so there the flag changes
    nothing.
    """

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 kernel_mode="block", dtype: torch.dtype = torch.float32,
                 drop_path: float = 0.0, remat: bool = False):
        super().__init__()
        if kernel_mode not in ("block", "block_fwd", "attn", False):
            raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
        if min(input_resolution) <= window_size:
            window_size = min(input_resolution)
            shift_size = 0
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift {shift_size} outside [0, {window_size})")
        self.dim, self.num_heads = dim, num_heads
        self.input_resolution = input_resolution
        self.window_size, self.shift_size = window_size, shift_size
        self.kernel_mode, self.dtype = kernel_mode, dtype
        self.drop_path = float(drop_path)
        self.remat = bool(remat)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        h, w = input_resolution
        mask = (torch.from_numpy(shifted_window_mask(h, w, window_size,
                                                     shift_size).copy())
                if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = self.input_resolution
        c = x.shape[-1]
        attn = self.attn
        qkv_b = (attn.qkv.bias if attn.qkv.bias is not None
                 else torch.zeros(3 * c, device=x.device))
        dpm = drop_path_multipliers(x.numel() // (h * w * c), self.drop_path,
                                    self.training, generator, x.device)
        body = (self._forward_attn if self.kernel_mode == "attn"
                else self._forward_block)
        if (self.remat and self.kernel_mode in ("attn", False)
                and torch.is_grad_enabled()):
            # nothing inside draws random numbers: no RNG state to replay
            return checkpoint(body, x, qkv_b, dpm, use_reentrant=False,
                              preserve_rng_state=False)
        return body(x, qkv_b, dpm)

    def _forward_block(self, x: torch.Tensor, qkv_b: torch.Tensor,
                       dpm: Optional[torch.Tensor]) -> torch.Tensor:
        """Roll -> the fused block (or its plain version) -> roll back, in
        ``[B, L, C]``."""
        h, w = self.input_resolution
        s, dt = self.shift_size, self.dtype
        c = x.shape[-1]
        attn, mlp = self.attn, self.mlp
        xb = x.reshape(-1, h, w, c).to(dt)
        if s > 0:
            xb = torch.roll(xb, shifts=(-s, -s), dims=(1, 2))
        if self.kernel_mode:
            block, kw = swin_block, dict(
                backward="plain" if self.kernel_mode == "block_fwd"
                else "kernel")
        else:
            block, kw = swin_block_reference, {}

        def operand(wt):
            return None if wt is None else wt.t().to(dt).contiguous()

        def run(xb, wqkv, wproj, w1, w2, **parts):
            return block(
                xb.contiguous(), operand(wqkv), qkv_b.to(dt),
                operand(wproj), attn.proj.bias.to(dt),
                attn.rel_bias().float(),
                self.norm1.weight, self.norm1.bias,
                self.norm2.weight, self.norm2.bias,
                operand(w1), mlp.fc1.bias, operand(w2), mlp.fc2.bias,
                self.attn_mask, dpm,
                window_size=self.window_size, num_heads=self.num_heads,
                eps=1e-5, **kw, **parts)

        if not self.kernel_mode and tp.tp_active():
            # the plain block with proj and the MLP on the weights' shards
            y = run(xb, tp.whole(attn.qkv.weight), None, None, None,
                    proj=self._proj_on_shards, ffn=lambda t: parallel_ffn(
                        mlp.fc1, mlp.fc2, t, lambda u, _: F.gelu(
                            u.float(), approximate="tanh").to(dt), dt))
        else:
            y = tp.data_shard_map(run, tp.active_mesh(), 1, 4)(
                xb, attn.qkv.weight, attn.proj.weight, mlp.fc1.weight,
                mlp.fc2.weight)
        if s > 0:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        return y.reshape(-1, h * w, c)

    def _proj_on_shards(self, out: torch.Tensor) -> torch.Tensor:
        """``out @ proj.weight.t()`` with the weight as it lies over
        ``'model'``: row-parallel on this rank's columns of ``out``, summed
        in f32 and rounded once, where it is split on its input dimension;
        else gathered whole."""
        wt, dt = self.attn.proj.weight, out.dtype
        if tp.split_on(wt, 1):
            part = tp.local_part(tp.copy_to_model(out), -1).float()
            return tp.reduce_from_model(part @ wt.t().to(dt).float()).to(dt)
        return out @ tp.whole(wt).t().to(dt)

    def _forward_attn(self, x: torch.Tensor, qkv_b: torch.Tensor,
                      dpm: Optional[torch.Tensor]) -> torch.Tensor:
        """LN -> roll -> windowed attention on the normalised, rolled grid ->
        roll back -> residual -> LN -> MLP -> residual, in ``[B, L, C]``."""
        h, w = self.input_resolution
        s, dt = self.shift_size, self.dtype
        c = x.shape[-1]
        attn, mlp = self.attn, self.mlp

        def ln(t, norm):
            return F.layer_norm(t.float(), (c,), norm.weight, norm.bias,
                                1e-5).to(dt)

        def drop_path(t, k):
            return t if dpm is None else t * dpm[:, k, None, None].to(dt)

        def run(x, wqkv, wproj, w1, w2):
            shortcut = x.to(dt)
            y = ln(x, self.norm1).reshape(-1, h, w, c)
            if s > 0:
                y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
            y = window_attention(
                y.contiguous(), wqkv.t().to(dt).contiguous(), qkv_b.to(dt),
                wproj.t().to(dt).contiguous(), attn.proj.bias.to(dt),
                attn.rel_bias().float(), self.attn_mask,
                window_size=self.window_size, num_heads=self.num_heads)
            if s > 0:
                y = torch.roll(y, shifts=(s, s), dims=(1, 2))
            x = shortcut + drop_path(y.reshape(-1, h * w, c), 0)
            y = F.linear(ln(x, self.norm2), w1.to(dt), mlp.fc1.bias.to(dt))
            y = F.linear(F.gelu(y, approximate="tanh"), w2.to(dt),
                         mlp.fc2.bias.to(dt))
            return x + drop_path(y, 1)

        return tp.data_shard_map(run, tp.active_mesh(), 1, 4)(
            x, attn.qkv.weight, attn.proj.weight, mlp.fc1.weight,
            mlp.fc2.weight)


class PatchMerging(nn.Module):
    """2x downsampling: 4-way strided concat -> LN -> Linear(4C -> 2C)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.norm = LayerNorm(4 * dim, 1e-5, dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        c = x.shape[-1]
        x = x.reshape(-1, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(-1, (h // 2) * (w // 2), 4 * c)
        return dense(self.reduction, self.norm(x), self.dtype)


def relative_coords_table(window_size: int) -> torch.Tensor:
    """SwinV2's ``[(2W-1)^2, 2]`` table of relative offsets (dy, dx), each
    over ``W - 1``, times 8, then ``sign(t) log2(|t| + 1) / log2(8)``."""
    if window_size < 2:
        raise ValueError(f"SwinV2's position bias needs windows of 2 or "
                         f"more, got {window_size}")
    r = torch.arange(-(window_size - 1), window_size, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)
    t = t / (window_size - 1) * 8.0
    return (torch.sign(t) * torch.log2(t.abs() + 1.0)
            / math.log2(8.0)).reshape(-1, 2)


class WindowAttentionV2(nn.Module):
    """The attention parameters of a SwinV2 block, under the published
    code's names: the logit scale of each head (``[heads, 1, 1]``, from ln
    10), the continuous position bias MLP ``cpb_mlp`` (Linear(2, 512) ->
    ReLU -> Linear(512, heads) without bias), ``qkv`` without bias and the
    separate ``q_bias`` and ``v_bias`` (k has none), ``proj``."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.register_buffer("relative_coords_table",
                             relative_coords_table(window_size),
                             persistent=False)
        rpi = relative_position_index(window_size, window_size)
        self.register_buffer("rpi", torch.from_numpy(rpi.reshape(-1)).long(),
                             persistent=False)
        self.n = window_size * window_size
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def qkv_bias(self) -> torch.Tensor:
        """``[3C]``: q's bias, zeros for k, v's bias."""
        return torch.cat([self.q_bias, torch.zeros_like(self.v_bias),
                          self.v_bias])

    def rel_bias(self) -> torch.Tensor:
        """``[heads, n, n]`` f32: ``16 sigmoid(cpb_mlp(coords))`` gathered
        by the relative-position index."""
        table = self.cpb_mlp(self.relative_coords_table)
        rel = table[self.rpi].reshape(self.n, self.n, -1).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(rel).contiguous()


class SwinV2TransformerBlock(nn.Module):
    """(shifted) scaled cosine W-MSA -> LN -> residual -> MLP -> LN ->
    residual (SwinV2's post-norm), with the continuous position bias.

    The bias ``[heads, n, n]`` is computed once a forward, inside the span
    ``strajnet.swinv2_cpb``, and handed to the block as the Swin-v1 block
    hands its table's gather; autograd of the MLP, the sigmoid and the
    gather carries its gradient. ``kernel_mode`` "block" runs :func:`~strajnet_tpu_torch.
    ops.swinv2_block.swinv2_block` (the kernels on CUDA tensors, the plain
    block on the CPU), False the plain block everywhere; the ``"attn"`` and
    ``"block_fwd"`` modes, ``remat`` and a ``('data', 'model')`` mesh are
    Swin-v1's alone and raise (the kernels' backward recomputes the block
    already). Drop-path draws two multipliers a block, as Swin-v1.
    """

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, kernel_mode="block",
                 dtype: torch.dtype = torch.float32,
                 drop_path: float = 0.0, remat: bool = False):
        super().__init__()
        if kernel_mode not in ("block", False):
            raise ValueError(f"the SwinV2 block runs in the 'block' and "
                             f"plain kernel modes, got {kernel_mode!r}")
        if remat:
            raise ValueError("the SwinV2 block takes no remat")
        if min(input_resolution) <= window_size:
            window_size = min(input_resolution)
            shift_size = 0
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift {shift_size} outside [0, {window_size})")
        self.dim, self.num_heads = dim, num_heads
        self.input_resolution = input_resolution
        self.window_size, self.shift_size = window_size, shift_size
        self.kernel_mode, self.dtype = kernel_mode, dtype
        self.drop_path = float(drop_path)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttentionV2(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        h, w = input_resolution
        mask = (torch.from_numpy(shifted_window_mask(h, w, window_size,
                                                     shift_size).copy())
                if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if tp.active_mesh() is not None:
            raise NotImplementedError(
                "the SwinV2 block runs without a ('data', 'model') mesh")
        h, w = self.input_resolution
        c = x.shape[-1]
        dpm = drop_path_multipliers(x.numel() // (h * w * c), self.drop_path,
                                    self.training, generator, x.device)
        s, dt = self.shift_size, self.dtype
        attn, mlp = self.attn, self.mlp
        with span("strajnet.swinv2_cpb"):
            rel = attn.rel_bias()
        xb = x.reshape(-1, h, w, c).to(dt)
        if s > 0:
            xb = torch.roll(xb, shifts=(-s, -s), dims=(1, 2))
        block = swinv2_block if self.kernel_mode else swinv2_block_reference

        def operand(wt):
            return wt.t().to(dt).contiguous()

        y = block(xb.contiguous(), operand(attn.qkv.weight),
                  attn.qkv_bias().to(dt), operand(attn.proj.weight),
                  attn.proj.bias.to(dt), rel, attn.logit_scale.reshape(-1),
                  self.norm1.weight, self.norm1.bias, self.norm2.weight,
                  self.norm2.bias, operand(mlp.fc1.weight), mlp.fc1.bias,
                  operand(mlp.fc2.weight), mlp.fc2.bias, self.attn_mask, dpm,
                  window_size=self.window_size, num_heads=self.num_heads,
                  eps=1e-5)
        if s > 0:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        return y.reshape(-1, h * w, c)


class PatchMergingV2(nn.Module):
    """SwinV2's 2x downsampling: 4-way strided concat -> Linear(4C -> 2C)
    -> LN(2C) (Swin-v1 normalises first)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, 1e-5, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        c = x.shape[-1]
        x = x.reshape(-1, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(-1, (h // 2) * (w // 2), 4 * c)
        return self.norm(dense(self.reduction, x, self.dtype))


class BasicLayer(nn.Module):
    """One Swin stage: ``depth`` blocks alternating shift 0 / ws//2, then an
    optional PatchMerging. Returns (x_down, pre-downsample residual)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 downsample: bool = False, kernel_mode="block",
                 dtype: torch.dtype = torch.float32,
                 drop_path: Sequence[float] = (), remat: bool = False,
                 spatial_shard: bool = False, block: str = "swin"):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"unknown block {block!r}, not in {BLOCKS}")
        self.depth, self.spatial_shard = depth, spatial_shard
        for i in range(depth):
            shift = 0 if i % 2 == 0 else window_size // 2
            rate = drop_path[i] if len(drop_path) else 0.0
            self.add_module(f"blocks{i}", SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size, shift,
                mlp_ratio, qkv_bias, kernel_mode, dtype, rate, remat)
                if block == "swin" else SwinV2TransformerBlock(
                dim, input_resolution, num_heads, window_size, shift,
                mlp_ratio, kernel_mode, dtype, rate, remat))
        merging = PatchMerging if block == "swin" else PatchMergingV2
        self.downsample = (merging(input_resolution, dim, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"blocks{i}")(x, generator)
            if self.spatial_shard:
                # tokens over 'model' (row-major L = H*W: an H split)
                x = tp.sharding_hint(x, tp.DATA, tp.MODEL, None)
        res = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, res


class PatchUpsampling(nn.Module):
    """2x nearest upsampling of ``[B, H, W, C]`` -> Dense(C/2) without bias
    (``up_emb``)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.up_emb = nn.Linear(dim, dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return dense(self.up_emb, x, self.dtype)


class BasicLayerDecoder(nn.Module):
    """Swin upsampling stage: :class:`PatchUpsampling` of the ``[B, H, W,
    dim]`` input, with ``res_connection`` plus a 1x1 conv of ``res``
    (reshaped to the upsampled grid), LayerNorm, then ``depth`` Swin blocks
    of ``dim // 2`` channels with alternating shifts at ``2H x 2W``; returns
    ``[B, 2H, 2W, dim // 2]``. ``input_resolution`` is ``(H, W)`` (the JAX
    module reads the blocks' resolution off the upsampled input; the port
    builds their shift masks up front). Its blocks take ``kernel_mode`` as
    the encoder's do, so on the card they run the fused Swin-block kernels.
    Nothing in the model builds it; the reference defines it beside the
    encoder's stage."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: Sequence[float] = (),
                 res_connection: bool = False, kernel_mode="block",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depth = dtype, depth
        c = dim // 2
        self.resolution = (2 * input_resolution[0], 2 * input_resolution[1])
        self.upsample = PatchUpsampling(dim, dtype)
        self.conv_layer = nn.Conv2d(c, c, 1) if res_connection else None
        self.norm = LayerNorm(c, 1e-5, dtype)
        for i in range(depth):
            self.add_module(f"blocks{i}", SwinTransformerBlock(
                c, self.resolution, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                kernel_mode, dtype, drop_path[i] if len(drop_path) else 0.0))

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.upsample(x)
        b, h, w, c = x.shape
        if (h, w) != self.resolution:
            raise ValueError(f"upsampled grid {(h, w)}, the blocks were "
                             f"built for {self.resolution}")
        if self.conv_layer is not None:
            dt = self.dtype
            x = x + conv2d_nhwc(res.reshape(b, h, w, c).to(dt),
                                self.conv_layer.weight.to(dt),
                                self.conv_layer.bias.to(dt))
        x = self.norm(x.reshape(b, h * w, c))
        for i in range(self.depth):
            x = getattr(self, f"blocks{i}")(x, generator)
        return x.reshape(b, h, w, c)


class PatchEmbed(nn.Module):
    """Strided-conv patchify -> tokens -> LN."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 use_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        dt = self.dtype
        x = conv2d_nhwc(x.to(dt), self.proj.weight.to(dt),
                        self.proj.bias.to(dt), stride=self.patch_size)
        x = x.reshape(b, -1, x.shape[-1])
        return self.norm(x) if self.norm is not None else x


def _center_crop_tokens(res: torch.Tensor, grid: int, dim: int):
    """Centre-crops a token grid to its middle half."""
    c_b, c_e = grid // 4, (3 * grid) // 4
    crop = grid // 2
    res = res.reshape(-1, grid, grid, dim)[:, c_b:c_e, c_b:c_e, :]
    return res.reshape(-1, crop * crop, dim)


class SwinTransformerEncoder(nn.Module):
    """3-branch hierarchical encoder over the OGM / map / flow rasters.

    Returns ``res_list``: the flow branch's residual first where there is a
    flow stage (``sep_encode``, ``flow_sep``, ``use_flow`` and a map), then
    one residual per stage; at the flagship config
    ``[64^2 x 96, 64^2 x 96, 32^2 x 192, 16^2 x 384]``.
    """

    def __init__(self, img_size: Tuple[int, int] = (512, 512),
                 patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12), window_size: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 patch_norm: bool = True, ogm_past_steps: int = 11,
                 kernel_mode="block", dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, remat: bool = False,
                 ape: bool = False, sep_encode: bool = True,
                 no_map: bool = False, flow_sep: bool = True,
                 use_flow: bool = True, large_input: bool = True,
                 ogm_classes: int = 2, spatial_shard: bool = False,
                 block: str = "swin"):
        super().__init__()
        if drop_rate or attn_drop_rate:
            raise NotImplementedError(
                f"drop_rate={drop_rate}, attn_drop_rate={attn_drop_rate}: "
                f"the fused Swin block has no place for dropout inside the "
                f"block; every supported config sets both to 0")
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.num_layers = len(depths)
        self.embed_dim, self.dtype = embed_dim, dtype
        self.pr = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.sep_encode, self.no_map = sep_encode, no_map
        self.flow_sep, self.use_flow = flow_sep, use_flow
        self.large_input, self.ape = large_input, ape
        # the flow through a Swin stage of its own
        self.flow_stage = sep_encode and not no_map and flow_sep and use_flow

        def stage(i: int, downsample: bool) -> BasicLayer:
            return BasicLayer(
                int(embed_dim * 2 ** i),
                (self.pr[0] // 2 ** i, self.pr[1] // 2 ** i), depths[i],
                num_heads[i], window_size, mlp_ratio, qkv_bias, downsample,
                kernel_mode, dtype,
                tuple(dpr[sum(depths[:i]):sum(depths[:i + 1])]), remat,
                spatial_shard, block)

        def embed(in_chans: int) -> PatchEmbed:
            return PatchEmbed(patch_size, in_chans, embed_dim, patch_norm,
                              dtype)

        if sep_encode:
            self.patch_embed_vehicle = embed(ogm_past_steps)
            if self.flow_stage:
                self.flow_norm = LayerNorm(embed_dim, 1e-5, dtype)
                self.flow_layer = stage(0, self.num_layers > 1)
            if not no_map:
                self.patch_embed_map = embed(3)
                if use_flow:
                    self.patch_embed_flow = embed(2)
        else:
            in_chans = ogm_past_steps * ogm_classes
            if not no_map and use_flow:
                in_chans += 3 + 2
            elif not use_flow:
                in_chans += 3
            self.patch_embed_vehicle = embed(in_chans)
        if ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, self.pr[0] * self.pr[1], embed_dim))
        self.all_patch_norm = LayerNorm(embed_dim, 1e-5, dtype)
        for i in range(self.num_layers):
            self.add_module(f"layers{i}", stage(i, i < self.num_layers - 1))

    def forward(self, ogm: torch.Tensor, map_img: torch.Tensor,
                flow: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        dt, pr, e = self.dtype, self.pr, self.embed_dim
        ogm, map_img = ogm.to(dt), map_img.to(dt)
        flow_x = flow_res = None
        if self.sep_encode:
            vec = ogm[..., 0]  # the vehicle channel only
            if self.no_map:
                x = self.patch_embed_vehicle(vec)
            elif self.flow_stage:
                f = self.flow_norm(self.patch_embed_flow(flow.to(dt)))
                flow_x, flow_res = self.flow_layer(f, generator)
                x = self.patch_embed_vehicle(vec)
                maps = self.patch_embed_map(map_img)
                if self.large_input:
                    # the map raster covers the centre half of the patch
                    # grid: zero-pad it out to the full grid
                    mg, pad = pr[0] // 2, pr[0] // 4
                    maps = F.pad(maps.reshape(-1, mg, mg, e),
                                 (0, 0, pad, pad, pad, pad))
                    maps = maps.reshape(-1, pr[0] * pr[1], e)
                x = x + maps
            else:
                x = self.patch_embed_vehicle(vec)
                x = x + self.patch_embed_map(map_img)
                if self.use_flow:
                    x = x + self.patch_embed_flow(flow.to(dt))
        else:
            b, h, w, t, cc = ogm.shape
            x = ogm.reshape(-1, h, w, t * cc)
            if not self.no_map and self.use_flow:
                x = torch.cat([x, map_img, flow.to(dt)], dim=-1)
            elif not self.use_flow:
                x = torch.cat([x, map_img], dim=-1)
            x = self.patch_embed_vehicle(x)
        if self.ape:
            x = x + self.absolute_pos_embed.to(dt)
        x = self.all_patch_norm(x)

        res_list = []
        for i in range(self.num_layers):
            x, res = getattr(self, f"layers{i}")(x, generator)
            if i == 0 and self.flow_sep and self.use_flow:
                # flow_x is None where the wiring has no flow stage: raises,
                # as in JAX
                x = x + flow_x
                if self.large_input:
                    flow_res = _center_crop_tokens(flow_res, pr[0], e)
                res_list.append(flow_res)
            if self.large_input:
                res = _center_crop_tokens(res, pr[0] // 2 ** i, e * 2 ** i)
            res_list.append(res)
        return res_list
