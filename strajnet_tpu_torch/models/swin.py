"""Swin-Transformer encoder.

Counterpart of ``strajnet_tpu/models/swin.py`` at the STrajNet wiring
(``sep_encode``, ``flow_sep``, ``use_flow``, ``large_input``, no absolute
position embedding). Module and parameter names follow the Flax tree so that
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
``nn.remat`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from strajnet_tpu_torch.ops.dropout import drop_path_multipliers
from strajnet_tpu_torch.ops.swin_block import swin_block, swin_block_reference
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc
from strajnet_tpu_torch.ops.window_attention import window_attention
from strajnet_tpu_torch.ops.windows import (relative_position_index,
                                            shifted_window_mask)


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
    """A Flax ``nn.Dense`` with compute dtype: operands and bias in dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
        y = block(
            xb.contiguous(),
            attn.qkv.weight.t().to(dt).contiguous(), qkv_b.to(dt),
            attn.proj.weight.t().to(dt).contiguous(), attn.proj.bias.to(dt),
            attn.rel_bias().float(),
            self.norm1.weight, self.norm1.bias,
            self.norm2.weight, self.norm2.bias,
            mlp.fc1.weight.t().to(dt).contiguous(), mlp.fc1.bias,
            mlp.fc2.weight.t().to(dt).contiguous(), mlp.fc2.bias,
            self.attn_mask, dpm,
            window_size=self.window_size, num_heads=self.num_heads, eps=1e-5,
            **kw)
        if s > 0:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        return y.reshape(-1, h * w, c)

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

        shortcut = x.to(dt)
        y = ln(x, self.norm1).reshape(-1, h, w, c)
        if s > 0:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        y = window_attention(
            y.contiguous(), attn.qkv.weight.t().to(dt).contiguous(),
            qkv_b.to(dt), attn.proj.weight.t().to(dt).contiguous(),
            attn.proj.bias.to(dt), attn.rel_bias().float(), self.attn_mask,
            window_size=self.window_size, num_heads=self.num_heads)
        if s > 0:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = shortcut + drop_path(y.reshape(-1, h * w, c), 0)
        y = dense(mlp.fc1, ln(x, self.norm2), dt)
        y = dense(mlp.fc2, F.gelu(y, approximate="tanh"), dt)
        return x + drop_path(y, 1)


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


class BasicLayer(nn.Module):
    """One Swin stage: ``depth`` blocks alternating shift 0 / ws//2, then an
    optional PatchMerging. Returns (x_down, pre-downsample residual)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 downsample: bool = False, kernel_mode="block",
                 dtype: torch.dtype = torch.float32,
                 drop_path: Sequence[float] = (), remat: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks{i}", SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                kernel_mode, dtype, drop_path[i] if len(drop_path) else 0.0,
                remat))
        self.downsample = (PatchMerging(input_resolution, dim, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"blocks{i}")(x, generator)
        res = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x, res


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

    Returns ``res_list = [flow_res, res0, res1, res2]``; at the flagship
    config ``[64^2 x 96, 64^2 x 96, 32^2 x 192, 16^2 x 384]``.
    """

    def __init__(self, img_size: Tuple[int, int] = (512, 512),
                 patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12), window_size: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 patch_norm: bool = True, ogm_past_steps: int = 11,
                 kernel_mode="block", dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, remat: bool = False):
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

        def stage(i: int, downsample: bool) -> BasicLayer:
            return BasicLayer(
                int(embed_dim * 2 ** i),
                (self.pr[0] // 2 ** i, self.pr[1] // 2 ** i), depths[i],
                num_heads[i], window_size, mlp_ratio, qkv_bias, downsample,
                kernel_mode, dtype,
                tuple(dpr[sum(depths[:i]):sum(depths[:i + 1])]), remat)

        self.patch_embed_flow = PatchEmbed(patch_size, 2, embed_dim,
                                           patch_norm, dtype)
        self.flow_norm = LayerNorm(embed_dim, 1e-5, dtype)
        self.flow_layer = stage(0, self.num_layers > 1)
        self.patch_embed_vehicle = PatchEmbed(patch_size, ogm_past_steps,
                                              embed_dim, patch_norm, dtype)
        self.patch_embed_map = PatchEmbed(patch_size, 3, embed_dim,
                                          patch_norm, dtype)
        self.all_patch_norm = LayerNorm(embed_dim, 1e-5, dtype)
        for i in range(self.num_layers):
            self.add_module(f"layers{i}", stage(i, i < self.num_layers - 1))

    def forward(self, ogm: torch.Tensor, map_img: torch.Tensor,
                flow: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        dt, pr, e = self.dtype, self.pr, self.embed_dim
        vec = ogm[..., 0].to(dt)  # the vehicle channel only
        f = self.flow_norm(self.patch_embed_flow(flow.to(dt)))
        flow_x, flow_res = self.flow_layer(f, generator)
        x = self.patch_embed_vehicle(vec)
        maps = self.patch_embed_map(map_img.to(dt))
        # the map raster covers the centre half of the patch grid: zero-pad
        # it out to the full grid
        mg, pad = pr[0] // 2, pr[0] // 4
        maps = F.pad(maps.reshape(-1, mg, mg, e), (0, 0, pad, pad, pad, pad))
        x = self.all_patch_norm(x + maps.reshape(-1, pr[0] * pr[1], e))

        res_list = []
        for i in range(self.num_layers):
            x, res = getattr(self, f"layers{i}")(x, generator)
            if i == 0:
                x = x + flow_x
                res_list.append(_center_crop_tokens(flow_res, pr[0], e))
            res_list.append(_center_crop_tokens(res, pr[0] // 2 ** i,
                                                e * 2 ** i))
        return res_list
