"""FPN-style 3D pyramid decoder over the waypoint axis.

Counterpart of ``strajnet_tpu/models/decoder.py::Pyramid3DDecoder`` on
STrajNet's path: ``use_pyramid``, ``flow_sep_decode``, ``rep_res``, no
ConvLSTM stage. Each branch's last upconv + elu + output conv is peeled off
the loop as in JAX and runs in the form ``use_tail_kernel`` names
(``ops/decoder_tail.py``): the naive composition, the phase form, or the
fused kernel. ``ConvLSTM2D`` (``conv_cnn`` / ``sep_conv``) is still to be
ported (ROADMAP.md).

Volumes are ``[B, T, H, W, C]``; the time-shared convs fold T into the batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.ops.decoder_tail import (decoder_tail,
                                                 decoder_tail_phase,
                                                 decoder_tail_reference)
from strajnet_tpu_torch.ops.upconv import upsample2x_conv3x3

DECODER_CHANNELS = (48, 96, 128, 192, 384)
# use_tail_kernel -> the tail's form; "infer" resolves at call time
_TAIL_FNS = {"xla": decoder_tail_reference, "phase": decoder_tail_phase,
             "kernel": decoder_tail}


class FusedUpConv(nn.Module):
    """UpSampling3D(1,2,2) + time-shared Conv2D(3x3, SAME) + elu."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 3, padding=1)
        self.dtype = dtype

    def upconv(self, x: torch.Tensor) -> torch.Tensor:
        """The pre-activation upconv of [B, T, H, W, C] -> [B*T, 2H, 2W, F]."""
        b, t, h, w, c = x.shape
        dt = self.dtype
        return upsample2x_conv3x3(x.reshape(b * t, h, w, c).to(dt),
                                  self.conv.weight, self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = x.shape
        return F.elu(self.upconv(x)).reshape(b, t, 2 * h, 2 * w, -1)


class TemporalConv(nn.Module):
    """Conv3D with kernel (kt, 1, 1), SAME padding over time, then elu.

    ``kernel`` keeps the Flax layout ``[kt, C, F]``. A time-constant input
    ``[B, 1, H, W, C]`` (the decoder's repeated pyramid skips) collapses to
    per-output-step summed kernels, one matmul; a ``[B, T, H, W, C]`` input
    takes the dense banded (T_in x T_out) form.
    """

    def __init__(self, in_features: int, features: int, kt: int = 8,
                 num_steps: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kt, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.kt, self.num_steps, self.dtype = kt, num_steps, dtype
        pad_lo = (kt - 1) // 2
        t = num_steps
        # tap dt_k of output step `to` reads input step to + dt_k - pad_lo
        ti_of = np.arange(kt)[:, None] + np.arange(t)[None, :] - pad_lo
        valid = ((ti_of >= 0) & (ti_of < t)).astype(np.float32)  # [kt, T]
        kidx = np.zeros((t, t), np.int64)
        band = np.zeros((t, t), np.float32)
        for d in range(kt):
            for to in range(t):
                ti = to + d - pad_lo
                if 0 <= ti < t:
                    kidx[ti, to] = d
                    band[ti, to] = 1.0
        self.register_buffer("valid", torch.from_numpy(valid),
                             persistent=False)
        self.register_buffer("kidx", torch.from_numpy(kidx), persistent=False)
        self.register_buffer("band", torch.from_numpy(band), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        t_in = x.shape[1]
        if t_in == 1:
            ksum = torch.einsum("kcf,ko->ocf", self.kernel, self.valid)
            y = torch.einsum("bhwc,ocf->bohwf", x[:, 0].to(dt), ksum.to(dt))
        else:
            if t_in != self.num_steps:
                raise ValueError(f"time axis {t_in}, expected 1 or "
                                 f"{self.num_steps}")
            wfull = self.kernel[self.kidx] * self.band[..., None, None]
            y = torch.einsum("bihwc,iocf->bohwf", x.to(dt), wfull.to(dt))
        return F.elu(y + self.bias.to(dt))


class Pyramid3DDecoder(nn.Module):
    """[B, T, h, w, C] bottleneck + encoder residuals -> [B, T, H, W, 4]
    with channels (observed, occluded, dx, dy).

    ``use_tail_kernel`` names the form of the two tails: "xla" the naive
    composition, "phase" the phase-domain form, "kernel" the fused kernel
    (``ops/decoder_tail.decoder_tail``: on a CUDA tensor it launches or
    raises, a geometry it does not cover included), "infer" the kernel in
    ``eval()`` mode and the naive composition in training. The aliases of
    ``ModelConfig.use_pallas_decoder_tail`` are resolved by
    ``models/strajnet.py::resolve_kernel_knobs``.
    """

    def __init__(self, in_dim: int, res_dims: Tuple[int, ...],
                 flow_res_dim: int, shallow_decode: int = 1,
                 num_waypoints: int = 8,
                 bottleneck_size: Tuple[int, int] = (16, 16),
                 dtype: torch.dtype = torch.float32,
                 use_tail_kernel: str = "xla"):
        super().__init__()
        if use_tail_kernel != "infer" and use_tail_kernel not in _TAIL_FNS:
            raise ValueError(f"unknown use_tail_kernel={use_tail_kernel!r}")
        self.use_tail_kernel = use_tail_kernel
        t = num_waypoints
        ch = DECODER_CHANNELS
        self.decode_inds = [4, 3, 2, 1, 0][shallow_decode:]
        self.ind_list = [2, 1, 0][shallow_decode:]
        self.reshape_dim = [bottleneck_size[0] * 2 ** (k + 1)
                            for k in range(len(self.ind_list))]
        self.num_waypoints, self.dtype = t, dtype
        occ_inds = self.decode_inds[:-1]
        tail_di = self.decode_inds[-1]
        c = in_dim
        for i, di in enumerate(occ_inds):
            self.add_module(f"upconv_{di}_0", FusedUpConv(c, ch[di], dtype))
            c = ch[di]
            if i < len(self.ind_list):
                self.add_module(f"resconv_{di}", TemporalConv(
                    res_dims[self.ind_list[i]], ch[di], t, t, dtype))
            if i == len(self.ind_list) - 1:
                flow_c = c
                self.resconv_f = TemporalConv(flow_res_dim, 128, t, t, dtype)
        self.add_module(f"upconv_{tail_di}_0", FusedUpConv(c, ch[tail_di],
                                                           dtype))
        self.outconv = nn.Conv2d(ch[tail_di], 2, 3, padding=1)
        fl_inds = self.decode_inds[-2:]
        for di in fl_inds[:-1]:
            self.add_module(f"upconvf_{di}_0", FusedUpConv(flow_c, ch[di],
                                                           dtype))
            flow_c = ch[di]
        self.add_module(f"upconvf_{fl_inds[-1]}_0",
                        FusedUpConv(flow_c, ch[fl_inds[-1]], dtype))
        self.outconv_f = nn.Conv2d(ch[fl_inds[-1]], 2, 3, padding=1)

    def _tail(self, up: FusedUpConv, out: nn.Conv2d,
              x: torch.Tensor) -> torch.Tensor:
        """Last upconv -> elu -> 3x3 output conv of one branch."""
        b, t, h, w, c = x.shape
        mode = self.use_tail_kernel
        if mode == "infer":
            mode = "xla" if self.training else "kernel"
        # the ops keep the JAX kernel layout, HWIO
        o = _TAIL_FNS[mode](x.reshape(b * t, h, w, c).to(self.dtype),
                            up.conv.weight.permute(2, 3, 1, 0), up.conv.bias,
                            out.weight.permute(2, 3, 1, 0), out.bias)
        return o.reshape(b, t, 2 * h, 2 * w, -1)

    def forward(self, x: torch.Tensor,
                res_list: List[torch.Tensor]) -> torch.Tensor:
        dt, t = self.dtype, self.num_waypoints
        x = x.to(dt)
        flow_res, res_list = res_list[0], res_list[1:]
        flow_x = None
        for i, di in enumerate(self.decode_inds[:-1]):
            x = getattr(self, f"upconv_{di}_0")(x)
            if i < len(self.ind_list):
                res = res_list[self.ind_list[i]]
                rd = self.reshape_dim[i]
                res = res.to(dt).reshape(-1, 1, rd, rd, res.shape[-1])
                x = x + getattr(self, f"resconv_{di}")(res)
            if i == len(self.ind_list) - 1:
                rd = self.reshape_dim[-1]
                fr = flow_res.to(dt).reshape(-1, 1, rd, rd,
                                             flow_res.shape[-1])
                flow_x = x + self.resconv_f(fr)
        y = self._tail(getattr(self, f"upconv_{self.decode_inds[-1]}_0"),
                       self.outconv, x)
        f = flow_x
        fl_inds = self.decode_inds[-2:]
        for di in fl_inds[:-1]:
            f = getattr(self, f"upconvf_{di}_0")(f)
        fo = self._tail(getattr(self, f"upconvf_{fl_inds[-1]}_0"),
                        self.outconv_f, f)
        return torch.cat([y, fo], dim=-1)
