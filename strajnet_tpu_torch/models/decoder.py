"""FPN-style 3D pyramid decoder over the waypoint axis.

Counterpart of ``strajnet_tpu/models/decoder.py`` with all of its flags:
``use_pyramid`` (the encoder residuals added through ``TemporalConv``),
``flow_sep_decode`` (a separate two-stage flow head seeded by the flow
residual; without it one head of 4 channels), ``conv_cnn`` (the first stage a
``ConvLSTM2D``), ``sep_conv`` (the flow head's first stage a ``ConvLSTM2D``
of 96), ``rep_res`` (each residual time-constant; without it reshaped to
``[-1, T, ...]``) and ``stp_grad`` (no gradient into the bottleneck and the
residuals). Where a branch ends in an upconv, its last upconv + elu + output
conv is peeled off the loop as in JAX and runs in the form
``use_tail_kernel`` names (``ops/decoder_tail.py``): the naive composition,
the phase form, or the fused kernel. ``TimeSharedConv`` is defined as in JAX
and, as there, no path calls it.

Volumes are ``[B, T, H, W, C]``; the time-shared convs fold T into the batch.

Under a ``('data', 'model')`` mesh (``parallel/mesh.py``) the fused tail
kernel (the ``"kernel"`` form, and ``"infer"`` in ``eval()``) runs inside
``data_shard_map`` on this rank's rows, and ``spatial_shard`` hints each
volume of the upsampling stages split over ``'model'`` on its H axis, as
``strajnet_tpu/models/decoder.py`` does; the hint records that split and
leaves the volume whole (the halo exchange of a conv on H shards is not
done: nothing is computed split).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.ops.decoder_tail import (decoder_tail,
                                                 decoder_tail_phase,
                                                 decoder_tail_reference)
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc, upsample2x_conv3x3
from strajnet_tpu_torch.parallel import mesh as tp

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


def upsample2x_time(x: torch.Tensor) -> torch.Tensor:
    """UpSampling3D(size=(1, 2, 2)): nearest 2x over H and W."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class TimeSharedConv(nn.Module):
    """Conv2D (SAME) + elu applied to each waypoint of ``[B, T, H, W, C]``."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel,
                              padding=(kernel[0] // 2, kernel[1] // 2))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        dt = self.dtype
        y = conv2d_nhwc(x.reshape(b * t, h, w, c).to(dt),
                        self.conv.weight.to(dt), self.conv.bias.to(dt),
                        padding=self.conv.padding)
        return F.elu(y).reshape(b, t, h, w, -1)


class ConvLSTM2D(nn.Module):
    """ConvLSTM over the waypoint axis, Keras's ``ConvLSTM2D(activation=
    'elu')``: gates i, f, g, o from ``conv_x(x_t) + conv_h(h)`` (3x3 SAME,
    ``conv_h`` without bias), sigmoid gates, elu for the candidate and the
    output; zero initial state; returns every step's h."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = (kernel[0] // 2, kernel[1] // 2)
        self.conv_x = nn.Conv2d(in_features, 4 * features, kernel,
                                padding=pad)
        self.conv_h = nn.Conv2d(features, 4 * features, kernel, padding=pad,
                                bias=False)
        self.features, self.dtype = features, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        dt = self.dtype
        # the input half of every step's gates in one batched conv
        gx = conv2d_nhwc(x.reshape(b * t, h, w, c).to(dt),
                         self.conv_x.weight.to(dt), self.conv_x.bias.to(dt),
                         padding=self.conv_x.padding)
        gx = gx.reshape(b, t, h, w, -1)
        wh = self.conv_h.weight.to(dt)
        hs = x.new_zeros((b, h, w, self.features), dtype=dt)
        cs = hs
        outs = []
        for k in range(t):
            gates = gx[:, k] + conv2d_nhwc(hs, wh, padding=self.conv_h.padding)
            i, f, g, o = torch.split(gates, self.features, dim=-1)
            cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * F.elu(g)
            hs = torch.sigmoid(o) * F.elu(cs)
            outs.append(hs)
        return torch.stack(outs, dim=1)


class Pyramid3DDecoder(nn.Module):
    """[B, T, h, w, C] bottleneck + encoder residuals -> [B, T, H, W, 4]
    with channels (observed, occluded, dx, dy).

    ``res_dims`` are the channels of the residuals the decoder indexes and
    ``flow_res_dim`` that of the flow residual, which ``forward`` takes off
    the front of ``res_list`` under ``flow_sep_decode`` (as JAX does, whether
    or not the encoder made one). The module tree follows the flags with
    JAX's names: ``uplstmconv_{di}_0`` for the ``conv_cnn`` stage,
    ``upconvf_{di}_0`` a ``ConvLSTM2D`` under ``sep_conv``, no
    ``resconv_{di}`` without the pyramid, a plain ``outconv`` of 4 channels
    without ``flow_sep_decode``.

    ``use_tail_kernel`` names the form of the peeled tails: "xla" the naive
    composition, "phase" the phase-domain form, "kernel" the fused kernel
    (``ops/decoder_tail.decoder_tail``: on a CUDA tensor it launches or
    raises, a geometry it does not cover included), "infer" the kernel in
    ``eval()`` mode and the naive composition in training. The aliases of
    ``ModelConfig.use_pallas_decoder_tail`` are resolved by
    ``models/strajnet.py::resolve_kernel_knobs``.
    """

    def __init__(self, in_dim: int, res_dims: Sequence[int],
                 flow_res_dim: Optional[int], shallow_decode: int = 1,
                 num_waypoints: int = 8,
                 bottleneck_size: Tuple[int, int] = (16, 16),
                 dtype: torch.dtype = torch.float32,
                 use_tail_kernel: str = "xla", use_pyramid: bool = True,
                 flow_sep_decode: bool = True, conv_cnn: bool = False,
                 sep_conv: bool = False, rep_res: bool = True,
                 stp_grad: bool = False, spatial_shard: bool = False):
        super().__init__()
        if use_tail_kernel != "infer" and use_tail_kernel not in _TAIL_FNS:
            raise ValueError(f"unknown use_tail_kernel={use_tail_kernel!r}")
        self.use_tail_kernel = use_tail_kernel
        self.use_pyramid, self.flow_sep_decode = use_pyramid, flow_sep_decode
        self.conv_cnn, self.sep_conv = conv_cnn, sep_conv
        self.rep_res, self.stp_grad = rep_res, stp_grad
        self.spatial_shard = spatial_shard
        t = num_waypoints
        ch = DECODER_CHANNELS
        self.decode_inds = [4, 3, 2, 1, 0][shallow_decode:]
        self.ind_list = [2, 1, 0][shallow_decode:]
        self.reshape_dim = [bottleneck_size[0] * 2 ** (k + 1)
                            for k in range(len(self.ind_list))]
        self.num_waypoints, self.dtype = t, dtype
        # the last occ stage is peeled off to fuse with the output conv
        self.occ_inds, self.occ_tail_di = self.decode_inds, None
        if flow_sep_decode and not (conv_cnn and len(self.decode_inds) == 1):
            self.occ_tail_di = self.decode_inds[-1]
            self.occ_inds = self.decode_inds[:-1]
        c = flow_c = in_dim
        for i, di in enumerate(self.occ_inds):
            if conv_cnn and i == 0:
                self.add_module(f"uplstmconv_{di}_0",
                                ConvLSTM2D(c, ch[di], dtype=dtype))
            else:
                self.add_module(f"upconv_{di}_0",
                                FusedUpConv(c, ch[di], dtype))
            c = ch[di]
            if use_pyramid and i < len(self.ind_list):
                self.add_module(f"resconv_{di}", TemporalConv(
                    res_dims[self.ind_list[i]], ch[di], t, t, dtype))
            if flow_sep_decode and i == len(self.ind_list) - 1:
                flow_c = c
                self.resconv_f = TemporalConv(flow_res_dim, 128, t, t, dtype)
        out_dim = 2 if flow_sep_decode else 4
        if self.occ_tail_di is not None:
            di = self.occ_tail_di
            self.add_module(f"upconv_{di}_0", FusedUpConv(c, ch[di], dtype))
            c = ch[di]
        self.outconv = nn.Conv2d(c, out_dim, 3, padding=1)
        if not flow_sep_decode:
            return
        self.fl_inds, self.flow_tail_di = self.decode_inds[-2:], None
        if not (sep_conv and len(self.fl_inds) == 1):
            self.flow_tail_di = self.fl_inds[-1]
            self.fl_inds = self.fl_inds[:-1]
        for j, di in enumerate(self.fl_inds):
            if sep_conv and j == 0:
                self.add_module(f"upconvf_{di}_0",
                                ConvLSTM2D(flow_c, 96, dtype=dtype))
                flow_c = 96
            else:
                self.add_module(f"upconvf_{di}_0",
                                FusedUpConv(flow_c, ch[di], dtype))
                flow_c = ch[di]
        if self.flow_tail_di is not None:
            di = self.flow_tail_di
            self.add_module(f"upconvf_{di}_0",
                            FusedUpConv(flow_c, ch[di], dtype))
            flow_c = ch[di]
        self.outconv_f = nn.Conv2d(flow_c, 2, 3, padding=1)

    def _tail(self, up: FusedUpConv, out: nn.Conv2d,
              x: torch.Tensor) -> torch.Tensor:
        """Last upconv -> elu -> 3x3 output conv of one branch."""
        b, t, h, w, c = x.shape
        mode = self.use_tail_kernel
        if mode == "infer":
            mode = "xla" if self.training else "kernel"
        fn = _TAIL_FNS[mode]

        def run(x, w_up, b_up, w_out, b_out):
            # the ops keep the JAX kernel layout, HWIO
            return fn(x, w_up.permute(2, 3, 1, 0), b_up,
                      w_out.permute(2, 3, 1, 0), b_out)

        if mode == "kernel":
            run = tp.data_shard_map(run, tp.active_mesh(), 1, 4)
        o = run(x.reshape(b * t, h, w, c).to(self.dtype), up.conv.weight,
                up.conv.bias, out.weight, out.bias)
        return o.reshape(b, t, 2 * h, 2 * w, -1)

    def _sp(self, v: torch.Tensor) -> torch.Tensor:
        """``spatial_shard``'s hint on a ``[B, T, H, W, C]`` volume."""
        if not self.spatial_shard:
            return v
        return tp.sharding_hint(v, tp.DATA, None, tp.MODEL, None, None)

    def _out_conv(self, out: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A 3x3 output conv of a branch that ends in a ConvLSTM."""
        b, t, h, w, c = x.shape
        dt = self.dtype
        y = conv2d_nhwc(x.reshape(b * t, h, w, c).to(dt), out.weight.to(dt),
                        out.bias.to(dt), padding=1)
        return y.reshape(b, t, h, w, -1)

    def forward(self, x: torch.Tensor,
                res_list: List[torch.Tensor]) -> torch.Tensor:
        dt, t = self.dtype, self.num_waypoints
        x = x.to(dt)
        if self.stp_grad:
            x = x.detach()
        flow_res = None
        if self.flow_sep_decode:
            flow_res, res_list = res_list[0], res_list[1:]
        flow_x = None
        for i, di in enumerate(self.occ_inds):
            if self.conv_cnn and i == 0:
                x = getattr(self, f"uplstmconv_{di}_0")(upsample2x_time(x))
            else:
                x = getattr(self, f"upconv_{di}_0")(x)
            x = self._sp(x)
            if self.use_pyramid and i < len(self.ind_list):
                res = res_list[self.ind_list[i]]
                rd = self.reshape_dim[i]
                res = res.to(dt).reshape(-1, 1 if self.rep_res else t, rd,
                                         rd, res.shape[-1])
                if self.stp_grad:
                    res = res.detach()
                x = x + getattr(self, f"resconv_{di}")(res)
            if self.flow_sep_decode and i == len(self.ind_list) - 1:
                rd = self.reshape_dim[-1]
                fr = flow_res.to(dt).reshape(-1, 1, rd, rd,
                                             flow_res.shape[-1])
                flow_x = x + self.resconv_f(fr)
        if self.occ_tail_di is not None:
            y = self._tail(getattr(self, f"upconv_{self.occ_tail_di}_0"),
                           self.outconv, x)
        else:
            y = self._out_conv(self.outconv, x)
        if not self.flow_sep_decode:
            return y
        f = flow_x
        for j, di in enumerate(self.fl_inds):
            if self.sep_conv and j == 0:
                f = getattr(self, f"upconvf_{di}_0")(upsample2x_time(f))
            else:
                f = getattr(self, f"upconvf_{di}_0")(f)
            f = self._sp(f)
        if self.flow_tail_di is not None:
            fo = self._tail(getattr(self, f"upconvf_{self.flow_tail_di}_0"),
                            self.outconv_f, f)
        else:
            fo = self._out_conv(self.outconv_f, f)
        return torch.cat([y, fo], dim=-1)
