"""Nearest 2x upsample followed by a 3x3 SAME convolution, without the
upsampled intermediate.

Counterpart of ``strajnet_tpu/ops/upconv.py::upsample2x_conv3x3``, with the
formulation the JAX package gives XLA: conv3x3(upsample2x(x)) equals one
stride-2 transposed convolution of x with the composed 4x4 kernel
``K4[u, v] = sum_{a, b in {0, 1}} W3[u - a, v - b]``. Each output then reads
2x2 input taps instead of 3x3 taps of a 4x larger upsampled image, and the
upsampled image is never written. Plain PyTorch (cuDNN on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on ``[N, H, W, C]`` input with an OIHW weight.

    The NCHW view of an NHWC tensor is channels-last in memory, which cuDNN
    convolves without a copy; the output comes back as ``[N, H, W, O]``.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding, 1,
                 groups)
    return y.permute(0, 2, 3, 1)


def compose_upsample_kernel(w3: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> the [Cout, Cin, 4, 4] composed kernel."""
    k4 = w3.new_zeros(w3.shape[:2] + (4, 4))
    for a in (0, 1):
        for b in (0, 1):
            k4[:, :, a:a + 3, b:b + 3] += w3
    return k4


def upsample2x_conv3x3(x: torch.Tensor, w3: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(SAME)(nearest_upsample_2x(x)).

    Args:
      x: [N, H, W, Cin].
      w3: [Cout, Cin, 3, 3] kernel; composed in f32, run in x's dtype.
      bias: optional [Cout]; added in x's dtype.

    Returns:
      [N, 2H, 2W, Cout].
    """
    k4 = compose_upsample_kernel(w3.float()).to(x.dtype)
    # conv_transpose2d scatters x[i] * w[u] to output 2i + u - 1: the
    # flipped composed kernel, [Cin, Cout, 4, 4]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           k4.flip(2, 3).transpose(0, 1), stride=2,
                           padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
