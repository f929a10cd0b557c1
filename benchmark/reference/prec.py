"""The precision of the plain reference's products.

Every matrix product and convolution of the reference goes through a
:class:`Prec`. :data:`EXACT` computes in float32 as it stands (the caller
turns TF32 off). :class:`Rounded` is the control of the correctness check:
the same reference with the operands of every product rounded to a lower
type and the sums kept in float32, as tensor cores compute. In training the
gradient that reaches a product's backward is rounded too, so the backward's
products take rounded operands as well.

- ``"bfloat16"``: operands and gradients rounded to bfloat16.
- ``"float8"``: operands rounded to float8 e4m3 and gradients to e5m2, each
  tensor scaled by its largest magnitude first (the usual fp8 recipe).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
        "e5m2": (torch.float8_e5m2, 57344.0)}


def round_to(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` (float32) rounded to ``fmt`` and back to float32."""
    if fmt == "bfloat16":
        return t.to(torch.bfloat16).float()
    dtype, top = _FP8[fmt]
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Operand(torch.autograd.Function):
    """Rounds a product's operand; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, t, fmt):
        return round_to(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Result(torch.autograd.Function):
    """The identity on a product's result; rounds the gradient that the
    product's backward receives."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.fmt), None


class Prec:
    """Float32 products; subclasses round their operands."""

    name = "float32"

    def a(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def linear(self, x, w, b: Optional[torch.Tensor] = None):
        y = self.r(F.linear(self.a(x), self.a(w)))
        return y if b is None else y + b

    def matmul(self, x, y):
        return self.r(torch.matmul(self.a(x), self.a(y)))

    def einsum(self, eq: str, x, y):
        return self.r(torch.einsum(eq, self.a(x), self.a(y)))

    def conv2d(self, x, w, b=None, stride: int = 1, padding=0,
               groups: int = 1):
        """``F.conv2d`` on ``[N, H, W, C]`` with an OIHW weight."""
        y = F.conv2d(self.a(x).permute(0, 3, 1, 2), self.a(w), None, stride,
                     padding, 1, groups)
        y = self.r(y.permute(0, 2, 3, 1))
        return y if b is None else y + b

    def conv_transpose2d(self, x, w, stride: int, padding: int):
        """``F.conv_transpose2d`` on ``[N, H, W, C]`` with an
        ``[in, out, kh, kw]`` weight."""
        y = F.conv_transpose2d(self.a(x).permute(0, 3, 1, 2), self.a(w),
                               stride=stride, padding=padding)
        return self.r(y.permute(0, 2, 3, 1))


class Rounded(Prec):
    """The products' operands rounded to ``"bfloat16"`` or ``"float8"``."""

    def __init__(self, name: str):
        formats = {"bfloat16": ("bfloat16", "bfloat16"),
                   "float8": ("e4m3", "e5m2")}
        if name not in formats:
            raise ValueError(f"no rounded precision {name!r}")
        self.name = name
        self.fwd, self.bwd = formats[name]

    def a(self, t):
        return _Operand.apply(t, self.fwd)

    def r(self, t):
        return _Result.apply(t, self.bwd) if t.requires_grad else t


EXACT = Prec()


def control_for(dtype: str) -> Prec:
    """The control's precision: the step below the configuration's type
    (fp8 below bfloat16, bfloat16 below a float32 that runs cuDNN's
    convolutions in TF32, PyTorch's default)."""
    return Rounded("float8" if dtype == "bfloat16" else "bfloat16")
