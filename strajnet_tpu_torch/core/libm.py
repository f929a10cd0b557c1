"""Float32 sine, cosine and fused multiply-add, the same bits on any device.

The JAX package's rasterizer runs on XLA's CPU backend, which calls the C
library's ``sinf``/``cosf`` and contracts ``a * b + c`` into one fused
multiply-add where it compiles a jitted function. PyTorch's own ``sin`` and
``cos`` differ from the C library's in the last bit of about one result in
twenty, and differ again on the card; a last bit is enough to move a sampled
box point to the next grid cell. So the port computes them here, from basic
float64 operations, which round the same on the CPU and on the card:

- :func:`sinf` and :func:`cosf` follow the C library's algorithm (the
  sincosf of glibc 2.28 and later: a reduction by pi/2 in double, and
  polynomials in double rounded once to float32), with its constants and
  the order of its operations;
- :func:`fmaf` is ``a * b + c`` rounded once to float32: the product of two
  float32 values is exact in float64, and the float64 sum rounds twice only
  where it lands exactly on a float32 midpoint.
"""

from __future__ import annotations

import numpy as np
import torch

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi * 2**24
_HPI = float.fromhex("0x1.921FB54442D18p0")          # pi/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")       # pi/2 * 2**-63
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
# 4/pi to 192 bits, 8 new bits an entry
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)


def _top12(value: float) -> int:
    """The exponent and top 3 mantissa bits of a float32, by which the C
    library picks its path."""
    return (int(np.float32(value).view(np.uint32)) >> 20) & 0x7FF


_TOP_PIO4 = _top12(float.fromhex("0x1.921FB6p-1"))
_TOP_TINY = _top12(2.0 ** -12)
_TOP_120 = _top12(120.0)
_TOP_INF = _top12(float("inf"))


def _poly(x, x2, odd):
    """The C library's ``sinf_poly`` with its first table, in float64: the
    sine polynomial where ``odd`` is false, the cosine polynomial where it
    is true."""
    x3 = x * x2
    s1 = _S[1] + x2 * _S[2]
    x7 = x3 * x2
    s = x + x3 * _S[0]
    sin = s + x7 * s1
    x4 = x2 * x2
    c2 = _C[3] + x2 * _C[4]
    c1 = _C[0] + x2 * _C[1]
    x6 = x4 * x2
    c = c1 + x4 * _C[2]
    cos = c + x6 * c2
    return torch.where(odd, cos, sin)


def _reduce_large(y):
    """(x, n): y = n * pi/2 + x, for |y| >= 120, from the 4/pi bits in
    64-bit integer arithmetic that wraps as the C library's unsigned one."""
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    xi = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    arr = (xi >> 26) & 15
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    res0 = (m * table[arr]) & 0xFFFFFFFF
    res1 = m * table[arr + 4]
    res2 = m * table[arr + 8]
    res0 = ((res2 >> 32) & 0xFFFFFFFF) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * _PI63, n


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    if y.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {y.dtype}")
    x = y.to(torch.float64)
    top = (y.view(torch.int32) >> 20) & 0x7FF
    small = top < _TOP_PIO4
    large = top >= _TOP_120

    # |y| < 120: n = round(y * 2/pi) as the C library rounds without its
    # rounding intrinsics (truncate, add one half, shift)
    r = torch.where(large, 0.0, x) * _HPI_INV
    n = (torch.trunc(r).to(torch.int64) + 0x800000) >> 24
    xr = x - n.to(torch.float64) * _HPI
    xl, nl = _reduce_large(y)
    xr = torch.where(large, xl, xr)
    n = torch.where(large, nl, n)
    # the large reduction's quadrant takes in the sign of y
    quadrant = torch.where(large, nl + ((y.view(torch.int32) >> 31) & 1), n)
    sign = torch.where((quadrant & 3 == 1) | (quadrant & 3 == 2), -1.0, 1.0)
    xs = torch.where(small, x, xr * sign)
    x2 = torch.where(small, x * x, xr * xr)
    n = torch.where(small, 0, n)
    odd = (n & 1) == (0 if cos else 1)
    # the second table negates the cosine polynomial
    flip = odd & ~small & ((quadrant & 2) == 2)
    out = _poly(xs, x2, odd)
    out = torch.where(flip, -out, out).to(torch.float32)
    tiny = top < _TOP_TINY
    out = torch.where(tiny, torch.ones_like(y) if cos else y, out)
    # infinity and NaN: the C library's (y - y) / (y - y)
    return torch.where(top >= _TOP_INF, (y - y) / (y - y), out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """The C library's ``sinf`` of a float32 tensor, bit for bit."""
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """The C library's ``cosf`` of a float32 tensor, bit for bit."""
    return _sincosf(y, cos=True)


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, rounded once to float32."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)
