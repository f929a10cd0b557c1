"""Dense bilinear warp gather: CUDA kernels, wrappers and plain versions.

Counterpart of ``strajnet_tpu/ops/pallas_warp_gather.py``. The warp loss and
the flow-grounded metrics sample a ``[S, H, W, 1]`` occupancy grid at
``identity + flow`` with INTEGER pixels and a ZERO border.
:func:`sample_dense` computes the floor indices and the blend weights in
PyTorch, with the expression tree of ``core.sampling.interpolate_bilinear``,
and fetches the four corners ``img[y0 + a, x0 + b]`` of the zero-padded image
through :func:`gather_corners`:

- a CUDA image launches ``csrc/warp_gather.cu`` (forward: one thread per
  query loads its four corners; backward: one block per band of rows of a
  slice's image cotangent, summed in shared memory and written once) or
  raises; there is no fallback;
- a CPU image takes the plain versions :func:`gather_corners_reference` and
  :func:`scatter_corners_reference`.

The gather is exact for any f32 image. The floor indices carry no gradient;
the gradient with respect to the query coordinates flows through the blend
weights by autograd, as on the portable path. ``warp_gather_fwd.launches`` and
``warp_gather_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Corners = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# Bands of rows per image slice in the backward kernel, at least: each band
# is one block, which reads the whole slice's floor rows (the bands of a
# slice run side by side, so all but the first read come from L2). A 258 x
# 258 slice needs two; three or four were slower on the H100 (PERF.md).
BWD_BANDS = 2
# Shared memory one block may take on the H100, bytes.
_MAX_SMEM = 232448


def _corner_index(x0f: torch.Tensor, y0f: torch.Tensor, wp: int):
    return y0f.long() * wp + x0f.long()


def gather_corners_reference(img: torch.Tensor, x0f: torch.Tensor,
                             y0f: torch.Tensor) -> Corners:
    """Plain four-corner gather by indexing: ``c_ab = img[s, y0+a, x0+b]``."""
    s, hp, wp = img.shape
    flat = img.reshape(s, hp * wp)
    base = _corner_index(x0f, y0f, wp)
    rows = torch.arange(s, device=img.device)[:, None]
    return tuple(flat[rows, base + off] for off in (0, 1, wp, wp + 1))


def scatter_corners_reference(img_shape: Sequence[int], x0f: torch.Tensor,
                              y0f: torch.Tensor,
                              gs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain scatter of the four corner cotangents into ``[S, Hp, Wp]``."""
    s, hp, wp = img_shape
    base = _corner_index(x0f, y0f, wp)
    base = base + (torch.arange(s, device=base.device) * (hp * wp))[:, None]
    dimg = torch.zeros(s * hp * wp, dtype=torch.float32, device=base.device)
    for off, g in zip((0, 1, wp, wp + 1), gs):
        dimg.index_add_(0, (base + off).reshape(-1),
                        g.reshape(-1).to(torch.float32))
    return dimg.reshape(s, hp, wp)


def _check(img, x0f, y0f, extra=()):
    if img.dim() != 3 or x0f.dim() != 2 or x0f.shape != y0f.shape \
            or x0f.shape[0] != img.shape[0]:
        raise ValueError(f"img [S, Hp, Wp] and x0f/y0f [S, N] expected, got "
                         f"{tuple(img.shape)}, {tuple(x0f.shape)}, "
                         f"{tuple(y0f.shape)}")
    for name, t in extra:
        if t.shape != x0f.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(x0f.shape)}")
    for name, t in (("img", img), ("x0f", x0f), ("y0f", y0f), *extra):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")


def _lib():
    from strajnet_tpu_torch._build import load_library

    lib = load_library("warp_gather")
    if not getattr(lib, "_bound", False):
        lib.warp_gather_fwd.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        lib.warp_gather_fwd.restype = ctypes.c_int
        lib.warp_gather_bwd.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p])
        lib.warp_gather_bwd.restype = ctypes.c_int
        lib._bound = True
    return lib


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def warp_gather_fwd(img: torch.Tensor, x0f: torch.Tensor,
                    y0f: torch.Tensor) -> Corners:
    """The four corners of every query; the kernel on CUDA, plain on the CPU.

    Args:
      img: [S, Hp, Wp] f32 zero-padded image.
      x0f, y0f: [S, N] f32 holding integer floor indices with
        ``0 <= x0 <= Wp-2`` and ``0 <= y0 <= Hp-2``.

    Returns:
      ``(c00, c01, c10, c11)``, each [S, N] f32.
    """
    if img.device.type == "cpu":
        return gather_corners_reference(img, x0f, y0f)
    if img.device.type != "cuda":
        raise ValueError(f"warp_gather runs on CPU or CUDA tensors, got "
                         f"{img.device}")
    _check(img, x0f, y0f)
    s, hp, wp = img.shape
    n = x0f.shape[1]
    out = tuple(torch.empty(s, n, dtype=torch.float32, device=img.device)
                for _ in range(4))
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _lib().warp_gather_fwd(_ptr(img), _ptr(x0f), _ptr(y0f),
                                 *(_ptr(o) for o in out), s, n, hp, wp,
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"warp_gather_fwd kernel launch failed with CUDA "
                           f"error {err}")
    warp_gather_fwd.launches += 1
    return out


def bwd_band_rows(hp: int, wp: int, bands: Optional[int] = None) -> int:
    """Rows of one band of the backward kernel for a ``[Hp, Wp]`` slice: the
    slice cut into ``bands`` (default :data:`BWD_BANDS`) or into as many as
    shared memory needs, whichever are more. Raises ValueError when one row
    of ``Wp`` floats does not fit a block's shared memory."""
    if 4 * wp > _MAX_SMEM:
        raise ValueError(f"one row of Wp={wp} floats does not fit the "
                         f"{_MAX_SMEM} bytes of shared memory of a block")
    want = max(BWD_BANDS if bands is None else bands,
               math.ceil(4 * hp * wp / _MAX_SMEM))
    rows = math.ceil(hp / want)
    return min(rows, _MAX_SMEM // (4 * wp))


def band_edge_rows(hp: int, rows: int) -> Tuple[int, ...]:
    """Floor rows ``y0`` (``0 <= y0 <= Hp - 2``) at which the backward's
    bands of ``rows`` rows meet, with the first and the last: a query on
    one of them has its two corner rows in two bands, or sits at the
    image's edge."""
    near = {0, hp - 2}
    for r in range(rows, hp, rows):
        near.update((r - 2, r - 1, r))
    return tuple(sorted(y for y in near if 0 <= y <= hp - 2))


def warp_gather_bwd(img_shape: Sequence[int], x0f: torch.Tensor,
                    y0f: torch.Tensor, gs: Sequence[torch.Tensor],
                    bands: Optional[int] = None) -> torch.Tensor:
    """The image cotangent [S, Hp, Wp] f32 of :func:`warp_gather_fwd`;
    ``bands`` as in :func:`bwd_band_rows`."""
    if x0f.device.type == "cpu":
        return scatter_corners_reference(img_shape, x0f, y0f, gs)
    if x0f.device.type != "cuda":
        raise ValueError(f"warp_gather runs on CPU or CUDA tensors, got "
                         f"{x0f.device}")
    s, hp, wp = img_shape
    if hp < 2 or wp < 2:
        raise ValueError(f"the padded image must be at least 2 x 2, got "
                         f"{hp} x {wp}")
    rows = bwd_band_rows(hp, wp, bands)
    gs = tuple(g.contiguous() for g in gs)
    dimg = torch.empty(s, hp, wp, dtype=torch.float32, device=x0f.device)
    _check(dimg, x0f, y0f, tuple((f"g{i}", g) for i, g in enumerate(gs)))
    n = x0f.shape[1]
    stream = torch.cuda.current_stream(x0f.device).cuda_stream
    err = _lib().warp_gather_bwd(_ptr(x0f), _ptr(y0f),
                                 *(_ptr(g) for g in gs), _ptr(dimg), s, n,
                                 hp, wp, rows, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"warp_gather_bwd kernel launch failed with CUDA "
                           f"error {err}")
    warp_gather_bwd.launches += 1
    return dimg


warp_gather_fwd.launches = 0
warp_gather_bwd.launches = 0


class _GatherCorners(torch.autograd.Function):
    """``(img, x0f, y0f) -> (c00, c01, c10, c11)``; the image cotangent comes
    from the scatter, the integer indices get none."""

    @staticmethod
    def forward(ctx, img, x0f, y0f):
        ctx.save_for_backward(x0f, y0f)
        ctx.img_shape = tuple(img.shape)
        return warp_gather_fwd(img, x0f, y0f)

    @staticmethod
    def backward(ctx, *gs):
        dimg = None
        if ctx.needs_input_grad[0]:
            x0f, y0f = ctx.saved_tensors
            dimg = warp_gather_bwd(ctx.img_shape, x0f, y0f, gs)
        return dimg, None, None


def gather_corners(img: torch.Tensor, x0f: torch.Tensor,
                   y0f: torch.Tensor) -> Corners:
    """Differentiable (in ``img``) four-corner gather; see the module doc."""
    return _GatherCorners.apply(img, x0f, y0f)


def supports(image: torch.Tensor, warp: torch.Tensor) -> bool:
    """True when :func:`sample_dense` applies to this (image, warp) pair:
    a single-channel ``[S, H, W, 1]`` image and ``[S, ..., 2]`` queries."""
    return (image.dim() == 4 and image.shape[-1] == 1
            and warp.dim() >= 2 and warp.shape[-1] == 2
            and warp.shape[0] == image.shape[0])


def sample_dense(image: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """Bilinear ZERO-border INTEGER-pixel sampling, the semantics of
    ``core.sampling.sample``, with the corner gather in the kernel.

    Args:
      image: [S, H, W, 1].
      warp: [S, ..., 2] (x, y) query coordinates.

    Returns:
      [S, ..., 1] f32, the portable path up to f32 blend rounding.
    """
    if not supports(image, warp):
        raise ValueError(f"sample_dense takes image [S, H, W, 1] and warp "
                         f"[S, ..., 2], got {tuple(image.shape)} and "
                         f"{tuple(warp.shape)}")
    s, h, w, _ = image.shape
    hp, wp = h + 2, w + 2
    img = F.pad(image[..., 0].float(), (1, 1, 1, 1)).contiguous()

    lead = warp.shape[:-1]
    q = warp.reshape(s, -1, 2).float()
    x = q[..., 0] + 1.0
    y = q[..., 1] + 1.0
    # the floor/clip expression tree of interpolate_bilinear, so autograd
    # through the clip boundaries matches the portable path
    y0f = torch.clamp(torch.floor(y), 0.0, float(hp - 2))
    ay = torch.clamp(y - y0f, 0.0, 1.0)
    x0f = torch.clamp(torch.floor(x), 0.0, float(wp - 2))
    ax = torch.clamp(x - x0f, 0.0, 1.0)

    c00, c01, c10, c11 = gather_corners(img, x0f.detach().contiguous(),
                                        y0f.detach().contiguous())
    interp_top = ax * (c01 - c00) + c00
    interp_bottom = ax * (c11 - c10) + c10
    out = ay * (interp_bottom - interp_top) + interp_top
    return out.reshape(lead + (1,))
