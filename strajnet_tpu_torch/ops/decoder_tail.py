"""The fused decoder tail: upsample2x + conv3x3 -> elu -> conv3x3 to two
channels. CUDA kernel wrapper and its plain versions.

Counterpart of ``strajnet_tpu/ops/pallas_decoder_tail.py``. Every form
computes, for ``x [N, H, W, Cin]``,

    conv3x3(elu(conv3x3(upsample2x(x), w_up) + b_up), w_out) + b_out

with SAME padding on both convolutions, so the elu'd intermediate counts as
zero outside the ``2H x 2W`` image. Kernels keep the JAX layout, HWIO:
``w_up [3, 3, Cin, Cmid]``, ``w_out [3, 3, Cmid, 2]``.

- :func:`decoder_tail_reference`: the naive composition (``decoder_tail_xla``
  in JAX): the transposed conv of ``ops/upconv.py``, elu, a 3x3 conv. It
  writes the ``[N, 2H, 2W, Cmid]`` intermediate to device memory.
- :func:`decoder_tail_phase`: the same function in the phase domain
  (``decoder_tail_phase`` in JAX): a 2x2 VALID conv with the phase-folded
  kernel onto the ``(H+1) x (W+1)`` offset grid, elu, a mask for the entries
  that stand for pixels outside the image, a 2x2 VALID conv with the
  re-bucketed output kernel (:func:`build_ky`), one depth-to-space at two
  channels. Plain PyTorch, no kernel.
- :func:`decoder_tail`: on a CUDA tensor a kernel of the route
  :func:`kernel_route` picks from the element type and the widths, before
  any launch; on a CPU tensor the naive composition. Route ``"wgmma"``,
  ``csrc/decoder_tail.cu``, runs the phase form's two products on ``wgmma``
  and keeps the intermediate in shared memory; it is built for the model's
  tails in bf16, ``Cin = 96`` and ``Cmid = 48``, and a small kernel of the
  same source folds both kernels and packs them into the products' operand
  layout per launch. Route ``"any"``, ``csrc/decoder_tail_any.cu``, takes
  every other width, f32 or bf16: the same phase form as an implicit GEMM
  on ``mma.sync`` (bf16, or f32 as 3xTF32) per chunk of 16 intermediate
  channels, the intermediate in shared memory too, after a small kernel
  that folds the weights and pads them to the products' tiles (two
  launches a call). The backward is autograd of the
  naive composition, as the JAX custom VJP is: there is no backward kernel.
  What neither route takes (two output channels only), or a failed build
  or launch, raises. ``decoder_tail.launches`` counts the wgmma route's
  launches, ``decoder_tail.launches_any`` the general route's.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from strajnet_tpu_torch._build import check_tensors, launch, load_library
from strajnet_tpu_torch.ops.upconv import conv2d_nhwc, upsample2x_conv3x3

# _ROW_SETS[a][r]: rows of the 3x3 kernel folded into low-resolution tap r of
# output phase a (phase 0 reads input rows y-1, y; phase 1 reads y, y+1).
_ROW_SETS = (((0,), (1, 2)), ((0, 1), (2,)))


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


@functools.lru_cache(maxsize=None)
def _fold_selector() -> torch.Tensor:
    """[2, 2, 3] 0/1: ``[a, r, d]`` is 1 where row d of the 3x3 kernel folds
    into low-resolution tap r of output phase a."""
    sel = torch.zeros(2, 2, 3)
    for a in (0, 1):
        for r in (0, 1):
            sel[a, r, list(_ROW_SETS[a][r])] = 1.0
    return sel


def fold_kernel_2x(w3: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [2, 2, Cin, 4*Cout] phase-folded kernel.

    Output channel block p = 2*a + b holds the 2x2 kernel of output phase
    (a, b): upsampled pixel (2i+a, 2j+b) reads the input at rows i+a-1, i+a
    and columns j+b-1, j+b.
    """
    sel = _fold_selector().to(device=w3.device, dtype=w3.dtype)
    kf = torch.einsum("aud,bve,deio->uviabo", sel, sel, w3)
    return kf.reshape(2, 2, w3.shape[2], 4 * w3.shape[3])


def _outconv_tap(a: int, k: int):
    """Tap k of output phase a reads upsampled row 2i+a+k-1 = 2(i+d)+a2:
    returns (a2, d)."""
    a2 = (a + k - 1) % 2
    return a2, (a + k - 1 - a2) // 2


@functools.lru_cache(maxsize=None)
def _ky_selector() -> torch.Tensor:
    """[2, 2, 4, 4, 3, 3] 0/1: ``[u, v, p, q, kr, kc]`` is 1 where tap
    (kr, kc) of the 3x3 output conv, for output phase q = 2a+b, reads channel
    block p of the offset-grid entry at offset (u, v)."""
    sel = torch.zeros(2, 2, 4, 4, 3, 3)
    for a in (0, 1):
        for kr in range(3):
            a2, di = _outconv_tap(a, kr)
            for b in (0, 1):
                for kc in range(3):
                    b2, dj = _outconv_tap(b, kc)
                    sel[a2 + di, b2 + dj, 2 * a2 + b2, 2 * a + b, kr, kc] = 1.0
    return sel


def build_ky(wo: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cmid, 2] -> [2, 2, 4*Cmid, 8] offset-grid output kernel.

    On the offset grid (phase (a, b) of upsampled pixel (2i+a, 2j+b) sits at
    ``y[a+i, b+j, block 2a+b]``) the 3x3 conv over the upsampled image is a
    2x2 VALID conv; output lane (2a+b)*2+o holds phase (a, b), channel o.
    """
    sel = _ky_selector().to(device=wo.device, dtype=wo.dtype)
    ky = torch.einsum("uvpqrc,rcmo->uvpmqo", sel, wo)
    return ky.reshape(2, 2, 4 * wo.shape[2], 8)


def _offset_grid_mask(h: int, w: int, device=None) -> torch.Tensor:
    """[h+1, w+1, 4] 0/1: zero where an offset-grid entry stands for an
    upsampled pixel outside the image (the output conv's zero padding)."""
    m = torch.ones(h + 1, w + 1, 4, device=device)
    m[0, :, 2:] = 0.0        # a2 == 1 blocks at row 0 are row -1
    m[h, :, :2] = 0.0        # a2 == 0 blocks at row h are row 2h
    m[:, 0, 1::2] = 0.0      # b2 == 1 blocks at column 0
    m[:, w, 0::2] = 0.0      # b2 == 0 blocks at column w
    return m


def decoder_tail_reference(x, w_up, b_up, w_out, b_out) -> torch.Tensor:
    """The naive composition, in ``x.dtype``: [N, H, W, Cin] -> [N, 2H, 2W, 2]."""
    dt = x.dtype
    e = F.elu(upsample2x_conv3x3(x, _oihw(w_up), b_up))
    o = conv2d_nhwc(e, _oihw(w_out).to(dt), padding=1)
    return o + b_out.to(dt)


def decoder_tail_phase(x, w_up, b_up, w_out, b_out) -> torch.Tensor:
    """The tail in the phase domain: the elu'd intermediate stays
    phase-stacked at low resolution, ``[N, H+1, W+1, 4*Cmid]``."""
    n, h, w, _ = x.shape
    cmid = w_up.shape[3]
    dt = x.dtype
    kf = fold_kernel_2x(w_up.float()).to(dt)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = conv2d_nhwc(xp, _oihw(kf)) + b_up.repeat(4).to(dt)
    mask = _offset_grid_mask(h, w, x.device).repeat_interleave(cmid, dim=-1)
    e = F.elu(y) * mask.to(dt)
    o = conv2d_nhwc(e, _oihw(build_ky(w_out.float()).to(dt)))
    o = o.reshape(n, h, w, 2, 2, 2).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(n, 2 * h, 2 * w, 2) + b_out.to(dt)


KERNEL_WIDTHS = (96, 48)   # (Cin, Cmid) of the model's tails


def supports(h: int, w: int, cin: int, cmid: int, cout: int) -> bool:
    """Whether the wgmma kernel covers this geometry.

    It is built for the tails of the model: ``Cin = 96``, ``Cmid = 48``, two
    output channels. The gate of the JAX package also asks for a square image
    whose side divides into 16-row chunks: that serves the TPU kernel's row
    chunks; this kernel masks ragged edges itself and takes any image.
    """
    return cout == 2 and h > 0 and w > 0 and (cin, cmid) == KERNEL_WIDTHS


def kernel_route(dtype: torch.dtype, cin: int, cmid: int, cout: int) -> str:
    """The tail kernel's route for this element type and these widths:
    ``"wgmma"`` where ``csrc/decoder_tail.cu`` is built for them (bf16,
    ``(Cin, Cmid) == (96, 48)``), else ``"any"``, which takes every width in
    f32 or bf16 (a superset of the JAX gate's, ``pallas_decoder_tail.py::
    supports``, at any image size). Raises ValueError on what neither takes:
    an output other than two channels, another element type. Pure."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the decoder-tail kernels compute in float32 or "
                         f"bfloat16, got {dtype}")
    if cout != 2 or cin < 1 or cmid < 1:
        raise ValueError(f"the decoder-tail kernels take Cin, Cmid >= 1 and "
                         f"two output channels, got cin={cin}, cmid={cmid}, "
                         f"cout={cout}")
    if dtype == torch.bfloat16 and (cin, cmid) == KERNEL_WIDTHS:
        return "wgmma"
    return "any"


def kernel_smem_bytes() -> int:
    """Dynamic shared memory of one block of the kernel (builds it; needs
    nvcc)."""
    return int(load_library("decoder_tail").decoder_tail_smem_bytes())


def _check_4d(x, w_up, w_out) -> None:
    if x.dim() != 4 or w_up.dim() != 4 or w_out.dim() != 4:
        raise ValueError(f"x, w_up and w_out must be 4-D, got "
                         f"{tuple(x.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_out.shape)}")


def check_launch_args(x, w_up, w_out) -> None:
    """Raises ValueError unless the wgmma kernel takes these arguments: bf16
    ``x [N, H, W, 96]``, ``w_up [3, 3, 96, 48]``, ``w_out [3, 3, 48, 2]``.
    Touches no kernel."""
    _check_4d(x, w_up, w_out)
    n, h, w, cin = x.shape
    cmid = w_up.shape[3]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x: dtype {x.dtype}, the kernel takes "
                         f"torch.bfloat16")
    if (tuple(w_up.shape) != (3, 3, cin, cmid)
            or tuple(w_out.shape) != (3, 3, cmid, 2)):
        raise ValueError(f"w_up {tuple(w_up.shape)} / w_out "
                         f"{tuple(w_out.shape)}: expected (3, 3, {cin}, "
                         f"Cmid) and (3, 3, Cmid, 2)")
    if n < 1 or not supports(h, w, cin, cmid, w_out.shape[3]):
        raise ValueError(f"the decoder-tail kernel does not cover n={n}, "
                         f"h={h}, w={w}, cin={cin}, cmid={cmid} (see "
                         f"supports)")


def check_general_args(x, w_up, w_out) -> None:
    """Raises ValueError unless the general kernel takes these arguments:
    ``x [N, H, W, Cin]`` in f32 or bf16 with N, H, W >= 1, ``w_up [3, 3,
    Cin, Cmid]``, ``w_out [3, 3, Cmid, 2]``. Touches no kernel."""
    _check_4d(x, w_up, w_out)
    n, h, w, cin = x.shape
    cmid = w_up.shape[3]
    kernel_route(x.dtype, cin, cmid, w_out.shape[3])
    if (tuple(w_up.shape) != (3, 3, cin, cmid)
            or tuple(w_out.shape) != (3, 3, cmid, 2)):
        raise ValueError(f"w_up {tuple(w_up.shape)} / w_out "
                         f"{tuple(w_out.shape)}: expected (3, 3, {cin}, "
                         f"Cmid) and (3, 3, Cmid, 2)")
    if min(n, h, w) < 1:
        raise ValueError(f"the decoder-tail kernel takes a non-empty image, "
                         f"got {tuple(x.shape)}")


def _launch(x, w_up, b_up, w_out, b_out):
    _check_4d(x, w_up, w_out)
    route = kernel_route(x.dtype, x.shape[3], w_up.shape[3], w_out.shape[3])
    launch = _launch_wgmma if route == "wgmma" else _launch_any
    return launch(x, w_up, b_up, w_out, b_out)


def _launch_any(x, w_up, b_up, w_out, b_out):
    check_general_args(x, w_up, w_out)
    n, h, w, cin = x.shape
    cmid = w_up.shape[3]
    f32 = torch.float32
    wu, bu, wo, bo = (t.to(f32).contiguous()
                      for t in (w_up, b_up, w_out, b_out))
    bf = int(x.dtype == torch.bfloat16)
    lib = load_library("decoder_tail_any")
    out = torch.empty(n, 2 * h, 2 * w, 2, dtype=x.dtype, device=x.device)
    # the folded weights, padded to the products' tiles
    scratch = torch.empty(lib.decoder_tail_any_scratch_bytes(bf, cin, cmid),
                          dtype=torch.uint8, device=x.device)
    check_tensors({"x": (x, x.dtype, (n, h, w, cin)),
                   "w_up": (wu, f32, (3, 3, cin, cmid)),
                   "b_up": (bu, f32, (cmid,)),
                   "w_out": (wo, f32, (3, 3, cmid, 2)),
                   "b_out": (bo, f32, (2,))}, x.device)
    launch(lib, "decoder_tail_any_fwd", x, wu, bu, wo, bo, out, scratch, bf,
           n, h, w, cin, cmid)
    decoder_tail.launches_any += 1
    return out


def _launch_wgmma(x, w_up, b_up, w_out, b_out):
    check_launch_args(x, w_up, w_out)
    n, h, w, cin = x.shape
    cmid = w_up.shape[3]
    bf, f32 = torch.bfloat16, torch.float32
    wu, bu, wo, bo = (t.to(f32).contiguous()
                      for t in (w_up, b_up, w_out, b_out))
    lib = load_library("decoder_tail")
    out = torch.empty(n, 2 * h, 2 * w, 2, dtype=bf, device=x.device)
    # the kernel's copy of both kernels, folded and packed into its tiles
    scratch = torch.empty(lib.decoder_tail_scratch_bytes(), dtype=torch.uint8,
                          device=x.device)
    check_tensors({"x": (x, bf, (n, h, w, cin)),
                   "w_up": (wu, f32, (3, 3, cin, cmid)),
                   "b_up": (bu, f32, (cmid,)),
                   "w_out": (wo, f32, (3, 3, cmid, 2)),
                   "b_out": (bo, f32, (2,))}, x.device)
    launch(lib, "decoder_tail_fwd", x, wu, bu, wo, bo, out, scratch, n, h, w,
           cin, cmid)
    decoder_tail.launches += 1
    return out


class _DecoderTailFn(torch.autograd.Function):
    """The kernel forward; the backward is autograd of the naive composition
    at the saved inputs."""

    @staticmethod
    def forward(ctx, x, w_up, b_up, w_out, b_out):
        ctx.save_for_backward(x, w_up, b_up, w_out, b_out)
        return _launch(x, w_up, b_up, w_out, b_out)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(decoder_tail_reference(*ins), ins, dy)
        return tuple(grads)


def decoder_tail(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                 w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Fused tail: conv3x3(elu(upconv2x(x, w_up) + b_up), w_out) + b_out.

    Args:
      x: [N, H, W, Cin] activations, f32 or bf16.
      w_up: [3, 3, Cin, Cmid] upconv kernel; b_up: [Cmid].
      w_out: [3, 3, Cmid, 2] output conv kernel; b_out: [2].

    Returns:
      [N, 2H, 2W, 2] in ``x.dtype``. Both kernels accumulate both
      convolutions in f32, add ``b_out`` in f32 and round the intermediate
      and the output once.
    """
    if x.device.type == "cpu":
        return decoder_tail_reference(x, w_up, b_up, w_out, b_out)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_tail runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    return _DecoderTailFn.apply(x.contiguous(), w_up, b_up, w_out, b_out)


decoder_tail.launches = 0
decoder_tail.launches_any = 0
