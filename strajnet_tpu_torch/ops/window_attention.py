"""Fused shifted-window attention, forward and backward: CUDA kernel wrappers
and their plain versions.

Counterpart of ``strajnet_tpu/ops/pallas_window_attention.py``.
:func:`window_attention` takes the arguments of ``fused_window_attention``
and computes, on pre-normalised, pre-rolled ``[B, H, W, C]`` input,

    proj(attention(window_partition(x)))

that is the qkv projection, per-head ``softmax(q k^T * scale + rel_bias +
mask) v`` inside each 8x8 window, the head merge and the output projection,
the result laid back on the grid. LayerNorm, the roll, the residuals and the
MLP stay with the caller (the ``"attn"`` mode of the Swin block).

A tensor on the CPU takes :func:`window_attention_reference` under autograd.
A CUDA tensor goes through a ``torch.autograd.Function``: the forward launches
``window_attention_fwd`` of ``csrc/window_attention.cu`` and saves only its
inputs; the backward launches ``window_attention_bwd``
(:func:`window_attention_bwd`), which recomputes qkv and the softmax and
returns dx and the five parameter gradients. Both are ``wgmma`` kernels on
the fused Swin block's device code, built as the Swin-block kernels are for C
of 96, 192 or 384 with head_dim 32; any other width raises before a launch
(the plain version serves every width on the CPU only). With
``backward="plain"`` the backward is autograd of the plain version instead,
which tells a fault of the backward kernel from one elsewhere. A failed build
or launch raises; there is no fallback.
:func:`window_attention_backward_reference` is the backward written out step
by step with the kernel's rounding points.
``window_attention.launches`` and ``window_attention_bwd.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from strajnet_tpu_torch.ops.swin_block import (check_attention_args,
                                               check_tensors, ptr)
from strajnet_tpu_torch.ops.windows import window_partition, window_reverse

GRAD_NAMES = ("dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
_FWD_KERNEL = "the window-attention forward kernels"
_BWD_KERNEL = "the window-attention backward kernels"


def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws*ws, C] f32, windows in row-major order."""
    return window_partition(t, ws).reshape(-1, ws * ws, t.shape[-1]).float()


def _attention_forward(xw, wqkv, bqkv, rel_bias, mask, heads, dt):
    """q, k, v ``[BW, heads, n, hd]`` (rounded to dt) and the f32 softmax."""
    bw, n, c = xw.shape
    hd = c // heads
    qkv = _rnd(xw @ _rnd(wqkv, dt) + bqkv.float(), dt)
    q, k, v = (t.reshape(bw, n, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + rel_bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, heads, n, n)
             + mask.float()[None, :, None]).reshape(bw, heads, n, n)
    return q, k, v, torch.softmax(s, dim=-1)


def window_attention_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                               mask=None, *, window_size: int,
                               num_heads: int) -> torch.Tensor:
    """Plain PyTorch windowed attention with the kernel's rounding points.

    Every product accumulates in f32 on operands in ``x.dtype``; qkv gets its
    bias in f32 and is rounded to ``x.dtype``; logits, bias, mask and softmax
    are f32; the softmax weights are rounded before ``P v``, the merged heads
    before the projection; the projection and its bias are f32 and rounded
    once on the way out.
    """
    b, h, w, c = x.shape
    dt = x.dtype
    xw = _windows(x, window_size)
    _, _, v, p = _attention_forward(xw, wqkv, bqkv, rel_bias, mask, num_heads,
                                    dt)
    merged = _rnd((_rnd(p, dt) @ v).transpose(1, 2).reshape(xw.shape), dt)
    y = merged @ _rnd(wproj, dt) + bproj.float()
    return window_reverse(y, window_size, h, w, c).to(dt)


def window_attention_backward_reference(
        x, wqkv, bqkv, wproj, rel_bias, mask, dy, *, window_size: int,
        num_heads: int, operand_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain PyTorch backward, step by step after the TPU ``_bwd_kernel``.

    Recomputes qkv and the softmax as the forward does, then walks back.
    Every backward product takes operands rounded to ``operand_dtype``
    (default ``x.dtype``; the JAX kernel always rounds to bf16) and
    accumulates in f32; ``dbqkv`` sums the rounded ``dqkv``; ``dbproj`` and
    ``dbias`` sum f32 values. The mask gets no gradient.

    Returns ``(dx, grads)``: dx in ``x.dtype`` and the five parameter
    gradients in f32, in the order of :data:`GRAD_NAMES`.
    """
    b, h, w, c = x.shape
    ws, heads = window_size, num_heads
    hd, n = c // heads, ws * ws
    scale = hd ** -0.5
    dt = x.dtype
    rd = dt if operand_dtype is None else operand_dtype

    def atb(a, bm):  # sum over windows and tokens of a^T b
        return a.reshape(-1, a.shape[-1]).t() @ bm.reshape(-1, bm.shape[-1])

    def heads_of(t):  # [BW, n, C] -> [BW, heads, n, hd]
        return t.reshape(-1, n, heads, hd).transpose(1, 2)

    xw = _windows(x, ws)
    dyw = _rnd(_windows(dy, ws), rd)
    q, k, v, p = _attention_forward(xw, wqkv, bqkv, rel_bias, mask, heads, dt)
    merged = (_rnd(p, dt) @ v).transpose(1, 2).reshape(-1, n, c)

    dwproj = atb(_rnd(merged, rd), dyw)
    dbproj = dyw.sum((0, 1))
    dmerged = dyw @ _rnd(_rnd(wproj, dt), rd).t()

    do = heads_of(_rnd(dmerged, rd))
    pb = _rnd(p, rd)
    dp = do @ _rnd(v, rd).transpose(-1, -2)
    dv = pb.transpose(-1, -2) @ do
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dsb = _rnd(ds, rd)
    dq = (dsb @ _rnd(k, rd)) * scale
    dk = (dsb.transpose(-1, -2) @ _rnd(q, rd)) * scale
    dqkv = _rnd(torch.cat([t.transpose(1, 2).reshape(-1, n, c)
                           for t in (dq, dk, dv)], dim=-1), rd)

    dwqkv = atb(_rnd(xw, rd), dqkv)
    dbqkv = dqkv.sum((0, 1))
    dxw = dqkv @ _rnd(_rnd(wqkv, dt), rd).t()
    dx = window_reverse(dxw, ws, h, w, c).to(dt)
    return dx, (dwqkv, dbqkv, dwproj, dbproj, dbias)


def _lib():
    from strajnet_tpu_torch._build import load_library

    lib = load_library("window_attention")
    if not getattr(lib, "_bound", False):
        lib.window_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.window_attention_fwd.restype = ctypes.c_int
        lib.window_attention_fwd_scratch_bytes.argtypes = [ctypes.c_int]
        lib.window_attention_fwd_scratch_bytes.restype = ctypes.c_longlong
        lib.window_attention_fwd_smem_bytes.argtypes = [ctypes.c_int]
        lib.window_attention_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.window_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.window_attention_bwd.restype = ctypes.c_int
        lib.window_attention_bwd_scratch_bf16.argtypes = [ctypes.c_int] * 4
        lib.window_attention_bwd_scratch_bf16.restype = ctypes.c_longlong
        lib.window_attention_bwd_smem_bytes.argtypes = [ctypes.c_int]
        lib.window_attention_bwd_smem_bytes.restype = ctypes.c_size_t
        lib._bound = True
    return lib


def fwd_kernel_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block of the forward window kernel at
    channel width ``c`` (builds the kernels; needs nvcc)."""
    return int(_lib().window_attention_fwd_smem_bytes(c))


def bwd_kernel_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block of the backward window kernel at
    channel width ``c`` (builds the kernels; needs nvcc)."""
    return int(_lib().window_attention_bwd_smem_bytes(c))


def check_fwd_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, *,
                   window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the forward kernel takes these arguments
    (:func:`check_attention_args`: among it C of 96, 192 or 384 with
    head_dim 32). Touches no kernel."""
    check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what=_FWD_KERNEL)


def _launch_fwd(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, window_size,
                num_heads):
    check_fwd_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                   window_size=window_size, num_heads=num_heads)
    b, h, w, c = x.shape
    lib = _lib()
    out = torch.empty_like(x)
    scratch = torch.empty(lib.window_attention_fwd_scratch_bytes(c),
                          dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.window_attention_fwd(
        ptr(x), ptr(wqkv), ptr(bqkv), ptr(wproj), ptr(bproj), ptr(rel_bias),
        ptr(mask), ptr(out), ptr(scratch), b, h, w, c, num_heads,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed with CUDA "
                           f"error {err}")
    window_attention.launches += 1
    return out


def check_bwd_args(x, wqkv, bqkv, wproj, rel_bias, mask, dy, *,
                   window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the backward kernel takes these arguments:
    what :func:`check_attention_args` asks (among it a channel width the
    wgmma window kernels are built for: 96, 192, 384 with head_dim 32) and
    ``dy`` like ``x``. Touches no kernel."""
    check_attention_args(x, wqkv, bqkv, wproj, None, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what=_BWD_KERNEL)
    check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)


def window_attention_bwd(x, wqkv, bqkv, wproj, rel_bias, mask, dy, *,
                         window_size: int, num_heads: int
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward of :func:`window_attention`: ``(dx, 5 f32 gradients)``.

    The kernel on CUDA tensors, :func:`window_attention_backward_reference`
    on CPU tensors.
    """
    if x.device.type == "cpu":
        return window_attention_backward_reference(
            x, wqkv, bqkv, wproj, rel_bias, mask, dy,
            window_size=window_size, num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention_bwd runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    check_bwd_args(x, wqkv, bqkv, wproj, rel_bias, mask, dy,
                   window_size=window_size, num_heads=num_heads)
    b, h, w, c = x.shape
    lib = _lib()
    dev = x.device
    dx = torch.empty_like(x)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), tuple(rel_bias.shape))
    grads = tuple(torch.zeros(sh, dtype=torch.float32, device=dev)
                  for sh in shapes)
    scratch = torch.empty(lib.window_attention_bwd_scratch_bf16(b, h, w, c),
                          dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.window_attention_bwd(
        ptr(x), ptr(dy), ptr(wqkv), ptr(bqkv), ptr(wproj), ptr(rel_bias),
        ptr(mask), ptr(dx), *(ptr(g) for g in grads), ptr(scratch),
        b, h, w, c, num_heads, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"window_attention_bwd kernel launch failed with "
                           f"CUDA error {err}")
    window_attention_bwd.launches += 1
    return dx, grads


class _WindowAttentionFn(torch.autograd.Function):
    """The forward kernel; the backward is the backward kernel, or autograd
    of the plain version when ``plain_backward``. Saves the inputs only."""

    @staticmethod
    def forward(ctx, window_size, num_heads, plain_backward, mask, x, wqkv,
                bqkv, wproj, bproj, rel_bias):
        ctx.save_for_backward(mask, x, wqkv, bqkv, wproj, bproj, rel_bias)
        ctx.cfg = (window_size, num_heads, plain_backward)
        return _launch_fwd(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                           window_size, num_heads)

    @staticmethod
    def backward(ctx, dy):
        mask, *args = ctx.saved_tensors
        window_size, num_heads, plain_backward = ctx.cfg
        kw = dict(window_size=window_size, num_heads=num_heads)
        if plain_backward:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in args]
                y = window_attention_reference(*ins, mask, **kw)
                grads = torch.autograd.grad(y, ins, dy)
            return (None,) * 4 + tuple(grads)
        x, wqkv, bqkv, wproj, bproj, rel_bias = args
        dx, grads = window_attention_bwd(x, wqkv, bqkv, wproj, rel_bias, mask,
                                         dy.contiguous(), **kw)
        return (None,) * 4 + (dx,) + tuple(
            g.to(t.dtype) for g, t in zip(grads, args[1:]))


def window_attention(x: torch.Tensor, wqkv, bqkv, wproj, bproj, rel_bias,
                     mask: Optional[torch.Tensor] = None, *,
                     window_size: int, num_heads: int,
                     backward: str = "kernel") -> torch.Tensor:
    """Windowed MHA with bias and mask on pre-rolled, pre-normalised x; the
    kernels on CUDA, the plain version on the CPU.

    Args:
      x: [B, H, W, C].
      wqkv/bqkv: [C, 3C] / [3C]; wproj/bproj: [C, C] / [C].
      rel_bias: [heads, ws*ws, ws*ws] relative-position bias.
      mask: optional [nW, ws*ws, ws*ws] additive SW-MSA mask (row-major
        window order over the grid; no gradient).
      backward: on CUDA, "kernel" for the backward kernel or "plain" for
        autograd of :func:`window_attention_reference` at the same inputs.

    Returns:
      [B, H, W, C] attention output, before the residual.
    """
    if backward not in ("kernel", "plain"):
        raise ValueError(f"backward must be 'kernel' or 'plain', got "
                         f"{backward!r}")
    if x.device.type == "cpu":
        return window_attention_reference(x, wqkv, bqkv, wproj, bproj,
                                          rel_bias, mask,
                                          window_size=window_size,
                                          num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    return _WindowAttentionFn.apply(window_size, num_heads,
                                    backward == "plain", mask, x, wqkv, bqkv,
                                    wproj, bproj, rel_bias)


window_attention.launches = 0
window_attention_bwd.launches = 0
