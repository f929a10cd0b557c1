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
returns dx and the five parameter gradients. The route of both is the Swin
block's, picked by ``ops/swin_block.py::kernel_route`` from the element type
and the widths before any launch: ``"wgmma"`` kernels on the fused Swin
block's device code for bf16 8x8 windows of C 96, 192 or 384 with head_dim
32, and the tensor-core kernels of ``csrc/window_any.cu`` (``attn_any_fwd``,
three launches; ``attn_any_bwd``, seven) for every other shape up to that
module's limits, in f32 or bf16. The general backward rounds its products' operands to bf16 whatever
the input type, as the JAX kernel does (``pallas_window_attention.py:142``):
its plain counterpart is :func:`window_attention_backward_reference` with
``operand_dtype=torch.bfloat16``. With ``backward="plain"`` the backward is
autograd of the plain version instead, which tells a fault of the backward
kernel from one elsewhere. A failed build or launch, or a shape neither
route takes, raises; there is no fallback.
:func:`window_attention_backward_reference` is the backward written out step
by step with the kernel's rounding points.
``window_attention.launches`` and ``window_attention_bwd.launches`` count
the wgmma route's launches, ``launches_any`` beside them the general
route's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from strajnet_tpu_torch._build import check_tensors, launch, load_library
from strajnet_tpu_torch.ops.swin_block import (
    any_scratch, check_attention_args, check_general_attention_args,
    kernel_route, window_any_lib)
from strajnet_tpu_torch.ops.windows import window_partition, window_reverse

GRAD_NAMES = ("dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
# The general route's forward attention halves its strips a block while its
# grid has fewer blocks than this: two waves of the H100's 132 SMs
# (csrc/window_any.cu: kAttnBlocks).
ATTN_BLOCKS = 264
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


def attention_plan(n: int, heads: int, windows: int) -> Tuple[int, int]:
    """The grid of the general route's forward attention
    (``csrc/window_any.cu::attn_plan``, its twin) for windows of ``n``
    tokens: ``(strips of 16 queries a block, parts of the keys)``, a warp
    each pair. A block holds four strips while the grid, ``windows * heads``
    times the blocks a window and head, has :data:`ATTN_BLOCKS` blocks or
    more; below that the strips a block are halved and the keys split into
    as many more parts, down to one strip and four parts; a part keeps 16
    keys or more, and with one part a block keeps four strips (a window of
    16 tokens uses one of them). Pure: a function of the widths alone."""
    tiles = -(-n // 16)
    qt = 4
    while qt > 1 and windows * heads * -(-tiles // qt) < ATTN_BLOCKS:
        qt //= 2
    kp = min(4 // qt, tiles)
    return (4, 1) if kp == 1 else (qt, kp)


def attention_plan_of_kernel(b: int, h: int, w: int, c: int, heads: int,
                             window_size: int) -> Tuple[int, int]:
    """:func:`attention_plan` as the built library computes it (needs
    nvcc)."""
    out = (ctypes.c_int * 2)()
    if window_any_lib().window_any_attn_plan(b, h, w, c, heads, window_size,
                                             out) != 0:
        raise ValueError(f"the general route takes no attention at "
                         f"[{b}, {h}, {w}, {c}], heads={heads}, "
                         f"window_size={window_size}")
    return out[0], out[1]


def fwd_kernel_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block of the forward window kernel at
    channel width ``c`` (builds the kernels; needs nvcc)."""
    lib = load_library("window_attention")
    return int(lib.window_attention_fwd_smem_bytes(c))


def bwd_kernel_smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block of the backward window kernel at
    channel width ``c`` (builds the kernels; needs nvcc)."""
    lib = load_library("window_attention")
    return int(lib.window_attention_bwd_smem_bytes(c))


def check_fwd_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, *,
                   window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the wgmma forward kernel takes these
    arguments (:func:`check_attention_args`: among it C of 96, 192 or 384
    with head_dim 32). Touches no kernel."""
    check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what=_FWD_KERNEL)


def _launch_fwd(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, window_size,
                num_heads):
    route = kernel_route(x.dtype, x.shape[-1], num_heads, window_size)
    launch = _launch_wgmma_fwd if route == "wgmma" else _launch_any_fwd
    return launch(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, window_size,
                  num_heads)


def _launch_any_fwd(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, window_size,
                    num_heads):
    check_general_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                 window_size=window_size, num_heads=num_heads)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    scratch = any_scratch(2, x, num_heads, window_size)
    launch(window_any_lib(), "attn_any_fwd", x, wqkv, bqkv, wproj, bproj,
           rel_bias, mask, out, scratch, int(x.dtype == torch.bfloat16), b, h,
           w, c, num_heads, window_size)
    window_attention.launches_any += 1
    return out


def _launch_wgmma_fwd(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                      window_size, num_heads):
    check_fwd_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                   window_size=window_size, num_heads=num_heads)
    b, h, w, c = x.shape
    lib = load_library("window_attention")
    out = torch.empty_like(x)
    scratch = torch.empty(lib.window_attention_fwd_scratch_bytes(c),
                          dtype=torch.uint8, device=x.device)
    launch(lib, "window_attention_fwd", x, wqkv, bqkv, wproj, bproj, rel_bias,
           mask, out, scratch, b, h, w, c, num_heads)
    window_attention.launches += 1
    return out


def check_bwd_args(x, wqkv, bqkv, wproj, rel_bias, mask, dy, *,
                   window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the wgmma backward kernel takes these
    arguments: what :func:`check_attention_args` asks (among it a channel
    width the wgmma window kernels are built for: 96, 192, 384 with head_dim
    32) and ``dy`` like ``x``. Touches no kernel."""
    check_attention_args(x, wqkv, bqkv, wproj, None, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what=_BWD_KERNEL)
    check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)


def window_attention_bwd(x, wqkv, bqkv, wproj, rel_bias, mask, dy, *,
                         window_size: int, num_heads: int
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward of :func:`window_attention`: ``(dx, 5 f32 gradients)``.

    The kernel of ``kernel_route``'s route on CUDA tensors,
    :func:`window_attention_backward_reference` with
    ``operand_dtype=bfloat16`` on CPU tensors: every backward product takes
    operands rounded to bf16 whatever x's element type, as the JAX kernel
    and both routes round them.
    """
    if x.device.type == "cpu":
        return window_attention_backward_reference(
            x, wqkv, bqkv, wproj, rel_bias, mask, dy,
            window_size=window_size, num_heads=num_heads,
            operand_dtype=torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention_bwd runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    route = kernel_route(x.dtype, x.shape[-1], num_heads, window_size)
    if route == "wgmma":
        check_bwd_args(x, wqkv, bqkv, wproj, rel_bias, mask, dy,
                       window_size=window_size, num_heads=num_heads)
    else:
        check_general_attention_args(x, wqkv, bqkv, wproj, None, rel_bias,
                                     mask, window_size=window_size,
                                     num_heads=num_heads)
        check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)
    b, h, w, c = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), tuple(rel_bias.shape))
    grads = tuple(torch.zeros(sh, dtype=torch.float32, device=dev)
                  for sh in shapes)
    if route == "any":
        scratch = any_scratch(3, x, num_heads, window_size)
        launch(window_any_lib(), "attn_any_bwd", x, dy, wqkv, bqkv, wproj,
               rel_bias, mask, dx, *grads, scratch,
               int(x.dtype == torch.bfloat16), 1, b, h, w, c, num_heads,
               window_size)
        window_attention_bwd.launches_any += 1
        return dx, grads
    lib = load_library("window_attention")
    scratch = torch.empty(lib.window_attention_bwd_scratch_bf16(b, h, w, c),
                          dtype=torch.bfloat16, device=dev)
    launch(lib, "window_attention_bwd", x, dy, wqkv, bqkv, wproj, rel_bias,
           mask, dx, *grads, scratch, b, h, w, c, num_heads)
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
window_attention.launches_any = 0
window_attention_bwd.launches_any = 0
