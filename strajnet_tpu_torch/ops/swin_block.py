"""The fused Swin block, forward and backward: CUDA kernel wrappers and their
plain versions.

Counterpart of ``strajnet_tpu/ops/pallas_swin_block.py``. :func:`swin_block`
takes the arguments of ``fused_swin_block`` and computes one whole Swin block
on pre-rolled ``[B, H, W, C]`` input (the caller rolls for shifted windows):

    r1  = x + dp1 * proj(W-MSA(LN1(x)))      (rel-pos bias, 0/-100 SW-MSA mask)
    out = r1 + dp2 * MLP_gelu_tanh(LN2(r1))

A tensor on the CPU takes :func:`swin_block_reference`, the plain PyTorch
version with the semantics of ``_xla_block_reference``, under autograd. A CUDA
tensor goes through a ``torch.autograd.Function``: the forward launches
``csrc/swin_block.cu`` and saves only its inputs; the backward launches
``csrc/swin_block_bwd.cu`` (:func:`swin_block_bwd`), which recomputes the
forward and returns dx and the 13 parameter gradients.

Each of the two has two routes, picked by :func:`kernel_route` from the
element type and the widths alone, before any launch:

- ``"wgmma"``: ``csrc/swin_block.cu`` and ``csrc/swin_block_bwd.cu``, fused
  ``wgmma`` kernels built for the flagship blocks: bf16, 8x8 windows, C of
  96, 192 or 384 with head_dim 32, MLP widths in 64-column chunks;
- ``"any"``: ``csrc/window_any.cu``, tensor-core kernels (``mma.sync``:
  bf16, and f32 as three TF32 passes) for every other shape the TPU kernels
  take, in f32 or bf16, up to 256 tokens a window, head_dim 64, C 1024 and
  an MLP width of 4096: five launches a forward (the products with their
  LayerNorm prologues and epilogues, a fused window attention), 13 a
  backward (:func:`window_any_launches` counts them).

The wrappers hand the kernels their scratch (the weights packed into tiles,
parking space, the intermediates). With ``backward="plain"`` the backward
is autograd of the plain version instead (the ``"block_fwd"`` mode of the
model). A failed build or launch, or a shape neither route covers, raises;
there is no fallback.
:func:`swin_block_backward_reference` is the backward written out step by
step with the kernel's rounding points; CPU tensors and the checks on the
card use it. :func:`atb_accum` is the backward's split-K pass
``dW += A^T B`` alone. ``swin_block.launches`` and
``swin_block_bwd.launches`` count the wgmma route's launches,
``swin_block.launches_any`` and ``swin_block_bwd.launches_any`` the general
route's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from strajnet_tpu_torch._build import check_tensors, launch, load_library

_KERNEL_WINDOW = 8   # ws * ws == 64 tokens: one wgmma M tile per window
_BLOCK_CHANNELS = (96, 192, 384)   # widths the wgmma window kernels are built for
_HEAD_DIM = 32
# What the general route (csrc/window_any.cu) takes: tokens a window, head
# size, channels, MLP width.
ANY_MAX_TOKENS = 256
ANY_MAX_HEAD_DIM = 64
ANY_MAX_CHANNELS = 1024
ANY_MAX_HIDDEN = 4096


def ln_f32(x, scale, bias, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                        bias.float(), eps)


def swin_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b,
                         ln2s, ln2b, w1, b1, w2, b2, mask=None,
                         drop_path=None, *, window_size: int, num_heads: int,
                         eps: float = 1e-5, proj=None,
                         ffn=None) -> torch.Tensor:
    """Plain PyTorch Swin block; ``_xla_block_reference`` semantics.

    Matrix products run in ``x.dtype`` (bf16 operands with bf16 results on
    the bf16 path); logits, LayerNorm and softmax in f32. ``proj`` (the
    attention output ``[windows, n, C]`` to its product with ``wproj``,
    before ``bproj``) and ``ffn`` (the normalised residual to the MLP's
    output, biases included), where given, take the place of those products
    (a caller that computes them on weight shards, ``models/swin.py``);
    ``wproj`` or ``w1``, ``b1``, ``w2``, ``b2`` then go unused.
    """
    b_, h, w, c = x.shape
    ws = window_size
    hd = c // num_heads
    n = ws * ws
    dt = x.dtype
    dp = (torch.ones(b_, 2, dtype=torch.float32, device=x.device)
          if drop_path is None else drop_path.float())

    xn = ln_f32(x, ln1s, ln1b, eps).to(dt)
    xw = xn.reshape(b_, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(-1, n, c)
    qkv = xw @ wqkv.to(dt) + bqkv.to(dt)
    qkv = qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
    attn = attn + rel_bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, num_heads, n, n)
                + mask.float()[None, :, None]).reshape(-1, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = (attn @ v).transpose(1, 2).reshape(-1, n, c)
    out = (out @ wproj.to(dt) if proj is None else proj(out)) + bproj.to(dt)
    out = out.reshape(b_, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b_, h, w, c)
    r1 = (x.float() + dp[:, 0, None, None, None] * out.float()).to(dt)
    y = ln_f32(r1, ln2s, ln2b, eps).to(dt)
    if ffn is None:
        y = F.gelu((y @ w1.to(dt) + b1.to(dt)).float(),
                   approximate="tanh").to(dt)
        y = y @ w2.to(dt) + b2.to(dt)
    else:
        y = ffn(y)
    return (r1.float() + dp[:, 1, None, None, None] * y.float()).to(dt)


def _gelu_tanh_grad(z: torch.Tensor) -> torch.Tensor:
    k, g = 0.7978845608028654, 0.044715
    t = torch.tanh(k * (z + g * z * z * z))
    du = k * (1.0 + 3.0 * g * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


GRAD_NAMES = ("dwqkv", "dbqkv", "dwproj", "dbproj", "drel", "dln1s", "dln1b",
              "dln2s", "dln2b", "dw1", "db1", "dw2", "db2")


def attention_backward_stage(q, k, v, p, do, scale: float,
                             rd: torch.dtype):
    """The attention stage of :func:`swin_block_backward_reference`, as
    ``_bwd_kernel`` computes it: from q, k, v ``[BW, heads, n, hd]`` (in
    the forward's type), the f32 softmax p and dO (rounded to ``rd``),
    ``(dq, dk, dv, drel)`` in f32 with every product on operands rounded to
    ``rd`` and dS taken from p rounded to ``rd``; drel sums dS over the
    windows."""
    def rnd(t):
        return t.to(rd).to(torch.float32)

    pb = rnd(p)
    dpr = do @ rnd(v).transpose(-1, -2)
    dv = pb.transpose(-1, -2) @ do
    ds = pb * (dpr - (dpr * pb).sum(-1, keepdim=True))
    drel = ds.sum(0)
    dsb = rnd(ds)
    dq = (dsb @ rnd(k)) * scale
    dk = (dsb.transpose(-1, -2) @ rnd(q)) * scale
    return dq, dk, dv, drel


def swin_block_backward_reference(
        x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s, ln2b, w1,
        b1, w2, b2, mask, drop_path, dy, *, window_size: int, num_heads: int,
        eps: float = 1e-5, operand_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain PyTorch backward of the block, step by step after ``_bwd_kernel``.

    Recomputes the forward with f32 accumulators and operands in ``x.dtype``,
    then walks back through it. Every backward product takes operands rounded
    to ``operand_dtype`` (default ``x.dtype``; the JAX kernel always rounds to
    bf16) and accumulates in f32; ``dbqkv`` sums the rounded ``dqkv``; the
    other bias, LayerNorm and rel-pos gradients sum f32 values.

    Returns ``(dx, grads)``: dx in ``x.dtype`` and the 13 parameter gradients
    in f32, in the order of :data:`GRAD_NAMES`.
    """
    b_, h, w, c = x.shape
    ws, heads = window_size, num_heads
    hd, n = c // heads, ws * ws
    nw = (h // ws) * (w // ws)
    scale = hd ** -0.5
    dt = x.dtype
    rd = dt if operand_dtype is None else operand_dtype
    f32 = torch.float32

    def rnd(t, dtype):
        return t.to(dtype).to(f32)

    def win(t):
        t = t.reshape(b_, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(-1, n, c).to(f32)

    def ln(v, s, b):
        mu = v.mean(-1, keepdim=True)
        xc = v - mu
        inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        xhat = xc * inv
        return xhat * s.to(f32) + b.to(f32), xhat, inv

    def ln_bwd(d, xhat, inv, s):
        dxhat = d * s.to(f32)
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        return (inv * (dxhat - m1 - xhat * m2), (d * xhat).sum((0, 1)),
                d.sum((0, 1)))

    def atb(a, bm):  # sum over windows and tokens of a^T b
        return a.reshape(-1, a.shape[-1]).t() @ bm.reshape(-1, bm.shape[-1])

    def heads_of(t):  # [BW, n, C] -> [BW, heads, n, hd]
        return t.reshape(-1, n, heads, hd).transpose(1, 2)

    dp = (torch.ones(b_, 2, dtype=f32, device=x.device)
          if drop_path is None else drop_path.to(f32))
    dp1 = dp[:, 0].repeat_interleave(nw)[:, None, None]
    dp2 = dp[:, 1].repeat_interleave(nw)[:, None, None]
    xw, dyw = win(x), win(dy)
    wqkv_f, wproj_f = rnd(wqkv, dt), rnd(wproj, dt)
    w1_f, w2_f = rnd(w1, dt), rnd(w2, dt)

    # ---- forward recompute ----
    h1, xhat1, inv1 = ln(xw, ln1s, ln1b)
    h1b = rnd(h1, dt)
    qkv = rnd(h1b @ wqkv_f + bqkv.to(f32), dt)
    q, k, v = (heads_of(t) for t in qkv.split(c, dim=-1))
    s = (q @ k.transpose(-1, -2)) * scale + rel_bias.to(f32)[None]
    if mask is not None:
        s = (s.reshape(b_, nw, heads, n, n)
             + mask.to(f32)[None, :, None]).reshape(-1, heads, n, n)
    p = torch.softmax(s, dim=-1)
    outs = rnd(p, dt) @ v
    merged = rnd(outs.transpose(1, 2).reshape(-1, n, c), dt)
    att = merged @ wproj_f + bproj.to(f32)
    r1 = rnd(xw + dp1 * att, dt)
    h2, xhat2, inv2 = ln(r1, ln2s, ln2b)
    h2b = rnd(h2, dt)
    z1 = h2b @ w1_f + b1.to(f32)
    g1 = rnd(F.gelu(z1, approximate="tanh"), dt)

    # ---- backward: out = r1 + dp2 * (g1 @ w2 + b2) ----
    dz2 = dp2 * dyw
    dz2b = rnd(dz2, rd)
    dw2 = atb(rnd(g1, rd), dz2b)
    db2 = dz2.sum((0, 1))
    dg1 = dz2b @ rnd(w2_f, rd).t()
    dz1 = dg1 * _gelu_tanh_grad(z1)
    dz1b = rnd(dz1, rd)
    dw1 = atb(rnd(h2b, rd), dz1b)
    db1 = dz1.sum((0, 1))
    dh2 = dz1b @ rnd(w1_f, rd).t()
    dr1_ln, dln2s, dln2b = ln_bwd(dh2, xhat2, inv2, ln2s)
    dr1 = dyw + dr1_ln

    # ---- r1 = x + dp1 * (merged @ wproj + bproj) ----
    datt = dp1 * dr1
    dattb = rnd(datt, rd)
    dwproj = atb(rnd(merged, rd), dattb)
    dbproj = datt.sum((0, 1))
    dmerged = dattb @ rnd(wproj_f, rd).t()

    do = heads_of(rnd(dmerged, rd))
    dq, dk, dv, drel = attention_backward_stage(q, k, v, p, do, scale, rd)
    dqkv = rnd(torch.cat([t.transpose(1, 2).reshape(-1, n, c)
                          for t in (dq, dk, dv)], dim=-1), rd)

    dwqkv = atb(rnd(h1b, rd), dqkv)
    dbqkv = dqkv.sum((0, 1))
    dh1 = dqkv @ rnd(wqkv_f, rd).t()
    dxw_ln, dln1s, dln1b = ln_bwd(dh1, xhat1, inv1, ln1s)

    dxw = dr1 + dxw_ln
    dx = dxw.reshape(b_, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    dx = dx.reshape(b_, h, w, c).to(dt)
    return dx, (dwqkv, dbqkv, dwproj, dbproj, drel, dln1s, dln1b, dln2s,
                dln2b, dw1, db1, dw2, db2)


def check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, *,
                         window_size: int, num_heads: int,
                         what: str = "the window kernels") -> None:
    """Raises ValueError unless the windowed-attention part of the wgmma
    kernels (``what``, for the message) takes these arguments: bf16
    activations, matrix weights, ``bqkv`` and ``bproj``; f32 ``rel_bias``
    and mask; 8x8 windows; a channel width the wgmma window kernels are built
    for (:func:`check_wgmma_widths`). ``bproj`` may be None (the backward of
    the attention does not read it)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    _, h, w, c = x.shape
    if window_size != _KERNEL_WINDOW:
        raise ValueError(f"the kernel runs 8x8 windows (64 tokens), got "
                         f"window_size={window_size}")
    if h % window_size or w % window_size:
        raise ValueError(f"H={h}, W={w} must be multiples of {window_size}")
    check_wgmma_widths(c, num_heads, what)
    check_tensors(attention_tensors(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                    mask, window_size, num_heads,
                                    torch.bfloat16), x.device)


def check_wgmma_widths(c: int, num_heads: int, what: str) -> None:
    """Raises ValueError unless the wgmma window kernels (all four: the
    block's forward and backward, the window attention's forward and
    backward) are built for this channel width and head count."""
    if c not in _BLOCK_CHANNELS or c != num_heads * _HEAD_DIM:
        raise ValueError(f"{what} are built for C in {_BLOCK_CHANNELS} with "
                         f"head_dim {_HEAD_DIM}, got C={c}, "
                         f"heads={num_heads}")


def check_kernel_args(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b,
                      ln2s, ln2b, w1, b1, w2, b2, mask, drop_path, *,
                      window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the wgmma kernels take these arguments.

    What :func:`check_attention_args` asks (among it a channel width the
    kernels are built for: 96, 192, 384 with head_dim 32), and f32 LayerNorm
    params, ``b1``, ``b2`` and drop-path multipliers; bf16 ``w1`` and ``w2``;
    MLP hidden width a multiple of 64.
    """
    check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what="the Swin-block kernels")
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    if hidden <= 0 or hidden % 64:
        raise ValueError(f"MLP hidden width {hidden} must be a multiple of "
                         f"64")
    check_tensors(mlp_tensors(x, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                              drop_path, torch.bfloat16), x.device)


def mlp_tensors(x, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, drop_path, dt):
    """``check_tensors``' table of the block's other arguments: ``w1`` and
    ``w2`` in ``dt``, the LayerNorm parameters, ``b1``, ``b2`` and the
    drop-path multipliers (which may be None) in f32."""
    b, c = x.shape[0], x.shape[-1]
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    f32 = torch.float32
    expect = {
        "ln1s": (ln1s, f32, (c,)), "ln1b": (ln1b, f32, (c,)),
        "ln2s": (ln2s, f32, (c,)), "ln2b": (ln2b, f32, (c,)),
        "w1": (w1, dt, (c, hidden)), "b1": (b1, f32, (hidden,)),
        "w2": (w2, dt, (hidden, c)), "b2": (b2, f32, (c,)),
    }
    if drop_path is not None:
        expect["drop_path"] = (drop_path, f32, (b, 2))
    return expect


def kernel_route(dtype: torch.dtype, c: int, heads: int, window_size: int,
                 hidden: Optional[int] = None) -> str:
    """The route of the window kernels for this element type and these
    widths: ``"wgmma"`` where the fused kernels are built for them (bf16, 8x8
    windows, C of 96, 192 or 384 with head_dim 32 and, for the block, an MLP
    width in 64-column chunks), else ``"any"``. ``hidden`` is the block's
    MLP width (None for the window attention, K3/K4). Raises ValueError on
    what neither route takes. Pure: it reads no tensor and builds nothing."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the window kernels compute in float32 or bfloat16, "
                         f"got {dtype}")
    if heads < 1 or c < 1 or c % heads:
        raise ValueError(f"C={c} must be heads * head_dim, got heads={heads}")
    hd, n = c // heads, window_size * window_size
    if window_size < 1 or n > ANY_MAX_TOKENS:
        raise ValueError(f"the window kernels take windows of at most "
                         f"{ANY_MAX_TOKENS} tokens, got window_size="
                         f"{window_size} ({n} tokens)")
    if hd > ANY_MAX_HEAD_DIM:
        raise ValueError(f"the window kernels take head_dim up to "
                         f"{ANY_MAX_HEAD_DIM}, got {hd} (C={c}, "
                         f"heads={heads})")
    if c > ANY_MAX_CHANNELS:
        raise ValueError(f"the window kernels take C up to "
                         f"{ANY_MAX_CHANNELS}, got C={c}")
    if hidden is not None and not 1 <= hidden <= ANY_MAX_HIDDEN:
        raise ValueError(f"the Swin-block kernels take an MLP width from 1 "
                         f"to {ANY_MAX_HIDDEN}, got {hidden}")
    if (dtype == torch.bfloat16 and window_size == _KERNEL_WINDOW
            and c in _BLOCK_CHANNELS and hd == _HEAD_DIM
            and (hidden is None or hidden % 64 == 0)):
        return "wgmma"
    return "any"


def attention_tensors(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                      window_size, num_heads, dt):
    """``check_tensors``' table of the attention arguments in element type
    ``dt`` (f32 rel_bias and mask)."""
    b, h, w, c = x.shape
    n = window_size * window_size
    expect = {
        "x": (x, dt, (b, h, w, c)),
        "wqkv": (wqkv, dt, (c, 3 * c)),
        "bqkv": (bqkv, dt, (3 * c,)),
        "wproj": (wproj, dt, (c, c)),
        "rel_bias": (rel_bias, torch.float32, (num_heads, n, n)),
    }
    if bproj is not None:
        expect["bproj"] = (bproj, dt, (c,))
    if mask is not None:
        expect["mask"] = (mask, torch.float32,
                          ((h // window_size) * (w // window_size), n, n))
    return expect


def check_grid(x, window_size: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    _, h, w, _ = x.shape
    if window_size < 1 or h % window_size or w % window_size:
        raise ValueError(f"H={h}, W={w} must be multiples of window_size="
                         f"{window_size}")


def check_general_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                 *, window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the general route's window attention
    (``csrc/window_any.cu``) takes these arguments: x, the matrix weights,
    ``bqkv`` and ``bproj`` (which may be None) in one element type, f32 or
    bf16; f32 ``rel_bias [heads, n, n]`` and mask; the limits of
    :func:`kernel_route`. Touches no kernel."""
    check_grid(x, window_size)
    kernel_route(x.dtype, x.shape[-1], num_heads, window_size)
    check_tensors(attention_tensors(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                    mask, window_size, num_heads, x.dtype),
                  x.device)


def check_general_args(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b,
                       ln2s, ln2b, w1, b1, w2, b2, mask, drop_path, *,
                       window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the general route's Swin block takes these
    arguments: what :func:`check_general_attention_args` asks, ``w1`` and
    ``w2`` in x's element type, f32 LayerNorm parameters, ``b1``, ``b2``
    and drop-path multipliers. Touches no kernel."""
    check_grid(x, window_size)
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    kernel_route(x.dtype, x.shape[-1], num_heads, window_size, hidden)
    expect = attention_tensors(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                               window_size, num_heads, x.dtype)
    expect.update(mlp_tensors(x, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                              drop_path, x.dtype))
    check_tensors(expect, x.device)


def window_any_lib():
    """The general route's library, ``csrc/window_any.cu``, built and
    bound (needs nvcc)."""
    return load_library("window_any")


def window_any_launches() -> int:
    """Kernels the general route's library has launched since it was
    loaded: 5 a K1 call, 13 a K2 call, 3 a K3 call, 7 a K4 call, 7 and 17
    a SwinV2 block's forward and backward call (8 and 18 where its
    attention stage is not fused, ``ops/swinv2_block.py::
    fused_attention``)."""
    return int(window_any_lib().window_any_launches())


def window_any_fwd_launches() -> int:
    """Of :func:`window_any_launches`, those of the f32 forward products'
    kernel (``fwd_product_kernel``): 4 a K1 call in f32, 3 in a K2 call's
    recompute, none in bf16."""
    return int(window_any_lib().window_any_fwd_launches())


def window_any_v2_attn_launches() -> int:
    """Of :func:`window_any_launches`, those of SwinV2's fused attention
    stage (``swinv2_attn_kernel``): one a SwinV2 block's forward call and
    one a backward call (its recompute), in bf16 at head size 32."""
    return int(window_any_lib().window_any_v2_attn_launches())


# the four products of a block's forward, as window_any_fwd_product numbers
FWD_PRODUCTS = ("qkv", "proj", "fc1", "fc2")


def window_any_fwd_product(which: str, a, w, bias, out, *, window_size: int,
                           res=None, ln_s=None, ln_b=None, drop_path=None,
                           stats=None, side=None, aux=None,
                           eps: float = 1e-5) -> None:
    """For the tests: one f32 product of the general K1's forward alone, as
    it launches it (``fwd_product_kernel``), into
    ``out``: ``qkv`` LN1(a) @ w + bias with ``a`` = x in grid order, read at
    its window-order rows; ``proj`` res + dp1 (a @ w + bias) with ``res`` = x;
    ``fc1`` gelu(LN2(a) @ w + bias); ``fc2`` res + dp2 (a @ w + bias) stored
    in grid order. ``a`` is ``[B, H, W, K]``, ``out`` ``[B, H, W, N]``;
    ``stats`` ``[M, 2]``, ``side`` ``[M, K]`` and ``aux`` ``[M, N]`` (fc1)
    keep what the backward's recompute keeps, where given."""
    b, h, w_, k = a.shape
    n = w.shape[1]
    c, hidden = {"qkv": (k, 1), "proj": (k, 1), "fc1": (k, n),
                 "fc2": (n, k)}[which]
    if w.shape[0] != k or n != {"qkv": 3 * k, "proj": k}.get(which, n):
        raise ValueError(f"{which}: w {tuple(w.shape)} at depth {k}")
    launch(window_any_lib(), "window_any_fwd_product",
           FWD_PRODUCTS.index(which), a, res, w, bias, ln_s, ln_b, drop_path,
           out, stats, side, aux, b, h, w_, c, window_size, hidden, eps)


def any_scratch(kind: int, x: torch.Tensor, num_heads: int,
                window_size: int, hidden: int = 1) -> torch.Tensor:
    """The general route's scratch for a launch of ``kind`` (0 block
    forward, 1 block backward, 2 attention forward, 3 attention
    backward, 4 and 5 the SwinV2 block's forward and backward)."""
    b, h, w, c = x.shape
    nbytes = window_any_lib().window_any_scratch_bytes(
        kind, int(x.dtype == torch.bfloat16), b, h, w, c, num_heads,
        window_size, hidden)
    if nbytes < 0:
        raise ValueError(f"window_any takes no launch of kind {kind} at "
                         f"{tuple(x.shape)}, heads={num_heads}, "
                         f"window_size={window_size}")
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def _launch_fwd(args, mask, drop_path, window_size, num_heads, eps):
    x, w1 = args[0], args[10]
    route = kernel_route(x.dtype, x.shape[-1], num_heads, window_size,
                         w1.shape[-1])
    launch = _launch_wgmma_fwd if route == "wgmma" else _launch_any_fwd
    return launch(args, mask, drop_path, window_size, num_heads, eps)


def _launch_any_fwd(args, mask, drop_path, window_size, num_heads, eps):
    x, w1 = args[0], args[10]
    check_general_args(*args, mask, drop_path, window_size=window_size,
                       num_heads=num_heads)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    scratch = any_scratch(0, x, num_heads, window_size, w1.shape[1])
    launch(window_any_lib(), "swin_any_fwd", *args, mask, drop_path, out,
           scratch, int(x.dtype == torch.bfloat16), b, h, w, c, num_heads,
           window_size, w1.shape[1], eps)
    swin_block.launches_any += 1
    return out


def _launch_wgmma_fwd(args, mask, drop_path, window_size, num_heads, eps):
    x, w1 = args[0], args[10]
    check_kernel_args(*args, mask, drop_path, window_size=window_size,
                      num_heads=num_heads)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = load_library("swin_block")
    # the kernel's copy of the four weights, packed into its tiles, and its
    # parking space for r1
    scratch = torch.empty(
        lib.swin_block_fwd_scratch_bytes(b, h, w, c, w1.shape[1]),
        dtype=torch.uint8, device=x.device)
    launch(lib, "swin_block_fwd", *args, mask, drop_path, out, scratch, b, h,
           w, c, num_heads, w1.shape[1], eps)
    swin_block.launches += 1
    return out


def swin_block_bwd(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s,
                   ln2b, w1, b1, w2, b2, mask, drop_path, dy, *,
                   window_size: int, num_heads: int, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward of :func:`swin_block`: ``(dx, 13 f32 parameter gradients)``.

    The kernel of :func:`kernel_route`'s route on CUDA tensors,
    :func:`swin_block_backward_reference` with ``operand_dtype=bfloat16`` on
    CPU tensors. Both routes round every backward product's operands to
    bf16 whatever x's element type, as ``_bwd_kernel`` does
    (``pallas_swin_block.py``): in f32 the general route runs those products
    as bf16 products on operands rounded as they are read.
    """
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s, ln2b,
            w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_backward_reference(
            *args, mask, drop_path, dy, window_size=window_size,
            num_heads=num_heads, eps=eps, operand_dtype=torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"swin_block_bwd runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    b, h, w, c = x.shape
    if drop_path is None:
        drop_path = torch.ones(b, 2, dtype=torch.float32, device=x.device)
    route = kernel_route(x.dtype, c, num_heads, window_size, w1.shape[-1])
    if route == "wgmma":
        check_kernel_args(*args, mask, drop_path, window_size=window_size,
                          num_heads=num_heads)
    else:
        check_general_args(*args, mask, drop_path, window_size=window_size,
                           num_heads=num_heads)
    check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)
    hidden = w1.shape[1]
    dev = x.device
    dx = torch.empty_like(x)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), tuple(rel_bias.shape),
              (c,), (c,), (c,), (c,), (c, hidden), (hidden,), (hidden, c),
              (c,))
    # one zeroed buffer (one fill kernel), cut into the 13 gradients
    sizes = [math.prod(sh) for sh in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    grads = tuple(v.view(sh) for v, sh in zip(flat.split(sizes), shapes))
    if route == "any":
        bf = int(x.dtype == torch.bfloat16)
        scratch = any_scratch(1, x, num_heads, window_size, hidden)
        launch(window_any_lib(), "swin_any_bwd", x, dy, *args[1:], mask,
               drop_path, dx, *grads, scratch, bf, 1, b, h, w, c, num_heads,
               window_size, hidden, eps)
        swin_block_bwd.launches_any += 1
        return dx, grads
    lib = load_library("swin_block_bwd")
    scratch16 = torch.empty(lib.swin_block_bwd_scratch_bf16(b, h, w, c, hidden),
                            dtype=torch.bfloat16, device=dev)
    scratch32 = torch.empty(lib.swin_block_bwd_scratch_f32(b, h, w, c),
                            dtype=torch.float32, device=dev)
    launch(lib, "swin_block_bwd", x, dy, *args[1:], mask, drop_path, dx,
           *grads, scratch16, scratch32, b, h, w, c, num_heads, hidden, eps)
    swin_block_bwd.launches += 1
    return dx, grads


def token_blocked(t: torch.Tensor) -> torch.Tensor:
    """``[tokens, M]`` as the backward window kernels lay it out in scratch:
    ``[tokens / 64, M / 8, 64, 8]``, per window the 8-column blocks one
    after the other, each with its 64 tokens' eight values in a row."""
    tokens, m = t.shape
    return (t.reshape(tokens // 64, 64, m // 8, 8).permute(0, 2, 1, 3)
            .contiguous())


def atb_accum(a: torch.Tensor, b: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out += a^T @ b`` in f32 for bf16 operands over the same tokens, both
    as :func:`token_blocked` makes them (``[tokens / 64, M / 8, 64, 8]`` and
    ``[tokens / 64, N / 8, 64, 8]``): the split-K pass that sums K2's and
    K4's weight gradients over all tokens, alone. The kernel on CUDA tensors,
    a plain product on CPU tensors."""
    if a.dim() != 4 or b.dim() != 4 or a.shape[0] != b.shape[0] \
            or tuple(a.shape[2:]) != (64, 8) or tuple(b.shape[2:]) != (64, 8):
        raise ValueError(f"atb_accum takes token-blocked operands "
                         f"[tokens / 64, M / 8, 64, 8], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    ntok, m, n = 64 * a.shape[0], 8 * a.shape[1], 8 * b.shape[1]
    if out is None:
        out = torch.zeros(m, n, dtype=torch.float32, device=a.device)
    if a.device.type == "cpu":
        a, b = (t.permute(0, 2, 1, 3).reshape(ntok, -1) for t in (a, b))
        return out.add_(a.float().t() @ b.float())
    if a.device.type != "cuda":
        raise ValueError(f"atb_accum runs on CPU or CUDA tensors, got "
                         f"{a.device}")
    check_tensors({"a": (a, torch.bfloat16, a.shape),
                   "b": (b, torch.bfloat16, b.shape),
                   "out": (out, torch.float32, (m, n))}, a.device)
    launch(load_library("swin_block_bwd"), "swin_block_atb_accum", a, b, out,
           m, n, ntok)
    return out


def kernel_smem_bytes(c: int, hidden: int) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the forward and of the backward
    window kernel at channel width ``c`` (builds the kernels; needs nvcc)."""
    return (int(load_library("swin_block").swin_block_smem_bytes(c)),
            int(load_library("swin_block_bwd").swin_block_bwd_smem_bytes(
                c, hidden)))


class _SwinBlockFn(torch.autograd.Function):
    """K1 forward; the backward is K2, or autograd of the plain version when
    ``plain_backward``. Saves the inputs only: both backwards recompute."""

    @staticmethod
    def forward(ctx, window_size, num_heads, eps, plain_backward, mask,
                drop_path, *args):
        ctx.save_for_backward(mask, drop_path, *args)
        ctx.cfg = (window_size, num_heads, eps, plain_backward)
        return _launch_fwd(args, mask, drop_path, window_size, num_heads, eps)

    @staticmethod
    def backward(ctx, dy):
        mask, drop_path, *args = ctx.saved_tensors
        window_size, num_heads, eps, plain_backward = ctx.cfg
        if plain_backward:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in args]
                y = swin_block_reference(*ins, mask, drop_path,
                                         window_size=window_size,
                                         num_heads=num_heads, eps=eps)
                grads = torch.autograd.grad(y, ins, dy)
            return (None,) * 6 + tuple(grads)
        dx, grads = swin_block_bwd(*args, mask, drop_path, dy.contiguous(),
                                   window_size=window_size,
                                   num_heads=num_heads, eps=eps)
        return (None,) * 6 + (dx,) + tuple(
            g.to(t.dtype) for g, t in zip(grads, args[1:]))


def swin_block(x: torch.Tensor, wqkv, bqkv, wproj, bproj, rel_bias,
               ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
               mask: Optional[torch.Tensor] = None,
               drop_path: Optional[torch.Tensor] = None, *,
               window_size: int, num_heads: int,
               eps: float = 1e-5, backward: str = "kernel") -> torch.Tensor:
    """One Swin block on pre-rolled x; the kernels on CUDA, plain on the CPU.

    Args:
      x: [B, H, W, C] input, already rolled by -shift.
      wqkv/bqkv: [C, 3C] / [3C]; wproj/bproj: [C, C] / [C].
      rel_bias: [heads, ws*ws, ws*ws] relative-position bias.
      ln1s/ln1b/ln2s/ln2b: [C] LayerNorm parameters.
      w1/b1: [C, hidden] / [hidden]; w2/b2: [hidden, C] / [C].
      mask: optional [nW, ws*ws, ws*ws] SW-MSA mask (no gradient).
      drop_path: optional [B, 2] keep-scaled per-sample multipliers of the
        two residual branches (no gradient).
      backward: on CUDA, "kernel" for the backward kernel or "plain" for
        autograd of :func:`swin_block_reference` at the same inputs.
    """
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s, ln2b,
            w1, b1, w2, b2)
    if backward not in ("kernel", "plain"):
        raise ValueError(f"backward must be 'kernel' or 'plain', got "
                         f"{backward!r}")
    if x.device.type == "cpu":
        return swin_block_reference(*args, mask, drop_path,
                                    window_size=window_size,
                                    num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"swin_block runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if drop_path is None:
        drop_path = torch.ones(x.shape[0], 2, dtype=torch.float32,
                               device=x.device)
    return _SwinBlockFn.apply(window_size, num_heads, eps,
                              backward == "plain", mask, drop_path, *args)


swin_block.launches = 0
swin_block_bwd.launches = 0
swin_block.launches_any = 0
swin_block_bwd.launches_any = 0
