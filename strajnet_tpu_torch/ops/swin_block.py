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
forward and returns dx and the 13 parameter gradients. Both are ``wgmma``
kernels built for the model's widths (C of 96, 192 or 384, head_dim 32); the
wrappers hand them their scratch (the weights packed into tiles, parking
space, the operands of the weight gradients). With ``backward="plain"`` the
backward is autograd of the plain version instead (the ``"block_fwd"`` mode
of the model). A failed build or launch, or a shape the kernels do not
cover, raises; there is no fallback.
:func:`swin_block_backward_reference` is the backward written out step by
step with the kernel's rounding points; CPU tensors and the checks on the
card use it. :func:`atb_accum` is the backward's split-K pass
``dW += A^T B`` alone. ``swin_block.launches`` and
``swin_block_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_KERNEL_WINDOW = 8   # ws * ws == 64 tokens: one wgmma M tile per window
_BLOCK_CHANNELS = (96, 192, 384)   # widths the wgmma window kernels are built for
_HEAD_DIM = 32


def _ln_f32(x, scale, bias, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                        bias.float(), eps)


def swin_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b,
                         ln2s, ln2b, w1, b1, w2, b2, mask=None,
                         drop_path=None, *, window_size: int, num_heads: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch Swin block; ``_xla_block_reference`` semantics.

    Matrix products run in ``x.dtype`` (bf16 operands with bf16 results on
    the bf16 path); logits, LayerNorm and softmax in f32.
    """
    b_, h, w, c = x.shape
    ws = window_size
    hd = c // num_heads
    n = ws * ws
    dt = x.dtype
    dp = (torch.ones(b_, 2, dtype=torch.float32, device=x.device)
          if drop_path is None else drop_path.float())

    xn = _ln_f32(x, ln1s, ln1b, eps).to(dt)
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
    out = out @ wproj.to(dt) + bproj.to(dt)
    out = out.reshape(b_, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b_, h, w, c)
    r1 = (x.float() + dp[:, 0, None, None, None] * out.float()).to(dt)
    y = _ln_f32(r1, ln2s, ln2b, eps).to(dt)
    y = F.gelu((y @ w1.to(dt) + b1.to(dt)).float(), approximate="tanh").to(dt)
    y = y @ w2.to(dt) + b2.to(dt)
    return (r1.float() + dp[:, 1, None, None, None] * y.float()).to(dt)


def _gelu_tanh_grad(z: torch.Tensor) -> torch.Tensor:
    k, g = 0.7978845608028654, 0.044715
    t = torch.tanh(k * (z + g * z * z * z))
    du = k * (1.0 + 3.0 * g * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


GRAD_NAMES = ("dwqkv", "dbqkv", "dwproj", "dbproj", "drel", "dln1s", "dln1b",
              "dln2s", "dln2b", "dw1", "db1", "dw2", "db2")


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
    pb = rnd(p, rd)
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
    dpr = do @ rnd(v, rd).transpose(-1, -2)
    dv = pb.transpose(-1, -2) @ do
    ds = pb * (dpr - (dpr * pb).sum(-1, keepdim=True))
    drel = ds.sum(0)
    dsb = rnd(ds, rd)
    dq = (dsb @ rnd(k, rd)) * scale
    dk = (dsb.transpose(-1, -2) @ rnd(q, rd)) * scale
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


def check_tensors(expect, device) -> None:
    """Raises ValueError unless every ``name: (tensor, dtype, shape)`` of
    ``expect`` is a contiguous, 32-byte aligned tensor of that dtype and
    shape on ``device``: what the CUDA kernels read through raw pointers."""
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")


def check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, *,
                         window_size: int, num_heads: int,
                         what: str = "the window kernels") -> None:
    """Raises ValueError unless the windowed-attention part of the CUDA
    kernels (``what``, for the message) takes these arguments: bf16
    activations, matrix weights, ``bqkv`` and ``bproj``; f32 ``rel_bias``
    and mask; 8x8 windows; a channel width the wgmma window kernels are built
    for (:func:`check_wgmma_widths`). ``bproj`` may be None (the backward of
    the attention does not read it)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if window_size != _KERNEL_WINDOW:
        raise ValueError(f"the kernel runs 8x8 windows (64 tokens), got "
                         f"window_size={window_size}")
    if h % window_size or w % window_size:
        raise ValueError(f"H={h}, W={w} must be multiples of {window_size}")
    check_wgmma_widths(c, num_heads, what)
    n = window_size * window_size
    bf = torch.bfloat16
    expect = {
        "x": (x, bf, (b, h, w, c)),
        "wqkv": (wqkv, bf, (c, 3 * c)),
        "bqkv": (bqkv, bf, (3 * c,)),
        "wproj": (wproj, bf, (c, c)),
        "rel_bias": (rel_bias, torch.float32, (num_heads, n, n)),
    }
    if bproj is not None:
        expect["bproj"] = (bproj, bf, (c,))
    if mask is not None:
        expect["mask"] = (mask, torch.float32,
                          ((h // window_size) * (w // window_size), n, n))
    check_tensors(expect, x.device)


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
    """Raises ValueError unless the CUDA kernels take these arguments.

    What :func:`check_attention_args` asks (among it a channel width the
    kernels are built for: 96, 192, 384 with head_dim 32), and f32 LayerNorm
    params, ``b1``, ``b2`` and drop-path multipliers; bf16 ``w1`` and ``w2``;
    MLP hidden width a multiple of 64.
    """
    check_attention_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                         window_size=window_size, num_heads=num_heads,
                         what="the Swin-block kernels")
    b, c = x.shape[0], x.shape[-1]
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    if hidden <= 0 or hidden % 64:
        raise ValueError(f"MLP hidden width {hidden} must be a multiple of "
                         f"64")
    f32 = torch.float32
    expect = {
        "ln1s": (ln1s, f32, (c,)), "ln1b": (ln1b, f32, (c,)),
        "ln2s": (ln2s, f32, (c,)), "ln2b": (ln2b, f32, (c,)),
        "w1": (w1, torch.bfloat16, (c, hidden)), "b1": (b1, f32, (hidden,)),
        "w2": (w2, torch.bfloat16, (hidden, c)), "b2": (b2, f32, (c,)),
    }
    if drop_path is not None:
        expect["drop_path"] = (drop_path, f32, (b, 2))
    check_tensors(expect, x.device)


def ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _lib(name: str):
    from strajnet_tpu_torch._build import load_library

    lib = load_library(name)
    if not getattr(lib, "_bound", False):
        if name == "swin_block":
            lib.swin_block_fwd.argtypes = (
                [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
            lib.swin_block_fwd.restype = ctypes.c_int
            lib.swin_block_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 5
            lib.swin_block_fwd_scratch_bytes.restype = ctypes.c_longlong
            lib.swin_block_smem_bytes.argtypes = [ctypes.c_int]
            lib.swin_block_smem_bytes.restype = ctypes.c_size_t
        else:
            lib.swin_block_bwd.argtypes = (
                [ctypes.c_void_p] * 33 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
            lib.swin_block_bwd.restype = ctypes.c_int
            lib.swin_block_bwd_scratch_bf16.argtypes = [ctypes.c_int] * 5
            lib.swin_block_bwd_scratch_bf16.restype = ctypes.c_longlong
            lib.swin_block_bwd_scratch_f32.argtypes = [ctypes.c_int] * 4
            lib.swin_block_bwd_scratch_f32.restype = ctypes.c_longlong
            lib.swin_block_atb_accum.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_longlong, ctypes.c_void_p])
            lib.swin_block_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
            lib.swin_block_bwd_smem_bytes.restype = ctypes.c_size_t
            lib.swin_block_atb_accum.restype = ctypes.c_int
        lib._bound = True
    return lib


def _launch_fwd(args, mask, drop_path, window_size, num_heads, eps):
    x, w1 = args[0], args[10]
    check_kernel_args(*args, mask, drop_path, window_size=window_size,
                      num_heads=num_heads)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = _lib("swin_block")
    # the kernel's copy of the four weights, packed into its tiles, and its
    # parking space for r1
    scratch = torch.empty(
        lib.swin_block_fwd_scratch_bytes(b, h, w, c, w1.shape[1]),
        dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.swin_block_fwd(
        *(ptr(t) for t in args), ptr(mask), ptr(drop_path), ptr(out),
        ptr(scratch), b, h, w, c, num_heads, w1.shape[1], eps,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"swin_block kernel launch failed with CUDA error "
                           f"{err}")
    swin_block.launches += 1
    return out


def swin_block_bwd(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s,
                   ln2b, w1, b1, w2, b2, mask, drop_path, dy, *,
                   window_size: int, num_heads: int, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward of :func:`swin_block`: ``(dx, 13 f32 parameter gradients)``.

    The kernel on CUDA tensors, :func:`swin_block_backward_reference` on CPU
    tensors.
    """
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s, ln2b,
            w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_backward_reference(
            *args, mask, drop_path, dy, window_size=window_size,
            num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"swin_block_bwd runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    b, h, w, c = x.shape
    if drop_path is None:
        drop_path = torch.ones(b, 2, dtype=torch.float32, device=x.device)
    check_kernel_args(*args, mask, drop_path, window_size=window_size,
                      num_heads=num_heads)
    check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)
    hidden = w1.shape[1]
    lib = _lib("swin_block_bwd")
    dev = x.device
    dx = torch.empty_like(x)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), tuple(rel_bias.shape),
              (c,), (c,), (c,), (c,), (c, hidden), (hidden,), (hidden, c),
              (c,))
    # one zeroed buffer (one fill kernel), cut into the 13 gradients
    sizes = [math.prod(sh) for sh in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    grads = tuple(v.view(sh) for v, sh in zip(flat.split(sizes), shapes))
    scratch16 = torch.empty(lib.swin_block_bwd_scratch_bf16(b, h, w, c, hidden),
                            dtype=torch.bfloat16, device=dev)
    scratch32 = torch.empty(lib.swin_block_bwd_scratch_f32(b, h, w, c),
                            dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.swin_block_bwd(
        ptr(x), ptr(dy), *(ptr(t) for t in args[1:]), ptr(mask),
        ptr(drop_path), ptr(dx), *(ptr(g) for g in grads),
        ptr(scratch16), ptr(scratch32), b, h, w, c, num_heads, hidden, eps,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"swin_block_bwd kernel launch failed with CUDA "
                           f"error {err}")
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
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib("swin_block_bwd").swin_block_atb_accum(
        ptr(a), ptr(b), ptr(out), m, n, ntok, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"atb_accum kernel launch failed with CUDA error "
                           f"{err}")
    return out


def kernel_smem_bytes(c: int, hidden: int) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the forward and of the backward
    window kernel at channel width ``c`` (builds the kernels; needs nvcc)."""
    return (int(_lib("swin_block").swin_block_smem_bytes(c)),
            int(_lib("swin_block_bwd").swin_block_bwd_smem_bytes(c, hidden)))


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
