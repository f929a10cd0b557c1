"""The fused Swin-block forward: CUDA kernel wrapper and its plain version.

Counterpart of ``strajnet_tpu/ops/pallas_swin_block.py``. :func:`swin_block`
takes the arguments of ``fused_swin_block`` and computes one whole Swin block
on pre-rolled ``[B, H, W, C]`` input (the caller rolls for shifted windows):

    r1  = x + dp1 * proj(W-MSA(LN1(x)))      (rel-pos bias, 0/-100 SW-MSA mask)
    out = r1 + dp2 * MLP_gelu_tanh(LN2(r1))

A tensor on the CPU takes :func:`swin_block_reference`, the plain PyTorch
version with the semantics of ``_xla_block_reference``. A CUDA tensor launches
``csrc/swin_block.cu`` or raises; there is no fallback. The kernel is the
forward only: its backward is still to be ported (ROADMAP.md), so a CUDA call
that would need a gradient raises. ``swin_block.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_KERNEL_WINDOW = 8   # ws * ws == 64 tokens per thread block
_MAX_CHANNELS = 384   # shared memory: 214 KB of the 227 KB at C=384


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


def check_kernel_args(x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b,
                      ln2s, ln2b, w1, b1, w2, b2, mask, drop_path, *,
                      window_size: int, num_heads: int) -> None:
    """Raises ValueError unless the CUDA kernel takes these arguments.

    The kernel wants bf16 activations and matrix weights, bf16 ``bqkv`` and
    ``bproj``, f32 LayerNorm params, ``b1``, ``b2``, ``rel_bias``, mask and
    drop-path multipliers; every tensor contiguous and on x's device; 8x8
    windows; C a multiple of 32 up to 384; head_dim a multiple of 16;
    MLP hidden width a multiple of 128.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    if window_size != _KERNEL_WINDOW:
        raise ValueError(f"the kernel runs 8x8 windows (64 tokens), got "
                         f"window_size={window_size}")
    if h % window_size or w % window_size:
        raise ValueError(f"H={h}, W={w} must be multiples of {window_size}")
    if c % 32 or c > _MAX_CHANNELS:
        raise ValueError(f"C={c} must be a multiple of 32 and <= "
                         f"{_MAX_CHANNELS}")
    if c % num_heads or (c // num_heads) % 16:
        raise ValueError(f"head_dim C/heads = {c}/{num_heads} must be a "
                         f"multiple of 16")
    if hidden <= 0 or hidden % 128:
        raise ValueError(f"MLP hidden width {hidden} must be a multiple of "
                         f"128")
    n = window_size * window_size
    expect = {
        "x": (x, torch.bfloat16, (b, h, w, c)),
        "wqkv": (wqkv, torch.bfloat16, (c, 3 * c)),
        "bqkv": (bqkv, torch.bfloat16, (3 * c,)),
        "wproj": (wproj, torch.bfloat16, (c, c)),
        "bproj": (bproj, torch.bfloat16, (c,)),
        "rel_bias": (rel_bias, torch.float32, (num_heads, n, n)),
        "ln1s": (ln1s, torch.float32, (c,)),
        "ln1b": (ln1b, torch.float32, (c,)),
        "ln2s": (ln2s, torch.float32, (c,)),
        "ln2b": (ln2b, torch.float32, (c,)),
        "w1": (w1, torch.bfloat16, (c, hidden)),
        "b1": (b1, torch.float32, (hidden,)),
        "w2": (w2, torch.bfloat16, (hidden, c)),
        "b2": (b2, torch.float32, (c,)),
    }
    if mask is not None:
        expect["mask"] = (mask, torch.float32,
                          ((h // window_size) * (w // window_size), n, n))
    if drop_path is not None:
        expect["drop_path"] = (drop_path, torch.float32, (b, 2))
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _bind():
    from strajnet_tpu_torch._build import load_library

    lib = load_library("swin_block")
    fn = lib.swin_block_fwd
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def swin_block(x: torch.Tensor, wqkv, bqkv, wproj, bproj, rel_bias,
               ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
               mask: Optional[torch.Tensor] = None,
               drop_path: Optional[torch.Tensor] = None, *,
               window_size: int, num_heads: int,
               eps: float = 1e-5) -> torch.Tensor:
    """One Swin block on pre-rolled x; the kernel on CUDA, plain on the CPU.

    Args:
      x: [B, H, W, C] input, already rolled by -shift.
      wqkv/bqkv: [C, 3C] / [3C]; wproj/bproj: [C, C] / [C].
      rel_bias: [heads, ws*ws, ws*ws] relative-position bias.
      ln1s/ln1b/ln2s/ln2b: [C] LayerNorm parameters.
      w1/b1: [C, hidden] / [hidden]; w2/b2: [hidden, C] / [C].
      mask: optional [nW, ws*ws, ws*ws] SW-MSA mask.
      drop_path: optional [B, 2] keep-scaled per-sample multipliers of the
        two residual branches.
    """
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, ln1s, ln1b, ln2s, ln2b,
            w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, mask, drop_path,
                                    window_size=window_size,
                                    num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"swin_block runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in args + (mask, drop_path)):
        raise RuntimeError(
            "the CUDA swin_block kernel is forward-only; its backward is "
            "still to be ported (ROADMAP.md). Run under torch.no_grad() or "
            "use_pallas_attention=False for gradients.")
    check_kernel_args(*args, mask, drop_path, window_size=window_size,
                      num_heads=num_heads)
    b, h, w, c = x.shape
    if drop_path is None:
        drop_path = torch.ones(b, 2, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bind()(*(_ptr(t) for t in args), _ptr(mask), _ptr(drop_path),
                  _ptr(out), b, h, w, c, num_heads, w1.shape[1], eps,
                  ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"swin_block kernel launch failed with CUDA error "
                           f"{err}")
    swin_block.launches += 1
    return out


swin_block.launches = 0
