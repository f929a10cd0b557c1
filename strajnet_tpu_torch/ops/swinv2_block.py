"""The SwinV2 block, forward and backward: the CUDA wrapper and its plain
version.

:func:`swinv2_block` computes one whole SwinV2 block (arXiv 2111.09883) on
pre-rolled ``[B, H, W, C]`` input (the caller rolls for shifted windows):

    q, k, v = split(x @ wqkv + bqkv)            (bqkv = q_bias, 0, v_bias)
    A   = softmax(norm(q) * exp(min(tau_h, ln 100)) @ norm(k)^T + B + mask)
    r1  = x + dp1 * LN1(proj(A @ v))            (post-norm residuals)
    out = r1 + dp2 * LN2(MLP_gelu_tanh(r1))

with ``norm`` the L2 normalisation over head_dim (``F.normalize``, eps
1e-12), ``tau`` the learned logit scale of each head and ``B`` the
``[heads, n, n]`` f32 bias the caller computes (SwinV2's continuous
position bias, ``models/swin.py``), which takes its gradient as the Swin-v1
block's table bias does.

A tensor on the CPU takes :func:`swinv2_block_reference`, the plain
PyTorch version, under autograd. A CUDA tensor goes through
:class:`_SwinV2BlockFn`: the forward launches ``swinv2_any_fwd`` of
``csrc/window_any.cu`` (the general route, f32 or bf16, at every width the
route takes) and saves only its inputs; the backward launches
``swinv2_any_bwd``, which recomputes the forward and returns dx and the 14
parameter gradients. The blocks reuse the route's products, around kernels
of their own: the attention stage, the normalisation's backward, the
post-norms and their backward, and dx's last sum. The attention stage (q
and k normalised, q scaled, the window attention at scale 1) is one kernel
in bf16 at head size 32 (``swinv2_attn_kernel``; seven launches a forward,
17 a backward, :data:`FWD_LAUNCHES` and :data:`BWD_LAUNCHES`), and two
elsewhere (the normalisation, then the route's fused window attention; one
launch more each way): :func:`fused_attention` and :func:`launches` state
the choice, :func:`attention_stage` runs the stage alone for the tests,
:func:`attention_stage_reference` is its plain version. As on the Swin-v1
general route, every backward product takes operands rounded to bf16
whatever the element type.

``swinv2_block.launches_any`` and ``swinv2_block_bwd.launches_any`` count
the calls. A failed build or launch, or a shape the route does not take,
raises; there is no fallback.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from strajnet_tpu_torch._build import check_tensors, launch
from strajnet_tpu_torch.ops.swin_block import (any_scratch,
                                               attention_tensors, check_grid,
                                               kernel_route, ln_f32,
                                               mlp_tensors, window_any_lib)

LOGIT_SCALE_MAX = math.log(100.0)   # the logit scale's clamp, ln 100
NORM_EPS = 1e-12                    # F.normalize's
FWD_LAUNCHES = 7                    # kernels a forward call, the stage fused
BWD_LAUNCHES = 17                   # kernels a backward call, the stage fused
FUSED_HEAD_DIM = 32                 # the head size swinv2_attn_kernel takes
# window_any_scratch_bytes' kinds of the SwinV2 block's launches
_KIND_FWD, _KIND_BWD = 4, 5

GRAD_NAMES = ("dwqkv", "dbqkv", "dwproj", "dbproj", "drel", "dtau", "dln1s",
              "dln1b", "dln2s", "dln2b", "dw1", "db1", "dw2", "db2")


def logit_scales(tau: torch.Tensor) -> torch.Tensor:
    """``exp(min(tau, ln 100))`` in f32: the heads' logit scales."""
    return torch.exp(torch.clamp(tau.float(), max=LOGIT_SCALE_MAX))


def fused_attention(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the block's attention stage runs as one kernel
    (``swinv2_attn_kernel``) at this element type and head size: bf16 at
    head size 32. Elsewhere it runs as two, the normalisation of q and k,
    then the route's window attention (``csrc/window_any.cu::
    v2_attn_fused``, the same rule)."""
    return dtype == torch.bfloat16 and head_dim == FUSED_HEAD_DIM


def launches(dtype: torch.dtype, head_dim: int) -> Tuple[int, int]:
    """Kernels a forward and a backward call launch at this element type
    and head size: :data:`FWD_LAUNCHES` and :data:`BWD_LAUNCHES` with the
    stage fused, one more each without."""
    more = 0 if fused_attention(dtype, head_dim) else 1
    return FWD_LAUNCHES + more, BWD_LAUNCHES + more


def attention_stage_reference(qkv, tau, rel_bias, mask=None, *,
                              window_size: int, num_heads: int):
    """Plain PyTorch attention stage of the block, the kernels' arithmetic.

    ``qkv`` is ``[M, 3C]`` in window order (window after window, each of
    ``window_size ** 2`` tokens), ``tau`` ``[heads]``, ``rel_bias``
    ``[heads, n, n]``, ``mask`` ``[nW, n, n]`` or None. Returns ``(qkv'``
    (q and k normalised and q scaled, in qkv's type), ``merged`` ``[M, C]``,
    ``raw`` ``[M, 2C]`` (q and k as they were), ``stats`` ``[windows *
    heads, n, 2]`` (each row's logit max and sum of exp(logit - max))).
    The squares of a row are summed in order over the head's elements as
    the kernels sum them; a bf16 square is exact in f32, so in bf16 q' and
    k' are the kernels' bit for bit. The logits, softmax and p @ v run in
    f32 on q', k' and p rounded to qkv's type."""
    m, c3 = qkv.shape
    c, n, heads = c3 // 3, window_size * window_size, num_heads
    hd, dt = c // heads, qkv.dtype
    x = qkv.reshape(-1, n, 3, heads, hd)
    qk = x[:, :, :2].float()
    ss = torch.zeros(qk.shape[:-1], dtype=torch.float32, device=qkv.device)
    for e in range(hd):
        ss = ss + qk[..., e] * qk[..., e]
    den = torch.sqrt(ss).clamp_min(NORM_EPS)
    g = torch.stack([logit_scales(tau), torch.ones_like(tau.float())])
    qkn = (qk / den[..., None] * g[:, :, None]).to(dt)
    out = qkv.clone()
    out.view(-1, n, 3, heads, hd)[:, :, :2] = qkn
    raw = qkv.reshape(m, 3, c)[:, :2].reshape(m, 2 * c).clone()
    q, k = (qkn[:, :, i].float().transpose(1, 2) for i in (0, 1))
    logits = q @ k.transpose(-1, -2) + rel_bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(-1, nw, heads, n, n)
                  + mask.float()[None, :, None]).reshape(-1, heads, n, n)
    mx = logits.amax(-1)
    e = torch.exp(logits - mx[..., None])
    sm = e.sum(-1)
    p = (e / sm[..., None]).to(dt)
    merged = (p.float() @ x[:, :, 2].float().transpose(1, 2)).to(dt)
    merged = merged.transpose(1, 2).reshape(m, c)
    return out, merged, raw, torch.stack([mx, sm], -1).reshape(-1, n, 2)


def swinv2_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, tau, ln1s,
                           ln1b, ln2s, ln2b, w1, b1, w2, b2, mask=None,
                           drop_path=None, *, window_size: int,
                           num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch SwinV2 block, the kernels' semantics.

    Matrix products run in ``x.dtype`` (bf16 operands with bf16 results on
    the bf16 path); the normalisation of q and k, the logits, softmax and
    both LayerNorms in f32. q and k are normalised in f32 and rounded to
    ``x.dtype`` after q's scale, as the kernels store them; each residual
    sum is rounded once. ``tau`` is ``[heads]``.
    """
    b_, h, w, c = x.shape
    ws, heads = window_size, num_heads
    hd, n = c // heads, ws * ws
    dt = x.dtype
    dp = (torch.ones(b_, 2, dtype=torch.float32, device=x.device)
          if drop_path is None else drop_path.float())
    xw = x.reshape(b_, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    qkv = xw.reshape(-1, n, c) @ wqkv.to(dt) + bqkv.to(dt)
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scale = logit_scales(tau).reshape(-1, 1, 1)
    qn = (F.normalize(q.float(), dim=-1, eps=NORM_EPS) * scale).to(dt)
    kn = F.normalize(k.float(), dim=-1, eps=NORM_EPS).to(dt)
    attn = qn.float() @ kn.float().transpose(-1, -2) + rel_bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, n, n)
                + mask.float()[None, :, None]).reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = (attn @ v).transpose(1, 2).reshape(-1, n, c)
    out = out @ wproj.to(dt) + bproj.to(dt)
    out = out.reshape(b_, h // ws, w // ws, ws, ws, c)
    y1 = out.permute(0, 1, 3, 2, 4, 5).reshape(b_, h, w, c)
    r1 = (x.float() + dp[:, 0, None, None, None]
          * ln_f32(y1, ln1s, ln1b, eps)).to(dt)
    y = F.gelu((r1 @ w1.to(dt) + b1.to(dt)).float(),
               approximate="tanh").to(dt)
    y2 = y @ w2.to(dt) + b2.to(dt)
    return (r1.float() + dp[:, 1, None, None, None]
            * ln_f32(y2, ln2s, ln2b, eps)).to(dt)


def attention_stage(qkv, tau, rel_bias, mask=None, *, batch: int,
                    height: int, width: int, window_size: int,
                    num_heads: int, save: bool = False,
                    fused: Optional[bool] = None):
    """For the tests: the block's attention stage alone on CUDA tensors,
    as the block's forward (``save`` False) or its backward's recompute
    (``save``) runs it. ``qkv`` ``[M, 3C]`` in window order (M = batch *
    height * width) and the rest as :func:`attention_stage_reference` takes
    them. ``fused`` None takes the route's choice (:func:`fused_attention`),
    True the fused kernel (bf16 at head size 32 only), False the two
    launches. Returns ``(merged, raw, stats)``, raw and stats None without
    ``save``; q and k in ``qkv`` are left normalised where ``save`` or the
    two launches."""
    m, c3 = qkv.shape
    c, n = c3 // 3, window_size * window_size
    expect = {"qkv": (qkv, qkv.dtype, (batch * height * width, 3 * c)),
              "tau": (tau, torch.float32, (num_heads,)),
              "rel_bias": (rel_bias, torch.float32, (num_heads, n, n))}
    if mask is not None:
        nw = (height // window_size) * (width // window_size)
        expect["mask"] = (mask, torch.float32, (nw, n, n))
    check_tensors(expect, qkv.device)
    if fused is None:
        fused = fused_attention(qkv.dtype, c // num_heads)
    merged = qkv.new_empty(m, c)
    raw = qkv.new_empty(m, 2 * c) if save else None
    stats = (torch.empty(m // n * num_heads, n, 2, dtype=torch.float32,
                         device=qkv.device) if save else None)
    launch(window_any_lib(), "swinv2_any_attn", qkv, tau, rel_bias, mask,
           merged, raw, stats, int(fused), int(qkv.dtype == torch.bfloat16),
           batch, height, width, c, num_heads, window_size)
    return merged, raw, stats


def check_args(x, wqkv, bqkv, wproj, bproj, rel_bias, tau, ln1s, ln1b, ln2s,
               ln2b, w1, b1, w2, b2, mask, drop_path, *, window_size: int,
               num_heads: int) -> None:
    """Raises ValueError unless the general route's SwinV2 block takes these
    arguments: the Swin-v1 general block's (x, the matrix weights,
    ``bqkv`` and ``bproj`` in one element type, f32 or bf16; f32 ``rel_bias
    [heads, n, n]``, mask, LayerNorm parameters, ``b1``, ``b2`` and
    drop-path multipliers; :func:`~strajnet_tpu_torch.ops.swin_block.
    kernel_route`'s limits), and an f32 ``tau [heads]``. Touches no
    kernel."""
    check_grid(x, window_size)
    hidden = w1.shape[-1] if w1.dim() == 2 else -1
    kernel_route(x.dtype, x.shape[-1], num_heads, window_size, hidden)
    expect = attention_tensors(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                               window_size, num_heads, x.dtype)
    expect.update(mlp_tensors(x, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                              drop_path, x.dtype))
    expect["tau"] = (tau, torch.float32, (num_heads,))
    check_tensors(expect, x.device)


def _launch_fwd(args, mask, drop_path, window_size, num_heads, eps):
    x, w1 = args[0], args[11]
    check_args(*args, mask, drop_path, window_size=window_size,
               num_heads=num_heads)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    scratch = any_scratch(_KIND_FWD, x, num_heads, window_size, w1.shape[1])
    launch(window_any_lib(), "swinv2_any_fwd", *args, mask, drop_path, out,
           scratch, int(x.dtype == torch.bfloat16), b, h, w, c, num_heads,
           window_size, w1.shape[1], eps)
    swinv2_block.launches_any += 1
    return out


def swinv2_block_bwd(x, wqkv, bqkv, wproj, bproj, rel_bias, tau, ln1s, ln1b,
                     ln2s, ln2b, w1, b1, w2, b2, mask, drop_path, dy, *,
                     window_size: int, num_heads: int, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward of :func:`swinv2_block` on CUDA tensors: ``(dx, 14 f32
    parameter gradients in the order of`` :data:`GRAD_NAMES` ``)``. The
    forward is recomputed; every backward product takes operands rounded to
    bf16, as the Swin-v1 general route's."""
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, tau, ln1s, ln1b, ln2s,
            ln2b, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"swinv2_block_bwd runs on CUDA tensors, got "
                         f"{x.device}")
    b, h, w, c = x.shape
    if drop_path is None:
        drop_path = torch.ones(b, 2, dtype=torch.float32, device=x.device)
    check_args(*args, mask, drop_path, window_size=window_size,
               num_heads=num_heads)
    check_tensors({"dy": (dy, x.dtype, x.shape)}, x.device)
    hidden = w1.shape[1]
    dx = torch.empty_like(x)
    shapes = ((c, 3 * c), (3 * c,), (c, c), (c,), tuple(rel_bias.shape),
              (num_heads,), (c,), (c,), (c,), (c,), (c, hidden), (hidden,),
              (hidden, c), (c,))
    # one zeroed buffer (one fill kernel), cut into the 14 gradients
    sizes = [math.prod(sh) for sh in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=x.device)
    grads = tuple(v.view(sh) for v, sh in zip(flat.split(sizes), shapes))
    scratch = any_scratch(_KIND_BWD, x, num_heads, window_size, hidden)
    launch(window_any_lib(), "swinv2_any_bwd", x, dy, *args[1:], mask,
           drop_path, dx, *grads, scratch, int(x.dtype == torch.bfloat16), b,
           h, w, c, num_heads, window_size, hidden, eps)
    swinv2_block_bwd.launches_any += 1
    return dx, grads


class _SwinV2BlockFn(torch.autograd.Function):
    """The SwinV2 block's forward kernels; its backward kernels recompute the
    forward, so only the inputs are saved."""

    @staticmethod
    def forward(ctx, window_size, num_heads, eps, mask, drop_path, *args):
        ctx.save_for_backward(mask, drop_path, *args)
        ctx.cfg = (window_size, num_heads, eps)
        return _launch_fwd(args, mask, drop_path, window_size, num_heads, eps)

    @staticmethod
    def backward(ctx, dy):
        mask, drop_path, *args = ctx.saved_tensors
        window_size, num_heads, eps = ctx.cfg
        dx, grads = swinv2_block_bwd(*args, mask, drop_path, dy.contiguous(),
                                     window_size=window_size,
                                     num_heads=num_heads, eps=eps)
        return (None,) * 5 + (dx,) + tuple(
            g.to(t.dtype) for g, t in zip(grads, args[1:]))


def swinv2_block(x: torch.Tensor, wqkv, bqkv, wproj, bproj, rel_bias, tau,
                 ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                 mask: Optional[torch.Tensor] = None,
                 drop_path: Optional[torch.Tensor] = None, *,
                 window_size: int, num_heads: int,
                 eps: float = 1e-5) -> torch.Tensor:
    """One SwinV2 block on pre-rolled x; the kernels on CUDA, plain on the
    CPU.

    Args:
      x: [B, H, W, C] input, already rolled by -shift.
      wqkv/bqkv: [C, 3C] / [3C] (k's third of bqkv zero); wproj/bproj:
        [C, C] / [C].
      rel_bias: [heads, ws*ws, ws*ws] position bias (f32).
      tau: [heads] logit scales before the clamp and exp (f32).
      ln1s/ln1b/ln2s/ln2b: [C] post-norm parameters.
      w1/b1: [C, hidden] / [hidden]; w2/b2: [hidden, C] / [C].
      mask: optional [nW, ws*ws, ws*ws] SW-MSA mask (no gradient).
      drop_path: optional [B, 2] keep-scaled per-sample multipliers of the
        two residual branches (no gradient).
    """
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias, tau, ln1s, ln1b, ln2s,
            ln2b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swinv2_block_reference(*args, mask, drop_path,
                                      window_size=window_size,
                                      num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"swinv2_block runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if drop_path is None:
        drop_path = torch.ones(x.shape[0], 2, dtype=torch.float32,
                               device=x.device)
    return _SwinV2BlockFn.apply(window_size, num_heads, eps, mask, drop_path,
                                *args)


swinv2_block.launches_any = 0
swinv2_block_bwd.launches_any = 0
