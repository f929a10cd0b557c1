"""The SwinV2 block's general-route kernels against the port's plain SwinV2
block, on a card.

Needs an NVIDIA GPU and nvcc, so these skip on a machine without one; run
them there with ``CUDA_VISIBLE_DEVICES=0 python -m pytest
tests/test_torch_swinv2_kernels.py -m cuda --noconftest`` (the file imports
no JAX). The forward (``swinv2_any_fwd``) and the backward
(``swinv2_any_bwd``) are held against ``swinv2_block_reference`` and its
autograd on the same card: in f32 directly, in bf16 by their distance from
the plain block computed in f32, against the plain bf16 block's own; at the
geometries of the SwinV2-B configuration's blocks, with a head of each
block past the logit scale's clamp (whose gradient is zero there). The
block's attention stage alone (``attention_stage``), fused in bf16 at head
size 32, is held against the two launches it replaces and against its
plain version (``attention_stage_reference``).
"""

import math

import pytest
import torch

from strajnet_tpu_torch.ops import swinv2_block as v2
from strajnet_tpu_torch.ops.windows import shifted_window_mask

pytestmark = pytest.mark.cuda

# f32: the forward within 1e-4 of the largest entry (3xTF32 products and
# sums in another order, as the Swin-v1 general route's f32 forward); the
# backward, against autograd of the plain block in f32, within the bf16
# operands' limits: the kernels round every backward product's operands to
# bf16 (as the Swin-v1 general route's), a bf16 operand is within 2^-9 of
# its value and a few products in a row add their errors, so the largest
# entry's error within 2^-6 of the largest entry (the Swin-v1 route's
# ANY_BF16_OPERANDS_MAX_ABS_REL) and the gradient's direction within
# 1 - cos 1e-4.
F32_FWD_TOL = 1e-4
F32_BWD_TOL = 2.0 ** -6
F32_BWD_ONE_MINUS_COS = 1e-4
# bf16: both the kernels and the plain block round their intermediates to
# bf16, each at its own places, and the cosine logits multiply a rounding
# of q or k by the logit scale (up to 100), so neither is the other's
# truth. Both are held against the plain block computed in f32 on the same
# (bf16) inputs: the kernels no further from it than BF16_FACTOR times the
# plain bf16 block is, in the largest entry's error and in 1 - cos, with a
# floor of one bf16 rounding (2^-8 of the largest entry; 1 - cos 1e-5)
# where the plain block comes closer than that.
BF16_FACTOR = 2.0
BF16_FLOOR = 2.0 ** -8
BF16_COS_FLOOR = 1e-5
# dtau, both types: a head's sum over every token of q^ . dq^, whose terms
# cancel (the softmax's gradient sums to zero over each row), from dS taken
# off p rounded to bf16 (as the Swin-v1 route's K2 takes it, in f32 too):
# its error is a bf16 rounding of the terms, not of the sum, so it is held
# to 2^-3 of its largest entry and 1 - cos 1e-3 (measured on the card: up
# to 4.5e-2 and 1.4e-4, at 2 and 32 heads).
DTAU_TOL = 2.0 ** -3
DTAU_ONE_MINUS_COS = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(card, b, h, c, heads, ws, hidden, shift, dtype):
    g = torch.Generator().manual_seed(0)

    def r(*s, k=1.0):
        return torch.randn(*s, generator=g) * k

    # a spread of logit scales around ln 10, head 0 past the clamp
    tau = math.log(10.0) + 1.5 * (torch.rand(heads, generator=g) * 2 - 1)
    tau[0] = 5.0
    bqkv = r(3 * c, k=0.1)
    bqkv[c:2 * c] = 0.0
    args = [r(b, h, h, c).to(dtype), r(c, 3 * c, k=c ** -0.5).to(dtype),
            bqkv.to(dtype), r(c, c, k=c ** -0.5).to(dtype),
            r(c, k=0.1).to(dtype),
            16.0 * torch.sigmoid(r(heads, ws * ws, ws * ws)), tau,
            1 + r(c, k=0.2), r(c, k=0.1), 1 + r(c, k=0.2), r(c, k=0.1),
            r(c, hidden, k=c ** -0.5).to(dtype), r(hidden, k=0.1),
            r(hidden, c, k=hidden ** -0.5).to(dtype), r(c, k=0.1)]
    args = [a.to(card) for a in args]
    mask = (torch.from_numpy(shifted_window_mask(h, h, ws, shift)).to(card)
            if shift else None)
    dp = (torch.rand(b, 2, generator=g) * 1.2).to(card)
    dy = r(b, h, h, c).to(dtype).to(card)
    return args, mask, dp, dy


def _gaps(got, want):
    """(largest error over the largest entry, 1 - cos) of two tensors."""
    a, w = got.double().flatten(), want.double().flatten()
    scale = float(w.abs().max())
    err = float((a - w).abs().max()) / scale if scale else float(
        (a - w).abs().max())
    cos = float(a @ w / (a.norm() * w.norm())) if scale else 1.0
    return err, 1.0 - cos


# (B, H = W, C, heads, window, MLP width, shift): SwinV2-B's first stage
# (and the flow stage) at 128^2 shifted, its second at C 256 with 8 heads,
# its third at C 512 with 16 heads, its last at C 1024 with 32 heads in one
# unshifted 16x16 window (head size 32 throughout: in bf16 the attention
# stage runs fused); and a small case of windows of 4 (head size 16: two
# launches).
GEOMETRIES = [
    (2, 128, 128, 4, 16, 512, 8),
    (2, 64, 256, 8, 16, 1024, 8),
    (2, 32, 512, 16, 16, 2048, 8),
    (2, 16, 1024, 32, 16, 4096, 0),
    (2, 8, 32, 2, 4, 64, 2),
]


def _forward_and_grads(block, args, mask, dp, dy, kw):
    ins = [a.clone().requires_grad_(True) for a in args]
    y = block(*ins, mask, dp, **kw)
    return (y,) + torch.autograd.grad(y, ins, dy)


def _named(outs, c):
    """(name, tensor) of the output and the gradients; dbqkv without k's
    third, which is no gradient (k has no bias)."""
    for name, t in zip(("y", "dx") + v2.GRAD_NAMES, outs):
        if name == "dbqkv":
            t = torch.cat([t[:c], t[2 * c:]])
        yield name, t.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c,heads,ws,hidden,shift", GEOMETRIES)
def test_swinv2_kernels_match_plain(card, b, h, c, heads, ws, hidden, shift,
                                    dtype):
    args, mask, dp, dy = _case(card, b, h, c, heads, ws, hidden, shift,
                               dtype)
    kw = dict(window_size=ws, num_heads=heads)
    f32 = dtype == torch.float32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = (v2.swinv2_block.launches_any,
                  v2.swinv2_block_bwd.launches_any)
        got = _forward_and_grads(v2.swinv2_block, args, mask, dp, dy, kw)
        assert (v2.swinv2_block.launches_any,
                v2.swinv2_block_bwd.launches_any) == (before[0] + 1,
                                                      before[1] + 1)
        again = v2.swinv2_block_bwd(*args, mask, dp, dy, **kw)
        plain = _forward_and_grads(v2.swinv2_block_reference, args, mask,
                                   dp, dy, kw)
        exact = plain if f32 else _forward_and_grads(
            v2.swinv2_block_reference,
            [a.float() if a.dtype == dtype else a for a in args], mask, dp,
            dy.float(), kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bad = []
    for (name, a), (_, p), (_, e) in zip(_named(got, c), _named(plain, c),
                                         _named(exact, c)):
        err, one_minus_cos = _gaps(a, e)
        if name == "dtau":
            lim = (DTAU_TOL, DTAU_ONE_MINUS_COS)
        elif f32:
            lim = (F32_FWD_TOL, 1.0) if name == "y" else (
                F32_BWD_TOL, F32_BWD_ONE_MINUS_COS)
        else:
            perr, pcos = _gaps(p, e)
            lim = (max(BF16_FACTOR * perr, BF16_FLOOR),
                   max(BF16_FACTOR * pcos, BF16_COS_FLOOR))
        print(f"{dtype} C {c} {name}: err {err:.3e} 1-cos "
              f"{one_minus_cos:.3e} limits {lim[0]:.3e} {lim[1]:.3e}")
        if err > lim[0] or one_minus_cos > lim[1]:
            bad.append(name)
    assert not bad, bad
    # the clamp's gradient: zero for head 0, past ln 100
    dtau = got[7]
    assert float(dtau[0]) == 0.0 and float(dtau[1:].abs().min()) > 0.0
    # twice on the same inputs: bit-identical (no atomics)
    assert torch.equal(again[0], got[1])
    assert all(torch.equal(a.to(t.dtype), t)
               for a, t in zip(again[1], got[2:]))


def test_swinv2_block_launch_counts(card):
    """Seven kernels a forward and 17 a backward in the library's own count
    (``FWD_LAUNCHES``, ``BWD_LAUNCHES``) in bf16 at head size 32, one of
    them the fused attention stage each way
    (``window_any_v2_attn_launches``); at head size 16 one more each way
    and no fused stage (``launches``)."""
    from strajnet_tpu_torch.ops.swin_block import (
        window_any_launches, window_any_v2_attn_launches)

    def counted(c, heads):
        args, mask, dp, dy = _case(card, 1, 8, c, heads, 4, 2 * c, 2,
                                   torch.bfloat16)
        kw = dict(window_size=4, num_heads=heads)
        v2.swinv2_block(*args, mask, dp, **kw)
        n0 = window_any_launches(), window_any_v2_attn_launches()
        v2.swinv2_block(*args, mask, dp, **kw)
        n1 = window_any_launches(), window_any_v2_attn_launches()
        v2.swinv2_block_bwd(*args, mask, dp, dy, **kw)
        n2 = window_any_launches(), window_any_v2_attn_launches()
        return tuple(b[i] - a[i] for i in (0, 1) for a, b in ((n0, n1),
                                                               (n1, n2)))

    assert counted(64, 2) == (v2.FWD_LAUNCHES, v2.BWD_LAUNCHES, 1, 1)
    assert v2.launches(torch.bfloat16, 32) == (7, 17)
    assert counted(32, 2) == v2.launches(torch.bfloat16, 16) + (0, 0)
    assert v2.launches(torch.bfloat16, 16) == (8, 18)


# (H = W, C, heads, window, shift) of the attention stage at batch 2: the
# SwinV2-B configuration's four widths (the first also the flow stage's),
# shifted and not, and the last in its one unshifted window; and windows of
# 16, 49 (rows of n % 4 != 0 floats: the bias staged by cp.async, not by
# tensor maps) and 144 tokens (a second half of the keys in part)
STAGE_GEOMETRIES = [
    (128, 128, 4, 16, 8), (128, 128, 4, 16, 0), (64, 256, 8, 16, 8),
    (64, 256, 8, 16, 0), (32, 512, 16, 16, 8), (32, 512, 16, 16, 0),
    (16, 1024, 32, 16, 0), (8, 64, 2, 4, 2), (14, 64, 2, 7, 3),
    (24, 96, 3, 12, 6),
]


def _stage_case(card, h, c, heads, shift, dtype, b=2, ws=16):
    g = torch.Generator().manual_seed(1)
    tau = math.log(10.0) + 1.5 * (torch.rand(heads, generator=g) * 2 - 1)
    tau[0] = 5.0
    qkv = torch.randn(b * h * h, 3 * c, generator=g).to(dtype)
    rel = 16.0 * torch.sigmoid(torch.randn(heads, ws * ws, ws * ws,
                                           generator=g))
    mask = (torch.from_numpy(shifted_window_mask(h, h, ws, shift)).to(card)
            if shift else None)
    kw = dict(window_size=ws, num_heads=heads)
    return qkv.to(card), tau.to(card), rel.to(card), mask, kw


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("h,c,heads,ws,shift", STAGE_GEOMETRIES)
def test_swinv2_fused_attention_stage_matches_two_launches(card, h, c, heads,
                                                           ws, shift, save):
    """The fused attention stage (``swinv2_attn_kernel``) against the two
    launches it replaces (``qk_norm_kernel``, ``attn_fwd_kernel``) on the
    same bf16 qkv: q', k' (left in qkv) and raw q, k bit for bit, and those
    of the plain stage too; without ``save`` qkv left as it was. merged and
    the row statistics held as the block is: against the plain stage in
    f32, no further than BF16_FACTOR times the two launches are."""
    from strajnet_tpu_torch.ops.swin_block import window_any_v2_attn_launches
    qkv, tau, rel, mask, kw = _stage_case(card, h, c, heads, shift,
                                          torch.bfloat16, ws=ws)
    geo = dict(batch=2, height=h, width=h, save=save, **kw)
    got_qkv, two_qkv = qkv.clone(), qkv.clone()
    n0 = window_any_v2_attn_launches()
    got = v2.attention_stage(got_qkv, tau, rel, mask, fused=True, **geo)
    assert window_any_v2_attn_launches() == n0 + 1
    two = v2.attention_stage(two_qkv, tau, rel, mask, fused=False, **geo)
    assert window_any_v2_attn_launches() == n0 + 1
    ref_qkv, ref_merged, ref_raw, ref_stats = v2.attention_stage_reference(
        qkv, tau, rel, mask, **kw)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, exact_merged, _, exact_stats = v2.attention_stage_reference(
            qkv.float(), tau, rel, mask, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(two_qkv, ref_qkv)
    if save:
        assert torch.equal(got_qkv, two_qkv)
        assert torch.equal(got[1], two[1]) and torch.equal(got[1], ref_raw)
    else:
        assert torch.equal(got_qkv, qkv)
        assert got[1] is None and got[2] is None
    pairs = [("merged", got[0], two[0], exact_merged)]
    if save:
        pairs += [("max", got[2][..., 0], two[2][..., 0], exact_stats[..., 0]),
                  ("sum", got[2][..., 1], two[2][..., 1], exact_stats[..., 1])]
    bad = []
    for name, a, p, e in pairs:
        err, omc = _gaps(a.float(), e.float())
        perr, pomc = _gaps(p.float(), e.float())
        lim = (max(BF16_FACTOR * perr, BF16_FLOOR),
               max(BF16_FACTOR * pomc, BF16_COS_FLOOR))
        print(f"stage C {c} ws {ws} shift {shift} save {save} {name}: err "
              f"{err:.3e} 1-cos {omc:.3e} (two launches {perr:.3e} "
              f"{pomc:.3e}); "
              f"bit-identical to the two launches: {torch.equal(a, p)}")
        if err > lim[0] or omc > lim[1]:
            bad.append(name)
    assert not bad, bad


def test_swinv2_attention_stage_unfused_in_f32(card):
    """f32, a type the fused stage is not built for: the route runs the two
    launches (no fused launch, two kernels), matching the plain stage, and
    asking for the fused kernel raises."""
    from strajnet_tpu_torch.ops.swin_block import (
        window_any_launches, window_any_v2_attn_launches)
    qkv, tau, rel, mask, kw = _stage_case(card, 32, 128, 4, 8, torch.float32)
    geo = dict(batch=2, height=32, width=32, save=True, **kw)
    assert not v2.fused_attention(torch.float32, 32)
    n0 = window_any_launches(), window_any_v2_attn_launches()
    got_qkv = qkv.clone()
    merged, raw, stats = v2.attention_stage(got_qkv, tau, rel, mask, **geo)
    assert (window_any_launches() - n0[0],
            window_any_v2_attn_launches() - n0[1]) == (2, 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = v2.attention_stage_reference(qkv, tau, rel, mask, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(raw, ref[2])
    for a, e in ((got_qkv, ref[0]), (merged, ref[1]), (stats, ref[3])):
        assert _gaps(a, e)[0] <= F32_FWD_TOL
    with pytest.raises(RuntimeError):
        v2.attention_stage(qkv.clone(), tau, rel, mask, fused=True, **geo)
