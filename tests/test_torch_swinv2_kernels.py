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
block past the logit scale's clamp (whose gradient is zero there).
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
# (and the flow stage) at 128^2 shifted, its third at C 512 with 16 heads,
# its last at C 1024 with 32 heads in one unshifted 16x16 window; and a
# small case of windows of 4.
GEOMETRIES = [
    (2, 128, 128, 4, 16, 512, 8),
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
    """Eight kernels a forward and 18 a backward in the library's own
    count (``FWD_LAUNCHES``, ``BWD_LAUNCHES``)."""
    from strajnet_tpu_torch.ops.swin_block import window_any_launches
    args, mask, dp, dy = _case(card, 1, 8, 32, 2, 4, 64, 2, torch.bfloat16)
    kw = dict(window_size=4, num_heads=2)
    v2.swinv2_block(*args, mask, dp, **kw)
    n0 = window_any_launches()
    v2.swinv2_block(*args, mask, dp, **kw)
    n1 = window_any_launches()
    v2.swinv2_block_bwd(*args, mask, dp, dy, **kw)
    assert (n1 - n0, window_any_launches() - n1) == (v2.FWD_LAUNCHES,
                                                      v2.BWD_LAUNCHES)
