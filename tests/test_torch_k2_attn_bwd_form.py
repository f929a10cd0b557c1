"""The form of the general K2's attention backward
(``csrc/window_any.cu::attn_bwd_kernel<T, true>``), on the CPU.

One kernel computes dq, dk and dv of a window and head from one computation
of p and dp: a warp owns 16 keys; the 16-query tiles of q and dO stream
through the block one after another; per tile each warp sums p dp over its
keys, the warps' sums are added in warp order (D), dS = p (dp - D) takes p
rounded to T (as ``pallas_swin_block.py::_bwd_kernel`` does), dv and dk
gather over the tiles in registers and dq is summed over all keys per tile.
``k2_form`` is that arithmetic in torch, tile by tile and warp by warp. In
f32 it is held against autograd of the plain attention; in f32 and bf16
against the attention stage of ``swin_block_backward_reference``, alone and
in place inside the whole block backward. The kernel itself runs only on a
card (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.ops import swin_block as sb
from strajnet_tpu_torch.ops.windows import shifted_window_mask

torch.set_num_threads(2)
# (windows, heads, window, head_dim, shift, grid side): 16 tokens, and 49
# tokens in 64 rows (a ragged last tile and a ragged last warp)
GEOMETRIES = {"ws4": (4, 2, 4, 8, 2, 8), "ws7": (4, 3, 7, 16, 3, 14)}
F32_MAX_ABS_REL = 1e-5


def _rnd(t, dt):
    return t.to(dt).float()


def k2_form(q, k, v, p, do, scale, rd):
    """dq, dk, dv (f32, before their rounding to ``rd``) and drel from q,
    k, v, the f32 softmax p and dO ``[BW, heads, n, hd]``, in the kernel's
    order: 16-query tiles, a warp per 16 keys, the warps' row sums added in
    warp order, dS from p rounded to ``rd``, every product on operands in
    ``rd``."""
    bw, heads, n, hd = q.shape
    n_pad = -(-n // 16) * 16

    def pad(t):   # rows beyond the window read as 0, as in shared memory
        return torch.nn.functional.pad(t, (0, 0, 0, n_pad - t.shape[-2]))

    q, k, v, do = (pad(_rnd(t, rd)) for t in (q, k, v, do))
    p = torch.nn.functional.pad(p, (0, n_pad - n, 0, n_pad - n))
    dq = torch.zeros(bw, heads, n_pad, hd)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    drel = torch.zeros(heads, n_pad, n_pad)
    warps = [slice(w0, w0 + 16) for w0 in range(0, n_pad, 16)]
    for q0 in range(0, n_pad, 16):
        tile = slice(q0, q0 + 16)
        qt, ot = q[..., tile, :], do[..., tile, :]
        # per warp: its keys x the tile's queries
        pt = [_rnd(p[..., tile, keys].transpose(-1, -2), rd) for keys in warps]
        dpt = [v[..., keys, :] @ ot.transpose(-1, -2) for keys in warps]
        big_d = torch.zeros(bw, heads, 1, 16)
        for pw, dw in zip(pt, dpt):   # warp order
            big_d = big_d + (pw * dw).sum(-2, keepdim=True)
        sd = torch.zeros(bw, heads, 16, n_pad)
        for keys, pw, dw in zip(warps, pt, dpt):
            ds = pw * (dw - big_d)
            drel[:, tile, keys] += ds.transpose(-1, -2).sum(0)
            dv[..., keys, :] += pw @ ot
            dk[..., keys, :] += _rnd(ds, rd) @ qt
            sd[..., keys] = _rnd(ds, rd).transpose(-1, -2)
        dq[..., tile, :] = sd @ k
    return (dq[..., :n, :] * scale, dk[..., :n, :] * scale, dv[..., :n, :],
            drel[:, :n, :n])


def _attention_inputs(name, seed=0):
    bw, heads, ws, hd, shift, side = GEOMETRIES[name]
    n = ws * ws
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    q, k, v, do = (r(bw, heads, n, hd) for _ in range(4))
    rel = r(heads, n, n, k=0.3)
    mask = torch.from_numpy(shifted_window_mask(side, side, ws, shift))
    assert mask.shape[0] == bw
    return q, k, v, do, rel, mask, hd ** -0.5


def _softmax(q, k, rel, mask, scale):
    s = q @ k.transpose(-1, -2) * scale + rel[None] + mask[:, None]
    return torch.softmax(s, dim=-1)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_k2_form_in_f32_is_the_gradient_of_the_plain_attention(name):
    """f32 (no rounding): dq, dk, dv and the rel-pos gradient against
    autograd of softmax(q k^T scale + rel + mask) v, within 1e-5 of each
    one's largest entry."""
    q, k, v, do, rel, mask, scale = _attention_inputs(name)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
    y = _softmax(ins[0], ins[1], ins[3], mask, scale) @ ins[2]
    want = torch.autograd.grad(y, ins, do)
    got = k2_form(q, k, v, _softmax(q, k, rel, mask, scale), do, scale,
                  torch.float32)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= F32_MAX_ABS_REL * float(
            w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_k2_form_matches_the_reference_attention_stage(name, dtype):
    """Against ``attention_backward_stage`` on the same operands, dq, dk,
    dv rounded to T as both store them: f32 within 1e-5; bf16 within the
    general K2's limits (2^-6 of the largest entry, 1 - cos 1e-4), since a
    sum in another order can round a bf16 operand the other way."""
    q, k, v, do, rel, mask, scale = _attention_inputs(name, seed=1)
    q, k, v, do = (_rnd(t, dtype) for t in (q, k, v, do))
    p = _softmax(q, k, rel, mask, scale)
    got = k2_form(q, k, v, p, do, scale, dtype)
    want = sb.attention_backward_stage(q, k, v, p, do, scale, dtype)
    for i, (a, w) in enumerate(zip(got, want)):
        if i < 3:
            a, w = _rnd(a, dtype), _rnd(w, dtype)
        err = float((a - w).abs().max()) / float(w.abs().max())
        if dtype == torch.float32:
            assert err <= F32_MAX_ABS_REL, i
        else:
            a64, w64 = a.double().flatten(), w.double().flatten()
            assert err <= 2.0 ** -6, i
            assert 1.0 - float(a64 @ w64 / (a64.norm() * w64.norm())) \
                <= 1e-4, i


def _block_inputs(dtype, seed=2):
    """A Swin block at C 48, 3 heads, 7x7 windows, shift 3, MLP 96."""
    b, h, c, heads, ws, hidden = 2, 14, 48, 3, 7, 96
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    args = [r(b, h, h, c).to(dtype), r(c, 3 * c, k=c ** -0.5).to(dtype),
            r(3 * c, k=0.1).to(dtype), r(c, c, k=c ** -0.5).to(dtype),
            r(c, k=0.1).to(dtype), r(heads, ws * ws, ws * ws, k=0.3),
            1 + r(c, k=0.1), r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
            r(c, hidden, k=c ** -0.5).to(dtype), r(hidden, k=0.1),
            r(hidden, c, k=hidden ** -0.5).to(dtype), r(c, k=0.1)]
    mask = torch.from_numpy(shifted_window_mask(h, h, ws, 3))
    dp = torch.rand(b, 2, generator=g) * 1.2
    dy = r(b, h, h, c).to(dtype)
    return args, mask, dp, dy, dict(window_size=ws, num_heads=heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_backward_with_the_k2_form_as_its_attention_stage(dtype):
    """``swin_block_backward_reference`` with its attention stage replaced
    by ``k2_form``: dx and the 13 gradients against the reference as it
    is, f32 within 1e-5 of each result's largest entry, bf16 within the
    general K2's limits."""
    args, mask, dp, dy, kw = _block_inputs(dtype)
    want = sb.swin_block_backward_reference(*args, mask, dp, dy, **kw)
    with mock.patch.object(sb, "attention_backward_stage", k2_form):
        got = sb.swin_block_backward_reference(*args, mask, dp, dy, **kw)
    for i, (a, w) in enumerate(zip((got[0],) + got[1],
                                   (want[0],) + want[1])):
        a, w = a.float(), w.float()
        err = float((a - w).abs().max()) / float(w.abs().max())
        if dtype == torch.float32:
            assert err <= F32_MAX_ABS_REL, (i, err)
        else:
            a64, w64 = a.double().flatten(), w.double().flatten()
            assert err <= 2.0 ** -6, (i, err)
            assert 1.0 - float(a64 @ w64 / (a64.norm() * w64.norm())) \
                <= 1e-4, i


def test_k2_form_takes_ds_from_p_rounded_to_t():
    """In bf16, dS from p rounded to bf16 (K2, as the block kernel) is the
    reference stage's; from the f32 p (K4, as the attention kernel) it is a
    different answer: the rel-pos gradient moves by more than the K2 form
    differs from the reference."""
    q, k, v, do, rel, mask, scale = _attention_inputs("ws7", seed=3)
    bf = torch.bfloat16
    q, k, v, do = (_rnd(t, bf) for t in (q, k, v, do))
    p = _softmax(q, k, rel, mask, scale)
    want = sb.attention_backward_stage(q, k, v, p, do, scale, bf)[3]
    got = k2_form(q, k, v, p, do, scale, bf)[3]
    pb = _rnd(p, bf)
    dpr = do @ v.transpose(-1, -2)
    k4_drel = (p * (dpr - (dpr * p).sum(-1, keepdim=True))).sum(0)
    assert float((got - want).abs().max()) < 0.1 * float(
        (k4_drel - want).abs().max())
    assert not torch.equal(pb, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
