"""The port's explicit Swin-block backward against autograd and JAX, on the CPU.

``swin_block_backward_reference`` (the CPU path of ``swin_block_bwd`` and the
backward kernel's oracle) is held against torch autograd of
``swin_block_reference`` and against ``jax.grad`` of the JAX package's fused
block, whose Pallas backward kernel runs in interpret mode: dx and all 13
parameter gradients. The CUDA kernel itself is checked on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.ops.pallas_swin_block import fused_swin_block
from strajnet_tpu.ops.windows import shifted_window_mask as jax_mask
from strajnet_tpu_torch.ops.swin_block import (GRAD_NAMES, atb_accum,
                                               swin_block,
                                               swin_block_backward_reference,
                                               swin_block_bwd,
                                               swin_block_reference,
                                               token_blocked)

torch.set_num_threads(2)

NAMES = ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias", "ln1s", "ln1b",
         "ln2s", "ln2b", "w1", "b1", "w2", "b2")
OUT_NAMES = ("dx",) + GRAD_NAMES
B, H, W, C, WS, HEADS = 2, 16, 16, 8, 4, 2
KW = dict(window_size=WS, num_heads=HEADS)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hidden = 4 * C
    a = dict(
        x=f(B, H, W, C) * 0.5,
        wqkv=f(C, 3 * C) * 0.2, bqkv=f(3 * C) * 0.1,
        wproj=f(C, C) * 0.2, bproj=f(C) * 0.1,
        rel_bias=f(HEADS, WS * WS, WS * WS) * 0.3,
        ln1s=1.0 + 0.1 * f(C), ln1b=0.1 * f(C),
        ln2s=1.0 + 0.1 * f(C), ln2b=0.1 * f(C),
        w1=f(C, hidden) * 0.2, b1=f(hidden) * 0.1,
        w2=f(hidden, C) * 0.2, b2=f(C) * 0.1,
    )
    dy = f(B, H, W, C)
    # sample 0 drops the attention branch, sample 1 keeps both, scaled
    dp = np.array([[0.0, 1.0 / 0.9], [1.0 / 0.9, 1.25]], np.float32)
    return a, dy, dp


def _mask(shift):
    return jax_mask(H, W, WS, shift) if shift > 0 else None


def _ours(a, dy, dp, mask, dtype=torch.float32, **kw):
    cast = lambda k, v: (v.to(dtype) if k in  # noqa: E731
                         ("x", "wqkv", "bqkv", "wproj", "bproj", "w1", "w2")
                         else v)
    t = [cast(k, torch.from_numpy(a[k])) for k in NAMES]
    tm = None if mask is None else torch.from_numpy(mask)
    return t, tm, swin_block_backward_reference(
        *t, tm, torch.from_numpy(dp), torch.from_numpy(dy).to(dtype), **KW,
        **kw)


def _jax_grads(a, dy, dp, mask, dtype=jnp.float32):
    cast = lambda k, v: (v.astype(dtype) if k in  # noqa: E731
                         ("x", "wqkv", "bqkv", "wproj", "bproj", "w1", "w2")
                         else v)
    vals = [cast(k, jnp.asarray(a[k])) for k in NAMES]
    jm = None if mask is None else jnp.asarray(mask)
    cot = jnp.asarray(dy)

    def loss(vals):
        y = fused_swin_block(*vals, jm, jnp.asarray(dp), interpret=True, **KW)
        return jnp.sum(y.astype(jnp.float32) * cot)

    return [np.asarray(g, np.float32) for g in jax.grad(loss)(vals)]


@pytest.mark.parametrize("shift", [0, 2])
def test_backward_reference_matches_autograd_f32(shift):
    a, dy, dp, mask = *_inputs(), _mask(shift)
    t, tm, (dx, grads) = _ours(a, dy, dp, mask)
    ins = [v.clone().requires_grad_(True) for v in t]
    y = swin_block_reference(*ins, tm, torch.from_numpy(dp), **KW)
    ref = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    for name, got, want in zip(OUT_NAMES, (dx,) + grads, ref):
        # f32 both ways; the explicit backward sums in another order
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


@pytest.mark.parametrize("shift", [0, 2])
def test_backward_reference_matches_jax_kernel_f32(shift):
    """f32 inputs. The JAX backward kernel rounds every product's operands to
    bf16 whatever the input type: ``operand_dtype=torch.bfloat16`` follows it
    and must land far closer to it than the unrounded f32 backward does."""
    a, dy, dp, mask = *_inputs(seed=1), _mask(shift)
    ref = _jax_grads(a, dy, dp, mask)
    _, _, (dx, grads) = _ours(a, dy, dp, mask,
                              operand_dtype=torch.bfloat16)
    _, _, (dx32, grads32) = _ours(a, dy, dp, mask)
    for name, got, got32, want in zip(OUT_NAMES, (dx,) + grads,
                                      (dx32,) + grads32, ref):
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got.numpy() - want).max()
        err32 = np.abs(got32.numpy() - want).max()
        # same rounding points: what is left is a bf16 operand that rounds
        # the other way after f32 sums in another order, 2e-3 of the scale
        assert err <= 2e-3 * scale, (name, err, scale)
        # the JAX package's own tolerance for its bf16-operand backward
        # against an f32 one
        assert err32 <= 1e-2 * scale, (name, err32, scale)


@pytest.mark.parametrize("shift", [0, 2])
def test_backward_reference_matches_jax_kernel_bf16_by_cosine(shift):
    a, dy, dp, mask = *_inputs(seed=2), _mask(shift)
    ref = _jax_grads(a, dy, dp, mask, dtype=jnp.bfloat16)
    _, _, (dx, grads) = _ours(a, dy, dp, mask, dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16
    for name, got, want in zip(OUT_NAMES, (dx,) + grads, ref):
        g = got.float().numpy().astype(np.float64).ravel()
        w = want.astype(np.float64).ravel()
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        # bf16 rounds at other places in XLA and ATen: compare by cosine
        assert 1.0 - cos <= 1e-3, (name, 1.0 - cos)


def test_dropped_sample_passes_dy_through():
    a, dy, _, mask = *_inputs(seed=3), _mask(2)
    dp = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    _, _, (dx, _) = _ours(a, dy, dp, mask)
    np.testing.assert_array_equal(dx[0].numpy(), dy[0])
    assert np.abs(dx[1].numpy() - dy[1]).max() > 1e-3


def test_wrappers_on_cpu_take_plain_path():
    """``swin_block_bwd`` on CPU f32 tensors is the plain backward with
    operands rounded to bf16 (as ``_bwd_kernel`` and the kernels round
    them), bit for bit; the forward wrapper under autograd, both backward
    modes, is the exact f32 gradient, the plain backward unrounded."""
    a, dy, dp, mask = *_inputs(seed=4), _mask(2)
    t, tm, (dx_bf, grads_bf) = _ours(a, dy, dp, mask,
                                     operand_dtype=torch.bfloat16)
    before = (swin_block.launches, swin_block_bwd.launches)
    dx2, grads2 = swin_block_bwd(*t, tm, torch.from_numpy(dp),
                                 torch.from_numpy(dy), **KW)
    np.testing.assert_array_equal(dx_bf.numpy(), dx2.numpy())
    for g, g2 in zip(grads_bf, grads2):
        np.testing.assert_array_equal(g.numpy(), g2.numpy())
    _, _, (dx, _) = _ours(a, dy, dp, mask, operand_dtype=None)
    # the forward wrapper under autograd, both backward modes
    for backward in ("kernel", "plain"):
        ins = [v.clone().requires_grad_(True) for v in t]
        y = swin_block(*ins, tm, torch.from_numpy(dp), backward=backward,
                       **KW)
        got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
        np.testing.assert_allclose(got[0].numpy(), dx.numpy(), rtol=3e-4,
                                   atol=3e-4)
    assert (swin_block.launches, swin_block_bwd.launches) == before
    with pytest.raises(ValueError):
        swin_block(*t, tm, None, backward="xla", **KW)


def test_backward_reference_matches_jax_kernel_at_a_ragged_window_count():
    """Kernel-sized windows (8x8, head_dim 32) and 75 of them, an odd count:
    the shape at which ``chip_smoke.py`` and the ``cuda`` tests run the
    persistent backward kernel's last step against this plain version."""
    b, h, c, ws, heads, shift = 3, 40, 96, 8, 3, 4
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = dict(
        x=f(b, h, h, c) * 0.5,
        wqkv=f(c, 3 * c) * 0.06, bqkv=f(3 * c) * 0.1,
        wproj=f(c, c) * 0.06, bproj=f(c) * 0.1,
        rel_bias=f(heads, ws * ws, ws * ws) * 0.3,
        ln1s=1.0 + 0.1 * f(c), ln1b=0.1 * f(c),
        ln2s=1.0 + 0.1 * f(c), ln2b=0.1 * f(c),
        w1=f(c, 4 * c) * 0.06, b1=f(4 * c) * 0.1,
        w2=f(4 * c, c) * 0.06, b2=f(c) * 0.1)
    dy = f(b, h, h, c)
    dp = np.array([[0.0, 1.0 / 0.9], [1.0 / 0.9, 1.25], [0.0, 0.0]], np.float32)
    mask = jax_mask(h, h, ws, shift)
    kw = dict(window_size=ws, num_heads=heads)
    vals = [jnp.asarray(a[k]) for k in NAMES]

    def loss(vals):
        y = fused_swin_block(*vals, jnp.asarray(mask), jnp.asarray(dp),
                             interpret=True, **kw)
        return jnp.sum(y * jnp.asarray(dy))

    ref = [np.asarray(g, np.float32) for g in jax.grad(loss)(vals)]
    dx, grads = swin_block_backward_reference(
        *(torch.from_numpy(a[k]) for k in NAMES), torch.from_numpy(mask),
        torch.from_numpy(dp), torch.from_numpy(dy),
        operand_dtype=torch.bfloat16, **kw)
    np.testing.assert_array_equal(dx[2].numpy(), dy[2])   # both branches dropped
    for name, got, want in zip(OUT_NAMES, (dx,) + grads, ref):
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got.numpy() - want).max()
        # as above: the same rounding points, f32 sums in another order
        assert err <= 2e-3 * scale, (name, err, scale)


def test_backward_reference_matches_jax_kernel_at_windows_of_256_tokens():
    """16x16 windows (256 tokens, the most the general route on the card
    takes), shifted by 8, two heads of 8, f32: the plain backward, the
    general K2's oracle, against ``jax.grad`` of the interpreted kernel,
    operands rounded to bf16 as that kernel rounds them."""
    b, h, c, ws, heads, shift = 2, 32, 16, 16, 2, 8
    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = dict(
        x=f(b, h, h, c) * 0.5,
        wqkv=f(c, 3 * c) * 0.2, bqkv=f(3 * c) * 0.1,
        wproj=f(c, c) * 0.2, bproj=f(c) * 0.1,
        rel_bias=f(heads, ws * ws, ws * ws) * 0.3,
        ln1s=1.0 + 0.1 * f(c), ln1b=0.1 * f(c),
        ln2s=1.0 + 0.1 * f(c), ln2b=0.1 * f(c),
        w1=f(c, 2 * c) * 0.2, b1=f(2 * c) * 0.1,
        w2=f(2 * c, c) * 0.2, b2=f(c) * 0.1)
    dy = f(b, h, h, c)
    dp = np.array([[1.0 / 0.9, 1.25], [1.0, 0.0]], np.float32)
    mask = jax_mask(h, h, ws, shift)
    kw = dict(window_size=ws, num_heads=heads)
    vals = [jnp.asarray(a[k]) for k in NAMES]

    def loss(vals):
        y = fused_swin_block(*vals, jnp.asarray(mask), jnp.asarray(dp),
                             interpret=True, **kw)
        return jnp.sum(y * jnp.asarray(dy))

    ref = [np.asarray(g, np.float32) for g in jax.grad(loss)(vals)]
    dx, grads = swin_block_backward_reference(
        *(torch.from_numpy(a[k]) for k in NAMES), torch.from_numpy(mask),
        torch.from_numpy(dp), torch.from_numpy(dy),
        operand_dtype=torch.bfloat16, **kw)
    for name, got, want in zip(OUT_NAMES, (dx,) + grads, ref):
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got.numpy() - want).max()
        # the same rounding points, f32 sums in another order
        assert err <= 2e-3 * scale, (name, err, scale)


def test_atb_accum_on_cpu_and_the_token_blocked_layout():
    """The split-K pass's CPU path is the plain product, accumulated into
    ``out``, from token-blocked operands; ``token_blocked`` is the
    per-window [M / 8][64][8] order in which the backward kernels write
    them. Row-major operands are refused."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((128, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 24)).astype(np.float32))
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    want = a16.float().t() @ b16.float()
    out = atb_accum(token_blocked(a16), token_blocked(b16))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    out2 = atb_accum(token_blocked(a16), token_blocked(b16), out.clone())
    np.testing.assert_allclose(out2.numpy(), 2 * want.numpy(), rtol=1e-6,
                               atol=1e-5)
    with pytest.raises(ValueError):
        atb_accum(token_blocked(a16), b16)
    with pytest.raises(ValueError):
        atb_accum(a16, b16)
    blk = token_blocked(a)
    assert blk.shape == (2, 2, 64, 8)
    for window, col, tok in ((0, 0, 0), (1, 9, 63), (0, 15, 17)):
        assert blk[window, col // 8, tok, col % 8] == a[64 * window + tok, col]
