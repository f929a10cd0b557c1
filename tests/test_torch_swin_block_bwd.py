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
from strajnet_tpu_torch.ops.swin_block import (GRAD_NAMES, swin_block,
                                               swin_block_backward_reference,
                                               swin_block_bwd,
                                               swin_block_reference)

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
    a, dy, dp, mask = *_inputs(seed=4), _mask(2)
    t, tm, (dx, grads) = _ours(a, dy, dp, mask)
    before = (swin_block.launches, swin_block_bwd.launches)
    dx2, grads2 = swin_block_bwd(*t, tm, torch.from_numpy(dp),
                                 torch.from_numpy(dy), **KW)
    np.testing.assert_array_equal(dx.numpy(), dx2.numpy())
    for g, g2 in zip(grads, grads2):
        np.testing.assert_array_equal(g.numpy(), g2.numpy())
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
