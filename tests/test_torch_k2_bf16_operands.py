"""The general K2 and K4 wrappers in f32 follow the JAX kernels' rounding,
on the CPU.

``pallas_swin_block.py::_bwd_kernel`` and ``pallas_window_attention.py::
_bwd_kernel`` round every backward product's operands to bf16 whatever the
input type. ``swin_block_bwd`` and ``window_attention_bwd`` on CPU f32
tensors (the plain backwards with ``operand_dtype=bfloat16``, the oracles
of the general K2 and K4 on the card) are held against JAX's kernels, run
interpreted, within 2e-3 of each result's largest entry, at 4x4 windows
shifted by 2 and 7x7 windows shifted by 3.

The general K2 runs those products in f32 as bf16 products on f32 operands
rounded as they are read (``csrc/window_any.cu``, the ``RB`` products):
each 16-deep stage summed from zero and added to the f32 total to nearest,
the weight gradients split over the tokens and the splits added in order.
``rb_product`` and ``rb_atb`` model that arithmetic in numpy; at the shapes
of each of K2's backward products they land within 1e-6 of the largest
entry of the bf16-operand product the plain backward takes (its f64 sum),
ragged depths and token counts included. The kernels themselves run only
on a card (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.ops.pallas_swin_block import fused_swin_block
from strajnet_tpu.ops.pallas_window_attention import fused_window_attention
from strajnet_tpu_torch.ops import swin_block as sb
from strajnet_tpu_torch.ops import window_attention as wa
from strajnet_tpu_torch.ops.windows import shifted_window_mask

torch.set_num_threads(2)
BLOCK_NAMES = ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias", "ln1s",
               "ln1b", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
# (B, H = W, C, heads, window, shift)
WINDOWS = {"ws4_shift2": (2, 16, 16, 2, 4, 2), "ws7_shift3": (1, 14, 24, 3, 7, 3)}
JAX_MAX_ABS_REL = 2e-3
STAGE_K = 16          # depth of one bf16 m16n8k16 stage of the RB products
MODEL_MAX_ABS_REL = 1e-6


def _block_inputs(b, h, c, heads, ws, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hidden = 2 * c
    a = dict(x=f(b, h, h, c) * 0.5, wqkv=f(c, 3 * c) * c ** -0.5,
             bqkv=f(3 * c) * 0.1, wproj=f(c, c) * c ** -0.5, bproj=f(c) * 0.1,
             rel_bias=f(heads, ws * ws, ws * ws) * 0.3,
             ln1s=1 + 0.1 * f(c), ln1b=0.1 * f(c), ln2s=1 + 0.1 * f(c),
             ln2b=0.1 * f(c), w1=f(c, hidden) * c ** -0.5,
             b1=f(hidden) * 0.1, w2=f(hidden, c) * hidden ** -0.5,
             b2=f(c) * 0.1)
    dp = np.array([[1.0 / 0.9, 1.25]] * b, np.float32)
    return a, f(b, h, h, c), dp


def _worst(got, want):
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-6)
               for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(WINDOWS))
def test_swin_block_bwd_on_cpu_f32_matches_the_jax_kernel(name):
    b, h, c, heads, ws, shift = WINDOWS[name]
    a, dy, dp = _block_inputs(b, h, c, heads, ws, seed=ws)
    mask = shifted_window_mask(h, h, ws, shift)
    kw = dict(window_size=ws, num_heads=heads)

    def loss(vals):
        y = fused_swin_block(*vals, jnp.asarray(mask), jnp.asarray(dp),
                             interpret=True, **kw)
        return jnp.sum(y * jnp.asarray(dy))

    want = [np.asarray(g, np.float32) for g in jax.grad(loss)(
        [jnp.asarray(a[k]) for k in BLOCK_NAMES])]
    dx, grads = sb.swin_block_bwd(
        *(torch.from_numpy(a[k]) for k in BLOCK_NAMES),
        torch.from_numpy(mask), torch.from_numpy(dp), torch.from_numpy(dy),
        **kw)
    assert dx.dtype == torch.float32
    got = [t.numpy() for t in (dx,) + grads]
    assert _worst(got, want) <= JAX_MAX_ABS_REL
    # unrounded, the plain backward is the exact f32 gradient, further off
    exact = sb.swin_block_backward_reference(
        *(torch.from_numpy(a[k]) for k in BLOCK_NAMES),
        torch.from_numpy(mask), torch.from_numpy(dp), torch.from_numpy(dy),
        operand_dtype=None, **kw)
    assert _worst([t.numpy() for t in (exact[0],) + exact[1]], want) > \
        _worst(got, want)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_attention_bwd_on_cpu_f32_matches_the_jax_kernel(name):
    b, h, c, heads, ws, shift = WINDOWS[name]
    a, dy, _ = _block_inputs(b, h, c, heads, ws, seed=ws + 1)
    mask = shifted_window_mask(h, h, ws, shift)
    kw = dict(window_size=ws, num_heads=heads)
    names = ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias")

    def f(*vals):
        return fused_window_attention(*vals, jnp.asarray(mask),
                                      interpret=True, **kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in names))
    x, wqkv, bqkv, wproj, _, rel = (torch.from_numpy(a[k]) for k in names)
    dx, grads = wa.window_attention_bwd(x, wqkv, bqkv, wproj, rel,
                                        torch.from_numpy(mask),
                                        torch.from_numpy(dy), **kw)
    # JAX's order: x, wqkv, bqkv, wproj, bproj, rel_bias
    got = [dx.numpy(), grads[0].numpy(), grads[1].numpy(), grads[2].numpy(),
           grads[3].numpy(), grads[4].numpy()]
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy))]
    assert _worst(got, want) <= JAX_MAX_ABS_REL


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def rb_product(a, b):
    """a [M, K] @ b [K, N] as the RB products compute it: both rounded to
    bf16, each 16-deep stage summed from zero (exact products, an f32 sum),
    the stages added to the f32 total in order, to nearest."""
    a, b = _bf16(a), _bf16(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], STAGE_K):
        stage = (a[:, k0:k0 + STAGE_K].astype(np.float64)
                 @ b[k0:k0 + STAGE_K].astype(np.float64)).astype(np.float32)
        total = (total + stage).astype(np.float32)
    return total


def rb_atb(a, b, splits):
    """sum over the tokens of a^T b (a [R, Ka], b [R, N]) as atb_kernel and
    reduce_kernel compute it: ``splits`` runs of tokens, each an RB product,
    their partials added in order."""
    rows = a.shape[0]
    chunk = -(-rows // splits)
    total = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for r0 in range(0, rows, chunk):
        total = (total + rb_product(a[r0:r0 + chunk].T, b[r0:r0 + chunk])
                 ).astype(np.float32)
    return total


# K2's backward products at a block of C 40 and MLP 88 over 300 tokens:
# (what, M, K, N) of the row products, (what, tokens, Ka, N) of the weight
# gradients
ROW_PRODUCTS = (("dg1 = rd(dp2 dy) @ rd(w2)^T", 300, 40, 88),
                ("dh2 = rd(dz1) @ rd(w1)^T", 300, 88, 40),
                ("dmerged = rd(datt) @ rd(wproj)^T", 300, 40, 40),
                ("dh1 = dqkv @ rd(wqkv)^T", 300, 120, 40))
WEIGHT_GRADIENTS = (("dw2 = rd(g1)^T rd(dz2)", 300, 88, 40),
                    ("dw1 = rd(h2)^T rd(dz1)", 300, 40, 88),
                    ("dwproj = rd(merged)^T rd(datt)", 300, 40, 40),
                    ("dwqkv = rd(h1)^T dqkv", 300, 40, 120))


@pytest.mark.parametrize("what,m,k,n", ROW_PRODUCTS)
def test_rb_row_products_match_the_bf16_operand_product(what, m, k, n):
    rng = np.random.default_rng(k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    want = _bf16(a).astype(np.float64) @ _bf16(b).astype(np.float64)
    got = rb_product(a, b)
    assert np.abs(got - want).max() <= MODEL_MAX_ABS_REL * np.abs(want).max()
    # the operands' rounding is what sets the answer: the f32 product of
    # the unrounded operands is far further off
    f32 = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(f32 - want).max() > 100 * np.abs(got - want).max()


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("what,rows,ka,n", WEIGHT_GRADIENTS)
def test_rb_weight_gradients_match_the_bf16_operand_product(what, rows, ka, n,
                                                            splits):
    rng = np.random.default_rng(ka * n + splits)
    a = rng.standard_normal((rows, ka)).astype(np.float32)
    b = rng.standard_normal((rows, n)).astype(np.float32)
    want = _bf16(a).T.astype(np.float64) @ _bf16(b).astype(np.float64)
    got = rb_atb(a, b, splits)
    assert np.abs(got - want).max() <= MODEL_MAX_ABS_REL * np.abs(want).max()


def test_plain_backward_in_f32_takes_every_product_on_bf16_operands():
    """``swin_block_backward_reference(operand_dtype=bf16)`` in f32 with its
    products replaced by the RB model (through ``torch.Tensor.__matmul__``
    on the reference's bf16-rounded operands, so every product it takes):
    dx and the 13 gradients within 1e-5 of each one's largest entry. The
    products it rounds are exactly those the kernel rounds."""
    b, h, c, heads, ws, shift = WINDOWS["ws7_shift3"]
    a, dy, dp = _block_inputs(b, h, c, heads, ws, seed=5)
    mask = torch.from_numpy(shifted_window_mask(h, h, ws, shift))
    args = [torch.from_numpy(a[k]) for k in BLOCK_NAMES]
    kw = dict(window_size=ws, num_heads=heads)
    want = sb.swin_block_backward_reference(
        *args, mask, torch.from_numpy(dp), torch.from_numpy(dy),
        operand_dtype=torch.bfloat16, **kw)
    # the plain backward's products, each taken on its bf16-rounded
    # operands: rounding them again changes nothing, so a product whose
    # operands are not bf16 values shows as an error of the model
    rounded = []
    matmul = torch.Tensor.__matmul__

    def staged(x, y):
        if x.dim() in (2, 3) and y.dim() == 2 and x.dtype == torch.float32:
            exact = (torch.equal(x, x.to(torch.bfloat16).float())
                     and torch.equal(y, y.to(torch.bfloat16).float()))
            rounded.append(exact)
            if exact:
                x2 = x.reshape(-1, x.shape[-1]).numpy()
                out = torch.from_numpy(rb_product(x2, y.numpy()))
                return out.reshape(*x.shape[:-1], y.shape[-1])
        return matmul(x, y)

    from unittest import mock
    with mock.patch.object(torch.Tensor, "__matmul__", staged):
        got = sb.swin_block_backward_reference(
            *args, mask, torch.from_numpy(dp), torch.from_numpy(dy),
            operand_dtype=torch.bfloat16, **kw)
    # the products over the tokens: the recomputed forward's three (qkv,
    # proj, fc1: f32 operands) and the backward's eight (four row products,
    # four weight gradients), all eight of these on bf16 operands
    assert len(rounded) == 11 and sum(rounded) == 8
    for x, y in zip((got[0],) + got[1], (want[0],) + want[1]):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
