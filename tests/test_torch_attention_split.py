"""The general K3's forward attention split over its grid
(``csrc/window_any.cu::attn_fwd_kernel`` with ``attn_plan``), on the CPU.

Where windows x heads x strips of 64 queries would leave the card's SMs
idle, the kernel gives each block fewer strips of 16 queries and splits
each strip's keys into parts, a warp each: the parts' row maxima are
combined in part order, then their sums of exp(logit - max), so that every
part rounds p = exp(logit - max) / sum to the element type with the row's
own statistics as the plain version does, and the parts' p @ v are added in
part order. ``split_form`` is that arithmetic in torch. At every split it
matches ``window_attention_reference`` and JAX's ``_kernel`` run
interpreted, and two runs at the same split give the same bits.
``attention_plan`` (the Python twin of ``attn_plan``, compared with the
library on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda_
kernels.py``) is held at its edges here. The kernel runs only on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strajnet_tpu.ops.pallas_window_attention import fused_window_attention
from strajnet_tpu_torch.ops import window_attention as wa
from strajnet_tpu_torch.ops.windows import shifted_window_mask

torch.set_num_threads(2)
# (B, H = W, C, heads, window, shift): 49 tokens (np 64), 144 (np 160) and
# 256 tokens a window
GEOMETRIES = {"ws7": (1, 14, 24, 3, 7, 3), "ws12": (1, 24, 32, 2, 12, 6),
              "ws16": (1, 16, 32, 2, 16, 8)}
F32_MAX_ABS_REL = 1e-5


def _rnd(t, dt):
    return t.to(dt).float()


def split_form(q, k, v, rel, mask, scale, dt, parts):
    """merged heads [BW, n, C] (rounded to ``dt``) from q, k, v [BW, heads,
    n, hd] (in ``dt``), the keys of each row split into ``parts`` parts of
    ``kpart`` keys (a multiple of 16 over the window padded to 16 rows), as
    the kernel computes them: the parts' maxima, then their sums, combined
    in part order; p rounded to ``dt`` with the row's statistics; the
    parts' p @ v added in part order."""
    bw, heads, n, hd = q.shape
    n_pad = -(-n // 16) * 16
    kpart = -(-(n_pad // 16) // parts) * 16
    s = (q @ k.transpose(-1, -2)) * scale + rel[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, heads, n, n) + mask[None, :, None]).reshape(
            bw, heads, n, n)
    cuts = [(p * kpart, min(n, (p + 1) * kpart)) for p in range(parts)]
    cuts = [(a, b) for a, b in cuts if a < b]
    mx = torch.full((bw, heads, n, 1), -float("inf"))
    for a, b in cuts:
        mx = torch.maximum(mx, s[..., a:b].amax(-1, keepdim=True))
    total = torch.zeros(bw, heads, n, 1)
    for a, b in cuts:
        total = total + torch.exp(s[..., a:b] - mx).sum(-1, keepdim=True)
    out = torch.zeros(bw, heads, n, hd)
    for a, b in cuts:
        p = _rnd(torch.exp(s[..., a:b] - mx) / total, dt)
        out = out + p @ v[..., a:b, :]
    return _rnd(out.transpose(1, 2).reshape(bw, n, heads * hd), dt)


def _inputs(name, seed=0):
    b, h, c, heads, ws, shift = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    args = [f(b, h, h, c, k=0.5), f(c, 3 * c, k=c ** -0.5), f(3 * c, k=0.1),
            f(c, c, k=c ** -0.5), f(c, k=0.1), f(heads, ws * ws, ws * ws,
                                                 k=0.3)]
    return args, shifted_window_mask(h, h, ws, shift), ws, heads


def _attention(args, mask, ws, heads, dt, parts):
    """The whole K3 with its attention stage computed by ``split_form``."""
    x, wqkv, bqkv, wproj, bproj, rel = (torch.from_numpy(a) for a in args)
    x, wqkv, bqkv, wproj, bproj = (t.to(dt) for t in (x, wqkv, bqkv, wproj,
                                                      bproj))
    b, h, w, c = x.shape
    xw = wa._windows(x, ws)
    q, k, v, _ = wa._attention_forward(xw, wqkv, bqkv, rel, None, heads, dt)
    merged = split_form(q, k, v, rel.float(), torch.from_numpy(mask),
                        (c // heads) ** -0.5, dt, parts)
    y = merged @ _rnd(wproj, dt) + bproj.float()
    return wa.window_reverse(y, ws, h, w, c).to(dt)


def _reference(args, mask, ws, heads, dt):
    x, wqkv, bqkv, wproj, bproj, rel = (torch.from_numpy(a) for a in args)
    return wa.window_attention_reference(
        *(t.to(dt) for t in (x, wqkv, bqkv, wproj, bproj)), rel,
        torch.from_numpy(mask), window_size=ws, num_heads=heads)


def _max_rel(a, b):
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_split_form_matches_the_plain_attention_in_f32(name, parts):
    args, mask, ws, heads = _inputs(name)
    got = _attention(args, mask, ws, heads, torch.float32, parts)
    again = _attention(args, mask, ws, heads, torch.float32, parts)
    assert torch.equal(got, again)
    assert _max_rel(got, _reference(args, mask, ws, heads,
                                    torch.float32)) <= F32_MAX_ABS_REL


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_split_form_matches_the_plain_attention_in_bf16(name, parts):
    """The same rounding points as the plain version (p rounded with the
    row's own statistics): within the general K3's bf16 limits (2^-5 of
    the largest entry, 1 - cos 1e-4)."""
    args, mask, ws, heads = _inputs(name, seed=1)
    got = _attention(args, mask, ws, heads, torch.bfloat16, parts)
    want = _reference(args, mask, ws, heads, torch.bfloat16)
    assert _max_rel(got, want) <= 2.0 ** -5
    g, w = got.double().flatten(), want.double().flatten()
    assert 1.0 - float(g @ w / (g.norm() * w.norm())) <= 1e-4


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_split_form_matches_the_interpreted_jax_kernel(name):
    args, mask, ws, heads = _inputs(name, seed=2)
    want = np.asarray(fused_window_attention(
        *(jnp.asarray(a) for a in args), jnp.asarray(mask), window_size=ws,
        num_heads=heads, interpret=True))
    for parts in (1, 2, 4):
        got = _attention(args, mask, ws, heads, torch.float32, parts)
        # f32 both sides; JAX's dense-strip softmax sums in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_the_plan_splits_only_a_grid_under_two_waves():
    """(strips a block, parts of the keys): four strips and one part while
    windows x heads x blocks a window and head reach ``ATTN_BLOCKS``;
    below, strips halved and the keys split as many more ways."""
    blocks = wa.ATTN_BLOCKS
    # 64 tokens, four strips a block: one block a window and head
    assert wa.attention_plan(64, 4, blocks // 4) == (4, 1)
    assert wa.attention_plan(64, 1, blocks) == (4, 1)
    assert wa.attention_plan(64, 1, blocks - 1) == (2, 2)
    # two blocks of two strips a window and head still short: one strip
    assert wa.attention_plan(64, 1, blocks // 2 - 1) == (1, 4)
    assert wa.attention_plan(256, 2, 4) == (1, 4)
    # a part keeps 16 keys: 48 tokens split three ways at most, 16 not at all
    assert wa.attention_plan(48, 1, 1) == (1, 3)
    assert wa.attention_plan(32, 1, 1) == (1, 2)
    assert wa.attention_plan(16, 1, 1) == (4, 1)
    assert wa.attention_plan(1, 1, 1) == (4, 1)


@pytest.mark.parametrize("n", [1, 16, 17, 49, 64, 121, 144, 225, 256])
def test_the_plan_is_a_pure_function_of_the_widths(n):
    """The same widths give the same plan; a block runs at most four warps;
    the parts never outnumber the key tiles; more windows never split a
    strip further."""
    tiles = -(-n // 16)
    last = None
    for windows in (1, 2, 3, 8, 33, 64, 65, 132, 263, 264, 1000):
        qt, kp = wa.attention_plan(n, 3, windows)
        assert (qt, kp) == wa.attention_plan(n, 3, windows)
        assert 1 <= qt * kp <= 4 and kp <= max(tiles, 1)
        assert kp == 1 or qt * kp == 4 or kp == tiles
        if last is not None:
            assert kp <= last
        last = kp
