"""The port's CUDA kernels against their plain versions, on a card.

Needs an NVIDIA GPU and nvcc, so these skip on a machine without one; run
them there with ``CUDA_VISIBLE_DEVICES=0 python -m pytest
tests/test_torch_cuda_kernels.py -m cuda`` (``tests/conftest.py`` hides the
card from the JAX tests unless the variable is set).
``chip_smoke.py`` makes the same comparisons at the flagship shapes.
"""

import ctypes

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.ops import decoder_tail as dtl
from strajnet_tpu_torch.ops import swin_block as sb
from strajnet_tpu_torch.ops import warp_gather as wg
from strajnet_tpu_torch.ops import window_attention as wa
from strajnet_tpu_torch.ops.windows import shifted_window_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_warp_gather_kernels_match_plain(card):
    rng = np.random.default_rng(0)
    s, h, w = 4, 32, 32
    img = torch.from_numpy(rng.random((s, h + 2, w + 2)).astype(np.float32))
    x0f = torch.from_numpy(rng.integers(0, w + 1, (s, 256)).astype(np.float32))
    y0f = torch.from_numpy(rng.integers(0, h + 1, (s, 256)).astype(np.float32))
    gs = [torch.from_numpy(rng.standard_normal((s, 256)).astype(np.float32))
          for _ in range(4)]
    got = wg.warp_gather_fwd(img.to(card), x0f.to(card), y0f.to(card))
    for a, b in zip(got, wg.gather_corners_reference(img, x0f, y0f)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    dimg = wg.warp_gather_bwd(img.shape, x0f.to(card), y0f.to(card),
                              [g.to(card) for g in gs])
    ref = wg.scatter_corners_reference(img.shape, x0f, y0f, gs)
    # f32 atomics sum in an order that varies
    np.testing.assert_allclose(dimg.cpu().numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_kernels_match_plain(card, shift):
    g = torch.Generator().manual_seed(0)
    b, h, c, heads = 2, 16, 96, 3
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    bf = torch.bfloat16
    args = [r(b, h, h, c).to(bf), r(c, 3 * c, k=c ** -0.5).to(bf),
            r(3 * c, k=0.1).to(bf), r(c, c, k=c ** -0.5).to(bf),
            r(c, k=0.1).to(bf), r(heads, 64, 64, k=0.3), 1 + r(c, k=0.1),
            r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
            r(c, 4 * c, k=c ** -0.5).to(bf), r(4 * c, k=0.1),
            r(4 * c, c, k=(4 * c) ** -0.5).to(bf), r(c, k=0.1)]
    args = [a.to(card) for a in args]
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(card)
            if shift else None)
    dp = torch.tensor([[0.0, 1.1], [1.2, 1.0]], device=card)
    dy = r(b, h, h, c).to(bf).to(card)
    kw = dict(window_size=8, num_heads=heads)
    ins = [a.clone().requires_grad_(True) for a in args]
    y = sb.swin_block(*ins, mask, dp, **kw)
    grads = torch.autograd.grad(y, ins, dy)
    ref = sb.swin_block_reference(*args, mask, dp, **kw)
    rdx, rgrads = sb.swin_block_backward_reference(*args, mask, dp, dy, **kw)
    # bf16 with f32 accumulation on both sides, rounding at other points:
    # 2^-5 of the largest entry for the forward, 2^-6 for the gradients
    assert float((y.detach().float() - ref.float()).abs().max()) <= \
        2.0 ** -5 * float(ref.float().abs().max())
    for got, want in zip(grads, (rdx,) + rgrads):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -6 * scale


def _block_case(card, b, h, c, heads, shift, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    bf = torch.bfloat16
    args = [r(b, h, h, c).to(bf), r(c, 3 * c, k=c ** -0.5).to(bf),
            r(3 * c, k=0.1).to(bf), r(c, c, k=c ** -0.5).to(bf),
            r(c, k=0.1).to(bf), r(heads, 64, 64, k=0.3), 1 + r(c, k=0.1),
            r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
            r(c, 4 * c, k=c ** -0.5).to(bf), r(4 * c, k=0.1),
            r(4 * c, c, k=(4 * c) ** -0.5).to(bf), r(c, k=0.1)]
    args = [a.to(card) for a in args]
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(card)
            if shift else None)
    dp = (torch.rand(b, 2, generator=g) * 1.2).to(card)
    dy = r(b, h, h, c).to(bf).to(card)
    return args, mask, dp, dy


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_swin_block_kernels_at_a_ragged_window_count_and_twice(card, c, heads):
    """[3, 40, 40, C] is 75 windows: odd, so the persistent kernels' last
    step has one window for two warpgroups, and with shift 4 every window
    takes its own mask. Both kernels are run twice on the same inputs: the
    forward and dx come out bit-identical (the weight ring's barriers leave
    no race); the parameter gradients sum f32 atomics in varying order."""
    args, mask, dp, dy = _block_case(card, 3, 40, c, heads, 4, seed=1)
    dp[2, :] = 0.0   # both branches dropped: dx == dy there
    kw = dict(window_size=8, num_heads=heads)
    with torch.no_grad():
        y = sb.swin_block(*args, mask, dp, **kw)
        y2 = sb.swin_block(*args, mask, dp, **kw)
        dx, grads = sb.swin_block_bwd(*args, mask, dp, dy, **kw)
        dx2, grads2 = sb.swin_block_bwd(*args, mask, dp, dy, **kw)
        ref = sb.swin_block_reference(*args, mask, dp, **kw)
        rdx, rgrads = sb.swin_block_backward_reference(*args, mask, dp, dy,
                                                       **kw)
    assert torch.equal(y, y2)
    assert torch.equal(dx, dx2)
    assert torch.equal(dx[2], dy[2])
    assert float((y.float() - ref.float()).abs().max()) <= \
        2.0 ** -5 * float(ref.float().abs().max())
    for name, got, again, want in zip(("dx",) + sb.GRAD_NAMES, (dx,) + grads,
                                      (dx2,) + grads2, (rdx,) + rgrads):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * scale, (name, err, scale)
        assert float((got.float() - again.float()).abs().max()) <= \
            1e-4 * scale, name


def test_wgmma_operand_layouts_one_product_each(card):
    """The hand-written shared-memory layouts of ``csrc/swin_block_sm90.cuh``
    against ``torch.matmul``, one 64-row product each: A and B as 8x8 core
    matrices without swizzle (K-major), the accumulator handed on as the next
    product's A fragments, B written by the transposed store, and both
    operands MN-major from the token-blocked layout. bf16 inputs, f32 sums:
    only the order of the sums differs."""
    from strajnet_tpu_torch._build import load_library
    lib = load_library("sm90_selftest")
    lib.sm90_layout_selftest.argtypes = [ctypes.c_void_p] * 6
    lib.sm90_blocked_selftest.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int, ctypes.c_void_p])
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=g).to(torch.bfloat16).to(card)
    w = torch.randn(64, 96, generator=g).to(torch.bfloat16).to(card)
    outs = [torch.zeros(64, n, device=card) for n in (96, 96, 64, 64)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    assert lib.sm90_layout_selftest(p(a), p(w), *(p(o) for o in outs[:3]),
                                    stream) == 0
    assert lib.sm90_blocked_selftest(p(a), p(a), p(outs[3]), 0, stream) == 0
    torch.cuda.synchronize()
    af, wf = a.float(), w.float()
    for got, want in zip(outs, (af @ wf, af @ wf, af @ af, af.t() @ af)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_decoder_tail_operand_layouts_one_product_each(card):
    """The two shifted A operands of ``csrc/decoder_tail.cu`` against
    ``torch.matmul``, at 16 channels per tap: the input tile, channel-blocked
    with nine pixels to a row, read by a 64-row wgmma whose 8-row groups are
    pixel rows and whose taps are offsets of the start address; and the
    intermediate read by ``wgmma.m64n8k16`` at an offset of ``8 u + v``
    entries. For both warpgroups of a block (rows 0-7 and 8-15)."""
    from strajnet_tpu_torch._build import load_library
    lib = load_library("sm90_selftest")
    lib.sm90_tail_selftest.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int, ctypes.c_void_p])
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(17, 9, 16, generator=g).to(bf).to(card)
    w = torch.randn(64, 96, generator=g).to(bf).to(card)
    e = torch.randn(144, 16, generator=g).to(bf).to(card)
    ky = torch.randn(64, 8, generator=g).to(bf).to(card)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    for wg in (0, 1):
        out_main = torch.zeros(64, 96, device=card)
        out_conv = torch.zeros(64, 8, device=card)
        assert lib.sm90_tail_selftest(p(x), p(w), p(e), p(ky), p(out_main),
                                      p(out_conv), wg, stream) == 0
        torch.cuda.synchronize()
        want_main = torch.zeros(64, 96, device=card)
        want_conv = torch.zeros(64, 8, device=card)
        for tap, (u, v) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            rows = x[8 * wg + u:8 * wg + u + 8, v:v + 8].reshape(64, 16)
            want_main += rows.float() @ w[16 * tap:16 * tap + 16].float()
            shift = 64 * wg + 8 * u + v
            want_conv += (e[shift:shift + 64].float()
                          @ ky[16 * tap:16 * tap + 16].float())
        torch.testing.assert_close(out_main, want_main, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(out_conv, want_conv, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,n,tokens", [(96, 288, 4800), (384, 96, 8192),
                                        (40, 1536, 640)])
def test_split_k_pass_matches_matmul(card, m, n, tokens):
    """dW += A^T B over all tokens from the token-blocked operands the
    backward window kernels write; M and N that do not fill the 128 x 128
    tiles, a token count that does not divide into equal slices. f32 sums of
    bf16 products in another order, with atomics."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(tokens, m, generator=g).to(torch.bfloat16).to(card)
    b = torch.randn(tokens, n, generator=g).to(torch.bfloat16).to(card)
    base = torch.randn(m, n, generator=g).to(card)
    got = sb.atb_accum(sb.token_blocked(a), sb.token_blocked(b), base.clone())
    want = base + a.float().t() @ b.float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("c,heads,shift", [(96, 3, 0), (96, 3, 4),
                                           (384, 12, 4)])
def test_window_attention_kernels_match_plain(card, c, heads, shift):
    g = torch.Generator().manual_seed(0)
    b, h = 2, 16
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    bf = torch.bfloat16
    args = [r(b, h, h, c).to(bf), r(c, 3 * c, k=c ** -0.5).to(bf),
            r(3 * c, k=0.1).to(bf), r(c, c, k=c ** -0.5).to(bf),
            r(c, k=0.1).to(bf), r(heads, 64, 64, k=0.3)]
    args = [a.to(card) for a in args]
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(card)
            if shift else None)
    dy = r(b, h, h, c).to(bf).to(card)
    kw = dict(window_size=8, num_heads=heads)
    before = wa.window_attention.launches, wa.window_attention_bwd.launches
    ins = [a.clone().requires_grad_(True) for a in args]
    y = wa.window_attention(*ins, mask, **kw)
    grads = torch.autograd.grad(y, ins, dy)
    assert (wa.window_attention.launches,
            wa.window_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = wa.window_attention_reference(*args, mask, **kw)
    x, wqkv, bqkv, wproj, _, rel_bias = args
    rdx, rgrads = wa.window_attention_backward_reference(
        x, wqkv, bqkv, wproj, rel_bias, mask, dy, **kw)
    # the same rounding points on both sides, f32 sums in another order:
    # 2^-5 of the largest entry forward, 2^-6 for each gradient
    assert float((y.detach().float() - ref.float()).abs().max()) <= \
        2.0 ** -5 * float(ref.float().abs().max())
    for name, got, want in zip(("dx",) + wa.GRAD_NAMES, grads,
                               (rdx,) + rgrads):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * scale, (name, err, scale)
    # the "plain" backward switch gives the same gradients by autograd
    ins2 = [a.clone().requires_grad_(True) for a in args]
    y2 = wa.window_attention(*ins2, mask, backward="plain", **kw)
    grads2 = torch.autograd.grad(y2, ins2, dy)
    for got, want in zip(grads, grads2):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -5 * scale


def _tail_case(card, n, h, w, cin=96, cmid=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k  # noqa: E731
    return (r(n, h, w, cin).to(torch.bfloat16).to(card),
            r(3, 3, cin, cmid, k=(9 * cin) ** -0.5).to(card),
            r(cmid, k=0.1).to(card),
            r(3, 3, cmid, 2, k=(9 * cmid) ** -0.5).to(card),
            r(2, k=0.1).to(card))


@pytest.mark.parametrize("h,w", [(14, 6), (15, 7), (16, 8), (44, 20),
                                 (45, 21), (46, 22)])
def test_decoder_tail_kernel_at_tile_edges_and_twice(card, h, w):
    """A tile owns 15 x 7 input pixels: images one under, at and one over one
    and three tiles a side, so the last tile's rows and columns are cut at
    every place, and three samples for a persistent grid that wraps. Twice
    on the same inputs the output is bit-identical: nothing in the kernel
    sums in an order that varies, and its barriers leave no race."""
    args = _tail_case(card, 3, h, w, seed=h)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = dtl.decoder_tail(*args)
        again = dtl.decoder_tail(*args)
        rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        ref32 = dtl.decoder_tail_reference(args[0].float(), args[1], args[2],
                                           rnd(args[3]), rnd(args[4]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert torch.equal(got, again)
    scale = float(ref32.abs().max())
    assert float((got.float() - ref32).abs().max()) <= 2.0 ** -6 * scale


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_window_attention_bwd_at_a_ragged_window_count_and_twice(card, c,
                                                                 heads):
    """[3, 40, 40, C] is 75 windows: odd, so the persistent backward's last
    step has one window for two warpgroups, and with shift 4 every window
    takes its own mask. Twice on the same inputs dx comes out bit-identical
    (the weight ring's barriers leave no race); the parameter gradients sum
    f32 atomics in varying order."""
    args, mask, _, dy = _block_case(card, 3, 40, c, heads, 4, seed=2)
    x, wqkv, bqkv, wproj, _, rel_bias = args[:6]
    bwd_args = (x, wqkv, bqkv, wproj, rel_bias, mask, dy)
    kw = dict(window_size=8, num_heads=heads)
    with torch.no_grad():
        dx, grads = wa.window_attention_bwd(*bwd_args, **kw)
        dx2, grads2 = wa.window_attention_bwd(*bwd_args, **kw)
        rdx, rgrads = wa.window_attention_backward_reference(*bwd_args, **kw)
    assert torch.equal(dx, dx2)
    for name, got, again, want in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads,
                                      (dx2,) + grads2, (rdx,) + rgrads):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * scale, (name, err, scale)
        assert float((got.float() - again.float()).abs().max()) <= \
            1e-6 * scale, name


def test_window_attention_refuses_widths_its_backward_does_not_cover(card):
    """C = 64 with head_dim 32 is no width of the wgmma window kernels: the
    forward raises as the backward does, with or without gradients, before
    any launch; only the CPU takes it (the plain version)."""
    args, mask, _, dy = _block_case(card, 1, 16, 64, 2, 4)
    args = args[:6]
    kw = dict(window_size=8, num_heads=2)
    before = wa.window_attention.launches, wa.window_attention_bwd.launches
    with torch.no_grad(), pytest.raises(ValueError, match="built for C in"):
        wa.window_attention(*args, mask, **kw)
    ins = [a.clone().requires_grad_(True) for a in args]
    for backward in ("kernel", "plain"):
        with pytest.raises(ValueError, match="built for C in"):
            wa.window_attention(*ins, mask, backward=backward, **kw)
    with pytest.raises(ValueError, match="built for C in"):
        wa.window_attention_bwd(args[0], args[1], args[2], args[3], args[5],
                                mask, dy, **kw)
    assert (wa.window_attention.launches,
            wa.window_attention_bwd.launches) == before
    cpu = [a.cpu() for a in args]
    y = wa.window_attention(*cpu, None if mask is None else mask.cpu(), **kw)
    assert y.shape == args[0].shape
    assert wa.window_attention.launches == before[0]


@pytest.mark.parametrize("h,c,heads,shift", [
    (128, 96, 3, 0), (128, 96, 3, 4), (64, 192, 6, 4), (32, 384, 12, 4)])
def test_window_attention_forward_at_the_flagship_geometries(card, h, c,
                                                            heads, shift):
    """The forward kernel at the four Swin-block geometries of the flagship
    model, batch 16, against the plain version: the same rounding points,
    f32 sums in another order."""
    args, mask, _, _ = _block_case(card, 16, h, c, heads, shift, seed=h + c)
    args = args[:6]
    kw = dict(window_size=8, num_heads=heads)
    before = wa.window_attention.launches
    with torch.no_grad():
        y = wa.window_attention(*args, mask, **kw)
        ref = wa.window_attention_reference(*args, mask, **kw)
    assert wa.window_attention.launches == before + 1
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= 2.0 ** -5 * scale
    a, b = y.double().flatten(), ref.double().flatten()
    assert 1.0 - float(a @ b / (a.norm() * b.norm())) <= 1e-4


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_window_attention_forward_at_a_ragged_window_count_and_twice(
        card, c, heads):
    """[3, 40, 40, C] is 75 windows: odd, so the persistent forward's last
    step has one window for two warpgroups, and with shift 4 every window
    takes its own mask. Twice on the same inputs the output is bit-identical:
    the forward sums nothing with atomics."""
    args, mask, _, _ = _block_case(card, 3, 40, c, heads, 4, seed=3)
    args = args[:6]
    kw = dict(window_size=8, num_heads=heads)
    with torch.no_grad():
        y = wa.window_attention(*args, mask, **kw)
        again = wa.window_attention(*args, mask, **kw)
        ref = wa.window_attention_reference(*args, mask, **kw)
    assert torch.equal(y, again)
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= 2.0 ** -5 * scale


def _scatter_case(s, size, seed, smooth):
    """Floor indices on a ``[size + 2]^2`` padded image: a smooth flow (the
    four queries around a pixel share it as a corner), or queries on the
    first and last rows and where the kernel's bands meet."""
    hp = wp = size + 2
    rng = np.random.default_rng(seed)
    n = size * size
    if smooth:
        ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        x0f = np.floor(xs + 1.3).reshape(1, n).repeat(s, 0)
        y0f = np.floor(ys + 1.6).reshape(1, n).repeat(s, 0)
    else:
        edge = wg.band_edge_rows(hp, wg.bwd_band_rows(hp, wp))
        y0f = np.resize(np.array(edge), (s, n))
        x0f = rng.integers(0, wp - 1, (s, n))
    gs = [torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
          for _ in range(4)]
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (s, hp, wp), t(x0f), t(y0f), gs


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("s,size", [(4, 32), (3, 256)])
def test_warp_gather_bwd_on_shared_corners_and_band_rows(card, s, size,
                                                        smooth):
    """The banded backward on a smooth flow and on queries at the rows where
    its bands meet, against the plain scatter: f32 sums in another order.
    Every entry of the image cotangent is written (no zeroing needed)."""
    shape, x0f, y0f, gs = _scatter_case(s, size, size, smooth)
    ref = wg.scatter_corners_reference(shape, x0f, y0f, gs)
    before = wg.warp_gather_bwd.launches
    got = wg.warp_gather_bwd(shape, x0f.to(card), y0f.to(card),
                             [g.to(card) for g in gs])
    assert wg.warp_gather_bwd.launches == before + 1
    scale = float(ref.abs().max())
    assert float((got.cpu() - ref).abs().max()) <= 1e-5 * scale
    for bands in (3, 5):
        again = wg.warp_gather_bwd(shape, x0f.to(card), y0f.to(card),
                                   [g.to(card) for g in gs], bands=bands)
        assert float((again.cpu() - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,h,w,cin,cmid", [(2, 16, 16, 96, 48),
                                            (1, 9, 20, 96, 48),
                                            (3, 20, 33, 96, 48)])
def test_decoder_tail_kernel_matches_plain(card, n, h, w, cin, cmid):
    x, w_up, b_up, w_out, b_out = _tail_case(card, n, h, w, cin, cmid)
    assert dtl.supports(h, w, cin, cmid, 2)
    before = dtl.decoder_tail.launches
    got = dtl.decoder_tail(x, w_up, b_up, w_out, b_out)
    assert dtl.decoder_tail.launches == before + 1
    assert got.shape == (n, 2 * h, 2 * w, 2) and got.dtype == torch.bfloat16
    # against the f32 composition of the same bf16-rounded inputs (cuDNN
    # TF32 off): the kernel rounds the intermediate and the output to bf16
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        ref32 = dtl.decoder_tail_reference(x.float(), w_up, b_up, rnd(w_out),
                                           rnd(b_out))
        ref16 = dtl.decoder_tail_reference(x, w_up, b_up, w_out, b_out)
        phase = dtl.decoder_tail_phase(x.float(), w_up, b_up, w_out, b_out)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = float(ref32.abs().max())
    assert float((got.float() - ref32).abs().max()) <= 2.0 ** -6 * scale
    assert float((got.float() - ref16.float()).abs().max()) <= 2.0 ** -6 * scale
    assert float((phase - ref32).abs().max()) <= 2.0 ** -6 * scale
    # the backward is autograd of the naive composition
    xg = x.clone().requires_grad_(True)
    wg_ = w_up.clone().requires_grad_(True)
    dtl.decoder_tail(xg, wg_, b_up, w_out, b_out).float().sum().backward()
    xr = x.clone().requires_grad_(True)
    wr = w_up.clone().requires_grad_(True)
    dtl.decoder_tail_reference(xr, wr, b_up, w_out, b_out).float().sum(
        ).backward()
    torch.testing.assert_close(xg.grad, xr.grad)
    torch.testing.assert_close(wg_.grad, wr.grad)


@pytest.mark.parametrize("dtype,cin,match", [
    (torch.float32, 96, "bfloat16"),        # the kernel is bf16 only
    (torch.bfloat16, 24, "does not cover"),    # the kernel is built for
    (torch.bfloat16, 1024, "does not cover"),  # Cin = 96, Cmid = 48
])
def test_tail_kernel_mode_raises_where_the_kernel_does_not_apply(
        card, dtype, cin, match):
    """A decoder asked for the tail kernel never takes the naive composition
    on the card: what the kernel does not cover raises."""
    from strajnet_tpu_torch.models.decoder import (FusedUpConv,
                                                   Pyramid3DDecoder)
    dec = Pyramid3DDecoder(32, (16, 32, 64), 16, dtype=dtype,
                           use_tail_kernel="kernel").to(card)
    up = FusedUpConv(cin, 48, dtype).to(card)
    x = torch.zeros(1, 2, 8, 8, cin, dtype=dtype, device=card)
    before = dtl.decoder_tail.launches
    with pytest.raises((ValueError, RuntimeError), match=match):
        dec._tail(up, dec.outconv, x)
    assert dtl.decoder_tail.launches == before
