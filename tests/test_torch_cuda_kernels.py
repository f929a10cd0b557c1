"""The port's CUDA kernels against their plain versions, on a card.

Needs an NVIDIA GPU and nvcc, so these skip on a machine without one; run
them there with ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
``chip_smoke.py`` makes the same comparisons at the flagship shapes.
"""

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.ops import swin_block as sb
from strajnet_tpu_torch.ops import warp_gather as wg
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
    assert float((y.float() - ref.float()).abs().max()) <= \
        2.0 ** -5 * float(ref.float().abs().max())
    for got, want in zip(grads, (rdx,) + rgrads):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -6 * scale
