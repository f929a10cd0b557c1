"""The SwinV2 block's attention stage on the CPU: the route's choice
between the fused kernel and the two launches (``fused_attention``,
``launches``), and the stage's plain version
(``attention_stage_reference``, which the card's tests hold both paths
against) against the plain block's own formulation of the stage
(``F.normalize``, softmax), in f32 and bf16, with and without a mask.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from strajnet_tpu_torch.ops import swinv2_block as v2
from strajnet_tpu_torch.ops.windows import shifted_window_mask


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield


@pytest.mark.parametrize("dtype,head_dim,fused", [
    (torch.bfloat16, 32, True), (torch.float32, 32, False),
    (torch.bfloat16, 16, False), (torch.bfloat16, 64, False),
])
def test_attention_stage_route(dtype, head_dim, fused):
    """One kernel in bf16 at head size 32, and seven and 17 launches a
    block; elsewhere two kernels, and one launch more each way."""
    assert v2.fused_attention(dtype, head_dim) is fused
    assert v2.launches(dtype, head_dim) == ((7, 17) if fused else (8, 18))


def _plain_stage(qkv, tau, rel, mask, ws, heads):
    """The stage as swinv2_block_reference writes it, on qkv in window
    order: (q', k', merged)."""
    m, c3 = qkv.shape
    c, n, dt = c3 // 3, ws * ws, qkv.dtype
    x = qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    scale = v2.logit_scales(tau).reshape(-1, 1, 1)
    qn = (F.normalize(x[0].float(), dim=-1, eps=v2.NORM_EPS) * scale).to(dt)
    kn = F.normalize(x[1].float(), dim=-1, eps=v2.NORM_EPS).to(dt)
    attn = qn.float() @ kn.float().transpose(-1, -2) + rel[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, n, n)
                + mask.float()[None, :, None]).reshape(-1, heads, n, n)
    p = torch.softmax(attn, dim=-1).to(dt)
    merged = (p.float() @ x[2].float()).to(dt)
    return qn, kn, merged.transpose(1, 2).reshape(m, c), attn


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_stage_reference_matches_the_block(dtype, shift):
    """q' and k' within one rounding of the block's (their squares are
    summed in another order), merged within the rounding of p and the
    products, the statistics the logits' row max and sum of exp(logit -
    max); raw is qkv's q and k, v left as it was."""
    g = torch.Generator().manual_seed(3)
    b, h, c, heads, ws = 2, 8, 16, 2, 4
    n = ws * ws
    tau = math.log(10.0) + 1.5 * (torch.rand(heads, generator=g) * 2 - 1)
    tau[0] = 5.0
    qkv = torch.randn(b * h * h, 3 * c, generator=g).to(dtype)
    rel = 16.0 * torch.sigmoid(torch.randn(heads, n, n, generator=g))
    mask = (torch.from_numpy(shifted_window_mask(h, h, ws, shift))
            if shift else None)
    out, merged, raw, stats = v2.attention_stage_reference(
        qkv, tau, rel, mask, window_size=ws, num_heads=heads)
    qn, kn, want, logits = _plain_stage(qkv, tau, rel, mask, ws, heads)
    x = out.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    for got, ref in ((x[0], qn), (x[1], kn)):
        assert torch.allclose(got.float(), ref.float(), rtol=ulp, atol=0)
    assert torch.equal(out[:, 2 * c:], qkv[:, 2 * c:])
    assert torch.equal(raw, qkv[:, :2 * c])
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert float((merged.float() - want.float()).abs().max()) <= tol * float(
        want.float().abs().max())
    mx = logits.amax(-1)
    sm = torch.exp(logits - mx[..., None]).sum(-1)
    assert stats.shape == (b * (h // ws) ** 2 * heads, n, 2)
    assert torch.allclose(stats[..., 0], mx.reshape(-1, n), rtol=1e-4,
                          atol=1e-4)
    assert torch.allclose(stats[..., 1], sm.reshape(-1, n), rtol=1e-4)
