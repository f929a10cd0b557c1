"""The port's fused Swin block: plain version vs the JAX block, on the CPU.

``swin_block_reference`` (the CPU path of ``swin_block`` and the CUDA
kernel's oracle) is held against both JAX formulations of the block: the
Pallas kernel run in interpret mode and ``_xla_block_reference``. The CUDA
kernel itself is checked on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strajnet_tpu.ops.pallas_swin_block import (_xla_block_reference,
                                                fused_swin_block)
from strajnet_tpu.ops.windows import shifted_window_mask as jax_mask
from strajnet_tpu_torch.ops.swin_block import (check_kernel_args, swin_block,
                                               swin_block_reference)

torch.set_num_threads(2)

NAMES = ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias", "ln1s", "ln1b",
         "ln2s", "ln2b", "w1", "b1", "w2", "b2")


def _inputs(b, h, w, c, ws, heads, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    hidden = 4 * c
    return dict(
        x=f(b, h, w, c) * 0.5,
        wqkv=f(c, 3 * c) * 0.2, bqkv=f(3 * c) * 0.1,
        wproj=f(c, c) * 0.2, bproj=f(c) * 0.1,
        rel_bias=f(heads, ws * ws, ws * ws) * 0.3,
        ln1s=1.0 + 0.1 * f(c), ln1b=0.1 * f(c),
        ln2s=1.0 + 0.1 * f(c), ln2b=0.1 * f(c),
        w1=f(c, hidden) * 0.2, b1=f(hidden) * 0.1,
        w2=f(hidden, c) * 0.2, b2=f(c) * 0.1,
    )


def _drop_path(b):
    # distinct keep-scaled per-sample multipliers: sample 0 drops branch 1,
    # sample 1 drops branch 2, the rest keep both with distinct scales
    dp = (1.0 / 0.9 + 0.1 * np.arange(2 * b, dtype=np.float32)).reshape(b, 2)
    dp[0, 0] = 0.0
    dp[1 % b, 1] = 0.0
    return dp


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("batch", [2, 3])
def test_reference_matches_jax_block(batch, shift):
    b, h, w, c, ws, heads = batch, 16, 16, 8, 4, 2
    a = _inputs(b, h, w, c, ws, heads)
    mask = jax_mask(h, w, ws, shift) if shift > 0 else None
    dp = _drop_path(b)
    ja = [jnp.asarray(a[k]) for k in NAMES]
    jm = None if mask is None else jnp.asarray(mask)
    kernel = np.asarray(fused_swin_block(*ja, jm, jnp.asarray(dp),
                                         window_size=ws, num_heads=heads,
                                         interpret=True))
    xla = np.asarray(_xla_block_reference(*ja, jm, jnp.asarray(dp),
                                          window_size=ws, num_heads=heads,
                                          eps=1e-5))
    ours = swin_block_reference(
        *(torch.from_numpy(a[k]) for k in NAMES),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(dp), window_size=ws, num_heads=heads).numpy()
    # f32 throughout; the tolerance of the JAX package's own block test
    # (different accumulation order of the same f32 sums)
    np.testing.assert_allclose(ours, kernel, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(ours, xla, rtol=3e-4, atol=3e-4)


def test_reference_matches_jax_block_at_a_ragged_window_count():
    """Kernel-sized windows (8x8, head_dim 32) at a batch and size whose
    window count, 75, is odd: what the persistent CUDA kernels' last step
    and their per-window mask index meet (``chip_smoke.py`` and the ``cuda``
    tests run the kernels at this shape against the plain version)."""
    b, h, w, c, ws, heads, shift = 3, 40, 40, 96, 8, 3, 4
    a = _inputs(b, h, w, c, ws, heads, seed=5)
    for k in ("wqkv", "wproj", "w1", "w2"):   # keep activations O(1) at C=96
        a[k] = a[k] * 0.3
    mask = jax_mask(h, w, ws, shift)
    dp = _drop_path(b)
    ja = [jnp.asarray(a[k]) for k in NAMES]
    kernel = np.asarray(fused_swin_block(*ja, jnp.asarray(mask),
                                         jnp.asarray(dp), window_size=ws,
                                         num_heads=heads, interpret=True))
    ours = swin_block_reference(
        *(torch.from_numpy(a[k]) for k in NAMES), torch.from_numpy(mask),
        torch.from_numpy(dp), window_size=ws, num_heads=heads).numpy()
    assert (b * (h // ws) * (w // ws)) % 2 == 1
    np.testing.assert_allclose(ours, kernel, rtol=3e-4, atol=3e-4)


def test_reference_matches_jax_block_at_windows_of_256_tokens():
    """16x16 windows (256 tokens, the most the general route on the card
    takes), shifted by 8, two heads of 8: new to the card with the general
    route; the plain version is its oracle there."""
    b, h, w, c, ws, heads, shift = 2, 32, 32, 16, 16, 2, 8
    a = _inputs(b, h, w, c, ws, heads, seed=7)
    mask = jax_mask(h, w, ws, shift)
    dp = _drop_path(b)
    ja = [jnp.asarray(a[k]) for k in NAMES]
    kernel = np.asarray(fused_swin_block(*ja, jnp.asarray(mask),
                                         jnp.asarray(dp), window_size=ws,
                                         num_heads=heads, interpret=True))
    ours = swin_block_reference(
        *(torch.from_numpy(a[k]) for k in NAMES), torch.from_numpy(mask),
        torch.from_numpy(dp), window_size=ws, num_heads=heads).numpy()
    # f32 both sides, sums in another order: the tolerance above
    np.testing.assert_allclose(ours, kernel, rtol=3e-4, atol=3e-4)


def test_wrapper_on_cpu_takes_plain_path():
    b, h, w, c, ws, heads = 2, 8, 8, 8, 4, 2
    a = {k: torch.from_numpy(v) for k, v in
         _inputs(b, h, w, c, ws, heads, seed=1).items()}
    mask = torch.from_numpy(jax_mask(h, w, ws, 2))
    dp = torch.from_numpy(_drop_path(b))
    before = swin_block.launches
    y = swin_block(*(a[k] for k in NAMES), mask, dp, window_size=ws,
                   num_heads=heads)
    ref = swin_block_reference(*(a[k] for k in NAMES), mask, dp,
                               window_size=ws, num_heads=heads)
    assert swin_block.launches == before
    # the same function on the same inputs: bit-identical
    assert torch.equal(y, ref)


def _kernel_args(c=96, heads=3, h=16, shift=True):
    bf, f32 = torch.bfloat16, torch.float32
    z = lambda *s, dtype=f32: torch.zeros(*s, dtype=dtype)  # noqa: E731
    args = [z(2, h, h, c, dtype=bf), z(c, 3 * c, dtype=bf),
            z(3 * c, dtype=bf), z(c, c, dtype=bf), z(c, dtype=bf),
            z(heads, 64, 64), z(c), z(c), z(c), z(c),
            z(c, 4 * c, dtype=bf), z(4 * c), z(4 * c, c, dtype=bf), z(c)]
    mask = z((h // 8) ** 2, 64, 64) if shift else None
    return args, mask, z(2, 2)


def test_kernel_arg_check_accepts_flagship_geometry():
    for c, heads, h in ((96, 3, 128), (192, 6, 64), (384, 12, 32)):
        args, mask, dp = _kernel_args(c, heads, h)
        check_kernel_args(*args, mask, dp, window_size=8, num_heads=heads)
        check_kernel_args(*args, None, None, window_size=8, num_heads=heads)


@pytest.mark.parametrize("bad", ["window", "head_dim", "dtype", "layout",
                                 "mask_shape", "width", "head_dim_16",
                                 "hidden"])
def test_kernel_arg_check_rejects(bad):
    args, mask, dp = _kernel_args()
    ws, heads = 8, 3
    if bad == "window":
        ws = 4
    elif bad == "head_dim":
        heads = 4   # head_dim 24
    elif bad == "width":   # the wgmma kernels are built for 96, 192, 384
        args, mask, dp = _kernel_args(c=128, heads=4)
        heads = 4
    elif bad == "head_dim_16":   # ... and for head_dim 32
        heads = 6
        args[5] = torch.zeros(heads, 64, 64)
    elif bad == "hidden":   # not in 64-column chunks
        args[10] = torch.zeros(96, 96, dtype=torch.bfloat16)
        args[11] = torch.zeros(96)
        args[12] = torch.zeros(96, 96, dtype=torch.bfloat16)
    elif bad == "dtype":
        args[0] = args[0].float()
    elif bad == "layout":   # right shape, transposed strides
        args[1] = torch.zeros(3 * 96, 96, dtype=torch.bfloat16).t()
    elif bad == "mask_shape":
        mask = mask[:1]
    with pytest.raises(ValueError):
        check_kernel_args(*args, mask, dp, window_size=ws, num_heads=heads)
