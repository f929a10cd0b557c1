"""The f32 arithmetic of the general window kernels, modelled in numpy.

These tests hold the arithmetic model of ``csrc/window_any.cu``'s f32
products, not the kernel itself: the kernel runs only on a card, where
``chip_smoke.py`` holds it against the plain version. The kernel runs f32
products on the tensor cores as 3xTF32: each operand is split into a TF32
high part (rounded to nearest even, 10 mantissa bits) and the TF32 rounding
of what is left, and a product sums ``lo_a hi_b + hi_a lo_b + hi_a hi_b``
in f32. Here, at the four product shapes of the flagship width in f32 (qkv
and fc2 over 2048 tokens, the attention's q k^T and p v of a 256-token
window), three passes stay within 1e-6 of the largest entry of the f64
product, and one TF32 pass misses the f32 forward limit of the kernel checks
on the card (``chip_smoke.ANY_F32_FWD_MAX_ABS_REL``). The product kernel
sums each stage of the ring (``Tile<float>::kBK`` = 16 deep: two m16n8k8
steps of three passes) in a fresh tensor-core accumulator, whose sums are
rounded toward zero, and adds it to the running f32 sum to nearest, rather
than keeping the whole sum in the tensor cores' accumulator: modelled over
the depth of fc2, the drift of the latter is held against the former.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import ANY_F32_FWD_MAX_ABS_REL  # noqa: E402

# Depth of one stage of the product kernel's ring in f32
# (``Tile<float>::kBK``: 64 bytes) and of one m16n8k8 TF32 product.
STAGE_K = 16
MMA_K = 8

# (M, K, N) of the products at the flagship width in f32 (C 384, MLP 1536,
# batch 2 at 32 x 32 tokens; the attention's 256-token window, head_dim 64)
SHAPES = {
    "qkv": (2048, 384, 1152),
    "fc2": (2048, 1536, 384),
    "q_kt": (256, 64, 256),
    "p_v": (256, 256, 64),
}


def tf32(x):
    """f32 to TF32 by rounding to nearest even (kernel: tf32_rne)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def operands(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


def rel_err(got, a, b):
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_tf32_rounds_to_nearest_even():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)       # TF32's spacing at 1
    half = np.float32(2.0 ** -11)
    x = np.array([one + half, one + ulp + half, one + half * 0.75,
                  -(one + ulp + half), one + ulp], np.float32)
    want = np.array([one, one + 2 * ulp, one, -(one + 2 * ulp), one + ulp],
                    np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    low = tf32(np.float32(np.pi)).view(np.uint32) & np.uint32(0x1FFF)
    assert low == 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_three_tf32_passes_hold_f32(name):
    a, b = operands(SHAPES[name], seed=len(name))
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = np.float64
    three = (ah.astype(f64) @ bl.astype(f64) + al.astype(f64) @ bh.astype(f64)
             + ah.astype(f64) @ bh.astype(f64))
    assert rel_err(three, a, b) <= 1e-6


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_one_tf32_pass_misses_the_f32_limit(name):
    a, b = operands(SHAPES[name], seed=len(name))
    one = tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)
    assert rel_err(one, a, b) > ANY_F32_FWD_MAX_ABS_REL


def _toward_zero(x):
    """f64 to f32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_steps_added_to_nearest_beat_the_tensor_cores_own_sum():
    """fc2's depth (1536) in stages of STAGE_K, each two m16n8k8 steps of
    three passes in the kernel's order (``csrc/mma_sync.cuh``,
    ``Tc<float>::mma``: lo hi, hi lo, hi hi), every pass added toward zero
    to a fresh accumulator, which is added to the running sum to nearest
    (the model of the kernel): within 1e-6. The same passes kept in one
    accumulator, rounded toward zero at every pass, drift further."""
    m, k, n = 64, 1536, 64
    a, b = operands((m, k, n), seed=7)
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = np.float64
    fresh = np.zeros((m, n), np.float32)
    kept = np.zeros((m, n), np.float32)
    for k0 in range(0, k, STAGE_K):
        stage = np.zeros((m, n), np.float32)
        for k1 in range(k0, k0 + STAGE_K, MMA_K):
            s = slice(k1, k1 + MMA_K)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                p = x[:, s].astype(f64) @ y[s].astype(f64)
                stage = _toward_zero(stage.astype(f64) + p)
                kept = _toward_zero(kept.astype(f64) + p)
        fresh = (fresh.astype(f64) + stage).astype(np.float32)
    err_fresh, err_kept = rel_err(fresh, a, b), rel_err(kept, a, b)
    assert err_fresh <= 1e-6
    assert err_kept > 2 * err_fresh
