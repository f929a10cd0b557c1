"""The arithmetic of the f32 wgmma product (``csrc/window_any.cu::
gemm_tf32x3_kernel``), modelled in numpy.

The kernel takes K3's f32 products (and K4's recomputed qkv) as three TF32
passes on wgmma: each 32-deep stage of A and B is split once, when it has
landed in shared memory, into TF32 halves (hi = tf32(x), lo = tf32(x - hi),
rounded to nearest even), each warpgroup sums lo_a hi_b + hi_a lo_b +
hi_a hi_b over the stage's four 8-deep steps in a fresh accumulator, which
the tensor cores round toward zero, and adds the stage to its f32 total to
nearest. Depths past K, rows past M and columns past N read as zero. At
ragged M, N and K (tiles of 128 x 64 that the matrix does not fill, depths
that are not a multiple of 8 or 32) and at the f32 flagship's qkv and
projection, the model lands within 1e-6 of the largest entry of the f64
product, under the f32 forward limit of the card's checks
(``chip_smoke.ANY_F32_FWD_MAX_ABS_REL``) by two orders. The kernel itself
runs only on a card (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import ANY_F32_FWD_MAX_ABS_REL  # noqa: E402
from test_torch_tf32x3 import _toward_zero, split  # noqa: E402

TILE_M, TILE_N = 128, 64   # gemm_tf32x3_kernel's tile of C
STAGE_K, MMA_K = 32, 8     # depths a stage and a wgmma step
# (M, K, N): ragged tiles and depths; the flagship's f32 qkv and projection
# at batch 2, 32 x 32 tokens (C 384)
SHAPES = {"ragged_k24": (300, 24, 72), "ragged_k40": (200, 40, 120),
          "ragged_k18": (130, 18, 54), "flagship_qkv": (2048, 384, 1152),
          "flagship_proj": (2048, 384, 384)}


def tf32x3_stages(a, b):
    """a [M, K] @ b [K, N] as the kernel computes it, tile by tile."""
    m, k = a.shape
    n = b.shape[1]
    f64 = np.float64
    kp = -(-k // STAGE_K) * STAGE_K
    a = np.pad(a, ((0, 0), (0, kp - k)))        # zeros past K
    b = np.pad(b, ((0, kp - k), (0, 0)))
    (ah, al), (bh, bl) = split(a), split(b)
    out = np.zeros((m, n), np.float32)
    for m0 in range(0, m, TILE_M):
        for n0 in range(0, n, TILE_N):
            rows, cols = slice(m0, m0 + TILE_M), slice(n0, n0 + TILE_N)
            total = np.zeros(out[rows, cols].shape, np.float32)
            for k0 in range(0, kp, STAGE_K):
                stage = np.zeros_like(total)
                for k1 in range(k0, k0 + STAGE_K, MMA_K):
                    s = slice(k1, k1 + MMA_K)
                    for x, y in ((al, bh), (ah, bl), (ah, bh)):
                        p = x[rows, s].astype(f64) @ y[s, cols].astype(f64)
                        stage = _toward_zero(stage.astype(f64) + p)
                total = (total + stage).astype(np.float32)
            out[rows, cols] = total
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tf32x3_stages_hold_f32(name):
    m, k, n = SHAPES[name]
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = tf32x3_stages(a, b)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-6
    assert 100 * err <= ANY_F32_FWD_MAX_ABS_REL


def test_the_split_is_exact_and_once():
    """hi + lo carries x to within 2^-22 of its magnitude, and splitting
    the halves again changes neither: splitting a stage once in shared
    memory gives each product the operands a per-fragment split gives it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
        -3, 4, 4096)
    hi, lo = split(x)
    assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -22 * np.abs(x))
    np.testing.assert_array_equal(split(hi)[0], hi)
    np.testing.assert_array_equal(split(lo)[0], lo)
