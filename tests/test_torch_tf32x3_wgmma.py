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

The same holds for the general K1's four f32 products on their own kernel
(``fwd_product_kernel``): tiles of 128 x 128 (columns past N read as zero),
16-deep stages of two 8-deep steps whose depths are permuted (depth 4 e + 2
step + j / 4 is element j of a step), the LayerNorm applied in f32 to each
landed stage of A before the split, and the bias, gelu and residual
epilogues in f32, at ragged shapes and at each of the f32 configuration's
three widths.
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


FWD_TILE_M, FWD_TILE_N, FWD_STAGE_K = 128, 128, 16   # fwd_product_kernel
# element j of step `step` of a stage is the stage's depth 4 (j % 4) + 2
# step + j // 4: a thread's fragment of both steps is four adjacent depths
FWD_STEP_DEPTHS = [[4 * (j % 4) + 2 * step + j // 4 for j in range(8)]
                   for step in range(2)]


def layer_norm_f32(a, s, b, eps=1e-5):
    """The rows' LayerNorm in f32: both sums over the row in f32, then (a -
    mean) * (1 / std) * s + b."""
    mean = a.sum(1, dtype=np.float32, keepdims=True) / np.float32(a.shape[1])
    d = a - mean
    var = (d * d).sum(1, dtype=np.float32, keepdims=True) / np.float32(a.shape[1])
    inv = (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(np.float32)
    return ((a - mean) * inv) * s + b


def gelu_f32(z):
    z = z.astype(np.float32)
    k, c = np.float32(0.7978845608028654), np.float32(0.044715)
    return np.float32(0.5) * z * (np.float32(1.0) + np.tanh(k * (z + c * z * z * z)))


def forward_product_stages(a, w, bias, ln=None):
    """a [M, K] @ w [K, N] + bias as ``fwd_product_kernel`` computes it:
    padded to its tiles (zeros past M, N and K), each landed 16-deep stage
    of A LayerNormed in f32 (``ln`` = (scale, shift)) before its split, the
    stage's two permuted 8-deep steps of three passes added toward zero to a
    fresh sum, the stage added to the total to nearest, then the bias."""
    m, k = a.shape
    n = w.shape[1]
    mp = -(-m // FWD_TILE_M) * FWD_TILE_M
    np_ = -(-n // FWD_TILE_N) * FWD_TILE_N
    kp = -(-k // FWD_STAGE_K) * FWD_STAGE_K
    if ln is not None:
        a = layer_norm_f32(a, *ln)
    a = np.pad(a, ((0, mp - m), (0, kp - k)))
    w = np.pad(w, ((0, kp - k), (0, np_ - n)))
    (ah, al), (wh, wl) = split(a), split(w)
    total = np.zeros((mp, np_), np.float32)
    for k0 in range(0, kp, FWD_STAGE_K):
        stage = np.zeros_like(total)
        for depths in FWD_STEP_DEPTHS:
            idx = [k0 + d for d in depths]
            for x, y in ((al, wh), (ah, wl), (ah, wh)):
                p = x[:, idx].astype(np.float64) @ y[idx, :].astype(np.float64)
                stage = _toward_zero(stage.astype(np.float64) + p)
        total = (total + stage).astype(np.float32)
    return total[:m, :n] + bias


# (M, K, N) of each of the four products: ragged rows, depths and columns
# (a tile that N 60 and 24 fill in part), and the f32 flagship's four at
# batch 1, 32 x 32 tokens at each of its widths (C 96, 192 and 384, MLP 4 C)
FWD_SHAPES = {"ragged": (144, 20, 60), "ragged_wide": (200, 36, 140),
              "ragged_narrow": (130, 40, 24)}
for _c in (96, 192, 384):
    _name = "flagship" if _c == 384 else f"flagship_c{_c}"
    FWD_SHAPES.update({f"{_name}_qkv": (1024, _c, 3 * _c),
                       f"{_name}_proj": (1024, _c, _c),
                       f"{_name}_fc1": (1024, _c, 4 * _c),
                       f"{_name}_fc2": (1024, 4 * _c, _c)})


FWD_CASES = [(name, epi) for name in sorted(FWD_SHAPES)
             for epi in ("qkv", "proj", "fc1", "fc2")
             if not name.startswith("flagship") or name.endswith(epi)]


@pytest.mark.parametrize("name,epi", FWD_CASES)
def test_forward_products_hold_f32(name, epi):
    """Each of the general K1's products in f32 on its kernel's tiles and
    stages (LayerNorm for qkv and fc1, gelu for fc1, the residual with a
    drop-path scale for proj and fc2), against the same function in f64:
    within 1e-6 of the result's largest entry (the LayerNorm's output too),
    two orders under ``chip_smoke.ANY_F32_FWD_MAX_ABS_REL``. The flagship
    shapes run each product at its own widths; the ragged ones run all
    four."""
    m, k, n = FWD_SHAPES[name]
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    f32 = np.float32
    a = rng.standard_normal((m, k)).astype(f32) * f32(1.5) + f32(0.3)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(f32)
    bias = (rng.standard_normal(n) * 0.1).astype(f32)
    ln = None
    if epi in ("qkv", "fc1"):
        ln = ((1 + 0.2 * rng.standard_normal(k)).astype(f32),
              (0.1 * rng.standard_normal(k)).astype(f32))
    got = forward_product_stages(a, w, bias, ln)
    a64 = a.astype(np.float64)
    if ln is not None:
        mu = a64.mean(1, keepdims=True)
        h64 = (a64 - mu) / np.sqrt(((a64 - mu) ** 2).mean(1, keepdims=True)
                                   + 1e-5) * ln[0] + ln[1]
        h32 = layer_norm_f32(a, *ln)
        assert np.abs(h32 - h64).max() <= 1e-6 * np.abs(h64).max()
        a64 = h64
    want = a64 @ w.astype(np.float64) + bias
    if epi == "fc1":
        got = gelu_f32(got)
        want = 0.5 * want * (1 + np.tanh(0.7978845608028654
                                         * (want + 0.044715 * want ** 3)))
    elif epi in ("proj", "fc2"):
        res = rng.standard_normal((m, n)).astype(f32)
        dp = f32(1.1)
        got = res + dp * got
        want = res + 1.1 * want
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-6
    assert 100 * err <= ANY_F32_FWD_MAX_ABS_REL


def test_forward_step_depths_cover_each_stage_once():
    """The two steps of a stage take its 16 depths once each, and a
    thread's four depths of both steps (elements t and t + 4 of each) are
    adjacent: 4 t .. 4 t + 3, one 16-byte read of the landed row."""
    assert sorted(FWD_STEP_DEPTHS[0] + FWD_STEP_DEPTHS[1]) == list(range(16))
    for t in range(4):
        got = sorted(FWD_STEP_DEPTHS[s][j] for s in range(2) for j in (t, t + 4))
        assert got == [4 * t + e for e in range(4)]
