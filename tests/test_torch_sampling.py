"""``core/sampling.py``'s public API in the port against JAX, on the CPU.

``sample`` in all eight (resampling, border, pixel) combinations on seeded
warps with out-of-range points and exact .5 ties, ``dense_image_warp``,
``interpolate_bilinear`` in both index orders, and the cases of the JAX
package's ``tests/test_sampling.py``; f32, rtol = atol = 1e-6.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strajnet_tpu.core as jcore
from strajnet_tpu.core import sampling as js
import strajnet_tpu_torch.core as tcore
from strajnet_tpu_torch.core import sampling as ts

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
COMBOS = list(itertools.product(ts.ResamplingType, ts.BorderType,
                                ts.PixelType))


def _warp(rng, shape, lo, hi):
    """Uniform (x, y) queries, a third of them exact .5 ties and a third
    integers (ties once HALF_INTEGER has shifted them)."""
    warp = rng.uniform(lo, hi, size=shape).astype(np.float32)
    flat = warp.reshape(-1)
    n = flat.size
    flat[: n // 3] = np.floor(flat[: n // 3]) + 0.5
    flat[n // 3: 2 * n // 3] = np.floor(flat[n // 3: 2 * n // 3])
    return warp


def _jax_enum(value):
    """The JAX package's member of the same enum and name."""
    return getattr(js, type(value).__name__)[value.name]


def test_the_port_exports_what_the_jax_package_exports():
    assert tcore.__all__ == jcore.__all__
    for name in jcore.__all__:
        assert callable(getattr(tcore, name))
    for cls in ("ResamplingType", "BorderType", "PixelType"):
        assert ([(e.name, e.value) for e in getattr(tcore, cls)]
                == [(e.name, e.value) for e in getattr(jcore, cls)])


@pytest.mark.parametrize("resampling,border,pixel", COMBOS,
                         ids=lambda e: e.name)
def test_sample_option_combination_matches_jax(resampling, border, pixel):
    rng = np.random.default_rng(7)
    image = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    warp = _warp(rng, (2, 5, 6, 2), -4.0, 12.0)
    ours = ts.sample(torch.from_numpy(image), torch.from_numpy(warp),
                     resampling, border, pixel).numpy()
    ref = np.asarray(js.sample(jnp.asarray(image), jnp.asarray(warp),
                               _jax_enum(resampling), _jax_enum(border),
                               _jax_enum(pixel)))
    assert ours.shape == ref.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_sample_defaults_are_jax_defaults():
    rng = np.random.default_rng(8)
    image = rng.random((1, 6, 5, 2)).astype(np.float32)
    warp = _warp(rng, (1, 11, 2), -2.0, 8.0)
    ours = ts.sample(torch.from_numpy(image), torch.from_numpy(warp)).numpy()
    ref = np.asarray(js.sample(jnp.asarray(image), jnp.asarray(warp)))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_nearest_rounds_half_to_even():
    """x = 0.5 rounds to 0 and 2.5 to 2, as ``jnp.round`` does (``floor(x +
    0.5)`` would give 1 and 3)."""
    image = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    warp = torch.tensor([[[0.5, 0.0], [2.5, 0.0]]])
    out = ts.sample(image, warp, ts.ResamplingType.NEAREST)
    assert out.flatten().tolist() == [0.0, 2.0]


@pytest.mark.parametrize("indexing", ["ij", "xy"])
def test_interpolate_bilinear_matches_jax(indexing):
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    query = rng.uniform(-3.0, 12.0, size=(2, 50, 2)).astype(np.float32)
    ours = ts.interpolate_bilinear(torch.from_numpy(grid),
                                   torch.from_numpy(query), indexing).numpy()
    ref = np.asarray(js.interpolate_bilinear(jnp.asarray(grid),
                                             jnp.asarray(query), indexing))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_sample_is_pad_shift_and_interpolate():
    """``sample`` = pad 1 px + warp + 1 + ``interpolate_bilinear('xy')``,
    INTEGER pixels."""
    rng = np.random.default_rng(1)
    image = rng.random((2, 8, 8, 1)).astype(np.float32)
    warp = rng.uniform(-4.0, 12.0, size=(2, 5, 6, 2)).astype(np.float32)
    ours = ts.sample(torch.from_numpy(image), torch.from_numpy(warp),
                     pixel_type=ts.PixelType.INTEGER).numpy()
    padded = np.pad(image, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.asarray(js.interpolate_bilinear(
        jnp.asarray(padded), jnp.asarray((warp + 1.0).reshape(2, -1, 2)),
        "xy")).reshape(2, 5, 6, 1)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_sample_zero_border_blends_to_zero():
    image = torch.ones(1, 4, 4, 1)
    out = ts.sample(image, torch.tensor([[[-0.5, 0.0]]]))
    np.testing.assert_allclose(out.numpy(), [[[0.5]]], atol=1e-6)


def test_sample_identity_warp_is_identity():
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.random((1, 6, 6, 2)).astype(np.float32))
    ys, xs = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    warp = torch.from_numpy(np.stack([xs, ys], -1)[None].astype(np.float32))
    np.testing.assert_allclose(ts.sample(image, warp).numpy(), image.numpy(),
                               atol=1e-6)


def test_nearest_resampling():
    image = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    out = ts.sample(image, torch.tensor([[[1.4, 2.6]]]),
                    resampling_type=ts.ResamplingType.NEAREST)
    assert float(out[0, 0, 0]) == 13.0  # row 3, col 1


def test_half_integer_shift():
    image = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    half = ts.sample(image, torch.tensor([[[1.5, 1.5]]]),
                     pixel_type=ts.PixelType.HALF_INTEGER)
    whole = ts.sample(image, torch.tensor([[[1.0, 1.0]]]))
    np.testing.assert_array_equal(half.numpy(), whole.numpy())


def test_flow_warp_origin_shifts_mass():
    occ = torch.zeros(1, 5, 5, 1)
    occ[0, 2, 2, 0] = 1.0
    flow = torch.zeros(1, 5, 5, 2)
    flow[..., 0] = 1.0
    for use_kernel in (True, False):
        out = ts.flow_warp_origin(occ, flow, use_kernel=use_kernel)
        assert float(out[0, 2, 1, 0]) == pytest.approx(1.0)
        assert float(out[0, 2, 2, 0]) == pytest.approx(0.0)


def test_dense_image_warp_identity():
    rng = np.random.default_rng(4)
    image = torch.from_numpy(rng.random((2, 5, 7, 3)).astype(np.float32))
    out = ts.dense_image_warp(image, torch.zeros(2, 5, 7, 2))
    np.testing.assert_allclose(out.numpy(), image.numpy(), atol=1e-6)


@pytest.mark.parametrize("scale", [0.7, 6.0])
def test_dense_image_warp_matches_jax(scale):
    """Small flows and flows that reach past every edge (clamped)."""
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 7, 2)) * scale).astype(np.float32)
    flow[0, 0, :3] = 0.5                    # ties between two rows/cols
    ours = ts.dense_image_warp(torch.from_numpy(image),
                               torch.from_numpy(flow)).numpy()
    ref = np.asarray(js.dense_image_warp(jnp.asarray(image),
                                         jnp.asarray(flow)))
    assert ours.shape == ref.shape == image.shape
    np.testing.assert_allclose(ours, ref, **TOL)
