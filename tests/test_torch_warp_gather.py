"""The port's warp gather against JAX, on the CPU.

``ops/warp_gather.py``'s plain versions (the CPU path of the wrappers and the
CUDA kernels' oracle) and ``sample_dense`` are held against the JAX package's
Pallas kernel run in interpret mode and against its portable
``core.sampling.sample``; gradients against ``jax.grad`` of the same. The
CUDA kernels themselves are checked on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.core import sampling as jsampling
from strajnet_tpu.ops import pallas_warp_gather as jwg
from strajnet_tpu_torch.core.sampling import flow_warp_origin, sample
from strajnet_tpu_torch.ops import warp_gather as wg

torch.set_num_threads(2)

CASES = [(2, 16), (3, 16), (4, 32)]


def _case(s, size, seed=0, binary=True, ties=True):
    """An image and (x, y) queries at identity + flow: most inside, some past
    the border and, with ``ties``, the first rows exactly on integer pixels
    and on the border."""
    rng = np.random.default_rng(seed)
    h = w = size
    img = rng.random((s, h, w, 1)).astype(np.float32)
    if binary:
        img = (img < 0.4).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    flow = (rng.standard_normal((s, h, w, 2)) * 3.0).astype(np.float32)
    flow[:, 1, :, 0] = -float(w) - 0.25    # far past the left border
    flow[:, 2, :, 1] = float(h) + 0.25     # far past the bottom border
    if ties:
        flow[:, 0] = 0.0                   # on integer pixels, on the border
        flow[:, 3] = np.round(flow[:, 3])  # integer offsets
    warp = np.stack([xs, ys], -1)[None] + flow
    return img, warp.astype(np.float32), flow


@pytest.mark.parametrize("s,size", CASES)
def test_sample_dense_matches_pallas_and_portable(s, size):
    img, warp, _ = _case(s, size)
    ours = wg.sample_dense(torch.from_numpy(img), torch.from_numpy(warp))
    pallas = jwg.sample_dense(jnp.asarray(img), jnp.asarray(warp),
                              interpret=True)
    portable = jsampling.sample(jnp.asarray(img), jnp.asarray(warp),
                                pixel_type=jsampling.PixelType.INTEGER)
    assert ours.shape == (s, size, size, 1)
    # f32 both sides, the same expression tree: blend rounding only
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(portable), atol=1e-6)


@pytest.mark.parametrize("s,size", CASES)
def test_sample_dense_is_exact_for_any_f32_image(s, size):
    """No bf16-exactness precondition: a non-binary image matches the port's
    own portable ``sample`` and JAX's."""
    img, warp, _ = _case(s, size, seed=1, binary=False)
    ours = wg.sample_dense(torch.from_numpy(img), torch.from_numpy(warp))
    ref = sample(torch.from_numpy(img), torch.from_numpy(warp))
    jref = jsampling.sample(jnp.asarray(img), jnp.asarray(warp),
                            pixel_type=jsampling.PixelType.INTEGER)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jref), atol=1e-6)


def _floor_indices(img, warp):
    s, h, w, _ = img.shape
    q = warp.reshape(s, -1, 2) + 1.0
    x0f = np.clip(np.floor(q[..., 0]), 0.0, w).astype(np.float32)
    y0f = np.clip(np.floor(q[..., 1]), 0.0, h).astype(np.float32)
    return np.pad(img[..., 0], ((0, 0), (1, 1), (1, 1))), x0f, y0f


@pytest.mark.parametrize("s,size", CASES)
def test_gather_corners_reference_matches_pallas_kernel(s, size):
    img, warp, _ = _case(s, size, seed=2)
    padded, x0f, y0f = _floor_indices(img, warp)
    ours = wg.gather_corners_reference(*(torch.from_numpy(a)
                                         for a in (padded, x0f, y0f)))
    # the Pallas call wants the buffer padded to (8, 128) tiles
    hp, wp = padded.shape[1:]
    phys = np.pad(padded, ((0, 0), (0, -hp % 8), (0, -wp % 128)))
    ref = jwg._gather_corners(jnp.asarray(phys), jnp.asarray(x0f),
                              jnp.asarray(y0f), True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("s,size", CASES)
def test_scatter_reference_matches_pallas_backward_and_autograd(s, size):
    img, warp, _ = _case(s, size, seed=3)
    padded, x0f, y0f = _floor_indices(img, warp)
    rng = np.random.default_rng(4)
    gs = [rng.standard_normal(x0f.shape).astype(np.float32) for _ in range(4)]
    t = [torch.from_numpy(a) for a in (padded, x0f, y0f)]
    ours = wg.scatter_corners_reference(padded.shape, t[1], t[2],
                                        [torch.from_numpy(g) for g in gs])
    # autograd of the plain gather
    leaf = t[0].clone().requires_grad_(True)
    corners = wg.gather_corners_reference(leaf, t[1], t[2])
    sum((c * torch.from_numpy(g)).sum() for c, g in zip(corners, gs)).backward()
    np.testing.assert_allclose(ours.numpy(), leaf.grad.numpy(), atol=1e-5)
    # the wrapper's autograd.Function on the CPU
    leaf2 = t[0].clone().requires_grad_(True)
    corners = wg.gather_corners(leaf2, t[1], t[2])
    sum((c * torch.from_numpy(g)).sum() for c, g in zip(corners, gs)).backward()
    np.testing.assert_allclose(ours.numpy(), leaf2.grad.numpy(), atol=1e-5)
    # the Pallas backward kernel, interpreted
    hp, wp = padded.shape[1:]
    php, pwp = hp + (-hp % 8), wp + (-wp % 128)
    ref = jwg._bwd_call((s, php, pwp), jnp.asarray(x0f), jnp.asarray(y0f),
                        [jnp.asarray(g) for g in gs], True)
    # f32 sums of at most a few terms per pixel, in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[:, :hp, :wp],
                               atol=1e-5)


@pytest.mark.parametrize("s,size", CASES)
def test_gradients_match_jax(s, size):
    # Queries off the integer lattice: exactly on it, ``x - floor(x)`` sits on
    # the clip's lower bound, where JAX halves the subgradient and PyTorch
    # passes it whole (a convention on a set of measure zero).
    img, warp, _ = _case(s, size, seed=5, binary=True, ties=False)
    weight = np.random.default_rng(6).standard_normal(
        (s, size, size, 1)).astype(np.float32)

    ti = torch.from_numpy(img).requires_grad_(True)
    tw = torch.from_numpy(warp).requires_grad_(True)
    (wg.sample_dense(ti, tw) * torch.from_numpy(weight)).sum().backward()

    def jloss(fn):
        return lambda i, q: jnp.sum(fn(i, q) * weight)

    g_pallas = jax.grad(jloss(lambda i, q: jwg.sample_dense(
        i, q, interpret=True)), argnums=(0, 1))(jnp.asarray(img),
                                                jnp.asarray(warp))
    g_portable = jax.grad(jloss(lambda i, q: jsampling.sample(
        i, q, pixel_type=jsampling.PixelType.INTEGER)), argnums=(0, 1))(
            jnp.asarray(img), jnp.asarray(warp))
    for ref in (g_pallas, g_portable):
        # image gradient: sums of a few f32 blend weights per pixel; warp
        # gradient: differences of corners times a weight
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("s,size", CASES)
def test_flow_warp_origin_matches_jax(s, size, use_kernel):
    img, _, flow = _case(s, size, seed=7)
    ours = flow_warp_origin(torch.from_numpy(img), torch.from_numpy(flow),
                            use_kernel=use_kernel)
    ref = jsampling.flow_warp_origin(jnp.asarray(img), jnp.asarray(flow))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_wrappers_on_cpu_take_plain_path_and_count_no_launch():
    img, warp, _ = _case(2, 16, seed=8)
    before = (wg.warp_gather_fwd.launches, wg.warp_gather_bwd.launches)
    ti = torch.from_numpy(img).requires_grad_(True)
    wg.sample_dense(ti, torch.from_numpy(warp)).sum().backward()
    assert ti.grad is not None
    assert (wg.warp_gather_fwd.launches,
            wg.warp_gather_bwd.launches) == before


def test_supports_and_shape_errors():
    img = torch.zeros(2, 8, 8, 1)
    assert wg.supports(img, torch.zeros(2, 8, 8, 2))
    assert wg.supports(img, torch.zeros(2, 5, 2))
    assert not wg.supports(torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 2))
    assert not wg.supports(img, torch.zeros(2, 8, 8, 3))
    assert not wg.supports(img, torch.zeros(3, 8, 8, 2))
    with pytest.raises(ValueError):
        wg.sample_dense(torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 2))


def test_flow_warp_origin_kernel_route_raises_on_unsupported_shape():
    # the kernel route never gives way to the portable sampler: an occupancy
    # with more than one channel raises, and only use_kernel=False samples it
    occ, flow = torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 2)
    with pytest.raises(ValueError):
        flow_warp_origin(occ, flow, use_kernel=True)
    assert flow_warp_origin(occ, flow, use_kernel=False).shape == (2, 8, 8, 3)


def _band_cases(s, size, seed):
    """Floor indices and cotangents of two query sets the banded backward
    kernel must get right: a smooth flow (zero flow plus one fractional
    offset, so the four queries around every pixel share it as a corner)
    and queries on the first and last rows of the padded image and on the
    rows where its bands meet."""
    hp = wp = size + 2
    ys, xs = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    warp = np.stack([xs + 0.3, ys + 0.6], -1)[None].repeat(s, 0)
    img = np.zeros((s, size, size, 1), np.float32)
    _, sx0, sy0 = _floor_indices(img, warp)
    rng = np.random.default_rng(seed)
    edge = wg.band_edge_rows(hp, wg.bwd_band_rows(hp, wp, bands=3))
    ey0 = np.resize(np.array(edge), sy0.shape).astype(np.float32)
    ex0 = rng.integers(0, wp - 1, sx0.shape).astype(np.float32)
    return (hp, wp), ((sx0, sy0), (ex0, ey0))


@pytest.mark.parametrize("s,size", CASES)
def test_scatter_reference_on_shared_corners_and_band_rows(s, size):
    """``scatter_corners_reference`` (the backward kernel's oracle on the
    card) against the interpreted Pallas backward on the smooth flow, where
    every pixel sums four corners, and on queries at the first and last
    rows and at the rows where three bands of the kernel meet."""
    (hp, wp), sets = _band_cases(s, size, seed=9)
    rng = np.random.default_rng(10)
    for x0f, y0f in sets:
        gs = [rng.standard_normal(x0f.shape).astype(np.float32)
              for _ in range(4)]
        ours = wg.scatter_corners_reference(
            (s, hp, wp), torch.from_numpy(x0f), torch.from_numpy(y0f),
            [torch.from_numpy(g) for g in gs])
        php, pwp = hp + (-hp % 8), wp + (-wp % 128)
        ref = jwg._bwd_call((s, php, pwp), jnp.asarray(x0f),
                            jnp.asarray(y0f), [jnp.asarray(g) for g in gs],
                            True)
        ref = np.asarray(ref)
        # nothing lands in the Pallas buffer's padding
        assert not ref[:, hp:].any() and not ref[:, :, wp:].any()
        # f32 sums of a few terms per pixel, in another order
        np.testing.assert_allclose(ours.numpy(), ref[:, :hp, :wp], atol=1e-5)


@pytest.mark.parametrize("hp,wp,bands,rows", [
    (258, 258, None, 129),    # the loss's slices: two bands by default
    (258, 258, 3, 86),
    (258, 258, 1, 129),       # one band of 266 KB does not fit: two
    (18, 18, None, 9),
    (3, 3, 4, 1),
    (1000, 4000, None, 14),   # as many bands as shared memory needs
])
def test_backward_band_rows(hp, wp, bands, rows):
    assert wg.bwd_band_rows(hp, wp, bands) == rows
    assert 4 * rows * wp <= 232448


def test_band_edge_rows():
    assert wg.band_edge_rows(258, 129) == (0, 127, 128, 129, 256)
    assert wg.band_edge_rows(18, 6) == (0, 4, 5, 6, 10, 11, 12, 16)
    assert wg.band_edge_rows(3, 1) == (0, 1)


def test_backward_band_rows_refuses_a_row_wider_than_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        wg.bwd_band_rows(4, 60000)
