"""The port's decoder tail against the JAX package, on the CPU.

``ops/decoder_tail.py``: the naive composition and the phase form against
``decoder_tail_xla`` and against the Pallas kernel (interpreted), their
gradients against ``jax.grad``, the folded kernels, the geometry gate and the
wrapper's plumbing. f32; the CUDA kernel is held against the naive composition
on a card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.ops import pallas_decoder_tail as jtail
from strajnet_tpu.ops.upconv import fold_kernel_2x as jax_fold_kernel_2x
from strajnet_tpu_torch.ops import decoder_tail as dtl

torch.set_num_threads(2)
FORMS = {"reference": dtl.decoder_tail_reference,
         "phase": dtl.decoder_tail_phase}


def _inputs(n, h, w, cin, cmid, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rng.randn(*s) * k).astype(np.float32)  # noqa: E731
    return [f(n, h, w, cin), f(3, 3, cin, cmid, k=0.2), f(cmid, k=0.1),
            f(3, 3, cmid, 2, k=0.2), f(2, k=0.1)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("h", [8, 16])
def test_plain_forms_match_xla_and_the_interpreted_pallas_kernel(h, form):
    args = _inputs(3, h, h, 16, 48)
    jargs = [jnp.asarray(a) for a in args]
    xla = np.asarray(jtail.decoder_tail_xla(*jargs))
    kernel = np.asarray(jtail.decoder_tail(*jargs, interpret=True))
    ours = FORMS[form](*_t(args)).numpy()
    assert ours.shape == (3, 2 * h, 2 * h, 2)
    # f32 both sides, taps summed in another order
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_forms_match_xla_at_64_to_32_channels(form):
    """``Cin = 64``, ``Cmid = 32`` in f32: widths new to the card with the
    general K7, whose oracle is the naive composition; f32 both sides."""
    args = _inputs(2, 16, 16, 64, 32, seed=9)
    xla = np.asarray(jtail.decoder_tail_xla(*[jnp.asarray(a) for a in args]))
    ours = FORMS[form](*_t(args)).numpy()
    assert ours.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_zero_border_handling(form):
    """Against a brute-force upsample + conv: outside the image the elu'd
    intermediate counts as 0, not as elu(b_up)."""
    x, w_up, b_up, w_out, b_out = _t(_inputs(1, 8, 8, 8, 48, seed=1))
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2).permute(0, 3, 1, 2)
    y = torch.nn.functional.conv2d(up, w_up.permute(3, 2, 0, 1), b_up,
                                   padding=1)
    ref = torch.nn.functional.conv2d(torch.nn.functional.elu(y),
                                     w_out.permute(3, 2, 0, 1), b_out,
                                     padding=1).permute(0, 2, 3, 1)
    got = FORMS[form](x, w_up, b_up, w_out, b_out)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    # a ragged, non-square image too
    args = _t(_inputs(2, 5, 11, 8, 12, seed=2))
    np.testing.assert_allclose(dtl.decoder_tail_phase(*args).numpy(),
                               dtl.decoder_tail_reference(*args).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", sorted(FORMS) + ["wrapper"])
def test_gradients_match_jax(form):
    args = _inputs(2, 8, 8, 8, 48, seed=2)
    cot = np.random.RandomState(3).randn(2, 16, 16, 2).astype(np.float32)
    ref = jax.grad(
        lambda *a: jnp.sum(jtail.decoder_tail_xla(*a) * jnp.asarray(cot)),
        argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in args])
    fn = dtl.decoder_tail if form == "wrapper" else FORMS[form]
    ins = [a.requires_grad_(True) for a in _t(args)]
    got = torch.autograd.grad(fn(*ins), ins, torch.from_numpy(cot))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4)


def test_folded_kernels_match_jax():
    rng = np.random.RandomState(4)
    w3 = rng.randn(3, 3, 8, 12).astype(np.float32)
    wo = rng.randn(3, 3, 12, 2).astype(np.float32)
    np.testing.assert_allclose(
        dtl.fold_kernel_2x(torch.from_numpy(w3)).numpy(),
        np.asarray(jax_fold_kernel_2x(jnp.asarray(w3))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        dtl.build_ky(torch.from_numpy(wo)).numpy(),
        np.asarray(jtail.build_ky(jnp.asarray(wo))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        dtl._offset_grid_mask(4, 6).numpy(),
        np.asarray(jtail._offset_grid_mask(4, 6)))


@pytest.mark.parametrize("geometry,expect", [
    ((128, 128, 96, 48, 2), True),     # the flagship tail
    ((16, 16, 96, 48, 2), True),       # the TINY tail
    ((9, 20, 96, 48, 2), True),        # ragged: the kernel masks its edges
    ((128, 128, 96, 48, 4), False),    # two output channels only
    ((128, 128, 24, 48, 2), False),    # the kernel is built for the tails'
    ((128, 128, 96, 6, 2), False),     # widths, Cin = 96 and Cmid = 48,
    ((128, 128, 1024, 48, 2), False),  # and refuses any other
    ((9, 20, 32, 16, 2), False),
])
def test_supports(geometry, expect):
    assert dtl.supports(*geometry) is expect
    if expect and geometry[0] == geometry[1]:
        # what the kernel here covers, the JAX gate covers at the same widths
        assert jtail.supports(128, 128, *geometry[2:])


def test_autograd_function_plumbing(monkeypatch):
    """The ``autograd.Function`` of the CUDA path with its launch replaced by
    the phase form: its backward is autograd of the naive composition."""
    monkeypatch.setattr(dtl, "_launch", dtl.decoder_tail_phase)
    args = _inputs(2, 8, 8, 16, 8, seed=5)
    cot = torch.from_numpy(
        np.random.RandomState(6).randn(2, 16, 16, 2).astype(np.float32))
    ins = [a.requires_grad_(True) for a in _t(args)]
    got = torch.autograd.grad(dtl._DecoderTailFn.apply(*ins), ins, cot)
    ref_ins = [a.requires_grad_(True) for a in _t(args)]
    want = torch.autograd.grad(dtl.decoder_tail_reference(*ref_ins), ref_ins,
                               cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_takes_the_naive_composition_and_launches_nothing():
    args = _t(_inputs(1, 8, 8, 16, 8))
    before = dtl.decoder_tail.launches
    assert torch.equal(dtl.decoder_tail(*args),
                       dtl.decoder_tail_reference(*args))
    assert dtl.decoder_tail.launches == before
    with pytest.raises(ValueError):
        dtl.decoder_tail(*[a.to("meta") for a in args])


def test_phase_form_and_output_kernel_match_jax_on_a_ragged_image():
    """``[3, 20, 33, 96]`` with 48 intermediate channels, the widths of the
    CUDA kernel at an image that is neither square nor a multiple of
    anything: the phase form, which is what that kernel computes, and the
    re-bucketed output kernel against the JAX package's. f32 both sides, taps
    summed in another order: rtol = atol = 1e-4."""
    args = _inputs(3, 20, 33, 96, 48, seed=7)
    jargs = [jnp.asarray(a) for a in args]
    ours = dtl.decoder_tail_phase(*_t(args)).numpy()
    assert ours.shape == (3, 40, 66, 2)
    np.testing.assert_allclose(
        ours, np.asarray(jtail.decoder_tail_phase(*jargs)), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(
        ours, np.asarray(jtail.decoder_tail_xla(*jargs)), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(
        dtl.build_ky(torch.from_numpy(args[3])).numpy(),
        np.asarray(jtail.build_ky(jargs[3])), rtol=1e-6, atol=1e-6)


def test_folds_match_their_written_out_index_formulas():
    """``fold_kernel_2x`` and ``build_ky`` are one ``einsum`` each with a 0/1
    selector; here they are held against the sums written out tap by tap."""
    rng = np.random.RandomState(8)
    w3 = torch.from_numpy(rng.randn(3, 3, 5, 6).astype(np.float32))
    wo = torch.from_numpy(rng.randn(3, 3, 6, 2).astype(np.float32))
    kf = dtl.fold_kernel_2x(w3)
    rows = (((0,), (1, 2)), ((0, 1), (2,)))   # [phase][tap] -> 3x3 rows
    for a in (0, 1):
        for b in (0, 1):
            for u in (0, 1):
                for v in (0, 1):
                    want = sum(w3[d, e] for d in rows[a][u]
                               for e in rows[b][v])
                    p = 2 * a + b
                    np.testing.assert_allclose(
                        kf[u, v, :, 6 * p:6 * p + 6].numpy(), want.numpy(),
                        rtol=1e-6, atol=1e-6)
    ky = dtl.build_ky(wo)
    want = torch.zeros(2, 2, 4, 6, 8)
    for a in (0, 1):
        for b in (0, 1):
            for kr in range(3):
                for kc in range(3):
                    # tap kr of phase a reads upsampled row 2i + a + kr - 1
                    a2, b2 = (a + kr - 1) % 2, (b + kc - 1) % 2
                    di, dj = (a + kr - 1 - a2) // 2, (b + kc - 1 - b2) // 2
                    lane = (2 * a + b) * 2
                    want[a2 + di, b2 + dj, 2 * a2 + b2, :, lane:lane + 2] += \
                        wo[kr, kc]
    np.testing.assert_allclose(ky.numpy(), want.reshape(2, 2, 24, 8).numpy(),
                               rtol=1e-6, atol=1e-6)


def _launch_case(cin=96, cmid=48, dtype=torch.bfloat16, cout=2, h=8, w=8):
    return (torch.zeros(1, h, w, cin, dtype=dtype),
            torch.zeros(3, 3, cin, cmid), torch.zeros(3, 3, cmid, cout))


@pytest.mark.parametrize("case,what", [
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(cin=24), "does not cover"),
    (dict(cin=1024), "does not cover"),
    (dict(cin=32, cmid=16), "does not cover"),
    (dict(cmid=24), "does not cover"),
    (dict(cout=4), "expected"),
])
def test_kernel_refuses_on_the_argument_check_alone(case, what):
    """What the kernel is not built for raises ValueError from
    ``check_launch_args``, which runs before any build or launch."""
    with pytest.raises(ValueError, match=what):
        dtl.check_launch_args(*_launch_case(**case))
    dtl.check_launch_args(*_launch_case())
    dtl.check_launch_args(*_launch_case(h=20, w=33))
