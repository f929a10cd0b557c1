"""The port's windowed attention against the JAX package, on the CPU.

``ops/window_attention.py``: the plain forward against
``fused_window_attention`` (the Pallas kernel, interpreted), the plain
backward against the kernel's custom VJP, and the wrapper's plumbing. f32
unless said; the CUDA kernels themselves are held against these plain versions
on a card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.ops.pallas_window_attention import fused_window_attention
from strajnet_tpu_torch.ops import window_attention as wa
from strajnet_tpu_torch.ops.windows import shifted_window_mask

torch.set_num_threads(2)
# (B, H, W, C, window, heads)
GEOMETRIES = [(2, 16, 16, 32, 8, 2), (1, 8, 16, 16, 4, 1)]


def _inputs(shape, shift, seed=0):
    b, h, w, c, ws, heads = shape
    rng = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rng.randn(*s) * k).astype(np.float32)  # noqa: E731
    args = [f(b, h, w, c, k=0.5), f(c, 3 * c, k=c ** -0.5), f(3 * c, k=0.1),
            f(c, c, k=c ** -0.5), f(c, k=0.1), f(heads, ws * ws, ws * ws,
                                                 k=0.3)]
    mask = shifted_window_mask(h, w, ws, shift) if shift else None
    return args, mask, f(b, h, w, c)


def _jax_fwd_and_vjp(args, mask, dy, ws, heads, dtype=jnp.float32):
    jmask = None if mask is None else jnp.asarray(mask)

    def f(*a):
        return fused_window_attention(*a, jmask, window_size=ws,
                                      num_heads=heads, interpret=True)

    jargs = [jnp.asarray(a, dtype) for a in args[:5]] + [jnp.asarray(args[5])]
    y, vjp = jax.vjp(f, *jargs)
    return np.asarray(y.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, dtype))]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _tmask(mask):
    return None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("shape", GEOMETRIES)
def test_plain_forward_matches_the_interpreted_pallas_kernel(shape, shift):
    ws, heads = shape[4], shape[5]
    args, mask, dy = _inputs(shape, shift)
    ref, _ = _jax_fwd_and_vjp(args, mask, dy, ws, heads)
    ours = wa.window_attention_reference(*_t(args), _tmask(mask),
                                         window_size=ws, num_heads=heads)
    # f32 both sides; the dense-strip softmax sums in another order
    np.testing.assert_allclose(ours.numpy(), ref, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("shape", GEOMETRIES)
def test_plain_backward_matches_the_pallas_custom_vjp(shape, shift):
    """The JAX backward kernel rounds every operand to bf16 whatever the
    input type: with ``operand_dtype=bfloat16`` the plain backward follows it
    to 1e-3 of each result's largest entry (all but a few entries in 10^4 to
    3e-4: an f32 sum taken in another order can round one bf16 operand the
    other way, which moves the entries it feeds by a bf16 ulp of one term);
    unrounded it is the exact gradient and sits within 1e-2."""
    ws, heads = shape[4], shape[5]
    args, mask, dy = _inputs(shape, shift)
    _, ref = _jax_fwd_and_vjp(args, mask, dy, ws, heads)
    x, wqkv, bqkv, wproj, _, rel = _t(args)
    for operand_dtype, tol in ((torch.bfloat16, 1e-3), (None, 1e-2)):
        dx, grads = wa.window_attention_backward_reference(
            x, wqkv, bqkv, wproj, rel, _tmask(mask), torch.from_numpy(dy),
            window_size=ws, num_heads=heads, operand_dtype=operand_dtype)
        for name, got, want in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads,
                                   ref):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=tol,
                atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("shift", [0, 2])
def test_plain_backward_is_the_gradient_of_the_plain_forward(shift):
    shape = GEOMETRIES[0]
    ws, heads = shape[4], shape[5]
    args, mask, dy = _inputs(shape, shift, seed=1)
    ins = [a.requires_grad_(True) for a in _t(args)]
    y = wa.window_attention(*ins, _tmask(mask), window_size=ws,
                            num_heads=heads)
    want = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    x, wqkv, bqkv, wproj, _, rel = [a.detach() for a in ins]
    dx, grads = wa.window_attention_bwd(
        x, wqkv, bqkv, wproj, rel, _tmask(mask), torch.from_numpy(dy),
        window_size=ws, num_heads=heads)
    for name, got, w in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(w.abs().max())),
                                   err_msg=name)


@pytest.mark.parametrize("backward", ["kernel", "plain"])
def test_autograd_function_plumbing(monkeypatch, backward):
    """The ``autograd.Function`` of the CUDA path with its forward launch
    replaced by the plain version: both backward switches hand every input
    its own gradient, the mask none."""
    shape = GEOMETRIES[0]
    ws, heads = shape[4], shape[5]
    args, mask, dy = _inputs(shape, 2, seed=2)

    def fake_launch(x, wqkv, bqkv, wproj, bproj, rel, m, window_size,
                    num_heads):
        return wa.window_attention_reference(
            x, wqkv, bqkv, wproj, bproj, rel, m, window_size=window_size,
            num_heads=num_heads)

    monkeypatch.setattr(wa, "_launch_fwd", fake_launch)
    ins = [a.requires_grad_(True) for a in _t(args)]
    y = wa._WindowAttentionFn.apply(ws, heads, backward == "plain",
                                    _tmask(mask), *ins)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    ref_ins = [a.requires_grad_(True) for a in _t(args)]
    y_ref = wa.window_attention_reference(*ref_ins, _tmask(mask),
                                          window_size=ws, num_heads=heads)
    want = torch.autograd.grad(y_ref, ref_ins, torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(w.abs().max())))


def test_bf16_matches_jax_by_cosine():
    shape = GEOMETRIES[0]
    ws, heads = shape[4], shape[5]
    args, mask, dy = _inputs(shape, 2, seed=3)
    ref, ref_grads = _jax_fwd_and_vjp(args, mask, dy, ws, heads,
                                      jnp.bfloat16)
    targs = _t(args[:5], torch.bfloat16) + [torch.from_numpy(args[5])]
    ours = wa.window_attention_reference(*targs, _tmask(mask),
                                         window_size=ws, num_heads=heads)
    assert ours.dtype == torch.bfloat16
    x, wqkv, bqkv, wproj, _, rel = targs
    dx, grads = wa.window_attention_backward_reference(
        x, wqkv, bqkv, wproj, rel, _tmask(mask),
        torch.from_numpy(dy).to(torch.bfloat16), window_size=ws,
        num_heads=heads)

    def omc(a, b):
        a, b = np.float64(a).ravel(), np.float64(b).ravel()
        return 1.0 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    # bf16 rounds at the same points in both, sums in another order
    assert omc(ours.float().numpy(), ref) <= 1e-3
    for got, want in zip((dx,) + grads, ref_grads):
        assert omc(got.float().numpy(), want) <= 1e-3


def test_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    shape = GEOMETRIES[1]
    ws, heads = shape[4], shape[5]
    args, mask, _ = _inputs(shape, 0)
    before = wa.window_attention.launches, wa.window_attention_bwd.launches
    y = wa.window_attention(*_t(args), None, window_size=ws, num_heads=heads)
    ref = wa.window_attention_reference(*_t(args), None, window_size=ws,
                                        num_heads=heads)
    assert torch.equal(y, ref)
    assert (wa.window_attention.launches,
            wa.window_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="backward"):
        wa.window_attention(*_t(args), None, window_size=ws, num_heads=heads,
                            backward="xla")
    with pytest.raises(ValueError):
        wa.window_attention(*[a.to("meta") for a in _t(args)], None,
                            window_size=ws, num_heads=heads)


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_plain_backward_at_the_kernel_widths_and_a_ragged_window_count(
        c, heads):
    """``[3, 40, 40, C]`` with 8x8 windows shifted by 4 (75 windows, each
    with its own mask) at the three widths the backward kernel is built for,
    head_dim 32: the plain backward, which is that kernel's oracle on the
    card, against the Pallas custom VJP (interpreted). Operands rounded to
    bf16 as the JAX kernel rounds them; rtol = atol = 3e-4 of each result's
    largest entry for all but at most one entry in a thousand (an f32 sum
    taken in another order can round one bf16 operand the other way, which
    moves the entries it feeds by a bf16 ulp of one term), 2e-3 for those."""
    shape = (3, 40, 40, c, 8, heads)
    args, mask, dy = _inputs(shape, 4, seed=c)
    _, ref = _jax_fwd_and_vjp(args, mask, dy, 8, heads)
    x, wqkv, bqkv, wproj, _, rel = _t(args)
    dx, grads = wa.window_attention_backward_reference(
        x, wqkv, bqkv, wproj, rel, _tmask(mask), torch.from_numpy(dy),
        window_size=8, num_heads=heads, operand_dtype=torch.bfloat16)
    for name, got, want in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads, ref):
        assert got.shape == want.shape, name
        scale = max(1.0, float(np.abs(want).max()))
        excess = np.abs(got.numpy() - want) - 3e-4 * np.abs(want)
        assert float((excess > 3e-4 * scale).mean()) <= 1e-3, name
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=name)


def _bwd_case(c, heads, ws=8, h=16, dtype=torch.bfloat16):
    z = torch.zeros
    return dict(x=z(1, h, h, c, dtype=dtype), wqkv=z(c, 3 * c, dtype=dtype),
                bqkv=z(3 * c, dtype=dtype), wproj=z(c, c, dtype=dtype),
                rel_bias=z(heads, ws * ws, ws * ws), mask=None,
                dy=z(1, h, h, c, dtype=dtype)), dict(window_size=ws,
                                                     num_heads=heads)


@pytest.mark.parametrize("c,heads,ws,what", [
    (32, 1, 8, "built for C in"),     # head_dim 32, but not a model width
    (128, 4, 8, "built for C in"),    # head_dim 32, but not a model width
    (96, 6, 8, "built for C in"),     # head_dim 16
    (192, 3, 8, "built for C in"),    # head_dim 64
    (96, 3, 4, "8x8 windows"),
    (416, 13, 8, "C=416"),
])
def test_backward_kernel_refuses_on_the_argument_check_alone(c, heads, ws,
                                                             what):
    """What the backward kernel is not built for raises ValueError from
    ``check_bwd_args``, which runs before any build or launch."""
    args, kw = _bwd_case(c, heads, ws)
    with pytest.raises(ValueError, match=what):
        wa.check_bwd_args(**args, **kw)


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_backward_kernel_argument_check_passes_the_model_widths(c, heads):
    args, kw = _bwd_case(c, heads)
    wa.check_bwd_args(**args, **kw)
    with pytest.raises(ValueError, match="dy"):
        wa.check_bwd_args(**{**args, "dy": args["dy"].float()}, **kw)
    with pytest.raises(ValueError, match="dtype"):
        wa.check_bwd_args(**{**args, "x": args["x"].float()}, **kw)


def _fwd_case(c, heads, ws=8, h=16):
    args, kw = _bwd_case(c, heads, ws, h)
    del args["dy"]
    args["bproj"] = torch.zeros(c, dtype=torch.bfloat16)
    return args, kw


@pytest.mark.parametrize("c,heads,ws,what", [
    (64, 2, 8, "built for C in"),     # head_dim 32, but not a model width
    (96, 6, 8, "built for C in"),     # head_dim 16
    (192, 3, 8, "built for C in"),    # head_dim 64
    (32, 1, 8, "built for C in"),     # head_dim 32, below the model widths
    (96, 3, 4, "8x8 windows"),
])
def test_forward_kernel_refuses_on_the_argument_check_alone(c, heads, ws,
                                                            what):
    """The forward kernel is built for the widths of the backward and of the
    Swin-block kernels only: anything else raises ValueError from
    ``check_fwd_args``, which runs before any build or launch."""
    args, kw = _fwd_case(c, heads, ws)
    with pytest.raises(ValueError, match=what):
        wa.check_fwd_args(**args, **kw)


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_forward_kernel_argument_check_passes_the_model_widths(c, heads):
    args, kw = _fwd_case(c, heads)
    wa.check_fwd_args(**args, **kw)
    wa.check_fwd_args(**{**args, "mask": torch.zeros(4, 64, 64)}, **kw)
    with pytest.raises(ValueError, match="bproj"):
        wa.check_fwd_args(**{**args, "bproj": args["bproj"].float()}, **kw)
    with pytest.raises(ValueError, match="mask"):
        wa.check_fwd_args(**{**args, "mask": torch.zeros(3, 64, 64)}, **kw)
