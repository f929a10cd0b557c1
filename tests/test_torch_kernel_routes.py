"""The routes of the port's window and decoder-tail kernels, on the CPU.

``ops/swin_block.py::kernel_route`` (K1-K4) and
``ops/decoder_tail.py::kernel_route`` (K7) pick, from the element type and
the widths alone, the ``wgmma`` kernels built for the flagship shapes or the
general kernels (``csrc/window_any.cu``, ``csrc/decoder_tail_any.cu``) for
every other shape the TPU kernels take, and raise on what neither takes.
Here: the route of each shape, the argument check of each route, and that
the CUDA path's autograd functions launch the route's kernel and nothing
else: a failed general launch reaches the caller. The kernels themselves run
on a card only (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).

Several cases are the argument-check cases of
``test_torch_swin_block.py::test_kernel_arg_check_rejects`` and
``test_torch_window_attention.py``'s
``test_{forward,backward}_kernel_refuses_on_the_argument_check_alone``
rebuilt with arguments that agree with their shape (a rel-pos bias of
``n x n``, one element type): the wgmma kernels' check still refuses them,
and the general route takes them.
"""

import numpy as np
import pytest
import torch

from strajnet_tpu_torch import _build
from strajnet_tpu_torch.ops import decoder_tail as dtl
from strajnet_tpu_torch.ops import swin_block as sb
from strajnet_tpu_torch.ops import window_attention as wa
from strajnet_tpu_torch.ops.windows import shifted_window_mask

torch.set_num_threads(2)
BF, F32 = torch.bfloat16, torch.float32


def _block_args(c=96, heads=3, ws=8, hidden=None, dtype=BF, h=16,
                shift=True):
    """Zero Swin-block arguments whose shapes agree: x and the matrix weights
    (and qkv's and proj's biases) in ``dtype``, the rest f32."""
    hidden = 4 * c if hidden is None else hidden
    n = ws * ws
    z = lambda *s, dt=F32: torch.zeros(*s, dtype=dt)  # noqa: E731
    args = [z(2, h, h, c, dt=dtype), z(c, 3 * c, dt=dtype),
            z(3 * c, dt=dtype), z(c, c, dt=dtype), z(c, dt=dtype),
            z(heads, n, n), z(c), z(c), z(c), z(c),
            z(c, hidden, dt=dtype), z(hidden), z(hidden, c, dt=dtype), z(c)]
    mask = z((h // ws) ** 2, n, n) if shift else None
    return args, mask, z(2, 2)


def _route(args, ws, heads):
    x, w1 = args[0], args[10]
    return sb.kernel_route(x.dtype, x.shape[-1], heads, ws, w1.shape[-1])


# id -> (arguments of _block_args, route). The first six are the cases of
# test_kernel_arg_check_rejects rebuilt with agreeing arguments.
BLOCK_ROUTES = {
    "window": (dict(ws=4), "any"),
    "head_dim": (dict(c=96, heads=4), "any"),          # head_dim 24
    "width": (dict(c=128, heads=4), "any"),            # head_dim 32
    "head_dim_16": (dict(c=96, heads=6), "any"),
    "hidden": (dict(hidden=96), "any"),                # not in 64-col chunks
    "dtype": (dict(dtype=F32), "any"),
    "flagship_96": (dict(c=96, heads=3), "wgmma"),
    "flagship_192": (dict(c=192, heads=6, h=64), "wgmma"),
    "flagship_384": (dict(c=384, heads=12, h=32), "wgmma"),
    "flagship_f32": (dict(c=384, heads=12, h=32, dtype=F32), "any"),
    "ultra_tiny_stage0": (dict(c=8, heads=1, ws=4, hidden=16, dtype=F32),
                          "any"),
    "ultra_tiny_stage2": (dict(c=32, heads=4, ws=2, hidden=64, dtype=F32,
                               h=2, shift=False), "any"),
    "tiny": (dict(c=64, heads=4, ws=4, hidden=256, dtype=F32), "any"),
    "swin_b": (dict(c=128, heads=4, hidden=512), "any"),
    "window_7": (dict(c=96, heads=3, ws=7, h=14, dtype=F32), "any"),
    "window_12": (dict(c=128, heads=4, ws=12, h=24), "any"),
    "tokens_256": (dict(c=64, heads=2, ws=16, h=32), "any"),
    "head_dim_64": (dict(c=1024, heads=16, hidden=4096, h=8), "any"),
    "head_dim_4": (dict(c=16, heads=4, ws=4, dtype=F32), "any"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_ROUTES))
def test_block_route_and_its_argument_check(case):
    kw, want = BLOCK_ROUTES[case]
    args, mask, dp = _block_args(**kw)
    ws, heads = kw.get("ws", 8), kw.get("heads", 3)
    assert _route(args, ws, heads) == want
    check = sb.check_kernel_args if want == "wgmma" else sb.check_general_args
    check(*args, mask, dp, window_size=ws, num_heads=heads)
    check(*args, None, None, window_size=ws, num_heads=heads)
    if want == "any":   # what the wgmma kernels are not built for
        with pytest.raises(ValueError):
            sb.check_kernel_args(*args, mask, dp, window_size=ws,
                                 num_heads=heads)


# id -> (C, heads, window) of the window-attention cases; the first six are
# those of test_backward_kernel_refuses_on_the_argument_check_alone, then
# those of test_forward_kernel_refuses_on_the_argument_check_alone.
ATTENTION_ROUTES = {
    "bwd_c32": (32, 1, 8), "bwd_c128": (128, 4, 8),
    "bwd_head_dim_16": (96, 6, 8), "bwd_head_dim_64": (192, 3, 8),
    "bwd_window_4": (96, 3, 4), "bwd_c416": (416, 13, 8),
    "fwd_c64": (64, 2, 8), "fwd_head_dim_16": (96, 6, 8),
    "fwd_head_dim_64": (192, 3, 8), "fwd_c32": (32, 1, 8),
    "fwd_window_4": (96, 3, 4),
}


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("case", sorted(ATTENTION_ROUTES))
def test_attention_route_and_its_argument_check(case, dtype):
    c, heads, ws = ATTENTION_ROUTES[case]
    args, mask, _ = _block_args(c=c, heads=heads, ws=ws, dtype=dtype)
    x, wqkv, bqkv, wproj, bproj, rel = args[:6]
    assert sb.kernel_route(dtype, c, heads, ws) == "any"
    sb.check_general_attention_args(x, wqkv, bqkv, wproj, bproj, rel, mask,
                                    window_size=ws, num_heads=heads)
    sb.check_general_attention_args(x, wqkv, bqkv, wproj, None, rel, None,
                                    window_size=ws, num_heads=heads)
    kw = dict(window_size=ws, num_heads=heads)
    with pytest.raises(ValueError):
        wa.check_fwd_args(x, wqkv, bqkv, wproj, bproj, rel, mask, **kw)
    with pytest.raises(ValueError):
        wa.check_bwd_args(x, wqkv, bqkv, wproj, rel, mask, x, **kw)


# (C, heads, window, H = W): windows of 49 and 144 tokens (SWIN_VARIANTS'
# 7 and 12) and head sizes of 8, 16 and 64, alone and together, which the
# general route takes whatever its kernels' tiles are.
GENERAL_SHAPES = {
    "window_7": (96, 3, 7, 14),
    "window_12": (128, 4, 12, 24),
    "head_dim_8": (64, 8, 8, 16),
    "head_dim_16": (64, 4, 8, 16),
    "head_dim_64": (128, 2, 8, 16),
    "window_7_head_dim_8": (24, 3, 7, 14),
    "window_12_head_dim_64": (256, 4, 12, 24),
}


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("case", sorted(GENERAL_SHAPES))
def test_general_route_takes_windows_7_and_12_and_head_dims_8_to_64(case,
                                                                    dtype):
    c, heads, ws, h = GENERAL_SHAPES[case]
    args, mask, dp = _block_args(c=c, heads=heads, ws=ws, h=h, dtype=dtype)
    assert _route(args, ws, heads) == "any"
    sb.check_general_args(*args, mask, dp, window_size=ws, num_heads=heads)
    x, wqkv, bqkv, wproj, bproj, rel = args[:6]
    assert sb.kernel_route(dtype, c, heads, ws) == "any"
    sb.check_general_attention_args(x, wqkv, bqkv, wproj, bproj, rel, mask,
                                    window_size=ws, num_heads=heads)
    sb.check_general_attention_args(x, wqkv, bqkv, wproj, None, rel, None,
                                    window_size=ws, num_heads=heads)


@pytest.mark.parametrize("c,heads", [(96, 3), (192, 6), (384, 12)])
def test_attention_route_at_the_model_widths_is_wgmma(c, heads):
    assert sb.kernel_route(BF, c, heads, 8) == "wgmma"
    assert sb.kernel_route(F32, c, heads, 8) == "any"


def _transposed(args, mask, dp):
    args[1] = torch.zeros(3 * 96, 96, dtype=BF).t()
    return args, mask, dp


def _wrong_mask(args, mask, dp):
    return args, mask[:1], dp


def _wrong_rel(args, mask, dp):
    args[5] = torch.zeros(3, 64, 64)
    return args, mask, dp


def _mixed_types(args, mask, dp):
    args[0] = args[0].float()
    return args, mask, dp


def _f32_drop_path_bf16(args, mask, dp):
    return args, mask, dp.to(BF)


# id -> (arguments of _block_args, a change to the arguments, the message):
# what neither route takes, refused by kernel_route or by the route's check.
BOTH_REFUSE = {
    "tokens": (dict(c=64, heads=2, ws=32, h=32, shift=False), None,
               "at most 256 tokens"),
    "heads_split": (dict(c=96, heads=5), None, "heads \\* head_dim"),
    "head_dim_128": (dict(c=256, heads=2), None, "head_dim up to 64"),
    "channels": (dict(c=1088, heads=17, hidden=64, h=8), None,
                 "C up to 1024"),
    "hidden": (dict(c=96, heads=3, hidden=4160), None, "MLP width"),
    "f16": (dict(dtype=torch.float16), None, "float32 or bfloat16"),
    "layout": (dict(), _transposed, "contiguous"),
    "mask_shape": (dict(), _wrong_mask, "mask"),
    "mask_shape_any": (dict(ws=4, dtype=F32), _wrong_mask, "mask"),
    "rel_bias_shape": (dict(ws=4), _wrong_rel, "rel_bias"),
    "mixed_types": (dict(dtype=BF, ws=4), _mixed_types, "dtype"),
    "drop_path_type": (dict(dtype=F32, ws=4), _f32_drop_path_bf16, "dtype"),
    "grid": (dict(ws=8, h=12, dtype=F32, shift=False), None,
             "multiples of"),
}


@pytest.mark.parametrize("case", sorted(BOTH_REFUSE))
def test_both_routes_refuse(case):
    kw, change, what = BOTH_REFUSE[case]
    args, mask, dp = _block_args(**kw)
    if change is not None:
        args, mask, dp = change(args, mask, dp)
    ws, heads = kw.get("ws", 8), kw.get("heads", 3)
    with pytest.raises(ValueError, match=what):
        route = _route(args, ws, heads)
        check = (sb.check_kernel_args if route == "wgmma"
                 else sb.check_general_args)
        check(*args, mask, dp, window_size=ws, num_heads=heads)


def test_the_route_is_pure(monkeypatch):
    """kernel_route reads no tensor and builds nothing: it answers with
    ``_build``'s loaders patched to fail."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    assert sb.kernel_route(BF, 96, 3, 8, 384) == "wgmma"
    assert sb.kernel_route(F32, 8, 1, 4, 16) == "any"
    assert dtl.kernel_route(BF, 96, 48, 2) == "wgmma"
    assert dtl.kernel_route(F32, 96, 48, 2) == "any"


# (dtype, Cin, Cmid, Cout) -> route; the first five are the cases of
# test_torch_decoder_tail.py::test_kernel_refuses_on_the_argument_check_alone
# that the general kernel takes.
TAIL_ROUTES = {
    "f32": ((F32, 96, 48), "any"),
    "cin_24": ((BF, 24, 48), "any"),
    "cin_1024": ((BF, 1024, 48), "any"),
    "cin_32_cmid_16": ((BF, 32, 16), "any"),
    "cmid_24": ((BF, 96, 24), "any"),
    "flagship": ((BF, 96, 48), "wgmma"),
    "f32_64_32": ((F32, 64, 32), "any"),
    "odd": ((F32, 5, 3), "any"),
}


def _tail_case(dtype, cin, cmid, cout=2, h=8, w=8):
    return (torch.zeros(1, h, w, cin, dtype=dtype),
            torch.zeros(3, 3, cin, cmid), torch.zeros(3, 3, cmid, cout))


@pytest.mark.parametrize("case", sorted(TAIL_ROUTES))
def test_tail_route_and_its_argument_check(case):
    (dtype, cin, cmid), want = TAIL_ROUTES[case]
    assert dtl.kernel_route(dtype, cin, cmid, 2) == want
    for h, w in ((8, 8), (5, 11)):
        args = _tail_case(dtype, cin, cmid, h=h, w=w)
        if want == "wgmma":
            dtl.check_launch_args(*args)
        else:
            dtl.check_general_args(*args)
            with pytest.raises(ValueError):
                dtl.check_launch_args(*args)


@pytest.mark.parametrize("case,what", [
    (dict(cout=4), "two output channels"),      # the JAX gate's cout == 2
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(h=0), "non-empty"),
])
def test_both_tail_routes_refuse(case, what):
    kw = dict(dtype=BF, cin=96, cmid=48)
    kw.update(case)
    with pytest.raises(ValueError, match=what):
        dtl.check_general_args(*_tail_case(**kw))


def _boom(*args, **kwargs):
    raise RuntimeError("the general kernels failed")


def _block_call():
    rng = np.random.default_rng(0)
    args, mask, dp = _block_args(c=8, heads=1, ws=4, hidden=16, dtype=F32)
    args = [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
            .to(a.dtype) for a in args]
    return lambda: sb._SwinBlockFn.apply(4, 1, 1e-5, False, mask, dp, *args)


def _attention_call():
    args, mask, _ = _block_args(c=8, heads=1, ws=4, dtype=F32)
    return lambda: wa._WindowAttentionFn.apply(4, 1, False, mask, *args[:6])


def _tail_call():
    x, w_up, w_out = _tail_case(F32, 8, 4)
    return lambda: dtl._DecoderTailFn.apply(x, w_up, torch.zeros(4), w_out,
                                            torch.zeros(2))


# kernel -> (module, general launcher, wgmma launcher, call, counter)
CALLS = {
    "swin_block": (sb, "_launch_any_fwd", "_launch_wgmma_fwd", _block_call,
                   sb.swin_block),
    "window_attention": (wa, "_launch_any_fwd", "_launch_wgmma_fwd",
                         _attention_call, wa.window_attention),
    "decoder_tail": (dtl, "_launch_any", "_launch_wgmma", _tail_call,
                     dtl.decoder_tail),
}


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_a_failed_general_launch_reaches_the_caller(monkeypatch, kernel):
    """The CUDA path's autograd function on an f32 shape (the general route)
    with the general launcher raising: the error reaches the caller, the
    wgmma launcher is never asked, no counter moves."""
    module, any_name, wgmma_name, make_call, counter = CALLS[kernel]
    monkeypatch.setattr(module, any_name, _boom)
    monkeypatch.setattr(module, wgmma_name, lambda *a: pytest.fail(
        "the wgmma launcher was asked"))
    before = counter.launches, counter.launches_any
    with pytest.raises(RuntimeError, match="the general kernels failed"):
        make_call()()
    assert (counter.launches, counter.launches_any) == before


def test_the_autograd_functions_dispatch_by_route(monkeypatch):
    """bf16 at the flagship widths goes to the wgmma launcher, the same
    shape in f32 to the general one."""
    asked = []

    def recorder(route):
        def launch(args, *rest):
            asked.append(route)
            return torch.zeros_like(args[0])
        return launch

    monkeypatch.setattr(sb, "_launch_any_fwd", recorder("any"))
    monkeypatch.setattr(sb, "_launch_wgmma_fwd", recorder("wgmma"))
    for dtype in (BF, F32):
        args, mask, dp = _block_args(dtype=dtype)
        sb._SwinBlockFn.apply(8, 3, 1e-5, False, mask, dp, *args)
    assert asked == ["wgmma", "any"]


def test_window_masks_of_every_window_the_route_takes():
    """The SW-MSA mask the general route reads, at windows of 2 to 16: one
    [n, n] block per window, 0 or -100."""
    for ws, h in ((2, 4), (4, 16), (7, 14), (12, 24), (16, 32)):
        m = shifted_window_mask(h, h, ws, ws // 2)
        assert m.shape == ((h // ws) ** 2, ws * ws, ws * ws)
        assert set(np.unique(m)) <= {0.0, -100.0}
