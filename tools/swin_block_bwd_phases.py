"""Where the persistent wgmma kernels spend their clocks: one window of the
Swin-block backward (K2) and of the window-attention backward (K4), one tile
of the decoder tail (K7).

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 tools/swin_block_bwd_phases.py [--kernels k2,k4,k7]

Builds ``csrc/swin_block_bwd.cu``, ``csrc/window_attention.cu`` and
``csrc/decoder_tail.cu`` with ``-DSWIN_PHASE_CLOCKS`` (the first warpgroup of
block 0 then sums ``clock64`` differences per phase over its windows or
tiles), runs K2 and K4 once per flagship geometry at batch 16 and K7 at the
flagship tail, and prints each phase's share, the clocks per window or tile
and the time of the whole call. The instrumented build is a few percent
slower than the plain one. Beside K2, the time of the same MLP backward (fc1
-> gelu -> fc2 on ``[tokens, C]`` bf16: both input gradients and both weight
gradients) through autograd and cuBLAS, the yardstick for K2's MLP phases.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.ops import decoder_tail as dtl  # noqa: E402
from strajnet_tpu_torch.ops import swin_block as sb  # noqa: E402
from strajnet_tpu_torch.ops import window_attention as wa  # noqa: E402
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402
from strajnet_tpu_torch.tools.timing import gpu_identity  # noqa: E402

K2_PHASES = ("attention half, recomputed", "dz2", "MLP epilogue (gelu, dz1)",
             "dh2", "LN2 backward", "d(merged) and heads", "dh1",
             "LN1 backward", "MLP products (z1, dg1)")
K4_PHASES = ("x into the operand and scratch",
             "q|k|v, softmax, P v per head, recomputed",
             "dy into the operand and scratch, dbproj",
             "d(merged) and the heads' backward", "dx = dqkv @ wqkv^T")
K7_PHASES = ("wait for the input tile", "main product (12 ring stages)",
             "wait for the other warpgroup's output conv",
             "bias, elu, mask, rounding into the intermediate",
             "wait for the other warpgroup's entries",
             "output conv (48 wgmma n8)", "output stores")
N_CLOCKS = 9   # kPhases of csrc/swin_block_sm90.cuh
GEOMETRIES = ((128, 96, 3), (64, 192, 6), (32, 384, 12))
BATCH = 16


def timed(fn, read_clocks):
    """Runs ``fn`` once warm, then once between CUDA events with the phase
    clocks zeroed before: (ms, clocks)."""
    clocks = (ctypes.c_longlong * N_CLOCKS)()
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        read_clocks(clocks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        read_clocks(clocks)
    return start.elapsed_time(end), list(clocks)


def report(title, ms, clocks, phases, units, unit):
    """``units`` windows or tiles went through block 0's first warpgroup."""
    total = sum(clocks)
    print(f"{title}: call {ms:.4f} ms, {total // units} clocks per {unit} "
          f"(one warpgroup, {units} {unit}s)")
    for name, value in zip(phases, clocks):
        print(f"    {name:48s} {100.0 * value / total:5.1f} %")
    return total


def block_inputs(h, c, heads, g):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    bf = torch.bfloat16
    args = (r(BATCH, h, h, c).to(bf),
            r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c, scale=0.1).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c, scale=0.1).to(bf),
            r(heads, 64, 64, scale=0.3), 1 + r(c, scale=0.1),
            r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 4 * c, scale=c ** -0.5).to(bf), r(4 * c, scale=0.1),
            r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), r(c, scale=0.1))
    mask = torch.from_numpy(shifted_window_mask(h, h, 8, 4)).cuda()
    dp = torch.rand(BATCH, 2, generator=g, device="cuda") * 1.2
    return args, mask, dp, r(BATCH, h, h, c).to(bf)


def windows_of_block0(h):
    windows = BATCH * (h // 8) ** 2
    blocks = min(torch.cuda.get_device_properties(0).multi_processor_count,
                 (windows + 1) // 2)
    return -(-((windows + 1) // 2) // blocks)


def swin_block_bwd_phases(g):
    lib = _build.load_library("swin_block_bwd")
    for h, c, heads in GEOMETRIES:
        args, mask, dp, dy = block_inputs(h, c, heads, g)
        kw = dict(window_size=8, num_heads=heads)
        ms, clocks = timed(
            lambda: sb.swin_block_bwd(*args, mask, dp, dy, **kw),
            lib.swin_block_bwd_phase_clocks)
        total = report(f"K2 [{BATCH},{h},{h},{c}]", ms, clocks, K2_PHASES,
                       windows_of_block0(h), "window")
        mlp = sum(clocks[i] for i in (1, 2, 3, 8)) / total
        tokens = BATCH * h * h
        bf = torch.bfloat16
        x2 = torch.randn(tokens, c, generator=g, device="cuda").to(bf) \
            .requires_grad_(True)
        w1, b1, w2, b2 = (t.detach().requires_grad_(True) for t in args[10:14])
        y = torch.nn.functional.gelu(
            (x2 @ w1 + b1.to(bf)).float(), approximate="tanh").to(bf) @ w2 \
            + b2.to(bf)
        dy2 = dy.reshape(tokens, c)
        grad = lambda: torch.autograd.grad(  # noqa: E731
            y, (x2, w1, b1, w2, b2), dy2, retain_graph=True)
        grad()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            grad()
        end.record()
        torch.cuda.synchronize()
        print(f"    MLP phases (dz2, products, epilogue, dh2): {100 * mlp:.1f} % "
              f"of the window kernel; the MLP backward by autograd and cuBLAS "
              f"(dx, dw1, db1, dw2, db2; z1 and g1 saved, not recomputed): "
              f"{start.elapsed_time(end) / 5:.4f} ms")


def window_attention_bwd_phases(g):
    lib = _build.load_library("window_attention")
    for h, c, heads in GEOMETRIES:
        args, mask, _, dy = block_inputs(h, c, heads, g)
        x, wqkv, bqkv, wproj, _, rel_bias = args[:6]
        ms, clocks = timed(
            lambda: wa.window_attention_bwd(x, wqkv, bqkv, wproj, rel_bias,
                                            mask, dy, window_size=8,
                                            num_heads=heads),
            lib.window_attention_bwd_phase_clocks)
        report(f"K4 [{BATCH},{h},{h},{c}]", ms, clocks[:len(K4_PHASES)],
               K4_PHASES, windows_of_block0(h), "window")


def decoder_tail_phases(g):
    lib = _build.load_library("decoder_tail")
    n, h, cin, cmid = BATCH * 8, 128, 96, 48

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    args = (r(n, h, h, cin).to(torch.bfloat16),
            r(3, 3, cin, cmid, scale=(9 * cin) ** -0.5), r(cmid, scale=0.1),
            r(3, 3, cmid, 2, scale=(9 * cmid) ** -0.5), r(2, scale=0.1))
    ms, clocks = timed(lambda: dtl.decoder_tail(*args),
                       lib.decoder_tail_phase_clocks)
    tiles = n * -(-h // 15) * -(-h // 7)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    report(f"K7 [{n},{h},{h},{cin}]", ms, clocks[:len(K7_PHASES)], K7_PHASES,
           -(-tiles // blocks), "tile")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default="k2,k4,k7",
                        help="comma-separated subset of k2,k4,k7")
    chosen = parser.parse_args(argv).kernels.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(gpu_identity())
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DSWIN_PHASE_CLOCKS",)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, fn in (("k2", swin_block_bwd_phases),
                     ("k4", window_attention_bwd_phases),
                     ("k7", decoder_tail_phases)):
        if name in chosen:
            fn(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
