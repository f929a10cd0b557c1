"""Where one window of the Swin-block backward kernel (K2) spends its clocks.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 tools/swin_block_bwd_phases.py

Builds ``csrc/swin_block_bwd.cu`` with ``-DSWIN_PHASE_CLOCKS`` (the first
warpgroup of block 0 then sums ``clock64`` differences per phase over its
windows), runs the backward once per flagship geometry at batch 16 and prints
each phase's share, the clocks per window and the time of the whole call.
The instrumented build is a few percent slower than the plain one. Beside
it, the time of the same MLP backward (fc1 -> gelu -> fc2 on ``[tokens, C]``
bf16: both input gradients and both weight gradients) through autograd and
cuBLAS, the yardstick for K2's MLP phases.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.ops import swin_block as sb  # noqa: E402
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402

PHASES = ("attention half, recomputed", "dz2", "MLP epilogue (gelu, dz1)",
          "dh2", "LN2 backward", "d(merged) and heads", "dh1", "LN1 backward",
          "MLP products (z1, dg1)")
GEOMETRIES = ((128, 96, 3), (64, 192, 6), (32, 384, 12))
BATCH = 16


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DSWIN_PHASE_CLOCKS",)
    lib = sb._lib("swin_block_bwd")
    lib.swin_block_bwd_phase_clocks.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_longlong * len(PHASES))()
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    bf = torch.bfloat16
    for h, c, heads in GEOMETRIES:
        args = (r(BATCH, h, h, c).to(bf),
                r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c, scale=0.1).to(bf),
                r(c, c, scale=c ** -0.5).to(bf), r(c, scale=0.1).to(bf),
                r(heads, 64, 64, scale=0.3), 1 + r(c, scale=0.1),
                r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
                r(c, 4 * c, scale=c ** -0.5).to(bf), r(4 * c, scale=0.1),
                r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), r(c, scale=0.1))
        mask = torch.from_numpy(shifted_window_mask(h, h, 8, 4)).cuda()
        dp = torch.rand(BATCH, 2, generator=g, device="cuda") * 1.2
        dy = r(BATCH, h, h, c).to(bf)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            sb.swin_block_bwd(*args, mask, dp, dy, **kw)   # warm-up
            torch.cuda.synchronize()
            lib.swin_block_bwd_phase_clocks(clocks)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sb.swin_block_bwd(*args, mask, dp, dy, **kw)
            end.record()
            torch.cuda.synchronize()
            lib.swin_block_bwd_phase_clocks(clocks)
        total = sum(clocks)
        windows = BATCH * (h // 8) ** 2
        blocks = min(torch.cuda.get_device_properties(0).multi_processor_count,
                     (windows + 1) // 2)
        mine = -(-((windows + 1) // 2) // blocks)   # windows of block 0's WG 0
        print(f"K2 [{BATCH},{h},{h},{c}]: call {start.elapsed_time(end):.4f} ms, "
              f"{total // mine} clocks per window (one warpgroup, {mine} "
              f"windows)")
        for name, value in zip(PHASES, clocks):
            print(f"    {name:28s} {100.0 * value / total:5.1f} %")
        mlp = sum(clocks[i] for i in (1, 2, 3, 8)) / total
        tokens = BATCH * h * h
        x2 = r(tokens, c).to(bf).requires_grad_(True)
        w1, b1, w2, b2 = (t.detach().requires_grad_(True) for t in args[10:14])
        y = torch.nn.functional.gelu(
            (x2 @ w1 + b1.to(bf)).float(), approximate="tanh").to(bf) @ w2 \
            + b2.to(bf)
        dy2 = dy.reshape(tokens, c)
        grad = lambda: torch.autograd.grad(  # noqa: E731
            y, (x2, w1, b1, w2, b2), dy2, retain_graph=True)
        grad()
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            grad()
        end.record()
        torch.cuda.synchronize()
        print(f"    MLP phases (dz2, products, epilogue, dh2): {100 * mlp:.1f} % "
              f"of the window kernel; the MLP backward by autograd and cuBLAS "
              f"(dx, dw1, db1, dw2, db2; z1 and g1 saved, not recomputed): "
              f"{start.elapsed_time(end) / 5:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
