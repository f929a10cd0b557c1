"""Smoke test of the PyTorch port of STrajNet on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``strajnet_tpu_torch/csrc`` (one nvcc
process per source, started together) and holds each against its plain
PyTorch version at the shapes of the flagship model (batch 16, bf16):

- K1 ``swin_block`` and K2 ``swin_block_bwd`` at the four Swin-block
  geometries, K3 ``window_attention`` and K4 ``window_attention_bwd`` at the
  same four; all four also at a ragged window count (``[3, 40, 40, C]``:
  75 windows for blocks that take two at a time) and twice on the same
  inputs (the forwards and dx bit-identical); K3 and K4 refusing C = 64
  before a launch; the split-K pass that sums K2's and K4's weight
  gradients alone against ``A.float().T @ B.float()``;
- K5 ``warp_gather_fwd`` and K6 ``warp_gather_bwd`` at ``[128, 256, 256, 1]``,
  K6 also on a smooth flow (neighbouring queries share corners), on queries
  at the rows where its bands meet, and at several band counts;
- K7 ``decoder_tail`` at ``[128, 128, 128, 96] -> [128, 256, 256, 2]``, at
  image sides one under, at and one over what its tiles own, and twice.

Then it drives the port's paths through their entry points with seeded
random weights at ``STRAJNET_CONFIG``, batch 16: the forward through the
kernel and through the plain path; three synthetic batches through
``infer.runner.run_shard``, whose submission it parses back; and three
training steps through ``train.state.create_train_state`` and
``train.step.make_train_step``, whose first step it repeats with the
``"block_fwd"`` mode and with the plain path (loss, whole gradient and
every parameter's gradient against the kernel path's), then in the ``"attn"``
mode against the plain path and once more with ``remat_encoder`` against the
``"attn"`` step without it (peak memory of both); and the gradient of
``core.sampling.flow_warp_origin`` with respect to the warped image, the one
path that reaches K6 (the loss warps ground truth). The evaluation path
follows: two synthetic batches through ``infer.evaluate.evaluate_batches``
(the eval step: forward, loss, challenge metrics) on a model with
``use_pallas_attention="attn"`` and the decoder-tail kernel, so K3 runs in
all eight Swin blocks and K7 in both tails, held against the same loop on
the plain path, and timed once more on the compact feed (uint8 grids, f16
map) that ``infer/evaluate.py`` reads by default. The launch counters are
set to zero just before each path and read just after. Any failed check
raises and the script exits non-zero. The last line is a JSON object naming
the device; the line before it lists each kernel with its launches on those
paths, its error against the plain version, its times and its bound.

``--phases`` runs a subset (kernels, forward, serve, train, eval) while
developing; with no arguments every phase runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.core.sampling import flow_warp_origin  # noqa: E402
from strajnet_tpu_torch.config import (  # noqa: E402
    STRAJNET_CONFIG, WAYMO_TASK_CONFIG, LossConfig, TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from strajnet_tpu_torch.infer.evaluate import evaluate_batches  # noqa: E402
from strajnet_tpu_torch.infer.proto import iter_fields  # noqa: E402
from strajnet_tpu_torch.infer.runner import run_shard  # noqa: E402
from strajnet_tpu_torch.infer.submission import (  # noqa: E402
    SCENARIO_ID, SCENARIO_WAYPOINTS, SUBMISSION_SCENARIO_PREDICTIONS)
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params  # noqa: E402
from strajnet_tpu_torch.objective.loss import (  # noqa: E402
    OGMFlowLoss, split_pred_waypoints, true_waypoints_from_batch)
from strajnet_tpu_torch.objective.metrics import (  # noqa: E402
    apply_sigmoid_to_occupancy_logits, compute_occupancy_flow_metrics,
    print_metrics)
from strajnet_tpu_torch.ops import window_attention as wa  # noqa: E402
from strajnet_tpu_torch.ops import decoder_tail as dtl  # noqa: E402
from strajnet_tpu_torch.ops.decoder_tail import (  # noqa: E402
    decoder_tail, decoder_tail_phase, decoder_tail_reference)
from strajnet_tpu_torch.ops.swin_block import (  # noqa: E402
    GRAD_NAMES, atb_accum, kernel_smem_bytes, swin_block,
    swin_block_backward_reference, swin_block_bwd, swin_block_reference,
    token_blocked)
from strajnet_tpu_torch.ops.warp_gather import (  # noqa: E402
    band_edge_rows, bwd_band_rows, gather_corners_reference, scatter_corners_reference,
    warp_gather_bwd, warp_gather_fwd)
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402
from strajnet_tpu_torch.train.state import create_train_state  # noqa: E402
from strajnet_tpu_torch.train.step import (  # noqa: E402
    ensure_f32, make_eval_step, make_predict_step, make_train_step)

BATCH = 16
KERNEL_SOURCES = ("swin_block", "swin_block_bwd", "warp_gather",
                  "window_attention", "decoder_tail")
# Published peaks of one H100 SXM: bf16 dense tensor-core rate and HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# K1 vs its plain version, both bf16 with f32 accumulation but rounding at
# different points: at most 4 bf16 ulps of the largest output, and 1 - cos
# at bf16 noise level.
K1_MAX_ABS_REL = 2.0 ** -5
K1_ONE_MINUS_COS = 1e-4
# K2 vs its plain version, for dx and each of the 13 gradients. Both round
# at the same points, but their f32 sums run in another order (and with
# atomics, in an order that varies), so a bf16 operand can round the other
# way; the parameter gradients then sum 10^5-10^6 such tokens. Limits are
# relative to the largest entry of the plain result: 2 bf16 ulps of it (dx
# is bf16), and 1 - cos at bf16 noise level.
K2_MAX_ABS_REL = 2.0 ** -6
K2_ONE_MINUS_COS = 1e-4
# The split-K pass against the f32 product of the same bf16 operands: only
# the order of the f32 sums differs (a few hundred token slices added with
# atomics), relative to the largest entry of the product.
SPLIT_K_MAX_ABS_REL = 1e-5
# K2's parameter gradients in two runs on the same inputs: f32 atomics in an
# order that varies, relative to the largest entry.
K2_REPEAT_MAX_ABS_REL = 1e-4
# K3 and K4 against their plain versions, which round at the kernels' own
# points; f32 sums run in another order (K4's with atomics), so a bf16
# operand can round the other way. The limits are K1's and K2's.
K3_MAX_ABS_REL = 2.0 ** -5
K3_ONE_MINUS_COS = 1e-4
K4_MAX_ABS_REL = 2.0 ** -6
K4_ONE_MINUS_COS = 1e-4
# K4's parameter gradients in two runs on the same inputs: f32 atomics in an
# order that varies, relative to the largest entry.
K4_REPEAT_MAX_ABS_REL = 1e-6
# K7 against the naive composition in bf16 (cuDNN rounds its sums once, as
# the kernel does, but sums in another order) and, at a small shape, against
# the f32 composition of the same bf16 inputs with TF32 off.
K7_MAX_ABS_REL = 2.0 ** -6
K7_ONE_MINUS_COS = 1e-4
# The eval path, kernels ("attn" + decoder-tail kernel) vs the plain path,
# means over two batches. Losses and metrics are held relative to the plain
# path's value (with seed-0 weights the AUCs and IoUs are small numbers, so
# an absolute limit would hold nothing); the absolute term only serves a
# metric whose value is 0 on both paths. Four times the worst readings on an
# H100: loss 2.6e-4 (observed_xe), metric 4.8e-4 (observed_auc; flow_epe
# 1.8e-4).
EVAL_LOSS_RTOL = 2e-3
EVAL_METRIC_RTOL = 2e-3
EVAL_METRIC_ATOL = 1e-6
# K5 is an exact copy of image values. K6 sums f32 with atomics in varying
# order: relative to the largest entry of the plain scatter.
K5_MAX_ABS = 0.0
K6_MAX_ABS_REL = 1e-5
# Whole bf16 forward, kernel path vs plain path: the block-level rounding
# differences pass through ~60 more bf16 layers.
FWD_ONE_MINUS_COS = 1e-3
# bf16 kernel forward vs the f32 plain forward of the same weights.
F32_ONE_MINUS_COS = 1e-3
# First training step, "block_fwd" and plain path vs the kernel path: the
# total loss (bf16 forwards that differ by rounding only), the whole
# gradient vector by cosine, and every parameter's gradient by cosine (the
# worst leaf). "block_fwd" shares the kernel path's forward, so its loss is
# the same number and its gradients differ by K2's sum order only; the plain
# path also rounds its forward elsewhere. The limits sit a few times above
# the readings on an H100 (loss 0 and 1.9e-3; gradient 4.3e-7 and 1.9e-5;
# worst leaf, a rel-pos bias table each time, 1.8e-4 and 6.6e-4). The
# "attn" step with remat_encoder against the same step without: the same
# kernels on the same inputs, so the same loss, and gradients that differ
# only by the order of f32 atomics.
STEP_LOSS_RTOL = {"block_fwd": 1e-6, False: 1e-2, "remat": 0.0}
STEP_GRAD_ONE_MINUS_COS = {"block_fwd": 1e-5, False: 1e-4, "remat": 1e-6}
STEP_LEAF_ONE_MINUS_COS = {"block_fwd": 1e-3, False: 3e-3, "remat": 1e-5}
# Its gradient is zero but for rounding (it shifts every logit of a softmax
# row alike), so its direction is noise.
ZERO_GRAD_LEAVES = ("fg_msa_layer.proj_k.bias",)
# (H = W, C, heads, shift, blocks of this geometry in one forward)
GEOMETRIES = ((128, 96, 3, 0, 2), (128, 96, 3, 4, 2), (64, 192, 6, 4, 2),
              (32, 384, 12, 4, 2))
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")
PHASES = ("kernels", "forward", "serve", "train", "eval")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def one_minus_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return 1.0 - float((a @ b) / (a.norm() * b.norm()))


# Clock cycles the card idles per timed launch while the host enqueues
# (about 1 ms at the H100's clock): see cuda_ms.
AHEAD_CYCLES = 2_000_000


def cuda_ms(fn, iters: int = 20, ahead: bool = False) -> float:
    """Mean ms of ``fn`` over ``iters`` runs by CUDA events, after one
    warm-up. With ``ahead`` the card first sleeps while the host enqueues
    all the runs, so that the reading is the device's time alone: a kernel
    of 0.1 ms is otherwise paced by its wrapper's host work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(AHEAD_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 20) -> float:
    """The device's time of one run of ``fn`` (a kernel, its plain version
    or a PyTorch call), host work between runs hidden."""
    return cuda_ms(fn, iters, ahead=True)


def bound(flops: float, nbytes: float):
    """(least ms on the card, which of the two rates sets it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def block_work(h: int, c: int, heads: int, shift: int, backward: bool):
    """FLOPs and bytes one Swin block at batch 16 needs, forward or backward.

    Forward, per token: 24 C^2 for the four weight products and 256 C for
    the two 64-token attention products. The backward recomputes the forward
    and runs two products for each of the forward's (72 C^2 + 768 C). Bytes:
    x in and out (and dy in) in bf16, the parameters in their dtypes, mask
    and drop-path once; the backward also writes the f32 gradients.
    """
    tokens = BATCH * h * h
    flops = tokens * (24 * c * c + 256 * c) * (3 if backward else 1)
    params = 12 * c * c * 2 + 4 * c * 2 + (4 + 4 + 1) * c * 4 \
        + heads * 4096 * 4
    extra = (h // 8) ** 2 * 4096 * 4 * (1 if shift else 0) + BATCH * 2 * 4
    acts = tokens * c * 2 * (3 if backward else 2)
    grads = (12 * c * c + 13 * c + heads * 4096) * 4 if backward else 0
    return flops, acts + params + extra + grads


def block_inputs(h: int, c: int, heads: int, shift: int,
                 g: torch.Generator, batch: int = BATCH):
    dev, bf = "cuda", torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    args = (r(batch, h, h, c).to(bf),
            r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c, scale=0.1).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c, scale=0.1).to(bf),
            r(heads, 64, 64, scale=0.3),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 4 * c, scale=c ** -0.5).to(bf), r(4 * c, scale=0.1),
            r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), r(c, scale=0.1))
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(dev)
            if shift else None)
    dp = torch.rand(batch, 2, generator=g, device=dev) * 1.2
    return args, mask, dp


def kernel_resources(log: str, kernel: str) -> dict:
    """{C: (registers, spill bytes)} of a kernel templated on the channel
    width (C = 0 for one that is not), from nvcc's ``-Xptxas -v`` output: the
    entry's own two lines (the functions it calls without inlining follow
    with lines of their own)."""
    found, width = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            width = None
            if kernel + "ILi" in line:
                width = int(line.split(kernel + "ILi")[1].split("E")[0])
            elif kernel + "E" in line:
                width = 0
            if width is not None:
                found[width] = [None, None]
        elif width is not None and "spill stores" in line:
            if found[width][1] is None:
                found[width][1] = int(
                    line.split("bytes spill stores")[0].split(",")[-1])
        elif width is not None and "Used" in line and "registers" in line:
            if found[width][0] is None:
                found[width][0] = int(
                    line.split("Used")[1].split("registers")[0])
    return {c: tuple(v) for c, v in sorted(found.items())}


def check_split_k(g: torch.Generator) -> dict:
    """The split-K pass ``dW += A^T B`` alone at K2's four operand shapes of
    the first and the last flagship stage, from the token-blocked layout the
    backward window kernels (K2, K4) write."""
    total, total_bound = 0.0, 0.0
    for h, c in ((128, 96), (32, 384)):
        tokens = BATCH * h * h
        for m, n in ((c, 3 * c), (c, c), (c, 4 * c), (4 * c, c)):
            a = torch.randn(tokens, m, generator=g,
                            device="cuda").to(torch.bfloat16)
            b = torch.randn(tokens, n, generator=g,
                            device="cuda").to(torch.bfloat16)
            want = a.float().t() @ b.float()
            a, b = token_blocked(a), token_blocked(b)
            got = atb_accum(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= SPLIT_K_MAX_ABS_REL * scale,
                  f"split-K [{tokens},{m}]^T [{tokens},{n}] max_abs_err "
                  f"{err} <= {SPLIT_K_MAX_ABS_REL} * {scale}")
            dst = torch.zeros(m, n, device="cuda")
            ms = kernel_ms(lambda: atb_accum(a, b, dst), iters=10)
            bound_ms, by = bound(2.0 * m * n * tokens,
                                 (m + n) * tokens * 2 + m * n * 4)
            total += ms
            total_bound += bound_ms
            print(f"split-K [{tokens},{m}]^T [{tokens},{n}]: "
                  f"max_abs_err={err:.3e} (max|ref|={scale:.1f}) "
                  f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({by})")
    return dict(ms=total, bound_ms=total_bound)


def check_ragged_and_repeat(g: torch.Generator) -> None:
    """K1 and K2 at [3, 40, 40, C], shift 4: 75 windows, an odd count for
    blocks that take two per step, each window with its own mask; and both
    kernels twice on the same inputs."""
    for c, heads in ((96, 3), (192, 6), (384, 12)):
        args, mask, dp = block_inputs(40, c, heads, 4, g, batch=3)
        dp[2, :] = 0.0
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            y = swin_block(*args, mask, dp, **kw)
            y2 = swin_block(*args, mask, dp, **kw)
            dx, grads = swin_block_bwd(*args, mask, dp, dy, **kw)
            dx2, grads2 = swin_block_bwd(*args, mask, dp, dy, **kw)
            torch.cuda.synchronize()
            ref = swin_block_reference(*args, mask, dp, **kw)
            rdx, rgrads = swin_block_backward_reference(*args, mask, dp, dy,
                                                        **kw)
        check(torch.equal(y, y2), f"K1 C={c}: two runs bit-identical")
        check(torch.equal(dx, dx2), f"K2 C={c}: dx of two runs bit-identical")
        check(torch.equal(dx[2], dy[2]), f"K2 C={c} ragged: dx == dy where "
              "both branches are dropped")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        check(err <= K1_MAX_ABS_REL * scale and
              one_minus_cos(y, ref) <= K1_ONE_MINUS_COS,
              f"K1 ragged C={c}: max_abs_err {err} <= {K1_MAX_ABS_REL} * "
              f"{scale}")
        worst, drift = 0.0, 0.0
        for name, got, again, want in zip(("dx",) + GRAD_NAMES, (dx,) + grads,
                                          (dx2,) + grads2, (rdx,) + rgrads):
            gscale = float(want.float().abs().max())
            gerr = float((got.float() - want.float()).abs().max())
            check(gerr <= K2_MAX_ABS_REL * gscale and
                  one_minus_cos(got, want) <= K2_ONE_MINUS_COS,
                  f"K2 ragged C={c} {name}: max_abs_err {gerr} <= "
                  f"{K2_MAX_ABS_REL} * {gscale}")
            rep = float((got.float() - again.float()).abs().max()) / gscale
            check(rep <= K2_REPEAT_MAX_ABS_REL,
                  f"K2 C={c} {name}: two runs within "
                  f"{K2_REPEAT_MAX_ABS_REL}: {rep}")
            worst, drift = max(worst, gerr / gscale), max(drift, rep)
        print(f"ragged [3,40,40,{c}] (75 windows), twice: K1 max_abs_err="
              f"{err} (max|ref|={scale}), bit-identical; K2 worst "
              f"max_abs_err/max|ref|={worst:.2e}, dx bit-identical, "
              f"gradients of two runs within {drift:.1e}")


def check_attention_ragged_and_repeat(g: torch.Generator) -> None:
    """K3 and K4 at [3, 40, 40, C], shift 4 (75 windows: the last step of
    the persistent kernels has one window for two warpgroups), twice on the
    same inputs; and K3 and K4 refusing a width they are not built for
    before any launch."""
    for c, heads in ((96, 3), (192, 6), (384, 12)):
        args, mask, _ = block_inputs(40, c, heads, 4, g, batch=3)
        x, wqkv, bqkv, wproj, bproj, rel_bias = args[:6]
        dy = torch.randn(x.shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        bwd_args = (x, wqkv, bqkv, wproj, rel_bias, mask, dy)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            y = wa.window_attention(*args[:6], mask, **kw)
            y2 = wa.window_attention(*args[:6], mask, **kw)
            dx, grads = wa.window_attention_bwd(*bwd_args, **kw)
            dx2, grads2 = wa.window_attention_bwd(*bwd_args, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_reference(*args[:6], mask, **kw)
            rdx, rgrads = wa.window_attention_backward_reference(*bwd_args,
                                                                 **kw)
        check(torch.equal(y, y2), f"K3 C={c}: two runs bit-identical")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(err <= K3_MAX_ABS_REL * scale and omc <= K3_ONE_MINUS_COS,
              f"K3 ragged C={c}: max_abs_err {err} <= {K3_MAX_ABS_REL} * "
              f"{scale}, 1-cos {omc}")
        check(torch.equal(dx, dx2), f"K4 C={c}: dx of two runs bit-identical")
        worst, drift = 0.0, 0.0
        for name, got, again, want in zip(
                ("dx",) + wa.GRAD_NAMES, (dx,) + grads, (dx2,) + grads2,
                (rdx,) + rgrads):
            gscale = float(want.float().abs().max())
            gerr = float((got.float() - want.float()).abs().max())
            check(gerr <= K4_MAX_ABS_REL * gscale and
                  one_minus_cos(got, want) <= K4_ONE_MINUS_COS,
                  f"K4 ragged C={c} {name}: max_abs_err {gerr} <= "
                  f"{K4_MAX_ABS_REL} * {gscale}")
            rep = float((got.float() - again.float()).abs().max()) / gscale
            check(rep <= K4_REPEAT_MAX_ABS_REL,
                  f"K4 C={c} {name}: two runs within "
                  f"{K4_REPEAT_MAX_ABS_REL}: {rep}")
            worst, drift = max(worst, gerr / gscale), max(drift, rep)
        print(f"ragged [3,40,40,{c}] (75 windows), twice: K3 max_abs_err="
              f"{err} (max|ref|={scale}) 1-cos={omc:.3e}, bit-identical; K4 "
              f"worst max_abs_err/max|ref|={worst:.2e}, dx bit-identical, "
              f"gradients of two runs within {drift:.1e}")

    # C = 64 (head_dim 32) is no width of the wgmma window kernels: both
    # raise before a launch, with or without gradients
    args, mask, _ = block_inputs(16, 64, 2, 4, g, batch=1)
    args = args[:6]
    dy = torch.zeros_like(args[0])
    kw = dict(window_size=8, num_heads=2)
    before = wa.window_attention.launches, wa.window_attention_bwd.launches
    ins = [a.clone().requires_grad_(True) for a in args]
    for what, call in (
            ("K3", lambda: wa.window_attention(*args, mask, **kw)),
            ("K3 with gradients", lambda: wa.window_attention(*ins, mask,
                                                              **kw)),
            ("K4", lambda: wa.window_attention_bwd(
                *args[:4], args[5], mask, dy, **kw))):
        try:
            call()
        except ValueError as e:
            print(f"{what} at C=64 raises ValueError: {e}")
        else:
            check(False, f"{what} at C=64 must raise")
    check((wa.window_attention.launches,
           wa.window_attention_bwd.launches) == before,
          "the refused K3 / K4 calls launched nothing")


def check_swin_block(g: torch.Generator) -> dict:
    """K1 against swin_block_reference; times summed over the eight blocks
    of one forward."""
    worst, ms, plain_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, dp = block_inputs(h, c, heads, shift, g)
        kw = dict(window_size=8, num_heads=heads)
        with torch.inference_mode():
            y = swin_block(*args, mask, dp, **kw)
            torch.cuda.synchronize()
            ref = swin_block_reference(*args, mask, dp, **kw)
            err = float((y.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            omc = one_minus_cos(y, ref)
            t_plain = kernel_ms(lambda: swin_block_reference(*args, mask, dp,
                                                           **kw), iters=10)
            t_kernel = kernel_ms(lambda: swin_block(*args, mask, dp, **kw),
                               iters=10)
        print(f"K1 swin_block [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: max_abs_err={err} (max|ref|={scale}) "
              f"1-cos={omc:.3e} kernel_ms={t_kernel:.4f} "
              f"plain_ms={t_plain:.4f}")
        check(bool(torch.isfinite(y).all()), "K1 output finite")
        check(err <= K1_MAX_ABS_REL * scale,
              f"K1 max_abs_err {err} <= {K1_MAX_ABS_REL} * {scale}")
        check(omc <= K1_ONE_MINUS_COS, f"K1 1-cos {omc} <= {K1_ONE_MINUS_COS}")
        worst = max(worst, err)
        ms += count * t_kernel
        plain_ms += count * t_plain
        fl, by = block_work(h, c, heads, shift, backward=False)
        flops += count * fl
        nbytes += count * by
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_swin_block_bwd(g: torch.Generator) -> dict:
    """K2 against swin_block_backward_reference: dx and the 13 gradients at
    the four geometries; times summed over the eight blocks of one step."""
    worst_abs, worst_rel = 0.0, 0.0
    ms, plain_ms, autograd_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, dp = block_inputs(h, c, heads, shift, g)
        dp[0, 0] = 0.0   # dropped samples: dx = dy through that branch
        dp[1, 1] = 0.0
        dp[2, :] = 0.0
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            dx, grads = swin_block_bwd(*args, mask, dp, dy, **kw)
            torch.cuda.synchronize()
            rdx, rgrads = swin_block_backward_reference(*args, mask, dp, dy,
                                                        **kw)
        report = []
        for name, got, ref in zip(("dx",) + GRAD_NAMES, (dx,) + grads,
                                  (rdx,) + rgrads):
            check(bool(torch.isfinite(got).all()), f"K2 {name} finite")
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            omc = one_minus_cos(got, ref)
            report.append(f"{name} {err / scale:.2e}/{omc:.1e}")
            check(err <= K2_MAX_ABS_REL * scale,
                  f"K2 {name} max_abs_err {err} <= {K2_MAX_ABS_REL} * {scale}")
            check(omc <= K2_ONE_MINUS_COS,
                  f"K2 {name} 1-cos {omc} <= {K2_ONE_MINUS_COS}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
        check(bool((dx[2] == dy[2]).all()),
              "K2: a sample with both branches dropped has dx == dy")

        def autograd_of_plain():
            ins = [t.detach().requires_grad_(True) for t in args]
            y = swin_block_reference(*ins, mask, dp, **kw)
            return torch.autograd.grad(y, ins, dy)

        with torch.no_grad():
            t_kernel = kernel_ms(lambda: swin_block_bwd(*args, mask, dp, dy,
                                                      **kw), iters=5)
            t_plain = kernel_ms(lambda: swin_block_backward_reference(
                *args, mask, dp, dy, **kw), iters=2)
        t_autograd = kernel_ms(autograd_of_plain, iters=2)
        print(f"K2 swin_block_bwd [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: kernel_ms={t_kernel:.4f} "
              f"plain_ms={t_plain:.4f} autograd_of_plain_fwd_bwd_ms="
              f"{t_autograd:.4f}\n  max_abs_err/max|ref| and 1-cos: "
              + ", ".join(report))
        ms += count * t_kernel
        plain_ms += count * t_plain
        autograd_ms += count * t_autograd
        fl, by = block_work(h, c, heads, shift, backward=True)
        flops += count * fl
        nbytes += count * by
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err=worst_abs, max_abs_err_rel=worst_rel, ms=ms,
                plain_ms=plain_ms, autograd_of_plain_ms=autograd_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def attention_work(h: int, c: int, heads: int, shift: int, backward: bool):
    """FLOPs and bytes one windowed attention at batch 16 needs.

    Forward, per token: 8 C^2 for the qkv and output projections and 256 C
    for the two 64-token attention products. The backward recomputes qkv and
    both attention products (6 C^2 + 256 C) and runs dwproj, d(merged),
    dwqkv, dx (16 C^2) and four more attention products per head (512 C).
    Bytes: x in and out (and dy in) in bf16, the parameters, the mask once;
    the backward also writes the f32 gradients.
    """
    tokens = BATCH * h * h
    per_token = (22 * c * c + 768 * c) if backward else (8 * c * c + 256 * c)
    params = 4 * c * c * 2 + 4 * c * 2 + heads * 4096 * 4
    extra = (h // 8) ** 2 * 4096 * 4 * (1 if shift else 0)
    acts = tokens * c * 2 * (3 if backward else 2)
    grads = (4 * c * c + 4 * c + heads * 4096) * 4 if backward else 0
    return tokens * per_token, acts + params + extra + grads


def check_window_attention(g: torch.Generator):
    """K3 against window_attention_reference and K4 against
    window_attention_backward_reference (dx and the five gradients) at the
    four geometries; times summed over the eight blocks of one forward or
    step."""
    k3 = dict(err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0,
              per_launch={}, call_per_launch={})
    k4 = dict(err=0.0, rel=0.0, ms=0.0, plain_ms=0.0, autograd_ms=0.0,
              flops=0.0, nbytes=0.0, per_launch={})
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, _ = block_inputs(h, c, heads, shift, g)
        x, wqkv, bqkv, wproj, bproj, rel_bias = args = args[:6]
        dy = torch.randn(x.shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        bwd_args = (x, wqkv, bqkv, wproj, rel_bias, mask, dy)
        with torch.no_grad():
            y = wa.window_attention(*args, mask, **kw)
            dx, grads = wa.window_attention_bwd(*bwd_args, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_reference(*args, mask, **kw)
            rdx, rgrads = wa.window_attention_backward_reference(*bwd_args,
                                                                 **kw)
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(bool(torch.isfinite(y).all()), "K3 output finite")
        check(err <= K3_MAX_ABS_REL * scale,
              f"K3 max_abs_err {err} <= {K3_MAX_ABS_REL} * {scale}")
        check(omc <= K3_ONE_MINUS_COS, f"K3 1-cos {omc} <= {K3_ONE_MINUS_COS}")
        report = []
        for name, got, want in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads,
                                   (rdx,) + rgrads):
            check(bool(torch.isfinite(got).all()), f"K4 {name} finite")
            gerr = float((got.float() - want.float()).abs().max())
            gscale = float(want.float().abs().max())
            gomc = one_minus_cos(got, want)
            report.append(f"{name} {gerr / gscale:.2e}/{gomc:.1e}")
            check(gerr <= K4_MAX_ABS_REL * gscale,
                  f"K4 {name} max_abs_err {gerr} <= {K4_MAX_ABS_REL} * "
                  f"{gscale}")
            check(gomc <= K4_ONE_MINUS_COS,
                  f"K4 {name} 1-cos {gomc} <= {K4_ONE_MINUS_COS}")
            k4["err"] = max(k4["err"], gerr)
            k4["rel"] = max(k4["rel"], gerr / gscale)

        def autograd_of_plain():
            ins = [t.detach().requires_grad_(True) for t in args]
            out = wa.window_attention_reference(*ins, mask, **kw)
            return torch.autograd.grad(out, ins, dy)

        with torch.no_grad():
            t3 = kernel_ms(lambda: wa.window_attention(*args, mask, **kw),
                           iters=10)
            # with the wrapper's host work between launches, as a caller
            # that does not keep the card busy sees it
            t3_call = cuda_ms(lambda: wa.window_attention(*args, mask, **kw),
                              iters=10)
            t3_plain = kernel_ms(lambda: wa.window_attention_reference(
                *args, mask, **kw), iters=5)
            t4 = kernel_ms(lambda: wa.window_attention_bwd(*bwd_args, **kw),
                         iters=5)
            t4_plain = kernel_ms(
                lambda: wa.window_attention_backward_reference(*bwd_args,
                                                               **kw),
                iters=2)
        t4_autograd = kernel_ms(autograd_of_plain, iters=2)
        print(f"K3 window_attention [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: max_abs_err={err} (max|ref|={scale}) "
              f"1-cos={omc:.3e} kernel_ms={t3:.4f} (with the wrapper's host "
          f"work between launches {t3_call:.4f}) plain_ms={t3_plain:.4f}")
        print(f"K4 window_attention_bwd [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: kernel_ms={t4:.4f} plain_ms={t4_plain:.4f} "
              f"autograd_of_plain_fwd_bwd_ms={t4_autograd:.4f}\n"
              f"  max_abs_err/max|ref| and 1-cos: " + ", ".join(report))
        k3["err"] = max(k3["err"], err)
        k3["ms"] += count * t3
        key = f"{c}" + ("" if shift else " unshifted")
        k3["per_launch"][key] = t3
        k3["call_per_launch"][key] = t3_call
        k3["plain_ms"] += count * t3_plain
        k4["ms"] += count * t4
        k4["per_launch"][f"{c}" + ("" if shift else " unshifted")] = t4
        k4["plain_ms"] += count * t4_plain
        k4["autograd_ms"] += count * t4_autograd
        for k, backward in ((k3, False), (k4, True)):
            fl, by = attention_work(h, c, heads, shift, backward)
            k["flops"] += count * fl
            k["nbytes"] += count * by
    b3, by3 = bound(k3["flops"], k3["nbytes"])
    b4, by4 = bound(k4["flops"], k4["nbytes"])
    return (dict(max_abs_err=k3["err"], ms=k3["ms"], plain_ms=k3["plain_ms"],
                 bound_ms=b3, bound_by=by3, library_ms=None,
                 ms_per_launch=k3["per_launch"],
                 call_ms_per_launch=k3["call_per_launch"]),
            dict(max_abs_err=k4["err"], max_abs_err_rel=k4["rel"],
                 ms=k4["ms"], plain_ms=k4["plain_ms"],
                 autograd_of_plain_ms=k4["autograd_ms"], bound_ms=b4,
                 bound_by=by4, library_ms=None,
                 ms_per_launch=k4["per_launch"]))


def check_decoder_tail(g: torch.Generator) -> dict:
    """K7 against decoder_tail_reference at the flagship tail in bf16 and,
    at a small ragged shape, against the f32 composition of the same inputs.
    The reference is also the port's default tail (transposed conv, elu,
    conv through cuDNN): its time is what the kernel has to beat in the
    model. Times are of one launch."""
    def inputs(n, h, w, cin, cmid):
        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        return (r(n, h, w, cin).to(torch.bfloat16),
                r(3, 3, cin, cmid, scale=(9 * cin) ** -0.5),
                r(cmid, scale=0.1),
                r(3, 3, cmid, 2, scale=(9 * cmid) ** -0.5), r(2, scale=0.1))

    def rnd(t):
        return t.to(torch.bfloat16).float()

    with torch.inference_mode():
        small = inputs(3, 20, 33, 96, 48)
        got = decoder_tail(*small)
        torch.cuda.synchronize()
        x, w_up, b_up, w_out, b_out = small
        ref32 = decoder_tail_reference(x.float(), w_up, b_up, rnd(w_out),
                                       rnd(b_out))
        err32 = float((got.float() - ref32).abs().max())
        scale32 = float(ref32.abs().max())
        omc32 = one_minus_cos(got, ref32)
        print(f"K7 decoder_tail [3,20,33,96] bf16 vs the f32 composition "
              f"(TF32 off): max_abs_err={err32} (max|ref|={scale32}) "
              f"1-cos={omc32:.3e}")
        check(err32 <= K7_MAX_ABS_REL * scale32,
              f"K7 vs f32: {err32} <= {K7_MAX_ABS_REL} * {scale32}")
        check(omc32 <= K7_ONE_MINUS_COS, f"K7 vs f32 1-cos {omc32}")

        # On the card the wrapper launches or raises: what the kernel does
        # not cover never takes the naive composition. The flagship launch
        # below also shows that a refused launch leaves no error behind.
        before = decoder_tail.launches
        for what, bad in (
                ("an f32 input", (x.float(),) + small[1:]),
                ("Cin=24", inputs(1, 8, 8, 24, 48)),
                ("Cin=1024", inputs(1, 8, 8, 1024, 48))):
            try:
                decoder_tail(*bad)
            except (ValueError, RuntimeError) as e:
                print(f"K7 on {what} raises {type(e).__name__}: {e}")
            else:
                check(False, f"K7 on {what} must raise")
        check(decoder_tail.launches == before,
              "the refused K7 calls launched nothing")

        # a tile owns 15 x 7 input pixels: one under, at and one over two
        # tiles a side, against the f32 composition; twice, bit-identical
        for eh, ew in ((29, 13), (30, 14), (31, 15)):
            edge = inputs(3, eh, ew, 96, 48)
            got = decoder_tail(*edge)
            again = decoder_tail(*edge)
            torch.cuda.synchronize()
            ref32 = decoder_tail_reference(edge[0].float(), edge[1], edge[2],
                                           rnd(edge[3]), rnd(edge[4]))
            err32 = float((got.float() - ref32).abs().max())
            scale32 = float(ref32.abs().max())
            print(f"K7 decoder_tail [3,{eh},{ew},96] vs the f32 composition: "
                  f"max_abs_err={err32} (max|ref|={scale32}); twice "
                  f"bit-identical: {torch.equal(got, again)}")
            check(err32 <= K7_MAX_ABS_REL * scale32,
                  f"K7 [3,{eh},{ew},96]: {err32} <= {K7_MAX_ABS_REL} * "
                  f"{scale32}")
            check(torch.equal(got, again),
                  f"K7 [3,{eh},{ew},96]: two runs bit-identical")

        n, h, cin, cmid = BATCH * 8, 128, 96, 48
        args = inputs(n, h, h, cin, cmid)
        y = decoder_tail(*args)
        check(torch.equal(y, decoder_tail(*args)),
              "K7: two runs bit-identical")
        torch.cuda.synchronize()
        ref = decoder_tail_reference(*args)
        check(tuple(y.shape) == (n, 2 * h, 2 * h, 2), f"K7 shape {y.shape}")
        check(bool(torch.isfinite(y).all()), "K7 output finite")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(err <= K7_MAX_ABS_REL * scale,
              f"K7 max_abs_err {err} <= {K7_MAX_ABS_REL} * {scale}")
        check(omc <= K7_ONE_MINUS_COS, f"K7 1-cos {omc} <= {K7_ONE_MINUS_COS}")
        del ref
        t = [kernel_ms(fn, iters=5) for fn in (
            lambda: decoder_tail_reference(*args), lambda: decoder_tail(*args),
            lambda: decoder_tail(*args), lambda: decoder_tail_reference(*args))]
        t_phase = kernel_ms(lambda: decoder_tail_phase(*args), iters=5)
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    px = n * 4 * h * h  # upsampled pixels
    flops = 2.0 * px * (4 * cin) * cmid + 2.0 * px * 9 * cmid * 2
    nbytes = (n * h * h * cin + px * 2 + 9 * cin * cmid + 9 * cmid * 2) * 2
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"K7 decoder_tail [{n},{h},{h},{cin}] -> [{n},{2 * h},{2 * h},2]: "
          f"max_abs_err={err} (max|ref|={scale}) 1-cos={omc:.3e} "
          f"kernel_ms={ms:.4f} ({t[1]:.4f}, {t[2]:.4f}) "
          f"plain_ms={plain_ms:.4f} ({t[0]:.4f}, {t[3]:.4f}; the default "
          f"tail: transposed conv, elu, conv) phase_form_ms={t_phase:.4f} "
          f"bound_ms={bound_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                phase_form_ms=t_phase, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def check_warp_gather(g: torch.Generator):
    """K5 and K6 against their plain versions at the loss's shapes: S = 16
    samples x 8 waypoints, 256 x 256 queries at identity + a flow of a few
    pixels, some of them past the border. K6 also on a smooth flow (zero
    flow plus one fractional offset: the four queries around a pixel share
    it as a corner), on queries at the rows where its bands meet, and at
    other band counts."""
    s, h, w = BATCH * 8, 256, 256
    hp, wp, n = h + 2, w + 2, h * w
    dev = "cuda"
    img = torch.zeros(s, hp, wp, device=dev)
    img[:, 1:-1, 1:-1] = (torch.rand(s, h, w, generator=g, device=dev) < 0.1
                          ).float()
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    flow = torch.randn(s, h, w, 2, generator=g, device=dev) * 4.0
    x = (xs[None] + flow[..., 0] + 1.0).reshape(s, n)
    y = (ys[None] + flow[..., 1] + 1.0).reshape(s, n)
    outside = int(((x < 0) | (x > wp - 1) | (y < 0) | (y > hp - 1)).sum())
    check(outside > 0, "some queries fall past the border")
    x0f = torch.clamp(torch.floor(x), 0.0, wp - 2.0).contiguous()
    y0f = torch.clamp(torch.floor(y), 0.0, hp - 2.0).contiguous()
    gs = tuple(torch.randn(s, n, generator=g, device=dev) for _ in range(4))

    got = warp_gather_fwd(img, x0f, y0f)
    torch.cuda.synchronize()
    ref = gather_corners_reference(img, x0f, y0f)
    err5 = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(err5 <= K5_MAX_ABS, f"K5 max_abs_err {err5} <= {K5_MAX_ABS}")

    def check_scatter(what, qx, qy):
        dimg = warp_gather_bwd((s, hp, wp), qx, qy, gs)
        torch.cuda.synchronize()
        rdimg = scatter_corners_reference((s, hp, wp), qx, qy, gs)
        err = float((dimg - rdimg).abs().max())
        scale = float(rdimg.abs().max())
        print(f"K6 warp_gather_bwd, {what}: max_abs_err={err} "
              f"(max|ref|={scale})")
        check(err <= K6_MAX_ABS_REL * scale,
              f"K6 {what}: max_abs_err {err} <= {K6_MAX_ABS_REL} * {scale}")
        return err

    err6 = check_scatter("flow N(0, 4 px)", x0f, y0f)
    # the smooth flow: every pixel the corner of four neighbouring queries
    sx0 = (xs[None] + 1.0 + 0.3).floor().expand(s, h, w).reshape(s, n)
    sy0 = (ys[None] + 1.0 + 0.6).floor().expand(s, h, w).reshape(s, n)
    sx0, sy0 = sx0.contiguous(), sy0.contiguous()
    err6 = max(err6, check_scatter("smooth flow", sx0, sy0))
    # queries on the first and last rows and where two bands meet
    rows = bwd_band_rows(hp, wp)
    edge = torch.tensor(band_edge_rows(hp, rows), dtype=torch.float32,
                        device=dev)
    ey0 = edge.repeat(s * n // len(edge) + 1)[:s * n].reshape(s, n)
    ex0 = torch.randint(0, wp - 1, (s, n), generator=g, device=dev).float()
    err6 = max(err6, check_scatter(f"rows at band edges ({rows} rows a band)",
                                   ex0, ey0.contiguous()))

    # one PyTorch call on precomputed int64 indices, as the yardstick
    base = (y0f.long() * wp + x0f.long())
    idx4 = torch.cat([base + o for o in (0, 1, wp, wp + 1)], dim=1)
    flat = img.reshape(s, hp * wp)
    rows_off = (torch.arange(s, device=dev) * (hp * wp))[:, None]
    idx_flat = (idx4 + rows_off).reshape(-1)
    src = torch.cat(gs, dim=1).reshape(-1)
    acc = torch.zeros(s * hp * wp, device=dev)
    t5 = kernel_ms(lambda: warp_gather_fwd(img, x0f, y0f))
    t5_plain = kernel_ms(lambda: gather_corners_reference(img, x0f, y0f))
    t5_lib = kernel_ms(lambda: torch.gather(flat, 1, idx4))
    t6 = kernel_ms(lambda: warp_gather_bwd((s, hp, wp), x0f, y0f, gs))
    t6_smooth = kernel_ms(lambda: warp_gather_bwd((s, hp, wp), sx0, sy0, gs))
    t6_plain = kernel_ms(lambda: scatter_corners_reference((s, hp, wp), x0f,
                                                         y0f, gs))
    t6_lib = kernel_ms(lambda: acc.index_add_(0, idx_flat, src))
    by_bands = {str(k): kernel_ms(lambda: warp_gather_bwd(
        (s, hp, wp), x0f, y0f, gs, bands=k)) for k in (2, 3, 4, 6)}
    b5, by5 = bound(0.0, img.numel() * 4 + 2 * s * n * 4 + 4 * s * n * 4)
    b6, by6 = bound(0.0, 6 * s * n * 4 + img.numel() * 4)
    print(f"K5 warp_gather_fwd [{s},{hp},{wp}] x [{s},{n}] ({outside} "
          f"queries past the border): max_abs_err={err5} kernel_ms={t5:.4f} "
          f"plain_ms={t5_plain:.4f} torch.gather_ms={t5_lib:.4f} "
          f"bound_ms={b5:.4f}")
    print(f"K6 warp_gather_bwd: worst max_abs_err={err6} kernel_ms={t6:.4f} "
          f"(smooth flow {t6_smooth:.4f}; by bands of a slice: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in by_bands.items())
          + f") plain_ms={t6_plain:.4f} index_add_ms={t6_lib:.4f} "
          f"bound_ms={b6:.4f}")
    return (dict(max_abs_err=err5, ms=t5, plain_ms=t5_plain, bound_ms=b5,
                 bound_by=by5, library_ms=t5_lib),
            dict(max_abs_err=err6, ms=t6, plain_ms=t6_plain, bound_ms=b6,
                 bound_by=by6, library_ms=t6_lib, smooth_flow_ms=t6_smooth,
                 ms_by_bands=by_bands, band_rows=rows,
                 smem_bytes=4 * rows * wp))


def to_device(batch, keys=MODEL_KEYS):
    return {k: torch.from_numpy(batch[k]).cuda() for k in keys}


def forward(model, b):
    return model(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
                 occ=b["occl_actors"], mapt=b["centerlines"],
                 flow=b["vec_flow"])


# K1 .. K7, in the order of the kernels line
COUNTERS = dict(k1=swin_block, k2=swin_block_bwd, k3=wa.window_attention,
                k4=wa.window_attention_bwd, k5=warp_gather_fwd,
                k6=warp_gather_bwd, k7=decoder_tail)


def reset_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters():
    return tuple(fn.launches for fn in COUNTERS.values())


def counts(**launches):
    """A counter reading with the named kernels' launches and 0 elsewhere."""
    unknown = set(launches) - set(COUNTERS)
    if unknown:
        raise KeyError(f"no such counters: {unknown}")
    return tuple(launches.get(k, 0) for k in COUNTERS)


def check_forward(state):
    """The flagship forward through K1 against the plain path."""
    cfg = STRAJNET_CONFIG
    model = STrajNet(cfg)
    model.load_state_dict(state)
    model = model.cuda().eval()
    plain = STrajNet(dataclasses.replace(cfg, use_pallas_attention=False))
    plain.load_state_dict(state)
    plain = plain.cuda().eval()
    batch = to_device(synthetic_batch(cfg, BATCH, seed=0))
    oh, ow = cfg.output_size
    with torch.inference_mode():
        reset_counters()
        y = forward(model, batch)
        torch.cuda.synchronize()
        per_forward = read_counters()
        y_plain = forward(plain, batch)
        check(per_forward == counts(k1=8), f"8 K1 launches per forward and "
                                           f"no other, got {per_forward}")
        check(tuple(y.shape) == (BATCH, oh, ow, 4 * cfg.num_waypoints),
              f"forward shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "forward output finite")
        omc = one_minus_cos(y, y_plain)
        err = float((y - y_plain).abs().max())
        print(f"forward [{BATCH},{oh},{ow},{4 * cfg.num_waypoints}] kernel "
              f"vs plain: 1-cos={omc:.3e} max_abs_err={err} "
              f"(max|plain|={float(y_plain.abs().max())})")
        check(omc <= FWD_ONE_MINUS_COS,
              f"forward 1-cos {omc} <= {FWD_ONE_MINUS_COS}")

        # plain, kernel, kernel, plain on the same card
        t = [cuda_ms(lambda: forward(m, batch), iters=3)
             for m in (plain, model, model, plain)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"forward batch {BATCH} bf16: kernel path {ms:.3f} ms "
              f"({t[1]:.3f}, {t[2]:.3f}); plain path {plain_ms:.3f} ms "
              f"({t[0]:.3f}, {t[3]:.3f}); {BATCH / ms * 1e3:.1f} scenes/s "
              f"through the kernel")

        # bf16 kernel path vs an f32 plain forward, on 2 samples
        ref_cfg = dataclasses.replace(cfg, dtype="float32",
                                      use_pallas_attention=False)
        ref = STrajNet(ref_cfg)
        ref.load_state_dict(state)
        ref = ref.cuda().eval()
        small = {k: v[:2] for k, v in batch.items()}
        omc32 = one_minus_cos(forward(model, small), forward(ref, small))
        print(f"forward bf16 kernel path vs f32 plain path (batch 2): "
              f"1-cos={omc32:.3e}")
        check(omc32 <= F32_ONE_MINUS_COS,
              f"bf16 vs f32 1-cos {omc32} <= {F32_ONE_MINUS_COS}")
    return model


def serve(model) -> int:
    """Three batches of 16 through run_shard; parses the submission back."""
    cfg = STRAJNET_CONFIG
    batches = []
    for i in range(3):
        b = synthetic_batch(cfg, BATCH, seed=100 + i)
        b = {k: b[k] for k in MODEL_KEYS}
        b["scenario/id"] = np.array([f"synthetic-{i}-{j:02d}"
                                     for j in range(BATCH)])
        batches.append(b)
    ids = {s for b in batches for s in b["scenario/id"]}
    with tempfile.TemporaryDirectory() as out_dir:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = run_shard(model, make_predict_step(cfg.num_waypoints),
                          "00000new.tfrecords", ids, out_dir,
                          batch_size=BATCH, batches=batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        name = "occupancy_flow_submission.binproto-00000-of-00150"
        with open(os.path.join(out_dir, name), "rb") as f:
            buf = f.read()
    scenarios = [v for fn, _, v in iter_fields(buf)
                 if fn == SUBMISSION_SCENARIO_PREDICTIONS]
    parsed_ids = set()
    for sc in scenarios:
        fields = list(iter_fields(sc))
        parsed_ids.update(v.decode() for fn, _, v in fields
                          if fn == SCENARIO_ID)
        n_wp = sum(1 for fn, _, _ in fields if fn == SCENARIO_WAYPOINTS)
        check(n_wp == cfg.num_waypoints, f"{n_wp} waypoints in a scenario")
    print(f"run_shard: {count} scenarios in {seconds:.3f} s "
          f"({count / seconds:.2f} scenes/s end to end, host quantization "
          f"and writing included); {len(scenarios)} parsed back; "
          f"{launches[0]} K1 launches")
    check(count == 3 * BATCH and len(scenarios) == 3 * BATCH,
          f"48 scenarios written and parsed, got {count}/{len(scenarios)}")
    check(parsed_ids == ids, "parsed scenario ids match")
    check(launches == counts(k1=3 * 8),
          f"24 K1 launches on the served path and no other, got {launches}")
    return launches


def warp_gradient_path():
    """``core.sampling.flow_warp_origin`` differentiated with respect to the
    warped image, the one caller that reaches K6 (the loss warps ground
    truth, which needs no gradient). Held against the portable path
    ``core.sampling.sample`` under autograd. Returns the counters."""
    g = torch.Generator(device="cuda").manual_seed(1)
    s, h, w = BATCH * 8, 256, 256
    origin = torch.rand(s, h, w, 1, generator=g, device="cuda")
    flow = torch.randn(s, h, w, 2, generator=g, device="cuda") * 4.0
    weight = torch.randn(s, h, w, 1, generator=g, device="cuda")
    grads = []
    reset_counters()
    for use_kernel in (True, False):
        img = origin.clone().requires_grad_(True)
        fl = flow.clone().requires_grad_(True)
        out = flow_warp_origin(img, fl, use_kernel=use_kernel)
        (out * weight).sum().backward()
        grads.append((out.detach(), img.grad, fl.grad))
    torch.cuda.synchronize()
    got = read_counters()
    check(got == counts(k5=1, k6=1), f"one K5 and one K6 launch, got {got}")
    for name, a, b in zip(("warped", "d/d image", "d/d flow"), *grads):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"flow_warp_origin kernel vs portable path, {name}: "
              f"max_abs_err={err} (max|ref|={scale})")
        check(err <= 1e-5 * scale, f"{name}: {err} <= 1e-5 * {scale}")
    return got


def fresh_train_state(mode, remat=False):
    """A train state from seed-0 weights in the given Swin-block mode (and
    ``remat_encoder``), with every bias drawn from N(0, 0.1) instead of the
    init's zeros.

    With all biases zero, a patch of an empty raster stays a constant token
    through every layer, each LayerNorm multiplies the gradient of the bias
    directions by eps^-1/2 = 316, and at this depth the squares of those
    gradients overflow f32 in Nadam's second moment, so such a parameter
    would never move. The JAX package computes the same gradients
    (``tests/test_torch_train_step.py`` holds the port to them at a small
    depth, where they already reach 1e25). Random biases keep the checks of
    this smoke out of that corner; :func:`real_init_report` prints what one
    step from the init itself does."""
    cfg = dataclasses.replace(STRAJNET_CONFIG, use_pallas_attention=mode,
                              remat_encoder=remat)
    state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                               torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return state, cfg


def _first_step(mode, batch, remat=False):
    """One training step from those weights and seed-0 noise: (loss dict,
    flat gradient, initial parameters, state, step function, noise)."""
    state, cfg = fresh_train_state(mode, remat)
    init = {k: v.detach().cpu().clone()
            for k, v in state.model.named_parameters()}
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           cfg.num_waypoints)
    noise = torch.Generator(device="cuda").manual_seed(0)
    state, losses = step(state, batch, noise)
    torch.cuda.synchronize()
    for name, p in state.model.named_parameters():
        check(p.grad is not None, f"parameter {name} has a gradient")
    grads = torch.cat([p.grad.flatten().float()
                       for p in state.model.parameters()])
    check(bool(torch.isfinite(grads).all()), "gradients finite")
    return losses, grads, init, state, step, noise


def worst_leaves(model, grads, other_grads, count=5):
    """Each parameter's 1 - cos between two flat gradients of ``model``,
    worst first: [(1 - cos, |leaf gradient| / |whole gradient|, name)]."""
    rows, offset, whole = [], 0, float(grads.norm())
    for name, p in model.named_parameters():
        a = grads[offset:offset + p.numel()]
        b = other_grads[offset:offset + p.numel()]
        offset += p.numel()
        if name not in ZERO_GRAD_LEAVES:
            rows.append((one_minus_cos(a, b), float(a.norm()) / whole, name))
    return sorted(rows, reverse=True)[:count]


def real_init_report(batch) -> None:
    """One kernel-path step from ``create_train_state``'s own weights, zero
    biases included: prints which parameters it leaves where they were. Not
    a check: see :func:`fresh_train_state`."""
    cfg = STRAJNET_CONFIG
    state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                               torch.Generator().manual_seed(0), "cuda")
    init = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints)
    state, losses = step(state, batch,
                         torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    named = dict(state.model.named_parameters())
    stuck = [n for n, p in named.items() if torch.equal(p.detach(), init[n])]
    top = max(named, key=lambda n: float(named[n].grad.abs().max()))
    finite = all(bool(torch.isfinite(p).all()) for p in named.values())
    print(f"one step from the entry point's own init (zero biases): total "
          f"loss {float(losses['total']):.6f}; parameters finite: {finite}; "
          f"largest gradient entry {float(named[top].grad.abs().max()):.4g} "
          f"in {top}; {len(stuck)} of {len(named)} parameters did not move: "
          + ", ".join(stuck[:12]) + (" ..." if len(stuck) > 12 else ""))


def train_steps():
    """Three flagship training steps at batch 16 through the kernels; then
    the first step again in the "block_fwd" mode and on the plain path, held
    against the kernel path's loss and gradients, whole and leaf by leaf;
    then one "attn" step (K3 forward, K4 backward) held against the plain
    path's; then one step from the init's own zero biases, reported only.
    Returns the counters over the three steps plus the "attn" step."""
    cfg = STRAJNET_CONFIG
    all_keys = MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow",
                             "origin_flow")
    batches = [to_device(synthetic_batch(cfg, BATCH, seed=i), all_keys)
               for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses, grads, init, state, step, noise = _first_step(None, batches[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    check(read_counters() == counts(k1=8, k2=8, k5=1),
          f"launches of K1/K2/K5 in one step are 8/8/1 and no other, got "
          f"{read_counters()}")
    history, step_ms = [losses], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss_dict = step(state, b, noise)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(loss_dict)
    launches = read_counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches == counts(k1=24, k2=24, k5=3),
          f"launches of K1/K2/K5 over three steps are 24/24/3 and no other, "
          f"got {launches}")
    check(state.step == 3, f"step count 3, got {state.step}")
    for i, loss_dict in enumerate(history):
        vals = {k: float(v) for k, v in loss_dict.items()}
        print(f"train step {i}: " + " ".join(f"{k}={v:.6f}"
                                             for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()),
              f"losses of step {i} finite")
    for name, p in state.model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"parameter {name} finite")
        # fg_msa_layer.proj_k.bias shifts every logit of a softmax row
        # alike: its gradient is zero but for rounding, so it may stay put
        check(not torch.equal(p.detach().cpu(), init[name])
              or name == "fg_msa_layer.proj_k.bias",
              f"parameter {name} changed by training")
    grad_norm = float(grads.norm())
    print(f"training, batch {BATCH} bf16, kernel path: gradient norm of the "
          f"first step {grad_norm:.4g}; first step "
          f"{first_ms:.1f} ms (model and optimizer creation included), then "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms per step; peak "
          f"memory {peak_mb:.0f} MB; launches K1..K7 = {launches}")
    model = state.model
    del state, step

    # "block_fwd" and the plain path against the kernel path; then the
    # "attn" mode (K3 forward, K4 backward) against the plain path
    kernel_ref = ("kernel", grads, float(losses["total"]))
    compare_first_step(model, "block_fwd", batches[0],
                       counts(k1=8, k5=1), kernel_ref, "block_fwd")
    plain_grads, plain_total, _, _ = compare_first_step(
        model, False, batches[0], counts(k5=1), kernel_ref, False)
    del grads, kernel_ref
    attn_grads, attn_total, attn_launches, attn_mb = compare_first_step(
        model, "attn", batches[0], counts(k3=8, k4=8, k5=1),
        ("plain", plain_grads, plain_total), False)
    del plain_grads
    # remat_encoder recomputes each block's forward in the backward: K3
    # runs twice per block, and the step is the same step
    _, _, remat_launches, remat_mb = compare_first_step(
        model, "attn", batches[0], counts(k3=16, k4=8, k5=1),
        ("attn", attn_grads, attn_total), "remat", remat=True)
    print(f"remat_encoder, \"attn\" step: peak memory {remat_mb:.0f} MB "
          f"against {attn_mb:.0f} MB without")
    del model, attn_grads
    torch.cuda.empty_cache()
    real_init_report(batches[0])
    return tuple(a + b + c for a, b, c in zip(launches, attn_launches,
                                             remat_launches))


def compare_first_step(model, mode, batch, expect, reference, limits,
                       remat=False):
    """The first training step in ``mode`` (with ``remat_encoder=remat``)
    against ``reference`` = (name, flat gradient, total loss) of another
    mode's first step, under the ``STEP_*[limits]`` limits; also that the
    step moved the parameters. Returns (flat gradient, total loss, counters
    of the step, peak device memory of the step in MB: the model and its
    optimizer state included)."""
    ref_name, ref_grads, ref_total = reference
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, grads, init, state = _first_step(mode, batch, remat)[:4]
    got = read_counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if remat:
        mode = f"{mode} + remat_encoder"
    check(got == expect, f"mode {mode!r}: launches {got}, expected {expect}")
    total = float(losses["total"])
    check(bool(np.isfinite(total)), f"mode {mode!r}: loss finite")
    stuck = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach().cpu(), init[n])
             and n not in ZERO_GRAD_LEAVES]
    check(not stuck, f"mode {mode!r}: parameters {stuck[:5]} did not move")
    del state, init
    omc = one_minus_cos(ref_grads, grads)
    leaves = worst_leaves(model, ref_grads, grads)
    print(f"first step, mode {mode!r} vs {ref_name} path: total loss "
          f"{total:.6f} vs {ref_total:.6f}; gradient 1-cos={omc:.3e}; peak "
          f"memory {peak_mb:.0f} MB; worst leaves by 1-cos (share of the "
          f"gradient's norm): "
          + ", ".join(f"{n} {v:.3e} ({share:.1e})" for v, share, n in leaves))
    check(abs(total - ref_total) <= STEP_LOSS_RTOL[limits] * abs(ref_total),
          f"mode {mode!r}: loss {total} within {STEP_LOSS_RTOL[limits]} of "
          f"{ref_total}")
    check(omc <= STEP_GRAD_ONE_MINUS_COS[limits],
          f"mode {mode!r}: gradient 1-cos {omc} <= "
          f"{STEP_GRAD_ONE_MINUS_COS[limits]}")
    check(leaves[0][0] <= STEP_LEAF_ONE_MINUS_COS[limits],
          f"mode {mode!r}: worst leaf {leaves[0][2]} 1-cos {leaves[0][0]} <= "
          f"{STEP_LEAF_ONE_MINUS_COS[limits]}")
    return grads, total, got, peak_mb


def eval_inputs(cfg, seeds):
    """Synthetic f32 eval batches whose map raster holds multiples of 1/256,
    as a record's int8 map divided by 256 does."""
    keys = MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow", "origin_flow")
    batches = [{k: b[k] for k in keys}
               for b in (synthetic_batch(cfg, BATCH, seed=s) for s in seeds)]
    for b in batches:
        b["map_image"] = np.floor(b["map_image"] * 256.0) / 256.0
    return batches


def compact_feed(batch):
    """The batch as ``infer/evaluate.py`` feeds it by default
    (``compact=True``, ``data/schema.py``): binary grids as uint8, the map
    raster as f16, the rest f32. Bit-exact for these values."""
    out = dict(batch)
    for k in ("ogm", "gt_obs_ogm", "gt_occ_ogm"):
        out[k] = batch[k].astype(np.uint8)
    out["map_image"] = batch["map_image"].astype(np.float16)
    return out


def eval_step_parts(model, batch, cfg):
    """CUDA-event times of the three parts of one eval step: forward, loss,
    metrics (ms)."""
    loss_fn = OGMFlowLoss(WAYMO_TASK_CONFIG, LossConfig())
    with torch.inference_mode():
        tb = ensure_f32(to_device(batch, tuple(batch)))
        true = true_waypoints_from_batch(tb)
        logits = split_pred_waypoints(forward(model, tb), cfg.num_waypoints)
        pred = apply_sigmoid_to_occupancy_logits(logits)
        return (cuda_ms(lambda: forward(model, tb), iters=3),
                cuda_ms(lambda: loss_fn(true, logits), iters=3),
                cuda_ms(lambda: compute_occupancy_flow_metrics(true, pred),
                        iters=3))


def eval_path(state):
    """The evaluation path at full width: two synthetic batches of 16 through
    ``infer.evaluate.evaluate_batches`` on a model with the window-attention
    kernel in all eight Swin blocks and the decoder-tail kernel in both
    tails, then through the same loop on the plain path; losses and metrics
    of the two held against each other. Returns the kernel run's counters."""
    cfg = dataclasses.replace(STRAJNET_CONFIG, use_pallas_attention="attn",
                              use_pallas_decoder_tail=True)
    plain_cfg = dataclasses.replace(STRAJNET_CONFIG,
                                    use_pallas_attention=False)
    batches = eval_inputs(cfg, (200, 201))
    eval_step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
    results, seconds, models = [], [], []
    for c in (cfg, plain_cfg):
        model = STrajNet(c)
        model.load_state_dict(state)
        model = model.cuda().eval()
        evaluate_batches(model, eval_step, batches[:1])   # warm-up
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(evaluate_batches(model, eval_step, batches))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if c is cfg:
            launches = read_counters()
        models.append(model)
    check(launches == counts(k3=16, k5=4, k7=4),
          f"16 K3, 4 K5 and 4 K7 launches over two eval steps and no other, "
          f"got {launches}")
    res, plain = results
    print("eval path, kernels (attn + decoder-tail kernel):")
    print_metrics(res, "val")
    print(json.dumps({"eval": res, "eval_plain_path": plain}))
    check(len(res) == 12 and set(res) == set(plain),
          f"seven metrics and five losses, got {sorted(res)}")
    losses = ("val_observed_xe", "val_occluded_xe", "val_flow",
              "val_flow_warp_xe", "val_total")
    worst_loss = worst_metric = 0.0
    for k, v in res.items():
        check(bool(np.isfinite(v)), f"eval {k} finite")
        diff = abs(v - plain[k])
        rel = diff / abs(plain[k]) if plain[k] else 0.0
        print(f"  {k}: {v} vs plain path {plain[k]}, difference {diff:.3e} "
              f"({rel:.3e} relative)")
        if k in losses:
            worst_loss = max(worst_loss, rel)
            check(diff <= EVAL_LOSS_RTOL * abs(plain[k]),
                  f"eval loss {k}: {v} within {EVAL_LOSS_RTOL} of {plain[k]}")
        else:
            worst_metric = max(worst_metric, rel)
            check(diff <= EVAL_METRIC_RTOL * abs(plain[k]) + EVAL_METRIC_ATOL,
                  f"eval metric {k}: {v} within {EVAL_METRIC_RTOL} relative "
                  f"+ {EVAL_METRIC_ATOL} of {plain[k]}")
    n = len(batches) * BATCH
    parts = [eval_step_parts(m, batches[0], cfg) for m in models]
    print(f"eval path, batch {BATCH} bf16, two steps: kernels "
          f"{seconds[0] * 1e3 / 2:.1f} ms/step ({n / seconds[0]:.1f} "
          f"scenes/s), plain path {seconds[1] * 1e3 / 2:.1f} ms/step "
          f"({n / seconds[1]:.1f} scenes/s), host transfer included; worst "
          f"loss difference {worst_loss:.3e} relative, worst metric "
          f"difference {worst_metric:.3e} relative; launches K1..K7 = "
          f"{launches}")
    for name, (fwd, loss, met) in zip(("kernels", "plain path"), parts):
        print(f"  one eval step by CUDA events, {name}: forward {fwd:.3f} ms, "
              f"loss {loss:.3f} ms, metrics {met:.3f} ms")

    # the compact feed, which the CLI takes by default, through the same
    # kernel model: the same values, a third of the bytes to copy
    compact = [compact_feed(b) for b in batches]
    evaluate_batches(models[0], eval_step, compact[:1])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_compact = evaluate_batches(models[0], eval_step, compact)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    worst = max(abs(v - res[k]) / max(abs(res[k]), 1e-30)
                for k, v in res_compact.items())
    print(f"eval path, kernels, compact feed (uint8 grids, f16 map): "
          f"{compact_s * 1e3 / 2:.1f} ms/step ({n / compact_s:.1f} scenes/s) "
          f"against {seconds[0] * 1e3 / 2:.1f} ms/step on the f32 feed; "
          f"worst difference to the f32 feed's results {worst:.3e} relative")
    check(set(res_compact) == set(res), "compact feed: the same keys")
    for k, v in res_compact.items():
        check(abs(v - res[k]) <= EVAL_METRIC_RTOL * abs(res[k])
              + EVAL_METRIC_ATOL,
              f"compact feed {k}: {v} within {EVAL_METRIC_RTOL} of {res[k]}")

    # what the loop spends outside the step: one batch from pageable host
    # memory to the card, as evaluate_batches copies it, in either feed
    for name, batch in (("f32", batches[0]), ("compact", compact[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(batch, tuple(batch))
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        mb = sum(v.nbytes for v in batch.values()) / 2 ** 20
        print(f"  one batch to the card, {name} feed: {mb:.0f} MB in "
              f"{copy_ms:.1f} ms")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args(argv)
    phases = tuple(args.phases.split(","))
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {set(phases) - set(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    builds = _build.build_all(KERNEL_SOURCES)
    print(f"nvcc build of {len(builds)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name, build in builds.items():
        print(f"  {name}: {build.seconds:.2f} s"
              + (" (up-to-date build found)" if build.seconds == 0 else ""))
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    csrc, jax_ops = "strajnet_tpu_torch/csrc/", "strajnet_tpu/ops/"
    kernels = {   # K1 .. K7, in the order of COUNTERS
        "swin_block": dict(
            source=csrc + "swin_block.cu",
            replaces=jax_ops + "pallas_swin_block.py:82"),
        "swin_block_bwd": dict(
            source=csrc + "swin_block_bwd.cu",
            replaces=jax_ops + "pallas_swin_block.py:143"),
        "window_attention": dict(
            source=csrc + "window_attention.cu",
            replaces=jax_ops + "pallas_window_attention.py:91"),
        "window_attention_bwd": dict(
            source=csrc + "window_attention.cu",
            replaces=jax_ops + "pallas_window_attention.py:131"),
        "warp_gather_fwd": dict(
            source=csrc + "warp_gather.cu",
            replaces=jax_ops + "pallas_warp_gather.py:57"),
        "warp_gather_bwd": dict(
            source=csrc + "warp_gather.cu",
            replaces=jax_ops + "pallas_warp_gather.py:83"),
        "decoder_tail": dict(
            source=csrc + "decoder_tail.cu",
            replaces=jax_ops + "pallas_decoder_tail.py:127"),
    }
    launches = dict.fromkeys(kernels, 0)

    def add_launches(counters):
        for name, count in zip(kernels, counters):
            launches[name] += count

    g = torch.Generator(device="cuda").manual_seed(0)
    if "kernels" in phases:
        kernels["swin_block"].update(check_swin_block(g))
        kernels["swin_block_bwd"].update(check_swin_block_bwd(g))
        kernels["swin_block_bwd"]["split_k"] = check_split_k(g)
        check_ragged_and_repeat(g)
        for name, source, kernel in (
                ("swin_block", "swin_block", "swin_block_fwd_kernel"),
                ("swin_block_bwd", "swin_block_bwd",
                 "swin_block_bwd_window_kernel")):
            res = kernel_resources(builds[source].log, kernel)
            kernels[name]["regs"] = {str(c): r for c, (r, _) in res.items()}
            kernels[name]["spill_bytes"] = {str(c): sp
                                            for c, (_, sp) in res.items()}
            kernels[name]["smem_bytes"] = {
                str(c): kernel_smem_bytes(c, 4 * c)[name == "swin_block_bwd"]
                for c in (96, 192, 384)}
        k3, k4 = check_window_attention(g)
        kernels["window_attention"].update(k3)
        kernels["window_attention_bwd"].update(k4)
        check_attention_ragged_and_repeat(g)
        for name, kernel, smem in (
                ("window_attention", "window_attention_fwd_kernel",
                 wa.fwd_kernel_smem_bytes),
                ("window_attention_bwd", "window_attention_bwd_kernel",
                 wa.bwd_kernel_smem_bytes)):
            res = kernel_resources(builds["window_attention"].log, kernel)
            kernels[name].update(
                regs={str(c): r for c, (r, _) in res.items()},
                spill_bytes={str(c): sp for c, (_, sp) in res.items()},
                smem_bytes={str(c): smem(c) for c in (96, 192, 384)})
        k5, k6 = check_warp_gather(g)
        kernels["warp_gather_fwd"].update(k5)
        kernels["warp_gather_bwd"].update(k6)
        regs, spill = kernel_resources(builds["warp_gather"].log,
                                       "warp_gather_bwd_kernel")[0]
        kernels["warp_gather_bwd"].update(regs=regs, spill_bytes=spill)
        kernels["decoder_tail"].update(check_decoder_tail(g))
        regs, spill = kernel_resources(builds["decoder_tail"].log,
                                       "decoder_tail_kernel")[0]
        kernels["decoder_tail"].update(
            regs=regs, spill_bytes=spill,
            smem_bytes=dtl.kernel_smem_bytes())
        torch.cuda.empty_cache()
    if set(phases) & {"forward", "serve", "eval"}:
        state = init_params(STRAJNET_CONFIG, torch.Generator().manual_seed(0))
        if "forward" in phases or "serve" in phases:
            model = check_forward(state)
            if "serve" in phases:
                add_launches(serve(model))
            del model
            torch.cuda.empty_cache()
        if "eval" in phases:
            add_launches(eval_path(state))
            torch.cuda.empty_cache()
        del state
    if "train" in phases:
        add_launches(train_steps())
        add_launches(warp_gradient_path())

    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], **info)
        for name, info in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
