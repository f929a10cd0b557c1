"""Smoke test of the PyTorch port of STrajNet on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``strajnet_tpu_torch/csrc`` (one nvcc
process per source, started together) and holds each against its plain
PyTorch version at the shapes of the flagship model (batch 16, bf16):

- K1 ``swin_block`` and K2 ``swin_block_bwd`` at the four Swin-block
  geometries;
- K5 ``warp_gather_fwd`` and K6 ``warp_gather_bwd`` at ``[128, 256, 256, 1]``.

Then it drives the port's paths through their entry points with seeded
random weights at ``STRAJNET_CONFIG``, batch 16: the forward through the
kernel and through the plain path; three synthetic batches through
``infer.runner.run_shard``, whose submission it parses back; and three
training steps through ``train.state.create_train_state`` and
``train.step.make_train_step``, whose first step it repeats with the
``"block_fwd"`` mode and with the plain path (loss, whole gradient and
every parameter's gradient against the kernel path's); and the gradient of
``core.sampling.flow_warp_origin`` with respect to the warped image, the one
path that reaches K6 (the loss warps ground truth). The launch counters are
set to zero just before each path and read just after. Any failed check
raises and the script exits non-zero. The last line is a JSON object naming
the device; the line before it lists each kernel with its launches on those
paths, its error against the plain version, its times and its bound.

``--phases`` runs a subset (kernels, forward, serve, train) while developing;
with no arguments every phase runs.
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
from strajnet_tpu_torch.infer.proto import iter_fields  # noqa: E402
from strajnet_tpu_torch.infer.runner import run_shard  # noqa: E402
from strajnet_tpu_torch.infer.submission import (  # noqa: E402
    SCENARIO_ID, SCENARIO_WAYPOINTS, SUBMISSION_SCENARIO_PREDICTIONS)
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params  # noqa: E402
from strajnet_tpu_torch.ops.swin_block import (  # noqa: E402
    GRAD_NAMES, swin_block, swin_block_backward_reference, swin_block_bwd,
    swin_block_reference)
from strajnet_tpu_torch.ops.warp_gather import (  # noqa: E402
    gather_corners_reference, scatter_corners_reference, warp_gather_bwd,
    warp_gather_fwd)
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402
from strajnet_tpu_torch.train.state import create_train_state  # noqa: E402
from strajnet_tpu_torch.train.step import (  # noqa: E402
    make_predict_step, make_train_step)

BATCH = 16
KERNEL_SOURCES = ("swin_block", "swin_block_bwd", "warp_gather")
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
# worst leaf, a rel-pos bias table each time, 1.8e-4 and 6.6e-4).
STEP_LOSS_RTOL = {"block_fwd": 1e-6, False: 1e-2}
STEP_GRAD_ONE_MINUS_COS = {"block_fwd": 1e-5, False: 1e-4}
STEP_LEAF_ONE_MINUS_COS = {"block_fwd": 1e-3, False: 3e-3}
# Its gradient is zero but for rounding (it shifts every logit of a softmax
# row alike), so its direction is noise.
ZERO_GRAD_LEAVES = ("fg_msa_layer.proj_k.bias",)
# (H = W, C, heads, shift, blocks of this geometry in one forward)
GEOMETRIES = ((128, 96, 3, 0, 2), (128, 96, 3, 4, 2), (64, 192, 6, 4, 2),
              (32, 384, 12, 4, 2))
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")
PHASES = ("kernels", "forward", "serve", "train")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def one_minus_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return 1.0 - float((a @ b) / (a.norm() * b.norm()))


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
                 g: torch.Generator):
    dev, bf = "cuda", torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    args = (r(BATCH, h, h, c).to(bf),
            r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c, scale=0.1).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c, scale=0.1).to(bf),
            r(heads, 64, 64, scale=0.3),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 4 * c, scale=c ** -0.5).to(bf), r(4 * c, scale=0.1),
            r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), r(c, scale=0.1))
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(dev)
            if shift else None)
    dp = torch.rand(BATCH, 2, generator=g, device=dev) * 1.2
    return args, mask, dp


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
            t_plain = cuda_ms(lambda: swin_block_reference(*args, mask, dp,
                                                           **kw), iters=10)
            t_kernel = cuda_ms(lambda: swin_block(*args, mask, dp, **kw),
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
            t_kernel = cuda_ms(lambda: swin_block_bwd(*args, mask, dp, dy,
                                                      **kw), iters=5)
            t_plain = cuda_ms(lambda: swin_block_backward_reference(
                *args, mask, dp, dy, **kw), iters=2)
        t_autograd = cuda_ms(autograd_of_plain, iters=2)
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


def check_warp_gather(g: torch.Generator):
    """K5 and K6 against their plain versions at the loss's shapes: S = 16
    samples x 8 waypoints, 256 x 256 queries at identity + a flow of a few
    pixels, some of them past the border."""
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
    dimg = warp_gather_bwd((s, hp, wp), x0f, y0f, gs)
    torch.cuda.synchronize()
    rdimg = scatter_corners_reference((s, hp, wp), x0f, y0f, gs)
    err6 = float((dimg - rdimg).abs().max())
    scale6 = float(rdimg.abs().max())
    check(err6 <= K6_MAX_ABS_REL * scale6,
          f"K6 max_abs_err {err6} <= {K6_MAX_ABS_REL} * {scale6}")

    # one PyTorch call on precomputed int64 indices, as the yardstick
    base = (y0f.long() * wp + x0f.long())
    idx4 = torch.cat([base + o for o in (0, 1, wp, wp + 1)], dim=1)
    flat = img.reshape(s, hp * wp)
    rows = (torch.arange(s, device=dev) * (hp * wp))[:, None]
    idx_flat = (idx4 + rows).reshape(-1)
    src = torch.cat(gs, dim=1).reshape(-1)
    acc = torch.zeros(s * hp * wp, device=dev)
    t5 = cuda_ms(lambda: warp_gather_fwd(img, x0f, y0f))
    t5_plain = cuda_ms(lambda: gather_corners_reference(img, x0f, y0f))
    t5_lib = cuda_ms(lambda: torch.gather(flat, 1, idx4))
    t6 = cuda_ms(lambda: warp_gather_bwd((s, hp, wp), x0f, y0f, gs))
    t6_plain = cuda_ms(lambda: scatter_corners_reference((s, hp, wp), x0f,
                                                         y0f, gs))
    t6_lib = cuda_ms(lambda: acc.index_add_(0, idx_flat, src))
    b5, by5 = bound(0.0, img.numel() * 4 + 2 * s * n * 4 + 4 * s * n * 4)
    b6, by6 = bound(0.0, 6 * s * n * 4 + img.numel() * 4)
    print(f"K5 warp_gather_fwd [{s},{hp},{wp}] x [{s},{n}] ({outside} "
          f"queries past the border): max_abs_err={err5} kernel_ms={t5:.4f} "
          f"plain_ms={t5_plain:.4f} torch.gather_ms={t5_lib:.4f} "
          f"bound_ms={b5:.4f}")
    print(f"K6 warp_gather_bwd: max_abs_err={err6} (max|ref|={scale6}) "
          f"kernel_ms={t6:.4f} plain_ms={t6_plain:.4f} "
          f"index_add_ms={t6_lib:.4f} bound_ms={b6:.4f}")
    return (dict(max_abs_err=err5, ms=t5, plain_ms=t5_plain, bound_ms=b5,
                 bound_by=by5, library_ms=t5_lib),
            dict(max_abs_err=err6, ms=t6, plain_ms=t6_plain, bound_ms=b6,
                 bound_by=by6, library_ms=t6_lib))


def to_device(batch, keys=MODEL_KEYS):
    return {k: torch.from_numpy(batch[k]).cuda() for k in keys}


def forward(model, b):
    return model(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
                 occ=b["occl_actors"], mapt=b["centerlines"],
                 flow=b["vec_flow"])


COUNTERS = (swin_block, swin_block_bwd, warp_gather_fwd, warp_gather_bwd)


def reset_counters() -> None:
    for fn in COUNTERS:
        fn.launches = 0


def read_counters():
    return tuple(fn.launches for fn in COUNTERS)


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
        check(per_forward == (8, 0, 0, 0), f"8 K1 launches per forward and "
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
    check(launches == (3 * 8, 0, 0, 0),
          f"24 K1 launches on the served path and no other, got {launches}")
    return launches[0]


def warp_gradient_path():
    """``core.sampling.flow_warp_origin`` differentiated with respect to the
    warped image, the one caller that reaches K6 (the loss warps ground
    truth, which needs no gradient). Held against the portable path
    ``core.sampling.sample`` under autograd. Returns (K5, K6) launches."""
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
    check(got == (0, 0, 1, 1), f"one K5 and one K6 launch, got {got}")
    for name, a, b in zip(("warped", "d/d image", "d/d flow"), *grads):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"flow_warp_origin kernel vs portable path, {name}: "
              f"max_abs_err={err} (max|ref|={scale})")
        check(err <= 1e-5 * scale, f"{name}: {err} <= 1e-5 * {scale}")
    return got[2], got[3]


def fresh_train_state(mode):
    """A train state from seed-0 weights in the given Swin-block mode, with
    every bias drawn from N(0, 0.1) instead of the init's zeros.

    With all biases zero, a patch of an empty raster stays a constant token
    through every layer, each LayerNorm multiplies the gradient of the bias
    directions by eps^-1/2 = 316, and at this depth the squares of those
    gradients overflow f32 in Nadam's second moment, so such a parameter
    would never move. The JAX package computes the same gradients
    (``tests/test_torch_train_step.py`` holds the port to them at a small
    depth, where they already reach 1e25). Random biases keep the checks of
    this smoke out of that corner; :func:`real_init_report` prints what one
    step from the init itself does."""
    cfg = dataclasses.replace(STRAJNET_CONFIG, use_pallas_attention=mode)
    state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                               torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return state, cfg


def _first_step(mode, batch):
    """One training step from those weights and seed-0 noise: (loss dict,
    flat gradient, initial parameters, state, step function, noise)."""
    state, cfg = fresh_train_state(mode)
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
    then one step from the init's own zero biases, reported only.
    Returns the launches of (K1, K2, K5, K6) over the three steps."""
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
    check(read_counters() == (8, 8, 1, 0),
          f"launches of K1/K2/K5/K6 in one step are 8/8/1/0, got "
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
    check(launches == (24, 24, 3, 0),
          f"launches of K1/K2/K5/K6 over three steps are 24/24/3/0, got "
          f"{launches}")
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
          f"memory {peak_mb:.0f} MB; launches K1/K2/K5/K6 = {launches}")
    model = state.model
    del state, step

    total = float(losses["total"])
    for mode, expect in (("block_fwd", (8, 0, 1, 0)), (False, (0, 0, 1, 0))):
        reset_counters()
        other_losses, other_grads = _first_step(mode, batches[0])[:2]
        got = read_counters()
        check(got == expect, f"mode {mode!r}: launches {got}, expected "
                             f"{expect}")
        other = float(other_losses["total"])
        omc = one_minus_cos(grads, other_grads)
        leaves = worst_leaves(model, grads, other_grads)
        print(f"first step, mode {mode!r} vs kernel path: total loss "
              f"{other:.6f} vs {total:.6f}; gradient 1-cos={omc:.3e}; worst "
              f"leaves by 1-cos (share of the gradient's norm): "
              + ", ".join(f"{n} {v:.3e} ({share:.1e})"
                          for v, share, n in leaves))
        check(abs(other - total) <= STEP_LOSS_RTOL[mode] * abs(total),
              f"mode {mode!r}: loss {other} within {STEP_LOSS_RTOL[mode]} "
              f"of {total}")
        check(omc <= STEP_GRAD_ONE_MINUS_COS[mode],
              f"mode {mode!r}: gradient 1-cos {omc} <= "
              f"{STEP_GRAD_ONE_MINUS_COS[mode]}")
        check(leaves[0][0] <= STEP_LEAF_ONE_MINUS_COS[mode],
              f"mode {mode!r}: worst leaf {leaves[0][2]} 1-cos "
              f"{leaves[0][0]} <= {STEP_LEAF_ONE_MINUS_COS[mode]}")
        del other_grads
    del model
    torch.cuda.empty_cache()
    real_init_report(batches[0])
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

    kernels = {
        "swin_block": dict(
            source="strajnet_tpu_torch/csrc/swin_block.cu",
            replaces="strajnet_tpu/ops/pallas_swin_block.py:82"),
        "swin_block_bwd": dict(
            source="strajnet_tpu_torch/csrc/swin_block_bwd.cu",
            replaces="strajnet_tpu/ops/pallas_swin_block.py:143"),
        "warp_gather_fwd": dict(
            source="strajnet_tpu_torch/csrc/warp_gather.cu",
            replaces="strajnet_tpu/ops/pallas_warp_gather.py:57"),
        "warp_gather_bwd": dict(
            source="strajnet_tpu_torch/csrc/warp_gather.cu",
            replaces="strajnet_tpu/ops/pallas_warp_gather.py:83"),
    }
    launches = dict.fromkeys(kernels, 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    if "kernels" in phases:
        kernels["swin_block"].update(check_swin_block(g))
        kernels["swin_block_bwd"].update(check_swin_block_bwd(g))
        k5, k6 = check_warp_gather(g)
        kernels["warp_gather_fwd"].update(k5)
        kernels["warp_gather_bwd"].update(k6)
    if "forward" in phases or "serve" in phases:
        state = init_params(STRAJNET_CONFIG, torch.Generator().manual_seed(0))
        model = check_forward(state)
        if "serve" in phases:
            launches["swin_block"] += serve(model)
        del model, state
        torch.cuda.empty_cache()
    if "train" in phases:
        for name, count in zip(kernels, train_steps()):
            launches[name] += count
        k5_launches, k6_launches = warp_gradient_path()
        launches["warp_gather_fwd"] += k5_launches
        launches["warp_gather_bwd"] += k6_launches

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
