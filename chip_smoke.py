"""Smoke test of the PyTorch port of STrajNet on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``strajnet_tpu_torch/csrc``, holds it
against its plain PyTorch version at the four Swin-block geometries of the
flagship model (batch 16, bf16), runs the flagship ``STRAJNET_CONFIG``
forward at batch 16 with seeded random weights through the kernel and
through the plain path, and serves three synthetic batches of 16 through the
inference entry point ``strajnet_tpu_torch.infer.runner.run_shard``, whose
submission it parses back. Any failed check raises and the script exits
non-zero. The last line is a JSON object naming the device; the line before
it lists each kernel with its launches on the served path, its error against
the plain version and both times.
"""

from __future__ import annotations

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

from strajnet_tpu.config import STRAJNET_CONFIG  # noqa: E402
from strajnet_tpu.data.synthetic import synthetic_batch  # noqa: E402
from strajnet_tpu.infer.proto import iter_fields  # noqa: E402
from strajnet_tpu.infer.submission import (  # noqa: E402
    SCENARIO_ID, SCENARIO_WAYPOINTS, SUBMISSION_SCENARIO_PREDICTIONS)
from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.infer.runner import run_shard  # noqa: E402
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params  # noqa: E402
from strajnet_tpu_torch.ops.swin_block import (  # noqa: E402
    swin_block, swin_block_reference)
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402
from strajnet_tpu_torch.train.step import make_predict_step  # noqa: E402

BATCH = 16
# K1 vs its plain version, both bf16 with f32 accumulation but rounding at
# different points: at most 4 bf16 ulps of the largest output, and 1 - cos
# at bf16 noise level.
K1_MAX_ABS_REL = 2.0 ** -5
K1_ONE_MINUS_COS = 1e-4
# Whole bf16 forward, kernel path vs plain path: the block-level rounding
# differences pass through ~60 more bf16 layers.
FWD_ONE_MINUS_COS = 1e-3
# bf16 kernel forward vs the f32 plain forward of the same weights.
F32_ONE_MINUS_COS = 1e-3
# (H = W, C, heads, shift, blocks of this geometry in one forward)
GEOMETRIES = ((128, 96, 3, 0, 2), (128, 96, 3, 4, 2), (64, 192, 6, 4, 2),
              (32, 384, 12, 4, 2))
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")


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


def check_swin_block(g: torch.Generator):
    """K1 against swin_block_reference; returns (max_abs_err, ms, plain_ms)
    with the times summed over the eight blocks of one forward."""
    worst, ms, plain_ms = 0.0, 0.0, 0.0
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
                                                           **kw))
            t_kernel = cuda_ms(lambda: swin_block(*args, mask, dp, **kw))
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
    return worst, ms, plain_ms


def to_device(batch, keys=MODEL_KEYS):
    return {k: torch.from_numpy(batch[k]).cuda() for k in keys}


def forward(model, b):
    return model(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
                 occ=b["occl_actors"], mapt=b["centerlines"],
                 flow=b["vec_flow"])


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
        swin_block.launches = 0
        y = forward(model, batch)
        torch.cuda.synchronize()
        per_forward = swin_block.launches
        y_plain = forward(plain, batch)
        check(per_forward == 8, f"8 K1 launches per forward, got "
                                f"{per_forward}")
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
        t = [cuda_ms(lambda: forward(m, batch), iters=5)
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
        swin_block.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = run_shard(model, make_predict_step(cfg.num_waypoints),
                          "00000new.tfrecords", ids, out_dir,
                          batch_size=BATCH, batches=batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = swin_block.launches
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
          f"{launches} K1 launches")
    check(count == 3 * BATCH and len(scenarios) == 3 * BATCH,
          f"48 scenarios written and parsed, got {count}/{len(scenarios)}")
    check(parsed_ids == ids, "parsed scenario ids match")
    check(launches == 3 * 8, f"24 K1 launches on the served path, got "
                             f"{launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    build = _build.build("swin_block")
    print(f"nvcc build of swin_block: {build.seconds:.2f} s"
          + (" (up-to-date build found)" if build.seconds == 0 else ""))
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err, ms, plain_ms = check_swin_block(g)
    state = init_params(STRAJNET_CONFIG, torch.Generator().manual_seed(0))
    model = check_forward(state)
    launches = serve(model)

    print(json.dumps({"kernels": [{
        "name": "swin_block", "route": "cuda",
        "source": "strajnet_tpu_torch/csrc/swin_block.cu",
        "replaces": "strajnet_tpu/ops/pallas_swin_block.py:82",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
