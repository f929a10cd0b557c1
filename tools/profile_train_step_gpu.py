"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 tools/profile_train_step_gpu.py [--out DIR] [--mode MODE]

Two measurements at the flagship ``STRAJNET_CONFIG``, batch 16, bf16, with
the seeded random weights of ``chip_smoke.py`` and synthetic batches:

1. One training step split by CUDA events into forward, loss, backward and
   optimizer, for the kernel path, ``"block_fwd"``, ``"attn"`` and the plain
   path, in the order plain, kernel, block_fwd, attn, attn, block_fwd,
   kernel, plain; peak memory.
2. The step of ``--mode`` (kernel, block_fwd, attn or plain; default kernel)
   under ``torch.profiler``: device time by kernel name over two steps, a
   summary of the port's own kernels (K1's and K2's window kernels over
   their three widths, their weight-packing kernels, the split-K pass of K2
   or K4), the device's busy share of the window.

It prints the card's name and power limit first and writes the tables to
``--out`` (default ``build/profile/``) as ``train_step_profile.txt``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from strajnet_tpu_torch.config import (  # noqa: E402
    STRAJNET_CONFIG, WAYMO_TASK_CONFIG, LossConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from strajnet_tpu_torch.objective.loss import (  # noqa: E402
    OGMFlowLoss, split_pred_waypoints, true_waypoints_from_batch)
from strajnet_tpu_torch.train.step import (  # noqa: E402
    _forward, ensure_f32, make_train_step)

LINES = []
# (row of the summary, what the kernel's name contains)
PORT_KERNELS = (
    ("K1 swin_block_fwd_kernel", "swin_block_fwd_kernel"),
    ("K1 pack_fwd_kernel (weights into tiles)", "pack_fwd_kernel"),
    ("K2 swin_block_bwd_window_kernel", "swin_block_bwd_window_kernel"),
    ("K2 pack_bwd_kernel (weights into tiles)", "pack_bwd_kernel"),
    ("K2 / K4 split-K atb_accum_sm90_kernel", "atb_accum_sm90_kernel"),
    ("K3 window_attention_fwd_kernel", "window_attention_fwd_kernel"),
    ("K3 pack_attn_fwd_kernel (weights into tiles)", "pack_attn_fwd_kernel"),
    ("K4 window_attention_bwd_kernel", "window_attention_bwd_kernel"),
    ("K4 pack_attn_bwd_kernel (weights into tiles)", "pack_attn_bwd_kernel"),
    ("K5 warp_gather_fwd", "warp_gather_fwd"),
    ("K6 warp_gather_bwd", "warp_gather_bwd"),
    ("K7 decoder_tail_kernel", "decoder_tail_kernel"),
    ("K7 pack_tail_weights_kernel", "pack_tail_weights_kernel"),
)
# --mode -> use_pallas_attention
MODES = {"kernel": None, "block_fwd": "block_fwd", "attn": "attn",
         "plain": False}


def say(line: str = "") -> None:
    print(line, flush=True)
    LINES.append(line)


def timed_step(state, batch, noise, loss_fn, num_waypoints):
    """One training step with CUDA events between its four parts."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    batch = ensure_f32(batch)
    true_waypoints = true_waypoints_from_batch(batch)
    state.optimizer.zero_grad(set_to_none=True)
    marks[0].record()
    outputs = _forward(state.model, batch, noise)
    marks[1].record()
    loss_dict = loss_fn(true_waypoints,
                        split_pred_waypoints(outputs, num_waypoints))
    total = sum(loss_dict.values())
    marks[2].record()
    total.backward()
    marks[3].record()
    state.optimizer.step()
    marks[4].record()
    torch.cuda.synchronize()
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]


def step_breakdown(batches) -> None:
    say("== one training step by CUDA events (ms): forward, loss, backward, "
        "optimizer; total ==")
    cfg = STRAJNET_CONFIG
    loss_fn = OGMFlowLoss(WAYMO_TASK_CONFIG, LossConfig())
    for mode in (False, None, "block_fwd", "attn", "attn", "block_fwd", None,
                 False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _ = cs.fresh_train_state(mode)
        noise = torch.Generator(device="cuda").manual_seed(0)
        timed_step(state, batches[0], noise, loss_fn, cfg.num_waypoints)
        parts = [timed_step(state, b, noise, loss_fn, cfg.num_waypoints)
                 for b in batches[1:]]
        mean = [sum(p[i] for p in parts) / len(parts) for i in range(4)]
        # the same step through the entry point, on the host's clock
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step(state, b, noise)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(batches[1:])
        say(f"mode {str(mode):9s}: " + ", ".join(f"{v:.3f}" for v in mean)
            + f"; {sum(mean):.3f}; make_train_step wall {wall:.3f} ms/step; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MB")
        del state, step


def step_profile(batches, mode: str) -> None:
    say(f"== {mode} path, two steps under torch.profiler ==")
    cfg = STRAJNET_CONFIG
    state, _ = cs.fresh_train_state(MODES[mode])
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints)
    noise = torch.Generator(device="cuda").manual_seed(0)
    state, _ = step(state, batches[0], noise)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[1:3]:
            state, _ = step(state, b, noise)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels only: an annotation such as the optimizer's step would count
    # its kernels a second time
    events = [ev for ev in prof.key_averages() if ev.device_time_total > 0
              and ev.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)
              and not ev.key.startswith("Optimizer.")]
    busy = sum(ev.device_time_total for ev in events) / 1e3
    say(f"window {wall:.3f} ms for 2 steps; device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} %), idle share "
        f"{100 * (1 - busy / wall):.1f} %")
    for ev in sorted(events, key=lambda e: -e.device_time_total)[:25]:
        say(f"    {ev.key[:80]:80s} {ev.count:5d} calls "
            f"{ev.device_time_total / 2e3:9.3f} ms per step")
    say("the port's own kernels, all widths together (ms per step, launches "
        "per step):")
    for label, needle in PORT_KERNELS:
        hits = [ev for ev in events if needle in ev.key]
        if hits:
            say(f"    {label:44s} "
                f"{sum(ev.device_time_total for ev in hits) / 2e3:9.3f} ms "
                f"{sum(ev.count for ev in hits) // 2:5d}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="build/profile")
    parser.add_argument("--mode", default="kernel", choices=sorted(MODES),
                        help="the Swin-block mode of the profiled step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device; none is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs._build.build_all(cs.KERNEL_SOURCES)
    keys = cs.MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow",
                            "origin_flow")
    batches = [cs.to_device(synthetic_batch(STRAJNET_CONFIG, cs.BATCH,
                                            seed=i), keys) for i in range(4)]
    step_breakdown(batches)
    step_profile(batches, args.mode)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "train_step_profile.txt"), "w") as f:
        f.write("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
