"""Timing on the card, the H100's published peaks, and the kernels' launch
counters: what ``chip_smoke.py`` and the tools of this package share.

A time here is the card's: CUDA events, the host clock around work that
ends in a synchronise, or the sum of the kernels' times in a profiler
trace. The peaks are those of one H100 SXM at its full 700 W
power limit; :func:`gpu_identity` says which card a reading came from and
at what limit.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from strajnet_tpu_torch.ops import decoder_tail as _tail
from strajnet_tpu_torch.ops import swin_block as _block
from strajnet_tpu_torch.ops import warp_gather as _gather
from strajnet_tpu_torch.ops import window_attention as _attn

# Published peaks of one H100 SXM: bf16 dense tensor-core rate, f32 rate
# outside the tensor cores, HBM rate. f32 products on the tensor cores as
# three TF32 passes (the general window kernels) run at a third of the TF32
# rate, 495 / 3 TFLOP/s.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12

# Clock cycles the card idles per timed launch while the host enqueues
# (about 1 ms at the H100's clock): see cuda_ms.
AHEAD_CYCLES = 2_000_000

# K1 .. K7: the wrappers whose ``launches`` count their kernel's launches
# (the wgmma route of K1-K4 and K7).
COUNTERS = dict(k1=_block.swin_block, k2=_block.swin_block_bwd,
                k3=_attn.window_attention, k4=_attn.window_attention_bwd,
                k5=_gather.warp_gather_fwd, k6=_gather.warp_gather_bwd,
                k7=_tail.decoder_tail)
# The general route of K1-K4 and K7 (``csrc/window_any.cu``,
# ``csrc/decoder_tail_any.cu``): the same wrappers' ``launches_any``.
GENERAL_COUNTERS = dict(k1=_block.swin_block, k2=_block.swin_block_bwd,
                        k3=_attn.window_attention,
                        k4=_attn.window_attention_bwd, k7=_tail.decoder_tail)


def gpu_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def cuda_ms(fn: Callable, iters: int = 20, ahead: bool = False) -> float:
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


def kernel_ms(fn: Callable, iters: int = 20) -> float:
    """The device's time of one run of ``fn`` (a kernel, its plain version
    or a PyTorch call), host work between runs hidden."""
    return cuda_ms(fn, iters, ahead=True)


def device_busy_ms(fn: Callable, iters: int = 20) -> float:
    """Mean ms the card works on one run of ``fn``: the sum of the device
    times of its kernels and copies in a ``torch.profiler`` trace of
    ``iters`` runs, after one warm-up. The gaps where the card waits on the
    host are left out, however long the host takes to enqueue a run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("the profiler's trace holds no device time")
    return busy_us / 1e3 / iters


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """(least ms on the card, which of the two rates sets it), the
    operations at ``peak_flops`` (the bf16 tensor-core rate by default)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def count_flops(fn: Callable) -> int:
    """Floating-point operations of one call of ``fn`` as PyTorch's
    ``FlopCounterMode`` counts them: matrix products, convolutions and
    attention, two per multiply-add. It sees only PyTorch's own operators,
    not the port's kernels, so count the plain path."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def reset_counters() -> None:
    """Sets the launches of both routes to 0."""
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn in GENERAL_COUNTERS.values():
        fn.launches_any = 0


def read_general_counters() -> Tuple[int, ...]:
    """The general route's launches of K1, K2, K3, K4 and K7 since
    :func:`reset_counters`."""
    return tuple(fn.launches_any for fn in GENERAL_COUNTERS.values())


def read_counters() -> Tuple[int, ...]:
    """The launches of K1 .. K7 since :func:`reset_counters`."""
    return tuple(fn.launches for fn in COUNTERS.values())


def launches_since(before: Sequence[int]) -> Dict[str, int]:
    """The launches of K1 .. K7 since ``before = read_counters()``, by name,
    ``{"k1": n, ...}``. The counters run on, so a caller that reset them
    around a larger piece of work still reads all of it."""
    return {k: n - b for k, n, b in zip(COUNTERS, read_counters(), before)}


def spread(values: Sequence[float]) -> Dict[str, float]:
    """``{"min", "median", "max"}`` of repeated readings."""
    return {"min": min(values), "median": statistics.median(values),
            "max": max(values)}
