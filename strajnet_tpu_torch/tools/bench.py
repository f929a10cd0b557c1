"""Throughput of the flagship STrajNet on the card, with its spread.

    python -m strajnet_tpu_torch.tools.bench [--device cuda] [--repeats 5] \
        [--iters 10] [--budget_s 600]

Counterpart of the JAX package's ``bench.py``, at ``STRAJNET_CONFIG`` in
bf16 with weights from ``init_params`` (seed 0) and inputs from
``synthetic_batch`` (seed 0). Three phases, headline first:

1. ``forward`` at batch 16: the model in ``eval()`` under
   ``inference_mode``, in the default kernel mode (K1 in the 8 Swin blocks);
2. ``train`` at batch 16: ``create_train_state`` and ``make_train_step``
   (K1 and K2 in the 8 blocks, K5 in the loss), every bias drawn from
   N(0, 0.1) as ``chip_smoke.py`` does, since the init's zero biases
   overflow Nadam at this depth;
3. ``forward`` at batch 32, run only if the budget is not spent.

Each phase runs ``--repeats`` timed runs of ``--iters`` calls after a
warm-up, each run ending in a synchronise, timed by the host clock. It
prints min, median and max of ms per call and of scenes/s, the peak device
memory, and the launches of K1-K7 over the phase. ``flops`` is PyTorch's
``FlopCounterMode`` count of one call on the plain path
(``use_pallas_attention=False``; the counter does not see the port's
kernels), the training phase's forward, loss and backward; ``mfu`` is
``flops`` times calls per second at the median over the H100's dense bf16
peak, 989 TFLOP/s.

The first line names the card (:func:`~strajnet_tpu_torch.tools.timing.
gpu_identity`) and the torch and CUDA versions; then one JSON line per
phase; the last line is one JSON object with every phase that finished.
The deadline (``--budget_s`` from the start) is checked between phases. On
``--device cpu`` the times are the CPU's, and ``peak_mb`` and ``mfu`` are
null. Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List

import torch

from strajnet_tpu_torch.config import (STRAJNET_CONFIG, LossConfig,
                                       ModelConfig, TaskConfig, TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.tools.timing import (PEAK_BF16_FLOPS, count_flops,
                                             gpu_identity, launches_since,
                                             read_counters, spread)
from strajnet_tpu_torch.train.state import TrainState, create_train_state
from strajnet_tpu_torch.train.step import make_train_step, zero_loss_sums

HEADLINE_BATCH = 16
TRAIN_BATCH = 16
SWEEP_BATCH = 32
WARMUP = 2
# The model's keyword -> the batch's key.
MODEL_INPUTS = dict(ogm="ogm", map_img="map_image", obs="actors",
                    occ="occl_actors", mapt="centerlines", flow="vec_flow")
TRAIN_KEYS = ("gt_obs_ogm", "gt_occ_ogm", "gt_flow", "origin_flow")


def model_inputs(cfg: ModelConfig, batch: int, device: torch.device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """A synthetic batch as the model's keyword arguments, on ``device``."""
    b = synthetic_batch(cfg, batch, seed=seed)
    return {k: torch.from_numpy(b[src]).to(device)
            for k, src in MODEL_INPUTS.items()}


def train_batch(cfg: ModelConfig, batch: int, device: torch.device,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """A synthetic batch with the keys the training step reads."""
    b = synthetic_batch(cfg, batch, seed=seed)
    return {k: torch.from_numpy(b[k]).to(device)
            for k in tuple(MODEL_INPUTS.values()) + TRAIN_KEYS}


def load_model(cfg: ModelConfig, state: Dict[str, torch.Tensor],
               device: torch.device) -> STrajNet:
    model = STrajNet(cfg)
    model.load_state_dict(state)
    return model.to(device).eval()


def train_state(cfg: ModelConfig, batch: int, device) -> TrainState:
    """A train state from seed-0 weights with every bias drawn from
    N(0, 0.1) (seed 1) instead of the init's zeros: with zero biases a
    patch of an empty raster stays a constant token through every layer,
    and the squares of the bias gradients overflow f32 in Nadam's second
    moment at the flagship depth."""
    state = create_train_state(cfg, TrainConfig(batch_size=batch),
                               torch.Generator().manual_seed(0), device)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return state


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_runs(call: Callable, device: torch.device, repeats: int,
               iters: int) -> List[float]:
    """ms per call of ``repeats`` runs of ``iters`` calls, each run ending
    in a synchronise, after ``WARMUP`` calls."""
    for _ in range(WARMUP):
        call()
    synchronize(device)
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        synchronize(device)
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return runs


def _phase_line(phase: str, batch: int, device: torch.device, runs,
                flops: int, repeats: int, iters: int, before) -> dict:
    ms = spread(runs)
    on_card = device.type == "cuda"
    return {
        "phase": phase, "batch": batch, "device": device.type,
        "repeats": repeats, "iters": iters, "ms": ms,
        "scenes_per_s": spread([batch * 1e3 / t for t in runs]),
        "peak_mb": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                    if on_card else None),
        "flops": flops,
        "mfu": (flops * 1e3 / ms["median"] / PEAK_BF16_FLOPS
                if on_card else None),
        "calls": WARMUP + repeats * iters,
        "launches": launches_since(before),
    }


def bench_forward(cfg: ModelConfig, batch: int, device: torch.device,
                  repeats: int, iters: int) -> dict:
    state = init_params(cfg, torch.Generator().manual_seed(0))
    inputs = model_inputs(cfg, batch, device)
    with torch.inference_mode():
        plain = load_model(
            dataclasses.replace(cfg, use_pallas_attention=False), state,
            device)
        flops = count_flops(lambda: plain(**inputs))
        del plain
        model = load_model(cfg, state, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        before = read_counters()
        runs = timed_runs(lambda: model(**inputs), device, repeats, iters)
    return _phase_line("forward", batch, device, runs, flops, repeats, iters,
                       before)


def bench_train(cfg: ModelConfig, batch: int, device: torch.device,
                repeats: int, iters: int) -> dict:
    task = TaskConfig(grid_height_cells=cfg.output_size[0],
                      grid_width_cells=cfg.output_size[1],
                      num_waypoints=cfg.num_waypoints)
    step = make_train_step(task, LossConfig(), cfg.num_waypoints,
                           accumulate=True)
    data = train_batch(cfg, batch, device)
    noise = torch.Generator(device).manual_seed(0)
    plain = train_state(dataclasses.replace(cfg, use_pallas_attention=False),
                        batch, device)
    flops = count_flops(lambda: step(plain, data, noise,
                                     zero_loss_sums(device)))
    del plain
    state = train_state(cfg, batch, device)
    sums = zero_loss_sums(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    before = read_counters()

    def call():
        nonlocal state, sums
        state, sums = step(state, data, noise, sums)

    runs = timed_runs(call, device, repeats, iters)
    line = _phase_line("train", batch, device, runs, flops, repeats, iters,
                       before)
    line["loss_sum_finite"] = bool(torch.isfinite(sums["total"]))
    return line


def run(cfg: ModelConfig = STRAJNET_CONFIG, device="cuda", repeats: int = 5,
        iters: int = 10, budget_s: float = 600.0,
        emit: Callable[[str], None] = print) -> dict:
    """Runs the phases and returns the last line's object."""
    device = resolve_device(device)
    deadline = time.perf_counter() + budget_s
    versions = f"torch {torch.__version__} cuda {torch.version.cuda}"
    if device.type == "cuda":
        emit(f"{gpu_identity()}; {versions}")
    else:
        emit(f"device cpu; {versions}")
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "phases": {}, "skipped": []}
    phases = ((f"forward@{HEADLINE_BATCH}", bench_forward, HEADLINE_BATCH),
              (f"train@{TRAIN_BATCH}", bench_train, TRAIN_BATCH),
              (f"forward@{SWEEP_BATCH}", bench_forward, SWEEP_BATCH))
    for i, (name, fn, batch) in enumerate(phases):
        if i > 0 and time.perf_counter() > deadline:
            result["skipped"].append(name)
            continue
        line = fn(cfg, batch, device, repeats, iters)
        result["phases"][name] = line
        emit(json.dumps(line))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit(json.dumps(result))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing card raises")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--budget_s", type=float, default=600.0,
                   help="seconds from the start after which no further "
                        "phase begins")
    args = p.parse_args(argv)
    run(STRAJNET_CONFIG, args.device, args.repeats, args.iters, args.budget_s,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
