"""What the training loop adds to the bare step, on one NVIDIA GPU.

    python3 tools/profile_loop_gpu.py [--steps N]

At the flagship ``STRAJNET_CONFIG``, batch 16, on ``N`` (default 12)
synthetic compact-feed batches (uint8 grids, f16 map, as the loop's reader
and ``chip_smoke.py``'s loop phase feed them), from the smoke's
``fresh_train_state`` (random biases), one warm state throughout:

- ``bare``: ``make_train_step(accumulate=True)`` on batches already on the
  card;
- ``prefetch``: the same steps fed by ``data/pipeline.py::
  prefetch_to_device`` from the numpy batches, as the loop feeds them; the
  time to the first batch is also given apart;
- ``pageable``: fed by one pageable copy per batch when its step comes;
- ``staging``: bare steps while a thread copies other numpy batches into
  pinned buffers (the producer's host work, without its copies to the card);

in the order bare, prefetch, pageable, staging and back, ms/step of each
turn (host clock around synchronised runs). Then the per-step times of the
first steps of a new train state's model, which every start of the loop
pays; and the bare step of ``STRAJNET_TRAIN_PY_CONFIG`` (no FG-MSA)
against ``STRAJNET_CONFIG``'s, each warm, in turns, with the peak memory
of each. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.config import (  # noqa: E402
    STRAJNET_CONFIG, STRAJNET_TRAIN_PY_CONFIG, WAYMO_TASK_CONFIG, LossConfig)
from strajnet_tpu_torch.data.pipeline import prefetch_to_device  # noqa: E402
from strajnet_tpu_torch.train.step import (  # noqa: E402
    make_train_step, zero_loss_sums)
from strajnet_tpu_torch.tools.timing import gpu_identity  # noqa: E402


def run(state, step, feed, noise):
    """Steps over ``feed``; (ms per step, ms to the first batch)."""
    sums = zero_loss_sums("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = None
    n = 0
    for batch in feed:
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
        state, sums = step(state, batch, noise, sums)
        n += 1
    values = torch.stack(list(sums.values())).tolist()
    if not all(np.isfinite(v) for v in values):
        raise RuntimeError(f"losses not finite: {values}")
    return (time.perf_counter() - t0) * 1e3 / n, first


def staging_thread(batches, stop):
    """Copies ``batches`` into pinned buffers over and over until ``stop``."""
    buffers = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                              pin_memory=True)
               for k, v in batches[0].items()}
    while not stop.is_set():
        for batch in batches:
            for k, v in batch.items():
                np.copyto(buffers[k].numpy(), v, casting="no")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device; none is available", file=sys.stderr)
        return 1
    print(gpu_identity())
    _build.build_all(cs.KERNEL_SOURCES)
    cfg = STRAJNET_CONFIG
    batches = [cs.compact_feed(b) for b in
               cs.eval_inputs(cfg, range(500, 500 + args.steps))]
    others = [cs.compact_feed(b) for b in cs.eval_inputs(cfg, (600, 601))]
    on_card = [cs.to_device(b, tuple(b)) for b in batches]
    state, _ = cs.fresh_train_state(None)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints,
                           accumulate=True)
    noise = torch.Generator(device="cuda").manual_seed(0)
    run(state, step, on_card[:2], noise)                  # warm-up
    list(prefetch_to_device(batches[:1], "cuda"))         # pinned cache

    def staged():
        stop = threading.Event()
        thread = threading.Thread(target=staging_thread, args=(others, stop))
        thread.start()
        try:
            return run(state, step, on_card, noise)
        finally:
            stop.set()
            thread.join()

    feeds = {
        "bare": lambda: run(state, step, on_card, noise),
        "prefetch": lambda: run(state, step,
                                prefetch_to_device(batches, "cuda"), noise),
        "pageable": lambda: run(state, step, cs.pageable_copies(
            batches, "cuda"), noise),
        "staging": staged,
    }
    order = list(feeds) + list(feeds)[::-1]
    results = {name: [] for name in feeds}
    for name in order:
        results[name].append(feeds[name]())
    print(f"STRAJNET_CONFIG, batch {cs.BATCH}, "
          f"{args.steps} steps a turn, turns in the order {order}:")
    for name, turns in results.items():
        ms = [t[0] for t in turns]
        print(f"  {name}: {np.mean(ms):.1f} ms/step ("
              + ", ".join(f"{t:.1f}" for t in ms) + ")"
              + (f"; first batch after "
                 + ", ".join(f"{t[1]:.1f}" for t in turns) + " ms"
                 if name in ("prefetch", "pageable") else ""))
    del state, on_card
    torch.cuda.empty_cache()

    # a new model object's first steps (each synchronised)
    state, _ = cs.fresh_train_state(None)
    on_card = [cs.to_device(b, tuple(b)) for b in batches[:6]]
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints,
                           accumulate=True)
    per_step = []
    for b in on_card:
        per_step.append(run(state, step, [b], noise)[0])
    print("  a new train state's first steps, each synchronised: "
          + ", ".join(f"{t:.1f}" for t in per_step) + " ms")
    del state

    # the two variants' bare steps, warm, in turns
    variants = {}
    for name, base in (("STRAJNET_CONFIG", STRAJNET_CONFIG),
                       ("STRAJNET_TRAIN_PY_CONFIG", STRAJNET_TRAIN_PY_CONFIG)):
        state, _ = cs.fresh_train_state(None, base=base)
        run(state, step, on_card[:2], noise)              # warm-up
        variants[name] = [state, [], 0.0]
    for name in list(variants) + list(variants)[::-1]:
        state = variants[name][0]
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        variants[name][1].append(run(state, step, on_card, noise)[0])
        variants[name][2] = max(variants[name][2], (
            torch.cuda.max_memory_allocated() - held) / 2 ** 20)
    for name, (state, ms, peak) in variants.items():
        state_mb = 3 * sum(p.numel() * 4 for p in state.model.parameters()
                           ) / 2 ** 20
        print(f"  bare step, {name}: {np.mean(ms):.1f} ms/step ("
              + ", ".join(f"{t:.1f}" for t in ms) + f"); the step's peak "
              f"{peak:.0f} MB above what was held before it; parameters "
              f"and Nadam moments {state_mb:.0f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
