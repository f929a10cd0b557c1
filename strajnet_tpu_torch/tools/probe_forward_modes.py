"""The flagship forward per decoder-tail form x attention mode x batch, timed
in turns on the card.

    python -m strajnet_tpu_torch.tools.probe_forward_modes [--device cuda] \
        [--batch 16 32] [--tails xla phase kernel infer] \
        [--modes block attn off] [--rounds 5] [--iters 5]

Counterpart of the JAX package's ``tools/probe_forward_modes.py``: judges a
formulation inside the whole forward, where its neighbours run too. Every
model is built once from one ``init_params`` state (seed 0) at
``STRAJNET_CONFIG`` in ``eval()``, and runs under ``inference_mode`` on
``synthetic_batch`` inputs (seed 0). The tails are
``use_pallas_decoder_tail``'s forms (``kernel`` and ``infer`` both run K7
in ``eval()``); the modes are the CLIs' ``--pallas`` names
(``models/strajnet.py::PALLAS_MODES``): ``block`` (K1), ``attn`` (K3) and
``off`` (the plain path). After one warm-up call of
each combination, which also counts its launches of K1, K3 and K7, come
``--rounds`` rounds, each visiting every combination once for ``--iters``
calls ending in a synchronise (host clock), so that drift of the card or
the host hits all combinations alike. It prints min, median and max of ms
per forward and of scenes/s per combination, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from typing import Callable, Sequence

import torch

from strajnet_tpu_torch.config import STRAJNET_CONFIG, ModelConfig
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import PALLAS_MODES, init_params
from strajnet_tpu_torch.tools.bench import (load_model, model_inputs,
                                            synchronize)
from strajnet_tpu_torch.tools.timing import (gpu_identity, launches_since,
                                             read_counters, spread)

TAILS = ("xla", "phase", "kernel", "infer")
MODES = ("block", "attn", "off")


def run(cfg: ModelConfig = STRAJNET_CONFIG, device="cuda",
        batches: Sequence[int] = (16,), tails: Sequence[str] = TAILS,
        modes: Sequence[str] = MODES, rounds: int = 5, iters: int = 5,
        emit: Callable[[str], None] = print) -> dict:
    """Returns ``{"<tail>/<mode>/<batch>": {"ms", "scenes_per_s",
    "launches_per_forward"}}``."""
    device = resolve_device(device)
    unknown = (set(tails) - set(TAILS)) | (set(modes) - set(MODES))
    if unknown:
        raise ValueError(f"unknown tails or modes {sorted(unknown)}")
    emit(gpu_identity() if device.type == "cuda" else "device cpu")
    state = init_params(cfg, torch.Generator().manual_seed(0))
    models = {(t, m): load_model(dataclasses.replace(
        cfg, use_pallas_decoder_tail=t, use_pallas_attention=PALLAS_MODES[m]),
        state, device) for t, m in itertools.product(tails, modes)}
    inputs = {b: model_inputs(cfg, b, device) for b in batches}
    combos = [(t, m, b) for b in batches for t, m in models]
    runs = {c: [] for c in combos}
    launches = {}
    with torch.inference_mode():
        for t, m, b in combos:
            before = read_counters()
            models[t, m](**inputs[b])
            synchronize(device)
            counts = launches_since(before)
            launches[t, m, b] = {k: counts[k] for k in ("k1", "k3", "k7")}
        for _ in range(rounds):
            for t, m, b in combos:
                model, x = models[t, m], inputs[b]
                t0 = time.perf_counter()
                for _ in range(iters):
                    model(**x)
                synchronize(device)
                runs[t, m, b].append((time.perf_counter() - t0) * 1e3 / iters)
    result = {}
    for t, m, b in combos:
        ms = spread(runs[t, m, b])
        sps = spread([b * 1e3 / v for v in runs[t, m, b]])
        result[f"{t}/{m}/{b}"] = dict(ms=ms, scenes_per_s=sps,
                                      launches_per_forward=launches[t, m, b])
        k = launches[t, m, b]
        emit(f"tail={t:6s} mode={m:5s} batch={b}: ms/forward "
             f"{ms['min']:.3f} / {ms['median']:.3f} / {ms['max']:.3f} "
             f"(min/median/max of {rounds}), scenes/s {sps['median']:.1f}; "
             f"launches K1/K3/K7 per forward {k['k1']}/{k['k3']}/{k['k7']}")
    emit(json.dumps({"device": device.type, "rounds": rounds, "iters": iters,
                     "combinations": result}))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing card raises")
    p.add_argument("--batch", type=int, nargs="+", default=[16])
    p.add_argument("--tails", nargs="+", choices=TAILS, default=list(TAILS))
    p.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    run(STRAJNET_CONFIG, args.device, args.batch, args.tails, args.modes,
        args.rounds, args.iters, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
