"""Time, FLOPs and bytes of each part of the flagship forward on the card.

    python -m strajnet_tpu_torch.tools.profile_parts [--device cuda] \
        [--batch 16] [--iters 20] [part ...]

Counterpart of the JAX package's ``tools/profile_parts.py``. Parts (default
the five coarse ones, ``full encoder fgmsa trajnet decoder``):

- ``full``: the model; ``encoder``, ``fgmsa``, ``trajnet``, ``decoder``: its
  four submodules; ``fgmsa_nope``: FG-MSA with its rel-pos bias skipped (a
  copy of the module with ``use_pe`` off, on FG-MSA's inputs);
- ``enc_embed``: the patch embeds and their norms; ``enc_flow`` and
  ``enc_stage0..2``: the flow branch's Swin stage and the three stages;
- ``dec_up3``, ``dec_up2``, ``dec_up1``, ``dec_upf1``: the decoder's
  up-convolutions; ``dec_tail_occ``, ``dec_tail_flow``: its two tails (the
  last up-convolution, elu and the output convolution); ``dec_res``: the
  three temporal convolutions of the residuals.

One forward of ``STrajNet(STRAJNET_CONFIG)`` (bf16, K1 in the Swin blocks,
weights from ``init_params`` seed 0, ``synthetic_batch`` seed 0) runs under
forward hooks that keep each part's inputs and outputs. Each part then runs
alone on its inputs, ``--iters`` runs for each of two times: the wall time
a run by CUDA events (what a caller waits, the host's enqueueing included)
and the card's busy time a run, the sum of its kernels' device times in a
``torch.profiler`` trace (the gaps where the card waits on the host left
out). Beside them: the part's FLOPs on the plain path (``FlopCounterMode``,
which does not see the port's kernels), its bytes in (inputs and
parameters) and out, and the achieved TFLOP/s and GB/s of the busy time
against the H100's 989 TFLOP/s and 3.35 TB/s. The sums of the coarse parts
stand beside ``full``. On ``--device cpu`` the wall time is the host
clock's, and there is no busy time.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from strajnet_tpu_torch.config import STRAJNET_CONFIG, ModelConfig
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.tools.bench import (load_model, model_inputs,
                                            synchronize)
from strajnet_tpu_torch.tools.timing import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES,
                                             count_flops, cuda_ms,
                                             device_busy_ms, gpu_identity)

COARSE = ("full", "encoder", "fgmsa", "trajnet", "decoder")
# part -> the submodules whose calls make it ("" is the model)
MODULE_PARTS = {
    "full": ("",), "encoder": ("encoder",), "fgmsa": ("fg_msa_layer",),
    "fgmsa_nope": ("fg_msa_layer",), "trajnet": ("trajnet_attn",),
    "decoder": ("decoder",),
    "enc_embed": tuple(f"encoder.{n}" for n in (
        "patch_embed_flow", "flow_norm", "patch_embed_vehicle",
        "patch_embed_map", "all_patch_norm")),
    "enc_flow": ("encoder.flow_layer",),
    **{f"enc_stage{i}": (f"encoder.layers{i}",) for i in range(3)},
    "dec_up3": ("decoder.upconv_3_0",), "dec_up2": ("decoder.upconv_2_0",),
    "dec_up1": ("decoder.upconv_1_0",), "dec_upf1": ("decoder.upconvf_1_0",),
    "dec_res": ("decoder.resconv_3", "decoder.resconv_2",
                "decoder.resconv_f"),
}
# part -> the up-convolution whose call of ``Pyramid3DDecoder._tail`` it is
TAIL_PARTS = {"dec_tail_occ": "decoder.upconv_0_0",
              "dec_tail_flow": "decoder.upconvf_0_0"}
PARTS = tuple(MODULE_PARTS) + tuple(TAIL_PARTS)


@dataclasses.dataclass
class Call:
    """One call inside the forward: ``fn(*args, **kwargs) -> output``."""

    fn: Callable
    args: tuple
    kwargs: dict
    output: object


def capture(model: STrajNet, inputs: Dict[str, torch.Tensor],
            parts: Sequence[str]) -> Dict[str, List[Call]]:
    """Runs ``model(**inputs)`` once, under ``inference_mode``, and returns
    each part's calls with their inputs and outputs. A submodule the
    configuration does not build is left out of its part."""
    calls = {p: [] for p in parts}
    handles = []

    def record(part):
        def hook(module, args, kwargs, output):
            calls[part].append(Call(module, args, kwargs, output))
        return hook

    for part in parts:
        for path in MODULE_PARTS.get(part, ()):
            try:
                module = model.get_submodule(path)
            except AttributeError:
                continue
            handles.append(module.register_forward_hook(
                record(part), with_kwargs=True))
    decoder = model.decoder
    tails = {id(model.get_submodule(path)): part
             for part, path in TAIL_PARTS.items() if part in parts}
    tail = decoder._tail

    def recorded_tail(up, out, x):
        y = tail(up, out, x)
        if id(up) in tails:
            calls[tails[id(up)]].append(Call(tail, (up, out, x), {}, y))
        return y

    decoder._tail = recorded_tail
    try:
        with torch.inference_mode():
            model(**inputs)
    finally:
        del decoder._tail
        for h in handles:
            h.remove()
    if "fgmsa_nope" in calls:
        nope = copy.deepcopy(model.fg_msa_layer)
        nope.use_pe = False
        calls["fgmsa_nope"] = [dataclasses.replace(c, fn=nope)
                               for c in calls["fgmsa_nope"]]
    return calls


def run_part(calls: List[Call]) -> list:
    """The part alone: each call again on its captured inputs."""
    with torch.inference_mode():
        return [c.fn(*c.args, **c.kwargs) for c in calls]


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        yield from obj.parameters()
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def part_bytes(calls: List[Call]):
    """(bytes in: inputs and the modules' parameters, bytes out)."""
    def nbytes(obj):
        return sum(t.numel() * t.element_size() for t in _tensors(obj))
    return (sum(nbytes([c.fn, c.args, c.kwargs]) for c in calls),
            sum(nbytes(c.output) for c in calls))


def part_ms(calls: List[Call], device: torch.device,
            iters: int) -> Tuple[float, Optional[float]]:
    """(wall ms a run, the card's busy ms a run or None off the card)."""
    if device.type == "cuda":
        return (cuda_ms(lambda: run_part(calls), iters),
                device_busy_ms(lambda: run_part(calls), iters))
    run_part(calls)
    t0 = time.perf_counter()
    for _ in range(iters):
        run_part(calls)
    return (time.perf_counter() - t0) * 1e3 / iters, None


def run(cfg: ModelConfig = STRAJNET_CONFIG, device="cuda", batch: int = 16,
        iters: int = 20, parts: Sequence[str] = COARSE,
        emit: Callable[[str], None] = print) -> dict:
    """Returns ``{part: {"ms", "device_ms", "flops", "bytes_in",
    "bytes_out", "tflops", "gbytes_per_s", "peak_flops_share",
    "peak_bytes_share"}}``: ``ms`` is the wall time a run, ``device_ms`` the
    card's busy time a run, which the rates and the shares of the H100's
    peaks divide; off the card those are null."""
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}; choose from "
                         f"{list(PARTS)}")
    device = resolve_device(device)
    emit(gpu_identity() if device.type == "cuda" else "device cpu")
    state = init_params(cfg, torch.Generator().manual_seed(0))
    inputs = model_inputs(cfg, batch, device)
    model = load_model(cfg, state, device)
    plain = load_model(dataclasses.replace(cfg, use_pallas_attention=False),
                       state, device)
    calls = capture(model, inputs, parts)
    plain_calls = capture(plain, inputs, parts)
    result = {}
    for part in parts:
        if not calls[part]:
            emit(f"{part:14s}: not in this configuration")
            continue
        ms, device_ms = part_ms(calls[part], device, iters)
        flops = count_flops(lambda: run_part(plain_calls[part]))
        b_in, b_out = part_bytes(calls[part])
        row = dict(ms=ms, device_ms=device_ms, flops=flops, bytes_in=b_in,
                   bytes_out=b_out, tflops=None, gbytes_per_s=None,
                   peak_flops_share=None, peak_bytes_share=None)
        line = (f"{part:14s}: wall {ms:9.3f} ms/batch{batch} "
                f"({batch / ms * 1e3:8.1f} scenes/s)  {flops / 1e9:8.1f} GF"
                f"  in {b_in / 1e6:8.1f} MB out {b_out / 1e6:8.1f} MB")
        if device_ms is not None:
            row.update(tflops=flops / device_ms / 1e9,
                       gbytes_per_s=(b_in + b_out) / device_ms / 1e6)
            row.update(peak_flops_share=row["tflops"] * 1e12 / PEAK_BF16_FLOPS,
                       peak_bytes_share=(row["gbytes_per_s"] * 1e9
                                         / PEAK_HBM_BYTES))
            line += (f"  card busy {device_ms:9.3f} ms -> "
                     f"{row['tflops']:6.1f} TF/s "
                     f"({row['peak_flops_share'] * 100:4.1f} % of 989) "
                     f"{row['gbytes_per_s']:7.1f} GB/s "
                     f"({row['peak_bytes_share'] * 100:4.1f} % of 3350)")
        result[part] = row
        emit(line)
        synchronize(device)
    coarse = [p for p in COARSE[1:] if p in result]
    if "full" in result and coarse:
        for key, what in (("ms", "wall"), ("device_ms", "card busy")):
            if result["full"][key] is None:
                continue
            total = sum(result[p][key] for p in coarse)
            emit(f"sum of {'+'.join(coarse)}: {what} {total:.3f} ms beside "
                 f"full {result['full'][key]:.3f} ms")
    emit(json.dumps({"device": device.type, "batch": batch, "iters": iters,
                     "parts": result}))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("parts", nargs="*", default=list(COARSE),
                   help=f"any of {' '.join(PARTS)}")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; a missing card raises")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    unknown = set(args.parts) - set(PARTS)
    if unknown:  # before any model is built
        p.error(f"unknown parts {sorted(unknown)}; choose from "
                f"{' '.join(PARTS)}")
    run(STRAJNET_CONFIG, args.device, args.batch, args.iters, args.parts,
        emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
