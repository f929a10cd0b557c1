"""The flagship forward as a function of its parameters and inputs.

Counterpart of ``entry`` in the JAX package's ``__graft_entry__.py``:

    forward, args = entry()          # on the card; entry("cpu") on the CPU
    out = forward(*args)             # [1, 256, 256, 32], f32

``forward(params, ogm, map_img, obs, occ, mapt, flow)`` runs
``STrajNet(STRAJNET_CONFIG)`` (bf16, the default kernel mode: K1 in the
Swin blocks on the card) in ``eval()`` through ``torch.func.functional_call``
with ``params``, a state dict; the example arguments are the
``init_params`` state (seed 0) and ``dummy_inputs`` at batch 1, all on the
device. The JAX file's ``dryrun_multichip``, a training step over a mesh
with a ``'model'`` axis, has no counterpart here yet: it comes with tensor
parallelism (``ROADMAP.md`` §1).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from strajnet_tpu_torch.config import STRAJNET_CONFIG
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import (STrajNet, dummy_inputs,
                                                init_params)


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(forward, example_args)`` of the flagship forward on ``device``."""
    device = resolve_device(device)
    cfg = STRAJNET_CONFIG
    model = STrajNet(cfg).to(device).eval()
    params = {k: v.to(device) for k, v in
              init_params(cfg, torch.Generator().manual_seed(0)).items()}
    inputs = dummy_inputs(cfg, batch=1, device=device)

    def forward(params, ogm, map_img, obs, occ, mapt, flow):
        return torch.func.functional_call(
            model, params, (), dict(ogm=ogm, map_img=map_img, obs=obs,
                                    occ=occ, mapt=mapt, flow=flow))

    return forward, (params, inputs["ogm"], inputs["map_img"], inputs["obs"],
                     inputs["occ"], inputs["mapt"], inputs["flow"])


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
