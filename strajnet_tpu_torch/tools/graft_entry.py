"""The flagship forward as a function, and the multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

    forward, args = entry()          # on the card; entry("cpu") on the CPU
    out = forward(*args)             # [1, 256, 256, 32], f32

``forward(params, ogm, map_img, obs, occ, mapt, flow)`` runs
``STrajNet(STRAJNET_CONFIG)`` (bf16, the default kernel mode: K1 in the
Swin blocks on the card) in ``eval()`` through ``torch.func.functional_call``
with ``params``, a state dict; the example arguments are the
``init_params`` state (seed 0) and ``dummy_inputs`` at batch 1, all on the
device.

``dryrun_multichip(n_devices, flagship=True, device="cuda")`` runs one
training step over a ``('data', 'model')`` mesh of ``n_devices`` ``gloo``
ranks (``parallel/mesh.py``; ``model_axis`` 2 where ``n_devices`` is 4 or
more and even), each a process of this module
(``python -m strajnet_tpu_torch.tools.graft_entry --dryrun-rank r ...``) on
the one card (or on card ``r`` of several) or on the CPU, and prints JAX's
three lines: a step of ``ULTRA_TINY_MODEL_CONFIG``, the same with the Swin
kernels forced on (``use_pallas_attention="block"``), and with
``flagship``, ``STRAJNET_CONFIG`` at depths (1, 1, 1) with
``spatial_shard`` in f32 on the same mesh. These are JAX's steps on the
CPU and on the card alike. On the CPU the kernels' plain versions stand in.
On the card the kernels-on step runs the Swin blocks of ULTRA_TINY (f32,
windows of 4x4 and smaller, head_dim 8) through K1 and K2 on their general
route (``csrc/window_any.cu``) under the mesh, its weights gathered whole;
the other two steps run the plain Swin blocks, as JAX's default
``use_pallas_attention=None`` does (the port reads None as ``"block"``, so
they ask for ``False``), with proj and the MLP computed on the weights'
shards, and K5 in the loss.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from strajnet_tpu_torch.config import STRAJNET_CONFIG
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import (STrajNet, dummy_inputs,
                                                init_params)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_TIMEOUT_S = 900


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


def mesh_axes(n_devices: int) -> Tuple[int, int]:
    """(data axis, model axis) of the dry run's mesh, as JAX picks them."""
    model_axis = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    return n_devices // model_axis, model_axis


def dryrun_steps(n_devices: int, flagship: bool, device_type: str):
    """``(label, config, global batch)`` of each step of the dry run."""
    from strajnet_tpu_torch.config import ULTRA_TINY_MODEL_CONFIG as tiny

    data_axis, model_axis = mesh_axes(n_devices)
    # JAX's default, None, is the plain Swin block; on the card the port's
    # None launches the kernels, so the plain steps say False there
    plain = dict(use_pallas_attention=False) if device_type == "cuda" else {}
    steps = [("ok", dataclasses.replace(tiny, **plain), max(2, data_axis)),
             ("kernels-on ok", dataclasses.replace(
                 tiny, use_pallas_attention="block"), max(2, data_axis))]
    if flagship:
        sp = "+sp" if model_axis > 1 else ""
        steps.append((f"flagship{sp} ok", dataclasses.replace(
            STRAJNET_CONFIG, depths=(1, 1, 1), dtype="float32",
            spatial_shard=model_axis > 1, **plain), data_axis))
    return steps


def _rank_main(rank: int, world: int, rendezvous: str, flagship: bool,
               device: str) -> None:
    """One rank of the dry run: the steps on this rank's shard of the
    mesh; rank 0 prints the lines."""
    from strajnet_tpu_torch.config import LossConfig, TaskConfig, TrainConfig
    from strajnet_tpu_torch.data.synthetic import synthetic_batch
    from strajnet_tpu_torch.parallel import ddp
    from strajnet_tpu_torch.parallel import mesh as tp
    from strajnet_tpu_torch.train.state import create_train_state
    from strajnet_tpu_torch.train.step import make_train_step, zero_loss_sums

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = ddp.init_distributed(dev, backend="gloo",
                               init_method="file://" + rendezvous,
                               rank=rank, world_size=world)
    data_axis, model_axis = mesh_axes(world)
    mesh = tp.create_mesh(model_axis, dev)
    try:
        with tp.use_mesh(mesh):
            for label, cfg, batch in dryrun_steps(world, flagship, dev.type):
                task = TaskConfig(grid_height_cells=cfg.output_size[0],
                                  grid_width_cells=cfg.output_size[1],
                                  num_waypoints=cfg.num_waypoints)
                state = create_train_state(
                    cfg, TrainConfig(use_schedule=True), device=dev)
                step = make_train_step(task, LossConfig(), cfg.num_waypoints,
                                       accumulate=True)
                rows = tp.shard_batch(synthetic_batch(cfg, batch=batch),
                                      mesh)
                rows = {k: torch.from_numpy(v).to(dev)
                        for k, v in rows.items()}
                _, sums = step(state, rows,
                               torch.Generator(dev).manual_seed(0),
                               zero_loss_sums(dev))
                # this rank's share of the global batch's loss, summed
                total = float(ddp.sum_over_ranks(sums["total"].detach()))
                if not math.isfinite(total):
                    raise FloatingPointError(
                        f"non-finite loss in dry run: {total}")
                if ddp.rank() == 0:
                    tag = " 512^2" if label.startswith("flagship") else ""
                    print(f"dryrun_multichip {label}: mesh=({data_axis}x"
                          f"{model_axis}){tag} loss={total:.4f}", flush=True)
                del state, step
    finally:
        ddp.destroy()


def dryrun_multichip(n_devices: int, flagship: bool = True,
                     device: str = "cuda",
                     timeout_s: float = RANK_TIMEOUT_S) -> List[str]:
    """Runs one training step over a mesh of ``n_devices`` ``gloo`` ranks
    for each configuration of the dry run and prints its lines (rank 0's
    output); returns them. A rank that fails or outlasts ``timeout_s``
    raises, with the tail of each failed rank's log; a missing card
    raises."""
    device_type = resolve_device(device).type
    tmp = tempfile.mkdtemp(prefix="dryrun_multichip_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device_type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    try:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n_devices)]
        files = [open(p, "w") for p in logs]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "strajnet_tpu_torch.tools.graft_entry",
             "--dryrun-rank", str(r), "--world", str(n_devices),
             "--rendezvous", os.path.join(tmp, "rendezvous"),
             "--device", device_type]
            + ([] if flagship else ["--no-flagship"]),
            env=env, cwd=_REPO, stdout=f, stderr=subprocess.STDOUT)
            for r, f in enumerate(files)]
        try:
            for p in procs:
                try:
                    p.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = []
            for r in failed:
                with open(logs[r]) as f:
                    tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                                 f"{f.read()[-3000:]}")
            raise RuntimeError("dryrun_multichip failed:\n"
                               + "\n".join(tails))
        with open(logs[0]) as f:
            lines = [ln.rstrip("\n") for ln in f
                     if ln.startswith("dryrun_multichip")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for ln in lines:
        print(ln, flush=True)
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dryrun-rank", type=int, default=None,
                   help="run as rank r of dryrun_multichip")
    p.add_argument("--world", type=int, default=None,
                   help="with --dryrun-rank: the number of ranks; alone: run "
                        "dryrun_multichip over that many ranks")
    p.add_argument("--rendezvous", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--no-flagship", action="store_true")
    args = p.parse_args(argv)
    if args.dryrun_rank is not None:
        _rank_main(args.dryrun_rank, args.world, args.rendezvous,
                   not args.no_flagship, args.device)
    elif args.world is not None:
        dryrun_multichip(args.world, not args.no_flagship, args.device)
    else:
        fn, fargs = entry(args.device)
        with torch.inference_mode():
            out = fn(*fargs)
        print("entry forward:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
