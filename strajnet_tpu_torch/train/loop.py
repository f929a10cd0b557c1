"""Training loop and CLI.

Counterpart of ``strajnet_tpu/train/loop.py``. Usage:

    python -m strajnet_tpu_torch.train.loop --save_dir ./ckpt \\
        --file_dir ./Waymo_Dataset/preprocessed_data --batch_size 16 \\
        --epochs 15 --lr 1e-4

and data-parallel over N cards of one host (``batch_size`` is the global
batch, ``batch_size // N`` a card):

    torchrun --nproc_per_node N -m strajnet_tpu_torch.train.loop ...

What it does, as the JAX loop does:

- resumes from the newest checkpoint in ``--save_dir``, at the epoch its
  sidecar records (``train/checkpoints.py``);
- runs the accumulating train step: the running loss sums stay on the
  device, and the host reads them only every ``log_every`` steps and at the
  end of an epoch;
- after each epoch, a validation pass over the eval step (loss and challenge
  metrics) with the model in ``eval()``; on one device the split's last,
  partial batch is evaluated too, above one rank it is dropped;
- appends a row per epoch to ``<save_dir>/train_log.csv`` (epoch, loss,
  val_loss, the seven val metrics) and writes a checkpoint per epoch.

Batches reach the card through ``data/pipeline.py::prefetch_to_device``.
One ``torch.Generator`` on the device feeds every step's dropout and
drop-path noise. It is seeded from ``TrainConfig.seed`` at every start of
:func:`train`, as the JAX loop re-creates ``PRNGKey(seed)``: a resumed run
draws its noise anew, and holds no generator state in its checkpoints.
The loop runs on ``--device`` (default ``cuda``); a device that is not
there raises.

Data parallelism (``parallel/ddp.py``), as the JAX loop's ``'data'`` axis:
started by ``torchrun`` (or under a process group the caller made), each
rank trains the DDP-wrapped model on ``batch_size // world_size`` samples
(a batch size the world size does not divide raises), reads the record
shard ``rank`` of ``world_size`` of each split, and computes the loss and
metrics of the global batch; the loss sums are summed over the ranks only
when the host reads them. An epoch ends on every rank at the first step
where one has no batch left. Rank 0 prints, writes ``train_log.csv`` and the
checkpoints.

Tensor parallelism (``parallel/mesh.py``), as the JAX loop's ``'model'``
axis: with ``--model_axis`` M above 1 the world's ranks form a
``('data', 'model')`` mesh of ``world // M`` by M (a world size M does not
divide raises), the parameters are cut to each rank's shards by JAX's
rules, and everything per-row above goes by the ``'data'`` coordinate: a
rank trains on ``batch_size // (world // M)`` samples, reads record shard
``data rank`` of ``world // M`` (the peers along ``'model'`` read the same
one), and the checkpoints hold whole parameters, so a run resumes onto any
mesh, DDP or one process. On the CPU:

    torchrun --nproc_per_node 4 -m strajnet_tpu_torch.train.loop \
        --device cpu --model_axis 2 ...
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from strajnet_tpu_torch.config import (STRAJNET_CONFIG,
                                       STRAJNET_TRAIN_PY_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       ModelConfig, TaskConfig, TrainConfig)
from strajnet_tpu_torch.data.pipeline import prefetch_to_device
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import PALLAS_MODES
from strajnet_tpu_torch.objective.metrics import (MetricsAccumulator,
                                                  print_metrics)
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.parallel.ddp import (common_steps, data_rank,
                                             data_size, destroy,
                                             init_distributed, rank,
                                             sum_over_ranks, world_size)
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import (make_eval_step, make_train_step,
                                           zero_loss_sums)

# (split, epoch) -> numpy batches of that split for that epoch (0-based)
BatchSource = Callable[[str, int], Iterable[Dict[str, np.ndarray]]]


class LossMeans:
    """Running means of loss dicts. The sums stay device scalars; the one
    fetch to the host happens in :meth:`result`."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.count = 0

    def update(self, losses: Dict[str, torch.Tensor], n: int = 1):
        for k, v in losses.items():
            prev = self.sums.get(k)
            self.sums[k] = v if prev is None else prev + v
        self.count += n

    def result(self) -> Dict[str, float]:
        return _host_means(self.sums, self.count)

    def reset(self):
        self.sums, self.count = {}, 0


def _host_means(sums: Dict[str, torch.Tensor], count: int
                ) -> Dict[str, float]:
    """``sums / count`` as floats, in one fetch from the device; under data
    parallelism the sums (of loss shares) are summed over the ranks first,
    so every rank must call this at the same point."""
    if not sums:
        return {}
    values = sum_over_ranks(
        torch.stack([s.float() for s in sums.values()])).tolist()
    return {k: v / max(count, 1) for k, v in zip(sums, values)}


def tfrecord_batches(train_cfg: TrainConfig, local_batch: int,
                     shard_index: int = 0, shard_count: int = 1
                     ) -> BatchSource:
    """The default batch source: batches of ``local_batch`` records of
    shard ``shard_index`` of ``shard_count`` (records ``shard_index``,
    ``shard_index + shard_count``, ...) of ``<file_dir>/{train,val}/
    *.tfrecords``, the train split shuffled with seed ``seed + epoch``.
    The val split keeps its last, partial batch on one shard and drops it
    on several, as the JAX loop does. TensorFlow loads here, at the first
    split read."""

    def batches(split: str, epoch: int):
        from strajnet_tpu_torch.data.pipeline import (as_numpy,
                                                      make_eval_dataset,
                                                      make_train_dataset)
        pattern = f"{train_cfg.file_dir}/{split}/*.tfrecords"
        if split == "train":
            ds = make_train_dataset(pattern, local_batch,
                                    train_cfg.shuffle_buffer,
                                    shard_index=shard_index,
                                    shard_count=shard_count,
                                    seed=train_cfg.seed + epoch,
                                    compact=train_cfg.compact_feed)
        else:
            ds = make_eval_dataset(pattern, local_batch,
                                   shard_index=shard_index,
                                   shard_count=shard_count,
                                   compact=train_cfg.compact_feed,
                                   drop_remainder=shard_count > 1)
        return as_numpy(ds)

    return batches


def train(model_cfg: ModelConfig = STRAJNET_CONFIG,
          task_cfg: TaskConfig = WAYMO_TASK_CONFIG,
          train_cfg: TrainConfig = TrainConfig(),
          loss_cfg: LossConfig = LossConfig(),
          model_axis: int = 1,
          log_every: int = 100,
          profile_dir: Optional[str] = None,
          device: Union[str, torch.device] = "cuda",
          batches: Optional[BatchSource] = None):
    """Trains ``model_cfg`` for ``train_cfg.epochs`` epochs, resuming from
    the newest checkpoint in ``train_cfg.save_dir``; returns the train state.

    ``batches(split, epoch)`` gives this rank's numpy batches of
    ``"train"`` or ``"val"`` for an epoch; by default they are read from
    ``train_cfg.file_dir`` (:func:`tfrecord_batches`, this rank's shard).
    ``train_cfg.batch_size`` is the global batch. ``device`` is this rank's
    device. ``model_axis`` above 1 trains on a ``('data', 'model')`` mesh
    of the process group's ranks (``parallel/mesh.py``); ``batches`` then
    gives this rank's ``'data'`` shard. ``profile_dir`` gets a
    ``torch.profiler`` trace of steps 10 to 20 of the first epoch run (rank
    0's), the steps' ``strajnet.*`` spans (``tracing.py``) among its host
    operations.
    """
    device = resolve_device(device)
    mesh = tp.create_mesh(model_axis, device) if model_axis > 1 else None
    with tp.use_mesh(mesh):
        return _train(model_cfg, task_cfg, train_cfg, loss_cfg, log_every,
                      profile_dir, device, batches, mesh)


def _train(model_cfg, task_cfg, train_cfg, loss_cfg, log_every, profile_dir,
           device, batches, mesh):
    ranks, me = data_size(), rank()
    if train_cfg.batch_size % ranks != 0:
        raise ValueError(f"global batch {train_cfg.batch_size} not divisible "
                         f"by the data axis of {ranks} ranks")
    local_bs = train_cfg.batch_size // ranks
    say = print if me == 0 else (lambda *a, **kw: None)
    say(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
        + (f", rank {me} of {world_size()}, {local_bs} samples a rank"
           if world_size() > 1 else "")
        + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
           if mesh is not None else ""))
    if batches is None:
        batches = tfrecord_batches(train_cfg, local_bs, data_rank(), ranks)

    state = create_train_state(model_cfg, train_cfg, device=device)
    ckpt = CheckpointManager(train_cfg.save_dir)
    restored, step0 = ckpt.restore(state)
    start_epoch = 0
    if restored is not None:
        start_epoch = int(ckpt.metadata(step0).get("epoch", 0))
        say(f"resumed from step {step0} (epoch {start_epoch})")

    train_step = make_train_step(task_cfg, loss_cfg, model_cfg.num_waypoints,
                                 accumulate=True)
    eval_step = make_eval_step(task_cfg, loss_cfg, model_cfg.num_waypoints)
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    val_losses = LossMeans()
    val_metrics = MetricsAccumulator("val")
    # rank 0 alone traces
    profiler, profiled = None, profile_dir is None or me != 0

    log_path = os.path.join(train_cfg.save_dir, "train_log.csv")
    for epoch in range(start_epoch, train_cfg.epochs):
        say(f"\nepoch {epoch + 1}/{train_cfg.epochs}")
        state.model.train()
        t0 = time.perf_counter()
        n = 0
        loss_sums = zero_loss_sums(device)
        for batch in common_steps(prefetch_to_device(batches("train", epoch),
                                                     device)):
            if not profiled:
                if n == 10 and profiler is None:
                    profiler = _start_profiler(device)
                elif n == 20 and profiler is not None:
                    _stop_profiler(profiler, profile_dir)
                    profiled = True
            state, loss_sums = train_step(state, batch, generator, loss_sums)
            n += 1
            if n % log_every == 0:
                # the only host<->device sync in the loop
                means = _host_means(loss_sums, n)
                rate = n * train_cfg.batch_size / (time.perf_counter() - t0)
                say(f"  step {n}: total={means['total']:.4f} "
                    f"obs={means['observed_xe']:.4f} "
                    f"({rate:.1f} scenes/s)")
        train_means = _host_means(loss_sums, n) if n else {}
        seconds = time.perf_counter() - t0
        say(f"  {n} steps in {seconds:.3f} s"
            + (f" ({seconds * 1e3 / n:.1f} ms/step)" if n else ""))

        state.model.eval()
        for batch in common_steps(prefetch_to_device(batches("val", epoch),
                                                     device)):
            losses, metrics = eval_step(state.model, batch)
            val_losses.update(losses)
            val_metrics.update_state(metrics)
        state.model.train()

        res = val_metrics.get_result()
        if me == 0:
            print_metrics(res, "val")

        log = {"epoch": epoch + 1,
               "loss": train_means.get("total", 0.0),
               "val_loss": val_losses.result().get("total", 0.0)}
        # the JAX loop's columns: its jitted eval step returns the metrics
        # with their keys sorted
        log.update(sorted(res.items()))
        if me == 0:
            write_header = not os.path.exists(log_path)
            with open(log_path, "a", newline="") as f:
                w = csv.writer(f)
                if write_header:
                    w.writerow(log.keys())
                w.writerow(log.values())

        ckpt.save(state.step, state,
                  metrics={"val_loss": log["val_loss"], "epoch": epoch + 1,
                           "steps_per_epoch": n})
        val_losses.reset()
        val_metrics.reset_states()

    if profiler is not None and not profiled:
        _stop_profiler(profiler, profile_dir)
    ckpt.close()
    return state


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"  profiler trace written to {path}")


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="STrajNet training (PyTorch)")
    p.add_argument("--save_dir", type=str, default="./checkpoints")
    p.add_argument("--file_dir", type=str,
                   default="./Waymo_Dataset/preprocessed_data")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--constant_lr", action="store_true",
                   help="reference-parity constant LR (train.py:197)")
    p.add_argument("--no_fg_msa", action="store_true",
                   help="train.py-parity variant without FG-MSA")
    p.add_argument("--model_axis", type=int, default=1,
                   help="ranks of the mesh's 'model' axis (tensor "
                        "parallelism); it must divide the world size")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--pallas", type=str, default="auto",
                   choices=["auto"] + list(PALLAS_MODES),
                   help="Swin-block kernel mode (off = plain torch; attn = "
                        "the window-attention kernels only; block = the "
                        "fused Swin-block kernels)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the encoder blocks in the backward")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model; 'cpu' only when asked; "
                        "under torchrun cuda:LOCAL_RANK")
    args = p.parse_args(argv)

    model_cfg = STRAJNET_TRAIN_PY_CONFIG if args.no_fg_msa else STRAJNET_CONFIG
    if args.pallas != "auto":
        model_cfg = dataclasses.replace(
            model_cfg, use_pallas_attention=PALLAS_MODES[args.pallas])
    if args.remat:
        model_cfg = dataclasses.replace(model_cfg, remat_encoder=True)
    train_cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                            lr=args.lr, use_schedule=not args.constant_lr,
                            save_dir=args.save_dir, file_dir=args.file_dir)
    run = functools.partial(train, model_cfg=model_cfg, train_cfg=train_cfg,
                            model_axis=args.model_axis,
                            profile_dir=args.profile_dir)
    if "WORLD_SIZE" not in os.environ:
        run(device=args.device)
        return
    # started by torchrun: one process a rank
    device = init_distributed(args.device)
    try:
        run(device=device)
    finally:
        destroy()


if __name__ == "__main__":
    main()
