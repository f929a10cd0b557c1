"""Data-parallel training over ranks: ``torch.distributed`` and DDP.

Counterpart of the ``'data'`` axis of ``strajnet_tpu/parallel/mesh.py``.
The JAX package runs one program over a device mesh: the global batch is
sharded over ``'data'`` and GSPMD computes the loss, the gradients and the
metrics of the global batch. Here each rank is a process with its own
device that takes ``batch_size // world_size`` samples of every global
batch, and these pieces keep the global batch's numbers:

- gradients: the model is wrapped in ``DistributedDataParallel`` with a
  comm hook that **sums** the ranks' gradients (:func:`allreduce_sum_hook`),
  because each rank's loss is its share of the global batch's loss
  (``objective/loss.py``, one all-reduce of label counts a step through
  :func:`sum_over_ranks`); the sum of the shares' gradients is the
  gradient of the global loss, with no rescaling by the world size;
- metrics: ``objective/metrics.py`` sums the PR-AUC histograms and the
  per-waypoint sums over ranks before its formulas;
- noise: ``ops/dropout.py`` draws every mask at the global batch's shape
  from the generator every rank seeds alike and keeps this rank's rows;
- the feed: ``train/loop.py`` reads the record shard ``rank`` of
  ``world_size`` and ends an epoch on every rank at the first step where
  some rank has no batch left (:func:`common_steps`); rank 0 writes the
  log and the checkpoints (``train/checkpoints.py``).

Without a process group, :func:`rank` is 0, :func:`world_size` is 1 and
every helper here does nothing, so one process runs as before.

Under a ``('data', 'model')`` mesh (``parallel/mesh.py``, tensor
parallelism) the peers along ``'model'`` hold the same rows, so what is
per-row here goes by the ``'data'`` coordinate and group
(:func:`data_rank`, :func:`data_size`, :func:`data_group`): the rows a
rank's noise keeps, the loss and metric sums, the record shard a rank
reads, and DDP, which runs over the ``'data'`` group (and not at all on a
data axis of one). Without a mesh they are the world's.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.parallel import mesh as tp

# gloo group of every rank for host-side agreement (steps, barriers) when
# the default group runs NCCL, which takes device tensors only
_host_group: Optional[dist.ProcessGroup] = None


def init_distributed(device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Joins the process group and returns this rank's device.

    Without ``init_method`` the rendezvous is torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    ``init_method`` (``tcp://host:port``, ``file://path``) with ``rank`` and
    ``world_size``. A ``"cuda"`` device without an index becomes
    ``cuda:LOCAL_RANK``. The backend is ``nccl`` on the card and ``gloo`` on
    the CPU; ``gloo`` may be asked for on the card (two ranks on one card,
    which NCCL refuses). A missing card, NCCL without one, or a failed
    rendezvous raises.
    """
    global _host_group
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size)
    _host_group = (dist.new_group(backend="gloo") if backend != "gloo"
                   else None)
    return device


def destroy() -> None:
    """Leaves the process group, if there is one."""
    global _host_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a process group (the JAX loop's
    ``jax.process_index()``)."""
    return dist.get_rank() if _grouped() else 0


def world_size() -> int:
    """The number of ranks; 1 without a process group (the JAX loop's
    ``jax.process_count()``)."""
    return dist.get_world_size() if _grouped() else 1


def data_rank() -> int:
    """This rank's ``'data'`` coordinate under an active mesh, else
    :func:`rank`."""
    return tp.axis_rank(tp.DATA) if tp.active_mesh() else rank()


def data_size() -> int:
    """The size of the ``'data'`` axis under an active mesh, else
    :func:`world_size`."""
    return tp.axis_size(tp.DATA) if tp.active_mesh() else world_size()


def data_group() -> Optional[dist.ProcessGroup]:
    """The ``'data'`` group under an active mesh, else None (the world)."""
    return tp.axis_group(tp.DATA) if tp.active_mesh() else None


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` over the ranks of the ``'data'`` axis (the world without
    a mesh) in place, on the backend's device, and returns it; on a data
    axis of one no collective runs."""
    if data_size() > 1:
        dist.all_reduce(t, group=data_group())
        if tp.active_mesh():
            tp.collective_bytes[tp.DATA] += t.numel() * t.element_size()
    return t


def barrier() -> None:
    """Waits for every rank, on the host; nothing at world size 1."""
    if world_size() > 1:
        dist.barrier(group=_host_group)


def common_steps(items: Iterable) -> Iterator:
    """Yields the items of ``items`` while every rank has one.

    The record shards of the ranks may differ by a record, and then by a
    batch; DDP would wait forever for the rank that ran out. So before each
    step the ranks sum, on the host, how many of them are out, and all stop
    at the first step where one is: a surplus batch is dropped, as the JAX
    loop drops the ragged tail. At world size 1, ``items`` as they are.
    """
    if world_size() == 1:
        yield from items
        return
    it = iter(items)
    end = object()
    try:
        while True:
            item = next(it, end)
            out = torch.tensor([int(item is end)], dtype=torch.int64)
            dist.all_reduce(out, group=_host_group)
            if int(out) > 0:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def allreduce_sum_hook(state, bucket):
    """DDP comm hook: the ``dist.GradBucket``'s gradients summed over the
    ranks of ``state``, a process group (None: the world; the default hook
    averages them). Counts the bytes it reduces in
    ``allreduce_sum_hook.bytes``. (DDP checks a hook's annotations against
    the classes themselves, so ``bucket`` has none: this module's are
    strings.)"""
    buf = bucket.buffer()
    allreduce_sum_hook.bytes += buf.numel() * buf.element_size()
    fut = dist.all_reduce(buf, group=state, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


allreduce_sum_hook.bytes = 0


def wrap_model(model: nn.Module, device: torch.device,
               find_unused_parameters: bool = False) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` with the summing comm hook;
    ``model`` itself without a process group. Under an active mesh DDP runs
    over the ``'data'`` group, and not at all where that axis is one rank
    (the peers along ``'model'`` compute the same rows: their gradients are
    not summed). ``find_unused_parameters`` is for configurations that leave
    parameters without a gradient (``stp_grad``). The model's buffers are
    constants, so they are not broadcast at each forward."""
    if not _grouped() or (tp.active_mesh() and data_size() == 1):
        return model
    device_ids = None
    if device.type == "cuda":
        device_ids = [device.index if device.index is not None
                      else torch.cuda.current_device()]
    ddp = DistributedDataParallel(
        model, device_ids=device_ids, broadcast_buffers=False,
        process_group=data_group(),
        find_unused_parameters=find_unused_parameters)
    ddp.register_comm_hook(data_group(), allreduce_sum_hook)
    return ddp


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel``, else ``model``."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model
