"""Train state and optimizer.

Counterpart of ``strajnet_tpu/train/state.py``. The optimizer is the exact
Keras Nadam(lr) with beta_1=0.9, beta_2=0.999, epsilon=1e-7
(:class:`strajnet_tpu_torch.train.optim.KerasNadam`). The reference builds an
SGDR cosine-restarts schedule but never wires it; here, as in the JAX
package, ``TrainConfig.use_schedule`` wires it by default.

Under a process group (``parallel/ddp.py``) the state holds the model
wrapped in ``DistributedDataParallel``; every rank runs the same optimizer
on the same summed gradients. Under an active ``('data', 'model')`` mesh
(``parallel/mesh.py``) the model's parameters are cut to this rank's shards
first, and the optimizer's moments live beside the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from strajnet_tpu_torch.config import ModelConfig, TrainConfig
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.objective.schedule import cosine_decay_restarts
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.parallel.ddp import wrap_model
from strajnet_tpu_torch.train.optim import KerasNadam


@dataclasses.dataclass
class TrainState:
    """The model (in ``DistributedDataParallel`` under a process group),
    its optimizer and the number of updates taken."""

    model: nn.Module
    optimizer: KerasNadam
    step: int = 0


def make_optimizer(train_cfg: TrainConfig, params) -> KerasNadam:
    if train_cfg.use_schedule:
        lr = cosine_decay_restarts(
            train_cfg.lr, train_cfg.first_decay_steps,
            t_mul=train_cfg.t_mul, m_mul=train_cfg.m_mul,
            alpha=train_cfg.alpha)
    else:
        lr = train_cfg.lr
    return KerasNadam(params, lr, b1=0.9, b2=0.999, eps=1e-7,
                      grad_clip_norm=train_cfg.grad_clip_norm)


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """A freshly initialised model in training mode on ``device`` and its
    optimizer. The initial weights are drawn from ``generator`` (a CPU
    generator; default: one seeded with ``train_cfg.seed``), alike on every
    rank. A device that is not there raises. Under an active mesh the
    parameters are sharded over ``'model'`` (``parallel/mesh.py::
    shard_params``). Under a process group the model is wrapped for data
    parallelism (``parallel/ddp.py::wrap_model``);
    ``stp_grad`` leaves the encoder, FG-MSA and TrajNet without gradients,
    so DDP looks for unused parameters in that configuration only."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(train_cfg.seed)
    model = STrajNet(model_cfg)
    model.load_state_dict(init_params(model_cfg, generator))
    model = model.to(device).train()
    mesh = tp.active_mesh()
    if mesh is not None:
        tp.shard_params(model, mesh)
    optimizer = make_optimizer(train_cfg, model.parameters())
    model = wrap_model(model, device,
                       find_unused_parameters=model_cfg.stp_grad)
    return TrainState(model, optimizer)
