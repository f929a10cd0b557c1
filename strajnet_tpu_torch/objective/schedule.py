"""Learning-rate schedules as plain functions of the step count.

Counterpart of ``strajnet_tpu/objective/schedule.py``. The reference builds
SGDR cosine restarts but never wires it into the optimizer; here, as in the
JAX package, the schedule is wired by default (``TrainConfig.use_schedule``)
with a constant-LR parity mode. Each schedule takes a Python number or a
tensor and computes in f32, like its JAX counterpart, so the two agree to
f32 rounding.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_decay_restarts(initial_learning_rate: float,
                          first_decay_steps: int, t_mul: float = 2.0,
                          m_mul: float = 1.0, alpha: float = 0.0):
    """SGDR schedule: ``schedule(step) -> f32 scalar tensor``."""

    def schedule(step):
        step = _f32(step)
        completed = step / first_decay_steps

        if t_mul == 1.0:
            i_restart = torch.floor(completed)
            frac = completed - i_restart
        else:
            i_restart = torch.floor(
                torch.log(1.0 - completed * (1.0 - t_mul)) / math.log(t_mul))
            sum_r = (1.0 - t_mul ** i_restart) / (1.0 - t_mul)
            frac = (completed - sum_r) / t_mul ** i_restart

        m_fac = m_mul ** i_restart
        cosine_decayed = 0.5 * m_fac * (1.0 + torch.cos(math.pi * frac))
        decayed = (1.0 - alpha) * cosine_decayed + alpha
        return initial_learning_rate * decayed

    return schedule


def transformer_schedule(d_model: int, warmup_steps: int = 4000):
    """rsqrt warmup schedule (unused in training, part of the inventory)."""

    def schedule(step):
        step = torch.clamp(_f32(step), min=1.0)
        arg1 = step ** -0.5
        arg2 = step * (warmup_steps ** -1.5)
        return (d_model ** -0.5) * torch.minimum(arg1, arg2)

    return schedule
