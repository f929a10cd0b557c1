"""Exact Keras Nadam as a ``torch.optim.Optimizer``.

Counterpart of ``strajnet_tpu/train/optim.py``. ``torch.optim.NAdam`` uses
another momentum-decay constant and epsilon placement than the reference's
``tf.keras.optimizers.Nadam``; this optimizer implements the Keras rule:

    local_step = t + 1
    u_t   = beta1 * (1 - 0.5 * 0.96**(0.004 * local_step))
    u_t+1 = beta1 * (1 - 0.5 * 0.96**(0.004 * (local_step + 1)))
    U_t   = U_{t-1} * u_t                    (momentum-cache product, U_0 = 1)
    m <- beta1 m + (1-beta1) g ;  v <- beta2 v + (1-beta2) g^2
    m_hat = u_t+1 m / (1 - U_t * u_t+1) + (1 - u_t) g / (1 - U_t)
    v_hat = v / (1 - beta2**local_step)
    p <- p - lr(t) * m_hat / (sqrt(v_hat) + eps)

The scalars are computed in f32 on the host, as the JAX transform computes
them in f32; ``mu`` and ``nu`` are f32 tensors beside each parameter; the
schedule is evaluated at the count before the update. The step forces no
host sync.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from strajnet_tpu_torch.parallel import mesh as tp

Schedule = Callable[[int], Union[float, torch.Tensor]]


def clip_by_global_norm(grads: Iterable[torch.Tensor],
                        max_norm: float,
                        split: Optional[Iterable[bool]] = None) -> None:
    """In place ``optax.clip_by_global_norm``: gradients whose joint norm
    reaches ``max_norm`` become ``(g / norm) * max_norm``, in that order of
    operations; smaller ones stay as they are. Reads no value on the host.
    ``split`` marks the gradients of parameters sharded over ``'model'``
    (``parallel/mesh.py``): their squares are summed over that axis, so the
    norm is the whole gradient's."""
    grads = list(grads)
    split = [False] * len(grads) if split is None else list(split)
    if any(split):
        sq = sum((g.float() ** 2).sum() for g, s in zip(grads, split) if s)
        sq = tp.all_reduce(sq, tp.MODEL)
        norm = torch.sqrt(sq + sum((g.float() ** 2).sum()
                                   for g, s in zip(grads, split) if not s))
    else:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class KerasNadam(torch.optim.Optimizer):
    """``tf.keras.optimizers.Nadam(learning_rate)``; ``learning_rate`` is a
    number or a schedule of the step count."""

    def __init__(self, params, learning_rate: Union[float, Schedule] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
                 decay: float = 0.96,
                 grad_clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, decay=decay,
                                      grad_clip_norm=grad_clip_norm,
                                      count=0, mu_product=1.0))

    def lr_at(self, count: int):
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        f = np.float32
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if group["grad_clip_norm"]:
                clip_by_global_norm([p.grad for p in params],
                                    group["grad_clip_norm"],
                                    [tp.placement(p) is not None
                                     for p in params])
            b1, b2 = f(group["b1"]), f(group["b2"])
            decay, eps = f(group["decay"]), float(group["eps"])
            count = int(group["count"])
            step = f(count + 1)
            u_t = b1 * (f(1) - f(0.5) * decay ** (f(0.004) * step))
            u_t1 = b1 * (f(1) - f(0.5) * decay ** (f(0.004) * (step + f(1))))
            mu_product = f(group["mu_product"]) * u_t
            mu_product_next = mu_product * u_t1
            beta2_power = b2 ** step
            c_m = float(u_t1 / (f(1) - mu_product_next))
            c_g = float((f(1) - u_t) / (f(1) - mu_product))
            c_v = float(f(1) / (f(1) - beta2_power))
            # a schedule computes on the host, so this reads no device value
            lr = float(self.lr_at(count))
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
            grads = [p.grad.float() for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, float(b1))
            torch._foreach_add_(mus, grads, alpha=float(f(1) - b1))
            torch._foreach_mul_(nus, float(b2))
            torch._foreach_addcmul_(nus, grads, grads, value=float(f(1) - b2))
            m_hat = torch._foreach_mul(mus, c_m)
            torch._foreach_add_(m_hat, grads, alpha=c_g)
            denom = torch._foreach_mul(nus, c_v)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(m_hat, denom)
            torch._foreach_mul_(m_hat, lr)
            if any(p.dtype != torch.float32 for p in params):
                m_hat = [u.to(p.dtype) for u, p in zip(m_hat, params)]
            torch._foreach_sub_(params, m_hat)
            group["count"] = count + 1
            group["mu_product"] = float(mu_product)
        return loss
