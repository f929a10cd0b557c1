"""Two training steps of STrajNet's map variant, port against JAX, on the CPU.

At ``ULTRA_TINY_MODEL_CONFIG`` with ``actor_only=False`` (the centerline
branch) and ``stp_grad=True`` (no gradient into the bottleneck and the
pyramid residuals), ``drop_path_rate`` 0 and the random parts off on both
sides: the losses, every gradient and the parameters after two Nadam steps
against ``jax.grad`` and the JAX Nadam, f32, to 1e-4.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.config import LossConfig as JLossConfig
from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import WAYMO_TASK_CONFIG as JTASK
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.models.strajnet import dummy_inputs as jax_dummy_inputs
from strajnet_tpu.objective import loss as jloss
from strajnet_tpu.train import state as jstate_mod
from strajnet_tpu_torch.config import (ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.train.state import TrainState, make_optimizer
from strajnet_tpu_torch.train.step import LOSS_KEYS, make_train_step
from tests.test_torch_variants import fill_params

torch.set_num_threads(2)
# The bottleneck of this config is 1x1: FG-MSA's softmax runs over one key,
# so its key projection and rel-pos table get a mathematically zero gradient
# (cancellation noise); under stp_grad they get none at all.
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")


def _jax_steps(flags, params, batch, steps):
    """Loss dicts, the first step's gradients and the parameters after
    ``steps`` Nadam updates on one batch, dropout off."""
    cfg = dataclasses.replace(JCFG, **flags)
    model = JaxSTrajNet(cfg=cfg)
    loss_fn = jloss.OGMFlowLoss(JTASK, JLossConfig())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    true = jloss.true_waypoints_from_batch(jb)

    def compute(p):
        out = model.apply({"params": p}, ogm=jb["ogm"],
                          map_img=jb["map_image"], obs=jb["actors"],
                          occ=jb["occl_actors"], mapt=jb["centerlines"],
                          flow=jb["vec_flow"], training=False)
        d = loss_fn(true, jloss.split_pred_waypoints(out, cfg.num_waypoints))
        total = (d["observed_xe"] + d["occluded_xe"] + d["flow"]
                 + d["flow_warp_xe"])
        return total, dict(d, total=total)

    tx = jstate_mod.make_optimizer(JTrainConfig())
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    grad_fn = jax.jit(jax.value_and_grad(compute, has_aux=True))
    update = jax.jit(tx.update)
    losses, first_grads = [], None
    for _ in range(steps):
        (_, d), grads = grad_fn(p)
        if first_grads is None:
            first_grads = jax.tree_util.tree_map(np.asarray, grads)
        losses.append({k: float(v) for k, v in d.items()})
        updates, opt_state = update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
    return losses, first_grads, jax.tree_util.tree_map(np.asarray, p)


def _without_key_bias(name, arr):
    """The key third of a Swin block's qkv bias shifts every logit of a
    softmax row alike: its gradient is rounding, which Nadam's normalised
    update turns into steps of the learning rate's size."""
    if name.endswith("attn.qkv.bias"):
        c = arr.shape[0] // 3
        return np.concatenate([arr[:c], arr[2 * c:]])
    return arr


def test_map_variant_two_steps_match_jax():
    """Under ``stp_grad`` only the decoder and the flow branch learn: the
    port leaves every other gradient None, where JAX's is zero."""
    flags = dict(actor_only=False, stp_grad=True, drop_path_rate=0.0)
    cfg = dataclasses.replace(ULTRA_TINY_MODEL_CONFIG, **flags)
    jcfg = dataclasses.replace(JCFG, **flags)
    shapes = jax.eval_shape(JaxSTrajNet(cfg=jcfg).init,
                            jax.random.PRNGKey(0),
                            **jax_dummy_inputs(jcfg, batch=2))
    params = fill_params(shapes["params"])
    batch = synthetic_batch(cfg, 2, seed=1)
    ref_losses, ref_grads, ref_params = _jax_steps(flags, params, batch, 2)

    model = STrajNet(cfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    state = TrainState(model.eval(), make_optimizer(TrainConfig(),
                                                    model.parameters()))
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           cfg.num_waypoints)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    state, losses = step(state, tb)
    for k in LOSS_KEYS:
        # f32 both sides, sums over the grid in another order
        np.testing.assert_allclose(float(losses[k]), ref_losses[0][k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    want = flax_to_state_dict(ref_grads)
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    learning = 0
    for name, p in named.items():
        w = want[name].numpy()
        if p.grad is None:
            assert not np.abs(w).any(), name
            continue
        learning += 1
        if name.startswith(ZERO_GRAD):
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)
    assert named["trajnet_attn.map_cross_attn.0.FFN1.weight"].grad is None
    assert named["decoder.resconv_f.kernel"].grad is not None
    assert 0 < learning < len(named)

    state, losses = step(state, tb)
    assert state.step == 2
    np.testing.assert_allclose(float(losses["total"]),
                               ref_losses[1]["total"], rtol=1e-4)
    want = flax_to_state_dict(ref_params)
    for name, p in state.model.named_parameters():
        if name.startswith(ZERO_GRAD):
            continue
        np.testing.assert_allclose(
            _without_key_bias(name, p.detach().numpy()),
            _without_key_bias(name, want[name].numpy()),
            rtol=1e-4, atol=1e-4, err_msg=name)
