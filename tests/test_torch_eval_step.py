"""The port's evaluation step and its kernel modes against JAX, on the CPU.

``make_eval_step`` at ``ULTRA_TINY_MODEL_CONFIG`` with converted weights; the
TINY forward of the ``"attn"`` Swin mode and of every decoder-tail mode
against the JAX model in the same mode (its Pallas kernels interpreted); one
``"attn"`` training step; and that one converted state dict loads in every
mode. f32, dropout off.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import TINY_MODEL_CONFIG as JTINY
from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.config import LossConfig as JLossConfig
from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import WAYMO_TASK_CONFIG as JTASK
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.objective import loss as jloss
from strajnet_tpu.train import state as jstate_mod
from strajnet_tpu.train.step import make_eval_step as jax_make_eval_step
from strajnet_tpu_torch.config import (TINY_MODEL_CONFIG,
                                       ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.objective.metrics import METRIC_KEYS
from strajnet_tpu_torch.ops.decoder_tail import decoder_tail
from strajnet_tpu_torch.ops.window_attention import window_attention
from strajnet_tpu_torch.train.state import TrainState, make_optimizer
from strajnet_tpu_torch.train.step import (LOSS_KEYS, make_eval_step,
                                           make_train_step)

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")
# Mathematically zero gradients (cancellation noise): FG-MSA's key projection
# and rel-pos table at a 1x1 bottleneck; see tests/test_torch_train_step.py.
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")
MODES = [dict(use_pallas_attention="attn"),
         dict(use_pallas_decoder_tail="xla"),
         dict(use_pallas_decoder_tail="phase"),
         dict(use_pallas_decoder_tail="kernel"),
         dict(use_pallas_decoder_tail="infer"),
         dict(use_pallas_attention="attn", use_pallas_decoder_tail=True)]


def _random_biases(params, seed=0):
    """Every bias drawn from N(0, 0.1): the init's zero biases leave the
    rel-pos tables and biases untested and blow bias gradients up."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                    if k in ("bias", "relative_position_bias_table")
                    else np.array(v))
                for k, v in tree.items()}

    return walk(params)


@pytest.fixture(scope="module")
def ultra_tiny():
    state = jstate_mod.create_train_state(JCFG, JTrainConfig(), jit_init=True)
    params = _random_biases(jax.tree_util.tree_map(np.asarray, state.params))
    return state, params, synthetic_batch(CFG, 2, seed=1)


@pytest.fixture(scope="module")
def tiny():
    state = jstate_mod.create_train_state(JTINY, JTrainConfig(),
                                          jit_init=True)
    params = _random_biases(jax.tree_util.tree_map(np.asarray, state.params))
    return params, synthetic_batch(TINY_MODEL_CONFIG, 2, seed=3)


def _torch_model(cfg, params):
    model = STrajNet(cfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("no_warp", [False, True])
def test_eval_step_matches_jax(ultra_tiny, no_warp):
    jstate, params, batch = ultra_tiny
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    ref_losses, ref_metrics = jax_make_eval_step(
        JTASK, JLossConfig(), JCFG.num_waypoints, no_warp=no_warp)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints,
                          no_warp=no_warp)
    losses, metrics = step(_torch_model(CFG, params), _tbatch(batch))
    assert set(losses) == set(LOSS_KEYS) == set(ref_losses)
    assert tuple(metrics) == METRIC_KEYS and set(metrics) == set(ref_metrics)
    for k in LOSS_KEYS:
        # f32 both sides, sums over the grid in another order
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in METRIC_KEYS:
        # an AUC moves when a prediction crosses one of 100 thresholds
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    assert not any(v.requires_grad for v in losses.values())


def test_eval_step_refuses_a_model_in_training_mode(ultra_tiny):
    _, params, batch = ultra_tiny
    step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints)
    with pytest.raises(ValueError, match="eval"):
        step(_torch_model(CFG, params).train(), _tbatch(batch))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(
    f"{k.split('_')[-1]}={v}" for k, v in m.items()))
def test_tiny_forward_in_each_kernel_mode_matches_jax_in_that_mode(tiny, mode):
    params, batch = tiny
    jmodel = JaxSTrajNet(cfg=dataclasses.replace(JTINY, **mode))
    ref = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, ogm=batch["ogm"], map_img=batch["map_image"],
        obs=batch["actors"], occ=batch["occl_actors"],
        mapt=batch["centerlines"], flow=batch["vec_flow"]))
    model = _torch_model(dataclasses.replace(TINY_MODEL_CONFIG, **mode),
                         params)
    before = window_attention.launches, decoder_tail.launches
    t = _tbatch(batch)
    with torch.no_grad():
        ours = model(ogm=t["ogm"], map_img=t["map_image"], obs=t["actors"],
                     occ=t["occl_actors"], mapt=t["centerlines"],
                     flow=t["vec_flow"]).numpy()
    # CPU tensors take the plain versions: nothing was launched
    assert (window_attention.launches, decoder_tail.launches) == before
    # f32 both sides; summation order differs across ~60 layers
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def _jax_loss_and_grads(cfg, params, batch):
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

    (_, d), grads = jax.jit(jax.value_and_grad(compute, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return ({k: float(v) for k, v in d.items()},
            flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)))


def test_attn_training_step_matches_jax(ultra_tiny):
    """One step in the ``"attn"`` mode. Its loss is held against the JAX
    model in that mode (the interpreted Pallas forward, f32). Its gradients
    are the exact f32 gradients on the CPU, so they are held to 1e-4 against
    ``jax.grad`` of the JAX model's plain mode, which is the same function;
    the JAX ``"attn"`` backward kernel rounds its operands to bf16 whatever
    the input type, so against it the limit is 2e-2 of each leaf's largest
    entry."""
    _, params, batch = ultra_tiny
    cfg = dataclasses.replace(CFG, use_pallas_attention="attn")
    model = _torch_model(cfg, params)
    state = TrainState(model, make_optimizer(TrainConfig(),
                                             model.parameters()))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints)
    state, losses = step(state, _tbatch(batch))
    named = dict(state.model.named_parameters())
    grads = {k: p.grad.numpy() for k, p in named.items()}

    for jmode, loss_tol, grad_tol in (("attn", 1e-4, 2e-2),
                                      (False, 1e-4, 1e-4)):
        ref_losses, want = _jax_loss_and_grads(
            dataclasses.replace(JCFG, use_pallas_attention=jmode), params,
            batch)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(losses[k]), ref_losses[k],
                                       rtol=loss_tol, atol=loss_tol,
                                       err_msg=f"{jmode} {k}")
        assert set(want) == set(grads)
        for name, g in grads.items():
            if name.startswith(ZERO_GRAD):
                continue
            w = want[name].numpy()
            np.testing.assert_allclose(
                g, w, rtol=grad_tol,
                atol=grad_tol * max(1.0, float(np.abs(w).max())),
                err_msg=f"{jmode} {name}")
    moved = [k for k, p in named.items() if not torch.equal(p.detach(),
                                                            init[k])]
    assert len(moved) >= len(named) - 3


def test_one_converted_state_dict_loads_in_every_mode(tiny):
    """The JAX param tree is the same in every kernel mode, and so is the
    port's: no mode adds or renames a parameter."""
    params, _ = tiny
    sd = flax_to_state_dict(params)
    plain = STrajNet(dataclasses.replace(TINY_MODEL_CONFIG,
                                         use_pallas_attention=False))
    names = [k for k, _ in plain.named_parameters()]
    for mode in MODES + [dict(use_pallas_attention="block"),
                         dict(use_pallas_attention="block_fwd")]:
        model = STrajNet(dataclasses.replace(TINY_MODEL_CONFIG, **mode))
        model.load_state_dict(sd, strict=True)
        assert [k for k, _ in model.named_parameters()] == names
