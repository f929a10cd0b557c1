"""The port's training step against JAX, on the CPU.

At ``ULTRA_TINY_MODEL_CONFIG`` in f32 with the random parts off on both sides
(JAX: ``training=False`` inside ``value_and_grad``; the port: ``model.eval()``):
the loss dict, every parameter gradient and the parameters after two Nadam
steps. Then the step's own behaviour: the accumulating variant, a falling
loss, and seeded noise in training mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.config import LossConfig as JLossConfig
from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import WAYMO_TASK_CONFIG as JTASK
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.objective import loss as jloss
from strajnet_tpu.train import state as jstate_mod
from strajnet_tpu_torch.config import (ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import (_flatten, convert_leaf,
                                                  flax_to_state_dict)
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.ops.dropout import drop_path_multipliers, dropout
from strajnet_tpu_torch.train.state import (TrainState, create_train_state,
                                            make_optimizer)
from strajnet_tpu_torch.train.step import (LOSS_KEYS, make_train_step,
                                           zero_loss_sums)

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG
BATCH = 2
# The bottleneck of this config is 1x1: FG-MSA's softmax runs over one key,
# so its key projection and rel-pos table get a mathematically zero gradient
# (cancellation noise), as ``fg_msa_layer/proj_k/bias`` does at any size.
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")


def _without_key_bias(name, arr):
    """The key third of a Swin block's qkv bias shifts every logit of a
    softmax row alike: its gradient is zero but for rounding, and Nadam's
    normalised update turns that rounding into steps of the size of the
    learning rate. Compared without it."""
    if name.endswith("attn.qkv.bias"):
        c = arr.shape[0] // 3
        return np.concatenate([arr[:c], arr[2 * c:]])
    return arr


def _perturbed_params():
    """The JAX init with every bias drawn from N(0, 0.1): with zero biases an
    empty patch stays a constant token, every LayerNorm multiplies its bias
    gradients by eps^-1/2, and the comparison would be of rounding noise."""
    state = jstate_mod.create_train_state(JCFG, JTrainConfig(), jit_init=True)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    rng = np.random.default_rng(0)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                    if k == "bias" else np.array(v))
                for k, v in tree.items()}

    return walk(params)


@pytest.fixture(scope="module")
def case():
    params = _perturbed_params()
    batch = synthetic_batch(CFG, BATCH, seed=1)
    return params, batch


def _jax_reference(params, batch, steps):
    """Loss dicts, first-step gradients and the parameters after ``steps``
    Nadam updates on one batch, dropout off."""
    model = JaxSTrajNet(cfg=JCFG)
    loss_fn = jloss.OGMFlowLoss(JTASK, JLossConfig())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    true = jloss.true_waypoints_from_batch(jb)

    def compute(p):
        out = model.apply({"params": p}, ogm=jb["ogm"],
                          map_img=jb["map_image"], obs=jb["actors"],
                          occ=jb["occl_actors"], mapt=jb["centerlines"],
                          flow=jb["vec_flow"], training=False)
        d = loss_fn(true, jloss.split_pred_waypoints(out, JCFG.num_waypoints))
        total = (d["observed_xe"] + d["occluded_xe"] + d["flow"]
                 + d["flow_warp_xe"])
        return total, dict(d, total=total)

    tx = jstate_mod.make_optimizer(JTrainConfig())
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)
    step = jax.jit(jax.value_and_grad(compute, has_aux=True))
    losses, first_grads = [], None
    for _ in range(steps):
        (_, d), grads = step(p)
        if first_grads is None:
            first_grads = jax.tree_util.tree_map(np.asarray, grads)
        losses.append({k: float(v) for k, v in d.items()})
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
    return losses, first_grads, jax.tree_util.tree_map(np.asarray, p)


def _torch_state(params, cfg=CFG, train=False):
    model = STrajNet(cfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    model.train(train)
    return TrainState(model, make_optimizer(TrainConfig(),
                                            model.parameters()))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_two_steps_match_jax(case):
    params, batch = case
    ref_losses, ref_grads, ref_params = _jax_reference(params, batch, 2)
    state = _torch_state(params)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           CFG.num_waypoints)
    tb = _tbatch(batch)

    state, losses = step(state, tb)
    assert set(losses) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        # f32 both sides, sums over the grid in another order
        np.testing.assert_allclose(float(losses[k]), ref_losses[0][k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    want = flax_to_state_dict(ref_grads)
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        if name.startswith(ZERO_GRAD):
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-4,
            atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)

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


def test_zero_bias_init_blows_up_bias_gradients_as_in_jax():
    """With the init's zero biases a sample whose rasters are empty is a zero
    token through the encoder: each LayerNorm there multiplies the gradient
    by eps^-1/2 = 316, and the patch-embed bias gradients reach 1e25 already
    at this depth. It is a property of the model: JAX gives the same
    gradients, leaf by leaf."""
    state = jstate_mod.create_train_state(JCFG, JTrainConfig(), jit_init=True)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    batch = dict(synthetic_batch(CFG, BATCH, seed=1))
    for key in ("ogm", "map_image", "vec_flow"):
        empty = batch[key].copy()
        empty[1] = 0
        batch[key] = empty
    _, ref_grads, _ = _jax_reference(params, batch, 1)
    state = _torch_state(params)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           CFG.num_waypoints)
    state, _ = step(state, _tbatch(batch))
    want = flax_to_state_dict(ref_grads)
    named = dict(state.model.named_parameters())
    for name, p in named.items():
        if name.startswith(ZERO_GRAD):
            continue
        w = want[name].numpy()
        # f32 both sides; relative to the leaf's largest entry, whatever
        # its magnitude
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for branch in ("vehicle", "flow", "map"):
        name = f"encoder.patch_embed_{branch}.proj.bias"
        assert float(named[name].grad.abs().max()) > 1e20, name
        assert float(np.abs(want[name].numpy()).max()) > 1e20, name


def test_accumulating_step_matches_per_step_losses(case):
    params, batch = case
    tb = _tbatch(batch)
    single = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                             CFG.num_waypoints)
    accum = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                            CFG.num_waypoints, accumulate=True)
    s1, s2 = _torch_state(params), _torch_state(params)
    sums = zero_loss_sums()
    expect = {k: 0.0 for k in LOSS_KEYS}
    for _ in range(3):
        s1, losses = single(s1, tb)
        for k in LOSS_KEYS:
            expect[k] += float(losses[k])
        s2, sums = accum(s2, tb, None, sums)
    assert set(sums) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(sums[k]), expect[k], rtol=1e-6)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_steps_on_one_batch_lower_the_loss(case):
    params, batch = case
    state = _torch_state(params)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           CFG.num_waypoints)
    tb = _tbatch(batch)
    totals = []
    for _ in range(6):
        state, losses = step(state, tb)
        totals.append(float(losses["total"]))
    assert all(np.isfinite(totals))
    assert totals[-1] < totals[0]
    for p in state.model.parameters():
        assert torch.isfinite(p).all()


def test_training_mode_noise_comes_from_the_generator(case):
    params, batch = case
    cfg = dataclasses.replace(CFG, drop_path_rate=0.3)
    tb = _tbatch(batch)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           cfg.num_waypoints)

    def run(seed):
        state = _torch_state(params, cfg, train=True)
        g = torch.Generator().manual_seed(seed)
        out = []
        for _ in range(2):
            state, losses = step(state, tb, g)
            out.append(float(losses["total"]))
        return out, [p.detach().numpy().copy()
                     for p in state.model.parameters()]

    a, pa = run(7)
    b, pb = run(7)
    c, _ = run(8)
    assert a == b
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    assert a != c
    # training mode without a generator is refused, not seeded globally
    with pytest.raises(ValueError):
        step(_torch_state(params, cfg, train=True), tb, None)


def test_drop_path_multipliers_and_dropout():
    g = torch.Generator().manual_seed(0)
    keep = 0.7
    dpm = drop_path_multipliers(256, 1.0 - keep, True, g, "cpu")
    assert dpm.shape == (256, 2) and dpm.dtype == torch.float32
    values = set(np.unique(dpm.numpy()).tolist())
    assert values == {0.0, float(np.float32(1.0) / np.float32(keep))}
    assert abs(float((dpm > 0).float().mean()) - keep) < 0.08
    assert drop_path_multipliers(4, 0.3, False, g, "cpu") is None
    assert drop_path_multipliers(4, 0.0, True, g, "cpu") is None
    x = torch.ones(1000)
    y = dropout(x, 0.1, True, g)
    assert set(np.unique(y.numpy()).tolist()) == {0.0, float(
        np.float32(1.0) / np.float32(0.9))}
    assert dropout(x, 0.1, False, None) is x
    assert dropout(x, 0.0, True, None) is x


def test_drop_path_rates_follow_the_jax_linspace():
    cfg = dataclasses.replace(CFG, depths=(2, 2, 2), drop_path_rate=0.1)
    enc = STrajNet(cfg).encoder
    want = np.linspace(0.0, 0.1, 6)
    got = [getattr(getattr(enc, f"layers{i}"), f"blocks{j}").drop_path
           for i in range(3) for j in range(2)]
    np.testing.assert_allclose(got, want)
    # the flow branch shares stage 0's rates
    flow = [getattr(enc.flow_layer, f"blocks{j}").drop_path for j in range(2)]
    np.testing.assert_allclose(flow, want[:2])
    with pytest.raises(NotImplementedError):
        STrajNet(dataclasses.replace(CFG, drop_rate=0.1))
    with pytest.raises(NotImplementedError):
        STrajNet(dataclasses.replace(CFG, attn_drop_rate=0.1))


def test_create_train_state_and_devices():
    state = create_train_state(CFG, TrainConfig(seed=3), device="cpu")
    assert state.step == 0 and state.model.training
    again = create_train_state(CFG, TrainConfig(seed=3), device="cpu")
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert state.optimizer.param_groups[0]["count"] == 0
    assert callable(state.optimizer.learning_rate)
    const = make_optimizer(TrainConfig(use_schedule=False, lr=3e-4),
                           state.model.parameters())
    assert const.learning_rate == 3e-4
    if not torch.cuda.is_available():
        # the default device is the card; a missing card raises
        with pytest.raises(RuntimeError):
            create_train_state(CFG, TrainConfig())


def test_optimizer_state_of_the_model_carries_over(case):
    """``nadam_state_to_state_dict`` on the real parameter tree: every leaf
    of mu and nu lands on its parameter, transposed like the parameter."""
    from strajnet_tpu_torch.interop.from_flax import (
        nadam_state_to_state_dict)
    params, _ = case
    rng = np.random.default_rng(5)
    noise = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nadam = dict(count=np.int32(11), mu=noise(), nu=noise(),
                 mu_product=np.float32(0.25))
    state = _torch_state(params)
    sd = nadam_state_to_state_dict(state.model, state.optimizer, nadam)
    state.optimizer.load_state_dict(sd)
    group = state.optimizer.param_groups[0]
    assert group["count"] == 11 and group["mu_product"] == 0.25
    mu = flax_to_state_dict(nadam["mu"])
    for name, p in state.model.named_parameters():
        got = state.optimizer.state[p]["mu"]
        assert got.shape == p.shape
        np.testing.assert_array_equal(got.numpy(), mu[name].numpy())
    assert len(mu) == len(list(state.model.parameters()))
    # a Dense kernel's moments transpose with it
    assert convert_leaf(("a", "kernel"), np.zeros((2, 3)))[1].shape == (3, 2)
    # the stacked per-waypoint subtree splits, so there are more torch
    # entries than Flax leaves
    assert len(list(_flatten(params))) < len(mu)
