"""The port's Keras Nadam and LR schedules against JAX, on the CPU.

``KerasNadam`` against ``keras_nadam`` over 20 steps of the same seeded
gradients (constant LR, the cosine-restarts schedule, gradient clipping); the
schedules across a restart; the optimizer state carried over from JAX.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from strajnet_tpu.objective import schedule as jschedule
from strajnet_tpu.train.optim import keras_nadam
from strajnet_tpu_torch.interop.from_flax import (find_nadam_state,
                                                  nadam_state_to_state_dict)
from strajnet_tpu_torch.objective import schedule as tschedule
from strajnet_tpu_torch.train.optim import KerasNadam, clip_by_global_norm

torch.set_num_threads(2)

SHAPES = {"fc": {"kernel": (5, 3), "bias": (3,)}, "norm": {"scale": (7,)}}
# Flax leaf -> the torch parameter it becomes (Dense kernels transpose)
ORDER = (("fc", "kernel"), ("fc", "bias"), ("norm", "scale"))


def _tree(rng, scale=1.0):
    return {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _to_torch(leaf_path, arr):
    return arr.T.copy() if leaf_path[1] == "kernel" else arr.copy()


class _Model(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.fc = torch.nn.Linear(5, 3)
        self.norm = torch.nn.LayerNorm(7)
        with torch.no_grad():
            for p, path in zip(self.trained(), ORDER):
                p.copy_(torch.from_numpy(
                    _to_torch(path, np.asarray(tree[path[0]][path[1]]))))
        self.norm.bias.requires_grad_(False)

    def trained(self):
        return [self.fc.weight, self.fc.bias, self.norm.weight]


def _schedules():
    kw = dict(first_decay_steps=8, t_mul=1.25, m_mul=0.99, alpha=0.05)
    return (jschedule.cosine_decay_restarts(1e-2, **kw),
            tschedule.cosine_decay_restarts(1e-2, **kw))


def _run_both(lr_pair, steps, clip=None, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** rng.uniform(-3, 1))
             for _ in range(steps)]
    jlr, tlr = lr_pair
    tx = keras_nadam(jlr)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    model = _Model(params)
    opt = KerasNadam(model.trained(), tlr, grad_clip_norm=clip)
    history = []
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, path in zip(model.trained(), ORDER):
            p.grad = torch.from_numpy(_to_torch(path, g[path[0]][path[1]]))
        opt.step()
        history.append((jax.tree_util.tree_map(np.asarray, jparams),
                        [p.detach().numpy().copy()
                         for p in model.trained()]))
    return history, jstate, model, opt, grads


def _assert_params_match(jtree, ours, rtol=1e-6, atol=1e-7):
    for path, got in zip(ORDER, ours):
        want = _to_torch(path, jtree[path[0]][path[1]])
        # f32 both sides; the momentum-cache scalars are computed on the
        # host in f32 here and in XLA there
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mode", ["constant", "schedule", "clipped"])
def test_keras_nadam_matches_jax_over_20_steps(mode):
    lr_pair = _schedules() if mode != "constant" else (1e-3, 1e-3)
    history, _, _, opt, _ = _run_both(lr_pair, 20,
                                      clip=0.5 if mode == "clipped" else None)
    # with clipping the global norm is an f32 sum in another order, and each
    # of the 20 updates of size lr = 1e-2 inherits a few ulps of it
    atol = 1e-6 if mode == "clipped" else 1e-7
    for jtree, ours in history:
        _assert_params_match(jtree, ours, atol=atol)
    group = opt.param_groups[0]
    assert group["count"] == 20
    assert 0.0 < group["mu_product"] < 1.0


@pytest.mark.parametrize("t_mul", [1.0, 1.25, 2.0])
def test_cosine_decay_restarts_matches_jax_across_restarts(t_mul):
    kw = dict(first_decay_steps=100, t_mul=t_mul, m_mul=0.9, alpha=0.1)
    js = jschedule.cosine_decay_restarts(3e-4, **kw)
    ts = tschedule.cosine_decay_restarts(3e-4, **kw)
    steps = np.arange(0, 400)
    want = np.asarray(jax.vmap(js)(jnp.asarray(steps)))
    got = np.array([float(ts(int(s))) for s in steps])
    got_vec = ts(torch.from_numpy(steps)).numpy()
    assert want[99] < 0.2 * want[0] and want[101] > 0.8 * want[0]  # a restart
    # f32 log/floor/cos on both sides. Right at a restart, floor() of a value
    # that rounds to either side of an integer may land in the other period:
    # allow that on the one step where the period turns over.
    close = np.isclose(got, want, rtol=1e-5, atol=1e-9)
    assert close.sum() >= len(steps) - 3, np.flatnonzero(~close)
    np.testing.assert_allclose(got_vec, got, rtol=1e-6)


def test_transformer_schedule_matches_jax():
    js = jschedule.transformer_schedule(384, warmup_steps=50)
    ts = tschedule.transformer_schedule(384, warmup_steps=50)
    for s in (0, 1, 10, 49, 50, 51, 300):
        np.testing.assert_allclose(float(ts(s)), float(js(s)), rtol=1e-6)


def test_state_carried_over_from_jax_gives_the_same_next_step():
    """Five steps in JAX, the optimizer state converted, the sixth step in
    both: same parameters. The converted state sits inside optax's chain."""
    history, jstate, _, _, grads = _run_both(_schedules(), 5, seed=3)
    jparams5 = history[-1][0]
    nadam = find_nadam_state(jax.tree_util.tree_map(np.asarray, jstate))
    assert int(nadam["count"]) == 5

    model = _Model(jparams5)
    opt = KerasNadam(model.trained(), _schedules()[1])
    named = torch.nn.Module()
    named.fc, named.norm = model.fc, torch.nn.Module()
    named.norm.weight = model.norm.weight
    opt.load_state_dict(nadam_state_to_state_dict(named, opt, nadam))
    assert opt.param_groups[0]["count"] == 5
    np.testing.assert_allclose(opt.param_groups[0]["mu_product"],
                               float(nadam["mu_product"]), rtol=1e-7)

    rng = np.random.default_rng(9)
    g6 = _tree(rng)
    tx = keras_nadam(_schedules()[0])
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g6), jstate,
                           None)
    jparams6 = optax.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, jparams5), updates)
    for p, path in zip(model.trained(), ORDER):
        p.grad = torch.from_numpy(_to_torch(path, g6[path[0]][path[1]]))
    opt.step()
    _assert_params_match(jax.tree_util.tree_map(np.asarray, jparams6),
                         [p.detach().numpy() for p in model.trained()])
    # a fresh optimizer from the same parameters takes another step
    fresh_model = _Model(jparams5)
    fresh = KerasNadam(fresh_model.trained(), _schedules()[1])
    for p, path in zip(fresh_model.trained(), ORDER):
        p.grad = torch.from_numpy(_to_torch(path, g6[path[0]][path[1]]))
    fresh.step()
    assert np.abs(fresh_model.fc.weight.detach().numpy()
                  - model.fc.weight.detach().numpy()).max() > 1e-6


def test_state_dict_round_trip_and_clip():
    history, _, model, opt, grads = _run_both((1e-3, 1e-3), 3, seed=5)
    # state_dict() hands out the live moment tensors: copy before sharing
    sd = copy.deepcopy(opt.state_dict())
    clone = _Model(history[-1][0])
    clone.load_state_dict(model.state_dict())
    opt2 = KerasNadam(clone.trained(), 1e-3)
    opt2.load_state_dict(sd)
    for o, m in ((opt, model), (opt2, clone)):
        for p, path in zip(m.trained(), ORDER):
            p.grad = torch.from_numpy(_to_torch(path, grads[0][path[0]][path[1]]))
        o.step()
    for a, b in zip(model.trained(), clone.trained()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())

    gs = [torch.full((4,), 3.0), torch.full((9,), -4.0)]
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in gs)))
    clip_by_global_norm(gs, 1.0)
    np.testing.assert_allclose(
        float(torch.sqrt(sum((g ** 2).sum() for g in gs))), 1.0, rtol=1e-6)
    small = [torch.full((4,), 1e-3)]
    clip_by_global_norm(small, 1.0)
    np.testing.assert_array_equal(small[0].numpy(), np.full(4, 1e-3, np.float32))
    assert norm > 1.0
