"""The port's ``ogmflow_loss`` against JAX, on the CPU.

Every term over the flags of ``LossConfig`` (and ``use_bce_warp``,
``replica``): values and the gradient with respect to the predicted logits,
on seeded synthetic ground truth, an empty scene included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import LossConfig as JLossConfig
from strajnet_tpu.config import WAYMO_TASK_CONFIG as JTASK
from strajnet_tpu.objective import loss as jloss
from strajnet_tpu_torch.config import WAYMO_TASK_CONFIG, LossConfig
from strajnet_tpu_torch.objective import loss as tloss

torch.set_num_threads(2)

B, T, H, W = 2, 3, 16, 16
TERMS = ("observed_xe", "occluded_xe", "flow", "flow_warp_xe")


def _case(seed=0, empty=()):
    """Ground truth and logits [B, T, H, W, c]; the waypoints in ``empty``
    hold no occupancy at all."""
    rng = np.random.default_rng(seed)
    obs = (rng.random((B, T, H, W, 1)) < 0.15).astype(np.float32)
    occ = (rng.random((B, T, H, W, 1)) < 0.08).astype(np.float32)
    flow = (rng.standard_normal((B, T, H, W, 2)) * 2).astype(np.float32)
    flow *= (rng.random((B, T, H, W, 1)) < 0.3)      # zero where no flow
    origin = (rng.random((B, T, H, W, 1)) < 0.2).astype(np.float32)
    for k in empty:
        obs[:, k] = 0.0
        occ[:, k] = 0.0
    true = (obs, occ, flow.astype(np.float32), origin)
    pred = ((rng.standard_normal((B, T, H, W, 1)) * 2).astype(np.float32),
            (rng.standard_normal((B, T, H, W, 1)) * 2).astype(np.float32),
            # off the integer lattice: the clip subgradient at exact ties is
            # a convention the two frameworks do not share
            (rng.standard_normal((B, T, H, W, 2)) * 1.5 + 0.123
             ).astype(np.float32))
    return true, pred


def _run_torch(true, pred, cfg_kw, **kw):
    logits = [torch.from_numpy(p).requires_grad_(True) for p in pred]
    grids = tloss.WaypointGrids(*logits, torch.zeros(B, T, H, W, 1))
    out = tloss.ogmflow_loss(
        WAYMO_TASK_CONFIG, LossConfig(**cfg_kw),
        tloss.WaypointGrids(*(torch.from_numpy(t) for t in true)), grids,
        **kw)
    total = sum(out[k] for k in TERMS)
    grads = torch.autograd.grad(total, logits, allow_unused=True)
    grads = [np.zeros_like(p) if g is None else g.numpy()
             for g, p in zip(grads, pred)]
    return {k: float(v.detach()) for k, v in out.items()}, grads


def _run_jax(true, pred, cfg_kw, **kw):
    jtrue = jloss.WaypointGrids(*(jnp.asarray(t) for t in true))

    def fn(logits):
        grids = jloss.WaypointGrids(*logits, jnp.zeros((B, T, H, W, 1)))
        out = jloss.ogmflow_loss(JTASK, JLossConfig(**cfg_kw), jtrue, grids,
                                 **kw)
        return sum(out[k] for k in TERMS), out

    (_, out), grads = jax.value_and_grad(fn, has_aux=True)(
        [jnp.asarray(p) for p in pred])
    return ({k: float(v) for k, v in out.items()},
            [np.asarray(g) for g in grads])


FLAG_CASES = {
    "defaults": (dict(), dict()),
    "focal": (dict(use_focal_loss=True), dict()),
    "use_pred": (dict(use_pred=True), dict()),
    "use_pred_focal": (dict(use_pred=True, use_focal_loss=True), dict()),
    "no_use_warp": (dict(no_use_warp=True), dict()),
    "no_gate": (dict(use_gt=False), dict()),
    "warp_pred_logits": (dict(warp_pred_logits=True), dict()),
    "portable_warp": (dict(warp_kernel=False), dict()),
    "bce_warp": (dict(), dict(use_bce_warp=True)),
    "replica": (dict(), dict(replica=4.0)),
    "weights": (dict(ogm_weight=10.0, occ_weight=5.0, flow_weight=2.0,
                     flow_origin_weight=7.0), dict()),
}


@pytest.mark.parametrize("empty", [(), (1,)], ids=["full", "empty_waypoint"])
@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_loss_terms_and_logit_gradients_match_jax(name, empty):
    cfg_kw, kw = FLAG_CASES[name]
    true, pred = _case(seed=len(name), empty=empty)
    ours, our_grads = _run_torch(true, pred, cfg_kw, **kw)
    ref, ref_grads = _run_jax(true, pred, cfg_kw, **kw)
    assert set(ours) == set(ref) == set(TERMS)
    for k in TERMS:
        # f32 sums over B*H*W cells in another order
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for got, want, what in zip(our_grads, ref_grads,
                               ("observed", "occluded", "flow")):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12),
                                   err_msg=what)


def test_gate_is_zero_on_an_empty_scene():
    """Every waypoint empty: the gate sum is 0 and ``_div_no_nan`` gives 0
    for both flow terms, with zero gradient into the flow."""
    true, pred = _case(seed=3, empty=tuple(range(T)))
    ours, grads = _run_torch(true, pred, {})
    ref, ref_grads = _run_jax(true, pred, {})
    assert ours["flow"] == 0.0 and ours["flow_warp_xe"] == 0.0
    assert ref["flow"] == 0.0 and ref["flow_warp_xe"] == 0.0
    assert not np.any(grads[2]) and not np.any(ref_grads[2])
    np.testing.assert_allclose(ours["observed_xe"], ref["observed_xe"],
                               rtol=1e-5)


def test_loss_object_and_batch_assembly():
    true, pred = _case(seed=4)
    batch = dict(zip(("gt_obs_ogm", "gt_occ_ogm", "gt_flow", "origin_flow"),
                     (torch.from_numpy(t) for t in true)))
    grids = tloss.true_waypoints_from_batch(batch)
    assert grids.flow.shape == (B, T, H, W, 2)
    fn = tloss.OGMFlowLoss(WAYMO_TASK_CONFIG,
                           dataclasses.replace(LossConfig(), use_pred=True),
                           replica=2.0, use_bce_warp=True)
    logits = tloss.WaypointGrids(*(torch.from_numpy(p) for p in pred),
                                 torch.zeros(B, T, H, W, 1))
    out = fn(grids, logits)
    ref = tloss.ogmflow_loss(WAYMO_TASK_CONFIG, LossConfig(use_pred=True),
                             grids, logits, replica=2.0, use_bce_warp=True)
    assert {k: float(v) for k, v in out.items()} == {
        k: float(v) for k, v in ref.items()}


def test_div_no_nan():
    a = torch.tensor([1.0, 2.0, 0.0])
    b = torch.tensor([2.0, 0.0, 0.0])
    np.testing.assert_array_equal(tloss._div_no_nan(a, b).numpy(),
                                  [0.5, 0.0, 0.0])
