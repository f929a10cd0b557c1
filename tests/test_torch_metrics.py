"""The port's challenge metrics against the JAX package, on the CPU."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import strajnet_tpu.objective.pr_auc  # noqa: F401  (the module, not the function)
from strajnet_tpu.objective import loss as jloss
from strajnet_tpu.objective import metrics as jmetrics
from strajnet_tpu_torch.objective import metrics as tmetrics
from strajnet_tpu_torch.objective import pr_auc as tauc
from strajnet_tpu_torch.objective.loss import WaypointGrids

jauc = sys.modules["strajnet_tpu.objective.pr_auc"]
torch.set_num_threads(2)


def _auc_case(name):
    rng = np.random.default_rng(0)
    n = 20000
    y_true = (rng.random(n) < 0.1).astype(np.float32)
    y_pred = rng.random(n).astype(np.float32)
    if name == "all_zero":
        y_true[:] = 0.0
    elif name == "all_one":
        y_true[:] = 1.0
    elif name == "ties_on_thresholds":
        # predictions exactly on the 100 Keras thresholds, 0 and 1 included
        y_pred = (rng.integers(0, 100, n) / 99.0).astype(np.float32)
    elif name == "soft_labels":   # any nonzero label is one positive
        y_true = y_true * rng.random(n).astype(np.float32)
    elif name == "separable":
        y_pred = np.where(y_true > 0, 0.9, 0.1).astype(np.float32)
    return y_true, y_pred


CASES = ["random", "all_zero", "all_one", "ties_on_thresholds", "soft_labels",
         "separable"]


@pytest.mark.parametrize("name", CASES)
def test_confusion_counts_are_exactly_those_of_jax(name):
    y_true, y_pred = _auc_case(name)
    ours = tauc.confusion_counts(torch.from_numpy(y_true),
                                 torch.from_numpy(y_pred))
    ref = jauc.confusion_counts(jnp.asarray(y_true), jnp.asarray(y_pred))
    for a, b in zip(ours, ref):
        assert a.shape == (100,) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", CASES)
def test_pr_auc_matches_jax(name):
    y_true, y_pred = _auc_case(name)
    ours = float(tauc.pr_auc(torch.from_numpy(y_true).reshape(4, -1),
                             torch.from_numpy(y_pred).reshape(4, -1)))
    ref = float(jauc.pr_auc(jnp.asarray(y_true), jnp.asarray(y_pred)))
    assert abs(ours - ref) <= 1e-6, (ours, ref)
    tp, fp, _, fn = tauc.confusion_counts(torch.from_numpy(y_true),
                                          torch.from_numpy(y_pred))
    assert float(tauc.pr_auc_from_counts(tp, fp, fn)) == ours


def test_thresholds_are_those_of_keras():
    np.testing.assert_array_equal(tauc._keras_thresholds(100).numpy(),
                                  np.asarray(jauc._keras_thresholds(100)))


def _grids(seed, b=2, t=3, h=16, w=16):
    rng = np.random.default_rng(seed)
    obs = (rng.random((b, t, h, w, 1)) < 0.15).astype(np.float32)
    occ = (rng.random((b, t, h, w, 1)) < 0.05).astype(np.float32)
    flow = (rng.standard_normal((b, t, h, w, 2)) * 2).astype(np.float32)
    flow *= (rng.random((b, t, h, w, 1)) < 0.3)
    origin = (rng.random((b, t, h, w, 1)) < 0.2).astype(np.float32)
    true = (obs, occ, flow.astype(np.float32), origin)
    pred = (rng.random((b, t, h, w, 1)).astype(np.float32),
            rng.random((b, t, h, w, 1)).astype(np.float32),
            (rng.standard_normal((b, t, h, w, 2)) * 2).astype(np.float32),
            np.zeros((b, t, h, w, 1), np.float32))
    return true, pred


@pytest.mark.parametrize("no_warp", [False, True])
def test_occupancy_flow_metrics_match_jax(no_warp):
    true, pred = _grids(0)
    ours = tmetrics.compute_occupancy_flow_metrics(
        WaypointGrids(*map(torch.from_numpy, true)),
        WaypointGrids(*map(torch.from_numpy, pred)), no_warp=no_warp)
    ref = jmetrics.compute_occupancy_flow_metrics(
        jloss.WaypointGrids(*map(jnp.asarray, true)),
        jloss.WaypointGrids(*map(jnp.asarray, pred)), no_warp=no_warp)
    assert tuple(ours) == tmetrics.METRIC_KEYS and set(ours) == set(ref)
    for k in ours:
        assert ours[k].shape == ()
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if no_warp:
        assert float(ours["vehicles_flow_warped_occupancy_auc"]) == 0.0


def test_soft_iou_and_epe_of_empty_grids_are_zero():
    z = torch.zeros(2, 3, 8, 8, 1)
    assert tmetrics._soft_iou(z, z).tolist() == [0.0] * 3
    assert tmetrics._flow_epe(torch.zeros(2, 3, 8, 8, 2),
                              torch.ones(2, 3, 8, 8, 2)).tolist() == [0.0] * 3


def test_per_waypoint_pass_equals_one_call_per_waypoint():
    """``group_dim``: the counts and AUCs of every waypoint from one pass are
    those of one call per waypoint, and the IoU and EPE those of JAX."""
    true, pred = _grids(5)
    t_obs, p_obs = torch.from_numpy(true[0]), torch.from_numpy(pred[0])
    grouped = tauc.confusion_counts(t_obs, p_obs, group_dim=1)
    aucs = tauc.pr_auc(t_obs, p_obs, group_dim=1)
    assert aucs.shape == (3,)
    for k in range(3):
        single = tauc.confusion_counts(t_obs[:, k], p_obs[:, k])
        for a, b in zip(grouped, single):
            assert torch.equal(a[k], b)
        assert float(aucs[k]) == float(tauc.pr_auc(t_obs[:, k], p_obs[:, k]))
        np.testing.assert_allclose(
            float(tmetrics._soft_iou(t_obs, p_obs)[k]),
            float(jmetrics._soft_iou(jnp.asarray(true[0][:, k]),
                                     jnp.asarray(pred[0][:, k]))), rtol=1e-6)
        np.testing.assert_allclose(
            float(tmetrics._flow_epe(torch.from_numpy(true[2]),
                                     torch.from_numpy(pred[2]))[k]),
            float(jmetrics._flow_epe(jnp.asarray(true[2][:, k]),
                                     jnp.asarray(pred[2][:, k]))), rtol=1e-6)


@pytest.mark.parametrize("no_warp", [False, True])
def test_metrics_accumulator_matches_jax(no_warp, capsys):
    ours = tmetrics.MetricsAccumulator("val", no_warp=no_warp)
    ref = jmetrics.MetricsAccumulator("val", no_warp=no_warp)
    assert ours.get_result() == {}
    for seed in (1, 2):
        true, pred = _grids(seed)
        ours.update_state(tmetrics.compute_occupancy_flow_metrics(
            WaypointGrids(*map(torch.from_numpy, true)),
            WaypointGrids(*map(torch.from_numpy, pred)), no_warp=no_warp))
        ref.update_state(jmetrics.compute_occupancy_flow_metrics(
            jloss.WaypointGrids(*map(jnp.asarray, true)),
            jloss.WaypointGrids(*map(jnp.asarray, pred)), no_warp=no_warp))
    got, want = ours.get_result(), ref.get_result()
    assert list(got) == list(want) and len(got) == (5 if no_warp else 7)
    for k in got:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    block = tmetrics.print_metrics(got, "val", no_warp=no_warp)
    assert block == jmetrics.print_metrics(got, "val", no_warp=no_warp)
    assert capsys.readouterr().out.count("obs-AUC") == 2
    ours.reset_states()
    assert ours.get_result() == {}
