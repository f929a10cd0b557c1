"""The port's evaluate entry point, on the CPU at a tiny size."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.config import (ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.infer import evaluate as ev
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.train.step import make_eval_step

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG
METRICS = ("observed_auc", "occluded_auc", "observed_iou", "occluded_iou",
           "flow_epe", "flow_ogm_auc", "flow_ogm_iou")
LOSSES = ("observed_xe", "occluded_xe", "flow", "flow_warp_xe", "total")


@pytest.fixture(autouse=True)
def tiny_model(monkeypatch):
    """``evaluate`` builds ``STRAJNET_CONFIG``; here that name holds the tiny
    configuration, so the entry point runs on the CPU."""
    monkeypatch.setattr(ev, "STRAJNET_CONFIG", CFG)


def _batches(sizes=(2, 2, 1)):
    return [synthetic_batch(CFG, n, seed=10 + i) for i, n in enumerate(sizes)]


@pytest.mark.parametrize("pallas", ["auto", "attn", "off"])
def test_evaluate_on_given_batches(pallas, capsys):
    res = ev.evaluate("unused", batch_size=2, pallas=pallas, device="cpu",
                      batches=_batches())
    assert set(res) == {f"val_{k}" for k in METRICS + LOSSES}
    assert all(isinstance(v, float) and np.isfinite(v) for v in res.values())
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == res
    assert sum(line.startswith(" |") for line in out) == 4


def test_every_mode_gives_the_same_numbers_on_the_cpu():
    runs = [ev.evaluate("unused", pallas=p, device="cpu", batches=_batches())
            for p in ("off", "attn", "block", "block_fwd")]
    for other in runs[1:]:
        for k, v in runs[0].items():
            np.testing.assert_allclose(other[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_no_warp_leaves_the_flow_grounded_metrics_out():
    res = ev.evaluate("unused", no_warp=True, device="cpu",
                      batches=_batches((2,)))
    assert len(res) == 10 and "val_flow_ogm_auc" not in res


def test_evaluate_batches_is_the_mean_over_batches():
    model = STrajNet(CFG)
    model.load_state_dict(init_params(CFG, torch.Generator().manual_seed(0)))
    model.eval()
    step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints)
    batches = _batches((2, 2))
    both = ev.evaluate_batches(model, step, batches)
    singles = [ev.evaluate_batches(model, step, [b]) for b in batches]
    for k, v in both.items():
        np.testing.assert_allclose(v, (singles[0][k] + singles[1][k]) / 2,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert ev.evaluate_batches(model, step, []) == {}


def test_weights_come_from_a_state_dict_file(tmp_path):
    sd = init_params(CFG, torch.Generator().manual_seed(5))
    path = str(tmp_path / "weights.pt")
    torch.save(sd, path)
    a = ev.evaluate("unused", weight_path=path, device="cpu",
                    batches=_batches((2,)))
    b = ev.evaluate("unused", device="cpu", batches=_batches((2,)))
    assert a != b   # seed 5 against the default seed 0


def test_an_empty_split_raises():
    with pytest.raises(FileNotFoundError, match="no records matched"):
        ev.evaluate("nothing/val/*.tfrecords", device="cpu", batches=[])


def test_the_default_device_is_the_card_and_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ev.evaluate("unused", batches=_batches((1,)))
    with pytest.raises(RuntimeError, match="--device cpu"):
        ev.main(["--file_dir", "/nonexistent"])


def test_cli_reads_a_val_split_and_keeps_the_partial_batch(tmp_path,
                                                           monkeypatch):
    """Three records at the stored shapes under <root>/val, batch size 2:
    ``main`` hands the loop two batches, the last of one record. The loop
    is swapped for a recorder: this exercises the reader."""
    import tensorflow as tf
    from strajnet_tpu_torch.data.schema import SHAPES, encode_example
    (tmp_path / "val").mkdir()
    rng = np.random.default_rng(0)
    with tf.io.TFRecordWriter(str(tmp_path / "val" / "00000.tfrecords")) as w:
        for _ in range(3):
            feats = {k: (rng.random(shape) < 0.1).astype(np.float32)
                     for k, shape in SHAPES.items()}
            w.write(encode_example(feats))
    seen = []

    def fake_batches(model, eval_step, batches, no_warp=False):
        seen.extend(b["ogm"].shape[0] for b in batches)
        return {"val_total": 1.0}

    monkeypatch.setattr(ev, "evaluate_batches", fake_batches)
    ev.main(["--file_dir", str(tmp_path), "--batch_size", "2", "--device",
             "cpu"])
    assert seen == [2, 1]
