"""The port's training loop, on the CPU at ``ULTRA_TINY``.

A run killed in its second epoch and resumed from its checkpoint equals the
unbroken run bit for bit; the loop equals the JAX package's loop (on the
8-device CPU mesh) from the same step-0 state; the CLI, reading TFRecords
at the stored shapes. The device prefetch has tests of its own
(``tests/test_torch_prefetch.py``).

TrajNet's dropouts (rate 0.1, fixed) would draw noise where the comparisons
want none: the port's loop seeds its generator at every start, as the JAX
loop re-creates ``PRNGKey(seed)``, so a resumed run draws other noise than
the unbroken one; and the two packages draw from different generators. The
tests turn them off (``drop_path_rate`` is 0 at this size): the port's
through ``models.trajnet._DROPOUT``, the JAX step by running its forward
with ``training=False``.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.train import loop as jloop
from strajnet_tpu.train import state as jstate_mod
from strajnet_tpu.train import step as jstep
from strajnet_tpu_torch.config import ULTRA_TINY_MODEL_CONFIG, TrainConfig
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import (find_nadam_state,
                                                  flax_to_state_dict,
                                                  nadam_state_to_state_dict)
from strajnet_tpu_torch.models import trajnet
from strajnet_tpu_torch.train import loop
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG
BATCH = 8
# zero gradients but for rounding (ROADMAP.md §3): Nadam turns their noise
# into steps of the learning rate's size
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")


@pytest.fixture(scope="module")
def data():
    """Two epochs of two train batches and a val split of one batch."""
    return {"train": [[synthetic_batch(CFG, BATCH, seed=10 * e + i)
                       for i in range(2)] for e in range(2)],
            "val": [synthetic_batch(CFG, BATCH, seed=99)]}


class Killed(Exception):
    """Stands for the process being killed."""


def _source(data, kill_at_epoch=None):
    """The ``batches`` callable of ``train``; with ``kill_at_epoch`` the
    run is killed after the first step of that epoch."""
    def killed(epoch):
        yield data["train"][epoch][0]
        raise Killed

    def batches(split, epoch):
        if split == "val":
            return data["val"]
        if epoch == kill_at_epoch:
            return killed(epoch)
        return data["train"][epoch]
    return batches


@pytest.fixture(scope="module")
def step0_params():
    """The JAX init with every bias drawn from N(0, 0.1) (zero biases on
    synthetic batches give bias gradients of rounding noise, ROADMAP §3)."""
    state = jstate_mod.create_train_state(JCFG, JTrainConfig(), jit_init=True)
    rng = np.random.default_rng(0)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                    if k == "bias" else np.array(v))
                for k, v in tree.items()}

    return state, walk(jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(trajnet, "_DROPOUT", 0.0)


def _write_step0(save_dir, step0_params):
    """The step-0 train state as a checkpoint of the port, epoch 0."""
    jstate, params = step0_params
    state = create_train_state(CFG, TrainConfig(), device="cpu")
    state.model.load_state_dict(flax_to_state_dict(params), strict=True)
    state.optimizer.load_state_dict(nadam_state_to_state_dict(
        state.model, state.optimizer, find_nadam_state(jstate.opt_state)))
    CheckpointManager(save_dir).save(
        0, state, metrics={"val_loss": 0.0, "epoch": 0, "steps_per_epoch": 0})


def _read_log(save_dir):
    with open(os.path.join(save_dir, "train_log.csv")) as f:
        return list(csv.reader(f))


def _train(save_dir, data, epochs, **kw):
    return loop.train(CFG, train_cfg=TrainConfig(batch_size=BATCH,
                                                 epochs=epochs,
                                                 save_dir=save_dir),
                      device="cpu", batches=_source(data, **kw), log_every=1)


def test_killed_and_resumed_run_equals_the_unbroken_one(tmp_path, data,
                                                        step0_params,
                                                        no_dropout):
    whole, broken = str(tmp_path / "whole"), str(tmp_path / "broken")
    for d in (whole, broken):
        _write_step0(d, step0_params)
    ref = _train(whole, data, 2)
    with pytest.raises(Killed):
        _train(broken, data, 2, kill_at_epoch=1)
    assert CheckpointManager(broken).latest_step() == 2
    assert len(_read_log(broken)) == 2            # header and epoch 1
    resumed = _train(broken, data, 2)
    assert resumed.step == ref.step == 4
    assert _read_log(broken) == _read_log(whole)
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            ref.model.state_dict().values()):
        assert torch.equal(a, b), name
    for pa, pb in zip(resumed.model.parameters(), ref.model.parameters()):
        for k in ("mu", "nu"):
            assert torch.equal(resumed.optimizer.state[pa][k],
                               ref.optimizer.state[pb][k])
    assert CheckpointManager(broken).all_steps() == [0, 2, 4]
    assert CheckpointManager(broken).metadata() == {
        "val_loss": float(_read_log(whole)[2][2]), "epoch": 2,
        "steps_per_epoch": 2}
    # a finished run resumes into nothing
    again = _train(broken, data, 2)
    assert again.step == 4 and len(_read_log(broken)) == 3


def test_noise_comes_from_the_seed(tmp_path, data, step0_params,
                                  monkeypatch):
    """Dropout on: two runs from one checkpoint draw the same noise (the
    generator is seeded from ``TrainConfig.seed``), and the noise moves the
    result away from a run without it."""
    runs = []
    for i in range(3):
        if i == 2:
            monkeypatch.setattr(trajnet, "_DROPOUT", 0.0)
        d = str(tmp_path / str(i))
        _write_step0(d, step0_params)
        runs.append(_train(d, data, 1))
    params = [[p.detach() for p in r.model.parameters()] for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(params[0], params[1]))
    assert not all(torch.equal(a, b) for a, b in zip(params[0], params[2]))
    assert _read_log(str(tmp_path / "0")) == _read_log(str(tmp_path / "1"))


def _without_key_bias(name, arr):
    """The key third of a Swin block's qkv bias has a zero gradient but for
    rounding (ROADMAP.md §3)."""
    if name.endswith("attn.qkv.bias"):
        c = arr.shape[0] // 3
        return np.concatenate([arr[:c], arr[2 * c:]])
    return arr


def test_loop_matches_the_jax_loop(tmp_path, data, step0_params, no_dropout,
                                   monkeypatch):
    """The JAX package's ``train`` on the 8-device CPU mesh and the port's
    ``train`` on the same batches, from the same step-0 state: parameters
    and Nadam moments after two epochs, and ``train_log.csv``.

    The port resumes from a checkpoint of that state. The JAX loop starts
    from it through its ``create_train_state``: resumed from an Orbax
    checkpoint on the 8-device mesh, its first step raises ("incompatible
    devices": the restored optimizer state is committed to device 0, the
    parameters are sharded over all eight), a fault of the JAX package that
    the port does not share (``ROADMAP.md`` §3)."""
    jstate, params = step0_params
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    start = jstate.replace(params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                         params))
    monkeypatch.setattr(jloop, "create_train_state", lambda *a, **kw: start)
    _write_step0(tdir, step0_params)

    def train_dataset(pattern, batch_size, shuffle_buffer, seed=None, **kw):
        assert batch_size == BATCH
        return data["train"][seed - JTrainConfig().seed]

    monkeypatch.setattr(jloop, "make_train_dataset", train_dataset)
    monkeypatch.setattr(jloop, "make_eval_dataset",
                        lambda *a, **kw: data["val"])
    monkeypatch.setattr(jloop, "as_numpy", iter)
    forward = jstep._forward
    monkeypatch.setattr(jstep, "_forward",
                        lambda state, p, batch, training, rng=None:
                        forward(state, p, batch, False))
    jcfg = JTrainConfig(batch_size=BATCH, epochs=2, save_dir=jdir)
    jax_state = jloop.train(model_cfg=JCFG, train_cfg=jcfg)
    ours = loop.train(CFG, train_cfg=TrainConfig(batch_size=BATCH, epochs=2,
                                                 save_dir=tdir),
                      device="cpu", batches=_source(data))
    assert ours.step == int(jax_state.step) == 4

    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jax_state.params))
    nadam = find_nadam_state(jax_state.opt_state)
    assert int(np.asarray(nadam["count"])) == 4
    mu = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, nadam["mu"]))
    nu = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, nadam["nu"]))
    named = dict(ours.model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        if name.startswith(ZERO_GRAD):
            continue
        # f32 both sides; XLA's sharded sums against ATen's, over 4 steps
        np.testing.assert_allclose(
            _without_key_bias(name, p.detach().numpy()),
            _without_key_bias(name, want[name].numpy()),
            rtol=1e-4, atol=1e-4, err_msg=name)
        for k, ref in (("mu", mu), ("nu", nu)):
            got = _without_key_bias(name, ours.optimizer.state[p][k].numpy())
            w = _without_key_bias(name, ref[name].numpy())
            np.testing.assert_allclose(
                got, w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
                err_msg=f"{k} {name}")

    jlog, tlog = _read_log(jdir), _read_log(tdir)
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 3
    for jrow, trow in zip(jlog[1:], tlog[1:]):
        assert trow[0] == jrow[0]
        for col, a, b in zip(tlog[0][1:], trow[1:], jrow[1:]):
            rtol = 1e-4 if col in ("loss", "val_loss") else 1e-3
            np.testing.assert_allclose(float(a), float(b), rtol=rtol,
                                       atol=rtol, err_msg=col)


def test_profile_dir_gets_a_trace_of_steps_10_to_20(tmp_path):
    """Twenty-two steps of batch 1: the ``torch.profiler`` trace starts
    before step 11 and is written after step 20, once."""
    import json
    batch = synthetic_batch(CFG, 1, seed=4)
    trace_dir = str(tmp_path / "trace")
    loop.train(CFG, train_cfg=TrainConfig(batch_size=1, epochs=1,
                                          save_dir=str(tmp_path / "ckpt")),
               device="cpu", profile_dir=trace_dir,
               batches=lambda split, epoch: [batch] * (22 if split ==
                                                       "train" else 1))
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert os.listdir(trace_dir) == ["trace.json"]


def test_cli_reads_the_train_and_val_splits(tmp_path, monkeypatch):
    """Three records at the stored shapes under <root>/train and <root>/val,
    batch size 2: one train batch (the remainder dropped) and two val
    batches (the last, partial one kept). The steps are swapped for
    recorders: this exercises the reader, the log and the checkpoint."""
    import tensorflow as tf
    from strajnet_tpu_torch.data.schema import SHAPES, encode_example
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        (tmp_path / split).mkdir()
        with tf.io.TFRecordWriter(str(tmp_path / split /
                                      "00000.tfrecords")) as w:
            for _ in range(3):
                w.write(encode_example({
                    k: (rng.random(shape) < 0.1).astype(np.float32)
                    for k, shape in SHAPES.items()}))
    seen = {"train": [], "val": []}

    def fake_train_step(*a, **kw):
        def step(state, batch, generator, loss_sums):
            assert state.model.training and generator is not None
            seen["train"].append((batch["ogm"].shape[0], batch["ogm"].dtype))
            state.step += 1
            return state, {k: v + 1.0 for k, v in loss_sums.items()}
        return step

    def fake_eval_step(*a, **kw):
        def step(model, batch):
            assert not model.training
            seen["val"].append(batch["ogm"].shape[0])
            return ({"total": torch.tensor(3.0)},
                    {"observed_auc": torch.tensor(0.5)})
        return step

    monkeypatch.setattr(loop, "STRAJNET_CONFIG", CFG)
    monkeypatch.setattr(loop, "make_train_step", fake_train_step)
    monkeypatch.setattr(loop, "make_eval_step", fake_eval_step)
    save = str(tmp_path / "ckpt")
    args = ["--file_dir", str(tmp_path), "--save_dir", save, "--batch_size",
            "2", "--epochs", "1", "--device", "cpu"]
    loop.main(args)
    assert seen == {"train": [(2, torch.uint8)], "val": [2, 1]}
    assert CheckpointManager(save).latest_step() == 1
    assert _read_log(save) == [["epoch", "loss", "val_loss",
                                "val_observed_auc"], ["1", "1.0", "3.0",
                                                      "0.5"]]
    # resumed with one more epoch: only epoch 2 runs
    loop.main(args[:-3] + ["2", "--device", "cpu"])
    assert len(seen["train"]) == 2
    assert [r[0] for r in _read_log(save)] == ["epoch", "1", "2"]


def test_cli_flags_pick_the_configuration(monkeypatch):
    got = {}
    monkeypatch.setattr(loop, "train", lambda **kw: got.update(kw))
    loop.main(["--no_fg_msa", "--pallas", "attn", "--remat", "--constant_lr",
               "--lr", "3e-4", "--batch_size", "4", "--epochs", "3",
               "--device", "cpu", "--profile_dir", "/p"])
    cfg, tcfg = got["model_cfg"], got["train_cfg"]
    assert (cfg.fg_msa, cfg.fg) == (False, False)
    assert cfg.use_pallas_attention == "attn" and cfg.remat_encoder
    assert dataclasses.replace(cfg, use_pallas_attention=None,
                               remat_encoder=False) == \
        loop.STRAJNET_TRAIN_PY_CONFIG
    assert not tcfg.use_schedule and tcfg.lr == 3e-4
    assert (tcfg.batch_size, tcfg.epochs) == (4, 3)
    assert got["device"] == "cpu" and got["profile_dir"] == "/p"
    loop.main([])
    assert got["model_cfg"] == loop.STRAJNET_CONFIG
    assert got["device"] == "cuda" and got["model_axis"] == 1


def test_one_device_only_and_the_default_device_is_the_card(tmp_path):
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        loop.train(CFG, model_axis=2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        loop.main(["--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        loop.train(CFG, train_cfg=TrainConfig(save_dir=str(tmp_path)),
                   batches=lambda split, epoch: [])
