"""The port's checkpoints, on the CPU at a tiny size: the round trip of a
train state, pruning, the sidecar, saves cut short, ``restore_params`` and
checkpoint directories as ``--weight_path`` of both CLIs."""

import os

import pytest
import torch

from strajnet_tpu_torch.config import (ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.infer import evaluate as ev
from strajnet_tpu_torch.infer import runner
from strajnet_tpu_torch.train import checkpoints as ckpt_mod
from strajnet_tpu_torch.train.checkpoints import (CheckpointManager,
                                                  load_weights)
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG


class Killed(Exception):
    """Stands for the process being killed."""


def _trained_state(seed=0, steps=2):
    """A train state after ``steps`` Nadam steps, so that its moments, count
    and momentum-cache product are not the initial ones."""
    state = create_train_state(CFG, TrainConfig(seed=seed), device="cpu")
    state.model.eval()
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(CFG, 2, seed=seed).items()}
    for _ in range(steps):
        state, _ = step(state, batch)
    return state


def _assert_same_state(a, b):
    assert a.step == b.step
    for (na, pa), (nb, pb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    ga, gb = a.optimizer.param_groups[0], b.optimizer.param_groups[0]
    assert ga["count"] == gb["count"] and ga["mu_product"] == gb["mu_product"]
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        for k in ("mu", "nu"):
            assert torch.equal(a.optimizer.state[pa][k],
                               b.optimizer.state[pb][k])


def test_round_trip_is_bit_exact(tmp_path):
    state = _trained_state()
    group = state.optimizer.param_groups[0]
    assert state.step == 2 and group["count"] == 2
    assert group["mu_product"] not in (0.0, 1.0)
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.restore(_trained_state(seed=1, steps=0)) == (None, None)
    assert mngr.restore_params() == (None, None)
    assert mngr.latest_step() is None and mngr.metadata() == {}
    mngr.save(state.step, state)
    other = _trained_state(seed=1, steps=1)
    restored, step = mngr.restore(other)
    assert restored is other and step == 2
    _assert_same_state(restored, state)
    # the restored optimizer goes on exactly as the original one
    step_fn = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                              CFG.num_waypoints)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(CFG, 2, seed=7).items()}
    a, _ = step_fn(state, batch)
    b, _ = step_fn(restored, batch)
    _assert_same_state(a, b)
    mngr.close()


def test_max_to_keep_prunes_the_oldest_with_their_sidecars(tmp_path):
    state = _trained_state(steps=0)
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 3, 7):
        state.step = step
        mngr.save(step, state, metrics={"epoch": step})
    assert mngr.all_steps() == [5, 7] and mngr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == ["5", "7", "meta_5.json",
                                            "meta_7.json"]


def test_sidecar_and_metadata(tmp_path):
    state = _trained_state(steps=0)
    mngr = CheckpointManager(str(tmp_path))
    meta = {"val_loss": 12.5, "epoch": 3, "steps_per_epoch": 40}
    mngr.save(120, state, metrics=meta)
    mngr.save(160, state)
    assert mngr.metadata(120) == meta
    assert mngr.metadata() == {}          # the newest, saved without
    assert mngr.metadata(999) == {}
    with open(tmp_path / "meta_160.json", "w") as f:
        f.write("{not json")
    assert mngr.metadata(160) == {}


def test_a_save_cut_short_leaves_no_checkpoint(tmp_path, monkeypatch):
    state = _trained_state(steps=0)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(4, state, metrics={"epoch": 1})

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise Killed

    monkeypatch.setattr(ckpt_mod.torch, "save", killed)
    with pytest.raises(Killed):
        mngr.save(8, state, metrics={"epoch": 2})
    monkeypatch.undo()
    # a leftover temporary directory, and a step directory without a state
    assert any(n.startswith(".tmp-8") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / "9")
    assert mngr.latest_step() == 4 and mngr.all_steps() == [4]
    assert mngr.metadata() == {"epoch": 1}
    restored, step = mngr.restore(_trained_state(seed=1, steps=0))
    assert step == 4
    # the next save of that step goes through
    mngr.save(8, state, metrics={"epoch": 2})
    assert mngr.latest_step() == 8


def test_restore_params_is_the_model_state_dict(tmp_path):
    state = _trained_state()
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(2, state)
    state.step = 6
    mngr.save(6, state)
    params, step = mngr.restore_params()
    assert step == 6
    want = state.model.state_dict()
    assert list(params) == list(want)
    assert all(torch.equal(params[k], want[k]) for k in want)
    assert all(v.device.type == "cpu" for v in params.values())
    assert mngr.restore_params(2)[1] == 2


def _write_weights(tmp_path):
    """The same weights as a checkpoint directory and as a .pt file."""
    state = _trained_state(seed=5)
    ckpt_dir = tmp_path / "ckpt"
    CheckpointManager(str(ckpt_dir)).save(2, state)
    pt = tmp_path / "weights.pt"
    torch.save(state.model.state_dict(), pt)
    return str(ckpt_dir), str(pt), state.model.state_dict()


def test_load_weights_takes_a_directory_or_a_file(tmp_path):
    ckpt_dir, pt, want = _write_weights(tmp_path)
    for path in (ckpt_dir, pt):
        got = load_weights(path)
        assert all(torch.equal(got[k], want[k]) for k in want)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_weights(str(tmp_path / "empty"))


def test_evaluate_takes_a_checkpoint_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(ev, "STRAJNET_CONFIG", CFG)
    ckpt_dir, pt, _ = _write_weights(tmp_path)
    batches = [synthetic_batch(CFG, 2, seed=20)]
    a = ev.evaluate("unused", weight_path=ckpt_dir, device="cpu",
                    batches=batches)
    b = ev.evaluate("unused", weight_path=pt, device="cpu", batches=batches)
    c = ev.evaluate("unused", device="cpu", batches=batches)
    assert a == b and a != c


def test_runner_takes_a_checkpoint_directory(tmp_path, monkeypatch):
    """``runner.main`` with ``--weight_path`` a directory and a .pt file
    hands ``run_shard`` a model with the same weights; ``run_shard`` is
    swapped for a recorder, so no shard is read."""
    monkeypatch.setattr(runner, "STRAJNET_CONFIG", CFG)
    ckpt_dir, pt, want = _write_weights(tmp_path)
    (tmp_path / "test").mkdir()
    (tmp_path / "test" / "00000new.tfrecords").write_bytes(b"")
    seen = []

    def record(model, predict_step, shard, ids, save_dir, **kw):
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        assert not model.training
        return 0

    monkeypatch.setattr(runner, "run_shard", record)
    for path in (ckpt_dir, pt):
        runner.main(["--no_id_check", "--file_dir", str(tmp_path / "test"),
                     "--weight_path", path, "--device", "cpu"])
    assert len(seen) == 2
    for got in seen:
        assert all(torch.equal(got[k], want[k]) for k in want)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        runner.main(["--no_id_check", "--file_dir", str(tmp_path / "test"),
                     "--weight_path", str(tmp_path / "empty"),
                     "--device", "cpu"])
