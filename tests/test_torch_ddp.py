"""Data-parallel training of the port (``parallel/ddp.py``) on the CPU.

Two ranks on ``gloo`` at ULTRA_TINY against the port's single process on
the concatenated batch: one training step with drop-path and dropout noise
on (losses, every gradient, the parameters after the Nadam update), the val
metrics (PR-AUC from summed bucket counts), the loss where one rank's flow
field and the other's scene are empty, checkpoints across the two set-ups;
the feed's record shards; the two-rank loop against the JAX loop on the
8-device CPU mesh; and the last two Swin modules against JAX.

The ranks run one script (``_WORKER``, written to ``tmp_path``) that
imports only torch and the port, so they pay for neither JAX's import nor
the 8-device setup of ``tests/conftest.py``. They meet through a
``FileStore`` in ``tmp_path`` (no TCP port: the test workers run side by
side) and each has a timeout of its own, so a hang fails this file's tests
and nothing else. They start once for the whole file, at the first test,
and work while the JAX loop runs here.

TrajNet's dropout (rate 0.1, fixed) stays on in the step against the single
process: every rank draws each mask at the global batch's shape and keeps
its rows (``ops/dropout.py``). Against JAX it is off in both packages, as
in ``tests/test_torch_loop.py``: the two draw from different generators.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.models import swin as jswin
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.models.strajnet import dummy_inputs as jax_dummy_inputs
from strajnet_tpu.train import loop as jloop
from strajnet_tpu.train import state as jstate_mod
from strajnet_tpu.train import step as jstep
from strajnet_tpu_torch.config import (ULTRA_TINY_MODEL_CONFIG,
                                       WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models import swin as tswin
from strajnet_tpu_torch.objective.loss import (ogmflow_loss,
                                               split_pred_waypoints,
                                               true_waypoints_from_batch)
from strajnet_tpu_torch.objective.pr_auc import bucket_histogram
from strajnet_tpu_torch.parallel import ddp
from strajnet_tpu_torch.train import loop
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                           make_train_step)
from tests.test_torch_variants import fill_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ULTRA_TINY_MODEL_CONFIG
# the step against the single process: stochastic depth on
CFG_DP = dataclasses.replace(CFG, drop_path_rate=0.2)
RANKS = 2
RANK_TIMEOUT_S = 120
# zero gradients but for rounding (ROADMAP.md §3): Nadam turns their noise
# into steps of the learning rate's size
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")

_WORKER = r'''
import os
import sys

import numpy as np
import torch

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)

from strajnet_tpu_torch.config import (WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.data import pipeline
from strajnet_tpu_torch.models import trajnet
from strajnet_tpu_torch.objective.loss import (
    ogmflow_loss, split_pred_waypoints, true_waypoints_from_batch)
from strajnet_tpu_torch.objective.pr_auc import bucket_histogram
from strajnet_tpu_torch.parallel import ddp
from strajnet_tpu_torch.train import loop
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import (make_eval_step,
                                           make_predict_step,
                                           make_train_step)

ddp.init_distributed("cpu", init_method="file://" + os.path.join(
    tmp, "rendezvous"), rank=rank, world_size=world)
spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
cfg_dp, n_wp = spec["cfg_dp"], spec["cfg_dp"].num_waypoints
out = {}


def mine(batch):
    """This rank's rows of a global numpy batch."""
    rows = len(next(iter(batch.values()))) // world
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * rows:(rank + 1) * rows])) for k, v in batch.items()}


def named(model, what):
    return {n: what(p).clone()
            for n, p in ddp.unwrap(model).named_parameters()}


# (a) one training step on this rank's half of the batch
state = create_train_state(cfg_dp, TrainConfig(), device="cpu")
out["wrapped"] = type(state.model).__name__
ddp.unwrap(state.model).load_state_dict(spec["params"])
step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), n_wp)
state, losses = step(state, mine(spec["train"]),
                     torch.Generator().manual_seed(0))
out["losses"] = {k: v.item() for k, v in losses.items()}
out["grads"] = named(state.model, lambda p: p.grad)
out["params"] = named(state.model, lambda p: p.detach())
out["reduced_bytes"] = ddp.allreduce_sum_hook.bytes

# (e) the DDP checkpoint, written by rank 0 alone; the single process's
# checkpoint restored into a DDP state
writes = []
write = CheckpointManager._write


def counted(self, *a):
    writes.append(rank)
    return write(self, *a)


CheckpointManager._write = counted
CheckpointManager(os.path.join(tmp, "ckpt_ddp")).save(
    state.step, state, metrics={"epoch": 1})
CheckpointManager._write = write
out["writes"] = len(writes)
fresh = create_train_state(cfg_dp, TrainConfig(), device="cpu")
_, out["restored_step"] = CheckpointManager(
    os.path.join(tmp, "ckpt_single")).restore(fresh)
out["restored"] = named(fresh.model, lambda p: p.detach())
out["restored_mu"] = [fresh.optimizer.state[p]["mu"].clone()
                      for p in ddp.unwrap(fresh.model).parameters()]
del fresh

# (b) the val pass: losses, metrics, the summed PR-AUC bucket counts
ddp.unwrap(state.model).load_state_dict(spec["params"])
state.model.eval()
val = mine(spec["val"])
val_losses, metrics = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                                     n_wp)(state.model, val)
out["val_losses"] = {k: v.item() for k, v in val_losses.items()}
out["val_metrics"] = {k: v.item() for k, v in metrics.items()}
pred = make_predict_step(n_wp)(state.model, val)
true = true_waypoints_from_batch(val)
out["hist"] = ddp.sum_over_ranks(bucket_histogram(
    true.observed_occupancy, pred.observed_occupancy, group_dim=1))

# (c) the loss where one rank's flow field and the other's scene are empty
c = spec["c"]
logits = mine({"l": c["logits"]})["l"].requires_grad_()
terms = ogmflow_loss(WAYMO_TASK_CONFIG, LossConfig(),
                     true_waypoints_from_batch(mine(c["batch"])),
                     split_pred_waypoints(logits, n_wp),
                     reduce_sum=ddp.sum_over_ranks)
sum(terms.values()).backward()
out["c_terms"] = {k: v.item() for k, v in terms.items()}
out["c_grad"] = logits.grad

# every rank stops where the first runs out
out["common"] = list(ddp.common_steps(range(2 + rank)))
try:
    loop.train(spec["cfg"], train_cfg=TrainConfig(
        batch_size=5, save_dir=os.path.join(tmp, "never")), device="cpu",
        batches=lambda split, epoch: [])
    out["odd_batch"] = "trained"
except ValueError as e:
    out["odd_batch"] = str(e)

# (f) the loop, reading its shard of the records through stand-ins of the
# tf.data builders that shard and batch as they do
records = spec["loop"]
out["val_drop"] = []


def shard_batches(recs, batch_size, shard_index, shard_count, drop):
    part = {k: v[shard_index::shard_count] for k, v in recs.items()}
    n = len(part["ogm"])
    return [{k: v[i:i + batch_size] for k, v in part.items()}
            for i in range(0, n, batch_size)
            if not drop or i + batch_size <= n]


def train_dataset(pattern, batch_size, shuffle_buffer=0, shard_index=0,
                  shard_count=1, seed=None, repeat=False, compact=False):
    return shard_batches(records["train"][seed - TrainConfig().seed],
                         batch_size, shard_index, shard_count, True)


def eval_dataset(pattern, batch_size, shard_index=0, shard_count=1,
                 compact=False, drop_remainder=True):
    out["val_drop"].append(drop_remainder)
    return shard_batches(records["val"], batch_size, shard_index,
                         shard_count, drop_remainder)


pipeline.make_train_dataset = train_dataset
pipeline.make_eval_dataset = eval_dataset
pipeline.as_numpy = iter
trajnet._DROPOUT = 0.0
state = loop.train(spec["cfg"], train_cfg=TrainConfig(
    batch_size=spec["loop_batch"], epochs=2,
    save_dir=os.path.join(tmp, "loop")), device="cpu")
out["loop_step"] = state.step
out["loop_params"] = named(state.model, lambda p: p.detach())
for k in ("mu", "nu"):
    out["loop_" + k] = {n: state.optimizer.state[p][k].clone() for n, p in
                        ddp.unwrap(state.model).named_parameters()}

torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
ddp.destroy()
'''


class Ranks:
    """The rank processes; :meth:`results` waits for them."""

    def __init__(self, tmp):
        self.tmp = tmp
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                     for r in range(RANKS)]
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(r), str(RANKS), tmp], env=env,
            cwd=tmp, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]
        self._results = None

    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pass
            finally:
                self.stop()
            failed = [r for r, p in enumerate(self.procs) if p.returncode]
            if failed:
                tails = []
                for r in failed:
                    code = self.procs[r].returncode
                    with open(os.path.join(self.tmp, f"rank{r}.log")) as f:
                        tails.append(f"rank {r} (exit {code}):\n"
                                     f"{f.read()[-4000:]}")
                pytest.fail("\n".join(tails))
            self._results = [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                                        weights_only=False)
                             for r in range(RANKS)]
        return self._results

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the single process's step and checkpoint, and the rank
    processes, started."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    shapes = jax.eval_shape(JaxSTrajNet(cfg=JCFG).init,
                            jax.random.PRNGKey(0),
                            **jax_dummy_inputs(JCFG, batch=2))
    flax_params = fill_params(shapes["params"])
    params = flax_to_state_dict(flax_params)

    train = synthetic_batch(CFG_DP, 2 * RANKS, seed=1)
    val = synthetic_batch(CFG, 2 * RANKS, seed=2)
    c_batch = synthetic_batch(CFG, 2 * RANKS, seed=3)
    c_batch["gt_flow"][:2] = 0.0              # rank 0: no flow anywhere
    for k in ("gt_obs_ogm", "gt_occ_ogm"):
        c_batch[k][2:] = 0.0                  # rank 1: an empty scene
        c_batch[k][:, -1] = 0.0               # the last waypoint: all empty
    oh, ow = CFG.output_size
    c_logits = np.random.default_rng(3).standard_normal(
        (2 * RANKS, oh, ow, 4 * CFG.num_waypoints)).astype(np.float32)
    loop_batch = 8
    loop_data = {"train": [synthetic_batch(CFG, loop_batch, seed=10 + e)
                           for e in range(2)],
                 # one global batch and a ragged tail of 4
                 "val": synthetic_batch(CFG, loop_batch + 4, seed=99)}

    # the single process on the concatenated batch
    state = create_train_state(CFG_DP, TrainConfig(), device="cpu")
    state.model.load_state_dict(params)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           CFG.num_waypoints)
    batch = {k: torch.from_numpy(v) for k, v in train.items()}
    state, losses = step(state, batch, torch.Generator().manual_seed(0))
    single = {"losses": {k: v.item() for k, v in losses.items()},
              "grads": {n: p.grad.clone()
                        for n, p in state.model.named_parameters()},
              "params": {n: p.detach().clone()
                         for n, p in state.model.named_parameters()},
              "mu": [state.optimizer.state[p]["mu"].clone()
                     for p in state.model.parameters()]}
    CheckpointManager(os.path.join(tmp, "ckpt_single")).save(
        state.step, state, metrics={"epoch": 1})
    # the loop's step-0 checkpoint
    start = create_train_state(CFG, TrainConfig(), device="cpu")
    start.model.load_state_dict(params)
    CheckpointManager(os.path.join(tmp, "loop")).save(
        0, start, metrics={"val_loss": 0.0, "epoch": 0,
                           "steps_per_epoch": 0})

    torch.save({"cfg": CFG, "cfg_dp": CFG_DP, "params": params,
                "train": train, "val": val,
                "c": {"batch": c_batch, "logits": c_logits},
                "loop": loop_data, "loop_batch": loop_batch},
               os.path.join(tmp, "spec.pt"))
    ranks = Ranks(tmp)
    yield dict(tmp=tmp, ranks=ranks, single=single, params=params,
               flax_params=flax_params, val=val, c_batch=c_batch,
               c_logits=c_logits, loop=loop_data, loop_batch=loop_batch)
    ranks.stop()


def _without_key_bias(name, arr):
    """The key third of a Swin block's qkv bias has a zero gradient but for
    rounding (ROADMAP.md §3)."""
    if name.endswith("attn.qkv.bias"):
        c = arr.shape[0] // 3
        return np.concatenate([arr[:c], arr[2 * c:]])
    return arr


def _read_log(path):
    with open(os.path.join(path, "train_log.csv")) as f:
        return list(csv.reader(f))


def test_two_rank_loop_matches_the_jax_loop(setup, monkeypatch, tmp_path):
    """The port's loop on two ranks (4 records a rank) against the JAX
    package's ``train`` on the 8-device CPU mesh (global batch 8), from the
    same step-0 parameters, shuffle off, drop-path 0 and TrajNet's dropout
    off: two epochs of one step, then a val split of 12 records whose
    ragged tail of 4 both drop. ``train_log.csv`` and the parameters."""
    records, bs = setup["loop"], setup["loop_batch"]
    jcfg = JTrainConfig(batch_size=bs, epochs=2, save_dir=str(tmp_path))
    start = jstate_mod.TrainState.create(
        apply_fn=JaxSTrajNet(cfg=JCFG).apply,
        params=jax.tree_util.tree_map(jnp.asarray, setup["flax_params"]),
        tx=jstate_mod.make_optimizer(jcfg))
    monkeypatch.setattr(jloop, "create_train_state", lambda *a, **kw: start)
    val_drop = []

    def train_dataset(pattern, batch_size, shuffle_buffer, seed=None, **kw):
        assert batch_size == bs and kw["shard_count"] == 1
        return [records["train"][seed - JTrainConfig().seed]]

    def eval_dataset(pattern, batch_size, drop_remainder=True, **kw):
        val_drop.append(drop_remainder)
        val = records["val"]
        n = len(val["ogm"])
        return [{k: v[i:i + batch_size] for k, v in val.items()}
                for i in range(0, n, batch_size)
                if not drop_remainder or i + batch_size <= n]

    monkeypatch.setattr(jloop, "make_train_dataset", train_dataset)
    monkeypatch.setattr(jloop, "make_eval_dataset", eval_dataset)
    monkeypatch.setattr(jloop, "as_numpy", iter)
    forward = jstep._forward
    monkeypatch.setattr(jstep, "_forward",
                        lambda state, p, batch, training, rng=None:
                        forward(state, p, batch, False))
    jax_state = jloop.train(model_cfg=JCFG, train_cfg=jcfg)
    outs = setup["ranks"].results()

    assert val_drop == [True, True]
    for out in outs:
        assert out["val_drop"] == [True, True]
        assert out["loop_step"] == int(jax_state.step) == 2
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jax_state.params))
    assert set(outs[0]["loop_params"]) == set(want)
    for name, p in outs[0]["loop_params"].items():
        assert torch.equal(p, outs[1]["loop_params"][name]), name
        if name.startswith(ZERO_GRAD):
            continue
        np.testing.assert_allclose(
            _without_key_bias(name, p.numpy()),
            _without_key_bias(name, want[name].numpy()),
            rtol=1e-4, atol=1e-4, err_msg=name)

    jlog = _read_log(str(tmp_path))
    tlog = _read_log(os.path.join(setup["tmp"], "loop"))
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 3
    for jrow, trow in zip(jlog[1:], tlog[1:]):
        assert trow[0] == jrow[0]
        for col, a, b in zip(tlog[0][1:], trow[1:], jrow[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-4, err_msg=col)


def test_two_ranks_take_the_step_of_the_concatenated_batch(setup):
    """Losses (the ranks' shares sum to the single process's), every
    gradient (each rank holds the summed one), and the parameters after the
    Nadam update, with drop-path and dropout noise on."""
    outs, single = setup["ranks"].results(), setup["single"]
    assert all(out["wrapped"] == "DistributedDataParallel" for out in outs)
    for k, want in single["losses"].items():
        got = sum(out["losses"][k] for out in outs)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
    assert set(outs[0]["grads"]) == set(single["grads"])
    n_bytes = 0
    for name, want in single["grads"].items():
        g0, g1 = outs[0]["grads"][name], outs[1]["grads"][name]
        assert torch.equal(g0, g1), name
        np.testing.assert_allclose(
            g0.numpy(), want.numpy(), rtol=1e-5,
            atol=1e-5 * max(1.0, float(want.abs().max())), err_msg=name)
        n_bytes += 4 * want.numel()
        if name.startswith(ZERO_GRAD):
            continue
        np.testing.assert_allclose(
            _without_key_bias(name, outs[0]["params"][name].numpy()),
            _without_key_bias(name, single["params"][name].numpy()),
            rtol=1e-4, atol=1e-4, err_msg=name)
    # one all-reduce of every gradient, once
    assert all(out["reduced_bytes"] == n_bytes for out in outs)


def test_two_ranks_score_the_global_val_batch(setup):
    """The eval step on two ranks: every rank returns the global batch's
    metrics; PR-AUC from bucket counts equal to the single process's, the
    others and the loss within 1e-5."""
    outs = setup["ranks"].results()
    model = create_train_state(CFG_DP, TrainConfig(), device="cpu").model
    model.load_state_dict(setup["params"])
    model.eval()
    val = {k: torch.from_numpy(v) for k, v in setup["val"].items()}
    losses, metrics = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                                     CFG.num_waypoints)(model, val)
    pred = make_predict_step(CFG.num_waypoints)(model, val)
    hist = bucket_histogram(true_waypoints_from_batch(val).observed_occupancy,
                            pred.observed_occupancy, group_dim=1)
    for out in outs:
        assert torch.equal(out["hist"], hist)
        for k, want in metrics.items():
            rtol = 1e-6 if k.endswith("_auc") else 1e-5
            np.testing.assert_allclose(out["val_metrics"][k], want.item(),
                                       rtol=rtol, atol=1e-7, err_msg=k)
    for k, want in losses.items():
        np.testing.assert_allclose(sum(out["val_losses"][k] for out in outs),
                                   want.item(), rtol=1e-5, err_msg=k)


def test_loss_shares_where_a_rank_has_no_flow_or_an_empty_scene(setup):
    """Rank 0's flow field is empty, rank 1's scene is, the last waypoint is
    empty on both: the gates and counts of the global batch, not each
    rank's, divide the terms; the shares sum to the single process's loss,
    and the gradient of each rank's logits is the single process's."""
    outs = setup["ranks"].results()
    logits = torch.from_numpy(setup["c_logits"]).requires_grad_()
    true = true_waypoints_from_batch(
        {k: torch.from_numpy(v) for k, v in setup["c_batch"].items()})
    terms = ogmflow_loss(WAYMO_TASK_CONFIG, LossConfig(), true,
                         split_pred_waypoints(logits, CFG.num_waypoints))
    sum(terms.values()).backward()
    assert terms["flow"].item() > 0 and terms["flow_warp_xe"].item() > 0
    # taken alone, rank 1 would gate its flow terms off
    rank1 = true_waypoints_from_batch(
        {k: torch.from_numpy(v[2:]) for k, v in setup["c_batch"].items()})
    local = ogmflow_loss(WAYMO_TASK_CONFIG, LossConfig(), rank1,
                         split_pred_waypoints(logits.detach()[2:],
                                              CFG.num_waypoints))
    assert local["flow"].item() == 0 and outs[1]["c_terms"]["flow"] > 0
    for k, want in terms.items():
        np.testing.assert_allclose(sum(out["c_terms"][k] for out in outs),
                                   want.item(), rtol=1e-6, err_msg=k)
    got = torch.cat([out["c_grad"] for out in outs])
    np.testing.assert_allclose(got.numpy(), logits.grad.numpy(), rtol=1e-6,
                               atol=1e-6 * float(logits.grad.abs().max()))


def test_checkpoints_cross_between_ddp_and_one_process(setup):
    """Rank 0 alone writes the DDP checkpoint, without ``module.`` keys; it
    restores into a single-device state, and the single process's
    checkpoint restores into the DDP state, bit for bit."""
    outs, single = setup["ranks"].results(), setup["single"]
    assert [out["writes"] for out in outs] == [1, 0]
    ckpt = CheckpointManager(os.path.join(setup["tmp"], "ckpt_ddp"))
    assert ckpt.all_steps() == [1] and ckpt.metadata() == {"epoch": 1}
    assert not [n for n in os.listdir(ckpt.directory) if n.startswith(".tmp")]
    state = create_train_state(CFG_DP, TrainConfig(), device="cpu")
    _, step = ckpt.restore(state)
    assert step == state.step == 1
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), outs[0]["params"][name]), name
    for out in outs:
        assert out["restored_step"] == 1
        for name, p in out["restored"].items():
            assert torch.equal(p, single["params"][name]), name
        for a, b in zip(out["restored_mu"], single["mu"]):
            assert torch.equal(a, b)


def test_ranks_stop_together_and_the_batch_divides(setup):
    """:func:`ddp.common_steps` ends both ranks' epochs at the shorter
    shard (2 against 3 items); a global batch of 5 does not divide over 2
    ranks and raises before any step."""
    outs = setup["ranks"].results()
    assert [out["common"] for out in outs] == [[0, 1], [0, 1]]
    assert all("not divisible" in out["odd_batch"] for out in outs)


def test_record_shards_are_disjoint_and_make_up_the_split(tmp_path):
    """``tfrecord_batches`` of two shards on three records at the stored
    shapes: train shards {0, 2} and {1}; the val split at a local batch of
    2 drops each shard's ragged tail on two shards and keeps it on one."""
    tf = pytest.importorskip("tensorflow")
    from strajnet_tpu_torch.data.schema import SHAPES, encode_example
    (tmp_path / "train").mkdir()
    with tf.io.TFRecordWriter(str(tmp_path / "train" /
                                  "00000.tfrecords")) as w:
        for i in range(3):
            ex = {k: np.zeros(shape, np.float32)
                  for k, shape in SHAPES.items()}
            ex["actors"][0, 0, 0] = i + 1
            w.write(encode_example(ex))
    os.symlink(tmp_path / "train", tmp_path / "val")
    cfg = TrainConfig(file_dir=str(tmp_path), shuffle_buffer=4)

    def ids(source, split, epoch=0):
        return [[int(r) - 1 for r in b["actors"][:, 0, 0, 0]]
                for b in source(split, epoch)]

    shards = [ids(loop.tfrecord_batches(cfg, 1, r, 2), "train")
              for r in range(2)]
    flat = [sorted(sum(s, [])) for s in shards]
    assert flat == [[0, 2], [1]]
    assert [len(b) for b in ids(loop.tfrecord_batches(cfg, 2, 0, 2),
                                "val")] == [2]
    assert ids(loop.tfrecord_batches(cfg, 2, 1, 2), "val") == []
    assert [len(b) for b in ids(loop.tfrecord_batches(cfg, 2), "val")] == \
        [2, 1]


def test_nccl_needs_a_card_and_cuda_a_device():
    with pytest.raises(ValueError, match="nccl"):
        ddp.init_distributed("cpu", backend="nccl",
                             init_method="file:///nonexistent", rank=0,
                             world_size=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ddp.init_distributed("cuda")
    assert (ddp.rank(), ddp.world_size()) == (0, 1)


@pytest.mark.parametrize("flags", [{}, {"stp_grad": True}],
                         ids=["default", "stp_grad"])
def test_world_size_one_group_is_the_plain_step_bit_for_bit(flags,
                                                           tmp_path):
    """Under a process group of one rank the model is wrapped in DDP, and
    two steps' losses, gradients and parameters are those of the plain
    steps, bit for bit: no collective changes a number at world size 1.
    ``stp_grad`` leaves the encoder, FG-MSA and TrajNet without gradients;
    DDP looks for unused parameters there, or its second step would raise."""
    cfg = dataclasses.replace(CFG_DP, **flags)
    params = create_train_state(cfg, TrainConfig(), device="cpu"
                                ).model.state_dict()
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, seed=5).items()}

    def two_steps():
        state = create_train_state(cfg, TrainConfig(), device="cpu")
        ddp.unwrap(state.model).load_state_dict(params)
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               CFG.num_waypoints)
        losses = []
        for seed in range(2):
            state, out = step(state, batch,
                              torch.Generator().manual_seed(seed))
            losses.append(out)
        return (type(state.model).__name__, losses,
                list(ddp.unwrap(state.model).parameters()))

    plain = two_steps()
    ddp.init_distributed("cpu", init_method=f"file://{tmp_path}/store",
                         rank=0, world_size=1)
    try:
        wrapped = two_steps()
    finally:
        ddp.destroy()
    assert (plain[0], wrapped[0]) == ("STrajNet", "DistributedDataParallel")
    for a, b in zip(plain[1], wrapped[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    unused = 0
    for a, b in zip(plain[2], wrapped[2]):
        assert torch.equal(a, b)
        if a.grad is None:
            assert b.grad is None
            unused += 1
        else:
            assert torch.equal(a.grad, b.grad)
    assert (unused > 0) == bool(flags)


@pytest.mark.parametrize("res_connection", [False, True])
def test_basic_layer_decoder_matches_jax(res_connection):
    """``PatchUpsampling`` and ``BasicLayerDecoder`` (with and without the
    1x1-conv residual) at TINY widths (C = 32 -> 16, two heads, 4x4
    windows, 8² -> 16²) in f32, against their JAX modules."""
    rng = np.random.default_rng(7)
    dim, h = 32, 8
    x = rng.standard_normal((2, h, h, dim)).astype(np.float32)
    res = rng.standard_normal((2, 2 * h, 2 * h, dim // 2)).astype(np.float32)
    jres = jnp.asarray(res) if res_connection else None

    jup = jswin.PatchUpsampling(dim)
    up_params = fill_params(jax.eval_shape(
        jup.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    up = tswin.PatchUpsampling(dim)
    up.load_state_dict(flax_to_state_dict(up_params), strict=True)
    np.testing.assert_allclose(
        up(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jup.apply(up_params, jnp.asarray(x))), rtol=1e-4,
        atol=1e-4)

    jm = jswin.BasicLayerDecoder(dim=dim, input_resolution=(2 * h, 2 * h),
                                 depth=2, num_heads=2, window_size=4,
                                 drop_path=(0.0, 0.0),
                                 res_connection=res_connection)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.asarray(x), jres))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jres))
    tm = tswin.BasicLayerDecoder(dim, (h, h), 2, 2, 4,
                                 res_connection=res_connection)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    got = tm(torch.from_numpy(x),
             torch.from_numpy(res) if res_connection else None)
    assert got.shape == want.shape == (2, 2 * h, 2 * h, dim // 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
