"""Tensor parallelism of the port (``parallel/mesh.py``) on the CPU: four
``gloo`` ranks on a 2x2 ``('data', 'model')`` mesh at ULTRA_TINY
(2 heads in TrajNet's attention, so its head split runs) against the port's
single process on the global batch: one training step in each Swin mode
(``"block"``, ``"attn"``, the plain path; the kernels' plain versions stand
in on the CPU) with drop-path and dropout on, ``spatial_shard``, K5's
route on uneven rows, the replicated gradients' alignment over
``'model'``, checkpoints between the mesh, DDP and one process, gradient
clipping, and the 2x2 loop against the JAX loop at ``model_axis=2`` on the
8-device CPU mesh.

The ranks run one script (``_WORKER``, written to ``tmp_path``) that imports
only torch and the port; they meet through a ``FileStore``, each has a
timeout of its own, and they start once for the file and work while the
JAX loop runs here, as in ``tests/test_torch_ddp.py``.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import jax
import jax.numpy as jnp

from strajnet_tpu.config import TrainConfig as JTrainConfig
from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JTINY
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
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import make_train_step
from tests.test_torch_variants import fill_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
RANK_TIMEOUT_S = 240
HEADS = dict(att_heads=2, traj_heads=2)
CFG = dataclasses.replace(ULTRA_TINY_MODEL_CONFIG, **HEADS)
JCFG = dataclasses.replace(JTINY, **HEADS)
CFG_DP = dataclasses.replace(CFG, drop_path_rate=0.2)
MODES = {"block": "block", "attn": "attn", "plain": False}
# zero gradients but for rounding (ROADMAP.md §3)
ZERO_GRAD = ("fg_msa_layer.proj_k.", "fg_msa_layer.rpe_table")
# gradients below 100 times Nadam's epsilon (see the step test)
NADAM_LIVE = 1e-5
CLIP = 1.0

_WORKER = r'''
import os
import sys

import numpy as np
import torch

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)

from strajnet_tpu_torch.config import (WAYMO_TASK_CONFIG, LossConfig,
                                       TrainConfig)
from strajnet_tpu_torch.core.sampling import flow_warp_origin
from strajnet_tpu_torch.models import trajnet
from strajnet_tpu_torch.parallel import ddp
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.train import loop
from strajnet_tpu_torch.train.checkpoints import CheckpointManager
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import make_eval_step, make_train_step

ddp.init_distributed("cpu", init_method="file://" + os.path.join(
    tmp, "rendezvous"), rank=rank, world_size=world)
spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
CLIP = spec["clip"]
mesh = tp.create_mesh(2, "cpu")
out = {"coord": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def whole(model, what):
    """name -> what(p) gathered whole over 'model' (every rank calls it)."""
    got = {}
    for name, p in ddp.unwrap(model).named_parameters():
        t = what(p).detach()
        dim = tp.placement(p)
        got[name] = (tp.all_gather(t, dim, tp.MODEL) if dim is not None
                     else t).clone()
    return got


with tp.use_mesh(mesh):
    rows = tensors(tp.shard_batch(spec["train"], mesh))
    # (a) one training step in each Swin mode
    for mode, cfg in spec["modes"].items():
        state = create_train_state(cfg, TrainConfig(), device="cpu")
        model = ddp.unwrap(state.model)
        out.setdefault("placements", {n: tp.placement(p) for n, p in
                                      model.named_parameters()})
        out.setdefault("wrapped", type(state.model).__name__)
        model.load_state_dict(tp.local_state_dict(model, spec["params"]))
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
        state, losses = step(state, rows, torch.Generator().manual_seed(0))
        out[mode] = {"losses": {k: v.item() for k, v in losses.items()},
                     "grads": whole(state.model, lambda p: p.grad),
                     "params": whole(state.model, lambda p: p)}
        if mode == "block":
            CheckpointManager(os.path.join(tmp, "ckpt_mesh")).save(
                state.step, state, metrics={"epoch": 1})
            out["mesh_mu"] = [
                (tp.all_gather(state.optimizer.state[p]["mu"],
                               tp.placement(p), tp.MODEL)
                 if tp.placement(p) is not None
                 else state.optimizer.state[p]["mu"]).clone()
                for p in model.parameters()]

    # gradient clipping by the whole gradient's norm
    state = create_train_state(spec["modes"]["block"],
                               TrainConfig(grad_clip_norm=CLIP), device="cpu")
    model = ddp.unwrap(state.model)
    model.load_state_dict(tp.local_state_dict(model, spec["params"]))
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), 8)
    state, _ = step(state, rows, torch.Generator().manual_seed(0))
    out["clip"] = {"grads": whole(state.model, lambda p: p.grad),
                   "params": whole(state.model, lambda p: p)}

    # (b) spatial_shard: the same forward, the hinted activations split
    fwd = {}
    for sp in (False, True):
        cfg = spec["sp"][sp]
        model = ddp.unwrap(create_train_state(cfg, TrainConfig(),
                                              device="cpu").model)
        model.load_state_dict(tp.local_state_dict(model, spec["params"]))
        model.eval()
        with torch.inference_mode(), tp.record_hints() as hints:
            fwd[sp] = model(ogm=rows["ogm"], map_img=rows["map_image"],
                            obs=rows["actors"], occ=rows["occl_actors"],
                            mapt=rows["centerlines"], flow=rows["vec_flow"])
        out["hints" if sp else "no_hints"] = list(hints)
    out["sp_equal"] = torch.equal(fwd[False], fwd[True])

    # (c) K5 on this rank's rows; the eval step, which reaches K5 twice,
    # refuses uneven rows over 'data' before its forward
    n = 3 if out["coord"][0] == 0 else 2
    uneven = tensors({k: v[:n] for k, v in spec["train"].items()})
    try:
        make_eval_step(WAYMO_TASK_CONFIG, LossConfig(), 8)(model, uneven)
        out["k5_uneven"] = "ran"
    except ValueError as e:
        out["k5_uneven"] = str(e)
    occ, flow = spec["k5"]
    d = out["coord"][0]
    out["k5_even"] = flow_warp_origin(occ[2 * d:2 * d + 2],
                                      flow[2 * d:2 * d + 2])

    # (g) replicated gradients take model-rank 0's values; split ones stay
    for p in model.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    tp.align_replicated_grads(model)
    out["aligned"] = {n: (tp.placement(p), float(p.grad.min()),
                          float(p.grad.max()))
                      for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    # (d) the single process's checkpoint onto the mesh
    fresh = create_train_state(spec["modes"]["block"], TrainConfig(),
                               device="cpu")
    CheckpointManager(os.path.join(tmp, "ckpt_single")).restore(fresh)
    out["from_single"] = whole(fresh.model, lambda p: p)
    out["from_single_local"] = {n: p.detach().clone() for n, p in
                                ddp.unwrap(fresh.model).named_parameters()}
    del fresh

# (e) the mesh's checkpoint into DDP over the world (model_axis 1), and
# DDP's back onto a mesh
ddp_state = create_train_state(spec["modes"]["block"], TrainConfig(),
                               device="cpu")
out["ddp_wrapped"] = type(ddp_state.model).__name__
CheckpointManager(os.path.join(tmp, "ckpt_mesh")).restore(ddp_state)
out["ddp_from_mesh"] = {n: p.detach().clone() for n, p in
                        ddp.unwrap(ddp_state.model).named_parameters()}
out["ddp_from_mesh_mu"] = [ddp_state.optimizer.state[p]["mu"].clone()
                           for p in ddp.unwrap(ddp_state.model).parameters()]
with torch.no_grad():
    for p in ddp.unwrap(ddp_state.model).parameters():
        p.add_(0.5)
CheckpointManager(os.path.join(tmp, "ckpt_ddp")).save(
    ddp_state.step + 1, ddp_state)
with tp.use_mesh(mesh):
    back = create_train_state(spec["modes"]["block"], TrainConfig(),
                              device="cpu")
    CheckpointManager(os.path.join(tmp, "ckpt_ddp")).restore(back)
    out["mesh_from_ddp"] = whole(back.model, lambda p: p)
    del back

# (f) the 2x2 loop, from the step-0 checkpoint, on this data rank's records
trajnet._DROPOUT = 0.0
records = spec["loop"]


def batches(split, epoch):
    data = records["train"][epoch] if split == "train" else records["val"]
    n = spec["loop_batch"]
    return [tp.shard_batch({k: v[i:i + n] for k, v in data.items()}, mesh)
            for i in range(0, len(data["ogm"]) - n + 1, n)]


state = loop.train(spec["cfg"], train_cfg=TrainConfig(
    batch_size=spec["loop_batch"], epochs=2,
    save_dir=os.path.join(tmp, "loop")), model_axis=2, device="cpu",
    batches=batches)
out["loop_step"] = state.step

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


def _single_step(cfg, params, batch, train_cfg=TrainConfig()):
    state = create_train_state(cfg, train_cfg, device="cpu")
    state.model.load_state_dict(params)
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints)
    state, losses = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    return state, {"losses": {k: v.item() for k, v in losses.items()},
                   "grads": {n: p.grad.clone()
                             for n, p in state.model.named_parameters()},
                   "params": {n: p.detach().clone()
                              for n, p in state.model.named_parameters()}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the rank processes (started), and the single process's
    step in each mode and its checkpoint."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    shapes = jax.eval_shape(JaxSTrajNet(cfg=JCFG).init,
                            jax.random.PRNGKey(0),
                            **jax_dummy_inputs(JCFG, batch=2))
    flax_params = fill_params(shapes["params"])
    params = flax_to_state_dict(flax_params)
    modes = {m: dataclasses.replace(CFG_DP, use_pallas_attention=v)
             for m, v in MODES.items()}
    train = synthetic_batch(CFG_DP, 4, seed=1)
    rng = np.random.default_rng(4)
    k5 = (torch.from_numpy((rng.random((4, 16, 16, 1)) > 0.5).astype(
              np.float32)),
          torch.from_numpy((rng.random((4, 16, 16, 2)) * 6 - 3).astype(
              np.float32) + 0.25))
    loop_batch = 8
    loop_data = {"train": [synthetic_batch(CFG, loop_batch, seed=10 + e)
                           for e in range(2)],
                 "val": synthetic_batch(CFG, loop_batch, seed=99)}
    # the single process's checkpoint, and the loop's step-0 checkpoint
    single_state, _ = _single_step(modes["block"], params, train)
    CheckpointManager(os.path.join(tmp, "ckpt_single")).save(
        single_state.step, single_state, metrics={"epoch": 1})
    start = create_train_state(CFG, TrainConfig(), device="cpu")
    start.model.load_state_dict(params)
    CheckpointManager(os.path.join(tmp, "loop")).save(
        0, start, metrics={"val_loss": 0.0, "epoch": 0,
                           "steps_per_epoch": 0})
    torch.save({"cfg": CFG, "modes": modes, "params": params, "clip": CLIP,
                "train": train, "k5": k5,
                "sp": {sp: dataclasses.replace(CFG, spatial_shard=sp)
                       for sp in (False, True)},
                "loop": loop_data, "loop_batch": loop_batch},
               os.path.join(tmp, "spec.pt"))
    ranks = Ranks(tmp)
    yield dict(tmp=tmp, ranks=ranks, params=params, modes=modes,
               train=train, k5=k5, flax_params=flax_params,
               loop=loop_data, loop_batch=loop_batch,
               single_params={n: p.detach().clone() for n, p in
                              single_state.model.named_parameters()})
    ranks.stop()


# --- placements against JAX's rules ---------------------------------------


def _without_key_bias(name, arr):
    """The key third of a Swin block's qkv bias has a zero gradient but for
    rounding (ROADMAP.md §3)."""
    if name.endswith("attn.qkv.bias"):
        c = arr.shape[0] // 3
        return np.concatenate([arr[:c], arr[2 * c:]])
    return arr


@pytest.mark.parametrize("mode", list(MODES))
def test_four_ranks_take_the_step_of_one_process(setup, mode):
    """Four ranks on a 2x2 mesh, with drop-path and dropout on, against the
    single process on the global batch: the ranks' loss shares sum to its
    losses within 1e-6, every gradient (gathered whole) within 1e-5, the
    parameters after the Nadam update within 1e-5 but for the zero-gradient
    leaves; the peers along ``'model'`` hold the same, and DDP runs over
    the ``'data'`` group."""
    _, single = _single_step(setup["modes"][mode], setup["params"],
                             setup["train"])
    outs = setup["ranks"].results()
    assert [out["coord"] for out in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(out["wrapped"] == "DistributedDataParallel" for out in outs)
    for k, want in single["losses"].items():
        got = outs[0][mode]["losses"][k] + outs[2][mode]["losses"][k]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert set(outs[0][mode]["grads"]) == set(single["grads"])
    skipped = total = 0
    for name, want in single["grads"].items():
        g = outs[0][mode]["grads"][name]
        for out in outs[1:]:
            assert torch.equal(out[mode]["grads"][name], g), name
            assert torch.equal(out[mode]["params"][name],
                               outs[0][mode]["params"][name]), name
        np.testing.assert_allclose(
            g.numpy(), want.numpy(), rtol=1e-5,
            atol=1e-5 * max(1.0, float(want.abs().max())), err_msg=name)
        if name.startswith(ZERO_GRAD):
            continue
        # Nadam's first step is lr * g / (|g| + 1e-7): where |g| comes near
        # its epsilon the step turns on the rounding of g itself
        live = _without_key_bias(name, want.numpy()) != 0
        live &= np.abs(_without_key_bias(name, want.numpy())) >= NADAM_LIVE
        skipped += int((~live).sum())
        total += live.size
        np.testing.assert_allclose(
            _without_key_bias(name, outs[0][mode]["params"][name].numpy())[
                live],
            _without_key_bias(name, single["params"][name].numpy())[live],
            rtol=1e-5, atol=1e-5, err_msg=name)
    print(f"{mode}: {skipped} of {total} elements with |g| < {NADAM_LIVE}")
    assert skipped <= total // 100


def test_gradient_clipping_takes_the_norm_of_the_whole_gradient(setup):
    """With ``grad_clip_norm`` the four ranks clip by the norm of the whole
    gradient, the shards' squares summed over ``'model'``: the clipped
    gradients and the parameters after the update are the single
    process's."""
    _, single = _single_step(setup["modes"]["block"], setup["params"],
                             setup["train"], TrainConfig(grad_clip_norm=CLIP))
    outs = setup["ranks"].results()
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in single["grads"].values())))
    assert abs(norm - CLIP) < 1e-4          # the clip was active
    for name, want in single["grads"].items():
        np.testing.assert_allclose(
            outs[0]["clip"]["grads"][name].numpy(), want.numpy(), rtol=1e-5,
            atol=1e-5 * max(1e-3, float(want.abs().max())), err_msg=name)
        if name.startswith(ZERO_GRAD):
            continue
        live = np.abs(_without_key_bias(name, want.numpy())) >= NADAM_LIVE
        np.testing.assert_allclose(
            _without_key_bias(name, outs[0]["clip"]["params"][name].numpy())[
                live],
            _without_key_bias(name, single["params"][name].numpy())[live],
            rtol=1e-5, atol=1e-5, err_msg=name)


def test_the_mesh_splits_what_jax_splits(setup):
    """The ranks' placements are the rules' at a model axis of 2: the Swin
    matrices, TrajNet's 2-head attention and its FFN pair."""
    outs = setup["ranks"].results()
    model = STrajNet(CFG)
    for out in outs:
        for name, p in model.named_parameters():
            spec = tp.param_partition_spec(name, p.shape, 2)
            want = spec.dim if isinstance(spec, Shard) else None
            assert out["placements"][name] == want, name
    split = {n for n, d in outs[0]["placements"].items() if d is not None}
    t = "trajnet_attn.traj_net.cross_attention."
    assert {t + "mha.query_kernel", t + "FFN1.weight",
            t + "FFN2.weight"} <= split


def test_spatial_shard_keeps_the_forward_and_splits_the_activations(setup):
    """``spatial_shard=True`` on the mesh: the forward equals the one
    without bit for bit, and the hinted activations, encoder tokens and
    decoder volumes, are recorded with the split over ``'model'`` on their
    token or H axis that JAX's layout gives them (the activations stay
    whole: nothing computes on the split yet)."""
    outs = setup["ranks"].results()
    for out in outs:
        assert out["sp_equal"]
        assert out["no_hints"] == []
        hints = out["hints"]
        enc = [h for h in hints if h[0] == ("data", "model", None)]
        dec = [h for h in hints
               if h[0] == ("data", None, "model", None, None)]
        assert len(enc) == sum(CFG.depths) + 1   # the flow stage's block
        assert dec
        for axes, local, whole in hints:
            d = axes.index("model")
            assert local[d] * 2 == whole[d]
            assert local[:d] + local[d + 1:] == whole[:d] + whole[d + 1:]


def test_k5_runs_on_this_ranks_rows_and_raises_on_uneven_rows(setup):
    """The warp gather under the mesh: on even rows each data rank gets its
    rows of the single process's result; where the data ranks hold 3 and 2
    rows (5 rows do not divide the axis of 2) the eval step, which reaches
    K5, raises on every rank before its forward (one row check per step),
    where JAX would fall through to XLA."""
    from strajnet_tpu_torch.core.sampling import flow_warp_origin
    outs = setup["ranks"].results()
    occ, flow = setup["k5"]
    want = flow_warp_origin(occ, flow)
    for out in outs:
        assert "do not divide" in out["k5_uneven"]
        d = out["coord"][0]
        assert torch.equal(out["k5_even"], want[2 * d:2 * d + 2])


def test_replicated_gradients_take_model_rank_0s_values(setup):
    """``align_replicated_grads`` on the mesh: each rank's gradients filled
    with its rank + 1; afterwards every replicated parameter's gradient is
    that of model-rank 0 of the rank's data row (rank 0 or 2), and every
    split parameter's is the rank's own."""
    outs = setup["ranks"].results()
    for rank, out in enumerate(outs):
        leader = 2 * out["coord"][0] + 1
        for name, (dim, lo, hi) in out["aligned"].items():
            want = rank + 1 if dim is not None else leader
            assert lo == hi == want, (rank, name, dim, lo, hi)
    assert any(d is not None for d, _, _ in outs[0]["aligned"].values())


def test_checkpoints_cross_between_the_mesh_ddp_and_one_process(setup):
    """Bit for bit: the mesh's checkpoint holds whole tensors and restores
    into one process and into DDP over four ranks (``model_axis=1``); DDP's
    checkpoint and the single process's restore onto the mesh as each
    rank's shards."""
    outs = setup["ranks"].results()
    ckpt = CheckpointManager(os.path.join(setup["tmp"], "ckpt_mesh"))
    assert ckpt.all_steps() == [1]
    state = create_train_state(setup["modes"]["block"], TrainConfig(),
                               device="cpu")
    _, step = ckpt.restore(state)
    assert step == 1
    mesh_params = outs[0]["block"]["params"]
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), mesh_params[name]), name
    for a, b in zip([state.optimizer.state[p]["mu"]
                     for p in state.model.parameters()], outs[0]["mesh_mu"]):
        assert torch.equal(a, b)
    for out in outs:
        assert out["ddp_wrapped"] == "DistributedDataParallel"
        for name, p in out["ddp_from_mesh"].items():
            assert torch.equal(p, mesh_params[name]), name
        for a, b in zip(out["ddp_from_mesh_mu"], outs[0]["mesh_mu"]):
            assert torch.equal(a, b)
        for name, p in out["mesh_from_ddp"].items():
            assert torch.equal(p, mesh_params[name] + 0.5), name
        for name, p in out["from_single"].items():
            assert torch.equal(p, setup["single_params"][name]), name
        # each rank holds its own shard of the single process's tensors
        m = out["coord"][1]
        for name, p in out["from_single_local"].items():
            dim = out["placements"][name]
            want = setup["single_params"][name]
            if dim is not None:
                want = want.chunk(2, dim)[m]
            assert torch.equal(p, want), name


def _read_log(path):
    with open(os.path.join(path, "train_log.csv")) as f:
        return list(csv.reader(f))


def test_the_2x2_loop_matches_the_jax_loop_at_model_axis_2(setup,
                                                          monkeypatch,
                                                          tmp_path):
    """The port's loop on the 2x2 mesh (resumed from a whole step-0
    checkpoint) against the JAX package's ``train`` with ``model_axis=2`` on
    the 8-device CPU mesh, from the same parameters, dropout and drop-path
    off on both sides: two epochs of one step and a val batch; the epoch
    losses and val metrics of ``train_log.csv`` within 1e-4."""
    records, bs = setup["loop"], setup["loop_batch"]
    jcfg = JTrainConfig(batch_size=bs, epochs=2, save_dir=str(tmp_path))
    start = jstate_mod.TrainState.create(
        apply_fn=JaxSTrajNet(cfg=JCFG).apply,
        params=jax.tree_util.tree_map(jnp.asarray, setup["flax_params"]),
        tx=jstate_mod.make_optimizer(jcfg))
    monkeypatch.setattr(jloop, "create_train_state", lambda *a, **kw: start)

    def train_dataset(pattern, batch_size, shuffle_buffer, seed=None, **kw):
        return [records["train"][seed - JTrainConfig().seed]]

    def eval_dataset(pattern, batch_size, drop_remainder=True, **kw):
        return [records["val"]]

    monkeypatch.setattr(jloop, "make_train_dataset", train_dataset)
    monkeypatch.setattr(jloop, "make_eval_dataset", eval_dataset)
    monkeypatch.setattr(jloop, "as_numpy", iter)
    forward = jstep._forward
    monkeypatch.setattr(jstep, "_forward",
                        lambda state, p, batch, training, rng=None:
                        forward(state, p, batch, False))
    jax_state = jloop.train(model_cfg=JCFG, train_cfg=jcfg, model_axis=2)
    outs = setup["ranks"].results()
    assert all(out["loop_step"] == int(jax_state.step) == 2 for out in outs)
    jlog = _read_log(str(tmp_path))
    tlog = _read_log(os.path.join(setup["tmp"], "loop"))
    assert tlog[0] == jlog[0] and len(tlog) == len(jlog) == 3
    for jrow, trow in zip(jlog[1:], tlog[1:]):
        assert trow[0] == jrow[0]
        for col, a, b in zip(tlog[0][1:], trow[1:], jrow[1:]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-4, err_msg=col)
