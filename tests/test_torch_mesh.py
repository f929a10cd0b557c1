"""Tensor parallelism of the port (``parallel/mesh.py``) on the CPU, without
rank processes of its own: each parameter's placement against JAX's
``param_partition_spec`` on the Flax path (the flagship and its map
variant, model axes 2 and 4), JAX's mesh tests (``tests/test_mesh.py``) in
the port's terms, the training CLI on a 2 x 2 mesh under ``torchrun``, and
``dryrun_multichip`` on the CPU. ``tests/test_torch_mesh_ranks.py`` holds
four ranks against one process and against the JAX loop.
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax

from strajnet_tpu.config import STRAJNET_CONFIG as JFLAG
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.models.strajnet import dummy_inputs as jax_dummy_inputs
from strajnet_tpu.parallel import mesh as jmesh
from strajnet_tpu_torch.config import (PORT_ONLY_MODEL_FIELDS, STRAJNET_CONFIG,
                                       ULTRA_TINY_MODEL_CONFIG, ModelConfig)
from strajnet_tpu_torch.interop.from_flax import convert_leaf
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.tools.graft_entry import (dryrun_multichip,
                                                  dryrun_steps)
from strajnet_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
RANK_TIMEOUT_S = 240
CFG = dataclasses.replace(ULTRA_TINY_MODEL_CONFIG, att_heads=2, traj_heads=2)


class _JaxMesh:
    """What ``param_partition_spec`` reads of a mesh: its axis sizes."""

    def __init__(self, model):
        self.shape = {"data": 1, "model": model}


def _path(kp):
    return "/".join(str(k.key) for k in kp)


def _torch_spec(flax_path, spec, ndim):
    """JAX's spec of one (unstacked) Flax leaf in the torch layout that
    ``from_flax`` gives it: Dense kernels transpose, Conv kernels go
    HWIO -> OIHW, the rest keep their layout."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    name = flax_path[-1]
    if name == "kernel" and ndim == 2:
        spec = (spec[1], spec[0])
    elif name == "kernel" and ndim == 4:
        spec = (spec[3], spec[2], spec[0], spec[1])
    return spec


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("variant", ["flagship", "map"])
def test_every_placement_equals_jax_param_partition_spec(variant,
                                                         model_size):
    """For every parameter of ``STrajNet(STRAJNET_CONFIG)`` and of its map
    variant (``actor_only=False``), the port's placement equals JAX's
    ``param_partition_spec`` on the Flax path, mapped through
    ``from_flax``'s layout, on a model axis of 2 and of 4."""
    flags = {} if variant == "flagship" else {"actor_only": False}
    jcfg = dataclasses.replace(JFLAG, **flags)
    shapes = jax.eval_shape(JaxSTrajNet(cfg=jcfg).init,
                            jax.random.PRNGKey(0),
                            **jax_dummy_inputs(jcfg, batch=1))["params"]
    want = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = tuple(str(k.key) for k in kp)
        spec = jmesh.param_partition_spec(_path(kp), leaf.shape,
                                          _JaxMesh(model_size))
        stacked = [i for i, p in enumerate(path[:-1])
                   if p in ("cross_attn_obs", "map_cross_attn")]
        if stacked:
            i = stacked[0]
            inner = tuple(spec)[1:] if len(tuple(spec)) else ()
            for t in range(leaf.shape[0]):
                sub = path[:i + 1] + (str(t),) + path[i + 1:]
                key, arr = convert_leaf(sub, np.zeros(leaf.shape[1:], np.int8))
                want[key] = _torch_spec(sub, inner, arr.ndim)
        else:
            key, arr = convert_leaf(path, np.zeros(leaf.shape, np.int8))
            want[key] = _torch_spec(path, spec, arr.ndim)
    model = STrajNet(dataclasses.replace(STRAJNET_CONFIG, **flags))
    got = {n: tp.param_partition_spec(n, p.shape, model_size)
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    sharded = 0
    for name, spec in want.items():
        expect = (Shard(spec.index("model")) if "model" in spec
                  else Replicate())
        assert got[name] == expect, (name, spec, got[name])
        sharded += isinstance(expect, Shard)
    # the eight Swin blocks' four matrices, at least
    assert sharded >= 32


def test_param_rules_shard_attention_and_mlp():
    """``tests/test_mesh.py``'s rules on the port's keys and layouts."""
    key = "encoder.layers0.blocks0."
    assert tp.param_partition_spec(key + "attn.qkv.weight", (288, 96),
                                   2) == Shard(0)
    assert tp.param_partition_spec(key + "attn.proj.weight", (96, 96),
                                   2) == Shard(1)
    assert tp.param_partition_spec(key + "mlp.fc1.weight", (384, 96),
                                   2) == Shard(0)
    assert tp.param_partition_spec(key + "mlp.fc2.weight", (96, 384),
                                   2) == Shard(1)
    assert tp.param_partition_spec(key + "attn.qkv.bias", (288,),
                                   2) == Replicate()
    assert tp.param_partition_spec(key + "norm1.weight", (96,),
                                   2) == Replicate()


def test_divisibility_guard_falls_back_to_replication():
    """A 3-head per-waypoint kernel stays whole on a model axis of 2, a
    6-head one splits its heads; the stacked blocks' FFNs stay whole (JAX's
    rank check skips them) while TrajNet's own split."""
    t = "trajnet_attn."
    assert tp.param_partition_spec(
        t + "cross_attn_obs.0.mha.query_kernel", (3, 384, 42),
        2) == Replicate()
    assert tp.param_partition_spec(
        t + "cross_attn_obs.0.mha.query_kernel", (4, 384, 32),
        2) == Shard(0)
    assert tp.param_partition_spec(
        t + "traj_net.cross_attention.mha.query_kernel", (6, 384, 64),
        2) == Shard(0)
    assert tp.param_partition_spec(
        t + "traj_net.cross_attention.mha.query_kernel", (6, 384, 64),
        4) == Replicate()
    assert tp.param_partition_spec(
        t + "map_cross_attn.0.mha.query_kernel", (4, 384, 32),
        2) == Replicate()
    assert tp.param_partition_spec(
        t + "cross_attn_obs.0.FFN1.weight", (512, 128), 2) == Replicate()
    assert tp.param_partition_spec(
        t + "traj_net.cross_attention.FFN1.weight", (1536, 384),
        2) == Shard(0)


class _Mesh:
    """A stand-in of a 2x2 DeviceMesh at one coordinate."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self.coord = {"data": data, "model": model}

    def size(self, dim=None):
        return 4 if dim is None else 2

    def get_local_rank(self, axis):
        return self.coord[axis]


def test_shard_batch_places_rows_on_the_data_axis():
    """Each rank gets the rows of its ``'data'`` coordinate, the same for
    both peers along ``'model'``; a batch the axis does not divide
    raises."""
    batch = {"x": np.arange(8 * 4).reshape(8, 4), "y": np.zeros((8, 2, 2))}
    for data in range(2):
        for model in range(2):
            got = tp.shard_batch(batch, _Mesh(data, model))
            np.testing.assert_array_equal(got["x"],
                                          batch["x"][4 * data:4 * data + 4])
            assert got["y"].shape == (4, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tp.shard_batch({"x": np.zeros((5, 1))}, _Mesh(0, 0))


def test_shard_params_cuts_each_rank_its_shard():
    """``shard_params`` cuts qkv's rows and proj's columns to this rank's
    half and marks them; biases stay whole."""
    model = STrajNet(dataclasses.replace(STRAJNET_CONFIG, depths=(1, 1, 1)))
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    tp.shard_params(model, _Mesh(1, 1))
    params = dict(model.named_parameters())
    key = "encoder.layers0.blocks0.attn."
    assert tp.placement(params[key + "qkv.weight"]) == 0
    assert torch.equal(params[key + "qkv.weight"],
                       whole[key + "qkv.weight"][144:])
    assert tp.placement(params[key + "proj.weight"]) == 1
    assert torch.equal(params[key + "proj.weight"],
                       whole[key + "proj.weight"][:, 48:])
    assert tp.placement(params[key + "qkv.bias"]) is None
    assert params[key + "qkv.bias"].shape == (288,)


def test_a_split_parameter_outside_its_mesh_raises():
    """A model with shards used without its mesh raises, instead of
    computing with half a weight."""
    model = STrajNet(CFG)
    tp.shard_params(model, _Mesh(0, 1))
    with pytest.raises(RuntimeError, match="outside its mesh"):
        tp.whole(model.encoder.layers0.blocks0.attn.qkv.weight)


def test_create_mesh_needs_a_divisible_world():
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        tp.create_mesh(2, "cpu")


# --- four ranks against one process ----------------------------------------


def _read_log(path):
    with open(os.path.join(path, "train_log.csv")) as f:
        return list(csv.reader(f))


_CLI = r'''
import dataclasses
import json
import os
import sys

from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.train import loop

cfg = dataclasses.replace(loop.STRAJNET_CONFIG, **{
    k: tuple(v) if isinstance(v, list) else v
    for k, v in json.loads(sys.argv[1]).items()})
loop.STRAJNET_CONFIG = cfg
feeds = []


def tfrecord_batches(train_cfg, local_batch, shard_index=0, shard_count=1):
    feeds.append([local_batch, shard_index, shard_count])

    def batches(split, epoch):
        b = synthetic_batch(cfg, local_batch * shard_count,
                            seed=epoch + 10 * (split == "val"))
        lo = shard_index * local_batch
        return [{k: v[lo:lo + local_batch] for k, v in b.items()}]

    return batches


loop.tfrecord_batches = tfrecord_batches
loop.main(sys.argv[2:])
with open(os.path.join(sys.argv[-1], f"feed{os.environ['RANK']}.json"),
          "w") as f:
    json.dump(feeds, f)
'''


def test_the_cli_trains_on_a_2x2_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 4 -m strajnet_tpu_torch.train.loop
    --device cpu --model_axis 2`` (the CLI's model swapped for the test's
    tiny one and its records for synthetic batches): two epochs, rank 0's
    log and checkpoints, each rank reading record shard ``data rank`` of
    2."""
    script = tmp_path / "cli.py"
    script.write_text(_CLI)
    save = tmp_path / "ckpt"
    flags = {f.name: getattr(CFG, f.name)
             for f in dataclasses.fields(CFG)}
    flags = {k: list(v) if isinstance(v, tuple) else v
             for k, v in flags.items()}
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), str(script),
         json.dumps(flags), "--device", "cpu",
         "--model_axis", "2", "--batch_size", "4", "--epochs", "2",
         "--save_dir", str(save)], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 2}" in proc.stdout
    assert CheckpointManager(str(save)).all_steps() == [1, 2]
    assert len(_read_log(str(save))) == 3
    feeds = [json.loads((save / f"feed{r}.json").read_text())
             for r in range(RANKS)]
    assert [f[0][1:] for f in feeds] == [[0, 2], [0, 2], [1, 2], [1, 2]]
    assert all(f[0][0] == 2 for f in feeds)


def test_dryrun_steps_are_jaxs_on_the_card_and_on_the_cpu():
    """``dryrun_steps`` needs no card: on the card and on the CPU it gives
    JAX's three configurations (``__graft_entry__.py::dryrun_multichip``),
    the kernels-on step ULTRA_TINY with ``"block"`` in f32. JAX reads
    ``use_pallas_attention=None`` as the plain block and the port as
    ``"block"``, so the card's plain steps ask for False; the CPU's are
    unchanged (the plain versions run there in any mode)."""
    from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JTINY

    def fields(cfg, **change):
        return dataclasses.asdict(dataclasses.replace(cfg, **change))

    jax_steps = [
        ("ok", fields(JTINY), 2),
        ("kernels-on ok", fields(JTINY, use_pallas_attention="block"), 2),
        ("flagship+sp ok", fields(JFLAG, dtype="float32", depths=(1, 1, 1),
                                  spatial_shard=True), 2)]
    for device, plain in (("cuda", False), ("cpu", None)):
        steps = dryrun_steps(4, True, device)
        assert [(label, batch) for label, _, batch in steps] == [
            (label, batch) for label, _, batch in jax_steps]
        for (label, cfg, _), (_, want, _) in zip(steps, jax_steps):
            got = dataclasses.asdict(cfg)
            # the port's own fields at their defaults (Swin-v1 blocks)
            for k in PORT_ONLY_MODEL_FIELDS:
                assert got.pop(k) == getattr(ModelConfig, k), (device, k)
            if label != "kernels-on ok":
                assert got["use_pallas_attention"] is plain, (device, label)
                got["use_pallas_attention"] = want["use_pallas_attention"]
            assert got == want, (device, label)
        kernels_on = steps[1][1]
        assert kernels_on.dtype == "float32"
        assert kernels_on.use_pallas_attention == "block"
        assert kernels_on.embed_dim == ULTRA_TINY_MODEL_CONFIG.embed_dim
    assert [label for label, _, _ in dryrun_steps(4, False, "cpu")] == [
        "ok", "kernels-on ok"]


def test_dryrun_multichip_on_the_cpu(capsys):
    """``dryrun_multichip(4, flagship=False, device="cpu")``: four ranks on
    a 2x2 mesh print JAX's two lines with finite losses."""
    lines = dryrun_multichip(4, flagship=False, device="cpu",
                             timeout_s=RANK_TIMEOUT_S)
    assert [ln.split(":")[0] for ln in lines] == [
        "dryrun_multichip ok", "dryrun_multichip kernels-on ok"]
    for ln in lines:
        assert "mesh=(2x2)" in ln
        assert np.isfinite(float(ln.split("loss=")[1]))
    assert capsys.readouterr().out.splitlines() == lines
