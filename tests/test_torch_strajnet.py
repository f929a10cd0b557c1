"""The whole inference slice of the PyTorch port against JAX, on the CPU.

At ``TINY_MODEL_CONFIG``, batch 2: the full forward (f32 allclose, bf16 by
cosine), the predict step -> quantize -> submission chain, the parameter
bridge and the Orbax converter, the seeded init, the config knobs, and that
the port imports neither JAX nor Flax.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import TINY_MODEL_CONFIG, TrainConfig
from strajnet_tpu.data.synthetic import synthetic_batch
from strajnet_tpu.infer import submission as jsub
from strajnet_tpu.infer.proto import iter_fields
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.objective.loss import WaypointGrids as JGrids
from strajnet_tpu.train.checkpoints import CheckpointManager
from strajnet_tpu.train.state import create_train_state
from strajnet_tpu.train.step import make_predict_step as jax_predict_step
from strajnet_tpu_torch.infer.runner import run_shard
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.strajnet import (STrajNet, dummy_inputs,
                                                init_params,
                                                resolve_kernel_knobs)
from strajnet_tpu_torch.ops.swin_block import swin_block
from strajnet_tpu_torch.train.step import make_predict_step

torch.set_num_threads(2)
CFG = TINY_MODEL_CONFIG
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")


@pytest.fixture(scope="module")
def case():
    state = create_train_state(CFG, TrainConfig(), jit_init=True)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    batch = synthetic_batch(CFG, 2, seed=3)
    return state, params, batch


def _jax_forward(cfg, params, batch):
    model = JaxSTrajNet(cfg=cfg)
    out = jax.jit(model.apply)(
        {"params": params}, ogm=batch["ogm"], map_img=batch["map_image"],
        obs=batch["actors"], occ=batch["occl_actors"],
        mapt=batch["centerlines"], flow=batch["vec_flow"])
    return np.asarray(out)


def _torch_model(cfg, params):
    model = STrajNet(cfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _torch_forward(model, batch):
    t = {k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}
    with torch.no_grad():
        return model(ogm=t["ogm"], map_img=t["map_image"], obs=t["actors"],
                     occ=t["occl_actors"], mapt=t["centerlines"],
                     flow=t["vec_flow"]).numpy()


def test_forward_f32_matches_jax(case):
    _, params, batch = case
    ref = _jax_forward(CFG, params, batch)
    ours = _torch_forward(_torch_model(CFG, params), batch)
    oh, ow = CFG.output_size
    assert ours.shape == ref.shape == (2, oh, ow, 4 * CFG.num_waypoints)
    # f32 both sides; summation order differs across ~60 layers
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches_jax_by_cosine(case):
    _, params, batch = case
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    ref = _jax_forward(cfg, params, batch).astype(np.float64).ravel()
    ours = _torch_forward(_torch_model(cfg, params), batch)
    ours = ours.astype(np.float64).ravel()
    assert np.isfinite(ours).all()
    cos = ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref))
    # bf16 rounds at different points in XLA and ATen; compare by cosine
    assert 1.0 - cos <= 1e-3, 1.0 - cos


def test_predict_and_submission_chain_matches_jax(case, tmp_path):
    state, params, batch = case
    ids = [f"scenario-{i}" for i in range(2)]
    jgrids = jax_predict_step(CFG.num_waypoints)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrids = JGrids(*(np.asarray(a) for a in jgrids))
    jsubmission = jsub.ChallengeSubmission()
    for i, sc in enumerate(ids):
        jsubmission.scenario_predictions.append(jsub.ScenarioPrediction(
            scenario_id=sc, waypoints=jsub.quantize_waypoints(
                JGrids(*(a[i:i + 1] for a in jgrids)))))
    jpath = jsub.save_submission(jsubmission, str(tmp_path / "jax"),
                                 "00007new.tfrecords")

    model = _torch_model(CFG, params)
    predict = make_predict_step(CFG.num_waypoints)
    grids = predict(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for ours, ref in zip(grids, jgrids):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)

    tbatch = {k: batch[k] for k in MODEL_KEYS}
    tbatch["scenario/id"] = np.array(ids)
    count = run_shard(model, predict, "00007new.tfrecords", set(ids),
                      str(tmp_path / "torch"), batch_size=2,
                      batches=[tbatch])
    assert count == 2
    path = tmp_path / "torch" / os.path.basename(jpath)

    def parse(p):
        out = {}
        for fn, _, sc in iter_fields(open(p, "rb").read()):
            if fn != jsub.SUBMISSION_SCENARIO_PREDICTIONS:
                continue
            fields = list(iter_fields(sc))
            sc_id = next(v for f, _, v in fields
                         if f == jsub.SCENARIO_ID).decode()
            wps = [dict((f, zlib.decompress(v)) for f, _, v in
                        iter_fields(w))
                   for f, _, w in fields if f == jsub.SCENARIO_WAYPOINTS]
            out[sc_id] = wps
        return out

    ours, ref = parse(path), parse(jpath)
    assert sorted(ours) == sorted(ref) == ids
    for sc in ids:
        assert len(ours[sc]) == len(ref[sc]) == CFG.num_waypoints
        for wo, wr in zip(ours[sc], ref[sc]):
            for field, dtype in ((jsub.WAYPOINT_OBSERVED, np.uint8),
                                 (jsub.WAYPOINT_OCCLUDED, np.uint8),
                                 (jsub.WAYPOINT_FLOW, np.int8)):
                a = np.frombuffer(wo[field], dtype).astype(np.int32)
                b = np.frombuffer(wr[field], dtype).astype(np.int32)
                # equal grids up to a rounding tie flipping one step
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= 1


def _count_leaves(tree, stacked=False):
    n = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            n += _count_leaves(v, stacked or k == "cross_attn_obs")
        else:
            n += v.shape[0] if stacked else 1
    return n


def test_state_dict_uses_every_flax_leaf_once(case):
    _, params, _ = case
    sd = flax_to_state_dict(params)
    model = STrajNet(CFG)
    assert len(sd) == _count_leaves(params) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # spot checks of each layout rule
    p = params
    enc = p["encoder"]["layers0"]["blocks0"]
    np.testing.assert_array_equal(
        sd["encoder.layers0.blocks0.attn.qkv.weight"].numpy(),
        enc["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["encoder.layers0.blocks0.norm1.weight"].numpy(),
        enc["norm1"]["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(
        sd["fg_msa_layer.conv_offset_0.weight"].numpy(),
        p["fg_msa_layer"]["conv_offset_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["trajnet_attn.cross_attn_obs.5.FFN1.weight"].numpy(),
        p["trajnet_attn"]["cross_attn_obs"]["FFN1"]["kernel"][5].T)
    np.testing.assert_array_equal(
        sd["decoder.resconv_3.kernel"].numpy(),
        p["decoder"]["resconv_3"]["kernel"])


def test_flax_to_torch_tool_converts_a_checkpoint(case, tmp_path):
    state, params, _ = case
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    mngr.save(3, state)
    mngr.close()
    spec = importlib.util.spec_from_file_location(
        "flax_to_torch", os.path.join(REPO, "tools", "flax_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "weights.pt")
    assert tool.convert(str(tmp_path / "ckpt"), out) == 3
    loaded = torch.load(out, weights_only=True)
    expect = flax_to_state_dict(params)
    assert sorted(loaded) == sorted(expect)
    for k in expect:
        assert torch.equal(loaded[k], expect[k]), k
    STrajNet(CFG).load_state_dict(loaded, strict=True)


def test_init_params_follow_flax_initializers():
    sd = init_params(CFG, torch.Generator().manual_seed(0))
    again = init_params(CFG, torch.Generator().manual_seed(0))
    other = init_params(CFG, torch.Generator().manual_seed(1))
    model = STrajNet(CFG)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["decoder.outconv.weight"],
                           other["decoder.outconv.weight"])
    for k, v in sd.items():
        if k.endswith("relative_position_bias_table") or k.endswith(".bias"):
            assert not v.any(), k
    for k in ("encoder.all_patch_norm.weight",
              "trajnet_attn.traj_net.obs_norm.weight"):
        assert torch.equal(sd[k], torch.ones_like(sd[k]))
    rpe = sd["fg_msa_layer.rpe_table"]
    assert rpe.abs().max() <= 0.02 and 0.005 < rpe.std() < 0.012
    # glorot-uniform limits with Flax's fans
    w = sd["fg_msa_layer.conv_offset_0.weight"]        # grouped 3x3 conv
    fan_in, fan_out = w.shape[1] * 9, w.shape[0] * 9
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    q = sd["trajnet_attn.traj_net.cross_attention.mha.query_kernel"]
    limit = (6.0 / (q.shape[0] * (q.shape[1] + q.shape[2]))) ** 0.5
    assert q.abs().max() <= limit and q.abs().max() > 0.9 * limit
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model.eval()(**dummy_inputs(CFG, batch=1))
    oh, ow = CFG.output_size
    assert out.shape == (1, oh, ow, 4 * CFG.num_waypoints)
    assert torch.isfinite(out).all()


def test_kernel_knobs():
    for mode, expect in ((None, "block"), (True, "block"),
                         ("block", "block"), ("block_fwd", "block_fwd"),
                         ("attn", "attn"), (False, False)):
        cfg = dataclasses.replace(CFG, use_pallas_attention=mode,
                                  pallas_windows_per_program=2,
                                  pallas_samples_per_program=8)
        assert resolve_kernel_knobs(cfg) == (expect, "xla")
        assert (resolve_kernel_knobs(cfg)[0] is False) == (expect is False)
    for tail, expect in ((None, "xla"), (False, "xla"), ("xla", "xla"),
                         ("phase", "phase"), (True, "kernel"),
                         ("kernel", "kernel"), ("infer", "infer")):
        cfg = dataclasses.replace(CFG, use_pallas_decoder_tail=tail)
        assert resolve_kernel_knobs(cfg) == ("block", expect)
    for kw in (dict(use_pallas_attention="strip"),
               dict(use_pallas_decoder_tail="fused")):
        with pytest.raises(ValueError):
            resolve_kernel_knobs(dataclasses.replace(CFG, **kw))
    with pytest.raises(NotImplementedError):
        STrajNet(dataclasses.replace(CFG, fg_msa=False))


def test_cpu_forward_with_kernel_mode_takes_plain_path(case):
    """use_pallas_attention=None on CPU tensors: the wrapper's plain path,
    the same output as False, and no kernel launch."""
    _, params, batch = case
    auto = _torch_model(dataclasses.replace(CFG, use_pallas_attention=None),
                        params)
    before = swin_block.launches
    out = _torch_forward(auto, batch)
    assert swin_block.launches == before
    plain = _torch_model(dataclasses.replace(CFG, use_pallas_attention=False),
                         params)
    np.testing.assert_array_equal(out, _torch_forward(plain, batch))


def _output_and_grads(model, batch, generator=None):
    """The model's output and the gradients of ``sum(out ** 2)`` with
    respect to every parameter."""
    t = {k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}
    out = model(ogm=t["ogm"], map_img=t["map_image"], obs=t["actors"],
                occ=t["occl_actors"], mapt=t["centerlines"],
                flow=t["vec_flow"], generator=generator)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad((out.float() ** 2).sum(), params,
                                allow_unused=True)
    return out.detach(), dict(zip([n for n, _ in model.named_parameters()],
                                  grads))


def _counting(monkeypatch, name):
    """Replaces ``models.swin.<name>`` with a wrapper that counts its calls."""
    from strajnet_tpu_torch.models import swin

    calls = [0]
    fn = getattr(swin, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(swin, name, counted)
    return calls


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("mode,inner", [("attn", "window_attention"),
                                        (False, "swin_block_reference")])
def test_remat_encoder_changes_nothing_but_recomputes(case, monkeypatch, mode,
                                                      inner, training):
    """``remat_encoder=True`` gives the same output and every parameter the
    same gradient as ``False``, in the ``"attn"`` and plain modes, f32; and
    each Swin block's forward runs twice (once more in the backward). In
    training mode drop-path is on (rate 0.2) and both runs take their noise
    from one seed: the multipliers are drawn outside the recomputed part, so
    the recomputation sees the same ones and the generator advances alike."""
    _, params, batch = case
    cfg = dataclasses.replace(CFG, use_pallas_attention=mode,
                              drop_path_rate=0.2 if training else 0.0)
    calls = _counting(monkeypatch, inner)
    results = []
    for remat in (False, True):
        model = _torch_model(dataclasses.replace(cfg, remat_encoder=remat),
                             params).train(training)
        gen = torch.Generator().manual_seed(5) if training else None
        before = calls[0]
        results.append(_output_and_grads(model, batch, gen) + (
            calls[0] - before,))
    (out, grads, n), (rout, rgrads, rn) = results
    blocks = sum(CFG.depths) + CFG.depths[0]   # three stages and the flow
    assert (n, rn) == (blocks, 2 * blocks)
    np.testing.assert_allclose(rout.numpy(), out.numpy(), rtol=0, atol=1e-6)
    assert rgrads.keys() == grads.keys()
    for name, g in grads.items():
        if g is None:
            assert rgrads[name] is None, name
            continue
        np.testing.assert_allclose(rgrads[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_remat_encoder_matches_jax_remat(case):
    """The port with ``remat_encoder=True`` against the JAX package with
    ``remat_encoder=True`` (``nn.remat`` around each Swin block), f32, the
    random parts off: the output, and the gradients of ``sum(out ** 2)`` for
    every parameter relative to the leaf's largest entry (the init's zero
    biases make some of them large; see the zero-bias test of the training
    step)."""
    _, params, batch = case
    cfg = dataclasses.replace(CFG, remat_encoder=True)
    jmodel = JaxSTrajNet(cfg=cfg)
    jb = {k: jnp.asarray(batch[k]) for k in MODEL_KEYS}

    def loss(p):
        out = jmodel.apply({"params": p}, ogm=jb["ogm"],
                           map_img=jb["map_image"], obs=jb["actors"],
                           occ=jb["occl_actors"], mapt=jb["centerlines"],
                           flow=jb["vec_flow"])
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out, grads = _output_and_grads(_torch_model(cfg, params), batch)
    # f32 both sides; summation order differs across ~60 layers
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        if name == "fg_msa_layer.proj_k.bias":   # zero but for rounding
            continue
        w = want[name].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_port_imports_no_jax_or_flax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import strajnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    strajnet_tpu_torch.__path__, 'strajnet_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'loaded': sorted(\n"
        "    k for k in ('jax', 'flax', 'tensorflow') if k in sys.modules)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "strajnet_tpu_torch.infer.runner" in result["mods"]
    assert "strajnet_tpu_torch.models.strajnet" in result["mods"]
    assert result["loaded"] == []
