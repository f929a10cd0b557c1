"""The port's Keras-checkpoint import against the JAX package's, on the CPU.

A stand-in for a built reference STrajNet at ``TINY_MODEL_CONFIG``: an
object whose ``.encoder``, ``.fg_msa_layer``, ``.decoder`` and
``.trajnet_attn`` carry ``.weights`` of seeded arrays with ``.name``s. The
encoder's names are Keras-style (automatic class scopes, then the
reference's explicit names, with the three ``patch_embed/proj/kernel`` and
two ``all_norm/gamma`` duplicates in construction order, and the buffers
the importer skips); the other three sub-models' weights come in the order
of their tables. The port's ``copy_strajnet_weights`` must equal the JAX
importer followed by ``flax_to_state_dict`` key for key and bit for bit,
and the two TINY forwards with the imported weights must agree in f32 to
1e-4. The golden round trip through a real Keras checkpoint needs the
reference's sources in ``reference/`` inside this checkout (listed in
``.gitignore``) and TensorFlow, and skips without them, as the JAX
package's does.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from strajnet_tpu.config import TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.interop import ref_import as jref
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.models.strajnet import dummy_inputs as jax_dummy_inputs
from strajnet_tpu_torch.config import STRAJNET_CONFIG, TINY_MODEL_CONFIG
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop import ref_import, refload
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.strajnet import STrajNet
from strajnet_tpu_torch.tools import import_ref_weights
from strajnet_tpu_torch.train.checkpoints import load_weights
from tests.test_torch_variants import fill_params

torch.set_num_threads(2)
CFG = TINY_MODEL_CONFIG
# where the golden round trip looks for the reference's sources
REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")
# flax head of an encoder leaf -> the reference's explicit name
KERAS_HEAD = {"patch_embed_vehicle": "patch_embed",
              "patch_embed_flow": "patch_embed",
              "patch_embed_map": "patch_embed", "flow_norm": "all_norm",
              "all_patch_norm": "all_norm", "flow_layer": "flow_layers0"}
# construction order of the encoder's sub-layers in the reference
ENCODER_ORDER = ("patch_embed_vehicle", "patch_embed_flow", "patch_embed_map",
                 "flow_norm", "flow_layer", "all_patch_norm", "layers0",
                 "layers1", "layers2")


class Weight:
    """A Keras variable as the importers read it: ``.name`` and an array."""

    def __init__(self, name, value):
        self.name, self.value = name, np.asarray(value)

    def __array__(self, dtype=None, copy=None):
        return self.value if dtype is None else self.value.astype(dtype)


class SubModel:
    def __init__(self, weights):
        self.weights = weights


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _keras_name(path, i):
    parts = list(path)
    if parts[-2:] == ["LayerNorm_0", "scale"]:
        parts = parts[:-2] + ["gamma"]
    elif parts[-2:] == ["LayerNorm_0", "bias"]:
        parts = parts[:-2] + ["beta"]
    parts[0] = KERAS_HEAD.get(parts[0], parts[0])
    # Keras' automatic scopes first, as a built model names its weights
    return (f"swin_transformer_encoder/basic_layer_{i % 4}/"
            f"swin_transformer_block_{i % 7}/" + "/".join(parts) + ":0")


def stand_in(values, drop=None, extra=None):
    """The stand-in reference model with ``values``' weights; ``drop`` /
    ``extra`` name a sub-model to lose its middle weight / gain one more."""
    enc = sorted(_leaves(values["encoder"]),
                 key=lambda pv: ENCODER_ORDER.index(pv[0][0]))
    encoder = [Weight(_keras_name(p, i), v) for i, (p, v) in enumerate(enc)]
    encoder.insert(5, Weight("layers0/blocks0/attn/relative_position_index:0",
                             np.zeros((16, 16), np.int32)))
    encoder.append(Weight("layers1/blocks1/attn_mask:0",
                          np.zeros((4, 16, 16), np.float32)))
    fg = [Weight(f"fgmsa/w{i}", _get(values["fg_msa_layer"], path))
          for i, (path, _) in enumerate(jref.fgmsa_order())]
    dec = []
    for i, (path, reshape) in enumerate(jref.decoder_order()):
        v = _get(values["decoder"], path)
        if reshape is not None:  # the reference's Conv3D kernel
            v = v[:, None, None]
        dec.append(Weight(f"decoder/w{i}", v))
    traj = []
    for i, spec in enumerate(jref.trajnet_order()):
        v = _get(values["trajnet_attn"], spec[0])
        traj.append(Weight(f"trajnet/w{i}", v if len(spec) == 2
                           else v[spec[2]]))
    subs = dict(encoder=encoder, fg_msa_layer=fg, decoder=dec,
                trajnet_attn=traj)
    if drop:
        del subs[drop][len(subs[drop]) // 2]
    if extra:
        subs[extra] = subs[extra] + [
            Weight("layers2/blocks1/attn/extra/kernel:0",
                   np.zeros((4, 4), np.float32))]
    return type("RefModel", (), {k: SubModel(w) for k, w in subs.items()})()


@pytest.fixture(scope="module")
def trees():
    """(the Flax template, the stand-in's values): the TINY tree's shapes
    by ``jax.eval_shape`` of ``init``, filled with two seeds."""
    shapes = jax.eval_shape(JaxSTrajNet(cfg=JCFG).init,
                            jax.random.PRNGKey(0),
                            **jax_dummy_inputs(JCFG, batch=1))["params"]
    return fill_params(shapes, 0), fill_params(shapes, 1)


@pytest.fixture(scope="module")
def imported(trees):
    template, values = trees
    ref = stand_in(values)
    ours = ref_import.copy_strajnet_weights(ref, CFG)
    jax_tree = jref.copy_strajnet_weights(ref, template)
    return ours, jax_tree


def test_copy_equals_the_jax_importer_then_flax_to_state_dict(imported):
    ours, jax_tree = imported
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert sorted(ours) == sorted(want)
    for k in want:
        assert ours[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(ours[k], want[k]), k
    assert set(ours) == set(STrajNet(CFG).state_dict())


def test_every_weight_came_from_the_stand_in(trees, imported):
    """No key kept the template's value: the stand-in's seed is in every
    tensor (the per-waypoint layers' split included)."""
    template, _ = trees
    ours, _ = imported
    untouched = flax_to_state_dict(template)
    same = [k for k in ours if torch.equal(ours[k], untouched[k])]
    assert same == []
    assert any(k.startswith("trajnet_attn.cross_attn_obs.7.") for k in ours)


def test_forwards_with_the_imported_weights_agree(imported):
    ours, jax_tree = imported
    batch = synthetic_batch(CFG, 2, seed=3)
    ref = np.asarray(jax.jit(JaxSTrajNet(cfg=JCFG).apply)(
        {"params": jax_tree}, ogm=batch["ogm"], map_img=batch["map_image"],
        obs=batch["actors"], occ=batch["occl_actors"],
        mapt=batch["centerlines"], flow=batch["vec_flow"]))
    model = STrajNet(CFG)
    model.load_state_dict(ours, strict=True)
    t = {k: torch.from_numpy(batch[k]) for k in MODEL_KEYS}
    with torch.no_grad():
        got = model.eval()(ogm=t["ogm"], map_img=t["map_image"],
                           obs=t["actors"], occ=t["occl_actors"],
                           mapt=t["centerlines"], flow=t["vec_flow"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("drop,extra", [
    ("encoder", None), (None, "encoder"), ("fg_msa_layer", None),
    ("decoder", None), (None, "trajnet_attn")])
def test_a_missing_or_extra_weight_raises(trees, drop, extra):
    _, values = trees
    with pytest.raises((ValueError, RuntimeError)):
        ref_import.copy_strajnet_weights(stand_in(values, drop, extra), CFG)


def test_a_weight_of_another_shape_raises(trees):
    _, values = trees
    ref = stand_in(values)
    w = ref.decoder.weights[1]
    ref.decoder.weights[1] = Weight(w.name, np.zeros(w.value.size + 1,
                                                     np.float32))
    with pytest.raises(RuntimeError, match="size mismatch"):
        ref_import.copy_strajnet_weights(ref, CFG)


def test_cli_writes_weights_the_serving_cli_reads(imported, monkeypatch,
                                                  tmp_path):
    """``tools/import_ref_weights.py`` with the TensorFlow half swapped out:
    its ``.pt`` goes through ``train/checkpoints.py::load_weights``, which
    ``infer/runner.py --weight_path`` and ``infer/evaluate.py`` use."""
    ours, _ = imported
    seen = {}

    def fake_import(weight_path, model_cfg=None, ref_dir=None):
        seen.update(weight_path=weight_path, cfg=model_cfg, ref_dir=ref_dir)
        return ours, model_cfg

    monkeypatch.setattr(import_ref_weights, "import_ref_checkpoint",
                        fake_import)
    out = str(tmp_path / "weights.pt")
    assert import_ref_weights.main(["--weight_path", "m.tf", "--out", out,
                                    "--ref_dir", "/ref"]) == 0
    assert seen == dict(weight_path="m.tf", cfg=STRAJNET_CONFIG,
                        ref_dir="/ref")
    back = load_weights(out)
    assert list(back) == list(ours)
    assert all(torch.equal(back[k], ours[k]) for k in ours)
    import_ref_weights.main(["--weight_path", "m.tf", "--out", out,
                             "--ref_dir", "/ref", "--variant", "train_py"])
    assert not seen["cfg"].fg_msa
    with pytest.raises(SystemExit):  # no default reference directory
        import_ref_weights.main(["--weight_path", "m.tf", "--out", out])
    with pytest.raises(ValueError, match="ref_dir"):
        ref_import.import_ref_checkpoint("m.tf")


def test_golden_round_trip_through_a_keras_checkpoint(tmp_path):
    """save_weights -> import_ref_checkpoint -> forward against the Keras
    model, at the 512^2 training geometry in f32 (the counterpart of the
    JAX package's ``test_import_ref_checkpoint_round_trip``)."""
    if not os.path.isdir(REF_DIR):
        pytest.skip("the reference's sources are not in reference/")
    tf = pytest.importorskip("tensorflow")
    pytest.importorskip("tf_keras")
    cfg = dataclasses.replace(STRAJNET_CONFIG, dtype="float32")
    ref = refload.build_reference_strajnet(
        cfg=dict(input_size=(512, 512), window_size=8, embed_dim=96,
                 depths=[2, 2, 2], num_heads=[3, 6, 12]), ref_dir=REF_DIR)
    rng = np.random.RandomState(7)
    for w in ref.weights:
        if any(s in w.name for s in ref_import._SKIP):
            continue
        w.assign(rng.randn(*w.shape).astype(np.float32) * 0.05)
    ckpt = str(tmp_path / "model_14_0.0_0.0.tf")
    ref.save_weights(ckpt)
    ogm = (rng.rand(1, 512, 512, 11, 2) > 0.7).astype(np.float32)
    map_img = rng.rand(1, 256, 256, 3).astype(np.float32)
    flow = rng.randn(1, 512, 512, 2).astype(np.float32)
    obs = rng.randn(1, 48, 11, 8).astype(np.float32)
    obs[:, 30:] = 0.0
    occ = rng.randn(1, 16, 11, 8).astype(np.float32)
    occ[:, 5:] = 0.0
    mapt = np.zeros((1, 256, 10, 7), np.float32)
    ref_out = np.asarray(ref(tf.constant(ogm), tf.constant(map_img),
                             training=False, obs=tf.constant(obs),
                             occ=tf.constant(occ), mapt=tf.constant(mapt),
                             flow=tf.constant(flow)))
    state, cfg = ref_import.import_ref_checkpoint(ckpt, model_cfg=cfg,
                                                  ref_dir=REF_DIR)
    model = STrajNet(cfg)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = model.eval()(*(torch.from_numpy(a) for a in
                             (ogm, map_img, obs, occ, mapt, flow))).numpy()
    assert out.shape == ref_out.shape == (1, 256, 256, 32)
    err = np.abs(out - ref_out).max() / (np.abs(ref_out).mean() + 1e-6)
    assert err < 5e-3, err
