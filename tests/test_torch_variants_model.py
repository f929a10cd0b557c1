"""The whole STrajNet under its variant flags, port against JAX, on the CPU.

At ``ULTRA_TINY_MODEL_CONFIG`` with the flags replaced on both packages'
configs (``dataclasses.replace``): every combination that the JAX package
runs builds in the port, loads that combination's Flax tree strictly and
gives a finite output of the JAX output's shape; every combination that the
JAX package cannot run raises in the port too. The flags are grouped into
four combined configurations whose forwards are held against JAX's in f32
to 1e-4 (each flag alone is held against its JAX module in
``tests/test_torch_variants.py``); ``init_params`` of a variant. Two training
steps of the map variant are ``tests/test_torch_variants_train.py``.

Parameters come from ``jax.eval_shape`` of the Flax ``init`` (which traces
without compiling) filled with seeded values, so a combination costs a JAX
compile only where its forward is compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.models.strajnet import STrajNet as JaxSTrajNet
from strajnet_tpu.models.strajnet import dummy_inputs as jax_dummy_inputs
from strajnet_tpu_torch.config import ULTRA_TINY_MODEL_CONFIG
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from tests.test_torch_variants import fill_params

torch.set_num_threads(2)
CFG = ULTRA_TINY_MODEL_CONFIG
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")

# The combinations the JAX package runs: each flag alone, and the encoder
# wirings without a flow stage, which run only without the flow head.
# rep_res=False reshapes each residual to [-1, T, ...], which works where
# the batch is T = 8.
RUNS = [
    dict(actor_only=False),
    dict(sep_actors=True),
    dict(deform_kv=True),
    dict(stp_grad=True),
    dict(conv_cnn=True),
    dict(sep_conv=True),
    dict(ape=True),
    dict(use_pyramid=False),
    dict(large_input=False),
    dict(rep_res=False, batch=8),
    dict(flow_sep=False, large_input=False, flow_sep_decode=False),
    dict(use_flow=False, large_input=False, flow_sep_decode=False),
    dict(sep_encode=False, flow_sep=False, large_input=False,
         flow_sep_decode=False),
    dict(sep_encode=False, use_flow=False, large_input=False,
         flow_sep_decode=False),
    dict(no_map=True, flow_sep=False, flow_sep_decode=False),
    dict(no_map=True, flow_sep=False, flow_sep_decode=False,
         large_input=False),
    dict(rep_res=False, flow_sep=False, large_input=False,
         flow_sep_decode=False, batch=8),
]

# The flags of RUNS in four configurations, one JAX compile each.
GROUPS = [
    dict(actor_only=False, sep_actors=True, deform_kv=True, conv_cnn=True,
         sep_conv=True, ape=True, stp_grad=True),
    dict(rep_res=False, flow_sep=False, large_input=False,
         flow_sep_decode=False, batch=8),
    dict(sep_encode=False, use_flow=False, large_input=False,
         flow_sep_decode=False, use_pyramid=False),
    dict(no_map=True, flow_sep=False, flow_sep_decode=False),
]

# The combinations it cannot run, and why.
RAISES = [
    # a residual of batch 2 reshaped to [-1, 8, ...]
    dict(rep_res=False),
    # the flow residual taken as a pyramid residual: batches do not meet
    dict(flow_sep_decode=False),
    # the 512^2-style OGM concatenated with the half-size map
    dict(sep_encode=False),
    # no flow stage, but flow_sep and use_flow add its (missing) output
    dict(sep_encode=False, large_input=False),
    dict(no_map=True),
    # the unpadded half-size map added to the full patch grid
    dict(flow_sep=False),
    dict(use_flow=False),
    # no flow stage under the flow head: res0 taken as the flow residual
    dict(flow_sep=False, large_input=False),
    dict(use_flow=False, large_input=False),
]


def _ids(flags):
    return "-".join(f"{k}={v}" for k, v in flags.items())


def _split(flags):
    flags = dict(flags)
    return flags.pop("batch", 2), flags


def _batch(cfg, batch, seed=3):
    return synthetic_batch(cfg, batch, seed=seed)


def _jax_kwargs(batch):
    return dict(ogm=batch["ogm"], map_img=batch["map_image"],
                obs=batch["actors"], occ=batch["occl_actors"],
                mapt=batch["centerlines"], flow=batch["vec_flow"])


def _variant_params(flags, batch=2, seed=0):
    """The variant's Flax tree (by ``jax.eval_shape`` of ``init``) with
    seeded values."""
    cfg = dataclasses.replace(JCFG, **flags)
    shapes = jax.eval_shape(JaxSTrajNet(cfg=cfg).init, jax.random.PRNGKey(0),
                            **jax_dummy_inputs(cfg, batch=batch))
    return fill_params(shapes["params"], seed)


def _count_leaves(tree, stacked=False):
    n = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            n += _count_leaves(v, stacked or k in ("cross_attn_obs",
                                                   "map_cross_attn"))
        else:
            n += v.shape[0] if stacked else 1
    return n


def _torch_forward(model, batch):
    t = {k: torch.from_numpy(np.asarray(batch[k])) for k in MODEL_KEYS}
    with torch.no_grad():
        return model(ogm=t["ogm"], map_img=t["map_image"], obs=t["actors"],
                     occ=t["occl_actors"], mapt=t["centerlines"],
                     flow=t["vec_flow"]).numpy()


def _torch_model(cfg, params):
    model = STrajNet(cfg)
    assert len(model.state_dict()) == _count_leaves(params)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def test_groups_cover_every_flag_that_runs():
    flags = {k for run in RUNS for k in run}
    assert flags == {k for group in GROUPS for k in group}
    assert all(any(all(group.get(k) == v for k, v in run.items())
                   for group in GROUPS)
               for run in RUNS if len(run) == 1)


@pytest.mark.parametrize("flags", RUNS, ids=_ids)
def test_variant_builds_loads_and_runs(flags):
    """The port builds the combination, its state dict is the combination's
    Flax tree (every leaf once, loaded strictly), and its forward is finite
    and of the configuration's output shape."""
    batch_size, flags = _split(flags)
    cfg = dataclasses.replace(CFG, **flags)
    params = _variant_params(flags, batch_size)
    ours = _torch_forward(_torch_model(cfg, params), _batch(cfg, batch_size))
    oh, ow = cfg.output_size
    assert ours.shape == (batch_size, oh, ow, 4 * cfg.num_waypoints)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("flags", GROUPS, ids=_ids)
def test_variant_forward_matches_jax(flags):
    batch_size, flags = _split(flags)
    cfg = dataclasses.replace(CFG, **flags)
    jcfg = dataclasses.replace(JCFG, **flags)
    params = _variant_params(flags, batch_size)
    batch = _batch(cfg, batch_size)
    ref = np.asarray(jax.jit(JaxSTrajNet(cfg=jcfg).apply)(
        {"params": params}, **_jax_kwargs(batch)))
    ours = _torch_forward(_torch_model(cfg, params), batch)
    assert ours.shape == ref.shape
    # f32 both sides; summation order differs across ~40 layers
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flags", RAISES, ids=_ids)
def test_variant_raises_where_jax_raises(flags):
    """``jax.eval_shape`` of the JAX ``init`` and ``apply`` raises (tracing
    only); the port raises as well, at construction or in the forward."""
    jcfg = dataclasses.replace(JCFG, **flags)
    jm = JaxSTrajNet(cfg=jcfg)
    inputs = jax_dummy_inputs(jcfg, batch=2)
    with pytest.raises((TypeError, ValueError, IndexError)):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), **inputs)
        jax.eval_shape(jm.apply, shapes, **inputs)
    cfg = dataclasses.replace(CFG, **flags)
    batch = _batch(cfg, 2)
    with pytest.raises((RuntimeError, TypeError, ValueError, IndexError)):
        model = STrajNet(cfg).eval()
        _torch_forward(model, batch)


def test_init_params_cover_the_variant_parameters():
    """``init_params`` of a variant with every new kind of parameter: the
    state dict loads, the ConvLSTM's recurrent kernels are orthogonal (as
    Flax's ``orthogonal()``: the HWIO kernel as a matrix with orthonormal
    columns), the position embedding is zero, the forward is finite."""
    cfg = dataclasses.replace(CFG, **GROUPS[0])
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    model = STrajNet(cfg)
    model.load_state_dict(sd, strict=True)
    for name in ("decoder.uplstmconv_3_0.conv_h.weight",
                 "decoder.upconvf_1_0.conv_h.weight"):
        w = sd[name]
        m = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).double()
        eye = torch.eye(min(m.shape), dtype=torch.float64)
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        assert torch.allclose(gram, eye, atol=1e-5), name
    assert not sd["encoder.absolute_pos_embed"].any()
    assert not sd["trajnet_attn.map_cross_attn.3.FFN2.bias"].any()
    q = sd["trajnet_attn.map_cross_attn.3.actor_mha.query_kernel"]
    limit = (6.0 / (q.shape[0] * (q.shape[1] + q.shape[2]))) ** 0.5
    assert q.abs().max() <= limit and q.abs().max() > 0.9 * limit
    out = _torch_forward(model.eval(), _batch(cfg, 1))
    assert np.isfinite(out).all()
