"""Each module of the PyTorch port against its JAX counterpart, on the CPU.

Inputs come from numpy seeds, parameters from the Flax ``init`` converted by
``strajnet_tpu_torch.interop.from_flax``; everything runs in f32 at
``TINY_MODEL_CONFIG`` widths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import TINY_MODEL_CONFIG
from strajnet_tpu.core import sampling as jsampling
from strajnet_tpu.models import decoder as jdecoder
from strajnet_tpu.models import fgmsa as jfgmsa
from strajnet_tpu.models import swin as jswin
from strajnet_tpu.models import trajnet as jtrajnet
from strajnet_tpu.ops import attention as jattention
from strajnet_tpu.ops import upconv as jupconv
from strajnet_tpu.ops import windows as jwindows
from strajnet_tpu.ops.rpe_window import rpe_window_bias
from strajnet_tpu_torch.core import sampling
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.decoder import Pyramid3DDecoder, TemporalConv
from strajnet_tpu_torch.models.fgmsa import FGMSA
from strajnet_tpu_torch.models.swin import SwinTransformerEncoder
from strajnet_tpu_torch.models.trajnet import TrajNetCrossAttention
from strajnet_tpu_torch.ops import windows
from strajnet_tpu_torch.ops.attention import TfaMultiHeadAttention
from strajnet_tpu_torch.ops.upconv import upsample2x_conv3x3

torch.set_num_threads(2)
CFG = TINY_MODEL_CONFIG

# f32 on both sides; the sums run in different orders (XLA vs ATen), and
# the deeper modules compound that over a few dozen layers.
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _params(module, *args, **kw):
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), *args, **kw)
    return jax.tree_util.tree_map(np.asarray, variables)


def _apply(module, params, *args, **kw):
    out = jax.jit(module.apply)(params, *args, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _load(module, flax_params):
    module.load_state_dict(flax_to_state_dict(flax_params), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_windows_match_jax():
    rng = np.random.RandomState(0)
    x = _rand(rng, 2, 8, 12, 3)
    parts = windows.window_partition(_t(x), 4)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jwindows.window_partition(x, 4)))
    np.testing.assert_array_equal(
        windows.window_reverse(parts, 4, 8, 12, 3).numpy(), x)
    for h, w, ws, s in ((8, 8, 4, 2), (16, 16, 8, 4), (12, 8, 4, 1)):
        np.testing.assert_array_equal(windows.shifted_window_mask(h, w, ws, s),
                                      jwindows.shifted_window_mask(h, w, ws, s))
    for ws in (4, 7, 8):
        np.testing.assert_array_equal(windows.relative_position_index(ws, ws),
                                      jwindows.relative_position_index(ws, ws))


def test_tfa_attention_matches_jax():
    rng = np.random.RandomState(1)
    q, kv = _rand(rng, 3, 5, 12), _rand(rng, 3, 7, 10)
    mask = (rng.rand(3, 5, 7) > 0.3).astype(np.int32)
    mask[0] = 0   # a fully masked query row set: uniform softmax
    jm = jattention.TfaMultiHeadAttention(num_heads=3, head_size=4,
                                          output_size=9)
    params = _params(jm, q, kv, mask=mask)
    ours = _load(TfaMultiHeadAttention(3, 4, 9, 12, 10), params)
    with torch.no_grad():
        y = ours(_t(q), _t(kv), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y.numpy(),
                               _apply(jm, params, q, kv, mask=mask),
                               **TOL)


def test_upsample_conv_matches_jax():
    rng = np.random.RandomState(2)
    x, w3, b = _rand(rng, 2, 5, 6, 4), _rand(rng, 3, 3, 4, 7), _rand(rng, 7)
    ref = np.asarray(jupconv.upsample2x_conv3x3(x, w3, b))
    y = upsample2x_conv3x3(_t(x), _t(w3.transpose(3, 2, 0, 1)), _t(b))
    np.testing.assert_allclose(y.numpy(), ref, **TOL)
    # and the composition it stands for: nearest 2x upsample, 3x3 SAME conv
    up = torch.from_numpy(x.repeat(2, axis=1).repeat(2, axis=2))
    naive = torch.nn.functional.conv2d(up.permute(0, 3, 1, 2),
                                       _t(w3.transpose(3, 2, 0, 1)), _t(b),
                                       padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.numpy(), naive.numpy(), **TOL)


def test_sampling_matches_jax():
    rng = np.random.RandomState(3)
    img = _rand(rng, 2, 9, 11, 3)
    # in-range, out-of-range and exactly-integral (pixel-centre) queries
    warp = _rand(rng, 2, 5, 4, 2, scale=6.0) + 4.0
    warp[0, 0, 0] = (3.0, 2.0)
    np.testing.assert_allclose(
        sampling.sample(_t(img), _t(warp)).numpy(),
        np.asarray(jsampling.sample(img, warp)), **TOL)
    q = _rand(rng, 2, 13, 2, scale=5.0) + 4.0
    np.testing.assert_allclose(
        sampling.interpolate_bilinear(_t(img), _t(q)).numpy(),
        np.asarray(jsampling.interpolate_bilinear(img, q)), **TOL)


@pytest.mark.parametrize("hw", [(2, 2), (4, 4), (6, 6)])
def test_rpe_gather_matches_window_and_one_hot_forms(hw):
    h, w = hw
    s, g = 6, 2
    rng = np.random.RandomState(4)
    table = _rand(rng, s, 2 * h - 1, 2 * w - 1, g)
    ref = np.asarray(jfgmsa._ref_points(h, w, jnp.float32)).reshape(1, -1, 2)
    # FG-MSA's positions: the grid plus tanh-bounded offsets of range h/2
    pos = ref + np.tanh(_rand(rng, s, h * w, 2, scale=2.0)) * (h / 2.0)
    pos[0, 0] = (0.0, 0.0)   # an integral position
    ours = sampling.rpe_bias(_t(table), _t(pos), (h, w)).numpy()
    window = np.asarray(rpe_window_bias(table, pos, (h, w), bound=h / 2.0))
    disp = ref[:, :, None, :] - pos[:, None]
    disp = np.stack([disp[..., 1], disp[..., 0]], axis=-1)
    one_hot = np.asarray(jsampling.sample_small_table(table, disp))
    np.testing.assert_allclose(ours, window, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, one_hot, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def encoder_case():
    rng = np.random.RandomState(5)
    h, w = CFG.input_size
    mh, mw = CFG.map_size
    ogm = (rng.rand(2, h, w, CFG.ogm_past_steps, 2) > 0.8).astype(np.float32)
    map_img = rng.rand(2, mh, mw, 3).astype(np.float32)
    flow = _rand(rng, 2, h, w, 2)
    kw = dict(img_size=CFG.input_size, patch_size=(4, 4),
              embed_dim=CFG.embed_dim, depths=CFG.depths,
              num_heads=CFG.num_heads, window_size=CFG.window_size,
              mlp_ratio=CFG.mlp_ratio, drop_path_rate=0.1)
    jm = jswin.SwinTransformerEncoder(**kw, use_pallas=False)
    params = _params(jm, ogm, map_img, flow)
    ours = _load(SwinTransformerEncoder(
        CFG.input_size, 4, CFG.embed_dim, CFG.depths, CFG.num_heads,
        CFG.window_size, CFG.mlp_ratio), params)
    with torch.no_grad():
        res = ours(_t(ogm), _t(map_img), _t(flow))
    return kw, params, (ogm, map_img, flow), [r.numpy() for r in res]


@pytest.mark.parametrize("use_pallas", [False, "block"])
def test_encoder_matches_jax(encoder_case, use_pallas):
    """res_list against JAX with its kernels off and with the fused block
    kernel (interpreted on the CPU)."""
    kw, params, inputs, ours = encoder_case
    jm = jswin.SwinTransformerEncoder(**kw, use_pallas=use_pallas)
    ref = _apply(jm, params, *inputs)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, np.asarray(r), **TOL)


def test_fgmsa_matches_jax():
    rng = np.random.RandomState(6)
    h = w = 4
    c = 64
    x = _rand(rng, 2, h, w, c)
    jm = jfgmsa.FGMSA(q_size=(h, w), kv_size=(h, w), n_heads=8,
                      n_head_channels=8, n_groups=8, out_dim=c, in_dim=c,
                      fg=True, deform_kv=False)
    params = _params(jm, x)
    # a rel-pos table large enough for the gathered bias to matter
    params["params"]["rpe_table"] = _rand(rng, 2 * h - 1, 2 * w - 1, 8)
    ours = _load(FGMSA((h, w), 8, 8, 8, c, c), params)
    with torch.no_grad():
        y, pos, hidden = ours(_t(x))
    jy, jpos, jhidden = _apply(jm, params, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)


def test_fgmsa_without_flow_head_matches_jax():
    """``fg=False``: no ``conv_offset_proj2`` (the state dict loads the Flax
    tree strictly), and the third output is the reference grid."""
    rng = np.random.RandomState(7)
    h = w = 4
    c = 64
    x = _rand(rng, 2, h, w, c)
    jm = jfgmsa.FGMSA(q_size=(h, w), kv_size=(h, w), n_heads=8,
                      n_head_channels=8, n_groups=8, out_dim=c, in_dim=c,
                      fg=False, deform_kv=False)
    params = _params(jm, x)
    assert "conv_offset_proj2" not in params["params"]
    params["params"]["rpe_table"] = _rand(rng, 2 * h - 1, 2 * w - 1, 8)
    ours = _load(FGMSA((h, w), 8, 8, 8, c, c, fg=False), params)
    assert not hasattr(ours, "conv_offset_proj2")
    with torch.no_grad():
        outs = ours(_t(x))
    ref = _apply(jm, params, x)
    assert outs[2].shape == (2, 8, h, w, 2)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_trajnet_cross_attention_matches_jax():
    rng = np.random.RandomState(7)
    bh, bw = 2, 2
    t, dim = CFG.num_waypoints, CFG.bottleneck_dim
    query = _rand(rng, 2, t, bh * bw, dim)
    obs = _rand(rng, 2, CFG.obs_actors, CFG.actor_steps, CFG.actor_feats)
    occ = _rand(rng, 2, CFG.occ_actors, CFG.actor_steps, CFG.actor_feats)
    obs[:, 3:] = 0.0          # invalid actors
    obs[0, 1, 5:, 0] = 0.0    # invalid steps of a valid actor
    occ[1] = 0.0
    jm = jtrajnet.TrajNetCrossAttention(
        pic_size=(bh, bw), pic_dim=dim, obs_actors=CFG.obs_actors,
        occ_actors=CFG.occ_actors, traj_heads=CFG.traj_heads,
        att_heads=CFG.att_heads, out_dim=CFG.traj_out_dim,
        num_waypoints=t)
    params = _params(jm, query, obs, occ)
    ours = _load(TrajNetCrossAttention(
        (bh, bw), dim, CFG.obs_actors, CFG.occ_actors, CFG.actor_feats,
        CFG.traj_heads, CFG.att_heads, CFG.traj_out_dim, t), params)
    with torch.no_grad():
        y = ours(_t(query), _t(obs), _t(occ))
    np.testing.assert_allclose(y.numpy(),
                               _apply(jm, params, query, obs, occ),
                               **TOL)


def test_decoder_matches_jax():
    rng = np.random.RandomState(8)
    t, e = CFG.num_waypoints, CFG.embed_dim
    bh, _ = CFG.bottleneck_size
    x = _rand(rng, 2, t, bh, bh, CFG.bottleneck_dim)
    res_list = [_rand(rng, 2, (4 * bh) ** 2, e), _rand(rng, 2, (4 * bh) ** 2, e),
                _rand(rng, 2, (2 * bh) ** 2, 2 * e),
                _rand(rng, 2, bh * bh, 4 * e)]
    jm = jdecoder.Pyramid3DDecoder(shallow_decode=CFG.shallow_decode,
                                   num_waypoints=t, bottleneck_size=(bh, bh))
    params = _params(jm, x, res_list)
    ours = _load(Pyramid3DDecoder(CFG.bottleneck_dim, (e, 2 * e, 4 * e), e,
                                  CFG.shallow_decode, t, (bh, bh)), params)
    with torch.no_grad():
        y = ours(_t(x), [_t(r) for r in res_list])
    np.testing.assert_allclose(y.numpy(),
                               _apply(jm, params, x, res_list),
                               **TOL)


@pytest.mark.parametrize("t_in", [1, 8])
def test_temporal_conv_matches_jax(t_in):
    """Both forms: the collapsed time-constant one and the dense band."""
    rng = np.random.RandomState(9)
    x = _rand(rng, 2, t_in, 3, 3, 5)
    jm = jdecoder.TemporalConv(features=6, kt=8, num_steps=8)
    params = _params(jm, x)
    ours = _load(TemporalConv(5, 6, 8, 8), params)
    with torch.no_grad():
        y = ours(_t(x))
    np.testing.assert_allclose(y.numpy(), _apply(jm, params, x),
                               **TOL)
