"""The modules behind STrajNet's variant flags, port against JAX, on the CPU.

Each module is built on both sides at small widths from the same seeded
numpy inputs and the same seeded parameters in the Flax module's tree
(converted by ``interop/from_flax.py``, loaded strictly), f32 unless stated:
``rpe_window_bias`` (FG-MSA's bias as a blend of table windows) and its
gradients against autograd of the direct gather, FG-MSA's options, the
centerline encoder and the map cross-attention, ``sep_actors``, ``TrajNet``'s
``no_attn`` / ``double_net``, the LSTM track encoder, ``ConvLSTM2D``,
``TimeSharedConv``, the decoder's flags and the encoder's wirings. The whole
model under each flag combination is ``tests/test_torch_variants_model.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import ULTRA_TINY_MODEL_CONFIG as JCFG
from strajnet_tpu.models import decoder as jdecoder
from strajnet_tpu.models import fgmsa as jfgmsa
from strajnet_tpu.models import swin as jswin
from strajnet_tpu.models import trajnet as jtrajnet
from strajnet_tpu.ops.rpe_window import rpe_window_bias as jax_rpe_window
from strajnet_tpu_torch.core.sampling import ref_points, rpe_bias
from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict
from strajnet_tpu_torch.models.decoder import (ConvLSTM2D, Pyramid3DDecoder,
                                               TimeSharedConv)
from strajnet_tpu_torch.models.fgmsa import FGMSA
from strajnet_tpu_torch.models.swin import SwinTransformerEncoder
from strajnet_tpu_torch.models.trajnet import (MapEncoder, TrajEncoderLSTM,
                                               TrajNet,
                                               TrajNetCrossAttention)
from strajnet_tpu_torch.ops.rpe_window import rpe_window_bias

torch.set_num_threads(2)

# f32 on both sides; the sums run in different orders (XLA vs ATen)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def fill_params(shapes, seed=0):
    """Seeded values for a Flax tree of shapes: kernels and tables
    N(0, 1/fan_in) with fan_in the product of all but the last axis,
    LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2) (not the init's
    zeros, so that a bias that went astray shows)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = rng.standard_normal(v.shape)
            if k == "scale":
                a = 1.0 + 0.1 * a
            elif k == "bias":
                a = 0.1 * a
            else:
                a = a / np.sqrt(max(1, int(np.prod(v.shape[:-1]))))
            out[k] = a.astype(np.float32)
        return out

    return walk(shapes)


def _params(module, *args, **kw):
    """The module's parameter tree with :func:`fill_params`' values: the
    tree by ``jax.eval_shape`` of ``init``, which traces without
    compiling."""
    return fill_params(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                      *args, **kw))


def _apply(module, params, *args, **kw):
    out = jax.jit(module.apply)(params, *args, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _load(module, flax_params):
    module.load_state_dict(flax_to_state_dict(flax_params), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(ours, ref, tol=TOL):
    ours = [ours] if isinstance(ours, torch.Tensor) else ours
    ref = [ref] if not isinstance(ref, (tuple, list)) else ref
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **tol)


# -- rpe_window_bias -------------------------------------------------------

def _rpe_case(h, bound, seed):
    """A table of S slices and FG-MSA's positions: the grid plus offsets of
    at most ``bound`` (tanh-shaped, none exactly integral)."""
    s, g = 4, 2
    rng = np.random.RandomState(seed)
    table = _rand(rng, s, 2 * h - 1, 2 * h - 1, g)
    grid = ref_points(h, h).reshape(1, -1, 2).numpy()
    pos = grid + np.tanh(_rand(rng, s, h * h, 2, scale=2.0)) * bound
    pos += 1e-3 * (1 + rng.rand(s, h * h, 2))   # off the lattice
    return table, pos.astype(np.float32)


RPE_CASES = [(16, 0.0), (16, 8.0), (4, 0.0), (4, 2.0)]


@pytest.mark.parametrize("h,bound", RPE_CASES)
def test_rpe_window_bias_matches_jax(h, bound):
    """f32 to 1e-5 against JAX's ``rpe_window_bias``, at the bounds FG-MSA
    uses (h/2, and 0 under ``no_off``) and two grid sizes; at the flagship's
    grid and bound also with bf16 compute, by cosine."""
    table, pos = _rpe_case(h, bound, seed=h)
    ours = rpe_window_bias(_t(table), _t(pos), (h, h), bound)
    ref = np.asarray(jax.jit(jax_rpe_window, static_argnums=(2, 3))(
        table, pos, (h, h), bound))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    if (h, bound) != (16, 8.0):
        return
    ours16 = rpe_window_bias(_t(table), _t(pos), (h, h), bound,
                             torch.bfloat16).double().flatten()
    ref16 = np.asarray(jax.jit(jax_rpe_window, static_argnums=(2, 3, 4))(
        table, pos, (h, h), bound, jnp.bfloat16), np.float64).ravel()
    cos = float(ours16.numpy() @ ref16) / (
        np.linalg.norm(ours16.numpy()) * np.linalg.norm(ref16))
    assert 1.0 - cos <= 1e-4, 1.0 - cos


@pytest.mark.parametrize("h,bound", RPE_CASES)
def test_rpe_window_bias_gradients_match_the_gather(h, bound):
    """The table and position gradients of the window form against autograd
    of the direct gather (``core/sampling.py::rpe_bias``), f32, to 1e-4 of
    the largest entry."""
    table, pos = _rpe_case(h, bound, seed=10 + h)
    weight = torch.from_numpy(
        np.random.RandomState(3).randn(4, h * h, h * h, 2).astype(np.float32))
    grads = []
    for fn in (lambda t, p: rpe_window_bias(t, p, (h, h), bound),
               lambda t, p: rpe_bias(t, p, (h, h))):
        t, p = _t(table).requires_grad_(), _t(pos).requires_grad_()
        out = fn(t, p)
        grads.append((out.detach(),) + torch.autograd.grad(
            (out * weight).sum(), (t, p)))
    for name, a, b in zip(("bias", "d/d table", "d/d pos"), *grads):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# -- FG-MSA's options ------------------------------------------------------

FGMSA_OPTIONS = [
    dict(deform_kv=True),
    dict(deform_kv=True, fg=False),
    dict(no_off=True),
    dict(use_pe=False),
    dict(stage_idx=0),
    dict(stage_idx=2, no_off=True, offset_range_factor=-1.0),
    dict(offset_range_factor=0.0),
    dict(offset_range_factor=-1.0),
    dict(use_last_ref=True),
]


@pytest.mark.parametrize("opts", FGMSA_OPTIONS,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_fgmsa_options_match_jax(opts):
    """Each option of the JAX module, with its bias branch: the window form
    where the queries form the grid and the offsets are bounded (``no_off``
    with a non-negative range factor: bound 0), the direct gather otherwise
    (free offsets, ``tanh`` of the sum, ``use_last_ref``)."""
    rng = np.random.RandomState(6)
    h = w = 4
    c = 64
    x = _rand(rng, 2, h, w, c)
    kw = dict(dict(fg=True), **opts)
    args = [x]
    if opts.get("use_last_ref"):
        grid = np.asarray(jfgmsa._ref_points(h, w, jnp.float32))
        args.append((grid + _rand(rng, 16, h, w, 2, scale=0.7)))
    jm = jfgmsa.FGMSA(q_size=(h, w), kv_size=(h, w), n_heads=8,
                      n_head_channels=8, n_groups=8, out_dim=c, in_dim=c,
                      **kw)
    params = _params(jm, *args)
    if kw.get("use_pe", True):
        params["params"]["rpe_table"] = _rand(rng, 2 * h - 1, 2 * w - 1, 8)
    else:
        assert "rpe_table" not in params["params"]
    ours = _load(FGMSA((h, w), 8, 8, 8, c, c, **kw), params)
    with torch.no_grad():
        got = ours(*[_t(a) for a in args])
    _close(got, _apply(jm, params, *args))


def test_fgmsa_bf16_matches_jax_by_cosine():
    """The flagship's bias branch in bf16 (the window form with
    ``compute_dtype`` bf16, the gather with the table in bf16)."""
    rng = np.random.RandomState(7)
    h = w = 4
    c = 64
    x = _rand(rng, 2, h, w, c)
    for opts in (dict(), dict(offset_range_factor=0.0)):
        jm = jfgmsa.FGMSA(q_size=(h, w), kv_size=(h, w), n_heads=8,
                          n_head_channels=8, n_groups=8, out_dim=c,
                          in_dim=c, fg=True, dtype=jnp.bfloat16, **opts)
        params = _params(jm, x)
        params["params"]["rpe_table"] = _rand(rng, 2 * h - 1, 2 * w - 1, 8)
        ours = _load(FGMSA((h, w), 8, 8, 8, c, c, torch.bfloat16, **opts),
                     params)
        with torch.no_grad():
            y = ours(_t(x))[0].double().numpy().ravel()
        ref = np.asarray(_apply(jm, params, x)[0], np.float64).ravel()
        cos = y @ ref / (np.linalg.norm(y) * np.linalg.norm(ref))
        assert 1.0 - cos <= 1e-3, (opts, 1.0 - cos)


def test_fgmsa_dropouts_act_in_training_with_the_generator():
    """``attn_drop`` and ``proj_drop`` change nothing in ``eval()``; in
    training mode they draw from the generator handed in."""
    torch.manual_seed(0)
    x = torch.randn(2, 4, 4, 64)
    m = FGMSA((4, 4), 8, 8, 8, 64, 64, attn_drop=0.3, proj_drop=0.2)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    with torch.no_grad():
        y0 = m.eval()(x)[0]
        m.train()
        a = m(x, generator=torch.Generator().manual_seed(1))[0]
        b = m(x, generator=torch.Generator().manual_seed(1))[0]
        c = m(x, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, y0)


# -- fusion: centerlines, sep_actors, TrajNet's options, the LSTM ----------

def _actors(rng, b, n_obs, n_occ, steps=11, feats=8):
    obs = _rand(rng, b, n_obs, steps, feats)
    occ = _rand(rng, b, n_occ, steps, feats)
    obs[:, n_obs - 1:] = 0.0      # an invalid actor
    obs[0, 1, 5:, 0] = 0.0        # invalid steps of a valid actor
    occ[1] = 0.0
    return obs, occ


def _centerlines(rng, b, segs, points=10, feats=7):
    mapt = _rand(rng, b, segs, points, feats)
    mapt[:, -2:] = 0.0            # invalid segments
    mapt[0, 1, 6:, 0] = 0.0       # invalid points of a valid segment
    return mapt


def test_map_encoder_matches_jax():
    rng = np.random.RandomState(8)
    mt = _centerlines(rng, 3, 4).reshape(12, 10, 7)
    mask = mt[..., 0] != 0
    jm = jtrajnet.MapEncoder(num_heads=2, out_dim=32)
    params = _params(jm, mt, mask)
    ours = _load(MapEncoder(7, 2, 32), params)
    with torch.no_grad():
        y = ours(_t(mt), torch.from_numpy(mask))
    _close(y, _apply(jm, params, mt, mask))


@pytest.mark.parametrize("no_attn,double_net",
                         [(True, False), (False, True), (True, True)])
def test_trajnet_options_match_jax(no_attn, double_net):
    """``no_attn`` (the ``sep_actors`` path) and ``double_net`` (no path of
    either package sets it: the OGM and the flow feature over all actors)."""
    rng = np.random.RandomState(9)
    obs, occ = _actors(rng, 2, 4, 2)
    jm = jtrajnet.TrajNet(obs_actors=4, occ_actors=2, traj_heads=2,
                          att_heads=2, out_dim=32, no_attn=no_attn,
                          double_net=double_net)
    params = _params(jm, obs, occ)
    ours = _load(TrajNet(4, 2, 8, 2, 2, 32, no_attn=no_attn,
                         double_net=double_net), params)
    with torch.no_grad():
        got = ours(_t(obs), _t(occ))
    ref = _apply(jm, params, obs, occ)
    if double_net:
        assert got[0].shape == got[1].shape == (2, 6, 32)
    _close(got[:2], ref[:2])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])


@pytest.mark.parametrize("actor_only,sep_actors",
                         [(True, True), (False, False), (False, True)])
def test_trajnet_cross_attention_variants_match_jax(actor_only, sep_actors):
    """The centerline branch (map encoder, ``map_norm``, eight per-waypoint
    map blocks on ``o``, ``v = mv + o + flat``) and ``sep_actors`` (actor
    self-attention in each block, masked in the actor blocks only), apart
    and together."""
    rng = np.random.RandomState(10)
    bh = bw = 2
    t, dim, out_dim = 8, 32, 32
    query = _rand(rng, 2, t, bh * bw, dim)
    obs, occ = _actors(rng, 2, 4, 2)
    mapt = _centerlines(rng, 2, 5)
    kw = dict(pic_size=(bh, bw), pic_dim=dim, obs_actors=4, occ_actors=2,
              traj_heads=2, att_heads=2, out_dim=out_dim, num_waypoints=t,
              actor_only=actor_only, sep_actors=sep_actors)
    jm = jtrajnet.TrajNetCrossAttention(**kw)
    params = _params(jm, query, obs, occ, mapt)
    assert ("map_cross_attn" in params["params"]) == (not actor_only)
    ours = _load(TrajNetCrossAttention(
        (bh, bw), dim, 4, 2, 8, 2, 2, out_dim, t, actor_only=actor_only,
        sep_actors=sep_actors), params)
    with torch.no_grad():
        y = ours(_t(query), _t(obs), _t(occ), _t(mapt))
    _close(y, _apply(jm, params, query, obs, occ, mapt))


def test_traj_encoder_lstm_matches_jax():
    """Conv1D embedding, Flax's ``OptimizedLSTMCell`` from a zero carry, the
    last output; the parameter tree (gate order, which projections carry a
    bias) read off the JAX module."""
    rng = np.random.RandomState(11)
    x = _rand(rng, 3, 11, 8)
    jm = jtrajnet.TrajEncoderLSTM(out_dim=16)
    params = _params(jm, x)
    cell = params["params"]["OptimizedLSTMCell_0"]
    assert sorted(cell) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert all("bias" in cell[f"h{g}"] and "bias" not in cell[f"i{g}"]
               for g in "ifgo")
    ours = _load(TrajEncoderLSTM(8, 16), params)
    with torch.no_grad():
        y = ours(_t(x))
    assert y.shape == (3, 16)
    _close(y, _apply(jm, params, x))


# -- decoder ---------------------------------------------------------------

def test_conv_lstm_and_time_shared_conv_match_jax():
    rng = np.random.RandomState(12)
    x = _rand(rng, 2, 8, 5, 6, 7)
    for jm, ours in ((jdecoder.ConvLSTM2D(features=5), ConvLSTM2D(7, 5)),
                     (jdecoder.TimeSharedConv(features=4),
                      TimeSharedConv(7, 4))):
        params = _params(jm, x)
        ours = _load(ours, params)
        with torch.no_grad():
            y = ours(_t(x))
        _close(y, _apply(jm, params, x))


DECODER_FLAGS = [
    dict(sep_conv=True, use_tail_kernel="kernel"),
    dict(use_pyramid=False),
    dict(flow_sep_decode=False),
    dict(rep_res=False),
    dict(stp_grad=True, conv_cnn=True, sep_conv=True),
]


@pytest.mark.parametrize("flags", DECODER_FLAGS,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_decoder_flags_match_jax(flags):
    """Each decoder flag against the JAX decoder: the module tree per flag
    (loaded strictly) and the forward; with ``stp_grad`` and both ConvLSTM
    stages (``conv_cnn``, ``sep_conv``) also the gradients
    of ``sum(y ** 2)`` with respect to the inputs and every parameter (none
    into the bottleneck or the residuals but the flow's). ``rep_res=False``
    reshapes each residual to ``[-1, T, ...]``, which works where the batch
    is T: batch T here, as the model needs. Four waypoints, to keep the
    JAX compiles of the unrolled ConvLSTMs short. The ``"kernel"`` tail takes its
    plain version on CPU tensors (the JAX side runs its naive tail, the same
    math)."""
    rng = np.random.RandomState(13)
    t, e, bh = 4, 8, 1
    b = t if not flags.get("rep_res", True) else 2
    x = _rand(rng, b, t, bh, bh, 32)
    res_list = [_rand(rng, b, (4 * bh) ** 2, e), _rand(rng, b, (4 * bh) ** 2, e),
                _rand(rng, b, (2 * bh) ** 2, 2 * e),
                _rand(rng, b, bh * bh, 4 * e)]
    jflags = dict(flags)
    tail = jflags.pop("use_tail_kernel", False)
    fsd = flags.get("flow_sep_decode", True)
    if not fsd:   # the model hands it no flow residual then
        res_list = res_list[1:]
    jm = jdecoder.Pyramid3DDecoder(shallow_decode=1, num_waypoints=t,
                                   bottleneck_size=(bh, bh),
                                   **jflags)
    params = _params(jm, x, res_list)
    ours = _load(Pyramid3DDecoder(
        32, (e, 2 * e, 4 * e), e if fsd else None, 1, t, (bh, bh),
        use_tail_kernel="kernel" if tail else "xla", **jflags), params)
    xs = [_t(x).requires_grad_()] + [_t(r).requires_grad_()
                                     for r in res_list]
    y = ours(xs[0], xs[1:])
    assert y.shape == (b, t, 16 * bh, 16 * bh, 4)
    _close(y, _apply(jm, params, x, res_list))
    if not flags.get("stp_grad"):
        return
    named = dict(ours.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum(), xs + list(named.values()),
                                allow_unused=True)

    def loss(p, x, res_list):
        return jnp.sum(jm.apply(p, x, res_list) ** 2)

    jg_p, jg_x, jg_res = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        params, x, res_list)
    want = [jg_x] + list(jg_res) + [
        flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg_p))[n]
        for n in named]
    names = ["x"] + [f"res_list[{i}]" for i in range(len(res_list))]
    for name, g, w in zip(names + list(named), grads, want):
        w = np.asarray(w)
        if g is None:   # not reached: JAX's gradient is zero
            assert not np.abs(w).any(), name
            continue
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy() / scale, w / scale,
                                   err_msg=name, **TOL)
    # only the flow residual (res_list[0]) takes a gradient
    assert grads[0] is None and all(g is None for g in grads[2:5])


# -- encoder wirings -------------------------------------------------------

# The wirings that no combined configuration of
# tests/test_torch_variants_model.py holds against JAX's whole forward.
ENCODER_WIRINGS = [
    dict(ape=True),
    dict(use_flow=False, large_input=False),
    dict(sep_encode=False, flow_sep=False, large_input=False),
    dict(sep_encode=False, no_map=True, flow_sep=False, large_input=False),
]


@pytest.mark.parametrize("wiring", ENCODER_WIRINGS,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_encoder_wirings_match_jax(wiring):
    """``res_list`` of each wiring against JAX's: the flow residual only
    where a flow stage runs, the map at the input size and no crops without
    ``large_input``, the concatenated patch embed without ``sep_encode``,
    the absolute position embedding (drawn non-zero here) before the patch
    norm."""
    cfg = dataclasses.replace(JCFG, **wiring)
    rng = np.random.RandomState(14)
    h, w = cfg.input_size
    mh, mw = cfg.map_size
    ogm = (rng.rand(2, h, w, 11, 2) > 0.8).astype(np.float32)
    map_img = rng.rand(2, mh, mw, 3).astype(np.float32)
    flow = _rand(rng, 2, h, w, 2)
    kw = dict(img_size=cfg.input_size, patch_size=(4, 4),
              embed_dim=cfg.embed_dim, depths=cfg.depths,
              num_heads=cfg.num_heads, window_size=cfg.window_size,
              mlp_ratio=cfg.mlp_ratio, drop_path_rate=0.0, use_pallas=False,
              **{k: v for k, v in wiring.items()})
    jm = jswin.SwinTransformerEncoder(**kw)
    params = _params(jm, ogm, map_img, flow)
    if cfg.ape:
        pe = params["params"]["absolute_pos_embed"]
        params["params"]["absolute_pos_embed"] = _rand(rng, *pe.shape,
                                                       scale=0.5)
    ours = _load(SwinTransformerEncoder(
        cfg.input_size, 4, cfg.embed_dim, cfg.depths, cfg.num_heads,
        cfg.window_size, cfg.mlp_ratio, kernel_mode=False,
        **{k: v for k, v in wiring.items()}), params)
    with torch.no_grad():
        res = ours(_t(ogm), _t(map_img), _t(flow))
    ref = _apply(jm, params, ogm, map_img, flow)
    assert len(res) == len(ref) == 3 + ours.flow_stage
    _close(res, ref)
