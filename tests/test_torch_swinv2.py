"""STrajNet on a SwinV2 encoder: the port's plain path (on the CPU the
``"block"`` mode runs the plain SwinV2 block) against the benchmark's plain
reference of the architecture (``benchmark/reference/swinv2.py``), in f32,
at a small configuration with SwinV2-B's wiring: four stages, windows of 4
with shifts, two and four heads, one head past the logit scale's clamp.
The weights are drawn as the benchmark draws them (``weights.draw`` with
the reference's rules). The same comparisons fail by far more than their
tolerance for a block with Swin-v1's dot-product attention, with pre-norm,
or without the position bias: the tolerances tell SwinV2 from those.
"""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, pool as pools, weights
from benchmark.reference import loss as ref_loss
from benchmark.reference import swinv2 as ref
from benchmark.reference.model import shift_mask
from strajnet_tpu_torch.config import (STRAJNET_SWINV2_B_CONFIG,
                                       TINY_MODEL_CONFIG)
from strajnet_tpu_torch.models import swin
from strajnet_tpu_torch.models.strajnet import STrajNet

SMALL = dict(input_size=[128, 128], window_size=4, embed_dim=8,
             depths=[2, 2, 2, 2], num_heads=[2, 2, 4, 4], traj_out_dim=32,
             traj_heads=2, att_heads=2, obs_actors=6, occ_actors=2,
             map_segments=8, fgmsa_heads=8, fgmsa_head_channels=8,
             fgmsa_groups=8, dtype="float32")
# f32 against f32, the same operations in another order; the logits are
# cosines times up to 100, so their rounding is up to 100x a cosine's
OUT_TOL = 1e-4      # of the largest output
GRAD_TOL = 1e-3     # of a leaf's largest gradient entry (or the median leaf's)
BLOCK_TOL = 1e-5    # a block's output, of its largest entry
PAST_CLAMP = 5.0    # a logit scale past ln 100


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield


def _model() -> dict:
    spec = harness.load_spec()
    return dict(harness.find_config(spec, "strajnet_swinv2b_bf16")["model"],
                **SMALL)


def _net_and_weights(model: dict, seed: int = 17):
    net = STrajNet(harness.ports_config(model))
    spec = weights.spec_of(net.state_dict())
    p = weights.draw(spec, seed, "cpu", ref.LEAF_RULES)
    tau = "encoder.layers1.blocks1.attn.logit_scale"
    p[tau] = p[tau].clone()
    p[tau][0] = PAST_CLAMP
    net.load_state_dict(p)
    return net, p


def _batch(model: dict, n: int = 2):
    return pools.make_pool(pools.with_sizes(model), n, 1, 9, "cpu", True)[0]


def _run(net, b, generator=None):
    return net(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
               occ=b["occl_actors"], mapt=b["centerlines"],
               flow=b["vec_flow"], generator=generator)


def _gap(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_the_reference(training):
    model = _model()
    net, p = _net_and_weights(model)
    net.train(training)
    b = _batch(model)
    g1 = torch.Generator().manual_seed(5) if training else None
    g2 = torch.Generator().manual_seed(5) if training else None
    with torch.no_grad():
        y = _run(net, b, g1)
        r = ref.forward(p, model, b, generator=g2)
    assert y.shape == r.shape == (2, 64, 64, 32)
    assert _gap(y, r) <= OUT_TOL


def test_loss_gradients_match_the_reference():
    model = _model()
    net, p = _net_and_weights(model)
    net.train()
    b = _batch(model)
    t = model["num_waypoints"]
    y = _run(net, b, torch.Generator().manual_seed(5))
    ref_loss.total(ref_loss.loss_terms(b, y, t)).backward()
    params = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    r = ref.forward(params, model, b,
                    generator=torch.Generator().manual_seed(5))
    ref_loss.total(ref_loss.loss_terms(b, r, t)).backward()
    got = dict(net.named_parameters())
    # each leaf over the larger of its own largest entry and the median
    # leaf's (a key's bias under softmax has a gradient of round-off alone)
    tops = {k: float(v.grad.abs().max()) for k, v in params.items()}
    floor = sorted(tops.values())[len(tops) // 2]
    worst = max((float((got[k].grad - v.grad).abs().max())
                 / max(tops[k], floor), k) for k, v in params.items())
    assert worst[0] <= GRAD_TOL, worst
    tau = "encoder.layers1.blocks1.attn.logit_scale"
    assert float(got[tau].grad[0]) == 0.0 and float(params[tau].grad[0]) == 0
    assert float(got[tau].grad[1:].abs().min()) > 0.0


def _block_case(shift: int = 2):
    """A SwinV2 block at 8x8 tokens, 16 channels, 2 heads, windows of 4,
    head 0 past the clamp; its weights by the reference's rules."""
    torch.manual_seed(0)
    blk = swin.SwinV2TransformerBlock(16, (8, 8), 2, 4, shift, 4.0,
                                      kernel_mode="block")
    spec = weights.spec_of(blk.state_dict())
    p = weights.draw(spec, 3, "cpu", ref.LEAF_RULES)
    p["attn.logit_scale"][0] = PAST_CLAMP
    blk.load_state_dict(p)
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(1))
    return blk, {"b." + k: v for k, v in p.items()}, x


def test_block_position_bias_and_merging_match_the_reference():
    blk, p, x = _block_case()
    with torch.no_grad():
        y = blk(x)
        want = ref.swinv2_block(ref.EXACT, p, "b", x, (8, 8), 2, 4, 2, None)
        assert _gap(y, want) <= BLOCK_TOL
        rel = blk.attn.rel_bias()
        want_rel = ref.position_bias(ref.EXACT, p, "b.attn", 4, 2, "cpu")
        assert _gap(rel, want_rel) <= 1e-6
        # the bias the rules draw moves by several units over positions
        assert float((rel.amax((1, 2)) - rel.amin((1, 2))).min()) > 3.0
        merge = swin.PatchMergingV2((8, 8), 16)
        mp = weights.draw(weights.spec_of(merge.state_dict()), 4, "cpu", {})
        merge.load_state_dict(mp)
        want = ref.patch_merging(ref.EXACT, {"m." + k: v for k, v in
                                             mp.items()}, "m", x, (8, 8))
        assert _gap(merge(x), want) <= 1e-6


def _variant_block(p, x, kind: str):
    """The block of ``_block_case`` computed otherwise: ``"dot"`` Swin-v1's
    scaled dot product in place of the cosine, ``"prenorm"`` LN before the
    attention and the MLP, ``"no_cpb"`` without the position bias."""
    b_, _, c = x.shape
    ws, s, heads, n, hd = 4, 2, 2, 16, 8

    def ln(t, name):
        return F.layer_norm(t, (c,), p[f"b.{name}.weight"],
                            p[f"b.{name}.bias"], 1e-5)

    def attention(t):
        t = torch.roll(t.reshape(b_, 8, 8, c), (-s, -s), (1, 2))
        w = t.reshape(b_, 2, ws, 2, ws, c).permute(0, 1, 3, 2, 4, 5)
        bias = torch.cat([p["b.attn.q_bias"], torch.zeros(c),
                          p["b.attn.v_bias"]])
        qkv = F.linear(w.reshape(-1, n, c), p["b.attn.qkv.weight"], bias)
        q, k, v = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        if kind == "dot":
            a = (q * hd ** -0.5) @ k.transpose(-1, -2)
        else:
            scale = torch.exp(torch.clamp(p["b.attn.logit_scale"],
                                          max=math.log(100.0)))
            a = (F.normalize(q, dim=-1)
                 @ F.normalize(k, dim=-1).transpose(-1, -2)) * scale
        if kind != "no_cpb":
            a = a + ref.position_bias(ref.EXACT, p, "b.attn", ws, heads,
                                      "cpu")[None]
        mask = torch.from_numpy(shift_mask(8, 8, ws, s))
        a = (a.reshape(b_, 4, heads, n, n) + mask[None, :, None]).reshape(
            -1, heads, n, n)
        o = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(-1, n, c)
        o = F.linear(o, p["b.attn.proj.weight"], p["b.attn.proj.bias"])
        o = o.reshape(b_, 2, 2, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        o = torch.roll(o.reshape(b_, 8, 8, c), (s, s), (1, 2))
        return o.reshape(b_, 64, c)

    def mlp(t):
        t = F.gelu(F.linear(t, p["b.mlp.fc1.weight"], p["b.mlp.fc1.bias"]),
                   approximate="tanh")
        return F.linear(t, p["b.mlp.fc2.weight"], p["b.mlp.fc2.bias"])

    if kind == "prenorm":
        r1 = x + attention(ln(x, "norm1"))
        return r1 + mlp(ln(r1, "norm2"))
    r1 = x + ln(attention(x), "norm1")
    return r1 + ln(mlp(r1), "norm2")


@pytest.mark.parametrize("kind", ["dot", "prenorm", "no_cpb"])
def test_block_tolerance_tells_swinv2_from(kind):
    blk, p, x = _block_case()
    with torch.no_grad():
        y = blk(x)
        other = _variant_block(p, x, kind)
        # the variant's own plain form is SwinV2 where kind is off
        assert _gap(y, _variant_block(p, x, "v2")) <= BLOCK_TOL
    assert _gap(other, y) > 100 * BLOCK_TOL


def test_swinv2_b_preset_builds_the_published_encoder():
    cfg = STRAJNET_SWINV2_B_CONFIG
    assert (cfg.output_size, cfg.bottleneck_size, cfg.bottleneck_dim,
            cfg.shallow_decode) == ((256, 256), (8, 8), 1024, 0)
    with torch.device("meta"):
        net = STrajNet(cfg)
    blocks = [m for m in net.modules()
              if isinstance(m, swin.SwinV2TransformerBlock)]
    assert len(blocks) == 26
    assert not any(isinstance(m, swin.SwinTransformerBlock)
                   for m in net.modules())
    assert [b.window_size for b in blocks[-2:]] == [16, 16]
    assert [b.shift_size for b in blocks[-2:]] == [0, 0]
    assert {b.attn.logit_scale.shape[0] for b in blocks} == {4, 8, 16, 32}
    assert hasattr(net.decoder, "upconv_4_0")


@pytest.mark.parametrize("mode", ["attn", "block_fwd", "remat"])
def test_swinv2_blocks_raise_in_swin_v1_only_modes(mode):
    flags = (dict(remat_encoder=True) if mode == "remat"
             else dict(use_pallas_attention=mode))
    cfg = dataclasses.replace(TINY_MODEL_CONFIG, block="swinv2", **flags)
    with pytest.raises(ValueError, match="SwinV2 block"):
        STrajNet(cfg)
