"""STrajNet on a SwinV2 encoder in plain PyTorch, float32: the reference
forward of the configurations that name ``"reference": "swinv2.py"``.

A frozen, independent statement of the model, for the wiring of
``model.py`` (its ``FIXED`` flags) with SwinV2's blocks (arXiv 2111.09883;
``microsoft/Swin-Transformer``, ``models/swin_transformer_v2.py``) in the
encoder, any number of stages, and the pyramid decoder with one upsampling
stage more per stage past three (``shallow_decode`` 0 at four stages: five
up-stages from the bottleneck, the skips added after the first three).
FG-MSA, TrajNet, the noise and the decoder's stage helpers are
``model.py``'s, imported, not copied. A SwinV2 block:

    q, k, v = x W_qkv + (q_bias, 0, v_bias)
    A   = softmax(cos(q, k) exp(min(tau_h, ln 100)) + 16 sigmoid(T[rpi])
                  + mask)
    r1  = x + dp1 * LN1(proj(A v))
    out = r1 + dp2 * LN2(fc2(gelu(fc1(r1))))

with ``T = cpb_mlp(coords)`` (Linear(2, 512) -> ReLU -> Linear(512, heads)
without bias) over the ``(2W-1)^2`` relative offsets, each over ``W - 1``,
times 8, then ``sign(t) log2(|t| + 1) / log2(8)``; patch merging reduces 4C
-> 2C and then normalises.

Departures from the published code: the MLP's gelu is the tanh
approximation (the program's, and ``model.py``'s, everywhere); the bias
MLP runs in float32 through the products' precision like every other
product; no pretrained window size (``pretrained_window_size`` 0); no final
norm (STrajNet takes each stage's output); the window shrinks to a stage's
side where the side is no larger, and the shift goes, as in Swin-v1. Each
block is recomputed in the backward (:func:`recomputed`), which changes no
number.

Parameters come under the names of the program's ``state_dict``
(``models/swin.py``'s ``SwinV2TransformerBlock``: ``attn.logit_scale``,
``attn.cpb_mlp.{0,2}``, ``attn.q_bias``, ``attn.v_bias``, ``attn.qkv``,
``attn.proj``, ``norm1``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import model as base
from benchmark.reference.model import (Noise, Params, centre_crop, dense,
                                       fgmsa, layer_norm, patch_embed,
                                       relative_position_index, shift_mask,
                                       tail, temporal_conv, trajnet,
                                       up_stage)
from benchmark.reference.prec import EXACT, Prec

FIXED = dict(base.FIXED, block="swinv2")
LOGIT_MAX = math.log(100.0)
TAU_SPREAD = 2.5     # logit scales: ln 10 + TAU_SPREAD u
CPB_STD = 0.5        # the bias MLP's output layer: CPB_STD z


def _tau(u, z):
    return math.log(10.0) + TAU_SPREAD * u


def _cpb(u, z):
    return CPB_STD * torch.clamp(z, -2.0, 2.0)


# The weights of this architecture's own leaves, by name suffix
# (benchmark/weights.py): the logit scales around the initialiser's ln 10,
# spread so that heads differ and about one in twenty lies past the clamp
# at ln 100 (where its gradient is zero); the bias MLP's output layer at a
# scale where 16 sigmoid(T) moves by several units over the positions
# (Glorot's would leave it near 8 everywhere, and a block that skipped the
# bias would compute about the same).
LEAF_RULES = {"logit_scale": _tau, "cpb_mlp.2.weight": _cpb}

# benchmark/faults.py's weight faults: the bias MLP's output layer zero (B
# = 8 at every position, which softmax ignores), the post-norms' scales one.
FAULT_LEAVES = {
    "no_relpos": (".blocks", ("cpb_mlp.2.weight",), 0.0),
    "no_ln_scale": (".blocks", ("norm1.weight", "norm2.weight"), 1.0),
}


def check_config(cfg: dict) -> None:
    """Raises on a wiring this reference does not state."""
    for key, want in FIXED.items():
        if cfg.get(key) != want:
            raise ValueError(f"the reference states {key}={want}, the "
                             f"configuration has {cfg.get(key)!r}")


# -- SwinV2 encoder ---------------------------------------------------------

def coords_table(ws: int, device) -> torch.Tensor:
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32, device=device)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)
    t = t / (ws - 1) * 8.0
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)


def position_bias(P: Prec, p: Params, pre: str, ws: int, heads: int,
                  device) -> torch.Tensor:
    """``[heads, n, n]``: 16 sigmoid of the bias MLP's table, gathered."""
    n = ws * ws
    h = F.relu(dense(P, p, pre + ".cpb_mlp.0", coords_table(ws, device)))
    table = dense(P, p, pre + ".cpb_mlp.2", h).reshape(-1, heads)
    rpi = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(
        device)
    rel = table[rpi].reshape(n, n, heads).permute(2, 0, 1)
    return 16.0 * torch.sigmoid(rel)


def swinv2_block(P: Prec, p: Params, pre: str, x, res, heads: int, ws: int,
                 shift: int, dp: Optional[torch.Tensor]):
    """(shifted) window cosine MHA -> LN -> residual -> MLP -> LN ->
    residual, on ``[B, h*w, C]``."""
    h, w = res
    b, _, c = x.shape
    n, hd = ws * ws, c // heads
    a = pre + ".attn"
    xb = x.reshape(b, h, w, c)
    if shift:
        xb = torch.roll(xb, (-shift, -shift), (1, 2))
    xw = xb.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    bias = torch.cat([p[a + ".q_bias"], torch.zeros_like(p[a + ".v_bias"]),
                      p[a + ".v_bias"]])
    qkv = P.linear(xw.reshape(-1, n, c), p[a + ".qkv.weight"], bias)
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = P.matmul(F.normalize(q, dim=-1),
                    F.normalize(k, dim=-1).transpose(-1, -2))
    scale = torch.exp(torch.clamp(p[a + ".logit_scale"], max=LOGIT_MAX))
    attn = attn * scale + position_bias(P, p, a, ws, heads, x.device)[None]
    if shift:
        mask = torch.from_numpy(shift_mask(h, w, ws, shift)).to(x.device)
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, n, n)
                + mask[None, :, None]).reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = P.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
    out = dense(P, p, a + ".proj", out)
    out = out.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, h, w, c)
    one = torch.ones(b, 1, 1, 1, device=x.device)
    d0 = one if dp is None else dp[:, 0, None, None, None]
    d1 = one if dp is None else dp[:, 1, None, None, None]
    r1 = xb + d0 * layer_norm(out, p, pre + ".norm1", 1e-5)
    y = F.gelu(dense(P, p, pre + ".mlp.fc1", r1), approximate="tanh")
    y = r1 + d1 * layer_norm(dense(P, p, pre + ".mlp.fc2", y), p,
                             pre + ".norm2", 1e-5)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y.reshape(b, h * w, c)


def recomputed(block, *args):
    """``block(*args)``, recomputed in the backward where gradients are
    taken (``torch.utils.checkpoint``): the same numbers, with the memory
    of one block's intermediates at a time (the 256-token windows' f32
    logits and softmax of 26 blocks at batch 16 fill the card, the fp8
    control's rounded copies on top). Not on the ``meta`` device, where
    the step's FLOPs are counted, so that a block counts once."""
    x = args[3]
    if x.device.type == "meta" or not torch.is_grad_enabled():
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False)


def patch_merging(P: Prec, p: Params, pre: str, x, res):
    h, w = res
    c = x.shape[-1]
    x = x.reshape(-1, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).reshape(-1, h * w // 4, 4 * c)
    return layer_norm(dense(P, p, pre + ".reduction", x), p, pre + ".norm",
                      1e-5)


def swin_stage(P: Prec, p: Params, pre: str, cfg: dict, noise: Noise, x,
               i: int, rates, downsample: bool):
    res = (cfg["pr"] // 2 ** i,) * 2
    ws, shift = cfg["window_size"], cfg["window_size"] // 2
    if res[0] <= ws:
        ws, shift = res[0], 0
    for j in range(cfg["depths"][i]):
        dp = noise.drop_path(x.shape[0], rates[j])
        x = recomputed(swinv2_block, P, p, f"{pre}.blocks{j}", x, res,
                       cfg["num_heads"][i], ws, shift if j % 2 else 0, dp)
    skip = x
    if downsample:
        x = patch_merging(P, p, pre + ".downsample", x, res)
    return x, skip


def encoder(P: Prec, p: Params, cfg: dict, noise: Noise, ogm, map_img,
            flow) -> List[torch.Tensor]:
    e, pr, ps = cfg["embed_dim"], cfg["pr"], cfg["patch_size"]
    depths = cfg["depths"]
    dpr = np.linspace(0.0, cfg["drop_path_rate"], sum(depths)).tolist()

    def rates(i):
        return dpr[sum(depths[:i]):sum(depths[:i + 1])]

    n_stages = len(depths)
    f = patch_embed(P, p, "encoder.patch_embed_flow", flow, ps)
    f = layer_norm(f, p, "encoder.flow_norm", 1e-5)
    flow_x, flow_res = swin_stage(P, p, "encoder.flow_layer", cfg, noise, f,
                                  0, rates(0), n_stages > 1)
    x = patch_embed(P, p, "encoder.patch_embed_vehicle", ogm[..., 0], ps)
    maps = patch_embed(P, p, "encoder.patch_embed_map", map_img, ps)
    mg, pad = pr // 2, pr // 4
    maps = F.pad(maps.reshape(-1, mg, mg, e), (0, 0, pad, pad, pad, pad))
    x = layer_norm(x + maps.reshape(-1, pr * pr, e), p,
                   "encoder.all_patch_norm", 1e-5)
    res_list = []
    for i in range(n_stages):
        x, skip = swin_stage(P, p, f"encoder.layers{i}", cfg, noise, x, i,
                             rates(i), i < n_stages - 1)
        if i == 0:
            x = x + flow_x
            res_list.append(centre_crop(flow_res, pr, e))
        res_list.append(centre_crop(skip, pr // 2 ** i, e * 2 ** i))
    return res_list


# -- decoder ------------------------------------------------------------

def decoder(P: Prec, p: Params, cfg: dict, x, res_list):
    """``[B, T, h, w, D]`` at the bottleneck and the encoder's skips ->
    ``[B, T, 2^(S+1) h, 2^(S+1) w, 4]`` for S >= 3 stages: S - 1
    upsampling stages ``upconv_{S}_0`` .. ``upconv_2_0`` with the skips of
    stages S - 2 .. 0 added after them, the flow's skip after the last of
    them, then ``upconv_1_0`` and the occupancy tail, ``upconvf_1_0`` and
    the flow tail."""
    t, side = cfg["num_waypoints"], 2 * cfg["bottleneck"]
    flow_res, skips = res_list[0], res_list[1:]
    stages = len(cfg["depths"])

    def skip(r, rd):
        return r.reshape(-1, rd, rd, r.shape[-1])

    d = "decoder"
    for i, di in enumerate(range(stages, 1, -1)):
        x = up_stage(P, p, f"{d}.upconv_{di}_0", x)
        x = x + temporal_conv(P, p, f"{d}.resconv_{di}",
                              skip(skips[stages - 2 - i], side * 2 ** i), t)
    flow_x = x + temporal_conv(P, p, f"{d}.resconv_f",
                               skip(flow_res, side * 2 ** (stages - 2)), t)
    x = up_stage(P, p, f"{d}.upconv_1_0", x)
    occ = tail(P, p, f"{d}.upconv_0_0", f"{d}.outconv", x)
    f = up_stage(P, p, f"{d}.upconvf_1_0", flow_x)
    fo = tail(P, p, f"{d}.upconvf_0_0", f"{d}.outconv_f", f)
    return torch.cat([occ, fo], dim=-1)


# -- the model ----------------------------------------------------------

def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
            P: Prec = EXACT, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Logits and flow ``[B, H, W, T*4]`` (channel ``k*4 + {0: observed,
    1: occluded, 2: dx, 3: dy}``) of a batch with the parsed record's keys;
    training-mode noise from ``generator`` where given."""
    check_config(cfg)
    cfg = base.derived(cfg)
    noise = Noise(generator, batch["ogm"].device)
    t, bh = cfg["num_waypoints"], cfg["bottleneck"]
    bd = cfg["bottleneck_dim"]
    res_list = encoder(P, p, cfg, noise, batch["ogm"].float(),
                       batch["map_image"].float(), batch["vec_flow"].float())
    q = res_list[-1]
    flow_hidden = None
    if cfg["fg_msa"]:
        q4 = q.reshape(-1, bh, bh, bd)
        y, flow_hidden = fgmsa(P, p, cfg, q4)
        q = (y + q4).reshape(-1, bh * bh, bd)
    query = q[:, None].repeat(1, t, 1, 1)
    if cfg["fg_msa"] and cfg["fg"]:
        query = flow_hidden.reshape(-1, t, bh * bh, bd) + query
    v = trajnet(P, p, cfg, noise, query, batch["actors"].float(),
                batch["occl_actors"].float())
    y = decoder(P, p, cfg, v.reshape(-1, t, bh, bh, bd), res_list)
    _, _, oh, ow, c = y.shape
    return y.permute(0, 2, 3, 1, 4).reshape(-1, oh, ow, t * c)
