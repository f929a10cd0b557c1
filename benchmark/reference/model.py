"""STrajNet in plain PyTorch, float32: the benchmark's reference forward.

A frozen, independent statement of what the served and trained model
computes, for the wirings the benchmark's configurations use: the separate
patch embeds of the vehicle OGM, the map and the flow, the flow through a
Swin stage of its own, the 512² rasters with the 256² map padded into the
centre of the patch grid (``sep_encode``, ``flow_sep``, ``use_flow``,
``large_input``); FG-MSA with its flow head or none (``fg_msa``, ``fg``;
``deform_kv`` off, as in the reference); TrajNet's per-waypoint
cross-attention with the actors only; the pyramid decoder with its separate
flow head (``use_pyramid``, ``flow_sep_decode``, ``rep_res``). Any other
flag raises.

Parameters come as a ``{name: tensor}`` dict under the names of the
program's ``state_dict`` (the weights the benchmark draws and hands to both
sides, by ``LEAF_RULES`` for this architecture's own leaves); nothing here
reads the program. Every product goes through a
:class:`~benchmark.reference.prec.Prec`; everything else is float32. The
random parts of training mode (stochastic depth in the Swin blocks, dropout
0.1 in TrajNet) draw from the generator they are handed, each mask one
``torch.rand`` of the mask's shape, in the order of the forward: the same
draws the program makes from a generator of the same seed. That order is
a rule the program keeps: a program that draws its masks otherwise is
compared on other noise and fails the training cells.
``benchmark/tests/test_bench_reference.py`` holds the two orders together
(the training-mode forward, program against reference, on one seed).

The forms here are the plain ones: a window partition and a dense softmax
for the Swin attention, FG-MSA's rel-pos bias by a four-corner gather of
its table. The decoder's upsampling convolutions take the phase form (one
transposed convolution of a composed kernel), which needs the products the
work counts count and computes what nearest upsampling and a 3x3
convolution compute.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.prec import EXACT, Prec

Params = Dict[str, torch.Tensor]
DROPOUT = 0.1
FIXED = dict(sep_encode=True, flow_sep=True, use_flow=True, no_map=False,
             large_input=True, ape=False, patch_norm=True, actor_only=True,
             sep_actors=False, deform_kv=False, use_pyramid=True,
             flow_sep_decode=True, conv_cnn=False, sep_conv=False,
             rep_res=True, stp_grad=False, drop_rate=0.0,
             attn_drop_rate=0.0, qkv_bias=True)


TABLE_STD = 1.0      # relative-position tables: TABLE_STD z


def _table(u, z):
    return TABLE_STD * torch.clamp(z, -2.0, 2.0)


# The weights of this architecture's own leaves, by name suffix
# (benchmark/weights.py): the relative-position tables, the Swin blocks' and
# FG-MSA's, at the scale of the attention logits they add to, so that a
# forward which ignores them gives other outputs (at Swin's N(0, 0.02) a
# Swin block that skipped its table would compute the same).
LEAF_RULES = {"relative_position_bias_table": _table, "rpe_table": _table}

# The leaves that benchmark/faults.py's weight faults set, as (a part of the
# name, its suffixes, the value): the Swin blocks' tables zero, their
# LayerNorms' scales one.
FAULT_LEAVES = {
    "no_relpos": (".blocks", ("relative_position_bias_table",), 0.0),
    "no_ln_scale": (".blocks", ("norm1.weight", "norm2.weight"), 1.0),
}


def check_config(cfg: dict) -> None:
    """Raises on a wiring this reference does not state."""
    for key, want in FIXED.items():
        if cfg[key] != want:
            raise ValueError(f"the reference states {key}={want}, the "
                             f"configuration has {cfg[key]!r}")


class Noise:
    """The training mode's random draws: ``torch.rand`` from ``generator``
    on ``device``; no generator means inference (no noise)."""

    def __init__(self, generator: Optional[torch.Generator], device):
        self.generator, self.device = generator, device

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        u = torch.rand(x.shape, device=self.device, generator=self.generator)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def drop_path(self, batch: int, rate: float) -> Optional[torch.Tensor]:
        """``[B, 2]``: each residual branch's keep-scaled multiplier."""
        if self.generator is None or rate == 0.0:
            return None
        keep = 1.0 - rate
        draws = [torch.floor(keep + torch.rand((batch,), device=self.device,
                                               generator=self.generator))
                 / keep for _ in range(2)]
        return torch.stack(draws, dim=1)


def layer_norm(x, p: Params, pre: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[pre + ".weight"],
                        p[pre + ".bias"], eps)


def dense(P: Prec, p: Params, pre: str, x):
    return P.linear(x, p[pre + ".weight"], p.get(pre + ".bias"))


# -- Swin encoder -----------------------------------------------------------

def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(h: int, w: int, ws: int, s: int) -> np.ndarray:
    """The SW-MSA mask ``[windows, n, n]``: -100 between cells of different
    shift regions of one rolled window, else 0."""
    img = np.zeros((h, w), np.float32)
    cuts = (slice(0, -ws), slice(-ws, -s), slice(-s, None))
    label = 0
    for hs in cuts:
        for wsl in cuts:
            img[hs, wsl] = label
            label += 1
    m = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).astype(
        np.float32)


def swin_block(P: Prec, p: Params, pre: str, x, res, heads: int, ws: int,
               shift: int, dp: Optional[torch.Tensor]):
    """LN -> (shifted) window MHA -> residual -> LN -> MLP -> residual, on
    ``[B, h*w, C]``."""
    h, w = res
    b, _, c = x.shape
    n, hd = ws * ws, c // heads
    xb = x.reshape(b, h, w, c)
    if shift:
        xb = torch.roll(xb, (-shift, -shift), (1, 2))
    xn = layer_norm(xb, p, pre + ".norm1", 1e-5)
    xw = xn.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    qkv = dense(P, p, pre + ".attn.qkv", xw.reshape(-1, n, c))
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = P.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    rpi = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(
        x.device)
    table = p[pre + ".attn.relative_position_bias_table"]
    attn = attn + table[rpi].reshape(n, n, heads).permute(2, 0, 1)[None]
    if shift:
        mask = torch.from_numpy(shift_mask(h, w, ws, shift)).to(x.device)
        nw = mask.shape[0]
        attn = (attn.reshape(-1, nw, heads, n, n)
                + mask[None, :, None]).reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = P.matmul(attn, v).transpose(1, 2).reshape(-1, n, c)
    out = dense(P, p, pre + ".attn.proj", out)
    out = out.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, h, w, c)
    one = torch.ones(b, 1, 1, 1, device=x.device)
    d0 = one if dp is None else dp[:, 0, None, None, None]
    d1 = one if dp is None else dp[:, 1, None, None, None]
    r1 = xb + d0 * out
    y = layer_norm(r1, p, pre + ".norm2", 1e-5)
    y = F.gelu(dense(P, p, pre + ".mlp.fc1", y), approximate="tanh")
    y = r1 + d1 * dense(P, p, pre + ".mlp.fc2", y)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y.reshape(b, h * w, c)


def patch_merging(P: Prec, p: Params, pre: str, x, res):
    h, w = res
    c = x.shape[-1]
    x = x.reshape(-1, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).reshape(-1, h * w // 4, 4 * c)
    return dense(P, p, pre + ".reduction", layer_norm(x, p, pre + ".norm",
                                                      1e-5))


def swin_stage(P: Prec, p: Params, pre: str, cfg: dict, noise: Noise, x,
               i: int, rates, downsample: bool):
    res = (cfg["pr"] // 2 ** i,) * 2
    ws, shift = cfg["window_size"], cfg["window_size"] // 2
    if res[0] <= ws:
        ws, shift = res[0], 0
    for j in range(cfg["depths"][i]):
        dp = noise.drop_path(x.shape[0], rates[j])
        x = swin_block(P, p, f"{pre}.blocks{j}", x, res, cfg["num_heads"][i],
                       ws, shift if j % 2 else 0, dp)
    skip = x
    if downsample:
        x = patch_merging(P, p, pre + ".downsample", x, res)
    return x, skip


def patch_embed(P: Prec, p: Params, pre: str, x, patch: int):
    y = P.conv2d(x, p[pre + ".proj.weight"], p[pre + ".proj.bias"],
                 stride=patch)
    y = y.reshape(y.shape[0], -1, y.shape[-1])
    return layer_norm(y, p, pre + ".norm", 1e-5)


def centre_crop(t, grid: int, dim: int):
    lo, hi = grid // 4, (3 * grid) // 4
    t = t.reshape(-1, grid, grid, dim)[:, lo:hi, lo:hi]
    return t.reshape(-1, (grid // 2) ** 2, dim)


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


# -- FG-MSA -------------------------------------------------------------

def ref_points(h: int, w: int, device) -> torch.Tensor:
    """``[W, H, 2]`` grid, ``ref[i, j] = (j, i)`` (tf.meshgrid's xy order)."""
    jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="xy")
    return torch.stack((jj, ii), dim=-1)


def bilinear(grid, query):
    """TF-Addons bilinear interpolation, (x, y) queries ``[B, N, 2]`` into
    ``[B, H, W, C]``: floors clamped to ``[0, size - 2]``, weights to
    ``[0, 1]``."""
    b, h, w, c = grid.shape
    n = query.shape[1]
    floors, alphas = [], []
    for dim, size in ((1, h), (0, w)):
        q = query[..., dim]
        fl = torch.clamp(torch.floor(q), 0.0, float(size - 2))
        floors.append(fl.long())
        alphas.append(torch.clamp(q - fl, 0.0, 1.0)[..., None])
    flat = grid.reshape(b * h * w, c)
    base = (torch.arange(b, device=grid.device) * (h * w))[:, None]

    def at(y, x):
        return flat[(base + y * w + x).reshape(-1)].reshape(b, n, c)

    y0, x0 = floors
    tl, tr = at(y0, x0), at(y0, x0 + 1)
    bl, br = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    top = alphas[1] * (tr - tl) + tl
    bottom = alphas[1] * (br - bl) + bl
    return alphas[0] * (bottom - top) + top


def sample(image, warp):
    """Bilinear sampling of ``[B, H, W, C]`` at (x, y) ``warp [B, ..., 2]``
    with integer pixel centres and a zero border."""
    image = F.pad(image, (0, 0, 1, 1, 1, 1))
    b = warp.shape[0]
    flat = bilinear(image, (warp + 1.0).reshape(b, -1, 2))
    return flat.reshape(warp.shape[:-1] + (image.shape[-1],))


def fgmsa(P: Prec, p: Params, cfg: dict, x):
    """x ``[B, h, w, C]`` -> (y ``[B, h, w, C]``, flow head ``[B, G, h, w,
    C]`` or None)."""
    pre = "fg_msa_layer"
    g, nh = cfg["fgmsa_groups"], cfg["fgmsa_heads"]
    hc = cfg["fgmsa_head_channels"]
    nc = nh * hc
    cg = nc // g
    b, h, w, c = x.shape
    n = h * w

    def conv1x1(name, t):
        wt = p[f"{pre}.{name}.weight"].flatten(1)
        return P.linear(t, wt, p.get(f"{pre}.{name}.bias"))

    q = conv1x1("proj_q", x)
    off = P.conv2d(q, p[pre + ".conv_offset_0.weight"],
                   p[pre + ".conv_offset_0.bias"], padding=1, groups=g)
    off = F.gelu(layer_norm(off, p, pre + ".conv_norm", 1e-3),
                 approximate="tanh")
    off = off.reshape(b, h, w, g, cg).permute(0, 3, 1, 2, 4)
    offset = conv1x1("conv_offset_proj", off.reshape(-1, h, w, cg))
    offset = torch.tanh(offset) * torch.tensor([h / 2.0, w / 2.0],
                                               device=x.device)
    flow_hidden = (conv1x1("conv_offset_proj2", offset.reshape(b, g, h, w, 2))
                   if cfg["fg"] else None)
    pos = offset + ref_points(h, w, x.device).expand(b * g, h, w, 2)

    def heads(t):
        return t.reshape(b, n, nh, hc).permute(0, 2, 1, 3).reshape(
            b * nh, n, hc)

    xs = x.reshape(b, n, 1, c)
    qh, kh, vh = heads(q), heads(conv1x1("proj_k", xs)), heads(
        conv1x1("proj_v", xs))
    attn = P.einsum("bqc,bkc->bqk", qh, kh) * hc ** -0.5
    # the rel-pos table sampled at q_grid[q] - pos[k], (x, y) swapped
    rpe = p[pre + ".rpe_table"].reshape(2 * h - 1, 2 * w - 1, g, nh // g)
    rpe = rpe.permute(2, 0, 1, 3)[None].expand(b, -1, -1, -1, -1)
    rpe = rpe.reshape(b * g, 2 * h - 1, 2 * w - 1, nh // g)
    posk = pos.reshape(b * g, n, 2)
    disp = ref_points(h, w, x.device).reshape(1, n, 1, 2) - posk[:, None]
    warp = torch.stack((disp[..., 1], disp[..., 0]), dim=-1)
    bias = sample(rpe, warp).reshape(b * g, n, n, nh // g)
    attn = attn + bias.permute(0, 3, 1, 2).reshape(b * nh, n, n)
    attn = torch.softmax(attn, dim=2)
    out = P.einsum("bkv,bvc->bck", attn, vh).reshape(b, c, h, w)
    y = conv1x1("proj_out", out.permute(0, 2, 3, 1))
    return y, flow_hidden


# -- TrajNet ------------------------------------------------------------

def mha(P: Prec, p: Params, pre: str, noise: Noise, query, key, mask=None):
    """TF-Addons multi-head attention: per-head kernels ``[heads, in, d]``,
    a multiplicative {0, 1} mask as ``-1e10 * (1 - mask)``, dropout 0.1 on
    the attention weights, a bias on the output projection only."""
    d = p[pre + ".query_kernel"].shape[-1]
    q = P.einsum("...ni,hio->...nho", query, p[pre + ".query_kernel"])
    k = P.einsum("...mi,hio->...mho", key, p[pre + ".key_kernel"])
    v = P.einsum("...mi,hio->...mho", key, p[pre + ".value_kernel"])
    logits = P.einsum("...nho,...mho->...hnm", q * d ** -0.5, k)
    if mask is not None:
        mask = mask.float()
        if mask.dim() < logits.dim():
            mask = mask.unsqueeze(-3)
        logits = logits + (-1e10) * (1.0 - mask)
    attn = noise.dropout(torch.softmax(logits, dim=-1), DROPOUT)
    out = P.einsum("...hnm,...mho->...nho", attn, v)
    out = P.einsum("...nho,hoi->...ni", out, p[pre + ".projection_kernel"])
    return out + p[pre + ".projection_bias"]


def cross_block(P: Prec, p: Params, pre: str, noise: Noise, query, key,
                mask):
    """Post-LN cross-attention: MHA -> LN -> FFN (elu) -> LN, dropout 0.1
    on the FFN's hidden layer and output."""
    v = layer_norm(mha(P, p, pre + ".mha", noise, query, key, mask), p,
                   pre + ".norm1", 1e-3)
    v = noise.dropout(F.elu(dense(P, p, pre + ".FFN1", v)), DROPOUT)
    v = noise.dropout(dense(P, p, pre + ".FFN2", v), DROPOUT)
    return layer_norm(v, p, pre + ".norm2", 1e-3)


def track_encoder(P: Prec, p: Params, noise: Noise, tracks, mask):
    """PointNet-style track encoder: a dense over the 5 kinematic features,
    masked MHA over the steps, max-pool, the type one-hot of step 0."""
    pre = "trajnet_attn.traj_net.traj_encoder.enc"
    m = mask.float()
    nodes = F.elu(dense(P, p, pre + ".node_feature", tracks[:, :, :5]))
    nodes = mha(P, p, pre + ".node_attention", noise, nodes, nodes,
                m[:, :, None] * m[:, None, :])
    nodes = nodes.max(dim=1).values
    vector = dense(P, p, pre + ".vector_feature", tracks[:, 0, 5:])
    return F.elu(dense(P, p, pre + ".sublayer",
                       torch.cat([nodes, vector], dim=1)))


def trajnet(P: Prec, p: Params, cfg: dict, noise: Noise, query, obs, occ):
    """query ``[B, T, h*w, D]`` -> ``[B, T, h*w, D]``."""
    pre = "trajnet_attn.traj_net"
    b, t = query.shape[:2]
    n_obs, out_dim = cfg["obs_actors"], cfg["traj_out_dim"]
    tracks = torch.cat([obs, occ], dim=1)
    steps, feats = tracks.shape[2:]
    valid = tracks[..., 0] != 0
    enc = track_encoder(P, p, noise, tracks.reshape(-1, steps, feats),
                        valid.reshape(-1, steps)).reshape(b, -1, out_dim)
    n_all = enc.shape[1]
    code = torch.zeros(n_all, 2, device=query.device)
    code[:n_obs, 0] = 1.0
    code[n_obs:, 1] = 1.0
    embed = dense(P, p, pre + ".seg_embed", code)[None].expand(b, -1, -1)
    actor = valid.sum(-1).ne(0).float()                # [B, actors]
    concat = actor[:, :, None] * enc
    val = cross_block(P, p, pre + ".cross_attention", noise, concat + embed,
                      concat, actor[:, :, None] * actor[:, None, :])
    obs_f = layer_norm(enc[:, :n_obs] + val[:, :n_obs] + embed[:, :n_obs], p,
                       pre + ".obs_norm", 1e-3)
    occ_f = layer_norm(enc[:, n_obs:] + val[:, n_obs:] + embed[:, n_obs:], p,
                       pre + ".occ_norm", 1e-3)
    key = torch.cat([obs_f, occ_f], dim=1)
    mask = actor[:, None, :].expand(-1, query.shape[2], -1)
    o = torch.stack([cross_block(P, p, f"trajnet_attn.cross_attn_obs.{k}",
                                 noise, query[:, k], key, mask)
                     for k in range(t)], dim=1)
    return o + query


# -- decoder ------------------------------------------------------------

def upconv(P: Prec, p: Params, pre: str, x):
    """Nearest 2x upsampling, then a 3x3 SAME convolution, of ``[N, H, W,
    C]`` (before the activation), in the phase form that the work counts
    take: each upsampled pixel reads 2x2 input taps, so the two are one
    stride-2 transposed convolution with the 4x4 kernel ``K[u, v] = sum over
    a, b in {0, 1} of W[u - a, v - b]``."""
    w3 = p[pre + ".conv.weight"]                     # [out, in, 3, 3]
    k4 = w3.new_zeros(w3.shape[:2] + (4, 4))
    for a in (0, 1):
        for b in (0, 1):
            k4[:, :, a:a + 3, b:b + 3] += w3
    y = P.conv_transpose2d(x, k4.flip(2, 3).transpose(0, 1), 2, 1)
    return y + p[pre + ".conv.bias"]


def up_stage(P: Prec, p: Params, pre: str, x):
    b, t, h, w, c = x.shape
    y = F.elu(upconv(P, p, pre, x.reshape(b * t, h, w, c)))
    return y.reshape(b, t, 2 * h, 2 * w, -1)


def temporal_conv(P: Prec, p: Params, pre: str, x, t: int):
    """Conv3D with kernel (t, 1, 1), SAME over the waypoints, of a
    time-constant ``[B, H, W, C]`` input, then elu: ``[B, T, H, W, F]``."""
    kernel = p[pre + ".kernel"]                     # [kt, C, F]
    kt = kernel.shape[0]
    lo = (kt - 1) // 2
    taps = [kernel[[d for d in range(kt) if 0 <= o + d - lo < t]].sum(0)
            for o in range(t)]                      # each [C, F]
    y = P.einsum("bhwc,ocf->bohwf", x, torch.stack(taps))
    return F.elu(y + p[pre + ".bias"])


def tail(P: Prec, p: Params, up: str, out: str, x):
    """Last upconv -> elu -> 3x3 output conv of a branch, ``[B, T, H, W,
    C]`` -> ``[B, T, 2H, 2W, 2]``."""
    b, t, h, w, c = x.shape
    e = F.elu(upconv(P, p, up, x.reshape(b * t, h, w, c)))
    o = P.conv2d(e, p[out + ".weight"], p[out + ".bias"], padding=1)
    return o.reshape(b, t, 2 * h, 2 * w, -1)


def decoder(P: Prec, p: Params, cfg: dict, x, res_list):
    """``[B, T, h, w, D]`` at the bottleneck and the encoder's skips ->
    ``[B, T, 16h, 16w, 4]`` (observed, occluded, dx, dy): three stages of
    upsampling with the skips added after the first two, then the two
    tails."""
    t, side = cfg["num_waypoints"], 2 * cfg["bottleneck"]
    flow_res, skips = res_list[0], res_list[1:]

    def skip(r, rd):
        return r.reshape(-1, rd, rd, r.shape[-1])

    d = "decoder"
    x = up_stage(P, p, f"{d}.upconv_3_0", x)
    x = x + temporal_conv(P, p, f"{d}.resconv_3", skip(skips[1], side), t)
    x = up_stage(P, p, f"{d}.upconv_2_0", x)
    x = x + temporal_conv(P, p, f"{d}.resconv_2", skip(skips[0], 2 * side),
                          t)
    flow_x = x + temporal_conv(P, p, f"{d}.resconv_f",
                               skip(flow_res, 2 * side), t)
    x = up_stage(P, p, f"{d}.upconv_1_0", x)
    occ = tail(P, p, f"{d}.upconv_0_0", f"{d}.outconv", x)
    f = up_stage(P, p, f"{d}.upconvf_1_0", flow_x)
    fo = tail(P, p, f"{d}.upconvf_0_0", f"{d}.outconv_f", f)
    return torch.cat([occ, fo], dim=-1)


# -- the model ----------------------------------------------------------

def derived(cfg: dict) -> dict:
    """The configuration with the sizes the forward reads off it."""
    out = dict(cfg)
    out["pr"] = cfg["input_size"][0] // cfg["patch_size"]
    out["bottleneck"] = out["pr"] // 2 ** (len(cfg["depths"]) - 1) // 2
    out["bottleneck_dim"] = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
    return out


def forward(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
            P: Prec = EXACT, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Logits and flow ``[B, 256, 256, T*4]`` (channel ``k*4 + {0:
    observed, 1: occluded, 2: dx, 3: dy}``) of a batch with the parsed
    record's keys; training-mode noise from ``generator`` where given."""
    check_config(cfg)
    cfg = derived(cfg)
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
