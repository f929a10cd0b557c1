"""STrajNet top-level model.

Counterpart of ``strajnet_tpu/models/strajnet.py``: Swin encoder -> FG-MSA
over the bottleneck (``fg_msa``) -> waypoint-repeated query plus the
flow-head injection (``fg``) -> per-waypoint cross-attention with the
actors (and the centerlines, ``actor_only=False``) -> 3D pyramid decoder ->
waypoint-major output ``[B, H, W, T*4]`` (channel ``k*4 + {0: observed,
1: occluded, 2: dx, 3: dy}``), f32.

Every flag of ``ModelConfig`` is ported: the encoder wirings (``sep_encode``, ``flow_sep``, ``use_flow``, ``no_map``, ``large_input``,
``ape``, ``patch_norm``), the fusion (``actor_only``, ``sep_actors``),
FG-MSA (``fg_msa``, ``fg``, ``deform_kv``) and the decoder
(``use_pyramid``, ``flow_sep_decode``, ``conv_cnn``, ``sep_conv``,
``rep_res``, ``stp_grad``), in inference and in training mode (dropout and
drop-path noise from an explicit generator). A variant is
``dataclasses.replace(STRAJNET_CONFIG, ...)``. Where the JAX package cannot
run a combination of flags (shapes that do not meet, a flow branch that is
not there), the port raises too, at construction or in the forward. As in
the JAX package, ``fg`` is ignored without ``fg_msa``. ``spatial_shard``
adds JAX's sharding hints: under a mesh with a ``'model'`` axis
(``parallel/mesh.py``) the encoder's tokens after every Swin block and the
decoder's upsampled volumes record the split over ``'model'`` that JAX
lays out and stay whole (nothing computes on a split activation yet), so
the forward is the same with and without it; without such an axis the
hints return their input, as in JAX.

The forward marks its four layers with ``tracing.span``
(``strajnet.encoder``, ``strajnet.fg_msa``, ``strajnet.trajnet``,
``strajnet.decoder``), recorded only while a ``torch.profiler`` runs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from strajnet_tpu_torch.config import ModelConfig
from strajnet_tpu_torch.models.decoder import (ConvLSTM2D, Pyramid3DDecoder,
                                               TemporalConv)
from strajnet_tpu_torch.models.fgmsa import FGMSA
from strajnet_tpu_torch.models.swin import SwinTransformerEncoder
from strajnet_tpu_torch.models.trajnet import TrajNetCrossAttention
from strajnet_tpu_torch.ops.attention import TfaMultiHeadAttention
from strajnet_tpu_torch.tracing import span

# The CLIs' --pallas choices (besides "auto") -> use_pallas_attention.
PALLAS_MODES = {"off": False, "attn": "attn", "block": "block",
                "block_fwd": "block_fwd"}


def resolve_kernel_knobs(cfg: ModelConfig):
    """(the Swin blocks' kernel mode, the decoder tails' form).

    ``use_pallas_attention``: None (auto) or True/"block" -> "block", the
    wrapper ``ops/swin_block.swin_block``, which launches the CUDA kernels
    (forward and backward) on CUDA tensors and runs the plain version on CPU
    tensors; "block_fwd" -> the forward kernel with autograd of the plain
    version as its backward, which tells a fault of the backward kernel from
    one elsewhere; "attn" -> only the windowed attention through its kernels
    (``ops/window_attention.py``), LayerNorm, MLP and residuals in plain
    torch; False -> the plain version everywhere.
    ``use_pallas_decoder_tail``: None/False/"xla" -> "xla", True/"kernel" ->
    "kernel", "phase" and "infer" as they are: the four forms
    ``models/decoder.py::Pyramid3DDecoder`` takes.
    ``pallas_windows_per_program`` and ``pallas_samples_per_program`` tune
    the TPU kernels' strips and are ignored here.
    """
    mode = cfg.use_pallas_attention
    if mode not in (None, True, False, "block", "block_fwd", "attn"):
        raise ValueError(f"unknown use_pallas_attention={mode!r}")
    tail = cfg.use_pallas_decoder_tail
    if tail not in (None, False, True, "xla", "phase", "kernel", "infer"):
        raise ValueError(f"unknown use_pallas_decoder_tail={tail!r}")
    if mode in (None, True):
        mode = "block"
    if tail in (None, False):
        tail = "xla"
    elif tail is True:
        tail = "kernel"
    return mode, tail


class STrajNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        kernel_mode, tail_mode = resolve_kernel_knobs(cfg)
        # the JAX package's configs, which the tests hand over too, have no
        # block field: their blocks are Swin-v1's
        block = getattr(cfg, "block", "swin")
        bh, bw = cfg.bottleneck_size
        bd = cfg.bottleneck_dim
        self.encoder = SwinTransformerEncoder(
            cfg.input_size, cfg.patch_size, cfg.embed_dim, cfg.depths,
            cfg.num_heads, cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
            cfg.patch_norm, cfg.ogm_past_steps, kernel_mode, dt,
            cfg.drop_rate, cfg.attn_drop_rate, cfg.drop_path_rate,
            cfg.remat_encoder, cfg.ape, cfg.sep_encode, cfg.no_map,
            cfg.flow_sep, cfg.use_flow, cfg.large_input, cfg.ogm_classes,
            cfg.spatial_shard, block)
        if cfg.fg_msa:
            self.fg_msa_layer = FGMSA(
                (bh, bw), cfg.fgmsa_heads, cfg.fgmsa_head_channels,
                cfg.fgmsa_groups, bd, bd, dt, fg=cfg.fg, kv_size=(bh, bw),
                deform_kv=cfg.deform_kv)
        self.trajnet_attn = TrajNetCrossAttention(
            (bh, bw), bd, cfg.obs_actors, cfg.occ_actors, cfg.actor_feats,
            cfg.traj_heads, cfg.att_heads, cfg.traj_out_dim,
            cfg.num_waypoints, dt, cfg.actor_only, cfg.sep_actors,
            cfg.map_points, cfg.map_feats)
        # the channels of the encoder's residuals, the flow stage's first
        res_dims = [cfg.embed_dim * 2 ** i for i in range(len(cfg.depths))]
        if self.encoder.flow_stage:
            res_dims.insert(0, cfg.embed_dim)
        flow_res_dim = None
        if cfg.flow_sep_decode:
            flow_res_dim, res_dims = res_dims[0], res_dims[1:]
        self.decoder = Pyramid3DDecoder(
            bd, res_dims, flow_res_dim, cfg.shallow_decode,
            cfg.num_waypoints, (bh, bw), dt, tail_mode, cfg.use_pyramid,
            cfg.flow_sep_decode, cfg.conv_cnn, cfg.sep_conv, cfg.rep_res,
            cfg.stp_grad, cfg.spatial_shard)

    def forward(self, ogm: torch.Tensor, map_img: torch.Tensor,
                obs: torch.Tensor, occ: torch.Tensor,
                mapt: Optional[torch.Tensor] = None,
                flow: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``mapt`` (centerlines, ``[B, segments, points, feats]``) is read
        only with ``actor_only=False``, ``flow`` not without ``use_flow``.
        In training mode the dropout and drop-path noise comes from
        ``generator``, which lives on the model's device."""
        cfg = self.cfg
        t = cfg.num_waypoints
        bh, bw = cfg.bottleneck_size
        bd = cfg.bottleneck_dim
        with span("strajnet.encoder"):
            res_list = self.encoder(ogm, map_img, flow, generator)
        q = res_list[-1]                              # [B, bh*bw, bd]
        if cfg.fg_msa:
            with span("strajnet.fg_msa"):
                q = q.reshape(-1, bh, bw, bd)
                res, _, ref = self.fg_msa_layer(q, generator=generator)
                q = (res + q).reshape(-1, bh * bw, bd)
        with span("strajnet.trajnet"):
            query = q[:, None].repeat(1, t, 1, 1)     # [B, T, N, D]
            if cfg.fg_msa and cfg.fg:
                # per-group flow features projected onto the waypoint axis
                # (n_groups is reused as T)
                query = ref.reshape(-1, t, bh * bw, bd) + query
            obs_value = self.trajnet_attn(query, obs, occ, mapt,
                                           generator=generator)
        with span("strajnet.decoder"):
            y = self.decoder(obs_value, res_list)
            _, _, oh, ow, c = y.shape
            return y.permute(0, 2, 3, 1, 4).reshape(-1, oh, ow,
                                                    t * c).float()


def build_model(cfg: ModelConfig) -> STrajNet:
    return STrajNet(cfg)


def dummy_inputs(cfg: ModelConfig, batch: int = 1,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> Dict[str, torch.Tensor]:
    """Zero inputs with the parsed-TFRecord shapes."""
    h, w = cfg.input_size
    mh, mw = cfg.map_size

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(
        ogm=z(batch, h, w, cfg.ogm_past_steps, cfg.ogm_classes),
        map_img=z(batch, mh, mw, 3),
        obs=z(batch, cfg.obs_actors, cfg.actor_steps, cfg.actor_feats),
        occ=z(batch, cfg.occ_actors, cfg.actor_steps, cfg.actor_feats),
        mapt=z(batch, cfg.map_segments, cfg.map_points, cfg.map_feats),
        flow=z(batch, h, w, 2),
    )


def _glorot_(p: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    p.uniform_(-limit, limit, generator=generator)


def _orthogonal_conv_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``orthogonal()`` for a conv kernel: the HWIO kernel as a
    ``[kh * kw * in, out]`` matrix with orthonormal columns (rows, if
    fewer), written into the OIHW weight."""
    out_c, in_c, kh, kw = w.shape
    m = torch.empty(out_c, kh * kw * in_c)
    torch.nn.init.orthogonal_(m, generator=generator)
    w.copy_(m.reshape(out_c, kh, kw, in_c).permute(0, 3, 1, 2))


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``STrajNet(cfg)`` drawn like the Flax init.

    Glorot-uniform Dense/Conv/MHA/temporal-conv kernels with Flax's fans
    (receptive field times in/out features), zero biases, LayerNorm scales
    one, ``truncated_normal(0.01)`` for FG-MSA's ``rpe_table``, zeros for
    the Swin rel-pos tables and the absolute position embedding, and an
    orthogonal ``conv_h`` kernel in each ``ConvLSTM2D``. The draws come from ``generator`` (a CPU
    generator); they are not the JAX init's numbers.
    """
    model = STrajNet(cfg)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                w = module.weight
                rf = w[0, 0].numel() if w.dim() == 4 else 1
                _glorot_(w, w.shape[1] * rf, w.shape[0] * rf, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, TfaMultiHeadAttention):
                for k in (module.query_kernel, module.key_kernel,
                          module.value_kernel, module.projection_kernel):
                    _glorot_(k, k.shape[0] * k.shape[1],
                             k.shape[0] * k.shape[2], generator)
                module.projection_bias.zero_()
            elif isinstance(module, TemporalConv):
                k = module.kernel
                _glorot_(k, k.shape[0] * k.shape[1], k.shape[0] * k.shape[2],
                         generator)
                module.bias.zero_()
            elif isinstance(module, FGMSA):
                torch.nn.init.trunc_normal_(module.rpe_table, std=0.01,
                                            a=-0.02, b=0.02,
                                            generator=generator)
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.zero_()
        for module in model.modules():
            if isinstance(module, ConvLSTM2D):
                _orthogonal_conv_(module.conv_h.weight, generator)
    return model.state_dict()
