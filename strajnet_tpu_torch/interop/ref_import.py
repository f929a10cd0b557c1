"""The reference's Keras checkpoint -> the port's ``state_dict``.

Counterpart of ``strajnet_tpu/interop/ref_import.py``. The reference saves
``model.save_weights('...model_{ep}_{...}.tf')`` and serves by
``model.load_weights(--weight_path)``; :func:`import_ref_checkpoint` builds
the reference model with TensorFlow (``interop/refload.py``), restores such
a checkpoint into it and maps every weight onto ``STrajNet``'s keys. The
mapping is numpy, one strategy per sub-model, as the reference names its
weights:

1. encoder, by NAME: the reference passes explicit ``name=`` strings
   (``layers0/blocks0/attn/qkv``, ...); Keras prefixes them with automatic
   class scopes and DUPLICATES some (three ``patch_embed/proj/kernel``, two
   ``all_norm/gamma``), told apart by their occurrence in ``.weights``
   order, which is construction order;
2. FG-MSA and the decoder, by CONSTRUCTION ORDER (``fgmsa_order``,
   ``decoder_order``);
3. the trajectory cross-attention, by construction order too, the 8
   per-waypoint layers (``cross_attn_obs``) included with their waypoint
   index.

Each weight gets the Flax path the JAX package gives it, and
``interop/from_flax.py::convert_leaf`` turns that path and value into the
torch key and layout; a per-waypoint layer's weight becomes
``cross_attn_obs.<t>.…``, as ``flax_to_state_dict`` splits the stacked
leaf. ``STrajNet(cfg).load_state_dict(..., strict=True)`` then checks that
every weight of the model came once, at its shape.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from strajnet_tpu_torch.config import STRAJNET_CONFIG, ModelConfig
from strajnet_tpu_torch.interop import refload
from strajnet_tpu_torch.interop.from_flax import convert_leaf
from strajnet_tpu_torch.models.strajnet import STrajNet

# The reference passes fixed name= strings, so several weights share the
# exact same Keras name.
_DUP_MAP = {
    "patch_embed": ["patch_embed_vehicle", "patch_embed_flow",
                    "patch_embed_map"],
    "all_norm": ["flow_norm", "all_patch_norm"],
}

_EXPLICIT_HEAD = re.compile(
    r"^(flow_layers\d+|layers\d+|patch_embed|all_norm)$")


def keras_name_to_flax_path(name, seen_counts):
    """Maps a Keras encoder weight name to a flax param path tuple.

    Keras prefixes weights with auto-generated class-name scopes
    (basic_layer_3/swin_transformer_block_7/...); the reference's explicit
    ``name=`` strings appear as the suffix — find the first explicit
    component and keep from there.
    """
    name = name.split(":")[0]
    comps = name.split("/")
    for i, c in enumerate(comps):
        if _EXPLICIT_HEAD.match(c):
            comps = comps[i:]
            break
    name = "/".join(comps)
    head = comps[0]
    if head in _DUP_MAP:
        idx = seen_counts.get(name, 0)
        seen_counts[name] = idx + 1
        name = _DUP_MAP[head][idx] + name[len(head):]
    name = name.replace("flow_layers0/", "flow_layer/")
    parts = [p for p in name.split("/") if p]
    # keras LN params (gamma/beta) -> our LayerNorm wrapper's nn.LayerNorm
    if parts[-1] == "gamma":
        parts = parts[:-1] + ["LayerNorm_0", "scale"]
    elif parts[-1] == "beta":
        parts = parts[:-1] + ["LayerNorm_0", "bias"]
    return parts


def fgmsa_order():
    """Construction order of reference FGMSA weights (FG_MSA.py __init__)."""
    return [
        (("conv_offset_0", "kernel"), None),
        (("conv_offset_0", "bias"), None),
        (("conv_norm", "LayerNorm_0", "scale"), None),
        (("conv_norm", "LayerNorm_0", "bias"), None),
        (("conv_offset_proj", "kernel"), None),
        (("conv_offset_proj2", "kernel"), None),
        (("conv_offset_proj2", "bias"), None),
        (("proj_q", "kernel"), None),
        (("proj_q", "bias"), None),
        (("proj_k", "kernel"), None),
        (("proj_k", "bias"), None),
        (("proj_v", "kernel"), None),
        (("proj_v", "bias"), None),
        (("proj_out", "kernel"), None),
        (("proj_out", "bias"), None),
        (("rpe_table",), None),
    ]


def _conv3d_to_temporal(v):  # (8,1,1,Cin,Cout) -> (8,Cin,Cout)
    return v[:, 0, 0]


def decoder_order():
    """Reference Pyramid3DDecoder weight order at the training config
    (modules.py __init__): upsample(no w), upconv_0s [3,2,1,0], then flow
    branch (upsample_f, upconv_f [1,0], res_f, 'outconv_f'), then res_layer
    [3,2], output_layer."""
    return [
        (("upconv_3_0", "conv", "kernel"), None),
        (("upconv_3_0", "conv", "bias"), None),
        (("upconv_2_0", "conv", "kernel"), None),
        (("upconv_2_0", "conv", "bias"), None),
        (("upconv_1_0", "conv", "kernel"), None),
        (("upconv_1_0", "conv", "bias"), None),
        (("upconv_0_0", "conv", "kernel"), None),
        (("upconv_0_0", "conv", "bias"), None),
        (("upconvf_1_0", "conv", "kernel"), None),
        (("upconvf_1_0", "conv", "bias"), None),
        (("upconvf_0_0", "conv", "kernel"), None),
        (("upconvf_0_0", "conv", "bias"), None),
        (("resconv_f", "kernel"), _conv3d_to_temporal),
        (("resconv_f", "bias"), None),
        (("outconv_f", "kernel"), None),
        (("outconv_f", "bias"), None),
        (("resconv_3", "kernel"), _conv3d_to_temporal),
        (("resconv_3", "bias"), None),
        (("resconv_2", "kernel"), _conv3d_to_temporal),
        (("resconv_2", "bias"), None),
        (("outconv", "kernel"), None),
        (("outconv", "bias"), None),
    ]


def _mha_order(prefix):
    return [(prefix + (n,), None) for n in
            ("query_kernel", "key_kernel", "value_kernel",
             "projection_kernel", "projection_bias")]


def trajnet_order(num_waypoints=8):
    """Reference TrajNetCrossAttention weight order = sublayer construction
    order: TrajNet (traj_encoder: Conv1D, MHA, vector_feature, sublayer;
    cross_attention: mha, norm1, norm2, FFN1, FFN2; obs_norm, occ_norm,
    seg_embed); then num_waypoints x Cross_AttentionT (mha, norm1, norm2,
    FFN1, FFN2) stacked into our vmapped cross_attn_obs params."""
    enc = ("traj_net", "traj_encoder", "enc")
    ca = ("traj_net", "cross_attention")
    order = [
        ((*enc, "node_feature", "kernel"), None),
        ((*enc, "node_feature", "bias"), None),
        *_mha_order((*enc, "node_attention")),
        ((*enc, "vector_feature", "kernel"), None),
        ((*enc, "sublayer", "kernel"), None),
        ((*enc, "sublayer", "bias"), None),
        *_mha_order((*ca, "mha")),
        ((*ca, "norm1", "scale"), None),
        ((*ca, "norm1", "bias"), None),
        ((*ca, "norm2", "scale"), None),
        ((*ca, "norm2", "bias"), None),
        ((*ca, "FFN1", "kernel"), None),
        ((*ca, "FFN1", "bias"), None),
        ((*ca, "FFN2", "kernel"), None),
        ((*ca, "FFN2", "bias"), None),
        (("traj_net", "obs_norm", "scale"), None),
        (("traj_net", "obs_norm", "bias"), None),
        (("traj_net", "occ_norm", "scale"), None),
        (("traj_net", "occ_norm", "bias"), None),
        (("traj_net", "seg_embed", "kernel"), None),
    ]
    for i in range(num_waypoints):
        cao = ("cross_attn_obs",)
        order += [((*cao, "mha", n), None, i) for n in
                  ("query_kernel", "key_kernel", "value_kernel",
                   "projection_kernel", "projection_bias")]
        order += [((*cao, "norm1", "scale"), None, i),
                  ((*cao, "norm1", "bias"), None, i),
                  ((*cao, "norm2", "scale"), None, i),
                  ((*cao, "norm2", "bias"), None, i),
                  ((*cao, "FFN1", "kernel"), None, i),
                  ((*cao, "FFN1", "bias"), None, i),
                  ((*cao, "FFN2", "kernel"), None, i),
                  ((*cao, "FFN2", "bias"), None, i)]
    return order


_SKIP = ("relative_position_index", "attn_mask")


def copy_strajnet_weights(ref_model, cfg: ModelConfig
                          ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` of f32 tensors for ``STrajNet(cfg)`` from a built
    reference STrajNet (``.encoder``, ``.fg_msa_layer`` where ``cfg.fg_msa``,
    ``.decoder`` and ``.trajnet_attn``, each with ``.weights``). A weight
    missing, left over or of another shape raises."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, value) -> None:
        key, arr = convert_leaf(tuple(path), np.asarray(value))
        if key in out:
            raise ValueError(f"two reference weights map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def by_order(prefix, order, weights) -> None:
        weights = list(weights)
        if len(weights) != len(order):
            raise ValueError(f"{prefix}: {len(weights)} reference weights "
                             f"for the {len(order)} of the table "
                             f"({[w.name for w in weights]})")
        for spec, w in zip(order, weights):
            path, reshape = spec[0], spec[1]
            value = np.asarray(w)
            if reshape is not None:
                value = reshape(value)
            if len(spec) > 2:  # waypoint index into the stacked layer
                at = path.index("cross_attn_obs") + 1
                path = path[:at] + (str(spec[2]),) + path[at:]
            put((prefix, *path), value)

    seen = {}
    for w in ref_model.encoder.weights:
        if any(s in w.name for s in _SKIP):
            continue
        put(("encoder", *keras_name_to_flax_path(w.name, seen)), w)
    if cfg.fg_msa:
        by_order("fg_msa_layer", fgmsa_order(),
                 ref_model.fg_msa_layer.weights)
    by_order("decoder", decoder_order(), ref_model.decoder.weights)
    by_order("trajnet_attn", trajnet_order(cfg.num_waypoints),
             ref_model.trajnet_attn.weights)
    STrajNet(cfg).load_state_dict(out, strict=True)
    return out


def import_ref_checkpoint(weight_path, model_cfg=None, ref_dir=None):
    """A published reference ``.tf`` checkpoint -> ``(state_dict, cfg)``.

    Builds the reference model from its sources in ``ref_dir`` (required:
    the directory that holds the reference's ``modules.py``) with TensorFlow
    and ``tf_keras``, restores the checkpoint through Keras ``load_weights``
    (the reference's own load path) and maps every weight with
    :func:`copy_strajnet_weights` for ``model_cfg`` (default
    ``STRAJNET_CONFIG``). Runs on the CPU.
    """
    if ref_dir is None:
        raise ValueError("ref_dir: name the reference's source checkout "
                         "(the directory that holds its modules.py)")
    if model_cfg is None:
        model_cfg = STRAJNET_CONFIG
    ref_cfg = dict(input_size=tuple(model_cfg.input_size),
                   window_size=model_cfg.window_size,
                   embed_dim=model_cfg.embed_dim,
                   depths=list(model_cfg.depths),
                   num_heads=list(model_cfg.num_heads))
    ref = refload.build_reference_strajnet(
        cfg=ref_cfg, fg_msa=model_cfg.fg_msa, fg=model_cfg.fg,
        ref_dir=ref_dir)
    ref.load_weights(weight_path).expect_partial()
    return copy_strajnet_weights(ref, model_cfg), model_cfg
