"""Trajectory encoders and the per-waypoint cross-attention fusion.

Counterpart of ``strajnet_tpu/models/trajnet.py`` on STrajNet's path
(``actor_only=True``, ``sep_actors=False``): all actors are encoded in one
batched call, and the eight per-waypoint ``CrossAttentionT`` layers (an
``nn.vmap`` over stacked parameters in Flax) are an ``nn.ModuleList`` here.
``MapEncoder`` and ``TrajEncoderLSTM`` are still to be ported (ROADMAP.md).
Inference forward: dropout is inactive.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.models.swin import LayerNorm, dense
from strajnet_tpu_torch.ops.attention import TfaMultiHeadAttention


class _PointNetEncoder(nn.Module):
    """Conv1D(64) over the geometric features -> masked tfa MHA -> global
    max-pool over all nodes (masked ones included) -> concat a Dense(64) of
    the step-0 type one-hot -> Dense(out_dim, elu)."""

    def __init__(self, num_geom_feats: int, num_type_feats: int,
                 num_heads: int, mha_out: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_geom_feats, self.dtype = num_geom_feats, dtype
        self.node_feature = nn.Linear(num_geom_feats, 64)
        self.node_attention = TfaMultiHeadAttention(num_heads, 64, mha_out,
                                                    64, dtype=dtype)
        self.vector_feature = nn.Linear(num_type_feats, 64, bias=False)
        self.sublayer = nn.Linear(mha_out + 64, out_dim)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor):
        dt, ng = self.dtype, self.num_geom_feats
        inputs = inputs.to(dt)
        m = mask.int()
        attn_mask = m[:, :, None] * m[:, None, :]
        nodes = F.elu(dense(self.node_feature, inputs[:, :, :ng], dt))
        nodes = self.node_attention(nodes, nodes, nodes, mask=attn_mask)
        nodes = nodes.max(dim=1).values
        vector = dense(self.vector_feature, inputs[:, 0, ng:], dt)
        out = dense(self.sublayer, torch.cat([nodes, vector], dim=1), dt)
        return F.elu(out)


class TrajEncoder(nn.Module):
    """Agent-track encoder: 5 kinematic features, the rest a type one-hot."""

    def __init__(self, actor_feats: int = 8, num_heads: int = 4,
                 out_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc = _PointNetEncoder(5, actor_feats - 5, num_heads, 64 * 5,
                                    out_dim, dtype)

    def forward(self, inputs, mask):
        return self.enc(inputs, mask)


class CrossAttentionT(nn.Module):
    """Post-LN cross-attention block: MHA -> LN -> FFN(4x key_dim, elu) ->
    Dense(output_dim) -> LN, LayerNorm eps 1e-3, no internal residual."""

    def __init__(self, num_heads: int, key_dim: int, output_dim: int,
                 in_q: int, in_k: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mha = TfaMultiHeadAttention(num_heads, key_dim // num_heads,
                                         key_dim, in_q, in_k, dtype=dtype)
        self.norm1 = LayerNorm(key_dim, 1e-3, dtype)
        self.FFN1 = nn.Linear(key_dim, 4 * key_dim)
        self.FFN2 = nn.Linear(4 * key_dim, output_dim)
        self.norm2 = LayerNorm(output_dim, 1e-3, dtype)

    def forward(self, query, key, mask=None):
        dt = self.dtype
        v = self.norm1(self.mha(query, key, mask=mask))
        v = dense(self.FFN2, F.elu(dense(self.FFN1, v, dt)), dt)
        return self.norm2(v)


class CrossAttention(CrossAttentionT):
    """:class:`CrossAttentionT` with output_dim == key_dim == in dims."""

    def __init__(self, num_heads: int, key_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_heads, key_dim, key_dim, key_dim, key_dim, dtype)


class TrajNet(nn.Module):
    """Actor interaction encoder: batched track encoding, a learned segment
    embedding of the fixed obs/occ code, one masked attention over all
    actors; returns LayerNorm'd obs / occ features and the actor mask."""

    def __init__(self, obs_actors: int = 48, occ_actors: int = 16,
                 actor_feats: int = 8, traj_heads: int = 4,
                 att_heads: int = 6, out_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.obs_actors, self.occ_actors = obs_actors, occ_actors
        self.out_dim, self.dtype = out_dim, dtype
        self.traj_encoder = TrajEncoder(actor_feats, traj_heads, out_dim,
                                        dtype)
        self.seg_embed = nn.Linear(2, out_dim, bias=False)
        self.cross_attention = CrossAttention(att_heads, out_dim, dtype)
        self.obs_norm = LayerNorm(out_dim, 1e-3, dtype)
        self.occ_norm = LayerNorm(out_dim, 1e-3, dtype)
        code = np.repeat(np.array([[1.0, 0.0], [0.0, 1.0]], np.float32),
                         [obs_actors, occ_actors], axis=0)
        self.register_buffer("seg_code", torch.from_numpy(code),
                             persistent=False)

    def forward(self, obs_traj: torch.Tensor, occ_traj: torch.Tensor):
        dt = self.dtype
        b = obs_traj.shape[0]
        n_obs, n_occ = self.obs_actors, self.occ_actors
        steps, feats = obs_traj.shape[2], obs_traj.shape[3]
        all_traj = torch.cat([obs_traj, occ_traj], dim=1)
        all_mask = all_traj[..., 0] != 0                  # [B, 64, T]
        enc = self.traj_encoder(all_traj.reshape(-1, steps, feats),
                                all_mask.reshape(-1, steps))
        enc = enc.reshape(b, n_obs + n_occ, self.out_dim)
        obs, occ = enc[:, :n_obs], enc[:, n_obs:]

        embed = dense(self.seg_embed, self.seg_code, dt)[None].expand(
            b, -1, -1)
        c_attn_mask = all_mask.int().sum(-1).ne(0).int()  # [B, 64]
        concat = c_attn_mask[:, :, None].to(dt) * enc
        attn_mask = c_attn_mask[:, :, None] * c_attn_mask[:, None, :]
        val = self.cross_attention(concat + embed, concat, attn_mask)
        obs = self.obs_norm(obs + val[:, :n_obs] + embed[:, :n_obs])
        occ = self.occ_norm(occ + val[:, n_obs:] + embed[:, n_obs:])
        return obs, occ, c_attn_mask


class TrajNetCrossAttention(nn.Module):
    """Per-waypoint fusion of the visual query with the actor features."""

    def __init__(self, pic_size: Tuple[int, int] = (16, 16),
                 pic_dim: int = 384, obs_actors: int = 48,
                 occ_actors: int = 16, actor_feats: int = 8,
                 traj_heads: int = 4, att_heads: int = 6, out_dim: int = 384,
                 num_waypoints: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pic_size, self.pic_dim = pic_size, pic_dim
        self.num_waypoints, self.dtype = num_waypoints, dtype
        self.traj_net = TrajNet(obs_actors, occ_actors, actor_feats,
                                traj_heads, att_heads, out_dim, dtype)
        self.cross_attn_obs = nn.ModuleList(
            CrossAttentionT(3, 128, pic_dim, pic_dim, out_dim, dtype)
            for _ in range(num_waypoints))

    def forward(self, pic_encode: torch.Tensor, obs_traj: torch.Tensor,
                occ_traj: torch.Tensor) -> torch.Tensor:
        """pic_encode: [B, T, h*w, pic_dim] -> [B, T, h, w, pic_dim]."""
        h, w = self.pic_size
        t = self.num_waypoints
        obs, occ, traj_mask = self.traj_net(obs_traj, occ_traj)
        flat = pic_encode.reshape(-1, t, h * w, self.pic_dim).to(self.dtype)
        key = torch.cat([obs, occ], dim=1)
        mask = traj_mask[:, None, :].expand(-1, h * w, -1)
        o = torch.stack([layer(flat[:, k], key, mask)
                         for k, layer in enumerate(self.cross_attn_obs)],
                        dim=1)
        return (o + flat).reshape(-1, t, h, w, self.pic_dim)
