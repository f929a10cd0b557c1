"""Trajectory and map encoders and the per-waypoint cross-attention fusion.

Counterpart of ``strajnet_tpu/models/trajnet.py``: the track encoder
(:class:`TrajEncoder`, all actors in one batched call), the centerline
encoder (:class:`MapEncoder`), the LSTM track encoder
(:class:`TrajEncoderLSTM`, which no path of either package calls), the actor
interaction encoder :class:`TrajNet` (with ``no_attn`` and ``double_net``)
and :class:`TrajNetCrossAttention`, which fuses the visual query with the
actors and, with ``actor_only=False``, with the encoded centerlines. The
eight per-waypoint ``CrossAttentionT`` blocks of each kind (an ``nn.vmap``
over stacked parameters in Flax) are an ``nn.ModuleList`` here; with
``sep_actors`` each block first runs a self-attention over its keys. In
training mode the attention weights of every MHA and the FFN activations of
each cross-attention block pass through ``Dropout(0.1)``, with noise from the
generator handed to ``forward``.

Under a ``'model'`` axis (``parallel/mesh.py``) JAX's rules split the MHA
heads where they divide the axis (at 2, the 6-head ``traj_net``
cross-attention and the 4-head node attention of the track and centerline
encoders; the 3-head per-waypoint blocks stay whole) and ``traj_net``'s FFN
pair, FFN1 column- and FFN2 row-parallel; the per-waypoint blocks' FFNs are
stacked leaves in Flax, which the rules do not take, so they stay whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from strajnet_tpu_torch.models.swin import LayerNorm, dense, parallel_ffn
from strajnet_tpu_torch.ops.attention import TfaMultiHeadAttention
from strajnet_tpu_torch.ops.dropout import dropout

_DROPOUT = 0.1


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
        self.node_attention = TfaMultiHeadAttention(
            num_heads, 64, mha_out, 64, dtype=dtype, dropout=_DROPOUT)
        self.vector_feature = nn.Linear(num_type_feats, 64, bias=False)
        self.sublayer = nn.Linear(mha_out + 64, out_dim)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor,
                generator=None):
        dt, ng = self.dtype, self.num_geom_feats
        inputs = inputs.to(dt)
        m = mask.int()
        attn_mask = m[:, :, None] * m[:, None, :]
        nodes = F.elu(dense(self.node_feature, inputs[:, :, :ng], dt))
        nodes = self.node_attention(nodes, nodes, nodes, mask=attn_mask,
                                    generator=generator)
        nodes = nodes.max(dim=1).values
        vector = dense(self.vector_feature, inputs[:, 0, ng:], dt)
        out = dense(self.sublayer, torch.cat([nodes, vector], dim=1), dt)
        return F.elu(out)


class MapEncoder(nn.Module):
    """Centerline-segment encoder: 4 geometric features, the rest a type
    one-hot, MHA output 4 x 64."""

    def __init__(self, map_feats: int = 7, num_heads: int = 4,
                 out_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc = _PointNetEncoder(4, map_feats - 4, num_heads, 64 * 4,
                                    out_dim, dtype)

    def forward(self, inputs, mask, generator=None):
        return self.enc(inputs, mask, generator)


class TrajEncoder(nn.Module):
    """Agent-track encoder: 5 kinematic features, the rest a type one-hot."""

    def __init__(self, actor_feats: int = 8, num_heads: int = 4,
                 out_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc = _PointNetEncoder(5, actor_feats - 5, num_heads, 64 * 5,
                                    out_dim, dtype)

    def forward(self, inputs, mask, generator=None):
        return self.enc(inputs, mask, generator)


_GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell`` (and ``LSTMCell``): per gate an input
    projection ``i<gate>`` without bias and a hidden projection ``h<gate>``
    with one; sigmoid gates i, f, o, tanh candidate g, carry (c, h)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for gate in _GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, features,
                                                  bias=False))
            self.add_module(f"h{gate}", nn.Linear(features, features))

    def forward(self, carry, x: torch.Tensor, dtype: torch.dtype):
        c, h = carry
        z = {gate: dense(getattr(self, f"h{gate}"), h, dtype)
             + dense(getattr(self, f"i{gate}"), x, dtype) for gate in _GATES}
        c = torch.sigmoid(z["f"]) * c + torch.sigmoid(z["i"]) * torch.tanh(
            z["g"])
        h = torch.sigmoid(z["o"]) * torch.tanh(c)
        return c, h


class TrajEncoderLSTM(nn.Module):
    """LSTM track encoder: Conv1D(64, elu) embedding, an LSTM over the steps
    from a zero carry, the last output. The mask is not used (as in JAX)."""

    def __init__(self, actor_feats: int = 8, out_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim, self.dtype = out_dim, dtype
        self.embed = nn.Linear(actor_feats, 64)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(64, out_dim)

    def forward(self, inputs: torch.Tensor, mask=None, generator=None):
        dt = self.dtype
        x = F.elu(dense(self.embed, inputs.to(dt), dt))
        h = x.new_zeros(x.shape[0], self.out_dim)
        carry = (h, h)
        for t in range(x.shape[1]):
            carry = self.OptimizedLSTMCell_0(carry, x[:, t], dt)
        return carry[1]


class CrossAttentionT(nn.Module):
    """Post-LN cross-attention block: MHA -> LN -> FFN(4x key_dim, elu) ->
    Dense(output_dim) -> LN, LayerNorm eps 1e-3, no internal residual.

    With ``sep_actors`` the keys first pass a self-attention block of their
    own (``actor_mha`` under ``actor_mask`` -> LN -> FFN -> ``actor_norm2``
    of it plus the keys), which needs ``output_dim == in_k``.
    """

    def __init__(self, num_heads: int, key_dim: int, output_dim: int,
                 in_q: int, in_k: int, dtype: torch.dtype = torch.float32,
                 sep_actors: bool = False):
        super().__init__()
        self.dtype, self.sep_actors = dtype, sep_actors
        if sep_actors:
            self.actor_mha = TfaMultiHeadAttention(
                num_heads, key_dim // num_heads, key_dim, in_k, in_k,
                dtype=dtype, dropout=_DROPOUT)
            self.actor_norm = LayerNorm(key_dim, 1e-3, dtype)
            self.aFFN1 = nn.Linear(key_dim, 4 * key_dim)
            self.aFFN2 = nn.Linear(4 * key_dim, output_dim)
            self.actor_norm2 = LayerNorm(output_dim, 1e-3, dtype)
        self.mha = TfaMultiHeadAttention(num_heads, key_dim // num_heads,
                                         key_dim, in_q, in_k, dtype=dtype,
                                         dropout=_DROPOUT)
        self.norm1 = LayerNorm(key_dim, 1e-3, dtype)
        self.FFN1 = nn.Linear(key_dim, 4 * key_dim)
        self.FFN2 = nn.Linear(4 * key_dim, output_dim)
        self.norm2 = LayerNorm(output_dim, 1e-3, dtype)

    def forward(self, query, key, mask=None, generator=None,
                actor_mask=None):
        dt, train = self.dtype, self.training
        if self.sep_actors:
            k = self.actor_norm(self.actor_mha(key, key, mask=actor_mask,
                                               generator=generator))
            k = dropout(F.elu(dense(self.aFFN1, k, dt)), _DROPOUT, train,
                        generator)
            k = dropout(dense(self.aFFN2, k, dt), _DROPOUT, train, generator)
            key = self.actor_norm2(k + key)
        v = self.norm1(self.mha(query, key, mask=mask, generator=generator))
        v = parallel_ffn(
            self.FFN1, self.FFN2, v,
            lambda t, split: dropout(F.elu(t), _DROPOUT, train, generator,
                                     split), dt)
        v = dropout(v, _DROPOUT, train, generator)
        return self.norm2(v)


class CrossAttention(CrossAttentionT):
    """:class:`CrossAttentionT` with output_dim == key_dim == in dims."""

    def __init__(self, num_heads: int, key_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_heads, key_dim, key_dim, key_dim, key_dim, dtype)


class TrajNet(nn.Module):
    """Actor interaction encoder: batched track encoding, a learned segment
    embedding of the fixed obs/occ code, one masked attention over all
    actors; returns LayerNorm'd obs / occ features and the actor mask.

    ``no_attn`` drops the attention (the features plus their embedding are
    normalised as they are); ``double_net`` runs two attention blocks and
    returns an OGM and a flow feature over all actors each (with
    ``no_attn``: the features of all actors through both norms).
    """

    def __init__(self, obs_actors: int = 48, occ_actors: int = 16,
                 actor_feats: int = 8, traj_heads: int = 4,
                 att_heads: int = 6, out_dim: int = 384,
                 dtype: torch.dtype = torch.float32, no_attn: bool = False,
                 double_net: bool = False):
        super().__init__()
        self.obs_actors, self.occ_actors = obs_actors, occ_actors
        self.out_dim, self.dtype = out_dim, dtype
        self.no_attn, self.double_net = no_attn, double_net
        self.traj_encoder = TrajEncoder(actor_feats, traj_heads, out_dim,
                                        dtype)
        self.seg_embed = nn.Linear(2, out_dim, bias=False)
        if not no_attn:
            if double_net:
                for i in range(2):
                    self.add_module(f"cross_attention_{i}", CrossAttentionT(
                        att_heads, 192, out_dim, out_dim, out_dim, dtype))
            else:
                self.cross_attention = CrossAttention(att_heads, out_dim,
                                                      dtype)
        self.obs_norm = LayerNorm(out_dim, 1e-3, dtype)
        self.occ_norm = LayerNorm(out_dim, 1e-3, dtype)
        code = np.repeat(np.array([[1.0, 0.0], [0.0, 1.0]], np.float32),
                         [obs_actors, occ_actors], axis=0)
        self.register_buffer("seg_code", torch.from_numpy(code),
                             persistent=False)

    def forward(self, obs_traj: torch.Tensor, occ_traj: torch.Tensor,
                generator=None):
        dt = self.dtype
        b = obs_traj.shape[0]
        n_obs = self.obs_actors
        steps, feats = obs_traj.shape[2], obs_traj.shape[3]
        all_traj = torch.cat([obs_traj, occ_traj], dim=1)
        all_mask = all_traj[..., 0] != 0                  # [B, 64, T]
        enc = self.traj_encoder(all_traj.reshape(-1, steps, feats),
                                all_mask.reshape(-1, steps), generator)
        enc = enc.reshape(b, -1, self.out_dim)
        obs, occ = enc[:, :n_obs], enc[:, n_obs:]
        embed = dense(self.seg_embed, self.seg_code, dt)[None].expand(
            b, -1, -1)
        c_attn_mask = all_mask.int().sum(-1).ne(0).int()  # [B, 64]

        if self.no_attn:
            if self.double_net:
                return (self.obs_norm(enc + embed),
                        self.occ_norm(enc + embed), c_attn_mask)
            return (self.obs_norm(obs + embed[:, :n_obs]),
                    self.occ_norm(occ + embed[:, n_obs:]), c_attn_mask)

        concat = c_attn_mask[:, :, None].to(dt) * enc
        query = concat + embed
        attn_mask = c_attn_mask[:, :, None] * c_attn_mask[:, None, :]
        if self.double_net:
            val = self.cross_attention_0(query, concat, attn_mask, generator)
            val_f = self.cross_attention_1(query, concat, attn_mask,
                                           generator)
            obs2 = obs + val[:, :n_obs]
            occ2 = occ + val[:, n_obs:]
            ogm = torch.cat([obs2, occ2], dim=1) + embed
            flow = torch.cat([obs2 + val_f[:, :n_obs],
                              occ2 + val_f[:, n_obs:]], dim=1) + embed
            return self.obs_norm(ogm), self.occ_norm(flow), c_attn_mask
        val = self.cross_attention(query, concat, attn_mask, generator)
        obs = self.obs_norm(obs + val[:, :n_obs] + embed[:, :n_obs])
        occ = self.occ_norm(occ + val[:, n_obs:] + embed[:, n_obs:])
        return obs, occ, c_attn_mask


class TrajNetCrossAttention(nn.Module):
    """Per-waypoint fusion of the visual query with the actor features and,
    with ``actor_only=False``, the centerline segments: ``map_traj``
    ``[B, segments, map_points, map_feats]``, a segment valid where the
    first feature of its first point is non-zero."""

    def __init__(self, pic_size: Tuple[int, int] = (16, 16),
                 pic_dim: int = 384, obs_actors: int = 48,
                 occ_actors: int = 16, actor_feats: int = 8,
                 traj_heads: int = 4, att_heads: int = 6, out_dim: int = 384,
                 num_waypoints: int = 8,
                 dtype: torch.dtype = torch.float32,
                 actor_only: bool = True, sep_actors: bool = False,
                 map_points: int = 10, map_feats: int = 7):
        super().__init__()
        self.pic_size, self.pic_dim = pic_size, pic_dim
        self.num_waypoints, self.dtype = num_waypoints, dtype
        self.out_dim, self.map_points = out_dim, map_points
        self.actor_only, self.sep_actors = actor_only, sep_actors
        self.traj_net = TrajNet(obs_actors, occ_actors, actor_feats,
                                traj_heads, att_heads, out_dim, dtype,
                                no_attn=sep_actors)

        def per_waypoint():
            return nn.ModuleList(
                CrossAttentionT(3, 128, pic_dim, pic_dim, out_dim, dtype,
                                sep_actors) for _ in range(num_waypoints))

        self.cross_attn_obs = per_waypoint()
        if not actor_only:
            self.map_encoder = MapEncoder(map_feats, traj_heads, out_dim,
                                          dtype)
            self.map_norm = LayerNorm(out_dim, 1e-3, dtype)
            self.map_cross_attn = per_waypoint()

    def forward(self, pic_encode: torch.Tensor, obs_traj: torch.Tensor,
                occ_traj: torch.Tensor,
                map_traj: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        """pic_encode: [B, T, h*w, pic_dim] -> [B, T, h, w, pic_dim]."""
        h, w = self.pic_size
        t = self.num_waypoints
        obs, occ, traj_mask = self.traj_net(obs_traj, occ_traj, generator)
        actor_mask = None
        if self.sep_actors:
            actor_mask = traj_mask[:, :, None] * traj_mask[:, None, :]
        flat = pic_encode.reshape(-1, t, h * w, self.pic_dim).to(self.dtype)
        key = torch.cat([obs, occ], dim=1)
        mask = traj_mask[:, None, :].expand(-1, h * w, -1)
        o = torch.stack([layer(flat[:, k], key, mask, generator, actor_mask)
                         for k, layer in enumerate(self.cross_attn_obs)],
                        dim=1)
        v = o + flat
        if not self.actor_only:
            segs = map_traj.shape[1]
            map_mask = map_traj[..., 0] != 0              # [B, segs, pts]
            mt = map_traj.reshape(-1, self.map_points, map_traj.shape[-1])
            map_enc = self.map_encoder(mt, map_mask.reshape(
                -1, self.map_points), generator)
            map_enc = self.map_norm(map_enc.reshape(-1, segs, self.out_dim))
            map_attn_mask = map_mask[:, None, :, 0].int().expand(
                -1, h * w, -1)
            # the map blocks attend from o; their keys get no mask
            mv = torch.stack([layer(o[:, k], map_enc, map_attn_mask,
                                    generator, None)
                              for k, layer in enumerate(self.map_cross_attn)],
                             dim=1)
            v = mv + o + flat
        return v.reshape(-1, t, h, w, self.pic_dim)
