"""Spiking DAB-DETR decoder (port of ``spike2former_tpu/models/dab_detr.py``;
reference: mmdet/models/layers/transformer/dab_detr_layers.py over
``ConditionalAttention``, ``coordinate_to_encoding`` and
``inverse_sigmoid`` of transformer/utils.py).

Queries carry anchors (cx, cy, w, h) in sigmoid space.  Each layer
re-encodes its anchor with a sine encoding, maps it through
``ref_point_head`` to the positional embedding of the self-attention,
scales the cross-attention's sine embedding by a transformation of the
content (``query_scale``, from the second layer on) and by the anchor's
width and height (``ref_anchor_head``, modulated HW attention), and after
the layer refines the anchor in inverse-sigmoid space by ``reg_branch``,
detached.  The cross-attention concatenates content and position per
head (``qpos_proj`` in the first layer only).  The attention core is the
softmax-free spiking one of ``attention.SpikeMHA`` with BN token norms;
the control MLPs are plain ReLU MLPs.

The port has the configuration the MaskFormer head builds: 4-d anchors,
``query_scale_type='cond_elewise'``, modulated HW attention and
``keep_query_pos=False``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel import spatial
from .attention import MSDAFFN
from .layers import BatchNorm, Linear, Spike, fold_t, unfold_t


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """The logit with clamping (transformer/utils.py inverse_sigmoid)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def coordinate_to_encoding(coord: torch.Tensor, num_feats: int = 128,
                           temperature: float = 10000.0,
                           scale: float = 2 * math.pi) -> torch.Tensor:
    """Sine/cosine encoding of (cx, cy[, w, h]) coordinates
    (transformer/utils.py:49-97): interleaved sin/cos blocks of
    ``num_feats`` each, concatenated as y, x[, w, h]."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=coord.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)

    def enc(v):
        pos = v[..., None] * scale / dim_t
        return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                           -1).reshape(*v.shape, num_feats)

    if coord.shape[-1] not in (2, 4):
        raise ValueError(f"coord last dim must be 2 or 4, got "
                         f"{tuple(coord.shape)}")
    blocks = [enc(coord[..., 1]), enc(coord[..., 0])]
    if coord.shape[-1] == 4:
        blocks += [enc(coord[..., 2]), enc(coord[..., 3])]
    return torch.cat(blocks, -1)


class _MLP(nn.Sequential):
    """Linear + ReLU stack of ``num_layers`` float32 layers (utils.py MLP;
    flax names ``Dense_0``, ...)."""

    def __init__(self, cin: int, hidden: int, out: int, num_layers: int = 2):
        super().__init__()
        dims = [cin] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        *hidden, last = self.children()
        for layer in hidden:
            x = torch.relu(layer(x))
        return last(x)


class ConditionalSpikeAttention(nn.Module):
    """Conditional (content and position decoupled) spiking attention with
    the residual inside.

    Self-attention: q, k = content_proj(x) + pos_proj(pos).
    Cross-attention: q, k = [content | position] per head (a score feature
    dim of 2C), with ``qpos_proj`` added in the first layer only
    (``is_first``).  Spiked q, k and v, scores over sqrt(that dim), masked
    scores zeroed (utils.py:685-735).

    Inside ``parallel.spatial_sharding()`` the cross-attention's keys are
    this band's pixel tokens: each score is the band's own, and the f32
    sum of the scores times the values over the keys is summed over the
    bands before it is rounded, so every rank gets the same queries."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 cross: bool = False, is_first: bool = False,
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        self.embed_dims, self.num_heads, self.cross = c, num_heads, cross
        self.with_qpos = not cross or is_first
        names = ["qcontent_proj", "kcontent_proj", "v_proj", "kpos_proj"]
        if self.with_qpos:
            names.append("qpos_proj")
        if cross:
            names.append("qpos_sine_proj")
        for name in names:
            setattr(self, name, Linear(c, c, dtype=dtype))
        for i in range(4):  # q, k, v and the merged heads
            setattr(self, f"Spike_{i}", Spike())
        self.out_proj = Linear(c, c, dtype=dtype, spike_input=True)
        self.BatchNorm_0 = BatchNorm(c)

    def forward(self, query, key, query_pos, key_pos=None,
                ref_sine_embed=None, attn_mask=None):
        """query [T,B,nq,C]; key [T,B,nk,C]; query_pos/key_pos [B,n,C];
        ref_sine_embed [B,nq,C] (cross only); attn_mask broadcast against
        the scores [T,B,heads,nq,nk], True = masked."""
        c, h = self.embed_dims, self.num_heads
        t, b, nq = query.shape[:3]
        nk = key.shape[2]
        v = self.v_proj(key)
        if self.cross:
            q_c = self.qcontent_proj(query)
            k_c = self.kcontent_proj(key)
            k_p = self.kpos_proj(key_pos)
            if self.with_qpos:
                q_c = q_c + self.qpos_proj(query_pos)
                k_c = k_c + k_p
            q_s = self.qpos_sine_proj(ref_sine_embed)
            q = torch.cat([q_c.reshape(t, b, nq, h, c // h),
                           q_s.reshape(b, nq, h, c // h).expand(
                               t, b, nq, h, c // h)], -1)
            k = torch.cat([k_c.reshape(t, b, nk, h, c // h),
                           k_p.reshape(b, nk, h, c // h).expand(
                               t, b, nk, h, c // h)], -1)
            hidden = 2 * c
        else:
            q = (self.qcontent_proj(query) + self.qpos_proj(query_pos)
                 ).reshape(t, b, nq, h, c // h)
            k = (self.kcontent_proj(key) + self.kpos_proj(
                query_pos if key_pos is None else key_pos)
                 ).reshape(t, b, nk, h, c // h)
            hidden = c
        q, k = self.Spike_0(q), self.Spike_1(k)
        v = self.Spike_2(v).reshape(t, b, nk, h, c // h)
        scores = torch.einsum("tbnhc,tbmhc->tbhnm", q.float(),
                              k.float()) / hidden ** 0.5
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask, 0.0)
        out = torch.einsum("tbhnm,tbmhc->tbnhc",
                           scores.to(v.dtype).float(), v.float())
        if self.cross:
            out = spatial.all_sum_(out)
        out = out.reshape(t, b, nq, c).to(query.dtype)
        outf, _ = fold_t(out)
        outf = self.BatchNorm_0(self.out_proj(self.Spike_3(outf)))
        return query + unfold_t(outf, t)


class DABDetrDecoderLayer(nn.Module):
    """Self-attention -> cross-attention -> FFN with conditional attention
    (dab_detr_layers.py:17-99; BN-normed spiking blocks in place of the
    reference's LayerNorms)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 2048, is_first: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.self_attn = ConditionalSpikeAttention(embed_dims, num_heads,
                                                   dtype=dtype)
        self.cross_attn = ConditionalSpikeAttention(
            embed_dims, num_heads, cross=True, is_first=is_first,
            dtype=dtype)
        self.ffn = MSDAFFN(embed_dims, feedforward_channels, dtype=dtype)

    def forward(self, query, key, query_pos, key_pos, ref_sine_embed,
                self_attn_mask=None, cross_attn_mask=None):
        query = self.self_attn(query, query, query_pos,
                               attn_mask=self_attn_mask)
        query = self.cross_attn(query, key, query_pos, key_pos=key_pos,
                                ref_sine_embed=ref_sine_embed,
                                attn_mask=cross_attn_mask)
        return query + self.ffn(query)


class DABDetrDecoder(nn.Module):
    """The DAB-DETR decoder: per-layer anchor re-encoding and refinement
    (dab_detr_layers.py:101-262)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_layers: int = 6, feedforward_channels: int = 2048,
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        self.embed_dims, self.num_layers, self.dtype = c, num_layers, dtype
        self.ref_point_head = _MLP(2 * c, c, c, 2)
        if num_layers > 1:  # the first layer takes no content scale
            self.query_scale = _MLP(c, c, c, 2)
        self.ref_anchor_head = _MLP(c, c, 2, 2)
        self.reg_branch = _MLP(c, c, 4, 3)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", DABDetrDecoderLayer(
                c, num_heads, feedforward_channels, is_first=i == 0,
                dtype=dtype))

    def forward(self, query, key, key_pos, anchors, cross_attn_mask=None):
        """query [T,B,nq,C]; key [T,B,nk,C]; key_pos [B,nk,C]; anchors
        [B,nq,4] in inverse-sigmoid space; ``cross_attn_mask`` ([B,1,1,nk]
        bool, True = masked) gates padded keys.

        Returns (outputs [L,T,B,nq,C], references [L,B,nq,4]): each
        layer's queries and the sigmoid-space anchors it attended with."""
        c, dt = self.embed_dims, self.dtype
        reference = torch.sigmoid(anchors.float())
        output = query
        inter_out, inter_refs = [], [reference]
        for i in range(self.num_layers):
            sine = coordinate_to_encoding(reference, c // 2)  # [B, nq, 2C]
            query_pos = self.ref_point_head(sine.to(dt))
            # the content's control signal is per query: the mean over T
            content = output.mean(0).to(dt)
            ref_sine = sine[..., :c]
            if i:
                ref_sine = ref_sine * self.query_scale(content)
            ref_hw = torch.sigmoid(self.ref_anchor_head(content).float())
            ref_sine = torch.cat([
                ref_sine[..., :c // 2]
                * (ref_hw[..., 1] / reference[..., 3])[..., None],
                ref_sine[..., c // 2:]
                * (ref_hw[..., 0] / reference[..., 2])[..., None]], -1)
            output = getattr(self, f"layer_{i}")(
                output, key, query_pos, key_pos, ref_sine.to(dt),
                cross_attn_mask=cross_attn_mask)
            # anchor refinement in logit space, detached (:236-246)
            reg = self.reg_branch(output.mean(0)).float()
            new_ref = torch.sigmoid(reg + inverse_sigmoid(reference))
            if i != self.num_layers - 1:
                inter_refs.append(new_ref)
            reference = new_ref.detach()
            inter_out.append(output)
        return torch.stack(inter_out), torch.stack(inter_refs)
