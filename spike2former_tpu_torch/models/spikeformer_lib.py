"""The spikeformer attention library, the BASE_Transformer decoder layer
and ``QueryProposal`` (port of ``spike2former_tpu/models/spikeformer_lib.py``;
reference mmcv_spike/spikeformer.py :193-483, BASE_Transformer.py
:229-313, transformer/utils.py :880-949).  No preset builds them.

Tokens are [T, B, N, C] channels-last; the reference's Conv1d(k=1) +
BatchNorm1d stacks are a dense layer and a BN over every leading axis
(``_ProjBN``).  Attention is softmax-free with the fixed score scale 0.1,
the residual inside each block; the products sum in float32.  Submodules
and spike sites carry the JAX modules' names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import (MSDAFFN, SpikeMultiheadAttention, _merge_heads,
                        _split_heads)
from .layers import BatchNorm, Linear, Spike, conv2d, conv_nhwc


class _ProjBN(nn.Module):
    """Conv1d(k=1) + BatchNorm1d on [T, B, N, C] tokens."""

    def __init__(self, cin: int, features: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Linear(cin, features, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Dense_0(x))


def _attend(q, k, v, num_heads: int, scale: float, attn_mask=None):
    """Multi-head ``(q k^T * scale) v`` with float32 sums; a bool mask
    zeroes its scores, a float mask adds to them."""
    dt = q.dtype
    qh, kh, vh = (_split_heads(y, num_heads).float() for y in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) * scale
    if attn_mask is not None:
        scores = (scores.masked_fill(attn_mask, 0.0)
                  if attn_mask.dtype == torch.bool else scores + attn_mask)
    out = (scores.to(dt).float() @ vh).to(dt)
    return _merge_heads(out)


class SpikeformerSelfAttention(nn.Module):
    """spikeformer.py ``SelfAttention`` (:193-277): head spike, q/k/v
    projections and spikes, ``q k^T * scale`` (no softmax) times v, attn
    spike, proj, plus the pos-added query."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 spike: str = "multispike_norm", scale: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        self.num_heads, self.scale = num_heads, scale
        for name in ("head_lif", "q_lif", "k_lif", "v_lif", "attn_lif"):
            setattr(self, name, Spike(spike))
        for name in ("q_conv", "k_conv", "v_conv", "proj_conv"):
            setattr(self, name, _ProjBN(c, c, dtype))

    def forward(self, query, query_pos=None, attn_mask=None):
        x = query if query_pos is None else query + query_pos
        tmp = x
        x = self.head_lif(x)
        q = self.q_lif(self.q_conv(x))
        k = self.k_lif(self.k_conv(x))
        v = self.v_lif(self.v_conv(x))
        out = self.attn_lif(_attend(q, k, v, self.num_heads, self.scale,
                                    attn_mask))
        return self.proj_conv(out) + tmp


class SpikeformerCrossAttention(nn.Module):
    """spikeformer.py ``CrossAttention`` (:280-435): q from the queries,
    k and v both from the spiked keys, residual the pos-added query."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 spike: str = "multispike_norm", scale: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        self.num_heads, self.scale = num_heads, scale
        for name in ("head_lif_q", "head_lif_k", "q_lif", "k_lif", "v_lif",
                     "attn_lif"):
            setattr(self, name, Spike(spike))
        for name in ("q_conv", "k_conv", "v_conv", "proj_conv"):
            setattr(self, name, _ProjBN(c, c, dtype))

    def forward(self, query, key, query_pos=None, key_pos=None,
                attn_mask=None):
        q_t = query if query_pos is None else query + query_pos
        key = key if key_pos is None else key + key_pos
        xq, xk = self.head_lif_q(q_t), self.head_lif_k(key)
        q = self.q_lif(self.q_conv(xq))
        k = self.k_lif(self.k_conv(xk))
        v = self.v_lif(self.v_conv(xk))
        out = self.attn_lif(_attend(q, k, v, self.num_heads, self.scale,
                                    attn_mask))
        return self.proj_conv(out) + q_t


class SpikeformerMLP(nn.Module):
    """spikeformer.py ``MLP`` (:438-483): spike -> fc1 -> spike -> fc2,
    residual inside."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 spike: str = "multispike_norm", dtype=torch.float32):
        super().__init__()
        self.fc1_lif, self.fc2_lif = Spike(spike), Spike(spike)
        self.fc1 = _ProjBN(embed_dims, feedforward_channels, dtype)
        self.fc2 = _ProjBN(feedforward_channels, embed_dims, dtype)

    def forward(self, x):
        return self.fc2(self.fc2_lif(self.fc1(self.fc1_lif(x)))) + x


class SpikeformerDecoderLayer(nn.Module):
    """``Spike2FormerTransformerDecoderLayer`` (Spike2former_layers.py
    :83-216): self-attention, cross-attention, FFN, each with its residual
    inside."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024,
                 spike: str = "multispike_norm", dtype=torch.float32):
        super().__init__()
        self.self_attn = SpikeformerSelfAttention(embed_dims, num_heads,
                                                  spike, dtype=dtype)
        self.cross_attn = SpikeformerCrossAttention(embed_dims, num_heads,
                                                    spike, dtype=dtype)
        self.ffn = SpikeformerMLP(embed_dims, feedforward_channels, spike,
                                  dtype=dtype)

    def forward(self, query, key, query_pos=None, key_pos=None,
                self_attn_mask=None, cross_attn_mask=None):
        query = self.self_attn(query, query_pos=query_pos,
                               attn_mask=self_attn_mask)
        query = self.cross_attn(query, key, query_pos=query_pos,
                                key_pos=key_pos, attn_mask=cross_attn_mask)
        return self.ffn(query)


class BaseTransformerDecoderLayer(nn.Module):
    """BASE_Transformer.py ``TransformerDecoderLayer`` (:229-313): spiking
    self- and cross-attention ('SA', 'CA') and ``MSDAFFN``, each added to
    the input scaled by a per-channel gamma (1e-6 at init)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 2048, spike: str = "qspike",
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        for name in ("gamma1", "gamma2", "gamma3"):
            setattr(self, name, nn.Parameter(torch.full((c,), 1e-6)))
        self.self_attn = SpikeMultiheadAttention(c, num_heads, "SA", spike,
                                                 dtype)
        self.multihead_attn = SpikeMultiheadAttention(c, num_heads, "CA",
                                                      spike, dtype)
        self.mlp = MSDAFFN(c, feedforward_channels, dtype=dtype, spike=spike)

    def forward(self, tgt, memory, query_pos=None, mem_pos=None,
                tgt_mask=None, memory_mask=None):
        tgt = tgt + self.gamma1 * self.self_attn(
            tgt, tgt, tgt, query_pos=query_pos, key_pos=query_pos,
            attn_mask=tgt_mask)
        tgt = tgt + self.gamma2 * self.multihead_attn(
            tgt, memory, memory, query_pos=query_pos, key_pos=mem_pos,
            attn_mask=memory_mask)
        return tgt + self.gamma3 * self.mlp(tgt)


def seek_local_maximum(x: torch.Tensor, epsilon: float = 1e-6
                       ) -> torch.Tensor:
    """1 where a pixel of ``x`` [B, H, W, C] is at least ``epsilon`` and at
    least each of its 8 zero-padded neighbours (utils.py :900-918)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    m = x >= epsilon
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = m & (x >= xp[:, 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx])
    return m.to(x.dtype)


def _top_k_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries of each row, ties broken
    by the lower index first (``jax.lax.top_k``'s order; the local-maximum
    boost makes exact ties common, and ``torch.topk`` promises no order
    among them)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


class QueryProposal(nn.Module):
    """utils.py ``QueryProposal`` (:880-949): spike -> 1x1 conv class
    logits -> sigmoid, gated by each pixel's foreground argmax one-hot,
    plus the 8-neighbour local-maximum map; the ``num_queries`` pixels of
    highest foreground score give the queries' features, positional
    embeddings and (in training) normalized locations.

    x [B, H, W, C]; pos_embeddings [B or 1, H, W, C].  Returns (proposals
    [B, K, C], pos [B, K, C], locations [B, K, 2] or None, logits [B, H, W,
    num_classes + 1])."""

    def __init__(self, in_channels: int, num_queries: int, num_classes: int,
                 spike: str = "multispike_norm", dtype=torch.float32):
        super().__init__()
        self.num_queries, self.num_classes = num_queries, num_classes
        self.proposal_spike = Spike(spike)
        self.proposal_cls = conv2d(in_channels, num_classes + 1, 1,
                                   bias=True, dtype=dtype)

    def forward(self, x, pos_embeddings, train: bool = False):
        b, h, w, c = x.shape
        logits = conv_nhwc(self.proposal_cls, self.proposal_spike(x))
        probs = torch.sigmoid(logits.float())
        onehot = F.one_hot(probs[..., :-1].argmax(-1),
                           self.num_classes + 1).to(probs.dtype)
        probs = probs * onehot
        probs = probs + seek_local_maximum(probs)
        score = probs[..., :-1].amax(-1).reshape(b, h * w)
        topk = _top_k_stable(score, self.num_queries)            # [B, K]
        idx = topk[..., None].expand(b, self.num_queries, c)
        feats = x.reshape(b, h * w, c).gather(1, idx)
        pos = pos_embeddings.expand(b, h, w, c).reshape(b, h * w, c)
        pos = pos.gather(1, idx)
        locations = None
        if train:
            ys = torch.linspace(0.0, 1.0, h, device=x.device)
            xs = torch.linspace(0.0, 1.0, w, device=x.device)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            loc = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
            locations = loc.expand(b, h * w, 2).gather(
                1, topk[..., None].expand(b, self.num_queries, 2))
        return feats, pos, locations, logits
