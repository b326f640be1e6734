"""Spiking DETR decoder layer (port of
``spike2former_tpu/models/transformer_decoder.py``, order ``ca_sa``):
cross-attn -> self-attn -> FFN, residual adds in the layer."""
from __future__ import annotations

import torch
from torch import nn

from .attention import MSDAFFN, SpikeMHA


class DetrDecoderLayer(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 2048, compat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        # the factored form kills the [nq, nk] score tensor over the big
        # pixel-token levels; compat keeps the reference's summation order
        self.cross_attn = SpikeMHA(embed_dims, num_heads, factored=not compat,
                                   dtype=dtype)
        self.self_attn = SpikeMHA(embed_dims, num_heads, dtype=dtype)
        self.ffn = MSDAFFN(embed_dims, feedforward_channels, compat=compat,
                           dtype=dtype)

    def forward(self, query, key, value, query_pos, key_pos,
                cross_attn_mask=None, self_attn_mask=None):
        """query [T,B,nq,C]; key/value [T,B,nk,C]; *_pos [B,n,C].  Inside
        ``parallel.spatial_sharding()`` the keys and values are this band's
        pixel tokens."""
        query = query + self.cross_attn(query + query_pos, key + key_pos,
                                         value, attn_mask=cross_attn_mask,
                                         key_bands=True)
        q = query + query_pos
        query = query + self.self_attn(q, q, query, attn_mask=self_attn_mask)
        return query + self.ffn(query)
