"""Spiking token attention and FFNs of the DETR decoder (port of
``spike2former_tpu/models/attention.py``: ``TokenConvBN``, ``SpikeMHA``,
``MSDAFFN``, ``SpikeMLP3``).

Attention is softmax-free: raw ``q k^T / sqrt(embed_dims)`` scores multiply
the values, and masked scores are zeroed.  Tokens are ``[T, B, N, C]``.  The
flax ``nn.Conv`` with kernel ``(1,)`` over channels-last tokens is a
``Linear`` here, computing in the module's ``dtype``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm, Linear, Spike, fold_t, unfold_t


class TokenConvBN(nn.Module):
    """spike (of ``spike`` kind) -> pointwise projection -> BN over tokens
    [T, B, N, C]."""

    def __init__(self, cin: int, features: int, dtype=torch.float32,
                 spike: str = "qspike"):
        super().__init__()
        self.Spike_0 = Spike(spike)
        self.Conv_0 = Linear(cin, features, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(self.Spike_0(x)))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., N, C] -> [..., H, N, C/H], channel-contiguous head split."""
    *lead, n, c = x.shape
    return x.reshape(*lead, n, num_heads, c // num_heads).transpose(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    *lead, h, n, ch = x.shape
    return x.transpose(-2, -3).reshape(*lead, n, h * ch)


class SpikeMHA(nn.Module):
    """Softmax-free spiking multi-head attention, scaled by the FULL embed
    dim (transformer.py:262-263).

    ``factored``: with no mask the output is linear in the scores, so
    ``(q k^T) v == q (k^T v)``; used only when no mask is given and there
    are at least ``factored_min_kv`` keys (transformer_decoder.py:45-50).

    The contractions take the spikes in their dtype with f32 sums, scaled
    in f32 and rounded to the spikes' dtype before the next product, as
    JAX's (attention.py:129-144): they run on f32 copies of bf16 spikes.
    """

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 factored: bool = False, factored_min_kv: int = 1024,
                 dtype=torch.float32, spike: str = "qspike"):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.factored, self.factored_min_kv = factored, factored_min_kv
        # Spike_0-2 on q, k and v, Spike_3 on the merged heads
        for i in range(4):
            setattr(self, f"Spike_{i}", Spike(spike))
        self.q = TokenConvBN(embed_dims, embed_dims, dtype, spike)
        self.k = TokenConvBN(embed_dims, embed_dims, dtype, spike)
        self.v = TokenConvBN(embed_dims, embed_dims, dtype, spike)
        self.Conv_0 = Linear(embed_dims, embed_dims, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(embed_dims)

    def forward(self, query, key, value, attn_mask=None):
        q = self.Spike_0(self.q(query))
        k = self.Spike_1(self.k(key))
        v = self.Spike_2(self.v(value))
        dt = q.dtype
        qh, kh, vh = (_split_heads(y, self.num_heads).float()
                      for y in (q, k, v))
        if (self.factored and attn_mask is None
                and key.shape[-2] >= self.factored_min_kv):
            kv = (kh.transpose(-1, -2) @ vh) / (self.embed_dims ** 0.5)
            out = (qh @ kv.to(dt).float()).to(dt)
        else:
            scores = (qh @ kh.transpose(-1, -2)) / (self.embed_dims ** 0.5)
            if attn_mask is not None:
                scores = scores.masked_fill(attn_mask, 0.0)
            out = (scores.to(dt).float() @ vh).to(dt)
        out = self.Spike_3(_merge_heads(out))
        return self.BatchNorm_0(self.Conv_0(out))


class MSDAFFN(nn.Module):
    """Spiking FFN: spike->1x1(->ffn)->BN->spike->1x1(->C)->BN, no residual.

    ``compat=True`` replays the reference's layout quirks, which trained
    weights encode: token inputs move to channel-major by ``reshape``
    instead of a transpose (transformer.py:777-781), and spatial outputs
    ``[tb, C, N]`` are reinterpreted channels-last by a plain reshape
    (:815-831).
    """

    def __init__(self, embed_dims: int = 256,
                 feedforward_channels: int = 2048, compat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.compat = compat
        self.Spike_0, self.Spike_1 = Spike(), Spike()
        self.Conv_0 = Linear(embed_dims, feedforward_channels, dtype=dtype,
                             spike_input=True)
        self.BatchNorm_0 = BatchNorm(feedforward_channels)
        self.Conv_1 = Linear(feedforward_channels, embed_dims, dtype=dtype,
                             spike_input=True)
        self.BatchNorm_1 = BatchNorm(embed_dims)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.Spike_0(xf)
        shape = xf.shape
        spatial = xf.dim() == 4
        if self.compat:
            tb, c = shape[0], shape[-1]
            # spatial: a real permute in and back (identity on the tokens);
            # tokens: a reshape in, so (token, channel) pairs are shuffled
            xf = (xf.reshape(tb, -1, c) if spatial
                  else xf.reshape(tb, c, -1).transpose(1, 2))
        xf = self.BatchNorm_0(self.Conv_0(xf))
        xf = self.BatchNorm_1(self.Conv_1(self.Spike_1(xf)))
        if self.compat:
            xf = xf.transpose(1, 2).reshape(shape)
        return unfold_t(xf, t)


class SpikeMLP3(nn.Module):
    """fc->(spike*a)->fc->(spike*a)->fc mask-embedding MLP
    (SNN_core.py:95-123, quant_const=4)."""

    def __init__(self, dim: int, out_dim: int, quant_const: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.quant_const = quant_const
        self.Spike_0, self.Spike_1 = Spike(), Spike()
        self.Dense_0 = Linear(dim, dim, bias=False, dtype=dtype)
        self.Dense_1 = Linear(dim, dim, bias=False, dtype=dtype)
        self.Dense_2 = Linear(dim, out_dim, dtype=dtype)

    def forward(self, x):
        x = self.Spike_0(self.Dense_0(x)) * self.quant_const
        x = self.Spike_1(self.Dense_1(x)) * self.quant_const
        return self.Dense_2(x)
