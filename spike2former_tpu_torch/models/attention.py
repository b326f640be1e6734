"""Spiking token attention and FFNs of the DETR decoder (port of
``spike2former_tpu/models/attention.py``: ``TokenConvBN``, ``SpikeMHA``,
``MSDAFFN``, ``SpikeMLP3``, and the library variants no preset builds:
``LinearSpikeMHA``, ``LocalRepresentation``, ``PEMCrossAttention`` and the
dispatching ``SpikeMultiheadAttention``).

Attention is softmax-free: raw ``q k^T / sqrt(embed_dims)`` scores multiply
the values, and masked scores are zeroed.  Tokens are ``[T, B, N, C]``.  The
flax ``nn.Conv`` with kernel ``(1,)`` over channels-last tokens is a
``Linear`` here, computing in the module's ``dtype``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel import spatial
from . import initializers as init
from .layers import (BatchNorm, Linear, RepConv, Spike, conv2d, conv_nhwc,
                     fold_t, unfold_t)


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

    ``key_bands``: the keys and values are this rank's band of the pixel
    tokens inside ``parallel.spatial_sharding()`` (the queries are the
    same on every rank); both associations' f32 sums over the keys are
    summed over the bands before they are scaled or rounded, and
    ``factored`` reads the global key count.  ``token_bands``: queries,
    keys and values are all this band's pixel tokens (self-attention over
    the map): every query reads every key, so the keys' and values'
    spikes are gathered whole and the band's queries attend to them.
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

    def forward(self, query, key, value, attn_mask=None,
                key_bands: bool = False, token_bands: bool = False):
        q = self.Spike_0(self.q(query))
        k = self.Spike_1(self.k(key))
        v = self.Spike_2(self.v(value))
        if token_bands:
            k, v = (spatial.gather_rows_h(y, -2) for y in (k, v))
        dt = q.dtype
        qh, kh, vh = (_split_heads(y, self.num_heads).float()
                      for y in (q, k, v))
        bands = spatial.bands() if key_bands else None
        n_keys = k.shape[-2] * (bands.size if bands else 1)
        total = spatial.all_sum_ if bands else (lambda t: t)
        if (self.factored and attn_mask is None
                and n_keys >= self.factored_min_kv):
            kv = total(kh.transpose(-1, -2) @ vh) / (self.embed_dims ** 0.5)
            out = (qh @ kv.to(dt).float()).to(dt)
        else:
            scores = (qh @ kh.transpose(-1, -2)) / (self.embed_dims ** 0.5)
            if attn_mask is not None:
                scores = scores.masked_fill(attn_mask, 0.0)
            out = total(scores.to(dt).float() @ vh).to(dt)
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
                 dtype=torch.float32, spike: str = "qspike"):
        super().__init__()
        self.compat = compat
        self.Spike_0, self.Spike_1 = Spike(spike), Spike(spike)
        self.Conv_0 = Linear(embed_dims, feedforward_channels, dtype=dtype,
                             spike_input=spike)
        self.BatchNorm_0 = BatchNorm(feedforward_channels)
        self.Conv_1 = Linear(feedforward_channels, embed_dims, dtype=dtype,
                             spike_input=spike)
        self.BatchNorm_1 = BatchNorm(embed_dims)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.Spike_0(xf)
        shape = xf.shape
        is_map = xf.dim() == 4
        if self.compat:
            tb, c = shape[0], shape[-1]
            # map: a real permute in and back (identity on the tokens);
            # tokens: a reshape in, so (token, channel) pairs are shuffled
            xf = (xf.reshape(tb, -1, c) if is_map
                  else xf.reshape(tb, c, -1).transpose(1, 2))
        xf = self.BatchNorm_0(self.Conv_0(xf))
        xf = self.BatchNorm_1(self.Conv_1(self.Spike_1(xf)))
        if self.compat:
            if is_map and spatial.bands() is not None:
                # the reshape mixes the whole map's pixels: this band's
                # rows of the whole map's reinterpretation
                tb, hb, w, c = shape
                r0, _ = spatial.rows(hb)
                whole = spatial.gather_rows_h(xf, 1)
                return unfold_t(whole.transpose(1, 2).reshape(
                    tb, -1, w, c).narrow(1, r0, hb), t)
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
        # flax's truncated_normal(0.02) (JAX attention.py:406-407)
        self.init_laws = {"Dense_2.weight": init.truncated_normal(0.02)}

    def forward(self, x):
        x = self.Spike_0(self.Dense_0(x)) * self.quant_const
        x = self.Spike_1(self.Dense_1(x)) * self.quant_const
        return self.Dense_2(x)


class LinearSpikeMHA(nn.Module):
    """Linear (kernelized) spiking attention ``q (k^T v)``, as JAX's
    (attention.py:131-202).  ``mode='SA'``: conv q/k/v, scaled by the head
    dim's ``-1/2`` power (MSMultiHeadAttentionBlock, transformer.py
    :442-502); ``mode='CA'``: key and value are spatial maps [T, B, H, W,
    C] through spike -> ``RepConv`` -> spike, ``k^T v`` over the full embed
    dim's square root, plus the channel-attention shortcut ``out * alpha +
    mean_N(channel_conv(spike(query)))`` (MultiHeadCrossAttentionBlock,
    :364-438).  The contractions sum in float32.  Spike sites in flax's
    call order: SA ``Spike_0``-``Spike_3`` (q, k, v, out); CA ``Spike_0``
    (q), ``Spike_1``/``Spike_2`` (key in/out), ``Spike_3``/``Spike_4``
    (value), ``Spike_5`` (shortcut), ``Spike_6`` (out)."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 mode: str = "SA", spike: str = "qspike",
                 dtype=torch.float32):
        super().__init__()
        if mode not in ("SA", "CA"):
            raise ValueError(f"mode must be 'SA' or 'CA', got {mode!r}")
        self.embed_dims, self.num_heads, self.mode = (embed_dims, num_heads,
                                                      mode)
        c = embed_dims
        self.q = TokenConvBN(c, c, dtype, spike)
        n_spikes = 7 if mode == "CA" else 4
        for i in range(n_spikes):
            setattr(self, f"Spike_{i}", Spike(spike))
        if mode == "CA":
            self.k_rep = RepConv(c, c, dtype=dtype)
            self.v_rep = RepConv(c, c, dtype=dtype)
            self.channel_conv = Linear(c, c, bias=False, dtype=dtype)
            self.alpha = nn.Parameter(torch.ones(1, 1, c))
            self.init_laws = {"alpha": init.ones}  # JAX attention.py:193
        else:
            self.k = TokenConvBN(c, c, dtype, spike)
            self.v = TokenConvBN(c, c, dtype, spike)
        self.Conv_0 = Linear(c, c, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(c)

    def _rep(self, y, rep, s_in, s_out):
        yf, t = fold_t(y)
        yf = s_out(rep(s_in(yf)))
        tb, h, w, c = yf.shape
        return unfold_t(yf.reshape(tb, h * w, c), t)

    def forward(self, query, key, value):
        spatial.refuse("LinearSpikeMHA")
        q = self.Spike_0(self.q(query))
        if self.mode == "CA":
            k = self._rep(key, self.k_rep, self.Spike_1, self.Spike_2)
            v = self._rep(value, self.v_rep, self.Spike_3, self.Spike_4)
        else:
            k = self.Spike_1(self.k(key))
            v = self.Spike_2(self.v(value))
        dt = q.dtype
        qh, kh, vh = (_split_heads(y, self.num_heads) for y in (q, k, v))
        kv = kh.float().transpose(-1, -2) @ vh.float()
        if self.mode == "CA":
            kv = kv / (self.embed_dims ** 0.5)
            out = qh.float() @ kv.to(dt).float()
        else:
            scale = (self.embed_dims // self.num_heads) ** -0.5
            out = (qh.float() @ kv.to(dt).float()) * scale
        out = _merge_heads(out.to(dt))
        if self.mode == "CA":
            tgt = self.channel_conv(self.Spike_5(query)).mean(-2,
                                                              keepdim=True)
            out = out * self.alpha + tgt
        last = self.Spike_6 if self.mode == "CA" else self.Spike_3
        outf, t = fold_t(out)
        outf = self.BatchNorm_0(self.Conv_0(last(outf)))
        return unfold_t(outf, t)


class LocalRepresentation(nn.Module):
    """BN -> depthwise 3x3 (bias) -> dense over tokens (transformer.py
    :63-100): [B, H, W, C] -> [B, H*W, C]."""

    def __init__(self, d_model: int = 256, dtype=torch.float32):
        super().__init__()
        self.bn = BatchNorm(d_model)
        self.dw = conv2d(d_model, d_model, 3, pad=1, groups=d_model,
                         bias=True, dtype=dtype)
        self.out = Linear(d_model, d_model, dtype=dtype)

    def forward(self, x):
        x = conv_nhwc(self.dw, self.bn(x))
        b, h, w, c = x.shape
        return self.out(x.reshape(b, h * w, c))


def _l2(y: torch.Tensor, dim: int) -> torch.Tensor:
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=dim, keepdim=True),
                           min=1e-12)


class PEMCrossAttention(nn.Module):
    """Prototype-based masked cross-attention (PEM_CA, transformer.py
    :102-192; JAX attention.py:223-293): each query copies, per head, the
    feature token of highest cosine similarity (tokens whose mask value is
    below 0 excluded, unless every query of a (batch, head) slice is wholly
    masked), then a dense refinement normalized over the QUERY axis, as
    the reference does.  tgt [B, Q, C], memory [B, H, W, C], memory_mask
    [B, Q, H, W], pos [B, H, W, C], query_pos [B, Q, C].  ``query_norm`` is
    flax's LayerNorm (eps 1e-6).  Ties of the argmax take the first
    token, as ``jnp.argmax`` does."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dtype=torch.float32):
        super().__init__()
        c = embed_dims
        self.num_heads = num_heads
        self.feature_proj = LocalRepresentation(c, dtype)
        self.query_norm = nn.LayerNorm(c, eps=1e-6)
        self.query_proj = Linear(c, c, dtype=dtype)
        self.alpha = nn.Parameter(torch.ones(1, 1, c))
        self.init_laws = {"alpha": init.ones}  # JAX attention.py:285
        self.proj = Linear(c, c, dtype=dtype)
        self.final = Linear(c, c, dtype=dtype)

    def forward(self, tgt, memory, memory_mask=None, pos=None,
                query_pos=None):
        spatial.refuse("PEMCrossAttention")
        if pos is not None:
            memory = memory + pos
        if query_pos is not None:
            tgt = tgt + query_pos
        mem = _l2(self.feature_proj(memory), -1)
        q = _l2(self.query_proj(self.query_norm(tgt.float()).to(tgt.dtype)),
                -1)
        b, n, c = mem.shape
        nq, nh = q.shape[1], self.num_heads
        hd = c // nh
        mh = mem.reshape(b, n, nh, hd).permute(0, 2, 1, 3)
        qh = q.reshape(b, nq, nh, hd).permute(0, 2, 1, 3)
        sim = torch.einsum("bhnc,bhqc->bhnq", mh, qh)        # [B, h, N, Q]
        if memory_mask is not None:
            excl = (memory_mask.detach().reshape(b, nq, n).transpose(1, 2)
                    < 0.0)[:, None].expand(b, nh, n, nq)
            wipe = (excl.sum(2) == n).all(2)                 # [B, h]
            excl = excl & ~wipe[:, :, None, None]
            sim = sim.masked_fill(excl, float("-inf"))
        idx = _first_argmax(sim, 2)                          # [B, h, Q]
        picked = mh.gather(2, idx[..., None].expand(b, nh, nq, hd))
        picked = picked.permute(0, 2, 1, 3).reshape(b, nq, c)
        mixed = self.proj(picked * q)
        out = _l2(mixed, 1) * self.alpha + picked
        return self.final(out)


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The index of the first maximum along ``dim`` (``jnp.argmax``'s
    tie rule; ``torch.argmax`` promises none)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ids = torch.arange(n, device=x.device).view(shape)
    at_max = x == x.amax(dim, keepdim=True)
    return torch.where(at_max, ids, n).amin(dim)


class SpikeMultiheadAttention(nn.Module):
    """The dispatching wrapper (transformer.py:505-638): positional
    embeddings added to query and key (not to a 'LinearCA' spatial key),
    then ``attn_type`` 'SA'/'CA' -> ``SpikeMHA``, 'LinearSA'/'LinearCA' ->
    ``LinearSpikeMHA`` of that mode, as the submodule ``attn``."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 attn_type: str = "SA", spike: str = "qspike",
                 dtype=torch.float32):
        super().__init__()
        self.attn_type = attn_type
        if attn_type in ("SA", "CA"):
            self.attn = SpikeMHA(embed_dims, num_heads, dtype=dtype,
                                 spike=spike)
        elif attn_type in ("LinearSA", "LinearCA"):
            self.attn = LinearSpikeMHA(embed_dims, num_heads,
                                       mode=attn_type.removeprefix("Linear"),
                                       spike=spike, dtype=dtype)
        else:
            raise ValueError(f"unknown attn_type {attn_type!r}")

    def forward(self, query, key, value, query_pos=None, key_pos=None,
                attn_mask=None):
        spatial.refuse("SpikeMultiheadAttention")
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None and self.attn_type != "LinearCA":
            key = key + key_pos
        if self.attn_type in ("SA", "CA"):
            return self.attn(query, key, value, attn_mask=attn_mask)
        return self.attn(query, key, value)
